"""Device meshes, the state's split rule and the exchanges between shards.

The counterpart of ``qpsim_tpu.parallel.mesh``.  The scaling axes are the
same:

* ``ensemble`` — independent simulations or parameter sweeps, no
  communication in the hot loop;
* ``space`` — the 2D grid split by rows; the ADI sweeps need a one-row
  halo from each neighbour and either a pencil transpose or the Wang
  interface rows.

Energy bins stay local: the collision operator couples all bins of one
pixel.

A :class:`Mesh` lays devices on an (ensemble × space) grid and holds the
exchange that moves data between its cells (shards):

* :class:`LocalExchange` — every cell in this process, on the devices of
  the list given to :func:`make_mesh`, which may repeat
  (``[torch.device("cpu")] * 8`` shards 8 ways on the CPU,
  ``[torch.device("cuda", 0)] * 4`` 4 ways on one card); rows move by
  tensor copies;
* :class:`DistributedExchange` — this process's one cell of a mesh over
  the processes of a ``torch.distributed`` group
  (:func:`initialize_distributed`, :func:`make_multihost_mesh`): halos by
  ``batch_isend_irecv``, pencils by ``all_to_all_single``, interface rows
  by ``all_gather``, sums by ``all_reduce``; NCCL between cards (one
  process per card), gloo on the CPU.

Both take per-cell lists in the order of :attr:`Mesh.cells` and return
such lists; the collectives stay outside the kernels.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "DistributedExchange",
    "ENSEMBLE_AXIS",
    "LocalExchange",
    "Mesh",
    "SPACE_AXIS",
    "StateSharding",
    "initialize_distributed",
    "local_devices",
    "make_mesh",
    "make_multihost_mesh",
    "state_sharding",
]

ENSEMBLE_AXIS = "ensemble"
SPACE_AXIS = "space"


class LocalExchange:
    """The exchange of a mesh whose cells all live in this process.

    ``devices`` is the (n_ensemble, n_space) grid; the space collectives
    run within each ensemble row.  A tensor moves to a cell's device with
    ``.to`` (no copy when it is already there).
    """

    def __init__(self, devices: np.ndarray):
        self.n_ensemble, self.n_space = devices.shape
        self.cells = [(e, s) for e in range(self.n_ensemble) for s in range(self.n_space)]
        self.devices = [devices[c] for c in self.cells]

    def _at(self, e: int, s: int) -> int:
        return e * self.n_space + s

    def halo(self, last: list, first: list) -> tuple[list, list]:
        """Each cell's row above (the previous cell's ``last``) and row below
        (the next cell's ``first``); zeros at the global edges."""
        above, below = [], []
        for i, (e, s) in enumerate(self.cells):
            dev = self.devices[i]
            above.append(last[self._at(e, s - 1)].to(dev, non_blocking=True) if s > 0
                         else torch.zeros_like(first[i]))
            below.append(first[self._at(e, s + 1)].to(dev, non_blocking=True) if s < self.n_space - 1
                         else torch.zeros_like(last[i]))
        return above, below

    def all_gather(self, parts: list) -> list:
        """Each cell gets its row's parts stacked along a new leading (space) axis."""
        out = []
        for i, (e, _) in enumerate(self.cells):
            dev = self.devices[i]
            out.append(torch.stack([parts[self._at(e, s)].to(dev, non_blocking=True)
                                    for s in range(self.n_space)]))
        return out

    def all_to_all(self, send: list) -> list:
        """``send[i][j]`` goes from cell i to position j of its row;
        returns ``recv[i][j]``, what cell i got from position j."""
        return [[send[self._at(e, j)][s].to(self.devices[i], non_blocking=True)
                 for j in range(self.n_space)]
                for i, (e, s) in enumerate(self.cells)]

    def psum(self, values: list) -> list:
        """The sum of ``values`` over each cell's row."""
        out = []
        for i, (e, _) in enumerate(self.cells):
            total = values[self._at(e, 0)].to(self.devices[i], non_blocking=True)
            for s in range(1, self.n_space):
                total = total + values[self._at(e, s)].to(self.devices[i], non_blocking=True)
            out.append(total)
        return out

    def gather_cells(self, parts: list) -> list:
        """Every cell's part, in :attr:`cells` order, on the first cell's device."""
        return [p.to(self.devices[0], non_blocking=True) for p in parts]


class DistributedExchange:
    """The exchange of a mesh over the processes of a ``torch.distributed``
    group, one cell per process: rank r holds cell (r // n_space,
    r % n_space).

    Every rank builds the same row groups in the same order at
    construction (``new_group`` is collective), so every rank must build
    its meshes in the same order.  NCCL puts one rank on each card.
    """

    def __init__(self, n_ensemble: int, n_space: int, device: torch.device):
        import torch.distributed as dist

        self.n_ensemble, self.n_space = n_ensemble, n_space
        self.rank = dist.get_rank()
        self.cells = [divmod(self.rank, n_space)]
        self.devices = [device]
        self._row = None  # the default group when the row is the whole world
        if n_ensemble > 1:
            for e in range(n_ensemble):
                group = dist.new_group(ranks=[e * n_space + s for s in range(n_space)])
                if e == self.cells[0][0]:
                    self._row = group

    def _rank_at(self, s: int) -> int:
        return self.cells[0][0] * self.n_space + s

    def halo(self, last: list, first: list) -> tuple[list, list]:
        import torch.distributed as dist

        _, s = self.cells[0]
        lo, hi = last[0].contiguous(), first[0].contiguous()
        above, below = torch.zeros_like(hi), torch.zeros_like(lo)
        ops = []
        if s < self.n_space - 1:  # my last row is the next cell's row above
            ops += [dist.P2POp(dist.isend, lo, self._rank_at(s + 1)),
                    dist.P2POp(dist.irecv, below, self._rank_at(s + 1))]
        if s > 0:
            ops += [dist.P2POp(dist.isend, hi, self._rank_at(s - 1)),
                    dist.P2POp(dist.irecv, above, self._rank_at(s - 1))]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [above], [below]

    def all_gather(self, parts: list) -> list:
        import torch.distributed as dist

        mine = parts[0].contiguous()
        bufs = [torch.empty_like(mine) for _ in range(self.n_space)]
        dist.all_gather(bufs, mine, group=self._row)
        return [torch.stack(bufs)]

    def all_to_all(self, send: list) -> list:
        import torch.distributed as dist

        stacked = torch.stack([t.contiguous() for t in send[0]])
        out = torch.empty_like(stacked)
        dist.all_to_all_single(out, stacked, group=self._row)
        return [list(out.unbind(0))]

    def psum(self, values: list) -> list:
        import torch.distributed as dist

        total = values[0].reshape(-1).clone()  # collectives take at least one dimension
        dist.all_reduce(total, group=self._row)
        return [total.reshape(values[0].shape)]

    def gather_cells(self, parts: list) -> list:
        """Every cell's part, in mesh order (rank order), on this rank's device."""
        import torch.distributed as dist

        mine = parts[0].contiguous()
        bufs = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(bufs, mine)
        return bufs


@dataclass(eq=False)
class Mesh:
    """An (ensemble × space) grid of devices and the exchange between its cells.

    ``devices`` is the (n_ensemble, n_space) object array of
    ``torch.device``; :attr:`cells` are the (e, s) positions this process
    holds, with their devices in :attr:`local_devices`.
    """

    devices: np.ndarray
    exchange: LocalExchange | DistributedExchange

    @property
    def shape(self) -> dict[str, int]:
        n_e, n_s = self.devices.shape
        return {ENSEMBLE_AXIS: int(n_e), SPACE_AXIS: int(n_s)}

    @property
    def cells(self) -> list[tuple[int, int]]:
        return self.exchange.cells

    @property
    def local_devices(self) -> list[torch.device]:
        return self.exchange.devices

    @property
    def device_type(self) -> str:
        return self.local_devices[0].type


def _forced_host_count() -> int:
    """The CPU device count JAX's rule gives this process: XLA_FLAGS'
    ``--xla_force_host_platform_device_count``, else 1."""
    m = re.search(r"--xla_force_host_platform_device_count=(\d+)", os.environ.get("XLA_FLAGS", ""))
    return int(m.group(1)) if m else 1


def local_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """This process's devices of type ``device``: every CUDA device
    (raises when there is none), or the CPU repeated as many times as
    JAX's forced host device count for this process (``XLA_FLAGS``), so
    that a CPU mesh takes the sizes the JAX package's takes."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' (or a list of "
                               "torch.device('cpu')) to shard on the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind != "cpu":
        raise ValueError(f"Unsupported device {device} (use 'cuda' or 'cpu').")
    return [torch.device("cpu")] * _forced_host_count()


def _indexed(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_space: int | None = None, n_ensemble: int = 1, devices=None) -> Mesh:
    """An (ensemble × space) mesh over ``devices`` (default: :func:`local_devices`),
    all in this process.  A device may repeat: each entry is one cell.  A
    CUDA device without an index is the current one (``"cuda"`` is
    ``cuda:<current>``, where tensors made on ``"cuda"`` land)."""
    devs = [_indexed(torch.device(d)) for d in (devices if devices is not None else local_devices())]
    if n_space is None:
        n_space = len(devs) // n_ensemble
    if n_ensemble * n_space != len(devs):
        raise ValueError(f"mesh {n_ensemble}x{n_space} does not match {len(devs)} devices.")
    grid = np.empty((n_ensemble, n_space), dtype=object)
    for i, d in enumerate(devs):
        grid[divmod(i, n_space)] = d
    return Mesh(grid, LocalExchange(grid))


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout: float | None = None,
) -> None:
    """Join a ``torch.distributed`` group (a no-op when this process has joined one).

    ``coordinator_address`` is "host:port" of rank 0 (``tcp://`` init);
    without it the group comes from torchrun's environment
    (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) when that is set, and
    otherwise there is no group to join (one process).  ``backend``
    defaults to "nccl" where CUDA is available (one process per card,
    each on card ``process_id`` modulo the card count) and "gloo" on the
    CPU.  ``timeout`` (seconds) bounds the group's collectives and its
    set-up (torch's default otherwise).
    """
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        if not all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            return  # nothing to join: a single-process run
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        init, world, rank = f"tcp://{coordinator_address}", int(num_processes), int(process_id)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    extra = {} if timeout is None else {"timeout": datetime.timedelta(seconds=float(timeout))}
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank, **extra)


def make_multihost_mesh(n_space: int | None = None, n_ensemble: int | None = None, *,
                        device: str | torch.device | None = None) -> Mesh:
    """A mesh over every process of the ``torch.distributed`` group, one cell
    (one device) per process, ensemble axis across processes by default.

    Defaults: one ensemble group per process (``n_ensemble`` = the world
    size, ``n_space`` = 1), as the JAX package lays one process's devices
    on the space axis; pass ``n_space`` to shard space across processes.
    The device follows the group's backend (NCCL: this process's card,
    gloo: the CPU).  Without a group (one process) it is :func:`make_mesh`
    over :func:`local_devices` of ``device`` (default "cuda"), with one
    ensemble group.
    """
    import torch.distributed as dist

    if not dist.is_initialized():
        devs = local_devices(device or "cuda")
        if n_ensemble is None:
            n_ensemble = 1 if n_space is None else len(devs) // int(n_space)
        return make_mesh(n_space=n_space, n_ensemble=int(n_ensemble), devices=devs)
    world = dist.get_world_size()
    if n_ensemble is None and n_space is None:
        n_ensemble = world
    if n_ensemble is None:
        n_ensemble = world // int(n_space)
    if n_space is None:
        n_space = world // int(n_ensemble)
    if n_ensemble * n_space != world:
        raise ValueError(f"mesh {n_ensemble}x{n_space} does not match {world} devices.")
    if dist.get_backend() == "nccl":
        mine = torch.device("cuda", torch.cuda.current_device())
    else:
        mine = torch.device("cpu")
    grid = np.empty((n_ensemble, n_space), dtype=object)
    grid[:] = torch.device(mine.type)  # other processes' devices: their type
    exchange = DistributedExchange(int(n_ensemble), int(n_space), mine)
    grid[exchange.cells[0]] = mine
    return Mesh(grid, exchange)


class StateSharding:
    """How a state splits over a mesh: axis ``axis`` (rows, −2, by default)
    over ``space``, and — with ``ensemble`` — the leading (member) axis over
    ``ensemble``; without it every ensemble row holds the same parts.

    :meth:`shard` gives each of this process's cells its part (a copy, on
    the cell's device); :meth:`gather` puts the parts back together on the
    first cell's device (with a distributed exchange: on every process).
    """

    def __init__(self, mesh: Mesh, *, ensemble: bool = False, axis: int = -2):
        self.mesh, self.ensemble, self.axis = mesh, ensemble, axis

    def _part(self, x, cell):
        e, s = cell
        n_e, n_s = self.mesh.devices.shape
        n = x.shape[self.axis]
        if n % n_s:
            raise ValueError(f"axis of {n} does not split {n_s} ways")
        index = [slice(None)] * x.ndim
        index[self.axis] = slice(s * (n // n_s), (s + 1) * (n // n_s))
        if self.ensemble:
            if x.shape[0] % n_e:
                raise ValueError(f"{x.shape[0]} members do not split over {n_e} ensemble groups")
            b = x.shape[0] // n_e
            index[0] = slice(e * b, (e + 1) * b)
        return x[tuple(index)]

    def shard(self, x, dtype: torch.dtype | None = None) -> list[torch.Tensor]:
        """Each local cell's part of ``x`` (a tensor or an array), in ``dtype``."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.require(x, requirements=("C", "W")))
        out = []
        for cell, dev in zip(self.mesh.cells, self.mesh.local_devices):
            part = self._part(x, cell)
            buf = torch.empty(part.shape, dtype=dtype or part.dtype, device=dev)
            out.append(buf.copy_(part, non_blocking=True))
        return out

    def gather(self, parts: list) -> torch.Tensor:
        """The whole state from the parts of :meth:`shard`."""
        every = self.mesh.exchange.gather_cells(parts)
        n_e, n_s = self.mesh.devices.shape
        rows = [torch.cat(every[e * n_s:(e + 1) * n_s], dim=self.axis) for e in range(n_e)]
        return torch.cat(rows, dim=0) if self.ensemble else rows[0]


def state_sharding(mesh: Mesh, *, ensemble: bool = False) -> StateSharding:
    """The split rule of a state: rows over 'space', optional leading members over 'ensemble'."""
    return StateSharding(mesh, ensemble=ensemble)
