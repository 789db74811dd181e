"""A closed loop of simulation jobs through ``qpsim_tpu_torch.run_2d_crank_nicolson``.

One caller runs one job after another, as a parameter sweep does.  Job
``k`` of seed ``s`` starts from the traffic mix's initial density: a
uniform background with one Gaussian hot spot whose centre and peak are
drawn from ``(s, k)``, with the DOS energy weights (the engine's default)
and the phonons at the bath.  Every job has the
same size: the configuration's film and physics, the mix's steps,
stored-snapshot interval and snapshot detail.  Each stored frame is
delivered to ``progress_callback`` and its host time kept; the frames
and the phonon frames come back in memory and are dropped after the job,
except for one job a run keeps to judge, drawn from the seed among the
jobs the window completed.  The check follows that job's first
``check_steps`` steps (the mix's: a third of a job, or less, so that the
plain reference takes less time than the window) and compares the
snapshots stored in them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .. import trace


@dataclass
class CallRecord:
    index: int
    start: float  # host clock, s
    end: float = 0.0
    frames: list[float] = field(default_factory=list)  # host clock of each delivered frame
    steps: int = 0
    sim_ns: float = 0.0
    error: str | None = None


def seed_words(seed: int) -> int:
    """A seed of any sign and size as one unsigned 64-bit word."""
    return int(seed) & 0xFFFF_FFFF_FFFF_FFFF


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str = "cuda"):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed_words(seed), device
        g = config["geometry"]
        ny, nx, margin = int(g["height"]), int(g["width"]), int(g["margin"])
        self.mask = np.zeros((ny, nx), dtype=bool)
        self.mask[margin:ny - margin, margin:nx - margin] = True
        p = config["physics"]
        self.dt = float(p["dt"])
        self.steps = int(traffic["steps_per_call"])
        self.store_every = int(traffic["store_every"])
        self.check_steps = int(traffic["check_steps"])
        if self.steps % self.store_every or self.check_steps % self.store_every or self.check_steps > self.steps:
            raise ValueError("a job, and the part of it a run checks, hold whole stored segments")
        self.kept: tuple[int, dict] | None = None
        self._kept_rng = np.random.default_rng([self.seed, 1 << 40])
        self._completed = 0

    def reseed(self, seed: int) -> None:
        """Draw later jobs' inputs from ``seed`` (the program stays set up)."""
        self.seed = seed_words(seed)

    # --- inputs ----------------------------------------------------------------------
    def initial_field(self, k: int) -> np.ndarray:
        """Call ``k``'s density (µm⁻²): the background and a hot spot drawn from (seed, k)."""
        spec = self.traffic["initial_field"]
        hot = spec["hot_spot"]
        rng = np.random.default_rng([self.seed, k & 0xFFFF_FFFF])
        dx = float(self.config["physics"]["dx"])
        rows, cols = np.nonzero(self.mask)
        clear = float(hot["clearance_um"])
        y0 = rng.uniform(rows.min() * dx + clear, (rows.max() + 1) * dx - clear)
        x0 = rng.uniform(cols.min() * dx + clear, (cols.max() + 1) * dx - clear)
        amp = rng.uniform(*hot["amplitude"])
        s2 = 2.0 * float(hot["sigma_um"]) ** 2
        ny, nx = self.mask.shape
        gy = np.exp(-(((np.arange(ny) + 0.5) * dx - y0) ** 2) / s2)
        gx = np.exp(-(((np.arange(nx) + 0.5) * dx - x0) ** 2) / s2)
        return float(spec["background"]) + amp * np.outer(gy, gx)

    # --- the program -----------------------------------------------------------------
    def setup(self) -> None:
        """Import the program, load (on a checkout's first run: build) its kernels,
        and run one stored segment at the cell's shapes."""
        import torch

        from qpsim_tpu_torch import run_2d_crank_nicolson
        from qpsim_tpu_torch.geometry.mask import extract_edge_segments
        from qpsim_tpu_torch.models.params import BoundaryCondition, ExternalGenerationSpec
        from qpsim_tpu_torch.utils.cuda_build import load_kernels

        if torch.device(self.device).type == "cuda":
            load_kernels()
        self._run = run_2d_crank_nicolson
        edges = extract_edge_segments(self.mask)
        wall = self.config["geometry"]["walls"]
        p = dict(self.config["physics"])
        gen = p.pop("external_generation", None)
        self._kwargs = dict(
            mask=self.mask, edges=edges,
            edge_conditions={e.edge_id: BoundaryCondition(kind=wall) for e in edges},
            store_every=self.store_every, snapshot_detail=self.traffic["snapshot_detail"],
            external_generation=None if gen is None else ExternalGenerationSpec(**gen),
            dtype=getattr(torch, self.config["dtype"]), device=self.device, **p,
        )
        self._engine(self.initial_field(-1), self.store_every, lambda t, f: None)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def _engine(self, field: np.ndarray, steps: int, callback) -> dict:
        phonons: dict = {}
        times, frames, mass, _, _, _ = self._run(
            initial_field=field, total_time=steps * self.dt, phonon_history_out=phonons,
            progress_callback=callback, **self._kwargs,
        )
        return {"times": times, "frames": frames, "mass": mass, "phonon_frames": phonons["phonon_frames"]}

    def call(self, k: int) -> CallRecord:
        """Job ``k``, timed on the host clock from its start to its return."""
        field_k = self.initial_field(k)
        rec = CallRecord(index=k, start=time.perf_counter())

        def on_frame(t, frame):
            rec.frames.append(time.perf_counter())
            with trace.mark(trace.FRAME):
                pass

        try:
            with trace.mark(trace.CALL):
                out = self._engine(field_k, self.steps, on_frame)
        except Exception as exc:  # a job that raises counts as failed; the loop goes on
            rec.end = time.perf_counter()
            rec.error = f"{type(exc).__name__}: {exc}"
            return rec
        rec.end = time.perf_counter()
        rec.steps, rec.sim_ns = self.steps, self.steps * self.dt
        # keep one completed job, uniformly among them, drawn from the seed
        self._completed += 1
        if self._kept_rng.random() * self._completed < 1.0:
            self.kept = (k, out)
        return rec

    def window(self, seconds: float) -> tuple[list[CallRecord], float]:
        """Jobs until the first one that ends ``seconds`` after the window opened: (records, window s)."""
        records: list[CallRecord] = []
        begin = time.perf_counter()
        while True:
            rec = self.call(len(records))
            records.append(rec)
            if rec.end - begin >= seconds:
                return records, rec.end - begin

    # --- the check -------------------------------------------------------------------
    def reference(self, k: int, dtype) -> dict:
        """The plain reference (the configuration's reference module) of job ``k``'s
        first ``check_steps`` steps: the snapshots a run compares."""
        import importlib

        ref = importlib.import_module(f"benchmark.reference.{self.config['reference']}")
        return ref.simulate(self.config, self.mask, self.initial_field(k), self.check_steps, self.store_every,
                            self.device, dtype)
