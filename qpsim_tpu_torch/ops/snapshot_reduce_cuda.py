"""The light snapshot's reductions of a state on the card: wrapper of ``csrc/snapshot_reduce.cu``.

Replaces no TPU kernel: the JAX package reduces its first stored frame on
the host in float64, and so does the port on the CPU
(``solver.spectral_runner.light_on_host``).  On the card the coupled
runner reduces the t = 0 state of an integrated-detail run with this
kernel and copies only its four results to the host: the integrated frame
(× dE), the per-bin sums, the width-weighted phonon frame and the per-ω
sums, all float64.  The frames are the host reduction's bit for bit (each
value widened to float64, a pixel's planes added in numpy's pairwise order,
:func:`pairwise_planes`); the sums are deterministic, and agree with the
host's to about 1e-16.

:func:`snapshot_reduce` launches the kernel (two launches: the tiles, then
the sums of their partials) for CUDA tensors and runs
:func:`snapshot_reduce_plain` (the same reductions in plain PyTorch, the
frames in the same order) for CPU tensors; it never falls back.
"""

from __future__ import annotations

import torch

from ..utils.cuda_build import load_kernels, refuse_grad

__all__ = ["pairwise_planes", "snapshot_reduce", "snapshot_reduce_plain"]

F64 = torch.float64


def _check(q, ph, mask, widths) -> None:
    if q.dtype not in (torch.float32, torch.float64) or q.dim() != 3:
        raise TypeError(f"the state must be a 3-D float32 or float64 tensor, got {q.dim()}-D {q.dtype}")
    if tuple(mask.shape) != tuple(q.shape[1:]) or mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"the mask must be a bool or uint8 plane of shape {tuple(q.shape[1:])}")
    tensors = [q, mask]
    if ph is not None:
        if ph.dtype != q.dtype or ph.dim() != 3 or tuple(ph.shape[1:]) != tuple(q.shape[1:]):
            raise ValueError("the phonon state must be (NW, ny, nx) in the state's dtype")
        if widths is None or widths.dtype != F64 or tuple(widths.shape) != (ph.shape[0],):
            raise ValueError(f"the phonon widths must be float64 of shape ({ph.shape[0]},)")
        tensors += [ph, widths]
    if any(t.device != q.device for t in tensors):
        raise ValueError("every input must lie on the state's device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every input must be contiguous")


def pairwise_planes(x: torch.Tensor) -> torch.Tensor:
    """Σ over the planes of (n, pixels) ``x`` in numpy's pairwise order, which
    ``np.sum(x, axis=0)`` takes where the planes of a pixel lie together in memory
    (the runner's ``q[:, mask]``): runs of more than 128 split at n/2 rounded down
    to a multiple of 8; a run of 8 to 128 into eight accumulators, folded as a
    tree, then its last n % 8 planes in turn; a run of fewer than 8 in turn."""
    n = x.shape[0]
    if n > 128:
        n2 = n // 2 - (n // 2) % 8
        return pairwise_planes(x[:n2]) + pairwise_planes(x[n2:])
    if n < 8:
        res = torch.zeros_like(x[0])
        for i in range(n):
            res = res + x[i]
        return res
    m = n - n % 8
    r = x[:8].clone()
    for i in range(8, m, 8):
        r = r + x[i:i + 8]
    res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for i in range(m, n):
        res = res + x[i]
    return res


def snapshot_reduce_plain(q, ph, mask, widths, dE: float) -> list[torch.Tensor | None]:
    """[integrated frame × dE, bin sums, phonon frame, ω sums] in float64 (plain PyTorch).

    The frames add each pixel's planes as the kernel does (:func:`pairwise_planes`,
    then added to 0); they are 0 outside the mask.  ``ph`` None gives None for the
    phonon values.
    """
    ny, nx = mask.shape
    inside = mask.reshape(-1).bool()

    def interior(x):
        return x.reshape(x.shape[0], -1)[:, inside].to(F64)

    def placed(values):
        out = torch.zeros(ny * nx, dtype=F64, device=q.device)
        out[inside] = 0.0 + values
        return out.reshape(ny, nx)

    qi = interior(q)
    out = [placed(pairwise_planes(qi)) * dE, qi.sum(dim=1), None, None]
    if ph is not None:
        pi = interior(ph)
        out[2], out[3] = placed(pairwise_planes(pi * widths[:, None])), pi.sum(dim=1)
    return out


def _launch(q, ph, mask, widths, dE: float) -> list[torch.Tensor | None]:
    ne, ny, nx = q.shape
    nw = 0 if ph is None else ph.shape[0]
    n_pix = ny * nx
    lib = load_kernels()
    blocks = lib.qp_snapshot_reduce_blocks(n_pix)
    integrated = torch.empty((ny, nx), dtype=F64, device=q.device)
    ph_frame = None if ph is None else torch.empty((ny, nx), dtype=F64, device=q.device)
    sums = torch.empty(ne + nw, dtype=F64, device=q.device)
    partial = torch.empty(max(1, (ne + nw) * blocks), dtype=F64, device=q.device)
    fn = getattr(lib, f"qp_snapshot_reduce_{'f32' if q.dtype == torch.float32 else 'f64'}")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(
        q.data_ptr(), ptr(ph), mask.data_ptr(), ptr(widths), float(dE), ne, nw, n_pix,
        integrated.data_ptr(), ptr(ph_frame), sums.data_ptr(), partial.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"snapshot reduction kernel launch failed with CUDA error {err}")
    return [integrated, sums[:ne], ph_frame, None if ph is None else sums[ne:]]


def snapshot_reduce(q, ph, mask, widths, dE: float) -> list[torch.Tensor | None]:
    """The light snapshot's four float64 values of the state (q, ph): the kernel on CUDA
    tensors, :func:`snapshot_reduce_plain` on CPU tensors.

    ``mask`` is the film's (ny, nx) bool or uint8 plane, ``widths`` the (NW,) float64
    phonon widths (with ``ph`` None, no phonon values are formed and both may be None).
    """
    refuse_grad("the snapshot reduction kernel", "ops.snapshot_reduce_cuda.snapshot_reduce_plain",
                q, ph)
    _check(q, ph, mask, widths)
    if q.device.type == "cpu":
        return snapshot_reduce_plain(q, ph, mask, widths, dE)
    if q.device.type != "cuda":
        raise ValueError(f"the snapshot reduction kernel runs on CUDA tensors, got {q.device}")
    return _launch(q, ph, mask, widths, dE)
