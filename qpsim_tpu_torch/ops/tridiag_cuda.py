"""The batched Thomas solve on the card: wrapper of the CUDA kernel ``csrc/tridiag.cu``.

Port of ``qpsim_tpu.ops.pallas_tridiag.tridiag_solve_pallas`` (kernel
``_thomas_kernel``): T x = rhs along the last axis for every leading index,
``sub[..., 0]`` and ``sup[..., -1]`` ignored, zero couplings decoupling
intervals exactly.  As in the JAX wrapper, the line axis is moved first
(an (N, B) copy), so that consecutive threads read consecutive lines.

:func:`thomas` launches the kernel for CUDA tensors and runs
:func:`thomas_plain` (the plain Thomas solve) for CPU tensors; it never
falls back.  ``set_default_solver("pallas")`` puts it under every
``tridiag_solve`` call.
"""

from __future__ import annotations

import torch

from ..utils.cuda_build import load_kernels
from .tridiag import tridiag_solve_thomas as thomas_plain

__all__ = ["LAUNCHES", "thomas", "thomas_plain"]

#: launches of the Thomas kernel since import (or since the caller reset it)
LAUNCHES = {"thomas": 0}


def _launch(sub, diag, sup, rhs) -> torch.Tensor:
    if rhs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Thomas kernel takes float32 or float64, got {rhs.dtype}")
    for t in (sub, diag, sup):
        if t.device != rhs.device or t.dtype != rhs.dtype:
            raise ValueError("sub, diag, sup and rhs must share the device and dtype")
    sub, diag, sup, rhs = torch.broadcast_tensors(sub, diag, sup, rhs)
    shape = rhs.shape
    n = shape[-1]
    if n == 1:
        return rhs / diag
    # (N, B): the line axis first, every sweep row one contiguous run of lines
    a, b, c, r = (t.reshape(-1, n).t().contiguous() for t in (sub, diag, sup, rhs))
    batch = r.shape[1]
    x = torch.empty_like(r)
    w_scratch = torch.empty_like(r)  # c′ of the sweep; d′ lives in x
    lib = load_kernels()
    fn = lib.qp_thomas_f32 if r.dtype == torch.float32 else lib.qp_thomas_f64
    err = fn(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), r.data_ptr(), x.data_ptr(),
        w_scratch.data_ptr(), n, batch, torch.cuda.current_stream(r.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"Thomas kernel launch failed with CUDA error {err}")
    LAUNCHES["thomas"] += 1
    return x.t().reshape(shape)


def thomas(sub: torch.Tensor, diag: torch.Tensor, sup: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Thomas solve along the last axis through the CUDA kernel (plain version on the CPU)."""
    if rhs.device.type == "cpu":
        return thomas_plain(sub, diag, sup, rhs)
    if rhs.device.type != "cuda":
        raise ValueError(f"Thomas kernel runs on CUDA tensors, got {rhs.device}")
    return _launch(sub, diag, sup, rhs)
