"""Carry host-side data of the JAX package into the port's objects.

Everything crosses as numpy arrays, so tests can hand the port exactly the
operators and states that ``qpsim_tpu`` built, without relying on the
port's own copy of the host code.  Layouts are the JAX package's: states
(NE, Ny, Nx) and (NW, Ny, Nx).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.collisions import (
    DEFAULT_PIXEL_CHUNK,
    AnalyticTables,
    CollisionPlan,
    build_analytic_plan,
    build_collision_plan_arrays,
)
from .ops.diffusion import SplitOperator
from .ops.phonon_map import PhononFrequencyMap

__all__ = [
    "split_operator_from_numpy",
    "collision_tables_from_numpy",
    "analytic_tables_from_numpy",
    "phonon_map_from_numpy",
    "state_to_torch",
    "state_to_numpy",
]


def split_operator_from_numpy(
    *, ax_lo, ax_hi, ax_diag, sx, ay_lo, ay_hi, ay_diag, sy, mask, bin_scale=None
) -> SplitOperator:
    """A port ``SplitOperator`` from the fields of a ``qpsim_tpu`` one.

    ``split_operator_from_numpy(**vars(jax_op))`` converts one directly.
    """
    f64 = lambda a: np.array(a, dtype=np.float64)
    return SplitOperator(
        ax_lo=f64(ax_lo), ax_hi=f64(ax_hi), ax_diag=f64(ax_diag), sx=f64(sx),
        ay_lo=f64(ay_lo), ay_hi=f64(ay_hi), ay_diag=f64(ay_diag), sy=f64(sy),
        mask=np.array(mask, dtype=bool),
        bin_scale=None if bin_scale is None else f64(bin_scale),
    )


def collision_tables_from_numpy(
    *,
    dE: float,
    rho,
    K_s0,
    K_r0,
    omega_bins,
    idx_diff,
    idx_sum,
    diff_sign,
    enable_scattering: bool,
    enable_recombination: bool,
    update_phonons: bool,
    device,
    dtype: torch.dtype,
    pixel_chunk: int = DEFAULT_PIXEL_CHUNK,
    gap_id=None,
) -> CollisionPlan:
    """A collision plan from ρ, K^s₀, K^r₀ and a ``PhononFrequencyMap``'s maps.

    ``rho`` (NE,) with ``K_*`` (NE, NE) for one gap, or the per-gap stacks
    (G, NE) and (G, NE, NE) with the dense (Ny, Nx) ``gap_id`` plane, as
    the JAX package's ``build_collision_plan_arrays`` takes them.
    """
    return build_collision_plan_arrays(
        dE=dE,
        rho=np.asarray(rho, dtype=np.float64),
        K_r0=None if K_r0 is None else np.asarray(K_r0, dtype=np.float64),
        K_s0=None if K_s0 is None else np.asarray(K_s0, dtype=np.float64),
        pmap=phonon_map_from_numpy(omega_bins, idx_diff, idx_sum, diff_sign),
        enable_recombination=enable_recombination,
        enable_scattering=enable_scattering,
        update_phonons=update_phonons,
        device=device,
        dtype=dtype,
        pixel_chunk=pixel_chunk,
        gap_id=None if gap_id is None else np.asarray(gap_id, dtype=np.int64),
    )


def analytic_tables_from_numpy(
    *,
    E_bins,
    dE: float,
    gap_plane,
    omega_bins,
    idx_diff,
    idx_sum,
    diff_sign,
    tau_s: float | None,
    tau_r: float | None,
    T_c: float,
    dynes_gamma: float,
    update_phonons: bool,
    device,
    dtype: torch.dtype,
    pixel_chunk: int = DEFAULT_PIXEL_CHUNK,
) -> tuple[CollisionPlan, AnalyticTables]:
    """The analytic-gap plan and tables from the arguments of the JAX package's
    ``build_pallas_collision_step_analytic`` (``tau_s``/``tau_r`` None = channel off)."""
    return build_analytic_plan(
        E_bins=np.asarray(E_bins, dtype=np.float64),
        dE=dE,
        gap_plane=np.asarray(gap_plane, dtype=np.float64),
        pmap=phonon_map_from_numpy(omega_bins, idx_diff, idx_sum, diff_sign),
        tau_s=tau_s,
        tau_r=tau_r,
        T_c=T_c,
        dynes_gamma=dynes_gamma,
        update_phonons=update_phonons,
        device=device,
        dtype=dtype,
        pixel_chunk=pixel_chunk,
    )


def phonon_map_from_numpy(omega_bins, idx_diff, idx_sum, diff_sign) -> PhononFrequencyMap:
    """A port ``PhononFrequencyMap`` from the maps of a ``qpsim_tpu`` one
    (its one-hot scatter matrices are formed from the index maps when read)."""
    return PhononFrequencyMap(
        omega_bins=np.array(omega_bins, dtype=np.float64),
        idx_diff=np.array(idx_diff, dtype=np.int32),
        idx_sum=np.array(idx_sum, dtype=np.int32),
        diff_sign=np.array(diff_sign, dtype=np.int8),
    )


def state_to_torch(q, ph, device, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, ph) numpy arrays → tensors on ``device`` in ``dtype``."""
    as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
    return as_t(q), as_t(ph)


def state_to_numpy(q: torch.Tensor, ph: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(q, ph) tensors → float64 numpy copies on the host."""
    as_np = lambda t: t.detach().to("cpu", torch.float64).numpy().copy()
    return as_np(q), as_np(ph)
