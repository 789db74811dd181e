"""Scalar (energy-integrated) mode runner.

Carried over from ``qpsim_tpu.solver.scalar_runner``: one CN field, no
collisions, and the fixed-temperature phonon scaffold.  The state is
(1, Ny, Nx) on the device; a segment applies the backend's step ``length``
times in a Python loop with no host sync inside it, and a stored segment
copies the state to the host once for its snapshot.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.diffusion import build_directional_stencils, fold_diffusion
from .diffusion_backends import choose_backend
from .phonon_history import build_fixed_phonon_history, reconstruct_field
from .stepping import _color_limits, _notify

__all__ = ["_run_scalar"]


def _run_scalar(
    *,
    mask,
    edges,
    edge_conditions,
    initial_field,
    diffusion_coefficient,
    dx,
    segments,
    enable_diffusion,
    bath_temperature,
    phonon_history_out,
    progress_callback,
    diffusion_backend,
    device,
    dtype,
):
    interior0 = initial_field[mask].astype(np.float64)
    ny, nx = mask.shape
    state_np = np.zeros((1, ny, nx), dtype=np.float64)
    state_np[0][mask] = interior0
    state = torch.as_tensor(state_np, dtype=dtype, device=device)

    backend = None
    if enable_diffusion:
        x_st, y_st = build_directional_stencils(mask, edges, edge_conditions, dx)
        op = fold_diffusion(x_st, y_st, mask, dx, float(diffusion_coefficient))
        backend = choose_backend(op, device, dtype, diffusion_backend)
    steps: dict[float, Callable[[torch.Tensor], torch.Tensor]] = {}

    def step_for(seg_dt: float):
        if seg_dt not in steps:
            steps[seg_dt] = backend.make_step(seg_dt)
        return steps[seg_dt]

    def snapshot(q_host: np.ndarray):
        values = q_host[0][mask]
        return reconstruct_field(mask, values), float(np.sum(values) * dx * dx)

    times: list[float] = [0.0]
    frames: list[np.ndarray] = [reconstruct_field(mask, interior0)]
    mass: list[float] = [float(np.sum(interior0) * dx * dx)]
    _notify(progress_callback, 0.0, frames[0])

    current_time = 0.0
    for seg in segments:
        if backend is not None:
            step = step_for(seg.dt)
            for _ in range(seg.length):
                state = step(state)
        current_time += seg.dt * seg.length
        if seg.stored:
            frame, m = snapshot(state.to("cpu", torch.float64).numpy())
            times.append(float(current_time))
            frames.append(frame)
            mass.append(m)
            _notify(progress_callback, current_time, frame)

    if phonon_history_out is not None:
        ph_frames, ph_energy, ph_bins, ph_meta = build_fixed_phonon_history(
            mask=mask, times=times, bath_temperature=bath_temperature, phonon_energy_bins=None
        )
        phonon_history_out.update(
            {
                "phonon_frames": ph_frames,
                "phonon_energy_frames": ph_energy,
                "phonon_energy_bins": ph_bins,
                "phonon_metadata": ph_meta,
            }
        )
    return times, frames, mass, _color_limits(frames), None, None
