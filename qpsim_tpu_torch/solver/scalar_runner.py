"""Scalar (energy-integrated) mode runner.

Carried over from ``qpsim_tpu.solver.scalar_runner``: one CN field, no
collisions, and the fixed-temperature phonon scaffold.  The state is
(1, Ny, Nx) on the device; a segment applies the backend's step ``length``
times in a Python loop with no host sync inside it, and a stored segment
copies the state to the host once for its snapshot.  With a
``checkpointer`` every stored snapshot is saved and a rerun resumes from
the aligned prefix; with a ``frame_sink`` each snapshot is streamed
instead of kept.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.diffusion import build_directional_stencils, fold_diffusion
from .diffusion_backends import choose_backend
from .phonon_history import build_fixed_phonon_history, reconstruct_field
from .stepping import _color_limits, _limits_from_running, _notify, _usable_resume_prefix

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
    checkpointer=None,
    frame_sink=None,
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

    times: list[float] = []
    frames: list[np.ndarray] = []
    mass: list[float] = []
    running_limits = [float("inf"), float("-inf")]  # streaming-mode color limits

    def emit(t: float, frame: np.ndarray, m: float) -> np.ndarray:
        # one stored snapshot: stream it or keep it, never both
        idx = len(times)
        times.append(float(t))
        mass.append(m)
        if frame_sink is not None:
            running_limits[0] = min(running_limits[0], float(np.nanmin(frame)))
            running_limits[1] = max(running_limits[1], float(np.nanmax(frame)))
            frame_sink.write(idx, float(t), frame=frame, mass=m)
        else:
            frames.append(frame)
        return frame

    current_time = 0.0
    step_counter = 0
    stored_idx = 0
    completed_steps = 0
    replay = _usable_resume_prefix(checkpointer, segments) if checkpointer is not None else []
    if replay:
        # rebuild the stored history from the checkpoints and continue from
        # the last aligned one: results match an uninterrupted run exactly
        for payload in replay:
            emit(payload["time_ns"], *snapshot(np.asarray(payload["q"], dtype=np.float64)))
        resume = replay[-1]
        state = torch.as_tensor(resume["q"], dtype=dtype, device=device)
        completed_steps = step_counter = resume["step"]
        current_time = resume["time_ns"]
    else:
        frame0 = emit(0.0, reconstruct_field(mask, interior0), float(np.sum(interior0) * dx * dx))
        _notify(progress_callback, 0.0, frame0)
        if checkpointer is not None:
            # the host state in float64, as the first frame is formed from it
            checkpointer.save_step(0, step=0, time_ns=0.0, q=state_np)

    cumulative = 0
    for seg in segments:
        cumulative += seg.length
        if cumulative <= completed_steps:  # replayed from the checkpoints
            stored_idx += int(seg.stored)
            continue
        if backend is not None:
            step = step_for(seg.dt)
            for _ in range(seg.length):
                state = step(state)
        step_counter += seg.length
        current_time += seg.dt * seg.length
        if seg.stored:
            stored_idx += 1
            q_host = state.to("cpu")
            frame = emit(current_time, *snapshot(q_host.to(torch.float64).numpy()))
            _notify(progress_callback, current_time, frame)
            if checkpointer is not None:
                checkpointer.save_step(
                    stored_idx, step=step_counter, time_ns=float(current_time), q=q_host
                )
    if checkpointer is not None:
        checkpointer.finalize()

    if phonon_history_out is not None:
        # the scalar scaffold is synthetic (fixed bath temperature, not
        # evolved state), so it is never streamed
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
    if frame_sink is not None:
        return times, [], mass, _limits_from_running(running_limits), None, None
    return times, frames, mass, _color_limits(frames), None, None
