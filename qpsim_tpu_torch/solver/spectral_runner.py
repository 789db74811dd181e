"""Energy-resolved mode runner.

Carried over from ``qpsim_tpu.solver.spectral_runner``: initial state
assembly, Pauli policy enforcement, the snapshot pipeline (``full`` and
on-device ``integrated`` detail), host-mode generation (one host
evaluation, one add and one one-step segment per step) and the depth-1 segment
pipeline — each segment's statistics and stored state start their copy to
the host right after the segment is enqueued, and are drained after the
NEXT segment is enqueued, so the host's snapshot work overlaps the
device's compute while frames, callbacks and errors keep program order.

The default initial state — energy weights ⊗ the initial field's interior
values for the quasiparticles, the bath's Bose–Einstein occupation for the
phonons — is formed on the device in the state dtype (on the CPU in float64
it is the JAX package's host state bit for bit); an ``initial_condition_spec``
is evaluated on the host in float64 (``fields``), as in the JAX package, and
copied over once.  The first stored frame is read back from the device
state and reduced in float64 as the JAX package reduces its host state: on
the host (:func:`light_on_host`), or, for an integrated-detail state on a
card, by the snapshot kernel (``ops.snapshot_reduce_cuda``), which gives
the same frames bit for bit and copies only its results to the host.
Every stored frame — the first, a replayed one, a later one — goes the same
way: the runner's ``start_frame`` chooses how it is reduced and starts its
copy, and ``record`` keeps or streams the host result.

With a ``checkpointer`` every stored snapshot's full state is saved (in
light mode too: it is the resume data), and a rerun replays the aligned
prefix of the checkpoints and skips the segments they cover; with a
``frame_sink`` each stored snapshot is streamed instead of kept.

With a ``mesh`` the state is split into this process's shards once, after
the first frame (or the resumed state), and put back together for each
stored frame and checkpoint (``EngineProgram.shard`` / ``gather``).

Under an active profiler the run's phases are spans (``qpsim.build``,
``qpsim.initial_state``, ``qpsim.first_frame``, ``qpsim.segment``,
``qpsim.drain``, ``qpsim.store`` …, :func:`~qpsim_tpu_torch.utils.profiling.span`);
:data:`COPIES` (``stepping``'s, shared with the scalar runner) counts,
always, the bytes it copies to the host, and :data:`FIRST_FRAMES` where
each first frame was reduced.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import build_initial_phonon_energy_state, build_initial_qp_energy_state
from ..io.precompute import precompute_arrays
from ..models.params import SimulationParameters, normalize_collision_solver_name
from ..ops.dos import dynes_density_of_states, thermal_phonon_occupation
from ..ops.energy_grid import build_energy_grid, integration_widths_from_centers
from ..ops.generation import evaluate_generation_host
from ..ops.snapshot_reduce_cuda import snapshot_reduce
from ..utils.profiling import span
from .pauli import PauliEnforcer
from .phonon_history import reconstruct_field
from .program_build import build_engine_program
from .stepping import (
    COPIES,
    _color_limits,
    _counted,
    _limits_from_running,
    _notify,
    _usable_resume_prefix,
)

__all__ = ["_run_energy_resolved", "COPIES", "FIRST_FRAMES", "light_on_host"]

#: first stored frames (t = 0, or a resumed call's replayed one) reduced
#: since import: on the card by the snapshot kernel, or on the host
FIRST_FRAMES = {"first_frames_on_card": 0, "first_frames_on_host": 0}


def light_on_host(q_host, ph_host, mask, dE, phonon_widths) -> list:
    """The light reductions of a host state in float64, as the JAX package reduces its
    host state: the integrated frame (× dE, NaN outside the mask) and the per-bin
    sums, and with ``ph_host`` the width-weighted phonon frame and the per-ω sums."""
    interior = q_host.astype(np.float64)[:, mask]
    out = [reconstruct_field(mask, np.sum(interior, axis=0) * dE), np.sum(interior, axis=1), None, None]
    if ph_host is not None:
        ph_interior = ph_host.astype(np.float64)[:, mask]
        out[2] = reconstruct_field(mask, np.sum(ph_interior * phonon_widths[:, None], axis=0))
        out[3] = np.sum(ph_interior, axis=1)
    return out


class _OnHost(list):
    """Host arrays already in hand (a replayed checkpoint's), read as a :class:`_HostCopy` is."""

    def __init__(self, *arrays: np.ndarray | None):
        super().__init__(arrays)

    def get(self) -> list[np.ndarray | None]:
        return self


class _HostCopy:
    """Device→host copies started now and waited for at :meth:`get`.

    On a CUDA device the copies go to pinned host memory without blocking,
    behind the work already enqueued on the stream, and an event marks
    their end; on the CPU they are plain copies (never views of the state,
    which later steps replace).
    """

    def __init__(self, *tensors: torch.Tensor | None):
        cuda = any(t is not None and t.is_cuda for t in tensors)
        self._host = []
        for t in tensors:
            if t is None:
                self._host.append(None)
                continue
            _counted(t)
            if cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            else:
                self._host.append(t.clone())
        self._event = None
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def get(self) -> list[np.ndarray | None]:
        with span("qpsim.copy_wait"):
            if self._event is not None:
                self._event.synchronize()
            return [None if h is None else h.numpy() for h in self._host]


def _run_energy_resolved(
    *,
    mask,
    edges,
    edge_conditions,
    initial_field,
    diffusion_coefficient,
    dt,
    dx,
    segments,
    total_steps,
    energy_gap,
    energy_min_factor,
    energy_max_factor,
    num_energy_bins,
    energy_weights,
    enable_diffusion,
    enable_recombination,
    enable_scattering,
    dynes_gamma,
    collision_solver,
    tau_s_eff,
    tau_r_eff,
    T_c,
    bath_temperature,
    external_generation,
    photon_drive=None,
    initial_condition_spec=None,
    gap_expression,
    precomputed,
    pauli_warn_threshold,
    pauli_error_threshold,
    enforce_pauli,
    pauli_density_floor,
    freeze_phonon_dynamics,
    phonon_history_out,
    progress_callback,
    diffusion_backend,
    device,
    dtype,
    pixel_chunk,
    collision_backend="auto",
    strang_mode="exact",
    snapshot_detail="full",
    checkpointer=None,
    frame_sink=None,
    mesh=None,
    mesh_y_solve="wang",
):
    gap = float(energy_gap)
    ny, nx = mask.shape
    n_spatial = int(mask.sum())
    E_bins, dE = build_energy_grid(gap, energy_min_factor, energy_max_factor, num_energy_bins)
    normalize_collision_solver_name(collision_solver)

    custom_qp_state = None
    if initial_condition_spec is not None:
        custom_qp_state = build_initial_qp_energy_state(mask, E_bins, initial_condition_spec)

    copied_before = COPIES["host_copy_bytes"]
    with span("qpsim.build"):
        # Auto-precompute diffusion arrays when a gap map is requested.
        if precomputed is None and str(gap_expression or "").strip():
            auto_params = SimulationParameters(
                diffusion_coefficient=diffusion_coefficient,
                dt=dt,
                total_time=max(dt, dt * max(1, total_steps)),
                mesh_size=dx,
                energy_gap=energy_gap,
                energy_min_factor=energy_min_factor,
                energy_max_factor=energy_max_factor,
                num_energy_bins=num_energy_bins,
                dynes_gamma=dynes_gamma,
                gap_expression=gap_expression,
                tau_0=0.5 * (tau_s_eff + tau_r_eff),
                tau_s=tau_s_eff,
                tau_r=tau_r_eff,
                T_c=T_c,
                bath_temperature=bath_temperature,
            )
            precomputed = precompute_arrays(
                mask, edges, edge_conditions, auto_params, include_collision_kernels=False
            )
        nonuniform_gap = precomputed is not None and not bool(
            np.asarray(precomputed.get("is_uniform", True)).reshape(-1)[0]
        )

        prog = build_engine_program(
            mask=mask,
            edges=edges,
            edge_conditions=edge_conditions,
            dx=dx,
            device=device,
            dtype=dtype,
            gap=gap,
            E_bins=E_bins,
            dE=dE,
            num_energy_bins=num_energy_bins,
            diffusion_coefficient=diffusion_coefficient,
            enable_diffusion=enable_diffusion,
            diffusion_backend=diffusion_backend,
            precomputed=precomputed,
            nonuniform_gap=nonuniform_gap,
            enable_recombination=enable_recombination,
            enable_scattering=enable_scattering,
            dynes_gamma=dynes_gamma,
            tau_s_eff=tau_s_eff,
            tau_r_eff=tau_r_eff,
            T_c=T_c,
            freeze_phonon_dynamics=freeze_phonon_dynamics,
            collision_backend=collision_backend,
            pixel_chunk=pixel_chunk,
            external_generation=external_generation,
            pauli_density_floor=pauli_density_floor,
            strang_mode=strang_mode,
            photon_drive=photon_drive,
            mesh=mesh,
            mesh_y_solve=mesh_y_solve,
        )
    omega_bins = prog.pmap.omega_bins

    # --- initial states (weights at the uniform energy_gap's DOS, gap map or not)
    with span("qpsim.initial_state"):
        nw = omega_bins.size
        mask_d = torch.as_tensor(mask, device=device)
        if custom_qp_state is not None:
            state_flat = np.asarray(custom_qp_state, dtype=np.float64)
            if state_flat.shape != (num_energy_bins, n_spatial):
                raise ValueError(
                    "Full custom quasiparticle profile must have shape "
                    f"({num_energy_bins}, {n_spatial}); got {state_flat.shape}."
                )
            if not np.all(np.isfinite(state_flat)):
                raise ValueError("Full custom quasiparticle profile produced non-finite values.")
            if np.any(state_flat < 0):
                raise ValueError("Full custom quasiparticle profile must be non-negative.")
            q = torch.zeros((num_energy_bins, ny, nx), dtype=dtype, device=device)
            q[:, mask_d] = torch.as_tensor(state_flat, dtype=dtype, device=device)
        else:
            if energy_weights is not None:
                raw_w = np.asarray(energy_weights, dtype=np.float64)
                if raw_w.ndim != 1:
                    raise ValueError("energy_weights must be a 1D array.")
                if raw_w.shape[0] != num_energy_bins:
                    raise ValueError(
                        f"energy_weights must have length {num_energy_bins}, got {raw_w.shape[0]}."
                    )
                if not np.all(np.isfinite(raw_w)):
                    raise ValueError("energy_weights must contain only finite values.")
                if np.any(raw_w < 0):
                    raise ValueError("energy_weights must be non-negative.")
            else:
                raw_w = dynes_density_of_states(E_bins, gap, dynes_gamma)
            integral = float(np.sum(raw_w) * dE)
            weights = (
                raw_w / integral if integral > 0 else np.full(num_energy_bins, 1.0 / (num_energy_bins * dE))
            )
            # weights ⊗ interior values, scattered into the mask, on the device
            spatial = torch.as_tensor(np.asarray(initial_field, dtype=np.float64), dtype=dtype, device=device)
            w_col = torch.as_tensor(weights, dtype=dtype, device=device)[:, None]
            q = torch.zeros((num_energy_bins, ny, nx), dtype=dtype, device=device)
            q[:, mask_d] = w_col * spatial[mask_d][None, :]

        if initial_condition_spec is not None:
            phonon_flat = build_initial_phonon_energy_state(
                mask, omega_bins, initial_condition_spec, bath_temperature
            )
            ph = torch.zeros((nw, ny, nx), dtype=dtype, device=device)
            ph[:, mask_d] = torch.as_tensor(phonon_flat, dtype=dtype, device=device)
        else:
            occ = thermal_phonon_occupation(omega_bins, bath_temperature)
            ph = torch.as_tensor(occ, dtype=dtype, device=device)[:, None, None] * mask_d.to(dtype)

        # --- Pauli monitoring ------------------------------------------------------
        enforcer = PauliEnforcer(
            E_bins=E_bins,
            grid_shape=(ny, nx),
            enforce=enforce_pauli,
            warn_threshold=pauli_warn_threshold,
            error_threshold=pauli_error_threshold,
        )
        enforcer.check_row(0, 0.0, _counted(prog.pauli_stats(q)).cpu().numpy())

    # --- snapshot bookkeeping ----------------------------------------------------
    record_phonons = phonon_history_out is not None
    phonon_widths = (
        integration_widths_from_centers(omega_bins, fallback_width=dE) if record_phonons else None
    )
    phonon_frames_hist: list[np.ndarray] = []
    phonon_energy_frames_hist: list[list[np.ndarray]] = []
    times: list[float] = []
    frames: list[np.ndarray] = []
    energy_frames: list[list[np.ndarray]] = []
    mass: list[float] = []
    running_limits = [float("inf"), float("-inf")]  # streaming-mode color limits

    # light ("integrated") snapshots: the stored observables are reduced and
    # only the reductions reach the host — the integrated 2D frame (already
    # ×dE), per-bin pixel sums and, when recorded, the width-weighted phonon
    # occupation frame and per-ω pixel sums
    light = snapshot_detail == "integrated"
    if light:
        mask_f = torch.as_tensor(mask, dtype=dtype, device=device)
        phw_d = (torch.as_tensor(phonon_widths, dtype=dtype, device=device)[:, None, None]
                 if record_phonons else None)
    # a light run's first frame is reduced in float64 where the state lies
    first_on_card = light and q.is_cuda

    def start_frame(q, ph, first: bool = False):
        """Start one stored frame: choose how it is reduced, and start its copy to the host.

        ``q``/``ph`` are the device state (a mesh's shards after the first frame) or a
        replayed checkpoint's host arrays.  Returns ``(copy, finish)``, ``finish(copy.get())``
        being ``(sums, state)``: the four light reductions (None in full detail) and the
        host state a checkpoint saves.  A frame is reduced

        * in full detail: on the host in float64 (``record``), from q and, where phonons are
          recorded or the state checkpointed, ph;
        * integrated, the first frame on a card: by the snapshot kernel, which gives the
          frames of :func:`light_on_host` bit for bit;
        * integrated, the first frame elsewhere: on the host by :func:`light_on_host`, as the
          JAX package reduces its host state;
        * integrated, a later frame: on the device in the state dtype.

        A replayed frame is reduced as the run reduced it: from its host arrays where the
        run reduced it on the host, else uploaded to the device.
        """
        if first:
            FIRST_FRAMES["first_frames_on_card" if first_on_card else "first_frames_on_host"] += 1
        replayed = isinstance(q, np.ndarray)
        keep = checkpointer is not None and not replayed  # the full state IS the resume data
        if not (first or replayed):
            q, ph = prog.gather(q), prog.gather(ph)  # a mesh's shards, put together
        if not light or (first and not first_on_card):
            copy = _OnHost(q, ph) if replayed else _HostCopy(q, ph if record_phonons or keep else None)
            if not light:
                return copy, lambda host: (None, host)
            return copy, lambda host: (
                light_on_host(host[0], host[1] if record_phonons else None, mask, dE, phonon_widths), host)
        if replayed:
            q, ph = (None if a is None else torch.as_tensor(a, dtype=dtype, device=device) for a in (q, ph))
        if first:
            widths = torch.as_tensor(phonon_widths, device=q.device) if record_phonons else None
            sums = snapshot_reduce(q.contiguous(), ph.contiguous() if record_phonons else None,
                                   mask_d.contiguous(), widths, dE)
        else:
            # the sums run over a contiguous copy: their order then does not
            # depend on the layout a step left the state in, so a state restored
            # from a checkpoint reduces to the same bits
            qm = q.contiguous() * mask_f  # anything outside the mask must not leak in
            sums = [qm.sum(dim=0) * dE, qm.sum(dim=(1, 2)), None, None]
            if record_phonons:
                phm = ph.contiguous() * mask_f
                sums[2:] = [(phm * phw_d).sum(dim=0), phm.sum(dim=(1, 2))]
        return _HostCopy(*sums, *((q, ph) if keep else ())), lambda host: (host[:4], host[4:])

    def record(t: float, sums, state: list) -> np.ndarray:
        """Keep or stream one stored snapshot from its host result (``start_frame``'s
        ``finish``): the light reductions, or in full detail the state, reduced here in
        float64.  Returns its frame."""
        if sums is not None:
            integrated, bin_sums, ph_int, ph_bin_sums = (
                None if a is None else np.asarray(a, dtype=np.float64) for a in sums)
            frame = np.where(mask, integrated, np.nan)
            m = float(np.sum(bin_sums) * dE * dx * dx)
            extra = dict(
                phonon_frame=None if ph_int is None else np.where(mask, ph_int, np.nan),
                energy_bin_sums=bin_sums, phonon_bin_sums=ph_bin_sums,
            )
        else:
            interior = state[0].astype(np.float64)[:, mask]
            integrated = np.sum(interior, axis=0) * dE
            frame = reconstruct_field(mask, integrated)
            m = float(np.sum(integrated) * dx * dx)
            extra = dict(energy_frames=[reconstruct_field(mask, interior[i]) for i in range(num_energy_bins)],
                         phonon_frame=None, phonon_energy_frames=None)
            if record_phonons and state[1] is not None:
                ph_interior = state[1].astype(np.float64)[:, mask]
                extra["phonon_frame"] = reconstruct_field(
                    mask, np.sum(ph_interior * phonon_widths[:, None], axis=0))
                extra["phonon_energy_frames"] = [reconstruct_field(mask, ph_interior[i]) for i in range(nw)]
        idx = len(times)
        times.append(float(t))
        mass.append(m)
        if frame_sink is not None:
            running_limits[0] = min(running_limits[0], float(np.nanmin(frame)))
            running_limits[1] = max(running_limits[1], float(np.nanmax(frame)))
            frame_sink.write(idx, float(t), frame=frame, mass=m, **extra)
            return frame
        frames.append(frame)
        for hist, key in ((energy_frames, "energy_frames"), (phonon_frames_hist, "phonon_frame"),
                          (phonon_energy_frames_hist, "phonon_energy_frames")):
            if extra.get(key) is not None:
                hist.append(extra[key])
        return frame

    stored_idx = -1  # the index of the last stored frame

    def store(t: float, step: int, pending) -> None:
        """One stored frame's host work: wait for its copy, record it, call back, checkpoint."""
        nonlocal stored_idx
        stored_idx += 1
        copy, finish = pending
        with span("qpsim.store"):
            host = copy.get()
            with span("qpsim.reduce"):
                sums, state = finish(host)
                frame = record(t, sums, state)
            _notify(progress_callback, t, frame)
            if checkpointer is not None:
                checkpointer.save_step(stored_idx, step=step, time_ns=float(t), q=state[0], ph=state[1])

    current_time = 0.0
    step_counter = 0
    completed_steps = 0
    replay = _usable_resume_prefix(checkpointer, segments) if checkpointer is not None else []
    if replay:
        # rebuild the stored history from the checkpoints and continue from
        # the last aligned one — results match an uninterrupted run exactly
        for payload in replay:
            copy, finish = start_frame(payload["q"], payload.get("ph"), first=payload["stored_idx"] == 0)
            record(payload["time_ns"], *finish(copy.get()))
        resume = replay[-1]
        q = torch.as_tensor(resume["q"], dtype=dtype, device=device).clone()
        if "ph" in resume:
            ph = torch.as_tensor(resume["ph"], dtype=dtype, device=device).clone()
        completed_steps = step_counter = resume["step"]
        current_time = resume["time_ns"]
        # stored_idx advances through the skipped segments below, reaching
        # resume["stored_idx"] exactly when the replay is complete
        stored_idx = 0
    else:
        # the first frame is read from the device state; on the card only the
        # kernel's results cross, and the state too where a checkpoint saves it
        with span("qpsim.first_frame"):
            store(0.0, 0, start_frame(q, ph, first=True))

    COPIES["initial_copy_bytes"] += COPIES["host_copy_bytes"] - copied_before

    # --- main loop --------------------------------------------------------------
    q, ph = prog.shard(q), prog.shard(ph)  # a mesh's runner steps this process's shards
    gen_mode = external_generation.normalized_mode() if external_generation else "none"

    def drain(p) -> None:
        with span("qpsim.drain"):
            stats_np = p["stats"].get()[0]
            flags = p["flags"]
            if stats_np.shape[1] > 4:  # the traced generation's device flags
                flags = flags | (stats_np[:, 4:6] != 0)
            t = p["t_start"]
            for i in range(p["seg"].length):
                t += p["seg"].dt
                if flags[i, 0]:
                    raise ValueError(
                        f"External generation mode '{gen_mode}' produced non-finite values."
                    )
                if flags[i, 1]:
                    raise ValueError(
                        f"External generation mode '{gen_mode}' produced negative values. "
                        "Generation rates must be non-negative."
                    )
                enforcer.check_row(p["step_start"] + i + 1, t, stats_np[i])
            if p["snapshot"] is not None:
                store(t, p["step_start"] + p["seg"].length, p["snapshot"])

    pending = None
    cumulative = 0
    for seg in segments:
        cumulative += seg.length
        if cumulative <= completed_steps:  # replayed from the checkpoints
            stored_idx += int(seg.stored)
            continue
        if prog.host_gen:
            # host-evaluated generation needs the host between every step —
            # inherently sequential, no pipelining
            with span("qpsim.segment"):
                one = prog.segment_runner(seg.dt, 1)
                for _ in range(seg.length):
                    g_host = evaluate_generation_host(
                        external_generation, E_bins, n_spatial, current_time, mask
                    )
                    if g_host is not None:
                        g_dense = torch.zeros((num_energy_bins, ny, nx), dtype=dtype, device=device)
                        g_dense[:, mask_d] = torch.as_tensor(g_host, dtype=dtype, device=device)
                        q = prog.shard(prog.gather(q) + seg.dt * g_dense)
                    q, ph, stats, _ = one(q, ph, current_time)
                    step_counter += 1
                    current_time += seg.dt
                    enforcer.check_row(step_counter, current_time, _counted(stats[0]).cpu().numpy())
            if seg.stored:
                store(current_time, step_counter, start_frame(q, ph))
            continue
        with span("qpsim.segment"):
            q, ph, stats, flags = prog.segment_runner(seg.dt, seg.length)(q, ph, current_time)
            new_pending = {
                "seg": seg,
                "stats": _HostCopy(stats),
                "flags": flags,
                "snapshot": start_frame(q, ph) if seg.stored else None,
                "step_start": step_counter,
                "t_start": current_time,
            }
        step_counter += seg.length
        for _ in range(seg.length):  # sequential adds: bit-identical times
            current_time += seg.dt
        if pending is not None:
            drain(pending)
        pending = new_pending
    if pending is not None:
        drain(pending)
    with span("qpsim.finish"):
        if checkpointer is not None:
            checkpointer.finalize()

        if phonon_history_out is not None:
            phonon_history_out.clear()
            phonon_history_out.update(
                {
                    "phonon_frames": phonon_frames_hist,
                    "phonon_energy_frames": phonon_energy_frames_hist,
                    "phonon_energy_bins": np.asarray(omega_bins, dtype=np.float64).copy(),
                    "phonon_metadata": {
                        "mode": "dynamic_local_coupled",
                        "field_units": "integrated_occupation",
                        "energy_frame_units": "occupation",
                        **({"streamed": True} if frame_sink is not None else {}),
                        **({"detail": "integrated"} if light else {}),
                    },
                }
            )
        if frame_sink is not None:
            return times, [], mass, _limits_from_running(running_limits), None, E_bins
        return times, frames, mass, _color_limits(frames), (None if light else energy_frames), E_bins
