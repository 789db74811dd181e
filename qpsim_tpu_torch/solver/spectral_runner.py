"""Energy-resolved mode runner.

Carried over from ``qpsim_tpu.solver.spectral_runner``: initial state
assembly, Pauli policy enforcement, the snapshot pipeline (``full`` and
on-device ``integrated`` detail), host-mode generation (one host
evaluation, one add and one single step per step) and the depth-1 segment
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
state.
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
from .pauli import PauliEnforcer
from .phonon_history import reconstruct_field
from .program_build import build_engine_program
from .stepping import _color_limits, _notify

__all__ = ["_run_energy_resolved"]


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
            elif cuda:
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
):
    gap = float(energy_gap)
    ny, nx = mask.shape
    n_spatial = int(mask.sum())
    E_bins, dE = build_energy_grid(gap, energy_min_factor, energy_max_factor, num_energy_bins)
    normalize_collision_solver_name(collision_solver)

    custom_qp_state = None
    if initial_condition_spec is not None:
        custom_qp_state = build_initial_qp_energy_state(mask, E_bins, initial_condition_spec)

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
    )
    omega_bins = prog.pmap.omega_bins

    # --- initial states (weights at the uniform energy_gap's DOS, gap map or not)
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
    enforcer.check_row(0, 0.0, prog.pauli_stats(q).cpu().numpy())

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

    def emit(t: float, q_host: np.ndarray, ph_host: np.ndarray | None) -> np.ndarray:
        """One stored snapshot from the full host state."""
        interior = q_host[:, mask]
        integrated = np.sum(interior, axis=0) * dE
        frame = reconstruct_field(mask, integrated)
        times.append(float(t))
        mass.append(float(np.sum(integrated) * dx * dx))
        frames.append(frame)
        energy_frames.append([reconstruct_field(mask, interior[i]) for i in range(num_energy_bins)])
        if record_phonons and ph_host is not None:
            ph_interior = ph_host[:, mask]
            phonon_frames_hist.append(
                reconstruct_field(mask, np.sum(ph_interior * phonon_widths[:, None], axis=0))
            )
            phonon_energy_frames_hist.append(
                [reconstruct_field(mask, ph_interior[i]) for i in range(nw)]
            )
        return frame

    # light ("integrated") snapshots: the stored observables are reduced ON
    # DEVICE and only the reductions cross to the host — the integrated 2D
    # frame (already ×dE), per-bin pixel sums and, when recorded, the
    # width-weighted phonon occupation frame
    light = snapshot_detail == "integrated"
    if light:
        mask_d = torch.as_tensor(mask, dtype=dtype, device=device)
        phw_d = (
            torch.as_tensor(phonon_widths, dtype=dtype, device=device)[:, None, None]
            if record_phonons
            else None
        )

    def light_reduce(q_dev: torch.Tensor, ph_dev: torch.Tensor) -> list[torch.Tensor | None]:
        qm = q_dev * mask_d  # anything outside the mask must not leak in
        out = [qm.sum(dim=0) * dE, qm.sum(dim=(1, 2)), None]
        if phw_d is not None:
            out[2] = (ph_dev * mask_d * phw_d).sum(dim=0)
        return out

    def emit_light(t: float, integrated, bin_sums, ph_int) -> np.ndarray:
        frame = np.where(mask, np.asarray(integrated, dtype=np.float64), np.nan)
        times.append(float(t))
        mass.append(float(np.sum(np.asarray(bin_sums, dtype=np.float64)) * dE * dx * dx))
        frames.append(frame)
        if ph_int is not None:
            phonon_frames_hist.append(np.where(mask, np.asarray(ph_int, dtype=np.float64), np.nan))
        return frame

    def start_copy(q_dev, ph_dev) -> _HostCopy:
        if light:
            return _HostCopy(*light_reduce(q_dev, ph_dev))
        return _HostCopy(q_dev, ph_dev if record_phonons else None)

    def store(t: float, copy: _HostCopy) -> None:
        host = copy.get()
        if light:
            frame = emit_light(t, *host)
        else:
            q_host, ph_host = (None if h is None else h.astype(np.float64) for h in host)
            frame = emit(t, q_host, ph_host)
        _notify(progress_callback, t, frame)

    # the first frame is read from the device state; in either detail it is
    # reduced on the host in float64, as the JAX package reduces its host state
    if light:
        q_host, ph_host = (
            None if h is None else h.astype(np.float64)
            for h in _HostCopy(q, ph if record_phonons else None).get()
        )
        interior = q_host[:, mask]
        frame0 = emit_light(
            0.0,
            reconstruct_field(mask, np.sum(interior, axis=0) * dE),
            np.sum(interior, axis=1),
            reconstruct_field(mask, np.sum(ph_host[:, mask] * phonon_widths[:, None], axis=0))
            if record_phonons
            else None,
        )
        _notify(progress_callback, 0.0, frame0)
    else:
        store(0.0, start_copy(q, ph))

    # --- main loop --------------------------------------------------------------
    gen_mode = external_generation.normalized_mode() if external_generation else "none"

    def drain(p) -> None:
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
            store(t, p["snapshot"])

    current_time = 0.0
    step_counter = 0
    pending = None
    for seg in segments:
        if prog.host_gen:
            # host-evaluated generation needs the host between every step —
            # inherently sequential, no pipelining
            one = prog.single_step(seg.dt)
            for _ in range(seg.length):
                g_host = evaluate_generation_host(
                    external_generation, E_bins, n_spatial, current_time, mask
                )
                if g_host is not None:
                    g_dense = torch.zeros((num_energy_bins, ny, nx), dtype=dtype, device=device)
                    g_dense[:, mask_d] = torch.as_tensor(g_host, dtype=dtype, device=device)
                    q = q + seg.dt * g_dense
                q, ph, stats = one(q, ph, current_time)
                step_counter += 1
                current_time += seg.dt
                enforcer.check_row(step_counter, current_time, stats.cpu().numpy())
            if seg.stored:
                store(current_time, start_copy(q, ph))
            continue
        q, ph, stats, flags = prog.segment_runner(seg.dt, seg.length)(q, ph, current_time)
        new_pending = {
            "seg": seg,
            "stats": _HostCopy(stats),
            "flags": flags,
            "snapshot": start_copy(q, ph) if seg.stored else None,
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
                    **({"detail": "integrated"} if light else {}),
                },
            }
        )
    return times, frames, mass, _color_limits(frames), (None if light else energy_frames), E_bins
