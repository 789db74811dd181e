"""High-level simulation runner: SetupData in, SimulationResultData out.

Carried over from ``qpsim_tpu.runner`` (the programmatic equivalent of the
reference GUI's worker thread): builds initial fields from the setup's IC
spec, resolves and validates the precompute sidecar, runs the engine on
the card (``device="cuda"``, the default) or the CPU, and assembles a
persistable :class:`SimulationResultData` with energy bookkeeping.

The energy-exchange residual is computed for real:

    residual(t) = [E_qp(t) + E_ph(t)] − [E_qp(0) + E_ph(0)]

which measures the Strang/exponential-integrator energy-exchange error in a
closed system (collisions conserve E_qp + E_ph exactly in the continuous
equations).  ``diagnostics_mode`` is ``"conservation_residual"`` for closed
runs and ``"open_system"`` when generation or non-reflective boundaries make
the total legitimately non-conserved.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable

import numpy as np

from .fields import build_initial_energy_weights, build_initial_field
from .geometry.mask import mask_from_lists
from .io.precompute import validate_precomputed
from .io.storage import (
    create_simulation_id,
    frame_to_jsonable,
    load_precomputed,
    precomputed_exists,
    save_simulation,
)
from .models.params import SetupData, SimulationResultData, utc_now_iso
from .ops.energy_grid import build_energy_grid, integration_widths_from_centers
from .solver.engine import _mesh_device, _resolve_device, run_2d_crank_nicolson

__all__ = ["run_setup", "resolve_precomputed"]


def resolve_precomputed(
    setup: SetupData,
    setup_path: str | Path | None,
    mask: np.ndarray,
) -> tuple[dict | None, str | None]:
    """Load + fingerprint-validate a setup's .precompute.npz sidecar.

    Returns (arrays or None, stale-reason or None), as the reference GUI's
    ``_resolve_precomputed_data`` does.
    """
    if setup_path is None:
        return None, None
    path = Path(setup_path)
    if not precomputed_exists(path):
        return None, None
    try:
        arrays = load_precomputed(path)
    except Exception as exc:
        return None, f"Failed to load precomputed arrays: {exc}"
    reason = validate_precomputed(arrays, setup.parameters, mask)
    if reason is not None:
        return None, reason
    return arrays, None


def _integrated_energy_total(
    frame_stack: list[list[np.ndarray]],
    bins: np.ndarray,
    widths: np.ndarray,
    mask: np.ndarray,
    area: float,
) -> list[float]:
    """Σ_bins Σ_pixels n(E,x)·E·ΔE·dx² per stored time."""
    totals = []
    for time_slice in frame_stack:
        total = 0.0
        for idx, e_val in enumerate(bins):
            total += float(np.nansum(np.asarray(time_slice[idx])[mask])) * float(e_val) * float(
                widths[idx]
            )
        totals.append(float(total * area))
    return totals


class _StreamingTotalsSink:
    """Frame-sink wrapper that accumulates energy bookkeeping on the fly.

    Streaming discards per-bin frame histories the moment they hit disk,
    so the post-run ``_integrated_energy_total`` pass has nothing to read.
    Instead, as each snapshot passes through, this wrapper reduces it to
    per-bin pixel sums — an (NE,)/(nω,) vector per stored time, a few
    hundred floats instead of gigabytes — and forwards the frames to the
    wrapped writer untouched.  Totals are assembled after the run, when
    the phonon ω-grid (engine-built) is known.
    """

    def __init__(self, sink, mask: np.ndarray) -> None:
        self._sink = sink
        self._mask = mask
        self.qp_bin_sums: dict[int, np.ndarray] = {}
        self.ph_bin_sums: dict[int, np.ndarray] = {}

    def write(
        self,
        index: int,
        time_ns: float,
        *,
        frame,
        mass,
        energy_frames=None,
        phonon_frame=None,
        phonon_energy_frames=None,
        energy_bin_sums=None,
        phonon_bin_sums=None,
    ) -> None:
        # light (snapshot_detail="integrated") runs deliver the sums directly
        if energy_bin_sums is not None:
            self.qp_bin_sums[index] = np.asarray(energy_bin_sums, np.float64)
        elif energy_frames is not None:
            self.qp_bin_sums[index] = np.array(
                [np.nansum(np.asarray(f)[self._mask]) for f in energy_frames]
            )
        if phonon_bin_sums is not None:
            self.ph_bin_sums[index] = np.asarray(phonon_bin_sums, np.float64)
        elif phonon_energy_frames is not None:
            self.ph_bin_sums[index] = np.array(
                [np.nansum(np.asarray(f)[self._mask]) for f in phonon_energy_frames]
            )
        self._sink.write(
            index,
            time_ns,
            frame=frame,
            mass=mass,
            energy_frames=energy_frames,
            phonon_frame=phonon_frame,
            phonon_energy_frames=phonon_energy_frames,
            energy_bin_sums=energy_bin_sums,
            phonon_bin_sums=phonon_bin_sums,
        )

    def totals(self, which: str, bins, widths, area: float, n_times: int) -> list[float] | None:
        sums = self.qp_bin_sums if which == "qp" else self.ph_bin_sums
        if len(sums) != n_times:
            return None
        bins = np.asarray(bins, np.float64)
        widths = np.asarray(widths, np.float64)
        return [
            float(np.sum(sums[i] * bins * widths) * area) for i in range(n_times)
        ]


def run_setup(
    setup: SetupData,
    *,
    setup_path: str | Path | None = None,
    precomputed: dict | None = None,
    progress_callback: Callable[[float, np.ndarray], None] | None = None,
    save: bool = True,
    save_path: Path | None = None,
    diffusion_backend: str = "auto",
    collision_backend: str = "auto",
    strang_mode: str = "auto",
    dtype=None,
    checkpoint_dir: str | Path | None = None,
    stream_dir: str | Path | None = None,
    snapshot_detail: str = "full",
    freeze_phonon_dynamics: bool = False,
    mesh=None,
    mesh_y_solve: str | None = None,
    device=None,
) -> tuple[SimulationResultData, str | None]:
    """Run one setup end-to-end and (optionally) persist the result.

    Returns (result, saved-path-or-None).  Raises on physics/validation
    errors; a failed save is reported in ``result.metadata['save_error']``.

    ``device`` is "cuda" (the default; raises without a card) or "cpu"
    (with ``mesh``, the mesh's devices decide);
    ``dtype`` a torch dtype (float32 on the card, float64 on the CPU by
    default).

    ``freeze_phonon_dynamics=True`` pins the phonon bath at its thermal
    state (the engine flag): the instantly-rethermalizing-substrate limit
    classic MKID decay analyses assume — in a closed reflective film with
    dynamic phonons, recombination phonons re-break pairs and the QP
    number barely decays.

    ``mesh`` (a :class:`qpsim_tpu_torch.parallel.mesh.Mesh`) routes the hot
    loop through the rows-sharded step, the engine's ``mesh=``;
    ``mesh_y_solve`` picks its y solve.

    ``checkpoint_dir`` makes every stored snapshot of an energy-resolved
    run a resume point (:class:`qpsim_tpu_torch.io.checkpoint.SimulationCheckpointer`):
    a rerun into the same directory replays what is there and continues,
    bit-identical to an uninterrupted run.

    ``stream_dir`` enables bounded-memory frame streaming: every stored
    snapshot is written to that directory as an NPZ shard the moment it
    leaves the device (:class:`qpsim_tpu_torch.io.stream.FrameStreamWriter`)
    instead of accumulating in RAM.  The returned result then carries
    empty ``frames``/``energy_frames``/phonon histories and a
    ``metadata['streamed_frames_dir']`` pointer; energy bookkeeping
    (QP/phonon totals, exchange residual) is computed on the fly as the
    frames pass through and is unchanged.  Read the stream back with
    :func:`qpsim_tpu_torch.io.stream.load_frame_stream`.

    ``snapshot_detail="integrated"`` reduces each stored snapshot on device
    and pulls only integrated frames + per-bin sums (see the engine
    docstring); it requires ``stream_dir`` in energy-resolved mode — the
    result's energy bookkeeping is reconstructed from the streamed bin-sum
    vectors.
    """
    # before any directory is touched
    device = _resolve_device(device if mesh is None else _mesh_device(device, mesh))
    p = setup.parameters
    if snapshot_detail == "integrated" and stream_dir is None and p.energy_gap > 0:
        raise ValueError(
            "snapshot_detail='integrated' requires stream_dir: the result's "
            "energy bookkeeping is reconstructed from the streamed bin sums."
        )
    mask = mask_from_lists(setup.geometry.mask)
    initial = build_initial_field(mask, setup.initial_condition)
    sim_id = create_simulation_id()

    e_weights = None
    E_bins = None
    if p.energy_gap > 0:
        E_bins, _ = build_energy_grid(
            p.energy_gap, p.energy_min_factor, p.energy_max_factor, p.num_energy_bins
        )
        e_weights = build_initial_energy_weights(
            E_bins=E_bins,
            gap=p.energy_gap,
            dynes_gamma=p.dynes_gamma,
            spec=setup.initial_condition,
            bath_temperature=p.bath_temperature,
        )

    if precomputed is None:
        precomputed, stale_reason = resolve_precomputed(setup, setup_path, mask)
    else:
        stale_reason = None

    collisions_on = p.enable_recombination or p.enable_scattering
    want_phonons = bool(p.export_phonon_history) or (p.energy_gap > 0 and collisions_on)
    phonon_sink: dict[str, Any] | None = {} if want_phonons else None

    checkpointer = None
    if checkpoint_dir is not None and p.energy_gap > 0:
        from .io.checkpoint import SimulationCheckpointer

        checkpointer = SimulationCheckpointer(checkpoint_dir)

    stream_writer = None
    stream_sink = None
    if stream_dir is not None:
        from .io.stream import FrameStreamWriter

        stream_writer = FrameStreamWriter(
            stream_dir,
            energy_bins=E_bins,
            metadata={
                "simulation_id": sim_id,
                "setup_id": setup.setup_id,
                "setup_name": setup.name,
                "created_at": utc_now_iso(),
                "energy_gap": p.energy_gap,
                "dynes_gamma": p.dynes_gamma,
            },
        )
        stream_sink = _StreamingTotalsSink(stream_writer, mask)

    times, frames, mass, color_limits, energy_frames, energy_bins = run_2d_crank_nicolson(
        mask=mask,
        edges=setup.geometry.edges,
        edge_conditions=setup.boundary_conditions,
        initial_field=initial,
        diffusion_coefficient=p.diffusion_coefficient,
        dt=p.dt,
        total_time=p.total_time,
        dx=p.mesh_size,
        store_every=p.store_every,
        energy_gap=p.energy_gap,
        energy_min_factor=p.energy_min_factor,
        energy_max_factor=p.energy_max_factor,
        num_energy_bins=p.num_energy_bins,
        energy_weights=e_weights,
        enable_diffusion=p.enable_diffusion,
        enable_recombination=p.enable_recombination,
        enable_scattering=p.enable_scattering,
        dynes_gamma=p.dynes_gamma,
        collision_solver=p.collision_solver,
        tau_0=p.tau_0,
        tau_s=p.tau_s,
        tau_r=p.tau_r,
        T_c=p.T_c,
        bath_temperature=p.bath_temperature,
        external_generation=p.external_generation,
        photon_drive=getattr(p, "photon_drive", None),
        initial_condition_spec=setup.initial_condition,
        gap_expression=p.gap_expression,
        precomputed=precomputed,
        freeze_phonon_dynamics=freeze_phonon_dynamics,
        phonon_history_out=phonon_sink,
        progress_callback=progress_callback,
        diffusion_backend=diffusion_backend,
        collision_backend=collision_backend,
        strang_mode=strang_mode,
        dtype=dtype,
        checkpointer=checkpointer,
        frame_sink=stream_sink,
        snapshot_detail=snapshot_detail,
        mesh=mesh,
        mesh_y_solve=mesh_y_solve,
        device=device,
    )

    area = float(p.mesh_size * p.mesh_size)

    # QP energy content per stored time
    if energy_bins is not None and p.energy_gap > 0 and (
        energy_frames is not None or stream_sink is not None
    ):
        _, dE = build_energy_grid(
            p.energy_gap, p.energy_min_factor, p.energy_max_factor, p.num_energy_bins
        )
        widths = integration_widths_from_centers(
            np.asarray(energy_bins, dtype=np.float64), fallback_width=float(dE)
        )
        if stream_sink is not None:
            energy_qp_total = stream_sink.totals(
                "qp", energy_bins, widths, area, len(times)
            ) or [float(v) for v in mass]
        else:
            energy_qp_total = _integrated_energy_total(
                energy_frames, np.asarray(energy_bins), widths, mask, area
            )
    else:
        energy_qp_total = [float(v) for v in mass]

    # phonon energy content per stored time
    ph_frames = ph_energy_frames = ph_bins = ph_meta = None
    if phonon_sink:
        ph_frames = phonon_sink.get("phonon_frames")
        ph_energy_frames = phonon_sink.get("phonon_energy_frames")
        ph_bins = phonon_sink.get("phonon_energy_bins")
        ph_meta = phonon_sink.get("phonon_metadata")
    if ph_energy_frames is not None and ph_bins is not None and p.energy_gap > 0:
        ph_widths = integration_widths_from_centers(
            np.asarray(ph_bins, dtype=np.float64), fallback_width=1.0
        )
        if stream_sink is not None:
            energy_phonon_total = stream_sink.totals(
                "ph", ph_bins, ph_widths, area, len(times)
            ) or [0.0 for _ in times]
        else:
            energy_phonon_total = _integrated_energy_total(
                ph_energy_frames, np.asarray(ph_bins), ph_widths, mask, area
            )
    else:
        energy_phonon_total = [0.0 for _ in times]

    # energy-exchange diagnostic (real, not the reference's placeholder)
    gen_mode = p.external_generation.normalized_mode() if p.external_generation else "none"
    open_boundaries = any(
        bc.normalized_kind() != "reflective" for bc in setup.boundary_conditions.values()
    ) and p.enable_diffusion
    closed_system = (
        p.energy_gap > 0
        and collisions_on
        and gen_mode == "none"
        and not open_boundaries
        and ph_energy_frames is not None
        # a frozen bath absorbs/supplies energy silently — not a closed system
        and not freeze_phonon_dynamics
    )
    total_energy = [q + ph for q, ph in zip(energy_qp_total, energy_phonon_total)]
    residual = [e - total_energy[0] for e in total_energy]
    diagnostics_mode = "conservation_residual" if closed_system else "open_system"

    if stream_writer is not None:
        stream_writer.finalize(
            phonon_energy_bins=ph_bins,
            extra_metadata={
                "energy_qp_total": energy_qp_total,
                "energy_phonon_total": energy_phonon_total,
                "energy_exchange_residual": residual,
                "diagnostics_mode": diagnostics_mode,
                **({"phonon_metadata": ph_meta} if ph_meta else {}),
            },
        )

    export_phonons = bool(p.export_phonon_history)
    result = SimulationResultData(
        simulation_id=sim_id,
        setup_id=setup.setup_id,
        setup_name=setup.name,
        created_at=utc_now_iso(),
        times=[float(t) for t in times],
        frames=[frame_to_jsonable(f) for f in frames],
        mass_over_time=[float(v) for v in mass],
        color_limits=[float(color_limits[0]), float(color_limits[1])],
        metadata={
            "diffusion_coefficient": p.diffusion_coefficient,
            "mesh_size": p.mesh_size,
            "dt": p.dt,
            "total_time": p.total_time,
            "energy_gap": p.energy_gap,
            "dynes_gamma": p.dynes_gamma,
            "export_phonon_history": export_phonons,
            "energy_qp_total": energy_qp_total,
            "energy_phonon_total": energy_phonon_total,
            "energy_exchange_residual": residual,
            "diagnostics_mode": diagnostics_mode,
            **({"precompute_stale_reason": stale_reason} if stale_reason else {}),
            **(
                {"streamed_frames_dir": str(stream_writer.directory)}
                if stream_writer is not None
                else {}
            ),
        },
        energy_frames=(
            [[frame_to_jsonable(ef) for ef in ts_] for ts_ in energy_frames]
            if energy_frames is not None
            else None
        ),
        energy_bins=energy_bins.tolist() if energy_bins is not None else None,
        phonon_frames=(
            [frame_to_jsonable(f) for f in ph_frames]
            if export_phonons and ph_frames is not None
            else None
        ),
        phonon_energy_frames=(
            [[frame_to_jsonable(f) for f in ts_] for ts_ in ph_energy_frames]
            if export_phonons and ph_energy_frames is not None
            else None
        ),
        phonon_energy_bins=(
            np.asarray(ph_bins).tolist() if export_phonons and ph_bins is not None else None
        ),
        phonon_metadata=ph_meta if export_phonons else None,
    )

    saved_path: str | None = None
    if save:
        try:
            saved_path = str(save_simulation(result, save_path))
        except Exception as exc:
            result.metadata["save_error"] = str(exc)
    return result, saved_path
