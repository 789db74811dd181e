"""The simulation engine: Strang-split time stepping on a CUDA device (or the CPU).

``run_2d_crank_nicolson`` keeps the signature and return contract of
``qpsim_tpu.solver.engine.run_2d_crank_nicolson`` (itself the reference's
``qpsim/solver.py:999-1587``):

    (times, frames, mass, [vmin, vmax], energy_frames | None, E_bins | None)

with one more keyword, ``device`` ("cuda" by default; "cpu" for tests).
It runs both branches:

* energy-resolved (``energy_gap > 0``): dense (NE, Ny, Nx) quasiparticle
  and (NW, Ny, Nx) phonon states, each step C(dt/2) D(dt) C(dt/2) (merged
  across a stored segment by default), with the collision substep and the
  ADI step on hand-written CUDA kernels on the card; a spatially varying
  gap (``gap_expression`` or a ``precomputed`` payload) gives per-pixel
  D(E, x) and per-pixel collision constants; ``initial_condition_spec``
  seeds the phonons (and a full-custom quasiparticle state),
  ``external_generation`` takes every mode (``custom`` traced on the
  device or evaluated on the host per step) and ``photon_drive`` adds the
  Fischer 2024 photon substep (one tone or several);
* scalar (``energy_gap <= 0``): one (1, Ny, Nx) CN field, no collisions,
  and a fixed-temperature phonon scaffold; on the card a full rectangle
  diffuses through the separable ADI kernel, any other film through the
  fused ADI kernel.

Features the port does not have yet raise ``NotImplementedError`` naming
the ROADMAP item that ports them; nothing falls back quietly.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..models.params import (
    BoundaryCondition,
    EdgeSegment,
    ExternalGenerationSpec,
    photon_drive_specs,
)
from ..ops.collisions import DEFAULT_PIXEL_CHUNK
from .phonon_history import reconstruct_field
from .scalar_runner import _run_scalar
from .spectral_runner import _run_energy_resolved
from .stepping import _plan_segments, _split_time, default_dtype

__all__ = ["run_2d_crank_nicolson", "reconstruct_field", "default_dtype"]


def _deferred(feature: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{feature} is not ported yet (ROADMAP.md, {item}).")


def _resolve_device(device) -> torch.device:
    """``torch.device`` for a run: CUDA must exist when asked for; never a quiet CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; pass device='cpu' "
                "to run the plain PyTorch path on the CPU."
            )
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device {dev} (use 'cuda' or 'cpu').")
    return dev


def run_2d_crank_nicolson(
    mask: np.ndarray,
    edges: list[EdgeSegment],
    edge_conditions: dict[str, BoundaryCondition],
    initial_field: np.ndarray,
    diffusion_coefficient: float,
    dt: float,
    total_time: float,
    dx: float,
    store_every: int = 1,
    energy_gap: float = 0.0,
    energy_min_factor: float = 1.0,
    energy_max_factor: float = 10.0,
    num_energy_bins: int = 50,
    energy_weights: np.ndarray | None = None,
    enable_diffusion: bool = True,
    enable_recombination: bool = False,
    enable_scattering: bool = False,
    dynes_gamma: float = 0.0,
    collision_solver: str = "fischer_catelani_local",
    tau_0: float = 440.0,
    tau_s: float | None = None,
    tau_r: float | None = None,
    T_c: float = 1.2,
    bath_temperature: float = 0.1,
    external_generation: ExternalGenerationSpec | None = None,
    photon_drive=None,
    initial_condition_spec=None,
    gap_expression: str = "",
    precomputed: dict | None = None,
    pauli_warn_threshold: float | None = 0.5,
    pauli_error_threshold: float | None = 1.0,
    enforce_pauli: bool = True,
    pauli_density_floor: float = 1e-18,
    freeze_phonon_dynamics: bool = False,
    phonon_history_out: dict[str, Any] | None = None,
    progress_callback: Callable[[float, np.ndarray], None] | None = None,
    *,
    diffusion_backend: str = "auto",
    dtype: torch.dtype | None = None,
    pixel_chunk: int = DEFAULT_PIXEL_CHUNK,
    checkpointer=None,
    collision_backend: str = "auto",
    strang_mode: str = "auto",
    mesh=None,
    mesh_y_solve: str | None = None,
    frame_sink=None,
    snapshot_detail: str = "full",
    device: str | torch.device = "cuda",
) -> tuple:
    """Run a masked 2D diffusion(–collision) simulation, scalar or energy-resolved.

    Reference-compatible entry point; see the module docstring and the
    JAX package's docstring for the physics and the options they share.
    Port-specific keywords:

    * ``device`` — "cuda" (default; raises when no CUDA device exists) or
      "cpu", where every kernel's plain PyTorch version runs.
    * ``dtype`` — ``torch.float32`` (default on CUDA) or ``torch.float64``
      (default on the CPU).
    * ``collision_backend`` — 'auto' (the CUDA kernel for CUDA tensors, the
      plain version on the CPU), 'kernel' (raises on the CPU) or 'plain';
      the JAX package's 'pallas' and 'xla' are aliases of the last two.
    * ``diffusion_backend`` — 'auto' (dense spectral CN at ≤ 4096 interior
      cells, else the CUDA ADI kernels on CUDA and plain ADI on the CPU),
      'dense', 'adi', 'wang', 'cg' or 'pallas' (the CUDA ADI kernels; raises
      on the CPU).
    * ``strang_mode`` — 'auto' ('merged', or 'exact' under a host-evaluated
      custom generation expression), 'exact' or 'merged'.
    * ``snapshot_detail`` — 'full' or 'integrated' (reduced on the device).

    ``mesh_y_solve`` is accepted for signature compatibility and unused.
    The scalar branch ignores the collision, generation and Strang options,
    as the JAX package does.
    """
    if dt <= 0 or total_time <= 0:
        raise ValueError("dt and total_time must be positive.")
    if enable_diffusion and diffusion_coefficient <= 0:
        raise ValueError("Diffusion coefficient must be positive.")
    if strang_mode not in ("auto", "exact", "merged"):
        raise ValueError(
            f"Unknown strang_mode: {strang_mode!r} (use 'auto', 'exact' or 'merged')"
        )
    if snapshot_detail not in ("full", "integrated"):
        raise ValueError(
            f"Unknown snapshot_detail: {snapshot_detail!r} (use 'full' or 'integrated')"
        )
    if photon_drive is not None and photon_drive_specs(photon_drive) and energy_gap <= 0.0:
        raise ValueError("photon_drive needs the energy-resolved mode (energy_gap > 0).")
    # features outside this slice of the port fail loudly
    if mesh is not None:
        raise _deferred("mesh= (spatial sharding)", "queue 1, 'Sharding'")
    if checkpointer is not None:
        raise _deferred("checkpointer=", "queue 1, 'I/O'")
    if frame_sink is not None:
        raise _deferred("frame_sink=", "queue 1, 'I/O'")

    dev = _resolve_device(device)
    if dtype is None:
        dtype = default_dtype(dev)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype!r}")
    if store_every <= 0:
        store_every = 1
    mask = np.asarray(mask, dtype=bool)
    if initial_field.shape != mask.shape:
        raise ValueError("Initial field shape must match mask shape.")
    if int(mask.sum()) == 0:
        raise ValueError("Geometry mask has no interior points.")
    if phonon_history_out is not None:
        phonon_history_out.clear()
    tau_s_eff = float(tau_s if tau_s is not None else tau_0)
    tau_r_eff = float(tau_r if tau_r is not None else tau_0)
    if enable_scattering and tau_s_eff <= 0:
        raise ValueError("tau_s must be positive when scattering is enabled.")
    if enable_recombination and tau_r_eff <= 0:
        raise ValueError("tau_r must be positive when recombination is enabled.")
    if external_generation is not None:
        external_generation.validate()

    full_steps, remainder_dt, total_steps = _split_time(total_time, dt)
    segments = _plan_segments(full_steps, remainder_dt, dt, store_every)

    if energy_gap <= 0.0:
        with torch.inference_mode():
            return _run_scalar(
                mask=mask,
                edges=edges,
                edge_conditions=edge_conditions,
                initial_field=initial_field,
                diffusion_coefficient=diffusion_coefficient,
                dx=dx,
                segments=segments,
                enable_diffusion=enable_diffusion,
                bath_temperature=bath_temperature,
                phonon_history_out=phonon_history_out,
                progress_callback=progress_callback,
                diffusion_backend=diffusion_backend,
                device=dev,
                dtype=dtype,
            )
    with torch.inference_mode():
        return _run_energy_resolved(
            mask=mask,
            edges=edges,
            edge_conditions=edge_conditions,
            initial_field=initial_field,
            diffusion_coefficient=diffusion_coefficient,
            dt=dt,
            dx=dx,
            segments=segments,
            total_steps=total_steps,
            energy_gap=energy_gap,
            energy_min_factor=energy_min_factor,
            energy_max_factor=energy_max_factor,
            num_energy_bins=num_energy_bins,
            energy_weights=energy_weights,
            enable_diffusion=enable_diffusion,
            enable_recombination=enable_recombination,
            enable_scattering=enable_scattering,
            dynes_gamma=dynes_gamma,
            collision_solver=collision_solver,
            tau_s_eff=tau_s_eff,
            tau_r_eff=tau_r_eff,
            T_c=T_c,
            bath_temperature=bath_temperature,
            external_generation=external_generation,
            photon_drive=photon_drive,
            initial_condition_spec=initial_condition_spec,
            gap_expression=gap_expression,
            precomputed=precomputed,
            pauli_warn_threshold=pauli_warn_threshold,
            pauli_error_threshold=pauli_error_threshold,
            enforce_pauli=enforce_pauli,
            pauli_density_floor=pauli_density_floor,
            freeze_phonon_dynamics=freeze_phonon_dynamics,
            phonon_history_out=phonon_history_out,
            progress_callback=progress_callback,
            diffusion_backend=diffusion_backend,
            device=dev,
            dtype=dtype,
            pixel_chunk=pixel_chunk,
            collision_backend=collision_backend,
            strang_mode=strang_mode,
            snapshot_detail=snapshot_detail,
        )
