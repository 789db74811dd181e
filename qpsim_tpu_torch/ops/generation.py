"""External quasiparticle generation g_ext(E, x, y, t), uniform modes.

Carried over from ``qpsim_tpu.ops.generation`` for the modes ``none``,
``constant`` and ``pulse``: g(E, x, y, t) = amp(t) on every masked pixel
and every bin, so the forward-Euler injection n += dt·g is one (Ny, Nx)
plane dt·amp(t)·mask added to every bin (fused into the collision step
where collisions run).

amp(t) is evaluated on the host in the state dtype, at the times the
engine computes in that dtype (``t0 + k·dt``), so pulse-window membership
matches the JAX program's in-scan arithmetic bit for bit without a device
round trip.  The ``custom`` mode needs the expression evaluator and the
field helpers, which are not ported yet, and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.params import ExternalGenerationSpec

__all__ = ["GenerationProgram", "build_generation_program", "numpy_dtype"]


def numpy_dtype(dtype: torch.dtype) -> type:
    """The numpy scalar type of a floating torch dtype (host time arithmetic)."""
    if dtype == torch.float32:
        return np.float32
    if dtype == torch.float64:
        return np.float64
    raise TypeError(f"unsupported state dtype {dtype}")


class GenerationProgram:
    """dt·g as a masked (Ny, Nx) plane for a uniform mode, or inactive.

    ``plane(seg_dt, t)`` returns ``(plane, nonfinite, negative)``: the
    increment dt·amp(t)·mask on the device and the validity flags of
    dt·amp(t) (equivalent to the per-cell flags, since the mask is never
    empty).  ``t`` is a numpy scalar of the state dtype.  A uniform mode
    takes few distinct values of dt·amp (a pulse: zero and one rate per
    step size), so each plane is made once and reused; callers must not
    write into it.
    """

    def __init__(self, spec: ExternalGenerationSpec | None, mask_plane: torch.Tensor | None):
        self.spec = spec
        self.mode = "none" if spec is None else spec.normalized_mode()
        self._mask_plane = mask_plane
        self._planes: dict[float, torch.Tensor] = {}

    @property
    def active(self) -> bool:
        return self.mode != "none"

    def amp(self, t):
        """amp(t) in the dtype of ``t`` (a numpy scalar)."""
        f = type(t)
        if self.mode == "constant":
            return f(self.spec.rate)
        start, duration = float(self.spec.pulse_start), float(self.spec.pulse_duration)
        inside = (t >= f(start)) and (t < f(start + duration))
        return f(self.spec.pulse_rate) if inside else f(0.0)

    def plane(self, seg_dt: float, t):
        f = type(t)
        amp = f(seg_dt) * self.amp(t)
        key = float(amp)
        if key not in self._planes:
            self._planes[key] = self._mask_plane * key
        return self._planes[key], not np.isfinite(amp), bool(amp < 0)


def build_generation_program(
    spec: ExternalGenerationSpec | None,
    mask: np.ndarray,
    device,
    dtype: torch.dtype,
) -> GenerationProgram:
    if spec is None or spec.normalized_mode() == "none":
        return GenerationProgram(None, None)
    spec.validate()
    if spec.normalized_mode() == "custom":
        raise NotImplementedError(
            "external_generation mode 'custom' is not ported yet: it needs the "
            "expression evaluator and field helpers (ROADMAP.md, queue 1, "
            "'Host layer, rest')."
        )
    mask_plane = torch.as_tensor(np.asarray(mask, dtype=np.float64), dtype=dtype, device=device)
    return GenerationProgram(spec, mask_plane)
