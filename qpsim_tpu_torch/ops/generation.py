"""External quasiparticle generation g_ext(E, x, y, t).

Carried over from ``qpsim_tpu.ops.generation``, with the JAX package's two
evaluation strategies:

* **Uniform modes** (constant, pulse): g(E, x, y, t) = amp(t) on every
  masked pixel and every bin, so the forward-Euler injection n += dt·g is
  one (Ny, Nx) plane dt·amp(t)·mask added to every bin (fused into the
  collision step that opens each step where collisions run and no photon
  drive sits between the two).  amp(t) is evaluated on the host in the
  state dtype, at the times the engine computes in that dtype
  (``t0 + k·dt``), so pulse-window membership matches the JAX program's
  in-scan arithmetic bit for bit without a device round trip.
* **Custom, traced**: the expression is evaluated by the torch backend of
  the expression DSL on the device, in the state dtype, over the active
  pixels, and scattered into (NE, Ny, Nx); its validity flags
  (non-finite, negative) stay on the device for the engine to read once
  per segment.  Whether an expression traces is decided as the JAX package
  decides it: by one probe evaluation on the meta device (shapes only, as
  ``jax.eval_shape``) with a time that, like a JAX tracer, refuses
  ``float()``, ``int()`` and ``bool()`` — so ``math.exp(t)`` or
  ``a if t < 1 else b`` evaluate on the host, in both packages.
* **Custom, host**: :func:`evaluate_generation_host`, the reference's
  vectorised-then-scalar evaluation with its validation, called by the
  engine once per step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..expr.safe_eval import compile_safe_expression
from ..fields import normalized_pixel_coords
from ..models.params import ExternalGenerationSpec

__all__ = [
    "GenerationProgram",
    "build_generation_program",
    "evaluate_generation_host",
    "numpy_dtype",
]


def numpy_dtype(dtype: torch.dtype) -> type:
    """The numpy scalar type of a floating torch dtype (host time arithmetic)."""
    if dtype == torch.float32:
        return np.float32
    if dtype == torch.float64:
        return np.float64
    raise TypeError(f"unsupported state dtype {dtype}")


class _TracerProbe(torch.Tensor):
    """A probe time that refuses conversion to a Python number, as a JAX tracer does."""

    def _refuse(self, *args, **kwargs):
        raise TypeError("the generation time is traced: no Python number can be taken from it")

    __bool__ = __float__ = __int__ = __index__ = __complex__ = _refuse
    item = tolist = _refuse


class GenerationProgram:
    """One generation mode of a run: uniform, custom traced, custom host, or none.

    * ``scalar_amp`` (constant, pulse): ``plane(seg_dt, t)`` returns
      ``(plane, nonfinite, negative)``: the increment dt·amp(t)·mask on the
      device and the host validity flags of dt·amp(t) (equivalent to the
      per-cell flags, since the mask is never empty).  ``t`` is a numpy
      scalar of the state dtype.  A uniform mode takes few distinct values
      of dt·amp (a pulse: zero and one rate per step size), so each plane is
      made once and reused; callers must not write into it.
    * ``traced_fn`` (custom, traced): ``traced_fn(t) -> (NE, Ny, Nx)`` for a
      0-d tensor ``t`` on the device; :meth:`add` is the forward-Euler
      injection with the device flags.
    * ``host_mode`` (custom, untraceable): the engine evaluates
      :func:`evaluate_generation_host` per step.
    """

    def __init__(
        self,
        spec: ExternalGenerationSpec | None,
        mask_plane: torch.Tensor | None,
        traced_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
        host_mode: bool = False,
    ):
        self.spec = spec
        self.mode = "none" if spec is None else spec.normalized_mode()
        self._mask_plane = mask_plane
        self._planes: dict[float, torch.Tensor] = {}
        self.traced_fn = traced_fn
        self.host_mode = host_mode

    @property
    def scalar_amp(self) -> bool:
        return self.mode in ("constant", "pulse")

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

    def flags(self, g: torch.Tensor):
        """The (non-finite, negative) device flags of a traced g on the mask."""
        g_masked = torch.where(self._mask_plane > 0, g, 0.0)
        return ~torch.isfinite(g_masked).all(), (g_masked < 0).any()

    def add(self, q: torch.Tensor, seg_dt: float, t: torch.Tensor):
        """q + dt·g(t) for the traced custom mode, and its (non-finite, negative) flags on the device."""
        g = self.traced_fn(t)
        return (q + seg_dt * g, *self.flags(g))


def build_generation_program(
    spec: ExternalGenerationSpec | None,
    E_bins: np.ndarray,
    mask: np.ndarray,
    device,
    dtype: torch.dtype,
) -> GenerationProgram:
    if spec is None or spec.normalized_mode() == "none":
        return GenerationProgram(None, None)
    spec.validate()
    m = np.asarray(mask, dtype=bool)
    mask_plane = torch.as_tensor(m.astype(np.float64), dtype=dtype, device=device)
    if spec.normalized_mode() != "custom":
        return GenerationProgram(spec, mask_plane)

    # custom: a traced program where the expression traces, else host mode
    body = spec.custom_body.strip() or "0.0"
    params = dict(spec.custom_params or {})
    ny, nx = m.shape
    ne = int(np.asarray(E_bins).size)
    x_norm, y_norm = normalized_pixel_coords(m)
    active_np = np.flatnonzero(m.ravel())
    n_active = int(active_np.size)
    try:
        fn = compile_safe_expression(
            body, variable_names=("E", "x", "y", "t", "params"), backend="torch"
        )
    except Exception:
        return GenerationProgram(spec, mask_plane, host_mode=True)

    def make_traced(e_col, x_row, y_row, active):
        dev = e_col.device

        def traced(t: torch.Tensor) -> torch.Tensor:
            vals = fn(E=e_col, x=x_row, y=y_row, t=t, params=params)
            vals = torch.broadcast_to(torch.as_tensor(vals, dtype=dtype, device=dev), (ne, n_active))
            out = torch.zeros((ne, ny * nx), dtype=dtype, device=dev)
            out[:, active] = vals
            return out.reshape(ne, ny, nx)

        return traced

    # one probe evaluation on the meta device, which checks shapes and
    # dtypes without touching the card, as jax.eval_shape does; a refused
    # trace (a Python number taken from t, an unsupported op, shape logic)
    # selects host mode
    meta = torch.device("meta")
    probe = make_traced(
        torch.empty((ne, 1), dtype=dtype, device=meta),
        torch.empty((1, n_active), dtype=dtype, device=meta),
        torch.empty((1, n_active), dtype=dtype, device=meta),
        torch.empty((n_active,), dtype=torch.int64, device=meta),
    )
    try:
        probe(torch.empty((), dtype=dtype, device=meta).as_subclass(_TracerProbe))
    except Exception:
        return GenerationProgram(spec, mask_plane, host_mode=True)
    traced = make_traced(
        torch.as_tensor(np.asarray(E_bins, dtype=np.float64)[:, None], dtype=dtype, device=device),
        torch.as_tensor(x_norm[m], dtype=dtype, device=device)[None, :],
        torch.as_tensor(y_norm[m], dtype=dtype, device=device)[None, :],
        torch.as_tensor(active_np, device=device),
    )
    return GenerationProgram(spec, mask_plane, traced_fn=traced)


def evaluate_generation_host(
    spec: ExternalGenerationSpec,
    E_bins: np.ndarray,
    n_spatial: int,
    t: float,
    mask: np.ndarray,
) -> np.ndarray | None:
    """Host-side generation over interior pixels → (NE, P), or None for 'none'.

    Validates shape, finiteness and non-negativity exactly like the
    reference; used for host-mode custom expressions and by tests.
    """
    mode = spec.normalized_mode()
    if mode == "none":
        return None
    ne = int(np.asarray(E_bins).size)

    def check(arr: np.ndarray) -> np.ndarray:
        if arr.shape != (ne, n_spatial):
            raise ValueError(
                f"External generation mode '{mode}' returned invalid shape "
                f"{arr.shape}; expected {(ne, n_spatial)}."
            )
        if not np.all(np.isfinite(arr)):
            raise ValueError(f"External generation mode '{mode}' produced non-finite values.")
        if np.any(arr < 0):
            raise ValueError(
                f"External generation mode '{mode}' produced negative values. "
                "Generation rates must be non-negative."
            )
        return arr

    if mode == "constant":
        return check(np.full((ne, n_spatial), spec.rate, dtype=np.float64))
    if mode == "pulse":
        if spec.pulse_start <= t < spec.pulse_start + spec.pulse_duration:
            return check(np.full((ne, n_spatial), spec.pulse_rate, dtype=np.float64))
        return check(np.zeros((ne, n_spatial), dtype=np.float64))
    if mode == "custom":
        fn = compile_safe_expression(
            spec.custom_body.strip() or "0.0",
            variable_names=("E", "x", "y", "t", "params"),
        )
        m = np.asarray(mask, dtype=bool)
        x_norm, y_norm = normalized_pixel_coords(m)
        xs, ys = x_norm[m], y_norm[m]
        params = dict(spec.custom_params or {})
        result = np.empty((ne, n_spatial), dtype=np.float64)
        e_arr = np.asarray(E_bins, dtype=np.float64)
        try:
            for i in range(ne):
                val = np.asarray(
                    fn(E=float(e_arr[i]), x=xs, y=ys, t=t, params=params), dtype=np.float64
                )
                if val.ndim == 0:
                    result[i] = float(val)
                else:
                    flat = val.ravel()
                    if flat.size != n_spatial:
                        raise ValueError(
                            "Vectorized custom generation must return a scalar or "
                            f"exactly {n_spatial} values per energy bin; got {flat.size}."
                        )
                    result[i] = flat
        except Exception:
            for i in range(ne):
                for px in range(n_spatial):
                    result[i, px] = float(
                        fn(E=float(e_arr[i]), x=float(xs[px]), y=float(ys[px]), t=t, params=params)
                    )
        return check(result)
    return None
