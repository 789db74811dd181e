"""Analytic test-case engine: 28 simulated-vs-closed-form benchmark cases.

Carried over from ``qpsim_tpu.testcases.generator``: the same five
geometry groups and case ids (parity with the reference suite), the
closed forms computed on the host with numpy and scipy, the simulations
run through this package's engine on the card (``device="cuda"``, the
default) or the CPU, persisted as a browsable manifest-v3 suite that
either package's viewer opens:

* ``strip_1d_effective`` — 10 boundary-condition cases on a 1-cell strip:
  reflective/neumann-flux/dirichlet/absorbing cosine–sine modes plus Robin
  even/odd eigenmodes with transcendental roots.
* ``rectangle_2d`` — 6 Dirichlet eigenmodes + 2 mixed D/N + 1 all-reflective
  on a 56×36 rectangle.
* ``polygon_donut`` — 4 radial Bessel modes (J₀/Y₀ annulus eigenfunctions)
  on a 20-gon annulus with D/D, D/N, N/D, N/N boundaries.
* ``recombination`` — 3 zero-dimensional ODE cases: 1/t decay,
  equilibrium stationarity, coth decay-to-equilibrium.
* ``scattering`` — 2 cases: top-bin exponential decay, equilibrium
  stationarity.

Every group builder takes ``device`` and ``dtype`` keywords (float32 on
the card and float64 on the CPU by default), passed to each run.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Callable

import numpy as np
from scipy import special
from scipy.optimize import brentq

from ..geometry.mask import extract_edge_segments
from ..geometry.raster import points_in_polygon
from ..io.storage import TEST_SUITE_FORMAT_VERSION, frame_to_jsonable, save_test_suite
from ..models.params import (
    BoundaryCondition,
    TestCaseResultData,
    TestGeometryGroupData,
    TestSuiteData,
    utc_now_iso,
)
from ..ops.dos import bcs_density_of_states, thermal_qp_weights
from ..ops.energy_grid import build_energy_grid
from ..ops.kernels import recombination_kernel, scattering_kernel
from ..solver.engine import run_2d_crank_nicolson

__all__ = ["generate_test_suite", "generate_and_save_test_suite"]


# --------------------------------------------------------------------------
# group 1: effective 1D strip
# --------------------------------------------------------------------------


@dataclass
class _StripCase:
    case_id: str
    title: str
    boundary_label: str
    left_bc: BoundaryCondition
    right_bc: BoundaryCondition
    init_fn: Callable
    analytic_fn: Callable
    formula_latex: str
    initial_latex: str
    description: str


def _bracketed_root(fn: Callable[[float], float], windows: list[tuple[float, float]]) -> float:
    for lo, hi in windows:
        try:
            f_lo, f_hi = fn(lo), fn(hi)
        except Exception:
            continue
        if np.isnan(f_lo) or np.isnan(f_hi):
            continue
        if f_lo == 0:
            return lo
        if f_hi == 0:
            return hi
        if f_lo * f_hi < 0:
            return float(brentq(fn, lo, hi))
    raise ValueError("Could not find root in provided intervals.")


def _strip_cases(length: float) -> list[_StripCase]:
    h = 0.02
    eps = 1e-6
    # Robin eigenvalue conditions on (0, L) with u' = ∓h u at the walls:
    # even modes: μ tan(μL/2) = h ; odd modes: μ cot(μL/2) = −h.
    mu_even = _bracketed_root(
        lambda mu: mu * np.tan(mu * length / 2.0) - h, [(eps, np.pi / length - eps)]
    )
    mu_odd = _bracketed_root(
        lambda mu: mu / np.tan(mu * length / 2.0) + h,
        [
            (np.pi / length + eps, 2 * np.pi / length - eps),
            (3 * np.pi / length + eps, 4 * np.pi / length - eps),
        ],
    )

    reflective = BoundaryCondition(kind="reflective")
    dirichlet0 = BoundaryCondition(kind="dirichlet", value=0.0)
    absorbing = BoundaryCondition(kind="absorbing")
    robin = BoundaryCondition(kind="robin", value=h, aux_value=0.0)
    q1, q2 = 0.02, -0.015

    def cos_mode(base, amp, k):
        init = lambda x, l, d: base + amp * np.cos(k * np.pi * x / l)
        ana = lambda x, t, l, d: base + amp * np.cos(k * np.pi * x[None, :] / l) * np.exp(
            -d * (k * np.pi / l) ** 2 * t[:, None]
        )
        return init, ana

    def sin_mode(amp, k):
        init = lambda x, l, d: amp * np.sin(k * np.pi * x / l)
        ana = lambda x, t, l, d: amp * np.sin(k * np.pi * x[None, :] / l) * np.exp(
            -d * (k * np.pi / l) ** 2 * t[:, None]
        )
        return init, ana

    def flux_mode(q, amp, k):
        init = lambda x, l, d: q * x + amp * np.cos(k * np.pi * x / l)
        ana = lambda x, t, l, d: q * x[None, :] + amp * np.cos(
            k * np.pi * x[None, :] / l
        ) * np.exp(-d * (k * np.pi / l) ** 2 * t[:, None])
        return init, ana

    r1i, r1a = cos_mode(1.0, 0.4, 1)
    r2i, r2a = cos_mode(0.8, 0.3, 2)
    n1i, n1a = flux_mode(q1, 0.25, 1)
    n2i, n2a = flux_mode(q2, 0.2, 2)
    d1i, d1a = sin_mode(1.0, 1)
    d2i, d2a = sin_mode(0.7, 2)
    a1i, a1a = sin_mode(0.6, 1)
    a3i, a3a = sin_mode(0.5, 3)

    robin_even_init = lambda x, l, d: np.cos(mu_even * (x - l / 2.0))
    robin_even_ana = lambda x, t, l, d: np.cos(mu_even * (x[None, :] - l / 2.0)) * np.exp(
        -d * mu_even**2 * t[:, None]
    )
    robin_odd_init = lambda x, l, d: np.sin(mu_odd * (x - l / 2.0))
    robin_odd_ana = lambda x, t, l, d: np.sin(mu_odd * (x[None, :] - l / 2.0)) * np.exp(
        -d * mu_odd**2 * t[:, None]
    )

    return [
        _StripCase(
            "reflective_mode1", "Reflective BC - Cosine Mode 1",
            "Reflective / Insulated (zero flux)", reflective, reflective, r1i, r1a,
            r"u(x,t)=1+0.4\cos\left(\frac{\pi x}{L}\right)e^{-D(\pi/L)^2t}",
            r"u(x,0)=1+0.4\cos\left(\frac{\pi x}{L}\right)",
            "Single Neumann cosine mode decay with conserved average.",
        ),
        _StripCase(
            "reflective_mode2", "Reflective BC - Cosine Mode 2",
            "Reflective / Insulated (zero flux)", reflective, reflective, r2i, r2a,
            r"u(x,t)=0.8+0.3\cos\left(\frac{2\pi x}{L}\right)e^{-D(2\pi/L)^2t}",
            r"u(x,0)=0.8+0.3\cos\left(\frac{2\pi x}{L}\right)",
            "Higher Neumann cosine mode decay with insulated boundaries.",
        ),
        _StripCase(
            "neumann_flux_mode1", "Neumann Flux BC - Linear + Mode 1",
            "Neumann (non-zero flux)",
            BoundaryCondition(kind="neumann", value=-q1),
            BoundaryCondition(kind="neumann", value=q1),
            n1i, n1a,
            r"u(x,t)=qx+0.25\cos\left(\frac{\pi x}{L}\right)e^{-D(\pi/L)^2t},\ q=0.02",
            r"u(x,0)=qx+0.25\cos\left(\frac{\pi x}{L}\right)",
            "Non-zero equal-slope derivative boundaries via homogeneous-mode reduction.",
        ),
        _StripCase(
            "neumann_flux_mode2", "Neumann Flux BC - Linear + Mode 2",
            "Neumann (non-zero flux)",
            BoundaryCondition(kind="neumann", value=-q2),
            BoundaryCondition(kind="neumann", value=q2),
            n2i, n2a,
            r"u(x,t)=qx+0.2\cos\left(\frac{2\pi x}{L}\right)e^{-D(2\pi/L)^2t},\ q=-0.015",
            r"u(x,0)=qx+0.2\cos\left(\frac{2\pi x}{L}\right)",
            "Second non-zero flux validation case with a higher spatial mode.",
        ),
        _StripCase(
            "dirichlet_mode1", "Dirichlet BC - Sine Mode 1",
            "Dirichlet (fixed zero boundary value)", dirichlet0, dirichlet0, d1i, d1a,
            r"u(x,t)=\sin\left(\frac{\pi x}{L}\right)e^{-D(\pi/L)^2t}",
            r"u(x,0)=\sin\left(\frac{\pi x}{L}\right)",
            "Classical first Dirichlet eigenmode decay.",
        ),
        _StripCase(
            "dirichlet_mode2", "Dirichlet BC - Sine Mode 2",
            "Dirichlet (fixed zero boundary value)", dirichlet0, dirichlet0, d2i, d2a,
            r"u(x,t)=0.7\sin\left(\frac{2\pi x}{L}\right)e^{-D(2\pi/L)^2t}",
            r"u(x,0)=0.7\sin\left(\frac{2\pi x}{L}\right)",
            "Second Dirichlet eigenmode decay benchmark.",
        ),
        _StripCase(
            "absorbing_mode1", "Absorbing BC - Sine Mode 1",
            "Absorbing (implemented as zero-value sink)", absorbing, absorbing, a1i, a1a,
            r"u(x,t)=0.6\sin\left(\frac{\pi x}{L}\right)e^{-D(\pi/L)^2t}",
            r"u(x,0)=0.6\sin\left(\frac{\pi x}{L}\right)",
            "Absorbing boundary replay using the same analytic mode as zero Dirichlet sink.",
        ),
        _StripCase(
            "absorbing_mode3", "Absorbing BC - Sine Mode 3",
            "Absorbing (implemented as zero-value sink)", absorbing, absorbing, a3i, a3a,
            r"u(x,t)=0.5\sin\left(\frac{3\pi x}{L}\right)e^{-D(3\pi/L)^2t}",
            r"u(x,0)=0.5\sin\left(\frac{3\pi x}{L}\right)",
            "Higher absorbing mode for sink-boundary validation.",
        ),
        _StripCase(
            "robin_even_mode", "Robin BC - Even Eigenmode",
            "Robin (mixed flux-value)", robin, robin, robin_even_init, robin_even_ana,
            rf"u(x,t)=\cos(\mu_1(x-L/2))e^{{-D\mu_1^2 t}},\ \mu_1\tan(\mu_1L/2)=h,\ h={h}",
            r"u(x,0)=\cos(\mu_1(x-L/2))",
            "First symmetric Robin eigenmode with root from transcendental condition.",
        ),
        _StripCase(
            "robin_odd_mode", "Robin BC - Odd Eigenmode",
            "Robin (mixed flux-value)", robin, robin, robin_odd_init, robin_odd_ana,
            rf"u(x,t)=\sin(\mu_2(x-L/2))e^{{-D\mu_2^2 t}},\ \mu_2\cot(\mu_2L/2)=-h,\ h={h}",
            r"u(x,0)=\sin(\mu_2(x-L/2))",
            "First antisymmetric Robin eigenmode benchmark.",
        ),
    ]


def _strip_group(nx, dx, D, dt, total_time, store_every, *, device="cuda", dtype=None) -> TestGeometryGroupData:
    length = nx * dx
    x_centers = (np.arange(nx, dtype=np.float64) + 0.5) * dx
    mask = np.ones((1, nx), dtype=bool)
    edges = extract_edge_segments(mask)

    cases = []
    for cd in _strip_cases(length):
        bcs = {}
        for e in edges:
            if e.normal == "left":
                bcs[e.edge_id] = cd.left_bc
            elif e.normal == "right":
                bcs[e.edge_id] = cd.right_bc
            else:
                bcs[e.edge_id] = BoundaryCondition(kind="reflective")
        initial = np.zeros((1, nx))
        initial[0] = cd.init_fn(x_centers, length, D)
        times, frames, *_ = run_2d_crank_nicolson(
            mask=mask, edges=edges, edge_conditions=bcs, initial_field=initial,
            diffusion_coefficient=D, dt=dt, total_time=total_time, dx=dx,
            store_every=store_every, device=device, dtype=dtype,
        )
        t_arr = np.asarray(times)
        simulated = np.asarray([f[0, :] for f in frames])
        analytic = np.asarray(cd.analytic_fn(x_centers, t_arr, length, D))
        cases.append(
            TestCaseResultData(
                case_id=cd.case_id,
                title=cd.title,
                boundary_label=cd.boundary_label,
                formula_latex=cd.formula_latex,
                initial_condition_latex=cd.initial_latex,
                description=cd.description,
                x=x_centers.tolist(),
                times=t_arr.tolist(),
                simulated=simulated.tolist(),
                analytic=analytic.tolist(),
                metadata={
                    "geometry_id": "strip_1d_effective",
                    "view_mode": "line1d",
                    "diffusion_coefficient": D,
                    "dx": dx,
                    "dt": dt,
                    "total_time": total_time,
                },
            )
        )
    preview = np.zeros((14, nx + 8), dtype=int)
    preview[6:8, 4:-4] = 1
    return TestGeometryGroupData(
        geometry_id="strip_1d_effective",
        title="Effective 1D Strip",
        description=(
            "One-cell-thick strip solved with full 2D engine; "
            "10 boundary-condition validation cases."
        ),
        view_mode="line1d",
        preview_mask=preview.tolist(),
        cases=cases,
    )


# --------------------------------------------------------------------------
# group 2: 2D rectangle eigenmodes
# --------------------------------------------------------------------------


def _rectangle_group(dx, D, dt, total_time, store_every, *, device="cuda", dtype=None) -> TestGeometryGroupData:
    nx, ny = 56, 36
    lx, ly = nx * dx, ny * dx
    gx, gy = np.meshgrid(
        (np.arange(nx) + 0.5) * dx, (np.arange(ny) + 0.5) * dx
    )
    mask = np.ones((ny, nx), dtype=bool)
    edges = extract_edge_segments(mask)
    dirichlet0 = BoundaryCondition(kind="dirichlet", value=0.0)
    reflective = BoundaryCondition(kind="reflective")

    def bcs_by_normal(overrides):
        return {e.edge_id: overrides.get(e.normal, reflective) for e in edges}

    cases = []

    def run_case(case_id, title, boundary_label, formula, initial_latex, description,
                 m, n, phi, bcs):
        lam_sq = (m * np.pi / lx) ** 2 + (n * np.pi / ly) ** 2
        times, frames, *_ = run_2d_crank_nicolson(
            mask=mask, edges=edges, edge_conditions=bcs, initial_field=phi.copy(),
            diffusion_coefficient=D, dt=dt, total_time=total_time, dx=dx,
            store_every=store_every, device=device, dtype=dtype,
        )
        t_arr = np.asarray(times)
        analytic = [phi * np.exp(-D * lam_sq * t) for t in t_arr]
        cases.append(
            TestCaseResultData(
                case_id=case_id, title=title, boundary_label=boundary_label,
                formula_latex=formula, initial_condition_latex=initial_latex,
                description=description, x=[], times=t_arr.tolist(),
                simulated=[frame_to_jsonable(f) for f in frames],
                analytic=[frame_to_jsonable(f) for f in analytic],
                metadata={
                    "geometry_id": "rectangle_2d", "view_mode": "heatmap2d",
                    "grid_shape": [ny, nx], "mode_m": m, "mode_n": n,
                    "diffusion_coefficient": D, "dx": dx, "dt": dt,
                    "total_time": total_time,
                },
            )
        )

    all_dirichlet = {e.edge_id: dirichlet0 for e in edges}
    for i, (m, n) in enumerate([(1, 1), (2, 1), (1, 2), (2, 2), (3, 1), (1, 3)], start=1):
        phi = np.sin(m * np.pi * gx / lx) * np.sin(n * np.pi * gy / ly)
        run_case(
            f"rectangle_mode_{m}_{n}",
            f"Rectangle Mode ({m}, {n})",
            "Dirichlet zero on all rectangle edges",
            (
                rf"u(x,y,t)=\sin\left(\frac{{{m}\pi x}}{{L_x}}\right)"
                rf"\sin\left(\frac{{{n}\pi y}}{{L_y}}\right)"
                rf"e^{{-D[(\frac{{{m}\pi}}{{L_x}})^2+(\frac{{{n}\pi}}{{L_y}})^2]t}}"
            ),
            (
                rf"u(x,y,0)=\sin\left(\frac{{{m}\pi x}}{{L_x}}\right)"
                rf"\sin\left(\frac{{{n}\pi y}}{{L_y}}\right)"
            ),
            f"2D rectangular Dirichlet eigenmode benchmark case {i}.",
            m, n, phi, all_dirichlet,
        )

    run_case(
        "rectangle_mix_dirichlet_x_neumann_y_1_1",
        "Rectangle Mixed BC (D/N) Mode (1, 1)",
        "Dirichlet on left/right, reflective on top/bottom",
        (
            r"u(x,y,t)=\sin\left(\frac{\pi x}{L_x}\right)\cos\left(\frac{\pi y}{L_y}\right)"
            r"e^{-D[(\frac{\pi}{L_x})^2+(\frac{\pi}{L_y})^2]t}"
        ),
        r"u(x,y,0)=\sin\left(\frac{\pi x}{L_x}\right)\cos\left(\frac{\pi y}{L_y}\right)",
        "Mixed-boundary rectangle benchmark with Dirichlet-x and Neumann-y constraints.",
        1, 1,
        np.sin(np.pi * gx / lx) * np.cos(np.pi * gy / ly),
        bcs_by_normal({"left": dirichlet0, "right": dirichlet0}),
    )
    run_case(
        "rectangle_mix_neumann_x_dirichlet_y_1_1",
        "Rectangle Mixed BC (N/D) Mode (1, 1)",
        "Reflective on left/right, Dirichlet on top/bottom",
        (
            r"u(x,y,t)=\cos\left(\frac{\pi x}{L_x}\right)\sin\left(\frac{\pi y}{L_y}\right)"
            r"e^{-D[(\frac{\pi}{L_x})^2+(\frac{\pi}{L_y})^2]t}"
        ),
        r"u(x,y,0)=\cos\left(\frac{\pi x}{L_x}\right)\sin\left(\frac{\pi y}{L_y}\right)",
        "Mixed-boundary rectangle benchmark with Neumann-x and Dirichlet-y constraints.",
        1, 1,
        np.cos(np.pi * gx / lx) * np.sin(np.pi * gy / ly),
        bcs_by_normal({"up": dirichlet0, "down": dirichlet0}),
    )
    run_case(
        "rectangle_reflective_mode_1_1",
        "Rectangle Reflective Mode (1, 1)",
        "Reflective on all rectangle edges",
        (
            r"u(x,y,t)=\cos\left(\frac{\pi x}{L_x}\right)\cos\left(\frac{\pi y}{L_y}\right)"
            r"e^{-D[(\frac{\pi}{L_x})^2+(\frac{\pi}{L_y})^2]t}"
        ),
        r"u(x,y,0)=\cos\left(\frac{\pi x}{L_x}\right)\cos\left(\frac{\pi y}{L_y}\right)",
        "Fully reflective rectangle benchmark with zero-flux boundaries on all sides.",
        1, 1,
        np.cos(np.pi * gx / lx) * np.cos(np.pi * gy / ly),
        {e.edge_id: reflective for e in edges},
    )

    preview = np.pad(mask.astype(int), 3)
    return TestGeometryGroupData(
        geometry_id="rectangle_2d",
        title="2D Rectangle",
        description=(
            "Non-1D rectangular diffusion with Dirichlet, mixed, and reflective "
            "analytic eigenmode solutions."
        ),
        view_mode="heatmap2d",
        preview_mask=preview.tolist(),
        cases=cases,
    )


# --------------------------------------------------------------------------
# group 3: polygonal annulus with radial Bessel modes
# --------------------------------------------------------------------------


def _regular_polygon(cx, cy, radius, sides, clockwise=False) -> np.ndarray:
    angles = np.linspace(0.0, 2.0 * np.pi, sides, endpoint=False)
    if clockwise:
        angles = angles[::-1]
    return np.column_stack([cx + radius * np.cos(angles), cy + radius * np.sin(angles)])


def _donut_mask(nx, ny):
    gx, gy = np.meshgrid(np.arange(nx) + 0.5, np.arange(ny) + 0.5)
    pts = np.column_stack([gx.ravel(), gy.ravel()])
    cx, cy = nx / 2.0, ny / 2.0
    outer_r = 0.42 * min(nx, ny)
    inner_r = 0.19 * min(nx, ny)
    outer = _regular_polygon(cx, cy, outer_r, 20)
    inner = _regular_polygon(cx, cy, inner_r, 20, clockwise=True)
    mask = (points_in_polygon(outer, pts) & ~points_in_polygon(inner, pts)).reshape(ny, nx)
    return mask, cx, cy, inner_r, outer_r


def _annulus_eigenvalue(inner_r, outer_r, mode_index, inner_boundary, outer_boundary) -> float:
    """k-th root of the annulus radial cross-product condition.

    Dirichlet rows use (J₀, Y₀); reflective/neumann rows use (J₁, Y₁) since
    d/dr[J₀(λr)] ∝ J₁(λr).
    """

    def row(lam, radius, boundary):
        if boundary in {"reflective", "neumann"}:
            return float(special.j1(lam * radius)), float(special.y1(lam * radius))
        return float(special.j0(lam * radius)), float(special.y0(lam * radius))

    def f(lam):
        i0, i1 = row(lam, inner_r, inner_boundary)
        o0, o1 = row(lam, outer_r, outer_boundary)
        return i0 * o1 - i1 * o0

    roots: list[float] = []
    left = 1e-4
    f_left = f(left)
    for right in np.linspace(0.01, 4.0, 5000):
        f_right = f(right)
        if np.isfinite(f_left) and np.isfinite(f_right) and f_left * f_right < 0:
            try:
                root = float(brentq(f, left, right))
            except Exception:
                root = None
            if root is not None and (not roots or abs(root - roots[-1]) > 1e-4):
                roots.append(root)
                if len(roots) >= mode_index:
                    return roots[mode_index - 1]
        left, f_left = right, f_right
    raise ValueError("Failed to find annulus eigenvalue root.")


def _annulus_mode(r, lam, inner_r, inner_boundary):
    if inner_boundary in {"reflective", "neumann"}:
        cj, cy_ = special.y1(lam * inner_r), -special.j1(lam * inner_r)
    else:
        cj, cy_ = special.y0(lam * inner_r), -special.j0(lam * inner_r)
    return cj * special.j0(lam * r) + cy_ * special.y0(lam * r)


def _donut_group(dx, D, dt, total_time, store_every, *, device="cuda", dtype=None) -> TestGeometryGroupData:
    nx = ny = 64
    mask, cx, cy, inner_r, outer_r = _donut_mask(nx, ny)
    edges = extract_edge_segments(mask)
    dirichlet0 = BoundaryCondition(kind="dirichlet", value=0.0)
    reflective = BoundaryCondition(kind="reflective")
    y_idx, x_idx = np.indices(mask.shape, dtype=np.float64)
    r = np.hypot(x_idx + 0.5 - cx, y_idx + 0.5 - cy)

    split_radius = 0.5 * (inner_r + outer_r)

    def edge_bcs(inner_bc, outer_bc):
        out = {}
        for e in edges:
            mid_r = float(np.hypot(0.5 * (e.x0 + e.x1) - cx, 0.5 * (e.y0 + e.y1) - cy))
            out[e.edge_id] = inner_bc if mid_r < split_radius else outer_bc
        return out

    profiles = [
        ("donut_radial_dd_mode_1", "Donut Radial D/D Mode 1", "dirichlet", "dirichlet",
         "Dirichlet on inner and outer polygon boundaries",
         r"\phi_k(a)=0,\quad \phi_k(b)=0"),
        ("donut_radial_dn_mode_1", "Donut Radial D/N Mode 1", "dirichlet", "reflective",
         "Dirichlet inner boundary, reflective outer boundary",
         r"\phi_k(a)=0,\quad \partial_r\phi_k(b)=0"),
        ("donut_radial_nd_mode_1", "Donut Radial N/D Mode 1", "reflective", "dirichlet",
         "Reflective inner boundary, Dirichlet outer boundary",
         r"\partial_r\phi_k(a)=0,\quad \phi_k(b)=0"),
        ("donut_radial_nn_mode_1", "Donut Radial N/N Mode 1", "reflective", "reflective",
         "Reflective inner and outer polygon boundaries",
         r"\partial_r\phi_k(a)=0,\quad \partial_r\phi_k(b)=0"),
    ]
    cases = []
    for case_id, title, inner_b, outer_b, boundary_label, boundary_latex in profiles:
        lam = _annulus_eigenvalue(inner_r, outer_r, 1, inner_b, outer_b)
        phi = _annulus_mode(r, lam, inner_r, inner_b)
        phi[~mask] = 0.0
        amp = np.max(np.abs(phi[mask]))
        if amp > 0:
            phi = phi / amp
        bcs = edge_bcs(
            dirichlet0 if inner_b == "dirichlet" else reflective,
            dirichlet0 if outer_b == "dirichlet" else reflective,
        )
        times, frames, *_ = run_2d_crank_nicolson(
            mask=mask, edges=edges, edge_conditions=bcs, initial_field=phi.copy(),
            diffusion_coefficient=D, dt=dt, total_time=total_time, dx=dx,
            store_every=store_every, device=device, dtype=dtype,
        )
        t_arr = np.asarray(times)
        analytic = []
        for t in t_arr:
            frame = phi * np.exp(-D * lam * lam * t)
            frame[~mask] = np.nan
            analytic.append(frame)
        cases.append(
            TestCaseResultData(
                case_id=case_id, title=title, boundary_label=boundary_label,
                formula_latex=r"u(r,t)=\phi_k(r)e^{-D\lambda_k^2 t},\ " + boundary_latex,
                initial_condition_latex=r"u(r,0)=\phi_k(r)",
                description=(
                    "Polygon annulus benchmark using radial Bessel eigenmodes "
                    f"with {boundary_label.lower()} (k=1)."
                ),
                x=[], times=t_arr.tolist(),
                simulated=[frame_to_jsonable(f) for f in frames],
                analytic=[frame_to_jsonable(f) for f in analytic],
                metadata={
                    "geometry_id": "polygon_donut", "view_mode": "heatmap2d",
                    "grid_shape": [ny, nx], "mode_index": 1,
                    "inner_boundary": inner_b, "outer_boundary": outer_b,
                    "lambda": float(lam), "inner_radius": float(inner_r),
                    "outer_radius": float(outer_r), "diffusion_coefficient": D,
                    "dx": dx, "dt": dt, "total_time": total_time,
                },
            )
        )
    preview = np.pad(mask.astype(int), 3)
    return TestGeometryGroupData(
        geometry_id="polygon_donut",
        title="Polygon Donut",
        description=(
            "Polygonal annulus geometry with Dirichlet/reflective boundary variants "
            "and radial Bessel analytic solutions."
        ),
        view_mode="heatmap2d",
        preview_mask=preview.tolist(),
        cases=cases,
    )


# --------------------------------------------------------------------------
# groups 4 & 5: zero-dimensional collision ODE benchmarks
# --------------------------------------------------------------------------


def _run_point_collisions(**kwargs):
    """Energy-resolved single-cell run with diffusion off."""
    mask = np.ones((1, 1), dtype=bool)
    edges = extract_edge_segments(mask)
    bcs = {e.edge_id: BoundaryCondition(kind="reflective") for e in edges}
    return run_2d_crank_nicolson(
        mask=mask, edges=edges, edge_conditions=bcs, diffusion_coefficient=1.0,
        dx=1.0, enable_diffusion=False, **kwargs,
    )


def _timeseries_case(case_id, title, formula, initial_latex, description,
                     t_arr, simulated, analytic, group_id, extra_meta) -> TestCaseResultData:
    return TestCaseResultData(
        case_id=case_id, title=title,
        boundary_label="Reflective (single cell, no diffusion)",
        formula_latex=formula, initial_condition_latex=initial_latex,
        description=description,
        x=t_arr.tolist(), times=[0.0],
        simulated=[np.asarray(simulated).tolist()],
        analytic=[np.asarray(analytic).tolist()],
        metadata={"geometry_id": group_id, "view_mode": "timeseries", **extra_meta},
    )


def _recombination_group(*, device="cuda", dtype=None) -> TestGeometryGroupData:
    cases = []
    gap, tc = 180.0, 1.2

    # 1) pure two-body decay at T=0: dn/dt = −Rn² → n(t) = n0/(1+R n0 t)
    tau = 440.0
    E1 = np.array([1.5 * gap])
    R = 2.0 * float(recombination_kernel(E1, gap, tau, tc, 0.0)[0, 0])
    n0 = 0.5
    times, _, _, _, ef, _ = _run_point_collisions(
        device=device, dtype=dtype,
        initial_field=np.full((1, 1), n0), dt=0.5, total_time=2000.0, store_every=4,
        energy_gap=gap, energy_min_factor=1.5, energy_max_factor=1.5, num_energy_bins=1,
        energy_weights=np.array([1.0]), enable_recombination=True,
        tau_0=tau, T_c=tc, bath_temperature=0.0,
    )
    t_arr = np.asarray(times)
    sim = np.array([frame[0][0, 0] for frame in ef])
    cases.append(_timeseries_case(
        "recomb_pure_1_over_t", "Pure 1/t Recombination Decay",
        r"n(t) = \frac{n_0}{1 + R\,n_0\,t},\quad R = 2\,K^r\,\Delta E",
        r"n(0) = 0.5",
        "Single energy bin at E=1.5Δ, T_bath=0. Two-body recombination gives "
        "dn/dt = -Rn² with the classic 1/t power-law solution.",
        t_arr, sim, n0 / (1.0 + R * n0 * t_arr), "recombination",
        {"tau_0": tau, "T_c": tc, "gap": gap, "T_bath": 0.0, "R": R, "n0": n0},
    ))

    # 2) thermal equilibrium is stationary (generation balances recombination)
    tau2, tbath2, nb2 = 10.0, 0.8, 15
    E2, dE2 = build_energy_grid(gap, 1.0, 3.0, nb2)
    n_eq = thermal_qp_weights(E2, gap, tbath2)
    total_eq = float(np.sum(n_eq) * dE2)
    times, _, _, _, ef, _ = _run_point_collisions(
        device=device, dtype=dtype,
        initial_field=np.full((1, 1), total_eq), dt=0.1, total_time=200.0, store_every=10,
        energy_gap=gap, energy_min_factor=1.0, energy_max_factor=3.0, num_energy_bins=nb2,
        energy_weights=n_eq, enable_recombination=True,
        tau_0=tau2, T_c=tc, bath_temperature=tbath2,
    )
    t_arr = np.asarray(times)
    sim = np.array([float(np.sum([b[0, 0] for b in frame]) * dE2) for frame in ef])
    cases.append(_timeseries_case(
        "recomb_equilibrium_stationarity", "Equilibrium Stationarity",
        r"n(t) = n_{\mathrm{eq}} = \mathrm{const}",
        r"n(0) = n_{\mathrm{eq}}(T_{\mathrm{bath}})",
        "15 energy bins, T_bath=0.8 K, τ₀=10 ns. Initial state is exact thermal "
        "equilibrium. Thermal generation exactly balances recombination, so total "
        "QP density remains constant.",
        t_arr, sim, np.full_like(t_arr, total_eq), "recombination",
        {"tau_0": tau2, "T_c": tc, "gap": gap, "T_bath": tbath2, "n_eq": total_eq},
    ))

    # 3) coth decay to equilibrium: dn/dt = R(n_eq² − n²)
    tau3, tbath3 = 10.0, 0.8
    E3 = np.array([1.5 * gap])
    K3 = float(recombination_kernel(E3, gap, tau3, tc, tbath3)[0, 0])
    R3 = 2.0 * K3
    w3 = thermal_qp_weights(E3, gap, tbath3)
    G3 = 2.0 * w3[0] * K3 * w3[0]
    n_eq3 = np.sqrt(G3 / R3)
    n0_3 = 0.5
    times, _, _, _, ef, _ = _run_point_collisions(
        device=device, dtype=dtype,
        initial_field=np.full((1, 1), n0_3), dt=0.05, total_time=50.0, store_every=4,
        energy_gap=gap, energy_min_factor=1.5, energy_max_factor=1.5, num_energy_bins=1,
        energy_weights=np.array([1.0]), enable_recombination=True,
        tau_0=tau3, T_c=tc, bath_temperature=tbath3,
    )
    t_arr = np.asarray(times)
    sim = np.array([frame[0][0, 0] for frame in ef])
    arccoth = 0.5 * np.log((n0_3 / n_eq3 + 1.0) / (n0_3 / n_eq3 - 1.0))
    cases.append(_timeseries_case(
        "recomb_decay_to_equilibrium", "Decay to Thermal Equilibrium",
        r"n(t) = n_{\mathrm{eq}}\,\coth\!\left(R\,n_{\mathrm{eq}}\,t + "
        r"\mathrm{arccoth}\!\left(\frac{n_0}{n_{\mathrm{eq}}}\right)\right)",
        r"n(0) = 0.5 \gg n_{\mathrm{eq}}",
        "Single energy bin at E=1.5Δ, T_bath=0.8 K, τ₀=10 ns. Elevated initial "
        "density decays toward thermal equilibrium via dn/dt = R(n_eq² - n²).",
        t_arr, sim, n_eq3 / np.tanh(R3 * n_eq3 * t_arr + arccoth), "recombination",
        {"tau_0": tau3, "T_c": tc, "gap": gap, "T_bath": tbath3,
         "R": R3, "n0": n0_3, "n_eq": float(n_eq3)},
    ))

    preview = np.zeros((8, 12), dtype=int)
    preview[3:5, 5:7] = 1
    return TestGeometryGroupData(
        geometry_id="recombination",
        title="Recombination Dynamics",
        description=(
            "Quasiparticle recombination test cases comparing simulated dynamics "
            "to analytic ODE solutions."
        ),
        view_mode="timeseries",
        preview_mask=preview.tolist(),
        cases=cases,
    )


def _scattering_group(*, device="cuda", dtype=None) -> TestGeometryGroupData:
    cases = []
    gap, tc, tau = 180.0, 1.2, 10.0

    # 1) top-bin exponential decay: Γ = ΔE Σ_j K^s_{top,j} ρ_j
    tbath1, nb1 = 0.3, 10
    E1, dE1 = build_energy_grid(gap, 1.0, 3.0, nb1)
    Ks = scattering_kernel(E1, gap, tau, tc, tbath1)
    rho = bcs_density_of_states(E1, gap)
    top = nb1 - 1
    gamma_top = dE1 * float(np.sum(Ks[top, :] * rho))
    n0 = 0.01
    weights = np.zeros(nb1)
    weights[top] = 1.0
    times, _, _, _, ef, _ = _run_point_collisions(
        device=device, dtype=dtype,
        initial_field=np.full((1, 1), n0), dt=0.002, total_time=4.0, store_every=20,
        energy_gap=gap, energy_min_factor=1.0, energy_max_factor=3.0, num_energy_bins=nb1,
        energy_weights=weights, enable_scattering=True,
        tau_0=tau, T_c=tc, bath_temperature=tbath1,
    )
    t_arr = np.asarray(times)
    sim = np.array([frame[top][0, 0] for frame in ef]) * dE1
    cases.append(_timeseries_case(
        "scat_top_bin_decay", "Top-Bin Scattering Out (Exponential Decay)",
        r"n_{\mathrm{top}}(t)=n_0 e^{-\Gamma t},\quad "
        r"\Gamma=\Delta E\sum_j K^s_{\mathrm{top},j}\rho_j",
        r"n_{\mathrm{top}}(0)=0.01,\quad n_{j\neq \mathrm{top}}(0)=0",
        "10 energy bins, T_bath=0.3 K, τ₀=10 ns. Only the highest bin is populated "
        "(low density, Pauli blocking ≈ 0). No density above → nothing scatters in. "
        "Pure exponential decay at rate Γ.",
        t_arr, sim, n0 * np.exp(-gamma_top * t_arr), "scattering",
        {"tau_0": tau, "T_c": tc, "gap": gap, "T_bath": tbath1,
         "Gamma_top": gamma_top, "n0": n0},
    ))

    # 2) equilibrium stationarity under pure scattering (detailed balance)
    tbath2, nb2 = 0.8, 15
    E2, dE2 = build_energy_grid(gap, 1.0, 3.0, nb2)
    n_eq = thermal_qp_weights(E2, gap, tbath2)
    total_eq = float(np.sum(n_eq) * dE2)
    times, _, _, _, ef, _ = _run_point_collisions(
        device=device, dtype=dtype,
        initial_field=np.full((1, 1), total_eq), dt=0.1, total_time=200.0, store_every=10,
        energy_gap=gap, energy_min_factor=1.0, energy_max_factor=3.0, num_energy_bins=nb2,
        energy_weights=n_eq, enable_scattering=True,
        tau_0=tau, T_c=tc, bath_temperature=tbath2,
    )
    t_arr = np.asarray(times)
    sim = np.array([float(np.sum([b[0, 0] for b in frame]) * dE2) for frame in ef])
    cases.append(_timeseries_case(
        "scat_equilibrium_stationarity", "Scattering Equilibrium Stationarity",
        r"n(t) = n_{\mathrm{eq}} = \mathrm{const}",
        r"n(0) = n_{\mathrm{eq}}(T_{\mathrm{bath}})",
        "15 energy bins, T_bath=0.8 K, τ₀=10 ns. Initial state is exact thermal "
        "equilibrium. Detailed balance ensures scattering in = scattering out at "
        "every energy, so total QP density remains constant.",
        t_arr, sim, np.full_like(t_arr, total_eq), "scattering",
        {"tau_0": tau, "T_c": tc, "gap": gap, "T_bath": tbath2, "n_eq": total_eq},
    ))

    preview = np.zeros((8, 12), dtype=int)
    preview[3:5, 5:7] = 1
    return TestGeometryGroupData(
        geometry_id="scattering",
        title="Scattering Dynamics",
        description=(
            "Quasiparticle-phonon scattering test cases verifying exponential decay "
            "and detailed balance."
        ),
        view_mode="timeseries",
        preview_mask=preview.tolist(),
        cases=cases,
    )


# --------------------------------------------------------------------------
# suite assembly
# --------------------------------------------------------------------------


def generate_test_suite(
    nx: int = 100,
    dx: float = 1.0,
    diffusion_coefficient: float = 25.0,
    dt: float = 0.05,
    total_time: float = 8.0,
    store_every: int = 2,
    *,
    device="cuda",
    dtype=None,
) -> TestSuiteData:
    """Generate the full 28-case analytic benchmark suite (5 groups).

    ``device`` is "cuda" (the default; raises without a card) or "cpu";
    ``dtype`` a torch dtype (float32 on the card, float64 on the CPU by
    default).
    """
    if nx < 8:
        raise ValueError("nx must be at least 8 for test generation.")
    if abs(dx - 1.0) > 1e-9:
        raise ValueError("Test suite expects mesh_size (dx) = 1.0.")
    on = dict(device=device, dtype=dtype)
    groups = [
        _strip_group(nx, dx, diffusion_coefficient, dt, total_time, store_every, **on),
        _rectangle_group(dx, diffusion_coefficient, dt, total_time, store_every, **on),
        _donut_group(dx, diffusion_coefficient, dt, total_time, store_every, **on),
        _recombination_group(**on),
        _scattering_group(**on),
    ]
    return TestSuiteData(
        suite_id=uuid.uuid4().hex[:12],
        created_at=utc_now_iso(),
        cases=[],
        geometry_groups=groups,
        metadata={"format_version": TEST_SUITE_FORMAT_VERSION},
    )


def generate_and_save_test_suite(*, device="cuda", dtype=None) -> tuple[TestSuiteData, str]:
    suite = generate_test_suite(device=device, dtype=dtype)
    return suite, str(save_test_suite(suite))
