"""The port's host layer equals the JAX package's, exactly.

``qpsim_tpu_torch`` carries its own copy of the numpy host code (it may not
import ``qpsim_tpu``, whose package import pulls in JAX); these tests pin
that copy bit-for-bit to the original, and scan the port's sources for
forbidden imports.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import qpsim_tpu.geometry.mask as j_mask  # noqa: E402
import qpsim_tpu.ops.diffusion as j_diff  # noqa: E402
import qpsim_tpu.ops.dos as j_dos  # noqa: E402
import qpsim_tpu.ops.energy_grid as j_grid  # noqa: E402
import qpsim_tpu.ops.kernels as j_kern  # noqa: E402
import qpsim_tpu.ops.phonon_map as j_pmap  # noqa: E402
from qpsim_tpu.models.params import BoundaryCondition  # noqa: E402

import qpsim_tpu_torch.geometry.mask as t_mask  # noqa: E402
import qpsim_tpu_torch.ops.diffusion as t_diff  # noqa: E402
import qpsim_tpu_torch.ops.dos as t_dos  # noqa: E402
import qpsim_tpu_torch.ops.energy_grid as t_grid  # noqa: E402
import qpsim_tpu_torch.ops.kernels as t_kern  # noqa: E402
import qpsim_tpu_torch.ops.phonon_map as t_pmap  # noqa: E402
from qpsim_tpu_torch import constants as t_const  # noqa: E402
from qpsim_tpu_torch.models import params as t_params  # noqa: E402

_KINDS = ["reflective", "absorbing", "dirichlet", "neumann", "robin"]
_PORT = Path(__file__).resolve().parents[1] / "qpsim_tpu_torch"


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.mark.parametrize(
    "gap,fmin,fmax,ne", [(180.0, 1.0, 4.0, 16), (180.0, 1.0, 4.0, 11), (200.0, 1.2, 10.0, 50), (180.0, 1.0, 3.0, 1)]
)
def test_energy_grid_and_widths(gap, fmin, fmax, ne):
    ej, dj = j_grid.build_energy_grid(gap, fmin, fmax, ne)
    et, dt = t_grid.build_energy_grid(gap, fmin, fmax, ne)
    _eq(et, ej)
    assert dt == dj
    _eq(
        t_grid.integration_widths_from_centers(et, fallback_width=dt),
        j_grid.integration_widths_from_centers(ej, fallback_width=dj),
    )


@pytest.mark.parametrize("gamma", [0.0, 2.5])
def test_dos_and_occupations(gamma):
    E, _ = j_grid.build_energy_grid(180.0, 1.0, 4.0, 24)
    _eq(t_dos.dynes_density_of_states(E, 180.0, gamma), j_dos.dynes_density_of_states(E, 180.0, gamma))
    gaps = np.array([150.0, 180.0, 200.0])
    _eq(
        t_dos.dynes_density_of_states_per_pixel(E, gaps, gamma),
        j_dos.dynes_density_of_states_per_pixel(E, gaps, gamma),
    )
    for T in (0.0, 0.1, 0.3):
        _eq(t_dos.thermal_phonon_occupation(E, T), j_dos.thermal_phonon_occupation(E, T))
        _eq(t_dos.fermi_dirac_occupation(E, T), j_dos.fermi_dirac_occupation(E, T))
        _eq(t_dos.thermal_qp_weights(E, 180.0, T, gamma), j_dos.thermal_qp_weights(E, 180.0, T, gamma))
    _eq(
        t_dos.diffusion_coefficient_of_energy(6.0, E, 180.0),
        j_dos.diffusion_coefficient_of_energy(6.0, E, 180.0),
    )
    assert t_const.K_B_UEV_PER_K == 86.17333262145


@pytest.mark.parametrize("ne", [8, 16, 50])
def test_kernel_tables(ne):
    E, dE = j_grid.build_energy_grid(180.0, 1.0, 4.0, ne)
    for fn in ("recombination_kernel_base", "scattering_kernel_base"):
        _eq(getattr(t_kern, fn)(E, 180.0, 440.0, 1.2), getattr(j_kern, fn)(E, 180.0, 440.0, 1.2))
    for fn in ("recombination_kernel", "scattering_kernel"):
        _eq(getattr(t_kern, fn)(E, 180.0, 440.0, 1.2, 0.1), getattr(j_kern, fn)(E, 180.0, 440.0, 1.2, 0.1))


@pytest.mark.parametrize(
    "gap,fmax,ne", [(180.0, 4.0, 8), (180.0, 4.0, 11), (180.0, 4.0, 16), (180.0, 10.0, 50)]
)
def test_phonon_frequency_map(gap, fmax, ne):
    # NE = 11 at Δ = 180, E_max/Δ = 4 splits a Toeplitz diagonal across two
    # ω bins (the 1e-12 dedup); the port must keep that exact binning
    E, _ = j_grid.build_energy_grid(gap, 1.0, fmax, ne)
    pj, pt = j_pmap.build_phonon_frequency_map(E), t_pmap.build_phonon_frequency_map(E)
    for field in ("omega_bins", "idx_diff", "idx_sum", "diff_sign", "scatter_diff", "scatter_sum"):
        _eq(getattr(pt, field), getattr(pj, field))
    assert pt.num_omega == pj.num_omega


def _donut(n=20):
    mask = np.ones((n, n), dtype=bool)
    mask[n // 3 : 2 * n // 3, n // 3 : 2 * n // 3] = False
    mask[0, :3] = False
    return mask


def _geometries():
    geo = t_mask.create_intrinsic_geometry(width=40, height=24)
    return {"rectangle": t_mask.mask_from_lists(geo.mask), "donut": _donut()}


@pytest.mark.parametrize("name", ["rectangle", "donut"])
def test_edge_segments(name):
    mask = _geometries()[name]
    ej, et = j_mask.extract_edge_segments(mask), t_mask.extract_edge_segments(mask)
    assert len(et) == len(ej)
    for a, b in zip(et, ej):
        assert (a.edge_id, a.x0, a.y0, a.x1, a.y1, a.normal) == (b.edge_id, b.x0, b.y0, b.x1, b.y1, b.normal)
        assert [(f.row, f.col, f.direction) for f in a.faces] == [
            (f.row, f.col, f.direction) for f in b.faces
        ]
    for d, plane in t_mask.boundary_face_map(mask).items():
        _eq(plane, j_mask.boundary_face_map(mask)[d])
    gj = j_mask.create_intrinsic_geometry(width=33, height=20)
    gt = t_mask.create_intrinsic_geometry(width=33, height=20)
    assert gt.mask == gj.mask and gt.bounds == gj.bounds and len(gt.edges) == len(gj.edges)


@pytest.mark.parametrize("name", ["rectangle", "donut"])
@pytest.mark.parametrize("d_kind", ["scalar", "per_bin", "per_pixel"])
def test_stencils_fold_and_dense_operator(name, d_kind):
    mask = _geometries()[name]
    rng = np.random.default_rng(7)
    edges = t_mask.extract_edge_segments(mask)
    bcs_j, bcs_t = {}, {}
    for i, e in enumerate(edges):
        kind = _KINDS[i % len(_KINDS)]
        kw = dict(
            kind=kind,
            value=0.3 if kind in ("dirichlet", "neumann", "robin") else None,
            aux_value=0.1 if kind == "robin" else None,
        )
        bcs_j[e.edge_id] = BoundaryCondition(**kw)
        bcs_t[e.edge_id] = t_params.BoundaryCondition(**kw)
    ny, nx = mask.shape
    D = {
        "scalar": 6.0,
        "per_bin": rng.uniform(1.0, 3.0, 3),
        "per_pixel": rng.uniform(1.0, 3.0, (2, ny, nx)),
    }[d_kind]
    sj = j_diff.build_directional_stencils(mask, edges, bcs_j, 0.7)
    st = t_diff.build_directional_stencils(mask, edges, bcs_t, 0.7)
    for a, b in zip(st, sj):
        for f in ("couple_lo", "couple_hi", "bc_diag", "bc_src"):
            _eq(getattr(a, f), getattr(b, f))
    oj = j_diff.fold_diffusion(*sj, mask, 0.7, D)
    ot = t_diff.fold_diffusion(*st, mask, 0.7, D)
    for f in ("ax_lo", "ax_hi", "ax_diag", "sx", "ay_lo", "ay_hi", "ay_diag", "sy", "mask"):
        _eq(getattr(ot, f), getattr(oj, f))
    assert (ot.bin_scale is None) == (oj.bin_scale is None)
    if ot.bin_scale is not None:
        _eq(ot.bin_scale, oj.bin_scale)
    for a, b in zip(t_diff.assemble_dense_operator(ot), j_diff.assemble_dense_operator(oj)):
        _eq(a, b)


def test_missing_boundary_condition_raises():
    mask = _donut()
    edges = t_mask.extract_edge_segments(mask)
    bcs = {e.edge_id: t_params.BoundaryCondition(kind="reflective") for e in edges[1:]}
    with pytest.raises(t_diff.BoundaryAssignmentError):
        t_diff.build_directional_stencils(mask, edges, bcs, 1.0)


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_port_never_imports_jax_or_the_jax_package():
    # nor orbax: the card's machine has none, so an import there would fail only on the card
    files = sorted(_PORT.rglob("*.py")) + [_PORT.parent / "chip_smoke.py"]
    assert len(files) > 20
    assert _PORT / "io" / "checkpoint.py" in files and _PORT / "runner.py" in files
    for name in ("observables.py", "qubit.py", "diff.py", "parallel/__init__.py", "parallel/ensemble.py",
                 "cli.py", "__main__.py", "utils/profiling.py", "utils/cuda_build.py", "utils/roofline.py",
                 "bench.py", "graft_entry.py",
                 *(f"ui/{m}.py" for m in ("theme", "playback", "run_worker", "dialogs", "viewers",
                                          "launch_dialog", "setup_editor", "main_app"))):
        assert _PORT / name in files, name
    bad = [
        (str(f.relative_to(_PORT.parent)), name)
        for f in files
        for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "qpsim_tpu", "orbax")
    ]
    assert bad == []
