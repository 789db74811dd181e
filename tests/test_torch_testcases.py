"""The port's analytic test-case generator against ``qpsim_tpu``'s, float64 on the CPU.

Each of the five groups is built by both packages at the sizes
``tests/test_testcases.py`` uses: the case ids are equal, the closed forms
(host numpy/scipy in both) bit-equal, and the simulated arrays agree to
1e-10 of each case's largest value (several cases decay through zero, so
the comparison is scaled).  The port's groups then meet the accuracy
gates of ``tests/test_testcases.py`` themselves, and a suite of them
round-trips through both packages' files.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from qpsim_tpu.io import storage as j_storage  # noqa: E402
from qpsim_tpu.testcases import generator as J  # noqa: E402

from qpsim_tpu_torch.io import storage as t_storage  # noqa: E402
from qpsim_tpu_torch.testcases import generator as G  # noqa: E402

GROUPS = {
    "strip_1d_effective": ("_strip_group", dict(nx=64, dx=1.0, D=25.0, dt=0.05, total_time=2.0, store_every=4)),
    "rectangle_2d": ("_rectangle_group", dict(dx=1.0, D=25.0, dt=0.05, total_time=0.5, store_every=5)),
    "polygon_donut": ("_donut_group", dict(dx=1.0, D=25.0, dt=0.05, total_time=1.0, store_every=10)),
    "recombination": ("_recombination_group", {}),
    "scattering": ("_scattering_group", {}),
}


@pytest.fixture(scope="module")
def groups():
    built = {}
    for gid, (fn, kw) in GROUPS.items():
        built[gid] = (getattr(J, fn)(**kw), getattr(G, fn)(**kw, device="cpu"))
    return built


def _arrays(values):
    return np.asarray([[np.nan if v is None else v for v in np.ravel(np.asarray(x, dtype=object))]
                       for x in values], dtype=np.float64)


@pytest.mark.parametrize("gid", list(GROUPS))
def test_group_matches_the_jax_package(groups, gid):
    jax_group, port_group = groups[gid]
    assert port_group.geometry_id == jax_group.geometry_id == gid
    assert [c.case_id for c in port_group.cases] == [c.case_id for c in jax_group.cases]
    assert port_group.preview_mask == jax_group.preview_mask
    assert (port_group.title, port_group.view_mode) == (jax_group.title, jax_group.view_mode)
    for pc, jc in zip(port_group.cases, jax_group.cases):
        assert (pc.times, pc.x) == (jc.times, jc.x)
        assert pc.metadata == jc.metadata
        assert pc.formula_latex == jc.formula_latex
        np.testing.assert_array_equal(_arrays(pc.analytic), _arrays(jc.analytic))  # bit-equal
        sim_p, sim_j = _arrays(pc.simulated), _arrays(jc.simulated)
        np.testing.assert_array_equal(np.isnan(sim_p), np.isnan(sim_j))
        scale = np.nanmax(np.abs(sim_j))
        np.testing.assert_allclose(np.nan_to_num(sim_p), np.nan_to_num(sim_j), rtol=0, atol=1e-10 * scale,
                                   err_msg=pc.case_id)


def _rel_err(sim, ana):
    sim, ana = np.asarray(sim, dtype=np.float64), np.asarray(ana, dtype=np.float64)
    return float(np.max(np.abs(sim - ana))) / max(1e-12, float(np.max(np.abs(ana))))


@pytest.mark.parametrize("gid", list(GROUPS))
def test_port_group_meets_the_accuracy_gates(groups, gid):
    """The tolerances of ``tests/test_testcases.py``, on the port's groups."""
    cases = groups[gid][1].cases
    if gid == "strip_1d_effective":
        assert len(cases) == 10
        for case in cases:
            assert _rel_err(case.simulated, case.analytic) < 2e-2, case.case_id
    elif gid == "rectangle_2d":
        assert len(cases) == 9
        for case in cases:
            sim, ana = _arrays(case.simulated[-1:]), _arrays(case.analytic[-1:])
            assert _rel_err(sim, ana) < 2e-2, case.case_id
    elif gid == "polygon_donut":
        assert len(cases) == 4
        for case in cases:
            sim, ana = _arrays(case.simulated[-1:]), _arrays(case.analytic[-1:])
            m = np.isfinite(ana)
            assert _rel_err(sim[m], ana[m]) < 0.2, case.case_id
    elif gid == "recombination":
        for case, tol in zip(cases, (0.3, 1e-4, 0.3)):
            sim, ana = np.asarray(case.simulated[0]), np.asarray(case.analytic[0])
            assert _rel_err(sim, ana) < tol, case.case_id
            k = max(2, len(sim) // 20)
            early = np.max(np.abs(sim[:k] - ana[:k])) / max(1e-12, np.max(np.abs(ana)))
            assert early < 0.02, case.case_id
    else:
        for case, tol in zip(cases, (0.05, 1e-3)):
            assert _rel_err(case.simulated[0], case.analytic[0]) < tol, case.case_id


def test_suite_assembles_and_crosses_both_packages_files(groups, tmp_path, monkeypatch):
    for gid, (fn, _) in GROUPS.items():
        monkeypatch.setattr(G, fn, lambda *a, _g=groups[gid][1], **k: _g)
    suite = G.generate_test_suite(device="cpu")
    assert [g.geometry_id for g in suite.geometry_groups] == list(GROUPS)
    assert sum(len(g.cases) for g in suite.geometry_groups) == 28
    assert suite.metadata == {"format_version": t_storage.TEST_SUITE_FORMAT_VERSION}
    path = t_storage.save_test_suite(suite, tmp_path / "suite.json")
    for load in (t_storage.load_test_suite, j_storage.load_test_suite):
        loaded = load(path)
        assert len(loaded.cases) == 28
        assert [c.case_id for c in loaded.cases] == [c.case_id for g in suite.geometry_groups for c in g.cases]


@pytest.mark.parametrize("kw", [dict(nx=4), dict(dx=0.5)], ids=["nx", "dx"])
def test_generate_test_suite_refuses_what_the_jax_package_refuses(kw):
    with pytest.raises(ValueError) as jax_err:
        J.generate_test_suite(**kw)
    with pytest.raises(ValueError) as port_err:
        G.generate_test_suite(**kw, device="cpu")
    assert str(port_err.value) == str(jax_err.value)


def test_annulus_eigenvalues_are_the_jax_packages():
    for inner, outer in (("dirichlet", "dirichlet"), ("dirichlet", "reflective"),
                         ("reflective", "dirichlet"), ("reflective", "reflective")):
        assert G._annulus_eigenvalue(12.0, 27.0, 1, inner, outer) == J._annulus_eigenvalue(
            12.0, 27.0, 1, inner, outer)
