"""The port's host layer for chip layouts against ``qpsim_tpu``, on the CPU.

Bit-equal (``np.array_equal``) to the JAX package: the materials table,
the polygon raster, the mask helpers (components, segment distance, the
polygon tracer), and the GDS reader, writer and rasterizer — the last
both through the C++ rasterizer (``native/gds_raster.cpp``, which the
port compiles into its own build directory) and through the numpy
winding-number fallback.  The torch expression backend agrees with the
JAX backend to 1e-14 on a generated corpus.
"""

import dataclasses
import struct

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from qpsim_tpu.expr.safe_eval import JNP_BACKEND_FUNCTIONS as J_FUNCS  # noqa: E402
from qpsim_tpu.expr.safe_eval import compile_safe_expression as j_compile  # noqa: E402
from qpsim_tpu.geometry import gds as jg  # noqa: E402
from qpsim_tpu.geometry import mask as jm  # noqa: E402
from qpsim_tpu.geometry import raster as jr  # noqa: E402
from qpsim_tpu.models import materials as jmat  # noqa: E402

from qpsim_tpu_torch.expr.safe_eval import JNP_BACKEND_FUNCTIONS as T_FUNCS  # noqa: E402
from qpsim_tpu_torch.expr.safe_eval import ExpressionError, compile_safe_expression  # noqa: E402
from qpsim_tpu_torch.geometry import gds as tg  # noqa: E402
from qpsim_tpu_torch.geometry import mask as tm  # noqa: E402
from qpsim_tpu_torch.geometry import raster as tr  # noqa: E402
from qpsim_tpu_torch.models import materials as tmat  # noqa: E402


def _rect(x0, y0, w, h, ccw=True):
    pts = np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h], [x0, y0 + h]], dtype=float)
    return pts if ccw else pts[::-1]


def test_materials_table_is_the_same():
    assert [dataclasses.asdict(m) for m in tmat.material_reference_table()] == [
        dataclasses.asdict(m) for m in jmat.material_reference_table()]
    for m in jmat.material_reference_table():
        assert dataclasses.asdict(tmat.lookup_material(m.key)) == dataclasses.asdict(m)
    with pytest.raises(KeyError) as a:
        jmat.lookup_material("unobtainium")
    with pytest.raises(KeyError) as b:
        tmat.lookup_material("unobtainium")
    assert str(b.value) == str(a.value)


def test_raster_primitives_are_bit_equal():
    rng = np.random.default_rng(0)
    angles = np.sort(rng.uniform(0, 2 * np.pi, 11))
    poly = np.column_stack([5 + 4 * np.cos(angles), 4 + 3 * np.sin(angles)])
    pts = rng.uniform(-1, 11, (500, 2))
    assert tr.polygon_signed_area(poly) == jr.polygon_signed_area(poly)
    assert np.array_equal(tr.winding_numbers(poly, pts), jr.winding_numbers(poly, pts))
    assert np.array_equal(tr.points_in_polygon(poly, pts), jr.points_in_polygon(poly, pts))
    polys = [_rect(0, 0, 16, 16), _rect(5, 5, 6, 6, ccw=False), poly]
    xc, yc = np.arange(20) - 1.0, np.arange(18) - 1.0
    assert np.array_equal(tr.rasterize_polygons(polys, xc, yc), jr.rasterize_polygons(polys, xc, yc))


def test_mask_helpers_are_bit_equal():
    rng = np.random.default_rng(3)
    for trial in range(4):
        mask = rng.random((12, 18)) > 0.45
        mask[5:8, 6:12] = True
        mask[6, 8:10] = False  # a hole
        assert tm.connected_component_count(mask) == jm.connected_component_count(mask)
        a, b = jm.mask_to_polygons(mask, 0.5, (1.0, -2.0)), tm.mask_to_polygons(mask, 0.5, (1.0, -2.0))
        assert len(a) == len(b) and all(np.array_equal(p, q) for p, q in zip(a, b))
    geo = jm.create_intrinsic_geometry(width=16, height=12)
    for e in geo.edges:
        for px, py in rng.uniform(-2, 18, (5, 2)):
            assert tm.point_to_segment_distance(px, py, e) == jm.point_to_segment_distance(px, py, e)


def _mkid(path, writer):
    """A pad, a meander PATH and an SREF'd finger, one connected film."""
    meander = np.array([[10.0, 4.0], [30.0, 4.0], [30.0, 10.0], [12.0, 10.0], [12.0, 16.0], [30.0, 16.0]])
    return writer(path, {
        "FINGER": [(1, _rect(0, 0, 3, 8))],
        "TOP": [(1, _rect(0, 0, 10, 20)), (1, meander, 2.0), (1, meander + [0.0, 20.0], 1.5, 2),
                (2, _rect(2, 2, 3, 3))],
    })


def _with_sref(path):
    """Append an SREF of FINGER into TOP: rewrite the file with one more element."""
    data = bytearray(path.read_bytes())
    # the TOP cell's ENDSTR is the last but one record (ENDLIB last)
    endstr = data.rfind(struct.pack(">HBB", 4, 0x07, 0))
    ref = (jg._record(0x0A, 0) + jg._ascii_record(0x12, "FINGER")
           + jg._record(0x10, 3, np.rint(np.array([[28.0, 16.0]]) / 1e-3).astype(">i4").tobytes())
           + jg._record(0x11, 0))
    path.write_bytes(bytes(data[:endstr] + ref + data[endstr:]))
    return path


@pytest.mark.parametrize("rasterizer", ["native", "numpy"])
def test_gds_pipeline_is_bit_equal(tmp_path, monkeypatch, rasterizer):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    pj = _with_sref(_mkid(tmp_path / "j" / "chip.gds", jg.write_gds))
    pt = _with_sref(_mkid(tmp_path / "t" / "chip.gds", tg.write_gds))
    assert pt.read_bytes() == pj.read_bytes()  # the writers agree byte for byte
    lj, lt = jg.read_gds_library(pj), tg.read_gds_library(pt)
    assert sorted(lt.cells) == sorted(lj.cells) == ["FINGER", "TOP"]
    assert [c.name for c in lt.top_level()] == [c.name for c in lj.top_level()] == ["TOP"]
    for inc in (True, False):
        a, b = jg.read_gds_polygons(pj, include_paths=inc), tg.read_gds_polygons(pt, include_paths=inc)
        assert [p.layer for p in b] == [p.layer for p in a]
        assert all(np.array_equal(q.points, p.points) for p, q in zip(a, b))
    assert tg.discover_gds_layers(pt) == jg.discover_gds_layers(pj) == [1, 2]
    if rasterizer == "numpy":  # the port's fallback, where no compiler is present
        monkeypatch.setattr(tg, "_native_checked", True)
        monkeypatch.setattr(tg, "_native_lib", None)
    else:
        assert tg.native_raster_available(), "g++ is on the test machine: the native path must build"
        path = tg.native_library_path()
        assert path.parent.name == "qpsim_tpu_torch" and path.parent.parent.name == "build"
    for mesh in (0.5, 0.37):
        mj, bj = jg.rasterize_gds_layer(pj, 1, mesh)
        mt, bt = tg.rasterize_gds_layer(pt, 1, mesh)
        assert np.array_equal(mt, mj) and bt == bj
    gj, gt = jg.create_geometry_from_gds(pj, 1, 0.5), tg.create_geometry_from_gds(pt, 1, 0.5)
    assert gt.mask == gj.mask and gt.bounds == gj.bounds and gt.name == gj.name
    assert [dataclasses.asdict(e) for e in gt.edges] == [dataclasses.asdict(e) for e in gj.edges]


def test_gds_errors_match(tmp_path):
    for mod in (jg, tg):
        mod.write_gds(tmp_path / f"two_{mod.__name__}.gds",
                      {"TOP": [(1, _rect(0, 0, 5, 5)), (1, _rect(20, 20, 5, 5))]})
    msgs = []
    for mod in (jg, tg):
        with pytest.raises(ValueError) as info:
            mod.create_geometry_from_gds(tmp_path / f"two_{mod.__name__}.gds", 1, 1.0)
        msgs.append(str(info.value))
        with pytest.raises(ValueError, match="No polygons"):
            mod.rasterize_gds_layer(tmp_path / f"two_{mod.__name__}.gds", 7, 1.0)
    assert msgs[0] == msgs[1]
    (tmp_path / "bad.gds").write_bytes(b"\x00\x04\x05\x02")  # no HEADER record
    msgs = []
    for mod in (jg, tg):
        with pytest.raises(ValueError) as info:
            mod.read_gds_library(tmp_path / "bad.gds")
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------------ expressions


def test_torch_backend_names():
    assert T_FUNCS == J_FUNCS
    fx = compile_safe_expression("np.exp(x)", variable_names=("x",), backend="jax")
    assert torch.equal(fx(x=torch.tensor([0.5])), torch.exp(torch.tensor([0.5])))
    with pytest.raises(ExpressionError):
        compile_safe_expression("x", variable_names=("x",), backend="cupy")


def _corpus(n):
    import random

    rng = random.Random(0)
    unary = ["np.sqrt", "np.exp", "np.sin", "np.cos", "np.tanh", "np.abs", "np.log", "abs",
             "np.arctan", "np.cosh", "np.log10"]

    def leaf():
        return rng.choice(["x", "y", "t", str(round(rng.uniform(0.1, 3.0), 3)), "np.pi", "np.e"])

    def expr(depth):
        if depth == 0:
            return leaf()
        k = rng.randrange(6)
        if k == 0:
            return f"{rng.choice(unary)}(np.abs({expr(depth - 1)}) + 0.1)"
        if k == 1:
            op = rng.choice(["+", "-", "*", "/", "**"])
            a, b = expr(depth - 1), expr(depth - 1)
            if op == "**":
                return f"(np.abs({a}) + 0.1) ** 1.5"
            if op == "/":
                return f"({a}) / (np.abs({b}) + 0.5)"
            return f"({a}) {op} ({b})"
        if k == 2:
            return f"np.where(({expr(depth - 1)}) > 0.5, {expr(depth - 1)}, {expr(depth - 1)})"
        if k == 3:
            return f"np.clip({expr(depth - 1)}, 0.2, 2.0) + np.maximum({expr(depth - 1)}, 0.3)"
        if k == 4:
            return f"np.minimum(np.power(np.abs({expr(depth - 1)}) + 0.1, 0.5), 3.0)"
        return expr(depth - 1)

    return [expr(3) for _ in range(n)]


@pytest.mark.parametrize("chunk", range(4))
def test_torch_backend_matches_the_jax_backend(chunk):
    x = np.linspace(0.05, 1.0, 7)[None, :]
    y = np.linspace(0.1, 0.9, 3)[:, None]
    for body in _corpus(40)[chunk * 10:(chunk + 1) * 10]:
        names = ("x", "y", "t")
        a = np.asarray(j_compile(body, variable_names=names, backend="jax")(
            x=jnp.asarray(x), y=jnp.asarray(y), t=jnp.asarray(0.7)))
        b = compile_safe_expression(body, variable_names=names, backend="torch")(
            x=torch.tensor(x), y=torch.tensor(y), t=torch.tensor(0.7, dtype=torch.float64))
        b = np.asarray(b.numpy() if isinstance(b, torch.Tensor) else b, dtype=np.float64)
        a, b = np.broadcast_arrays(a, b)
        np.testing.assert_allclose(b, a, rtol=1e-14, atol=1e-14, err_msg=body)


def test_torch_backend_keeps_the_state_dtype_and_device():
    fn = compile_safe_expression("np.where(x > 0.5, 1.0, 0.1) * np.exp(2.0) + x.size",
                                 variable_names=("x",), backend="torch")
    out = fn(x=torch.linspace(0, 1, 5, dtype=torch.float32))
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    ref = np.where(np.linspace(0, 1, 5) > 0.5, 1.0, 0.1) * np.exp(2.0) + 5
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
