"""The port's UI (``qpsim_tpu_torch.ui``) headlessly, on the CPU.

The flows of ``tests/test_ui.py`` on the port's modules: the Tk-free
playback logic and run worker directly, and the Tk widgets over the
``tests/tkstub.py`` substitute for tkinter (which purges and restores the
JAX package's UI modules; :func:`port_ui` does the same for the port's).
Every run goes to ``device="cpu"`` on a film small enough to finish in
seconds, and every wait is bounded.
"""

import importlib
import sys
import time
from contextlib import contextmanager

import numpy as np
import pytest

import tkstub
from qpsim_tpu_torch.fields import default_initial_condition
from qpsim_tpu_torch.geometry.mask import create_intrinsic_geometry
from qpsim_tpu_torch.models.params import (
    BoundaryCondition,
    ExternalGenerationSpec,
    PhotonDriveSpec,
    SetupData,
    SimulationParameters,
    TestCaseResultData,
    TestGeometryGroupData,
    TestSuiteData,
)
from qpsim_tpu_torch.runner import run_setup
from qpsim_tpu_torch.ui.playback import PlaybackState, render_heatmap, render_line1d, render_timeseries
from qpsim_tpu_torch.ui.run_worker import SimulationWorker

#: the longest a test waits for a worker (a run here takes well under a second)
WAIT_S = 60.0

_PORT_UI = tuple(f"qpsim_tpu_torch.ui.{m}" for m in (
    "theme", "playback", "run_worker", "dialogs", "viewers", "launch_dialog", "setup_editor", "main_app"))


@contextmanager
def port_ui():
    """(stub, modules): the port's UI modules imported afresh over the tkinter
    stub, and the previously imported ones restored afterwards."""
    with tkstub.installed() as stub:
        saved = {name: sys.modules.pop(name, None) for name in _PORT_UI}
        try:
            yield stub, {name.rsplit(".", 1)[1]: importlib.import_module(name) for name in _PORT_UI}
        finally:
            for name, mod in saved.items():
                sys.modules.pop(name, None)
                if mod is not None:
                    sys.modules[name] = mod


def _params(**extra):
    return SimulationParameters(
        diffusion_coefficient=6.0, dt=0.1, total_time=0.4, mesh_size=1.0,
        energy_gap=180.0, energy_max_factor=3.0, num_energy_bins=4,
        enable_recombination=True, enable_scattering=True, bath_temperature=0.2, **extra)


def _setup(width=14, height=10):
    geo = create_intrinsic_geometry(width=width, height=height)
    ic = default_initial_condition()
    ic.spatial_kind = "uniform"
    ic.spatial_params = {"value": 1e-4}
    return SetupData(
        setup_id="ui0000000001", name="worker test", created_at="now", geometry=geo,
        boundary_conditions={e.edge_id: BoundaryCondition(kind="reflective") for e in geo.edges},
        parameters=_params(), initial_condition=ic)


def _wait(worker):
    deadline = time.time() + WAIT_S
    frames, outcome = [], None
    while time.time() < deadline and outcome is None:
        frames.extend(worker.drain_live())
        outcome = worker.poll_result()
        time.sleep(0.02)
    frames.extend(worker.drain_live())
    assert outcome is not None, f"worker did not finish within {WAIT_S} s"
    return outcome, frames


def test_playback_state_loop_and_seek():
    st = PlaybackState(num_frames=5)
    assert st.step() == 1
    st.seek(4)
    assert st.step() == 0  # loops
    st.loop = False
    st.playing = True
    st.seek(3)
    st.step()
    assert st.index == 4 and not st.playing  # stops at the end
    assert st.seek(99) == 4
    assert st.toggle() is True


def test_render_functions_on_agg_backend(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib.figure import Figure

    fig = Figure()
    ax = fig.add_subplot(111)
    frame = np.full((4, 6), np.nan)
    frame[1:3, 1:5] = 1.0
    assert render_heatmap(ax, frame, clim=(0, 1), title="t").get_clim() == (0, 1)
    case = TestCaseResultData(
        case_id="c", title="T", boundary_label="b", formula_latex="f", initial_condition_latex="i",
        description="d", x=[0.5, 1.5, 2.5], times=[0.0, 0.1],
        simulated=[[1.0, 0.5, 0.2], [0.9, 0.45, 0.18]], analytic=[[1.0, 0.5, 0.2], [0.9, 0.45, 0.18]],
        metadata={"view_mode": "line1d"})
    render_line1d(ax, case, 1)
    ts_case = TestCaseResultData(
        case_id="c2", title="T2", boundary_label="b", formula_latex="f", initial_condition_latex="i",
        description="d", x=[0.0, 1.0, 2.0], times=[0.0], simulated=[[0.5, 0.4, 0.3]],
        analytic=[[0.5, 0.4, 0.31]], metadata={"view_mode": "timeseries"})
    render_timeseries(ax, ts_case)
    fig.savefig(tmp_path / "render.png")
    assert (tmp_path / "render.png").stat().st_size > 0


def test_simulation_worker_streams_and_completes_on_the_cpu():
    setup = _setup()
    worker = SimulationWorker(setup=setup, save=False, device="cpu")
    worker.start()
    (kind, payload), frames = _wait(worker)
    assert kind == "ok", payload
    result, path = payload
    assert path is None
    assert len(result.times) == 5
    assert len(frames) == 5  # t=0 plus 4 stored steps
    assert frames[0].time_ns == 0.0
    assert frames[-1].frame.shape == (10, 14)
    # the worker runs what run_setup runs
    direct, _ = run_setup(setup, save=False, device="cpu")
    assert result.times == direct.times
    np.testing.assert_array_equal(result.mass_over_time, direct.mass_over_time)
    with pytest.raises(RuntimeError):  # double-start protection
        worker.start()


@pytest.mark.parametrize("device,match", [("cpu", "boundary"), ("cuda", "cuda")])
def test_worker_surfaces_errors(device, match):
    """A missing boundary condition, and a card asked for where none is."""
    import torch

    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("a card is present: the run would not fail")
    geo = create_intrinsic_geometry(width=10, height=8)
    setup = SetupData(
        setup_id="ui0000000002", name="bad", created_at="now", geometry=geo,
        boundary_conditions={} if device == "cpu" else
        {e.edge_id: BoundaryCondition(kind="reflective") for e in geo.edges},
        parameters=SimulationParameters(diffusion_coefficient=6.0, dt=0.1, total_time=0.2, mesh_size=1.0),
        initial_condition=default_initial_condition())
    worker = SimulationWorker(setup=setup, save=False, device=device)
    worker.start()
    worker.join(WAIT_S)
    assert not worker.is_running(), f"worker did not finish within {WAIT_S} s"
    kind, payload = worker.result.get_nowait()
    assert kind == "error"
    assert match in str(payload).lower()


def _editor_with_geometry(ui, stub, width=14, height=10):
    root = stub.tk.Tk()
    editor = ui["setup_editor"].SetupEditor(root, device="cpu")
    geo = create_intrinsic_geometry(width=width, height=height)
    editor._set_geometry(geo)
    for e in geo.edges:
        editor.edge_conditions[e.edge_id] = BoundaryCondition(kind="reflective")
    editor.parameters = _params(export_phonon_history=True)
    return root, editor


def test_headless_main_app_and_material_reference():
    with port_ui() as (stub, ui):
        app = ui["main_app"].QuasiparticleMainApp(device="cpu")
        assert "Quasiparticle" in app.title() and "cpu" in app.title()
        tkstub.find_button(app, "Material reference…").invoke()
        trees = tkstub.find_widgets(app, stub.ttk.Treeview)
        assert trees, "material table not built"
        rows = trees[-1].get_children()
        assert len(rows) >= 6  # Al, Nb, Ta, Sn, NbN, TiN
        trees[-1].selection_set(rows[0])  # fires <<TreeviewSelect>>
        assert any("References" in t.get() for t in tkstub.find_widgets(app, stub.tk.Text))
        # the setup editor opens from the start menu, on the app's device
        tkstub.find_button(app, "New / edit setup…").invoke()
        editors = [w for w in tkstub.walk(app) if type(w).__name__ == "SetupEditor"]
        assert editors and editors[0].device == "cpu"
        app.destroy()
        assert not app.winfo_exists()


def test_headless_main_app_runs_the_suites_on_its_device(monkeypatch):
    """"Run physics validation" and "Generate analytic test suite" pass the
    app's device to the port's suites (stubbed here: each takes seconds)."""
    from qpsim_tpu_torch import testcases, validation

    calls = []

    class Report:
        overall_passed = True

    monkeypatch.setattr(validation, "run_fast_validation_suite",
                        lambda **kw: calls.append(("validate", kw)) or Report())
    monkeypatch.setattr(testcases.generator, "generate_and_save_test_suite",
                        lambda **kw: calls.append(("gen-tests", kw)) or (None, "suite.json"))
    with port_ui() as (stub, ui):
        app = ui["main_app"].QuasiparticleMainApp(device="cpu")
        for label, text in (("Run physics validation", "Validation: PASS"),
                            ("Generate analytic test suite", "Test suite saved: suite.json")):
            tkstub.find_button(app, label).invoke()
            deadline = time.time() + WAIT_S
            while text not in app.status.options["text"] and time.time() < deadline:
                stub.pump()
                time.sleep(0.02)
            assert text in app.status.options["text"]
        app.destroy()
    assert calls == [("validate", {"device": "cpu"}), ("gen-tests", {"device": "cpu"})]


def test_headless_dialog_accept_flows():
    with port_ui() as (stub, ui):
        dialogs = ui["dialogs"]
        root = stub.tk.Tk()

        def entries(win):
            return [e for e in tkstub.find_widgets(win, stub.tk.Entry)
                    if not isinstance(e, stub.ttk.Combobox)]

        def fill_bc(win):
            tkstub.find_widgets(win, stub.ttk.Combobox)[0].set("dirichlet")
            entries(win)[0].delete(0, "end")
            entries(win)[0].insert(0, "0.25")
            tkstub.find_button(win, "OK").invoke()

        stub.on_next_modal(fill_bc)
        bc = dialogs.ask_boundary_condition(root, None)
        assert bc is not None and bc.kind == "dirichlet" and bc.value == 0.25
        stub.on_next_modal(lambda win: tkstub.find_button(win, "Cancel").invoke())
        assert dialogs.ask_boundary_condition(root, None) is None

        def fill_bad(win):
            tkstub.find_widgets(win, stub.ttk.Combobox)[0].set("robin")  # robin needs a value
            tkstub.find_button(win, "OK").invoke()
            assert stub.messagebox.showerror.calls, "validation error not surfaced"
            tkstub.find_button(win, "Cancel").invoke()

        stub.on_next_modal(fill_bad)
        assert dialogs.ask_boundary_condition(root, None) is None

        def fill_gen(win):
            tkstub.find_widgets(win, stub.ttk.Combobox)[0].set("constant")
            entries(win)[0].delete(0, "end")
            entries(win)[0].insert(0, "1e-5")
            tkstub.find_button(win, "OK").invoke()

        stub.on_next_modal(fill_gen)
        spec = dialogs.ask_external_generation(root, ExternalGenerationSpec())
        assert spec is not None and spec.normalized_mode() == "constant" and spec.rate == 1e-5

        stub.on_next_modal(lambda win: tkstub.find_button(win, "OK").invoke())
        ic = dialogs.ask_initial_condition(root, default_initial_condition())
        assert ic is not None and ic.spatial_kind == default_initial_condition().spatial_kind

        def fill_photon(win):
            tkstub.find_widgets(win, stub.ttk.Combobox)[0].set("photon")
            for entry, value in zip(entries(win), ("450.0", "2.0", "1e-4")):
                entry.delete(0, "end")
                entry.insert(0, value)
            tkstub.find_button(win, "OK").invoke()

        stub.on_next_modal(fill_photon)
        drive = dialogs.ask_photon_drive(root, PhotonDriveSpec())
        assert drive is not None and drive.enabled
        assert (drive.photon_energy, drive.occupancy, drive.coupling) == (450.0, 2.0, 1e-4)
        assert drive.window_start is None


def test_headless_editor_photon_drive_single_and_multi_tone():
    with port_ui() as (stub, ui):
        _, editor = _editor_with_geometry(ui, stub)

        def fill_photon(win):
            tkstub.find_widgets(win, stub.ttk.Combobox)[0].set("photon")
            entries = [e for e in tkstub.find_widgets(win, stub.tk.Entry)
                       if not isinstance(e, stub.ttk.Combobox)]
            for entry, value in zip(entries, ("470.0", "1.0", "2e-4")):
                entry.delete(0, "end")
                entry.insert(0, value)
            tkstub.find_button(win, "OK").invoke()

        stub.on_next_modal(fill_photon)
        editor.edit_photon_drive()
        drive = editor.parameters.photon_drive
        assert isinstance(drive, PhotonDriveSpec) and drive.photon_energy == 470.0
        second = PhotonDriveSpec(mode="photon", photon_energy=500.0, occupancy=3.0, coupling=5e-5)
        editor.parameters.photon_drive = [drive, second]
        stub.on_next_modal(fill_photon)
        editor.edit_photon_drive()
        drive2 = editor.parameters.photon_drive
        assert isinstance(drive2, list) and len(drive2) == 2
        assert drive2[0].photon_energy == 470.0 and drive2[1] == second


def test_headless_setup_editor_parameter_dialog():
    with port_ui() as (stub, ui):
        _, editor = _editor_with_geometry(ui, stub)
        editor.edit_parameters()  # non-modal Toplevel
        win = [w for w in tkstub.walk(editor) if isinstance(w, stub.tk.Toplevel)][-1]
        dt_entry = tkstub.find_widgets(win, stub.tk.Entry)[1]  # field order: D0, dt, ...
        dt_entry.delete(0, "end")
        dt_entry.insert(0, "0.2")
        tkstub.find_button(win, "OK").invoke()
        assert editor.parameters.dt == 0.2
        assert not win.winfo_exists()


def test_headless_launch_dialog_behavior():
    with port_ui() as (stub, ui):
        root = stub.tk.Tk()
        qp = np.full((6, 8), np.nan)
        qp[1:5, 1:7] = 1e-4
        ph = np.where(np.isfinite(qp), 0.3, np.nan)
        started = []
        dlg = ui["launch_dialog"].SimulationLaunchDialog(root, "demo", qp, ph, live_default=True,
                                                        on_start=started.append)
        assert "demo" in dlg.title()
        dlg.live_var.set(False)
        dlg.start_btn.invoke()
        assert started == [False]
        dlg.set_running(True)
        assert dlg.start_btn.options["state"] == "disabled"
        dlg.start_btn.invoke()  # disabled + running: must not re-fire
        assert started == [False]
        lo0, _ = dlg.qp_image.get_clim()
        dlg.update_preview(1.25, np.where(np.isfinite(qp), 5e-4, np.nan))
        assert "1.250" in dlg.time_label.options["text"]
        lo1, hi1 = dlg.qp_image.get_clim()
        assert hi1 >= 5e-4 and lo1 <= lo0
        dlg.update_preview(2.5, np.where(np.isfinite(qp), 2e-4, np.nan))
        assert dlg.qp_image.get_clim() == (lo1, hi1)  # never shrinks
        dlg.set_status("Simulation complete.")
        dlg.set_running(False)
        assert "complete" in dlg.status_var.get().lower()
        dlg._handle_close()
        assert dlg.closed


def test_headless_full_gui_run_flow(tmp_path, monkeypatch):
    """Start to finish on the CPU: editor → launch dialog → worker → viewers."""
    from qpsim_tpu_torch.io import storage as storage_mod

    monkeypatch.setattr(storage_mod, "SIMULATIONS_DIR", tmp_path)
    monkeypatch.setattr(storage_mod, "ensure_data_dirs", lambda: None)
    with port_ui() as (stub, ui):
        _, editor = _editor_with_geometry(ui, stub)
        editor.run_simulation()
        dlg = editor._launch_dialog
        assert dlg is not None and not dlg.closed
        assert np.isfinite(np.asarray(dlg.qp_image.get_array(), dtype=float)).any()
        tkstub.find_button(dlg, "Start simulation").invoke()
        assert editor._worker is not None and editor._worker.device == "cpu"
        deadline = time.time() + WAIT_S
        while time.time() < deadline and "Done" not in editor.status.options["text"]:
            stub.pump()
            time.sleep(0.02)
        stub.pump(rounds=3)  # drain any trailing poll callbacks
        assert "Done" in editor.status.options["text"], editor.status.options["text"]
        assert str(tmp_path) in editor.status.options["text"]  # saved
        assert "complete" in dlg.status_var.get().lower()
        assert dlg.start_btn.options["state"] == "normal"
        # the last stored frame reached the dialog, however fast the run was
        assert dlg.time_label.options["text"] == "t = 0.400 ns", dlg.time_label.options["text"]
        viewers = [w for w in tkstub.walk(editor) if type(w).__name__ == "SimulationViewer"]
        assert viewers, "SimulationViewer not opened on completion"
        assert [w for w in tkstub.walk(editor) if type(w).__name__ == "PhononViewer"]
        viewers[0]._toggle()
        stub.pump(rounds=2)
        assert viewers[0].state_.index > 0


def test_headless_test_suite_landing_and_case_viewer():
    case = TestCaseResultData(
        case_id="c", title="decay", boundary_label="b", formula_latex="f", initial_condition_latex="i",
        description="d", x=[0.5, 1.5, 2.5], times=[0.0, 0.1],
        simulated=[[1.0, 0.5, 0.2], [0.9, 0.45, 0.18]], analytic=[[1.0, 0.5, 0.2], [0.9, 0.45, 0.18]],
        metadata={"view_mode": "line1d"})
    group = TestGeometryGroupData(geometry_id="g1", title="1D line", description="", view_mode="line1d",
                                  preview_mask=[[1, 1, 1]], cases=[case], case_count=1)
    suite = TestSuiteData(suite_id="s1", created_at="now", geometry_groups=[group])
    with port_ui() as (stub, ui):
        landing = ui["viewers"].TestGeometryLanding(stub.tk.Tk(), suite)
        assert landing.group_list.size() == 1
        landing.group_list.selection_set(0)
        landing._on_group()
        assert landing.case_list.size() == 1
        landing.case_list.selection_set(0)
        landing._open_case()
        assert [w for w in tkstub.walk(landing) if type(w).__name__ == "_CaseViewer"]


def test_headless_gap_map_editor():
    with port_ui() as (stub, ui):
        _, editor = _editor_with_geometry(ui, stub)
        editor.edit_gap_map()
        win = [w for w in tkstub.walk(editor) if isinstance(w, stub.tk.Toplevel)][-1]
        text = tkstub.find_widgets(win, stub.tk.Text)[0]
        tkstub.find_button(win, "Preview").invoke()
        assert "gap map" in editor.ax.get_title()
        text.delete("1.0", "end")
        text.insert("1.0", "return __import__('os')")
        n_err = len(stub.messagebox.showerror.calls)
        tkstub.find_button(win, "Apply").invoke()
        assert len(stub.messagebox.showerror.calls) == n_err + 1 and win.winfo_exists()
        text.delete("1.0", "end")
        text.insert("1.0", "return 160.0 + 30.0 * x")
        tkstub.find_button(win, "Apply").invoke()
        assert editor.parameters.gap_expression == "return 160.0 + 30.0 * x"
        assert not win.winfo_exists()
        editor.edit_gap_map()
        win2 = [w for w in tkstub.walk(editor) if isinstance(w, stub.tk.Toplevel)][-1]
        tkstub.find_button(win2, "Use constant only").invoke()
        assert editor.parameters.gap_expression == ""


def test_headless_stream_viewer(tmp_path):
    from qpsim_tpu_torch.io.stream import FrameStreamWriter, load_frame_stream

    with FrameStreamWriter(tmp_path / "stream") as w:
        for i in range(5):
            frame = np.full((4, 6), np.nan)
            frame[1:3, 1:5] = float(i + 1)
            w.write(i, 0.1 * i, frame=frame, mass=float(i + 1))
    reader = load_frame_stream(tmp_path / "stream")
    reads: list[int] = []
    real_frame = type(reader).frame
    reader.frame = lambda idx, _r=reader: (reads.append(idx), real_frame(_r, idx))[1]
    with port_ui() as (stub, ui):
        viewer = ui["viewers"].StreamViewer(None, reader)
        assert "Streamed run" in viewer.title()
        assert reads == [0]  # only the first frame loaded at construction
        viewer._on_seek(3)
        assert reads == [0, 3]
        viewer._on_seek(0)  # cached: no new read
        assert reads == [0, 3]
        viewer._CACHE_FRAMES = 2
        viewer._on_seek(4)
        viewer._on_seek(3)
        assert np.nanmax(viewer._frame(4)) == 5.0
        app = ui["main_app"].QuasiparticleMainApp(device="cpu")
        stub.filedialog.askdirectory = lambda **kw: str(tmp_path / "stream")
        tkstub.find_button(app, "View streamed run…").invoke()
        assert [w for w in tkstub.walk(app) if type(w).__name__ == "StreamViewer"]
        app.destroy()
