"""Result and test-suite viewers (Tk shells over the playback module)."""

from __future__ import annotations

import tkinter as tk

import numpy as np
from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
from matplotlib.figure import Figure

from ..io.storage import frame_from_jsonable, load_test_geometry_group
from ..models.params import SimulationResultData, TestSuiteData
from .playback import PlaybackState, render_heatmap, render_line1d, render_timeseries
from .theme import FONT_TITLE, PALETTE

__all__ = ["SimulationViewer", "StreamViewer", "PhononViewer", "TestGeometryLanding"]

_PLAY_INTERVAL_MS = 120


class _PlaybackWindow(tk.Toplevel):
    """Shared scaffold: figure canvas + scrubber + play/pause."""

    def __init__(self, parent, title: str, num_frames: int):
        super().__init__(parent)
        self.title(title)
        self.configure(bg=PALETTE["face"])
        self.state_ = PlaybackState(num_frames=num_frames)
        self.figure = Figure(figsize=(6.4, 4.2), dpi=100)
        self.ax = self.figure.add_subplot(111)
        self.canvas = FigureCanvasTkAgg(self.figure, master=self)
        self.canvas.get_tk_widget().pack(fill="both", expand=True, padx=8, pady=8)
        bar = tk.Frame(self, bg=PALETTE["face"])
        bar.pack(fill="x", padx=8, pady=(0, 8))
        self.play_btn = tk.Button(bar, text="Play", width=8, command=self._toggle)
        self.play_btn.pack(side="left")
        self.scale = tk.Scale(
            bar,
            from_=0,
            to=max(0, num_frames - 1),
            orient="horizontal",
            command=self._on_seek,
            bg=PALETTE["face"],
        )
        self.scale.pack(side="left", fill="x", expand=True, padx=8)
        self._tick_scheduled = False

    def draw_frame(self, index: int) -> None:  # overridden
        raise NotImplementedError

    def _refresh(self):
        self.draw_frame(self.state_.index)
        self.canvas.draw_idle()

    def _toggle(self):
        playing = self.state_.toggle()
        self.play_btn.configure(text="Pause" if playing else "Play")
        if playing and not self._tick_scheduled:
            self._tick()

    def _tick(self):
        self._tick_scheduled = False
        if not self.state_.playing:
            return
        self.state_.step(1)
        self.scale.set(self.state_.index)
        self._refresh()
        self._tick_scheduled = True
        self.after(_PLAY_INTERVAL_MS, self._tick)

    def _on_seek(self, value):
        self.state_.seek(int(float(value)))
        self._refresh()


class SimulationViewer(_PlaybackWindow):
    """Energy-integrated heatmap playback of a saved/just-finished run."""

    def __init__(self, parent, result: SimulationResultData):
        frames = [frame_from_jsonable(f) for f in result.frames]
        super().__init__(parent, f"Simulation — {result.setup_name}", len(frames))
        self.frames = frames
        self.times = result.times
        self.clim = tuple(result.color_limits)
        self._refresh()

    def draw_frame(self, index: int) -> None:
        render_heatmap(
            self.ax,
            self.frames[index],
            clim=self.clim,
            title=f"t = {self.times[index]:.6g} ns",
        )


class StreamViewer(_PlaybackWindow):
    """Playback over a streamed-frames directory — one shard read per frame.

    Streams exist precisely because the full history does not fit in RAM
    (``run --stream-dir``, ``io/stream.py``), so this viewer never
    materializes it: ``reader.frame(index)`` decompresses only the
    requested snapshot's integrated frame (a small LRU smooths scrubbing).
    The reference has no streaming at all; its viewer loads every frame up
    front (the reference GUI's ``qpsim/ui/main_app.py:227-350``).
    """

    _CACHE_FRAMES = 32

    def __init__(self, parent, reader):
        name = str(reader.metadata.get("setup_name", reader.directory))
        super().__init__(parent, f"Streamed run — {name}", len(reader))
        self.reader = reader
        self.times = reader.times
        self.clim = tuple(reader.color_limits)
        self._cache: dict[int, np.ndarray] = {}
        self._refresh()

    def _frame(self, index: int) -> np.ndarray:
        if index in self._cache:
            # LRU: re-insertion moves the entry to the young end
            frame = self._cache.pop(index)
        else:
            if len(self._cache) >= self._CACHE_FRAMES:
                self._cache.pop(next(iter(self._cache)))
            frame = self.reader.frame(index)
        self._cache[index] = frame
        return frame

    def draw_frame(self, index: int) -> None:
        render_heatmap(
            self.ax,
            self._frame(index),
            clim=self.clim,
            title=f"t = {self.times[index]:.6g} ns",
        )


class PhononViewer(_PlaybackWindow):
    """Phonon field playback (integrated occupation or fixed-T map)."""

    def __init__(self, parent, result: SimulationResultData):
        frames = [frame_from_jsonable(f) for f in (result.phonon_frames or [])]
        super().__init__(parent, f"Phonons — {result.setup_name}", len(frames))
        self.frames = frames
        self.times = result.times
        meta = result.phonon_metadata or {}
        self.units = str(meta.get("field_units", ""))
        if frames:
            stack = np.stack(frames)
            lo, hi = float(np.nanmin(stack)), float(np.nanmax(stack))
            self.clim = (lo, hi if hi > lo else lo + 1e-9)
            self._refresh()

    def draw_frame(self, index: int) -> None:
        render_heatmap(
            self.ax,
            self.frames[index],
            clim=self.clim,
            title=f"t = {self.times[index]:.6g} ns [{self.units}]",
            cmap="viridis",
        )


class _CaseViewer(_PlaybackWindow):
    """One analytic test case (line1d / timeseries / heatmap2d)."""

    def __init__(self, parent, case):
        view_mode = str(case.metadata.get("view_mode", "line1d"))
        n = 1 if view_mode == "timeseries" else len(case.times)
        super().__init__(parent, case.title, n)
        self.case = case
        self.view_mode = view_mode
        self._refresh()

    def draw_frame(self, index: int) -> None:
        if self.view_mode == "timeseries":
            render_timeseries(self.ax, self.case)
        elif self.view_mode == "heatmap2d":
            sim = frame_from_jsonable(self.case.simulated[index])
            render_heatmap(
                self.ax, sim, title=f"{self.case.title} — t = {self.case.times[index]:.4g} ns"
            )
        else:
            render_line1d(self.ax, self.case, index)


class TestGeometryLanding(tk.Toplevel):
    """Suite browser: pick a geometry group (lazily loaded), then a case."""

    def __init__(self, parent, suite: TestSuiteData, manifest_path=None):
        super().__init__(parent)
        self.title("Analytic Test Suite")
        self.configure(bg=PALETTE["face"])
        self.suite = suite
        self.manifest_path = manifest_path
        tk.Label(self, text="Geometry groups", font=FONT_TITLE, bg=PALETTE["face"]).pack(
            anchor="w", padx=8, pady=(8, 0)
        )
        self.group_list = tk.Listbox(self, height=6)
        for g in suite.geometry_groups:
            self.group_list.insert("end", f"{g.title}  ({g.case_count} cases)")
        self.group_list.pack(fill="x", padx=8, pady=4)
        tk.Label(self, text="Cases", font=FONT_TITLE, bg=PALETTE["face"]).pack(
            anchor="w", padx=8
        )
        self.case_list = tk.Listbox(self, height=10)
        self.case_list.pack(fill="both", expand=True, padx=8, pady=4)
        self.group_list.bind("<<ListboxSelect>>", self._on_group)
        self.case_list.bind("<Double-Button-1>", self._open_case)
        tk.Button(self, text="Open case", command=self._open_case).pack(pady=(0, 8))
        self._current_cases = []

    def _on_group(self, _event=None):
        sel = self.group_list.curselection()
        if not sel:
            return
        group = self.suite.geometry_groups[sel[0]]
        if not group.cases and self.manifest_path is not None:
            group = load_test_geometry_group(self.manifest_path, group.geometry_id)
        self._current_cases = group.cases
        self.case_list.delete(0, "end")
        for case in group.cases:
            self.case_list.insert("end", case.title)

    def _open_case(self, _event=None):
        sel = self.case_list.curselection()
        if not sel or not self._current_cases:
            return
        _CaseViewer(self, self._current_cases[sel[0]])
