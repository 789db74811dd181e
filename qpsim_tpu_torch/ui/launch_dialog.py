"""Standalone simulation-launch dialog with a pre-run live preview.

Counterpart of the reference's dedicated launch flow
(``qpsim/ui/main_app.py:353-479``): before a run starts the
user reviews the initial quasiparticle and phonon fields side by side,
chooses whether to watch the simulation live, and presses Start; while the
run progresses the QP panel updates from the worker's live-frame queue and
the color limits only ever widen (no flicker from frame-local rescaling).
"""

from __future__ import annotations

import tkinter as tk
from typing import Callable

import numpy as np
from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
from matplotlib.figure import Figure

from .theme import PALETTE

__all__ = ["SimulationLaunchDialog"]


class SimulationLaunchDialog(tk.Toplevel):
    """Review initial fields, then start a simulation (optionally live).

    Parameters
    ----------
    parent:
        Owning Tk widget.
    setup_name:
        Shown in the window title.
    initial_qp_frame / initial_phonon_frame:
        Dense (ny, nx) fields (NaN outside the mask) previewed before launch.
    live_default:
        Initial state of the "view live" checkbox.
    on_start:
        ``on_start(live: bool)`` called when the user presses Start.
    """

    def __init__(
        self,
        parent: tk.Misc,
        setup_name: str,
        initial_qp_frame: np.ndarray,
        initial_phonon_frame: np.ndarray,
        *,
        live_default: bool = True,
        on_start: Callable[[bool], None],
    ):
        super().__init__(parent)
        self.title(f"Initialize Simulation - {setup_name}")
        self.configure(bg=PALETTE["face"])
        self._on_start = on_start
        self._closed = False
        self._running = False
        self._phonon_frame = np.array(initial_phonon_frame, dtype=float, copy=True)

        self.bind("<Escape>", lambda _e: self._handle_close())
        self.protocol("WM_DELETE_WINDOW", self._handle_close)

        top = tk.Frame(self, bg=PALETTE["face"])
        top.pack(fill="x", padx=10, pady=(8, 4))
        self.live_var = tk.BooleanVar(value=bool(live_default))
        tk.Checkbutton(
            top, text="View live simulation", variable=self.live_var,
            bg=PALETTE["face"], anchor="w",
        ).pack(side="left", padx=(0, 12))
        self.start_btn = tk.Button(
            top, text="Start simulation", width=18, command=self._start_pressed
        )
        self.start_btn.pack(side="left", padx=(0, 8))
        tk.Button(top, text="Close", width=12, command=self._handle_close).pack(side="left")
        self.time_label = tk.Label(top, text="t = 0.000 ns", bg=PALETTE["face"])
        self.time_label.pack(side="right", padx=8)

        self.status_var = tk.StringVar(value="Ready. Press Start simulation.")
        tk.Label(self, textvariable=self.status_var, bg=PALETTE["face"], anchor="w").pack(
            fill="x", padx=10, pady=(0, 6)
        )

        fig = Figure(figsize=(10.4, 5.2), dpi=100)
        self.ax_qp = fig.add_subplot(1, 2, 1)
        self.ax_ph = fig.add_subplot(1, 2, 2)
        self.canvas = FigureCanvasTkAgg(fig, master=self)
        self.canvas.get_tk_widget().pack(fill="both", expand=True, padx=10, pady=(0, 10))

        qp0 = np.array(initial_qp_frame, dtype=float, copy=True)
        self.qp_image = self.ax_qp.imshow(
            qp0, origin="lower", cmap="inferno", interpolation="nearest",
            vmin=self._limits(qp0)[0], vmax=self._limits(qp0)[1],
        )
        self.ph_image = self.ax_ph.imshow(
            self._phonon_frame, origin="lower", cmap="magma", interpolation="nearest",
            vmin=self._limits(self._phonon_frame)[0],
            vmax=self._limits(self._phonon_frame)[1],
        )
        self.ax_qp.set_title("quasiparticle density")
        self.ax_ph.set_title("phonon occupation")
        for ax in (self.ax_qp, self.ax_ph):
            ax.set_xlabel("x (mesh index)")
            ax.set_ylabel("y (mesh index)")
            ax.set_aspect("equal")
        fig.colorbar(self.qp_image, ax=self.ax_qp, fraction=0.046, pad=0.04)
        fig.colorbar(self.ph_image, ax=self.ax_ph, fraction=0.046, pad=0.04)
        self.canvas.draw_idle()

    # -- state -----------------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def _handle_close(self) -> None:
        self._closed = True
        if self.winfo_exists():
            self.destroy()

    def _start_pressed(self) -> None:
        if self._running:
            return
        self._on_start(bool(self.live_var.get()))

    def set_running(self, running: bool) -> None:
        self._running = bool(running)
        self.start_btn.configure(state=("disabled" if running else "normal"))
        if running:
            self.status_var.set("Simulation running…")
        elif "complete" not in self.status_var.get().lower():
            self.status_var.set("Ready. Press Start simulation.")

    def set_status(self, text: str) -> None:
        self.status_var.set(str(text))

    # -- live preview ----------------------------------------------------------

    def update_preview(self, time_ns: float, qp_frame: np.ndarray) -> None:
        """Show a live QP frame; color limits only widen, never shrink."""
        self.time_label.configure(text=f"t = {float(time_ns):.3f} ns")
        qp = np.asarray(qp_frame, dtype=float)
        self.qp_image.set_data(qp)
        self._widen_clim(self.qp_image, qp)
        self.canvas.draw_idle()

    @staticmethod
    def _limits(frame: np.ndarray) -> tuple[float, float]:
        arr = np.asarray(frame, dtype=float)
        finite = arr[np.isfinite(arr)]
        if finite.size == 0:
            return 0.0, 1e-9
        vmin, vmax = float(finite.min()), float(finite.max())
        if abs(vmax - vmin) < 1e-12:
            vmax = vmin + 1e-9
        return vmin, vmax

    @classmethod
    def _widen_clim(cls, image, frame: np.ndarray) -> None:
        vmin, vmax = cls._limits(frame)
        cur_vmin, cur_vmax = image.get_clim()
        if vmin < cur_vmin or vmax > cur_vmax:
            image.set_clim(min(cur_vmin, vmin), max(cur_vmax, vmax))
