"""Setup editor: geometry, per-edge boundary conditions, parameters, run.

The reference's central workflow (qpsim/ui/main_app.py:1023-2144): import or
create a geometry, hover/click edges to assign boundary conditions, edit
material & simulation parameters, define initial conditions and generation,
save the setup, precompute caches, and launch a threaded simulation with a
live preview.  Port of ``qpsim_tpu.ui.setup_editor``: runs go to the
port's runner on the editor's ``device``.
"""

from __future__ import annotations

import tkinter as tk
from pathlib import Path
from tkinter import filedialog, messagebox, simpledialog

import numpy as np
from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
from matplotlib.figure import Figure

from ..fields import default_initial_condition
from ..geometry.gds import create_geometry_from_gds, discover_gds_layers
from ..geometry.mask import create_intrinsic_geometry, mask_from_lists, point_to_segment_distance
from ..io.precompute import precompute_arrays
from ..io.storage import create_setup_id, save_precomputed, save_setup
from ..models.params import (
    BoundaryCondition,
    SetupData,
    SimulationParameters,
    utc_now_iso,
)
from .dialogs import (
    ask_boundary_condition,
    ask_external_generation,
    ask_photon_drive,
    ask_initial_condition,
    show_material_reference,
)
from .run_worker import SimulationWorker
from .theme import PALETTE
from .viewers import PhononViewer, SimulationViewer

__all__ = ["SetupEditor"]

_POLL_MS = 150
_EDGE_PICK_RADIUS = 1.5


class SetupEditor(tk.Toplevel):
    def __init__(self, parent, device: str = "cuda"):
        super().__init__(parent)
        self.device = device
        self.title("Setup Editor")
        self.configure(bg=PALETTE["face"])
        self.geometry_data = None
        self.mask = None
        self.edge_conditions: dict[str, BoundaryCondition] = {}
        self.initial_condition = default_initial_condition()
        self.parameters = SimulationParameters(
            diffusion_coefficient=6.0, dt=0.05, total_time=10.0, mesh_size=1.0,
            energy_gap=180.0, energy_max_factor=4.0, num_energy_bins=16,
            enable_recombination=True, enable_scattering=True,
        )
        self.setup_name = "untitled"
        self._hover_edge = None
        self._setup_path: Path | None = None
        self._precomputed: dict | None = None
        self._worker: SimulationWorker | None = None
        self._launch_dialog = None
        self._live_view = True

        toolbar = tk.Frame(self, bg=PALETTE["face"])
        toolbar.pack(fill="x", padx=6, pady=6)
        buttons = [
            ("Intrinsic geometry", self.load_intrinsic),
            ("Import GDS…", self.load_gds),
            ("Parameters…", self.edit_parameters),
            ("Initial conditions…", self.edit_initial_conditions),
            ("Preview IC", self.preview_initial_condition),
            ("Generation…", self.edit_generation),
            ("Photon drive…", self.edit_photon_drive),
            ("Gap map…", self.edit_gap_map),
            ("Materials…", lambda: show_material_reference(self)),
            ("Precompute", self.run_precompute),
            ("Save setup", self.save_setup_file),
            ("Run simulation", self.run_simulation),
        ]
        for text, cmd in buttons:
            tk.Button(toolbar, text=text, command=cmd).pack(side="left", padx=2)

        self.status = tk.Label(self, text="Load a geometry to begin.", anchor="w",
                               bg=PALETTE["face"])
        self.status.pack(fill="x", padx=6)

        self.figure = Figure(figsize=(7.2, 4.6), dpi=100)
        self.ax = self.figure.add_subplot(111)
        self.canvas = FigureCanvasTkAgg(self.figure, master=self)
        self.canvas.get_tk_widget().pack(fill="both", expand=True, padx=6, pady=6)
        self.canvas.mpl_connect("motion_notify_event", self._on_hover)
        self.canvas.mpl_connect("button_press_event", self._on_click)

    # -- geometry ------------------------------------------------------------

    def load_intrinsic(self):
        self._set_geometry(create_intrinsic_geometry(mesh_size=self.parameters.mesh_size))

    def load_gds(self):
        path = filedialog.askopenfilename(
            parent=self, title="Select GDS file", filetypes=[("GDSII", "*.gds"), ("all", "*.*")]
        )
        if not path:
            return
        try:
            layers = discover_gds_layers(path)
            layer = layers[0]
            if len(layers) > 1:
                choice = simpledialog.askinteger(
                    "Layer", f"Available layers: {layers}\nLayer to rasterize:",
                    parent=self, initialvalue=layers[0],
                )
                if choice is None:
                    return
                layer = int(choice)
            geo = create_geometry_from_gds(path, layer, self.parameters.mesh_size)
        except Exception as exc:
            messagebox.showerror("GDS import failed", str(exc), parent=self)
            return
        self._set_geometry(geo)

    def _set_geometry(self, geo):
        self.geometry_data = geo
        self.mask = mask_from_lists(geo.mask)
        self.edge_conditions = {}
        self._precomputed = None
        self.status.configure(
            text=f"Geometry '{geo.name}': {int(self.mask.sum())} cells, "
                 f"{len(geo.edges)} edges — click an edge to assign its boundary condition."
        )
        self._redraw()

    # -- edge picking ----------------------------------------------------------

    def _nearest_edge(self, x, y):
        if self.geometry_data is None or x is None or y is None:
            return None
        best, best_d = None, _EDGE_PICK_RADIUS
        for edge in self.geometry_data.edges:
            d = point_to_segment_distance(x, y, edge)
            if d < best_d:
                best, best_d = edge, d
        return best

    def _on_hover(self, event):
        edge = self._nearest_edge(event.xdata, event.ydata)
        if edge is not self._hover_edge:
            self._hover_edge = edge
            self._redraw()

    def _on_click(self, event):
        edge = self._nearest_edge(event.xdata, event.ydata)
        if edge is None:
            return
        bc = ask_boundary_condition(self, self.edge_conditions.get(edge.edge_id))
        if bc is not None:
            self.edge_conditions[edge.edge_id] = bc
            self._redraw()

    def _redraw(self):
        self.ax.clear()
        if self.mask is not None:
            self.ax.imshow(self.mask, origin="lower", cmap="gray_r", interpolation="nearest")
            for edge in self.geometry_data.edges:
                assigned = edge.edge_id in self.edge_conditions
                color = "#00a000" if assigned else "#c00000"
                lw = 3.0 if edge is self._hover_edge else 1.5
                self.ax.plot(
                    [edge.x0 - 0.5, edge.x1 - 0.5], [edge.y0 - 0.5, edge.y1 - 0.5],
                    color=color, lw=lw,
                )
            missing = sum(
                1 for e in self.geometry_data.edges if e.edge_id not in self.edge_conditions
            )
            self.ax.set_title(
                "all edges assigned" if missing == 0 else f"{missing} edges unassigned (red)"
            )
        self.ax.set_xticks([])
        self.ax.set_yticks([])
        self.canvas.draw_idle()

    # -- dialogs -----------------------------------------------------------------

    def edit_parameters(self):
        fields = [
            ("diffusion_coefficient", "D₀ [µm²/ns]"),
            ("dt", "dt [ns]"),
            ("total_time", "total time [ns]"),
            ("mesh_size", "mesh size [µm]"),
            ("store_every", "store every N steps"),
            ("energy_gap", "Δ [µeV] (0 = scalar mode)"),
            ("energy_max_factor", "E_max / Δ"),
            ("num_energy_bins", "energy bins"),
            ("dynes_gamma", "Dynes Γ [µeV]"),
            ("tau_s", "τ_s [ns]"),
            ("tau_r", "τ_r [ns]"),
            ("T_c", "T_c [K]"),
            ("bath_temperature", "T_bath [K]"),
            ("gap_expression", "gap map Δ(x,y) expression"),
        ]
        win = tk.Toplevel(self)
        win.title("Simulation Parameters")
        win.configure(bg=PALETTE["face"])
        win.grab_set()
        vars_ = {}
        for i, (key, label) in enumerate(fields):
            tk.Label(win, text=label).grid(row=i, column=0, sticky="w", padx=8, pady=1)
            vars_[key] = tk.StringVar(value=str(getattr(self.parameters, key)))
            tk.Entry(win, textvariable=vars_[key], width=28).grid(row=i, column=1, padx=8)
        flags = {}
        for j, key in enumerate(("enable_diffusion", "enable_recombination", "enable_scattering",
                                 "export_phonon_history")):
            flags[key] = tk.BooleanVar(value=getattr(self.parameters, key))
            tk.Checkbutton(win, text=key, variable=flags[key], bg=PALETTE["face"]).grid(
                row=len(fields) + j, column=0, columnspan=2, sticky="w", padx=8
            )

        def accept():
            try:
                kwargs = dict(
                    diffusion_coefficient=float(vars_["diffusion_coefficient"].get()),
                    dt=float(vars_["dt"].get()),
                    total_time=float(vars_["total_time"].get()),
                    mesh_size=float(vars_["mesh_size"].get()),
                    store_every=int(vars_["store_every"].get()),
                    energy_gap=float(vars_["energy_gap"].get()),
                    energy_max_factor=float(vars_["energy_max_factor"].get()),
                    num_energy_bins=int(vars_["num_energy_bins"].get()),
                    dynes_gamma=float(vars_["dynes_gamma"].get()),
                    tau_s=float(vars_["tau_s"].get()),
                    tau_r=float(vars_["tau_r"].get()),
                    T_c=float(vars_["T_c"].get()),
                    bath_temperature=float(vars_["bath_temperature"].get()),
                    gap_expression=vars_["gap_expression"].get(),
                    external_generation=self.parameters.external_generation,
                    **{k: v.get() for k, v in flags.items()},
                )
                self.parameters = SimulationParameters(**kwargs)
            except Exception as exc:
                messagebox.showerror("Invalid parameters", str(exc), parent=win)
                return
            win.destroy()

        tk.Button(win, text="OK", width=10, command=accept).grid(
            row=len(fields) + 5, column=0, pady=8
        )
        tk.Button(win, text="Cancel", width=10, command=win.destroy).grid(
            row=len(fields) + 5, column=1, pady=8
        )

    def edit_initial_conditions(self):
        spec = ask_initial_condition(self, self.initial_condition)
        if spec is not None:
            self.initial_condition = spec

    def preview_initial_condition(self):
        """Render the initial QP field before launching (launch-dialog preview)."""
        if self.mask is None:
            messagebox.showinfo("No geometry", "Load a geometry first.", parent=self)
            return
        try:
            from ..fields import build_initial_field

            field = build_initial_field(self.mask, self.initial_condition)
        except Exception as exc:
            messagebox.showerror("Initial condition failed", str(exc), parent=self)
            return
        shown = np.where(self.mask, field, np.nan)
        self.ax.clear()
        self.ax.imshow(shown, origin="lower", cmap="inferno", interpolation="nearest")
        self.ax.set_title("initial condition preview (click geometry buttons to return)")
        self.ax.set_xticks([])
        self.ax.set_yticks([])
        self.canvas.draw_idle()

    def edit_generation(self):
        spec = ask_external_generation(self, self.parameters.external_generation)
        if spec is not None:
            self.parameters.external_generation = spec

    def edit_photon_drive(self):
        drive = self.parameters.photon_drive
        multi = isinstance(drive, (list, tuple)) and len(drive) > 0
        spec = ask_photon_drive(self, drive[0] if multi else drive)
        if spec is not None:
            if multi:
                # multi-tone setups (JSON-authored): the dialog edits the
                # first mode; the remaining tones are preserved untouched
                self.parameters.photon_drive = [spec, *drive[1:]]
            else:
                self.parameters.photon_drive = spec

    def edit_gap_map(self):
        """Multi-line Δ(x,y) editor with validate-on-apply and a preview.

        Reference counterpart: ``qpsim/ui/main_app.py:1429-1485`` (the
        dedicated gap-map dialog; expressions are evaluated against the
        current mask before being accepted).
        """
        win = tk.Toplevel(self)
        win.title("Custom Gap Map Δ(x,y)")
        win.configure(bg=PALETTE["face"])
        win.grab_set()
        tk.Label(
            win, text="Custom Python body for Δ(x,y) in µeV", bg=PALETTE["face"],
        ).pack(anchor="w", padx=10, pady=(10, 2))
        tk.Label(
            win,
            text=(
                "Variables: x, y in [0,1], params dict, numpy as np.\n"
                "Return a scalar or vectorized array over interior pixels.\n"
                "Leave empty to use the constant (uniform) Δ parameter."
            ),
            bg=PALETTE["face"], justify="left",
        ).pack(anchor="w", padx=10, pady=(0, 6))
        text = tk.Text(win, width=80, height=14)
        text.pack(fill="both", expand=True, padx=10, pady=(0, 8))
        current = (self.parameters.gap_expression or "").strip()
        text.insert("1.0", current or "return 180.0 + 20.0 * x")

        def _evaluate():
            from ..fields import evaluate_gap_expression

            expression = text.get("1.0", "end").strip()
            if not expression:
                return None, np.full(int(self.mask.sum()), self.parameters.energy_gap)
            values = evaluate_gap_expression(
                expression, self.mask.copy(), self.parameters.energy_gap
            )
            return expression, values

        def _apply():
            try:
                expression, _ = _evaluate() if self.mask is not None else (
                    text.get("1.0", "end").strip() or None, None
                )
            except Exception as exc:
                messagebox.showerror("Invalid gap map", str(exc), parent=win)
                return
            self.parameters.gap_expression = expression or ""
            self.status.configure(
                text="Gap map: " + (expression or "uniform Δ")
            )
            win.destroy()

        def _preview():
            if self.mask is None:
                messagebox.showinfo("No geometry", "Load a geometry first.", parent=win)
                return
            try:
                _, values = _evaluate()
            except Exception as exc:
                messagebox.showerror("Invalid gap map", str(exc), parent=win)
                return
            shown = np.full(self.mask.shape, np.nan)
            shown[self.mask] = values
            self.ax.clear()
            self.ax.imshow(shown, origin="lower", cmap="viridis", interpolation="nearest")
            self.ax.set_title("gap map Δ(x,y) preview [µeV]")
            self.ax.set_xticks([])
            self.ax.set_yticks([])
            self.canvas.draw_idle()

        def _clear_constant():
            self.parameters.gap_expression = ""
            self.status.configure(text="Gap map: uniform Δ")
            win.destroy()

        bar = tk.Frame(win, bg=PALETTE["face"])
        bar.pack(fill="x", padx=10, pady=(0, 10))
        tk.Button(bar, text="Use constant only", width=16, command=_clear_constant).pack(side="left")
        tk.Button(bar, text="Preview", width=10, command=_preview).pack(side="left", padx=6)
        tk.Button(bar, text="Cancel", width=10, command=win.destroy).pack(side="right", padx=(6, 0))
        tk.Button(bar, text="Apply", width=10, command=_apply).pack(side="right")

    # -- setup assembly -------------------------------------------------------------

    def build_setup(self) -> SetupData:
        if self.geometry_data is None:
            raise ValueError("Load a geometry first.")
        missing = [
            e.edge_id for e in self.geometry_data.edges if e.edge_id not in self.edge_conditions
        ]
        if missing and self.parameters.enable_diffusion:
            raise ValueError(f"{len(missing)} edges have no boundary condition assigned.")
        return SetupData(
            setup_id=create_setup_id(),
            name=self.setup_name,
            created_at=utc_now_iso(),
            geometry=self.geometry_data,
            boundary_conditions=dict(self.edge_conditions),
            parameters=self.parameters,
            initial_condition=self.initial_condition,
        )

    def save_setup_file(self):
        name = simpledialog.askstring("Setup name", "Name:", parent=self,
                                      initialvalue=self.setup_name)
        if not name:
            return
        self.setup_name = name
        try:
            setup = self.build_setup()
            self._setup_path = save_setup(setup)
            if self._precomputed is not None:
                save_precomputed(self._setup_path, self._precomputed)
            self.status.configure(text=f"Saved {self._setup_path}")
        except Exception as exc:
            messagebox.showerror("Save failed", str(exc), parent=self)

    def run_precompute(self):
        try:
            setup = self.build_setup()
            if setup.parameters.energy_gap <= 0:
                raise ValueError("Precompute requires energy_gap > 0.")
            self._precomputed = precompute_arrays(
                self.mask, setup.geometry.edges, setup.boundary_conditions, setup.parameters,
                progress_callback=lambda m: self.status.configure(text=m),
                include_collision_kernels=True,
            )
            self.status.configure(text="Precompute complete (saved with the setup).")
        except Exception as exc:
            messagebox.showerror("Precompute failed", str(exc), parent=self)

    # -- run -------------------------------------------------------------------------

    def _initial_phonon_frame(self, setup) -> np.ndarray:
        """Integrated thermal phonon occupation at T_bath for the launch preview."""
        p = setup.parameters
        if p.energy_gap > 0:
            from ..ops.dos import thermal_phonon_occupation
            from ..ops.energy_grid import (
                build_energy_grid,
                integration_widths_from_centers,
            )
            from ..ops.phonon_map import build_phonon_frequency_map

            E, dE = build_energy_grid(
                p.energy_gap, p.energy_min_factor, p.energy_max_factor, p.num_energy_bins
            )
            pm = build_phonon_frequency_map(E)
            occ = thermal_phonon_occupation(pm.omega_bins, p.bath_temperature)
            widths = integration_widths_from_centers(pm.omega_bins, fallback_width=dE)
            total = float(np.sum(occ * widths))
        else:  # scalar mode carries no phonon field: show the bath temperature
            total = float(p.bath_temperature)
        return np.where(self.mask, total, np.nan)

    def run_simulation(self):
        """Open the launch dialog: review initial fields, then start.

        Reference flow: ``qpsim/ui/main_app.py:353-479`` (dedicated
        ``SimulationLaunchDialog`` with pre-run preview + live toggle).
        """
        if self._worker is not None and self._worker.is_running():
            messagebox.showinfo("Busy", "A simulation is already running.", parent=self)
            return
        try:
            setup = self.build_setup()
            from ..fields import build_initial_field

            qp0 = build_initial_field(self.mask, self.initial_condition)
        except Exception as exc:
            messagebox.showerror("Cannot run", str(exc), parent=self)
            return
        qp_frame = np.where(self.mask, qp0, np.nan)
        ph_frame = self._initial_phonon_frame(setup)
        from .launch_dialog import SimulationLaunchDialog

        self._launch_dialog = SimulationLaunchDialog(
            self, setup.name, qp_frame, ph_frame, live_default=True,
            on_start=lambda live: self._start_run(setup, live),
        )

    def _start_run(self, setup, live: bool):
        if self._worker is not None and self._worker.is_running():
            return
        self._live_view = bool(live)
        self._worker = SimulationWorker(setup=setup, setup_path=self._setup_path, device=self.device)
        self._worker.start()
        dialog = getattr(self, "_launch_dialog", None)
        if dialog is not None and not dialog.closed:
            dialog.set_running(True)
        self.status.configure(text="Simulation running…")
        self.after(_POLL_MS, self._poll_worker)

    def _poll_worker(self):
        worker = self._worker
        if worker is None:
            return
        dialog = getattr(self, "_launch_dialog", None)
        if dialog is not None and dialog.closed:
            dialog = None
        # the result first: the worker queues every live frame before it, so
        # once it is in, one full drain shows the last frames too
        outcome = worker.poll_result()
        for live in worker.drain_live(64 if outcome is None else worker.live.qsize() + 64):
            if not getattr(self, "_live_view", True):
                continue
            if dialog is not None:
                dialog.update_preview(live.time_ns, live.frame)
            else:  # dialog closed mid-run: fall back to the editor canvas
                self.ax.clear()
                self.ax.imshow(
                    live.frame, origin="lower", cmap="inferno", interpolation="nearest"
                )
                self.ax.set_title(f"live — t = {live.time_ns:.6g} ns")
                self.ax.set_xticks([])
                self.ax.set_yticks([])
                self.canvas.draw_idle()
        if outcome is None:
            self.after(_POLL_MS, self._poll_worker)
            return
        kind, payload = outcome
        if kind == "error":
            if dialog is not None:
                dialog.set_status("Simulation failed.")
                dialog.set_running(False)
            messagebox.showerror("Simulation failed", str(payload), parent=self)
            self.status.configure(text="Simulation failed.")
            self._redraw()
            return
        result, path = payload
        done = f"Done: {len(result.times)} frames" + (f", saved {path}" if path else "")
        if dialog is not None:
            dialog.set_status("Simulation complete.")
            dialog.set_running(False)
        self.status.configure(text=done)
        SimulationViewer(self, result)
        if result.phonon_frames:
            PhononViewer(self, result)
        self._redraw()
