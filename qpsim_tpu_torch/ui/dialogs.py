"""Modal dialogs: material reference, boundary conditions, initial
conditions, external generation (reference qpsim/ui/dialogs.py)."""

from __future__ import annotations

import json
import tkinter as tk
from tkinter import messagebox, ttk

from ..models.params import (
    BOUNDARY_KINDS,
    BoundaryCondition,
    ExternalGenerationSpec,
    InitialConditionSpec,
    PhotonDriveSpec,
)
from ..models.materials import material_reference_table
from .theme import FONT_TITLE, PALETTE

__all__ = [
    "show_material_reference",
    "ask_boundary_condition",
    "ask_initial_condition",
    "ask_external_generation",
    "ask_photon_drive",
]


def show_material_reference(parent) -> None:
    """Literature table of superconductor parameters (Al, Nb, Ta, Sn, NbN, TiN)."""
    win = tk.Toplevel(parent)
    win.title("Material Reference")
    win.configure(bg=PALETTE["face"])
    cols = ("material", "Tc_K", "gap_ueV", "D0", "tau0")
    tree = ttk.Treeview(win, columns=cols, show="headings", height=8)
    for col, label, width in (
        ("material", "Material", 140),
        ("Tc_K", "T_c [K]", 70),
        ("gap_ueV", "Δ(0) [µeV]", 90),
        ("D0", "D₀ [µm²/ns]", 110),
        ("tau0", "τ₀ [ns]", 80),
    ):
        tree.heading(col, text=label)
        tree.column(col, width=width, anchor="center")
    for mat in material_reference_table():
        tree.insert(
            "",
            "end",
            values=(mat.material, mat.Tc_K, mat.gap_ueV, f"{mat.D0_nom} ({mat.D0_range})", mat.tau_0_ns),
        )
    tree.pack(fill="both", expand=True, padx=8, pady=8)

    notes = tk.Text(win, height=6, wrap="word")
    notes.pack(fill="both", expand=True, padx=8, pady=(0, 8))

    def show_notes(_event=None):
        sel = tree.selection()
        if not sel:
            return
        name = tree.item(sel[0], "values")[0]
        mat = next(m for m in material_reference_table() if m.material == name)
        notes.delete("1.0", "end")
        notes.insert("end", mat.notes + "\n\nReferences:\n")
        for ref, detail in mat.refs:
            notes.insert("end", f"  • {ref} — {detail}\n")

    tree.bind("<<TreeviewSelect>>", show_notes)
    tk.Button(win, text="Close", command=win.destroy).pack(pady=(0, 8))


def ask_boundary_condition(parent, current: BoundaryCondition | None = None) -> BoundaryCondition | None:
    """Pick a BC kind + values for one edge; None when cancelled."""
    win = tk.Toplevel(parent)
    win.title("Boundary Condition")
    win.configure(bg=PALETTE["face"])
    win.grab_set()

    kind_var = tk.StringVar(value=(current.normalized_kind() if current else "reflective"))
    value_var = tk.StringVar(value="" if not current or current.value is None else str(current.value))
    aux_var = tk.StringVar(value="" if not current or current.aux_value is None else str(current.aux_value))

    tk.Label(win, text="Kind:", font=FONT_TITLE).grid(row=0, column=0, sticky="w", padx=8, pady=4)
    kinds = sorted(BOUNDARY_KINDS)
    box = ttk.Combobox(win, textvariable=kind_var, values=kinds, state="readonly")
    box.grid(row=0, column=1, padx=8, pady=4)
    tk.Label(win, text="Value (g / q / β):").grid(row=1, column=0, sticky="w", padx=8)
    tk.Entry(win, textvariable=value_var).grid(row=1, column=1, padx=8)
    tk.Label(win, text="Aux value (γ, robin only):").grid(row=2, column=0, sticky="w", padx=8)
    tk.Entry(win, textvariable=aux_var).grid(row=2, column=1, padx=8)

    out: list[BoundaryCondition | None] = [None]

    def accept():
        try:
            kind = kind_var.get()
            value = float(value_var.get()) if value_var.get().strip() else None
            aux = float(aux_var.get()) if aux_var.get().strip() else None
            bc = BoundaryCondition(kind=kind, value=value, aux_value=aux)
            bc.validate()
        except Exception as exc:
            messagebox.showerror("Invalid boundary condition", str(exc), parent=win)
            return
        out[0] = bc
        win.destroy()

    tk.Button(win, text="OK", width=10, command=accept).grid(row=3, column=0, pady=8)
    tk.Button(win, text="Cancel", width=10, command=win.destroy).grid(row=3, column=1, pady=8)
    parent.wait_window(win)
    return out[0]


_SPATIAL_KINDS = ("gaussian", "uniform", "point", "custom")
_ENERGY_KINDS = ("dos", "fermi_dirac", "uniform", "custom")
_PH_ENERGY_KINDS = ("bose_einstein", "uniform", "custom")


def _params_entry(parent, label, initial):
    tk.Label(parent, text=label).pack(anchor="w", padx=8)
    var = tk.StringVar(value=json.dumps(initial))
    tk.Entry(parent, textvariable=var, width=60).pack(fill="x", padx=8, pady=(0, 4))
    return var


def ask_initial_condition(parent, spec: InitialConditionSpec) -> InitialConditionSpec | None:
    """Tabbed QP/phonon initial-condition editor; None when cancelled.

    Full non-separable profiles require custom×custom, matching the
    reference's gating (dialogs.py:546-561, 687-695).
    """
    win = tk.Toplevel(parent)
    win.title("Initial Conditions")
    win.configure(bg=PALETTE["face"])
    win.grab_set()
    notebook = ttk.Notebook(win)
    notebook.pack(fill="both", expand=True, padx=8, pady=8)

    def build_tab(title, sp_kinds, sp_kind, sp_params, sp_body, en_kinds, en_kind, en_params,
                  en_body, full_enabled, full_body):
        tab = tk.Frame(notebook, bg=PALETTE["face"])
        notebook.add(tab, text=title)
        sp_var = tk.StringVar(value=sp_kind or sp_kinds[0])
        en_var = tk.StringVar(value=en_kind or en_kinds[0])
        tk.Label(tab, text="Spatial kind:", font=FONT_TITLE).pack(anchor="w", padx=8)
        ttk.Combobox(tab, textvariable=sp_var, values=sp_kinds, state="readonly").pack(anchor="w", padx=8)
        sp_params_var = _params_entry(tab, "Spatial params (JSON):", sp_params)
        tk.Label(tab, text="Spatial custom expression:").pack(anchor="w", padx=8)
        sp_body_var = tk.StringVar(value=sp_body)
        tk.Entry(tab, textvariable=sp_body_var, width=60).pack(fill="x", padx=8, pady=(0, 4))
        tk.Label(tab, text="Energy kind:", font=FONT_TITLE).pack(anchor="w", padx=8)
        ttk.Combobox(tab, textvariable=en_var, values=en_kinds, state="readonly").pack(anchor="w", padx=8)
        en_params_var = _params_entry(tab, "Energy params (JSON):", en_params)
        tk.Label(tab, text="Energy custom expression:").pack(anchor="w", padx=8)
        en_body_var = tk.StringVar(value=en_body)
        tk.Entry(tab, textvariable=en_body_var, width=60).pack(fill="x", padx=8, pady=(0, 4))
        full_var = tk.BooleanVar(value=full_enabled)
        tk.Checkbutton(
            tab,
            text="Full non-separable profile F(x, y, E) (requires custom × custom)",
            variable=full_var,
            bg=PALETTE["face"],
        ).pack(anchor="w", padx=8, pady=(6, 0))
        full_body_var = tk.StringVar(value=full_body)
        tk.Entry(tab, textvariable=full_body_var, width=60).pack(fill="x", padx=8, pady=(0, 6))
        return dict(sp=sp_var, sp_params=sp_params_var, sp_body=sp_body_var,
                    en=en_var, en_params=en_params_var, en_body=en_body_var,
                    full=full_var, full_body=full_body_var)

    qp = build_tab("Quasiparticles", _SPATIAL_KINDS, spec.spatial_kind, spec.spatial_params,
                   spec.spatial_custom_body, _ENERGY_KINDS, spec.energy_kind, spec.energy_params,
                   spec.energy_custom_body, spec.qp_full_custom_enabled, spec.qp_full_custom_body)
    ph = build_tab("Phonons", _SPATIAL_KINDS, spec.phonon_spatial_kind, spec.phonon_spatial_params,
                   spec.phonon_spatial_custom_body, _PH_ENERGY_KINDS, spec.phonon_energy_kind,
                   spec.phonon_energy_params, spec.phonon_energy_custom_body,
                   spec.phonon_full_custom_enabled, spec.phonon_full_custom_body)

    out: list[InitialConditionSpec | None] = [None]

    def accept():
        try:
            for tab, label in ((qp, "QP"), (ph, "phonon")):
                if tab["full"].get() and not (
                    tab["sp"].get() == "custom" and tab["en"].get() == "custom"
                ):
                    raise ValueError(
                        f"Full {label} profile requires custom spatial AND custom energy kinds."
                    )
            result = InitialConditionSpec(
                spatial_kind=qp["sp"].get(),
                spatial_params=json.loads(qp["sp_params"].get() or "{}"),
                spatial_custom_body=qp["sp_body"].get(),
                energy_kind=qp["en"].get(),
                energy_params=json.loads(qp["en_params"].get() or "{}"),
                energy_custom_body=qp["en_body"].get(),
                qp_full_custom_enabled=qp["full"].get(),
                qp_full_custom_body=qp["full_body"].get(),
                phonon_spatial_kind=ph["sp"].get(),
                phonon_spatial_params=json.loads(ph["sp_params"].get() or "{}"),
                phonon_spatial_custom_body=ph["sp_body"].get(),
                phonon_energy_kind=ph["en"].get(),
                phonon_energy_params=json.loads(ph["en_params"].get() or "{}"),
                phonon_energy_custom_body=ph["en_body"].get(),
                phonon_full_custom_enabled=ph["full"].get(),
                phonon_full_custom_body=ph["full_body"].get(),
            )
        except Exception as exc:
            messagebox.showerror("Invalid initial condition", str(exc), parent=win)
            return
        out[0] = result
        win.destroy()

    bar = tk.Frame(win, bg=PALETTE["face"])
    bar.pack(pady=(0, 8))
    tk.Button(bar, text="OK", width=10, command=accept).pack(side="left", padx=4)
    tk.Button(bar, text="Cancel", width=10, command=win.destroy).pack(side="left", padx=4)
    parent.wait_window(win)
    return out[0]


def ask_external_generation(parent, spec: ExternalGenerationSpec) -> ExternalGenerationSpec | None:
    win = tk.Toplevel(parent)
    win.title("External Generation")
    win.configure(bg=PALETTE["face"])
    win.grab_set()
    mode_var = tk.StringVar(value=spec.normalized_mode())
    vars_ = {
        "rate": tk.StringVar(value=str(spec.rate)),
        "pulse_start": tk.StringVar(value=str(spec.pulse_start)),
        "pulse_duration": tk.StringVar(value=str(spec.pulse_duration)),
        "pulse_rate": tk.StringVar(value=str(spec.pulse_rate)),
        "custom_body": tk.StringVar(value=spec.custom_body),
    }
    tk.Label(win, text="Mode:", font=FONT_TITLE).grid(row=0, column=0, sticky="w", padx=8, pady=4)
    ttk.Combobox(
        win, textvariable=mode_var, values=("none", "constant", "pulse", "custom"), state="readonly"
    ).grid(row=0, column=1, padx=8)
    rows = [
        ("Constant rate [µeV⁻¹µm⁻²ns⁻¹]:", "rate"),
        ("Pulse start [ns]:", "pulse_start"),
        ("Pulse duration [ns]:", "pulse_duration"),
        ("Pulse rate:", "pulse_rate"),
        ("Custom g(E,x,y,t,params):", "custom_body"),
    ]
    for i, (label, key) in enumerate(rows, start=1):
        tk.Label(win, text=label).grid(row=i, column=0, sticky="w", padx=8)
        tk.Entry(win, textvariable=vars_[key], width=44).grid(row=i, column=1, padx=8, pady=2)

    out: list[ExternalGenerationSpec | None] = [None]

    def accept():
        try:
            result = ExternalGenerationSpec(
                mode=mode_var.get(),
                rate=float(vars_["rate"].get() or 0.0),
                pulse_start=float(vars_["pulse_start"].get() or 0.0),
                pulse_duration=float(vars_["pulse_duration"].get() or 0.0),
                pulse_rate=float(vars_["pulse_rate"].get() or 0.0),
                custom_body=vars_["custom_body"].get() or "return 0.0",
            )
            result.validate()
        except Exception as exc:
            messagebox.showerror("Invalid generation spec", str(exc), parent=win)
            return
        out[0] = result
        win.destroy()

    tk.Button(win, text="OK", width=10, command=accept).grid(row=7, column=0, pady=8)
    tk.Button(win, text="Cancel", width=10, command=win.destroy).grid(row=7, column=1, pady=8)
    parent.wait_window(win)
    return out[0]


def ask_photon_drive(parent, spec: PhotonDriveSpec) -> PhotonDriveSpec | None:
    """Editor for the resonator-photon drive (Fischer 2024).

    Beyond the reference UI — the model sits in its "Not yet Implemented"
    queue; the dialog mirrors the external-generation editor's shape.
    """
    win = tk.Toplevel(parent)
    win.title("Photon Drive (pair-breaking photons)")
    win.configure(bg=PALETTE["face"])
    win.grab_set()
    mode_var = tk.StringVar(value=spec.normalized_mode())
    scat_var = tk.BooleanVar(value=spec.include_scattering)
    pb_var = tk.BooleanVar(value=spec.include_pair_breaking)
    vars_ = {
        "photon_energy": tk.StringVar(value=str(spec.photon_energy)),
        "occupancy": tk.StringVar(value=str(spec.occupancy)),
        "coupling": tk.StringVar(value=str(spec.coupling)),
        "window_start": tk.StringVar(
            value="" if spec.window_start is None else str(spec.window_start)
        ),
        "window_duration": tk.StringVar(
            value="" if spec.window_duration is None else str(spec.window_duration)
        ),
    }
    tk.Label(win, text="Mode:", font=FONT_TITLE).grid(row=0, column=0, sticky="w", padx=8, pady=4)
    ttk.Combobox(
        win, textvariable=mode_var, values=("none", "photon"), state="readonly"
    ).grid(row=0, column=1, padx=8)
    rows = [
        ("Photon energy ω [µeV] (pair-breaking needs ω > 2Δ):", "photon_energy"),
        ("Mode occupancy n̄:", "occupancy"),
        ("Coupling c [1/ns]:", "coupling"),
        ("Window start [ns] (blank = always on):", "window_start"),
        ("Window duration [ns]:", "window_duration"),
    ]
    for i, (label, key) in enumerate(rows, start=1):
        tk.Label(win, text=label).grid(row=i, column=0, sticky="w", padx=8)
        tk.Entry(win, textvariable=vars_[key], width=30).grid(row=i, column=1, padx=8, pady=2)
    tk.Checkbutton(win, text="Scattering (absorption/emission redistribution)",
                   variable=scat_var).grid(row=6, column=0, columnspan=2, sticky="w", padx=8)
    tk.Checkbutton(win, text="Pair breaking (generation + photon-emission recombination)",
                   variable=pb_var).grid(row=7, column=0, columnspan=2, sticky="w", padx=8)

    out: list[PhotonDriveSpec | None] = [None]

    def accept():
        try:
            w0 = vars_["window_start"].get().strip()
            wd = vars_["window_duration"].get().strip()
            result = PhotonDriveSpec(
                mode=mode_var.get(),
                photon_energy=float(vars_["photon_energy"].get() or 0.0),
                occupancy=float(vars_["occupancy"].get() or 0.0),
                coupling=float(vars_["coupling"].get() or 0.0),
                include_scattering=bool(scat_var.get()),
                include_pair_breaking=bool(pb_var.get()),
                window_start=float(w0) if w0 else None,
                window_duration=float(wd) if wd else None,
            )
            result.validate()
        except Exception as exc:
            messagebox.showerror("Invalid photon drive", str(exc), parent=win)
            return
        out[0] = result
        win.destroy()

    tk.Button(win, text="OK", width=10, command=accept).grid(row=8, column=0, pady=8)
    tk.Button(win, text="Cancel", width=10, command=win.destroy).grid(row=8, column=1, pady=8)
    parent.wait_window(win)
    return out[0]
