"""Top-level Tkinter application (reference qpsim/ui/main_app.py).

Start screen with the reference's workflows: create/edit setups, load and
replay saved simulations, generate and browse the analytic test suite, run
the physics validation suite, and open the material reference.  Port of
``qpsim_tpu.ui.main_app``: runs, the test suite and the validation suite
compute on the app's ``device``.  Start it with
``python -m qpsim_tpu_torch.ui.main_app [--device cpu]`` (needs Tk and
matplotlib).
"""

from __future__ import annotations

import argparse
import threading
import tkinter as tk
from tkinter import filedialog, messagebox

from ..io.storage import (
    latest_test_suite_file,
    load_simulation,
    load_test_suite,
)
from .dialogs import show_material_reference
from .setup_editor import SetupEditor
from .theme import FONT_BIG, PALETTE, apply_theme
from .viewers import PhononViewer, SimulationViewer, StreamViewer, TestGeometryLanding

__all__ = ["QuasiparticleMainApp", "run_app"]


class QuasiparticleMainApp(tk.Tk):
    def __init__(self, device: str = "cuda"):
        super().__init__()
        self.device = device
        self.title(f"Quasiparticle Physics Simulator ({device})")
        apply_theme(self)
        tk.Label(
            self,
            text="Quasiparticle & Phonon Kinetics",
            font=FONT_BIG,
            bg=PALETTE["accent"],
            fg=PALETTE["accent_text"],
            pady=12,
        ).pack(fill="x")
        body = tk.Frame(self, bg=PALETTE["face"])
        body.pack(padx=24, pady=16)
        actions = [
            ("New / edit setup…", self.open_setup_editor),
            ("View saved simulation…", self.view_simulation),
            ("View streamed run…", self.view_stream),
            ("Generate analytic test suite", self.generate_tests),
            ("Browse analytic test suite…", self.view_tests),
            ("Run physics validation", self.run_validation),
            ("Material reference…", lambda: show_material_reference(self)),
            ("Quit", self.destroy),
        ]
        for text, cmd in actions:
            tk.Button(body, text=text, width=34, command=cmd).pack(pady=3)
        self.status = tk.Label(self, text="", anchor="w", bg=PALETTE["face"])
        self.status.pack(fill="x", padx=8, pady=(0, 6))

    def open_setup_editor(self):
        SetupEditor(self, device=self.device)

    def view_simulation(self):
        path = filedialog.askopenfilename(
            parent=self, title="Simulation JSON", filetypes=[("JSON", "*.json")]
        )
        if not path:
            return
        try:
            result = load_simulation(path)
        except Exception as exc:
            messagebox.showerror("Load failed", str(exc), parent=self)
            return
        SimulationViewer(self, result)
        if result.phonon_frames:
            PhononViewer(self, result)

    def view_stream(self):
        path = filedialog.askdirectory(
            parent=self, title="Streamed-frames directory (run --stream-dir)"
        )
        if not path:
            return
        try:
            from ..io.stream import load_frame_stream

            # inside the try: a manifest can be intact while a shard is
            # missing/truncated — the first frame read happens here
            StreamViewer(self, load_frame_stream(path))
        except Exception as exc:
            messagebox.showerror("Load failed", str(exc), parent=self)
            return

    def generate_tests(self):
        self.status.configure(text="Generating test suite (background)…")

        def work():
            try:
                from ..testcases.generator import generate_and_save_test_suite

                _, path = generate_and_save_test_suite(device=self.device)
                self.after(0, lambda: self.status.configure(text=f"Test suite saved: {path}"))
            except Exception as exc:
                self.after(
                    0, lambda exc=exc: messagebox.showerror("Generation failed", str(exc), parent=self)
                )

        threading.Thread(target=work, daemon=True).start()

    def view_tests(self):
        path = latest_test_suite_file()
        if path is None:
            path = filedialog.askopenfilename(
                parent=self, title="Test suite manifest", filetypes=[("JSON", "*.json")]
            )
            if not path:
                return
        try:
            suite = load_test_suite(path, load_group_cases=False)
        except Exception as exc:
            messagebox.showerror("Load failed", str(exc), parent=self)
            return
        TestGeometryLanding(self, suite, manifest_path=path)

    def run_validation(self):
        self.status.configure(text="Running validation suite…")

        def work():
            try:
                from ..validation import run_fast_validation_suite

                report = run_fast_validation_suite(device=self.device)
                verdict = "PASS" if report.overall_passed else "FAIL"
                self.after(0, lambda: self.status.configure(text=f"Validation: {verdict}"))
            except Exception as exc:
                self.after(
                    0, lambda exc=exc: messagebox.showerror("Validation failed", str(exc), parent=self)
                )

        threading.Thread(target=work, daemon=True).start()


def run_app(device: str = "cuda") -> None:
    app = QuasiparticleMainApp(device=device)
    app.mainloop()


if __name__ == "__main__":
    cli = argparse.ArgumentParser(prog="python -m qpsim_tpu_torch.ui.main_app",
                                  description="The simulator's GUI (Tk).")
    cli.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    run_app(cli.parse_args().device)
