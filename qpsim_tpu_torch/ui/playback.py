"""Tk-independent viewer logic: playback state and frame rendering.

All drawing targets a matplotlib ``Axes`` so the same code backs the Tk
viewers (TkAgg) and headless tests (Agg).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.storage import frame_from_jsonable
from ..models.params import SimulationResultData, TestCaseResultData

__all__ = [
    "PlaybackState",
    "export_case_images",
    "export_simulation_images",
    "export_stream_images",
    "export_sweep_curves",
    "export_mkid_response",
    "write_gif",
    "render_heatmap",
    "render_line1d",
    "render_mass_trace",
    "render_timeseries",
    "result_frames",
    "select_frame_indices",
]


@dataclass
class PlaybackState:
    """Frame index bookkeeping for play/pause/scrub controls."""

    num_frames: int
    index: int = 0
    playing: bool = False
    loop: bool = True

    def step(self, delta: int = 1) -> int:
        if self.num_frames <= 0:
            return 0
        nxt = self.index + delta
        if self.loop:
            self.index = nxt % self.num_frames
        else:
            self.index = min(max(nxt, 0), self.num_frames - 1)
            if self.index == self.num_frames - 1:
                self.playing = False
        return self.index

    def seek(self, index: int) -> int:
        self.index = min(max(int(index), 0), max(0, self.num_frames - 1))
        return self.index

    def toggle(self) -> bool:
        self.playing = not self.playing
        return self.playing


def result_frames(result: SimulationResultData) -> list[np.ndarray]:
    """Decode a result's NaN-encoded frames into numpy arrays."""
    return [frame_from_jsonable(f) for f in result.frames]


def render_heatmap(ax, frame: np.ndarray, *, clim=None, title: str = "", cmap="inferno"):
    """Draw one NaN-masked 2D frame; returns the image artist."""
    ax.clear()
    img = ax.imshow(frame, origin="lower", cmap=cmap, interpolation="nearest")
    if clim is not None:
        img.set_clim(*clim)
    ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    return img


def render_line1d(ax, case: TestCaseResultData, frame_idx: int):
    """Strip test case: simulated vs analytic profiles at one stored time."""
    ax.clear()
    x = np.asarray(case.x)
    sim = np.asarray(case.simulated[frame_idx], dtype=np.float64)
    ana = np.asarray(case.analytic[frame_idx], dtype=np.float64)
    ax.plot(x, ana, "-", lw=2, label="analytic")
    ax.plot(x, sim, "--", lw=1.5, label="simulated")
    ax.set_xlabel("x [µm]")
    ax.set_ylabel("density")
    ax.set_title(f"{case.title} — t = {case.times[frame_idx]:.4g} ns")
    ax.legend(loc="best")
    return ax


def render_timeseries(ax, case: TestCaseResultData):
    """Collision ODE case: simulated vs analytic n(t)."""
    ax.clear()
    t = np.asarray(case.x)  # timeseries cases store times in x
    sim = np.asarray(case.simulated[0], dtype=np.float64)
    ana = np.asarray(case.analytic[0], dtype=np.float64)
    ax.plot(t, ana, "-", lw=2, label="analytic")
    ax.plot(t, sim, "--", lw=1.5, label="simulated")
    ax.set_xlabel("t [ns]")
    ax.set_ylabel("n")
    ax.set_title(case.title)
    ax.legend(loc="best")
    return ax


def render_mass_trace(ax, result: SimulationResultData):
    """Total QP mass Σn·dx² over the stored times."""
    ax.clear()
    ax.plot(np.asarray(result.times), np.asarray(result.mass_over_time), "-", lw=1.5)
    ax.set_xlabel("t [ns]")
    ax.set_ylabel("total mass")
    ax.set_title(f"{result.setup_name}: mass over time")
    return ax


def select_frame_indices(num_frames: int, spec: str) -> list[int]:
    """Resolve a frame-selection spec against ``num_frames`` stored frames.

    Accepted forms: ``all``, ``last``, ``first``, a comma list of indices
    (negatives count from the end), or a ``start:stop:step`` slice with
    python semantics (any part may be empty).
    """
    spec = (spec or "all").strip()
    if num_frames <= 0:
        return []
    if spec == "all":
        return list(range(num_frames))
    if spec == "last":
        return [num_frames - 1]
    if spec == "first":
        return [0]
    if ":" in spec:
        parts = spec.split(":")
        if len(parts) > 3:
            raise ValueError(f"bad frame slice {spec!r}")
        ints = [int(p) if p.strip() else None for p in parts]
        while len(ints) < 3:
            ints.append(None)
        return list(range(num_frames))[slice(*ints)]
    out = []
    for tok in spec.split(","):
        idx = int(tok)
        if idx < 0:
            idx += num_frames
        if not 0 <= idx < num_frames:
            raise ValueError(f"frame index {tok} out of range (0..{num_frames - 1})")
        out.append(idx)
    return out


def export_simulation_images(
    result: SimulationResultData,
    out_dir,
    *,
    frames: str = "all",
    phonons: bool = False,
    energy_bin: int | None = None,
    mass: bool = True,
    cmap: str = "inferno",
    dpi: int = 110,
) -> list:
    """Render a saved simulation to PNG files — the headless counterpart of
    the Tk viewers (SimulationViewer / PhononViewer playback windows).

    Writes ``frame_NNNN.png`` per selected stored frame (color scale fixed
    to the run's ``color_limits``, like the GUI viewer), optionally
    ``phonon_NNNN.png`` (energy-integrated phonon frames), optionally
    ``bin<B>_NNNN.png`` (one energy bin's spectral density from
    ``energy_frames``), and ``mass.png``. Returns the written paths.

    Uses matplotlib's object API directly (no pyplot, no backend state), so
    it works on displayless hosts.
    """
    from pathlib import Path

    from matplotlib.figure import Figure

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written: list = []

    def _save(draw, path):
        fig = Figure(figsize=(6.0, 4.8))
        draw(fig.add_subplot(111))
        fig.savefig(path, dpi=dpi, bbox_inches="tight")
        written.append(path)

    idxs = select_frame_indices(len(result.frames), frames)
    clim = tuple(result.color_limits) if result.color_limits else None
    decoded = result_frames(result)
    for i in idxs:
        title = f"t = {result.times[i]:.6g} ns"
        _save(
            lambda ax, f=decoded[i], t=title: render_heatmap(
                ax, f, clim=clim, title=t, cmap=cmap
            ),
            out / f"frame_{i:04d}.png",
        )

    if energy_bin is not None:
        if not result.energy_frames:
            raise ValueError("simulation stores no energy-resolved frames")
        nbins = len(result.energy_frames[0])
        if not 0 <= energy_bin < nbins:
            raise ValueError(f"energy bin {energy_bin} out of range (0..{nbins - 1})")
        e_label = (
            f"E = {result.energy_bins[energy_bin]:.4g} µeV"
            if result.energy_bins
            else f"bin {energy_bin}"
        )
        for i in idxs:
            fr = frame_from_jsonable(result.energy_frames[i][energy_bin])
            _save(
                lambda ax, f=fr, t=f"{e_label}, t = {result.times[i]:.6g} ns": render_heatmap(
                    ax, f, title=t, cmap=cmap
                ),
                out / f"bin{energy_bin}_{i:04d}.png",
            )

    if phonons:
        if not result.phonon_frames:
            raise ValueError("simulation stores no phonon frames")
        ph_idxs = select_frame_indices(len(result.phonon_frames), frames)
        for i in ph_idxs:
            fr = frame_from_jsonable(result.phonon_frames[i])
            _save(
                lambda ax, f=fr, t=f"phonons, t = {result.times[i]:.6g} ns": render_heatmap(
                    ax, f, title=t, cmap="viridis"
                ),
                out / f"phonon_{i:04d}.png",
            )

    if mass:
        _save(lambda ax: render_mass_trace(ax, result), out / "mass.png")
    return written


def export_stream_images(
    reader,
    out_dir,
    *,
    frames: str = "all",
    phonons: bool = False,
    energy_bin: int | None = None,
    mass: bool = True,
    cmap: str = "inferno",
    dpi: int = 110,
) -> list:
    """Render a streamed-frames directory to PNGs, one shard at a time.

    The lazy counterpart of :func:`export_simulation_images` for
    ``FrameStreamReader``: streams exist precisely because the run's
    history exceeds host RAM, so this never materializes more than the
    single array being drawn (and shard members decompress individually —
    rendering integrated frames never touches the per-bin stacks).
    """
    from pathlib import Path

    from matplotlib.figure import Figure

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written: list = []

    def _save(draw, path):
        fig = Figure(figsize=(6.0, 4.8))
        draw(fig.add_subplot(111))
        fig.savefig(path, dpi=dpi, bbox_inches="tight")
        written.append(path)

    idxs = select_frame_indices(reader.count, frames)
    clim = tuple(reader.color_limits) if reader.color_limits else None
    for i in idxs:
        fr = reader.frame(i)
        title = f"t = {reader.times[i]:.6g} ns"
        _save(
            lambda ax, f=fr, t=title: render_heatmap(ax, f, clim=clim, title=t, cmap=cmap),
            out / f"frame_{i:04d}.png",
        )

    if energy_bin is not None:
        if not reader.has_energy_frames:
            raise ValueError(
                "stream stores no per-bin energy frames (a light "
                "snapshot_detail='integrated' run keeps per-bin sums only)"
            )
        e_bins = reader.energy_bins
        for i in idxs:
            ef = reader.energy_frames(i)
            nbins = ef.shape[0]
            if not 0 <= energy_bin < nbins:
                raise ValueError(f"energy bin {energy_bin} out of range (0..{nbins - 1})")
            e_label = (
                f"E = {e_bins[energy_bin]:.4g} µeV" if e_bins is not None else f"bin {energy_bin}"
            )
            _save(
                lambda ax, f=ef[energy_bin], t=f"{e_label}, t = {reader.times[i]:.6g} ns": (
                    render_heatmap(ax, f, title=t, cmap=cmap)
                ),
                out / f"bin{energy_bin}_{i:04d}.png",
            )

    if phonons:
        if not reader.has_phonon_frames:
            raise ValueError("stream stores no phonon frames")
        for i in idxs:
            pf = reader.phonon_frame(i)
            if pf is None:
                continue
            _save(
                lambda ax, f=pf, t=f"phonons, t = {reader.times[i]:.6g} ns": render_heatmap(
                    ax, f, title=t, cmap="viridis"
                ),
                out / f"phonon_{i:04d}.png",
            )

    if mass:
        name = str(reader.metadata.get("setup_name", reader.directory.name))

        def _mass(ax):
            ax.clear()
            ax.plot(np.asarray(reader.times), np.asarray(reader.mass_over_time), "-", lw=1.5)
            ax.set_xlabel("t [ns]")
            ax.set_ylabel("total mass")
            ax.set_title(f"{name}: mass over time")

        _save(_mass, out / "mass.png")
    return written



def export_sweep_curves(summary: dict, out_dir, *, dpi: int = 110) -> list:
    """Render calibration curves from a ``sweep_summary.json`` payload.

    One PNG per observable (``mass_final``, ``mass_peak``, the decay ratio
    final/peak, and the energy finals when present): x = the FIRST vary
    axis, one line per combination of the remaining axes, failed variants
    skipped.  Matches the plotting conventions of the other exporters
    (``render_mass_trace`` style); the sweep machinery itself lives in
    :mod:`qpsim_tpu_torch.sweep`.
    """
    from pathlib import Path

    from matplotlib.figure import Figure

    axes_spec = summary.get("axes") or []
    if not axes_spec:
        raise ValueError("sweep summary has no axes to plot against.")
    x_field = axes_spec[0]["field"]
    other_fields = [a["field"] for a in axes_spec[1:]]
    ok = [v for v in summary.get("variants", []) if "error" not in v]
    if not ok:
        raise ValueError("sweep summary has no successful variants to plot.")

    series: dict[tuple, list] = {}
    for rec in ok:
        key = tuple(rec["overrides"].get(f) for f in other_fields)
        series.setdefault(key, []).append(rec)
    for recs in series.values():
        recs.sort(key=lambda r: r["overrides"][x_field])

    def values(recs, obs):
        xs = [r["overrides"][x_field] for r in recs]
        if obs == "decay_ratio":
            ys = [
                r["mass_final"] / r["mass_peak"] if r.get("mass_peak") else None
                for r in recs
            ]
        else:
            ys = [r.get(obs) for r in recs]
        pairs = [(x, y) for x, y in zip(xs, ys) if y is not None]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    observables = ["mass_final", "mass_peak", "decay_ratio",
                   "energy_qp_final", "energy_phonon_final"]
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written: list = []
    name = summary.get("setup_name", "sweep")
    for obs in observables:
        any_points = False
        fig = Figure(figsize=(6.0, 4.2))
        ax = fig.add_subplot(111)
        for key, recs in sorted(series.items()):
            xs, ys = values(recs, obs)
            if not xs:
                continue
            any_points = True
            label = ", ".join(
                f"{f.split('.')[-1]}={v:g}" if isinstance(v, float) else f"{f.split('.')[-1]}={v}"
                for f, v in zip(other_fields, key)
            )
            ax.plot(xs, ys, "o-", lw=1.5, label=label or None)
        if not any_points:
            continue
        ax.set_xlabel(x_field)
        ax.set_ylabel(obs.replace("_", " "))
        ax.set_title(f"{name}: {obs.replace('_', ' ')} vs {x_field}")
        if len(series) > 1:
            ax.legend(fontsize=8)
        path = out / f"sweep_{obs}.png"
        fig.savefig(path, dpi=dpi, bbox_inches="tight")
        written.append(path)
    return written


def export_mkid_response(times, response: dict, out_dir, *, dpi: int = 110):
    """Render a Mattis–Bardeen response trace (δf/f and δ(1/Q) vs time)
    to ``mkid_response.png``; ``response`` is
    :func:`qpsim_tpu_torch.observables.mkid_response_trace` output."""
    from pathlib import Path

    from matplotlib.figure import Figure

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    fig = Figure(figsize=(6.4, 5.6))
    ax1 = fig.add_subplot(211)
    ax1.plot(np.asarray(times), np.asarray(response["df_over_f"]), "-", lw=1.5)
    ax1.set_ylabel("δf / f")
    ax1.set_title("resonator readout response")
    ax2 = fig.add_subplot(212, sharex=ax1)
    ax2.plot(np.asarray(times), np.asarray(response["dQ_inv"]), "-", lw=1.5, color="tab:red")
    ax2.set_xlabel("t [ns]")
    ax2.set_ylabel("δ(1/Q)")
    path = out / "mkid_response.png"
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    return path

def write_gif(image_paths, out_path, *, fps: float = 8.0):
    """Assemble already-rendered PNGs into a looping animated GIF."""
    from pathlib import Path

    from PIL import Image

    paths = [Path(p) for p in image_paths]
    if not paths:
        raise ValueError("no frames to animate")
    frames = [Image.open(p).convert("P", palette=Image.ADAPTIVE) for p in paths]
    out_path = Path(out_path)
    frames[0].save(
        out_path,
        save_all=True,
        append_images=frames[1:],
        duration=max(1, int(round(1000.0 / fps))),
        loop=0,
    )
    return out_path


def export_case_images(
    case: TestCaseResultData,
    out_dir,
    *,
    frames: str = "all",
    dpi: int = 110,
) -> list:
    """Render one analytic test case to PNGs — headless counterpart of the
    suite case viewers.  Dispatches on the case's ``view_mode`` metadata:
    ``timeseries`` writes a single n(t) comparison, ``heatmap2d`` writes
    per-frame simulated|analytic panel pairs on a shared color scale (the
    reference's HeatmapTestSuiteViewer layout, main_app.py:754-757), and
    ``line1d`` (default) writes per-frame profile comparisons."""
    from pathlib import Path

    from matplotlib.figure import Figure

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written: list = []
    view_mode = str(case.metadata.get("view_mode", "line1d"))

    if view_mode == "timeseries":
        fig = Figure(figsize=(6.0, 4.8))
        render_timeseries(fig.add_subplot(111), case)
        path = out / "timeseries.png"
        fig.savefig(path, dpi=dpi, bbox_inches="tight")
        return [path]

    idxs = select_frame_indices(len(case.times), frames)
    if view_mode == "heatmap2d":
        sim_frames = [frame_from_jsonable(case.simulated[i]) for i in idxs]
        ana_frames = [frame_from_jsonable(case.analytic[i]) for i in idxs]
        finite = [f[np.isfinite(f)] for f in (*sim_frames, *ana_frames)]
        finite = [f for f in finite if f.size]
        vals = np.concatenate(finite) if finite else np.zeros(0)
        clim = (float(vals.min()), float(vals.max())) if vals.size else None
        for k, i in enumerate(idxs):
            fig = Figure(figsize=(9.6, 4.2))
            t = f"t = {case.times[i]:.4g} ns"
            render_heatmap(fig.add_subplot(121), sim_frames[k], clim=clim,
                           title=f"simulated — {t}")
            render_heatmap(fig.add_subplot(122), ana_frames[k], clim=clim,
                           title=f"analytic — {t}")
            path = out / f"frame_{i:04d}.png"
            fig.savefig(path, dpi=dpi, bbox_inches="tight")
            written.append(path)
        return written

    for i in idxs:
        fig = Figure(figsize=(6.0, 4.8))
        render_line1d(fig.add_subplot(111), case, i)
        path = out / f"frame_{i:04d}.png"
        fig.savefig(path, dpi=dpi, bbox_inches="tight")
        written.append(path)
    return written
