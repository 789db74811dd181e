"""Bounded-memory streaming of stored simulation frames.

Carried over from ``qpsim_tpu.io.stream`` with the same on-disk format, so
that either package reads the other's stream.  A run hands each stored
snapshot to a :class:`FrameStreamWriter` the moment it is pulled off the
device (``run_2d_crank_nicolson(frame_sink=...)``); the writer persists it
as one compressed NPZ shard, and nothing per-frame stays in memory.  At a
1024² grid × 16 energy bins stored every 10 steps over 10 k steps an
in-memory history would hold ~128 GB.

On-disk layout::

    <dir>/manifest.json       index: times, mass, color limits, bins
    <dir>/frame_000000.npz    one stored snapshot per shard
    <dir>/frame_000001.npz
    ...

Writes are atomic (tempfile + rename) and idempotent per index —
checkpoint-resumed runs rewrite their replayed snapshots bit-identically.
The manifest is only written by :meth:`FrameStreamWriter.finalize`, so a
missing manifest marks an interrupted stream; :class:`FrameStreamReader`
refuses it with a clear error.

The engine-facing protocol is a single duck-typed method — any object
with the same ``write`` signature can be passed as ``frame_sink``.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Any, Sequence

import numpy as np

__all__ = [
    "FrameStreamWriter",
    "FrameStreamReader",
    "load_frame_stream",
    "estimate_history_memory",
    "widen_color_limits",
]


def widen_color_limits(vmin: float, vmax: float) -> list[float]:
    """[vmin, vmax] with degenerate (constant-field) ranges nudged open.

    The one definition of the viewer color-limit contract in this package —
    the engine's returned ``color_limits`` and the stream manifest's must
    stay bit-identical, so both compute theirs here.
    """
    if abs(vmax - vmin) < 1e-12:
        vmax = vmin + 1e-9
    return [float(vmin), float(vmax)]


_MANIFEST = "manifest.json"
_SHARD_FMT = "frame_{:06d}.npz"
_VERSION = 1


def _shard_path(directory: Path, index: int) -> Path:
    return directory / _SHARD_FMT.format(index)


class FrameStreamWriter:
    """Persist stored snapshots one NPZ shard at a time.

    Parameters
    ----------
    directory:
        Target directory (created if missing).  A pre-existing manifest is
        deleted immediately — reusing a finalized stream directory makes it
        visibly unfinalized again until this run's :meth:`finalize`, so a
        reader can never mix two runs' shards.  Pre-existing shards are
        overwritten index-by-index (checkpoint-resumed runs replay
        bit-identically); stale higher-index shards from an earlier,
        longer run are deleted by :meth:`finalize`.
    energy_bins / phonon_energy_bins:
        Optional bin-center arrays recorded in the manifest.  Phonon
        bins are usually only known after the engine builds its ω-grid;
        pass them to :meth:`finalize` instead in that case.
    metadata:
        Free-form JSON-serializable dict stored in the manifest.
    """

    def __init__(
        self,
        directory: str | Path,
        *,
        energy_bins: np.ndarray | None = None,
        phonon_energy_bins: np.ndarray | None = None,
        metadata: dict[str, Any] | None = None,
    ) -> None:
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        # a stream being (re)written is not valid to read: drop any manifest
        # left by an earlier finalized run NOW, so an interrupted rerun can
        # never be mistaken for the previous run's complete stream
        (self.directory / _MANIFEST).unlink(missing_ok=True)
        self._energy_bins = None if energy_bins is None else np.asarray(energy_bins, np.float64)
        self._phonon_bins = (
            None if phonon_energy_bins is None else np.asarray(phonon_energy_bins, np.float64)
        )
        self._metadata = dict(metadata or {})
        self._times: dict[int, float] = {}
        self._mass: dict[int, float] = {}
        self._vmin = math.inf
        self._vmax = -math.inf
        self._has_energy = False
        self._has_phonons = False
        self._finalized = False

    # -- engine-facing protocol ------------------------------------------------

    def write(
        self,
        index: int,
        time_ns: float,
        *,
        frame: np.ndarray,
        mass: float,
        energy_frames: Sequence[np.ndarray] | None = None,
        phonon_frame: np.ndarray | None = None,
        phonon_energy_frames: Sequence[np.ndarray] | None = None,
        energy_bin_sums: np.ndarray | None = None,
        phonon_bin_sums: np.ndarray | None = None,
    ) -> None:
        """Persist one stored snapshot as ``frame_<index>.npz``.

        ``frame`` is the NaN-padded energy-integrated 2D field; per-bin
        QP/phonon histories arrive as sequences of 2D fields and are
        stacked to ``(n_bins, ny, nx)`` on disk.  Light
        (``snapshot_detail="integrated"``) runs send per-bin pixel-sum
        VECTORS (``energy_bin_sums``/``phonon_bin_sums``) instead of
        per-bin frames — enough for energy bookkeeping at a millionth of
        the bytes.
        """
        if self._finalized:
            raise ValueError("FrameStreamWriter is finalized; no further writes allowed.")
        index = int(index)
        frame = np.asarray(frame, dtype=np.float64)
        arrays: dict[str, np.ndarray] = {
            "time_ns": np.float64(time_ns),
            "frame": frame,
            "mass": np.float64(mass),
        }
        if energy_frames is not None:
            arrays["energy_frames"] = np.stack(
                [np.asarray(f, np.float64) for f in energy_frames]
            )
            self._has_energy = True
        if phonon_frame is not None:
            arrays["phonon_frame"] = np.asarray(phonon_frame, np.float64)
            self._has_phonons = True
        if phonon_energy_frames is not None:
            arrays["phonon_energy_frames"] = np.stack(
                [np.asarray(f, np.float64) for f in phonon_energy_frames]
            )
            self._has_phonons = True
        if energy_bin_sums is not None:
            arrays["energy_bin_sums"] = np.asarray(energy_bin_sums, np.float64)
        if phonon_bin_sums is not None:
            arrays["phonon_bin_sums"] = np.asarray(phonon_bin_sums, np.float64)
        dest = _shard_path(self.directory, index)
        tmp = dest.with_suffix(".npz.tmp")
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **arrays)
        os.replace(tmp, dest)  # atomic: readers never see a torn shard
        self._times[index] = float(time_ns)
        self._mass[index] = float(mass)
        lo, hi = float(np.nanmin(frame)), float(np.nanmax(frame))
        self._vmin = min(self._vmin, lo)
        self._vmax = max(self._vmax, hi)

    # -- lifecycle ----------------------------------------------------------------

    def color_limits(self) -> list[float]:
        """Running [vmin, vmax] over every written integrated frame."""
        if not self._times:
            raise ValueError("No frames written yet.")
        return widen_color_limits(self._vmin, self._vmax)

    def finalize(
        self,
        *,
        phonon_energy_bins: np.ndarray | None = None,
        extra_metadata: dict[str, Any] | None = None,
    ) -> Path:
        """Write the manifest and seal the stream.  Returns the directory."""
        if self._finalized:
            return self.directory
        if not self._times:
            raise ValueError("Cannot finalize an empty frame stream (no frames written).")
        count = len(self._times)
        if sorted(self._times) != list(range(count)):
            missing = sorted(set(range(max(self._times) + 1)) - set(self._times))
            raise ValueError(
                f"Frame stream has non-contiguous indices (missing {missing[:8]}"
                f"{'...' if len(missing) > 8 else ''}); refusing to write a manifest."
            )
        if phonon_energy_bins is not None:
            self._phonon_bins = np.asarray(phonon_energy_bins, np.float64)
        if extra_metadata:
            self._metadata.update(extra_metadata)
        # drop stale higher-index shards from an earlier, longer run into
        # the same directory — the sealed stream is exactly [0, count)
        for path in self.directory.glob("frame_*.npz"):
            try:
                idx = int(path.stem.split("_")[1])
            except (IndexError, ValueError):
                continue
            if idx >= count:
                path.unlink(missing_ok=True)
        manifest = {
            "format": "qpsim_tpu.frame_stream",
            "version": _VERSION,
            "count": count,
            "times": [self._times[i] for i in range(count)],
            "mass_over_time": [self._mass[i] for i in range(count)],
            "color_limits": self.color_limits(),
            "has_energy_frames": self._has_energy,
            "has_phonon_frames": self._has_phonons,
            "energy_bins": None if self._energy_bins is None else self._energy_bins.tolist(),
            "phonon_energy_bins": (
                None if self._phonon_bins is None else self._phonon_bins.tolist()
            ),
            "metadata": self._metadata,
        }
        tmp = self.directory / (_MANIFEST + ".tmp")
        tmp.write_text(json.dumps(manifest, indent=1))
        os.replace(tmp, self.directory / _MANIFEST)
        self._finalized = True
        return self.directory

    def __enter__(self) -> "FrameStreamWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # only seal clean exits: an exception mid-run must leave the stream
        # visibly interrupted (no manifest) rather than silently truncated
        if exc_type is None and self._times:
            self.finalize()


class FrameStreamReader:
    """Lazy reader over a finalized frame-stream directory.

    Manifest fields (times, mass, color limits, bins) load eagerly —
    they are tiny; per-frame arrays load from their shard on access.
    """

    def __init__(self, directory: str | Path) -> None:
        self.directory = Path(directory)
        manifest_path = self.directory / _MANIFEST
        if not manifest_path.is_file():
            raise ValueError(
                f"'{self.directory}' is not a finalized frame stream (no {_MANIFEST} — "
                "the producing run may have been interrupted before finalize())."
            )
        try:
            manifest = json.loads(manifest_path.read_text())
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            raise ValueError(f"Frame-stream manifest '{manifest_path}' is damaged: {exc}")
        if manifest.get("format") != "qpsim_tpu.frame_stream":
            raise ValueError(f"'{manifest_path}' is not a qpsim_tpu frame-stream manifest.")
        if int(manifest.get("version", -1)) > _VERSION:
            raise ValueError(
                f"Frame stream '{self.directory}' uses format version "
                f"{manifest['version']}; this build reads up to {_VERSION}."
            )
        self.count = int(manifest["count"])
        self.times: list[float] = [float(t) for t in manifest["times"]]
        self.mass_over_time: list[float] = [float(m) for m in manifest["mass_over_time"]]
        self.color_limits: list[float] = [float(v) for v in manifest["color_limits"]]
        eb = manifest.get("energy_bins")
        self.energy_bins = None if eb is None else np.asarray(eb, np.float64)
        pb = manifest.get("phonon_energy_bins")
        self.phonon_energy_bins = None if pb is None else np.asarray(pb, np.float64)
        self.has_energy_frames = bool(manifest.get("has_energy_frames"))
        self.has_phonon_frames = bool(manifest.get("has_phonon_frames"))
        self.metadata: dict[str, Any] = dict(manifest.get("metadata") or {})

    def __len__(self) -> int:
        return self.count

    def _load(
        self, index: int, keys: tuple[str, ...] | None = None
    ) -> dict[str, np.ndarray]:
        """Load one shard — only ``keys`` when given.

        NPZ members decompress individually, so asking for just ``frame``
        skips the (n_bins, ny, nx) stacks entirely: at 1024²×16 that is
        ~NE× less decompression and peak memory per accessed snapshot.
        """
        if not 0 <= index < self.count:
            raise IndexError(f"frame index {index} out of range [0, {self.count}).")
        path = _shard_path(self.directory, index)
        try:
            with np.load(path) as data:
                names = data.files if keys is None else [k for k in keys if k in data.files]
                return {k: np.asarray(data[k]) for k in names}
        except FileNotFoundError:
            raise ValueError(f"Frame stream '{self.directory}' is missing shard '{path.name}'.")
        except Exception as exc:  # truncated zip etc. (zipfile.BadZipFile)
            raise ValueError(f"Frame-stream shard '{path}' is damaged: {exc}")

    def frame(self, index: int) -> np.ndarray:
        """NaN-padded energy-integrated 2D field of stored snapshot `index`."""
        return self._load(index, ("frame",))["frame"]

    def energy_frames(self, index: int) -> np.ndarray | None:
        """(NE, ny, nx) per-bin QP fields, or None if not recorded."""
        return self._load(index, ("energy_frames",)).get("energy_frames")

    def phonon_frame(self, index: int) -> np.ndarray | None:
        return self._load(index, ("phonon_frame",)).get("phonon_frame")

    def phonon_energy_frames(self, index: int) -> np.ndarray | None:
        return self._load(index, ("phonon_energy_frames",)).get("phonon_energy_frames")

    def energy_bin_sums(self, index: int) -> np.ndarray | None:
        """(NE,) per-bin pixel sums (light-snapshot runs), or None."""
        return self._load(index, ("energy_bin_sums",)).get("energy_bin_sums")

    def phonon_bin_sums(self, index: int) -> np.ndarray | None:
        """(nω,) per-bin pixel sums (light-snapshot runs), or None."""
        return self._load(index, ("phonon_bin_sums",)).get("phonon_bin_sums")

    def iter_frames(self):
        """Yield (time_ns, integrated 2D frame) pairs, one shard in memory at a time."""
        for i in range(self.count):
            yield self.times[i], self.frame(i)

    def to_result_data(self, *, include_energy_frames: bool = True, include_phonons: bool = True):
        """Materialize the full stream as a :class:`SimulationResultData`.

        Loads EVERY shard into memory — intended for viewing/export of
        streams that fit in RAM; use the lazy accessors for larger ones.
        """
        from ..models.params import SimulationResultData, utc_now_iso
        from .storage import frame_to_jsonable

        frames = []
        energy_frames: list[list] | None = (
            [] if (include_energy_frames and self.has_energy_frames) else None
        )
        phonon_frames: list | None = (
            [] if (include_phonons and self.has_phonon_frames) else None
        )
        phonon_energy_frames: list[list] | None = (
            [] if (include_phonons and self.has_phonon_frames) else None
        )
        for i in range(self.count):
            shard = self._load(i)
            frames.append(frame_to_jsonable(shard["frame"]))
            if energy_frames is not None:
                ef = shard.get("energy_frames")
                if ef is None:
                    raise ValueError(
                        f"Frame stream shard {i} lacks energy_frames but the "
                        "manifest promises them."
                    )
                energy_frames.append([frame_to_jsonable(ef[b]) for b in range(ef.shape[0])])
            if phonon_frames is not None:
                pf = shard.get("phonon_frame")
                if pf is not None:
                    phonon_frames.append(frame_to_jsonable(pf))
                pef = shard.get("phonon_energy_frames")
                if pef is not None:
                    phonon_energy_frames.append(
                        [frame_to_jsonable(pef[b]) for b in range(pef.shape[0])]
                    )
        meta = dict(self.metadata)
        meta.setdefault("streamed_frames_dir", str(self.directory))
        return SimulationResultData(
            simulation_id=str(meta.get("simulation_id", f"stream-{self.directory.name}")),
            setup_id=str(meta.get("setup_id", "")),
            setup_name=str(meta.get("setup_name", self.directory.name)),
            created_at=str(meta.get("created_at", utc_now_iso())),
            times=list(self.times),
            frames=frames,
            mass_over_time=list(self.mass_over_time),
            color_limits=list(self.color_limits),
            metadata=meta,
            energy_frames=energy_frames,
            energy_bins=None if self.energy_bins is None else self.energy_bins.tolist(),
            phonon_frames=phonon_frames or None,
            phonon_energy_frames=phonon_energy_frames or None,
            phonon_energy_bins=(
                None if self.phonon_energy_bins is None else self.phonon_energy_bins.tolist()
            ),
            phonon_metadata=meta.get("phonon_metadata"),
        )


def load_frame_stream(directory: str | Path) -> FrameStreamReader:
    """Open a finalized frame-stream directory for reading."""
    return FrameStreamReader(directory)


def estimate_history_memory(
    *,
    grid_shape: tuple[int, int],
    dt: float,
    total_time: float,
    store_every: int,
    num_energy_bins: int = 0,
    record_phonons: bool = False,
) -> int:
    """Bytes of host RAM an in-memory (non-streamed) run's history needs.

    Counts the dense f64 per-snapshot artifacts the engine accumulates:
    the integrated 2D frame, per-bin QP fields (energy-resolved mode) and
    — when phonon history is recorded — per-ω phonon fields, whose bin
    count for the uniform energy grid is ≤ 3·NE − 1 (NE distinct |Eᵢ−Eⱼ|
    values + 2·NE−1 distinct sums; ``solver.py`` builds the exact grid).
    The companion to :func:`qpsim_tpu_torch.io.precompute.estimate_precompute_memory`:
    it says when a run needs ``stream_dir`` to fit in host memory.
    """
    ny, nx = grid_shape
    steps = max(1, int(round(float(total_time) / float(dt))))
    n_stored = steps // max(1, int(store_every)) + 2  # t=0 + forced final
    per_snapshot = ny * nx * 8  # integrated frame
    if num_energy_bins > 0:
        per_snapshot += num_energy_bins * ny * nx * 8
        if record_phonons:
            n_omega = 3 * num_energy_bins - 1
            per_snapshot += (n_omega + 1) * ny * nx * 8
    return n_stored * per_snapshot
