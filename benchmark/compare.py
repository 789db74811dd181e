"""The numbers that decide ``correct``: a kept job of the window against its plain reference.

Each is the widest gap over the job's stored snapshots, relative to the
reference:

* ``frames`` — the energy-integrated density, max over the film's cells
  of |program − reference| over the reference frame's largest value;
* ``mass`` — the film's quasiparticle number, |program − reference| over
  the reference's;
* ``phonons`` — the phonon frame's change since t = 0 (what the
  collisions added to the bath's occupation), max over the cells of the
  gap, over the largest change the reference shows in the job.

The reference may follow the job's first steps only: the job's snapshots
are compared as far as the reference's go.  A job whose snapshots fall at
other times than the reference's, or a number that is not finite, reads
infinity.
"""

from __future__ import annotations

import math

import numpy as np

NAMES = ("frames", "mass", "phonons")


def compare(prog: dict, ref: dict, mask: np.ndarray) -> dict[str, float]:
    inf = {name: math.inf for name in NAMES}
    n = len(ref["times"])
    if len(prog["times"]) < n or not np.allclose(prog["times"][:n], ref["times"], rtol=0, atol=1e-9):
        return inf
    prog = {key: prog[key][:n] for key in ("times", "frames", "mass", "phonon_frames")}
    frames = max(
        float(np.max(np.abs(fp[mask] - fr[mask])) / np.max(np.abs(fr[mask])))
        for fp, fr in zip(prog["frames"], ref["frames"])
    )
    mass = max(abs(mp - mr) / abs(mr) for mp, mr in zip(prog["mass"], ref["mass"]))
    p0, r0 = prog["phonon_frames"][0][mask], ref["phonon_frames"][0][mask]
    scale = max(float(np.max(np.abs(r[mask] - r0))) for r in ref["phonon_frames"])
    gap = max(
        float(np.max(np.abs((p[mask] - p0) - (r[mask] - r0))))
        for p, r in zip(prog["phonon_frames"], ref["phonon_frames"])
    )
    phonons = gap / scale if scale > 0 else (0.0 if gap == 0 else math.inf)
    out = {"frames": frames, "mass": float(mass), "phonons": phonons}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}
