"""The card's memory peak, its name and power limit, and the bytes a simulated step must move.

The peak is the NVIDIA H100 SXM data sheet's HBM rate at its full power
limit of 700 W; every run records the card's own limit beside it
(:func:`card`).  A bound is the bytes of the state that a piece of work
must read and write, each once, over that rate, from the number of energy
bins NE, of phonon bins NW and of film cells alone, whatever tables,
planes or packs an implementation keeps besides:

* one collision substep of dt: q (NE planes) and n_ph (NW planes);
* one diffusion step (two ADI halves): q;
* one whole simulated step: q and n_ph, however the program merges or
  fuses its substeps.

No operation count enters a bound: the least number of operations is not
known (the collision pair sums take O(NE²) operations a cell summed
directly and O(NE log NE) as the plain reference's FFT convolutions), and
a count above the least would let a cheaper form read above 100 %.
"""

from __future__ import annotations

import subprocess

#: H100 SXM data sheet: HBM bytes/s
HBM_BYTES_PER_S = 3.35e12


def card(index: int = 0) -> dict:
    """The card's name (``get_device_properties``) and power limit (``nvidia-smi``)."""
    import torch

    out = {"name": torch.cuda.get_device_properties(index).name, "power_limit_w": None}
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
        out["nvidia_smi"] = line
        out["power_limit_w"] = float(line.rsplit(",", 1)[-1].split()[0])
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        pass
    return out


def bound_s(n_bytes: float) -> float:
    """The least time the card could take to move ``n_bytes`` through its memory."""
    return n_bytes / HBM_BYTES_PER_S


def state_bytes(planes: int, cells: int, elem_bytes: int) -> int:
    """Bytes of ``planes`` planes of the film's cells, read once and written once."""
    return 2 * planes * cells * elem_bytes
