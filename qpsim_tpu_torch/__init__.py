"""qpsim_tpu_torch — the PyTorch/CUDA port of ``qpsim_tpu`` for NVIDIA Hopper.

Nonequilibrium quasiparticle and phonon kinetics in superconducting thin
films (Fischer–Catelani collisions, Crank–Nicolson diffusion), with the
hot substeps on hand-written CUDA kernels (``csrc/``) built at first use.
The JAX package ``qpsim_tpu`` stays beside it as the reference; this
package imports neither it nor JAX.

Public entry points: :func:`run_2d_crank_nicolson` (energy-resolved and
scalar branches) and :func:`run_fast_validation_suite` (the physics
gates, ``device="cuda"`` by default).
"""

from .validation import ValidationReport, run_fast_validation_suite
from .solver.engine import run_2d_crank_nicolson

__all__ = ["ValidationReport", "run_fast_validation_suite", "run_2d_crank_nicolson"]
