"""qpsim_tpu_torch — the PyTorch/CUDA port of ``qpsim_tpu`` for NVIDIA Hopper.

Nonequilibrium quasiparticle and phonon kinetics in superconducting thin
films (Fischer–Catelani collisions, Crank–Nicolson diffusion), with the
hot substeps on hand-written CUDA kernels (``csrc/``) built at first use.
The JAX package ``qpsim_tpu`` stays beside it as the reference; this
package imports neither it nor JAX.

Public entry point: :func:`run_2d_crank_nicolson` (energy-resolved and
scalar branches).
"""

from .solver.engine import run_2d_crank_nicolson

__all__ = ["run_2d_crank_nicolson"]
