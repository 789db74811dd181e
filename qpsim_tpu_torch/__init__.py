"""qpsim_tpu_torch — the PyTorch/CUDA port of ``qpsim_tpu`` for NVIDIA Hopper.

Nonequilibrium quasiparticle and phonon kinetics in superconducting thin
films (Fischer–Catelani collisions, Crank–Nicolson diffusion), with the
hot substeps on hand-written CUDA kernels (``csrc/``) built at first use.
The JAX package ``qpsim_tpu`` stays beside it as the reference; this
package imports neither it nor JAX.

Public entry points: :func:`run_2d_crank_nicolson` (energy-resolved and
scalar branches), :func:`run_setup` (a setup file's run, streamed,
checkpointed and saved), :func:`generate_test_suite` (the 28 analytic
cases), :func:`run_fast_validation_suite` (the physics gates), and the
file helpers :func:`load_setup`, :func:`save_setup` and
:func:`load_simulation` — all on ``device="cuda"`` by default.  The
command line is ``python -m qpsim_tpu_torch <command>`` (:mod:`.cli`), the
GUI ``python -m qpsim_tpu_torch.ui.main_app``.
"""

__version__ = "0.1.0"

from .io.storage import load_setup, load_simulation, save_setup
from .runner import run_setup
from .solver.engine import run_2d_crank_nicolson
from .testcases.generator import generate_test_suite
from .validation import ValidationReport, run_fast_validation_suite

__all__ = [
    "__version__",
    "ValidationReport",
    "generate_test_suite",
    "load_setup",
    "load_simulation",
    "run_2d_crank_nicolson",
    "run_fast_validation_suite",
    "run_setup",
    "save_setup",
]
