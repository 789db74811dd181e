"""The port's entry points (``qpsim_tpu_torch.graft_entry``) against ``__graft_entry__``.

``entry()``'s one step on the CPU (the kernels' plain versions) is held to
the JAX package's ``entry()`` on JAX-CPU, both float32 at 256² × 16, to
1e-5 scaled; ``dryrun_multichip(n, device="cpu")`` runs in a fresh
interpreter with no test configuration, as the JAX dry run is called.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import __graft_entry__  # noqa: E402

from qpsim_tpu_torch import graft_entry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scaled(got, ref) -> float:
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def test_entry_step_matches_the_jax_entry_in_float32():
    import jax

    j_fn, j_args = __graft_entry__.entry()
    j_q, j_ph = jax.jit(j_fn)(*j_args)
    fn, (q0, ph0) = graft_entry.entry(device="cpu")
    assert q0.dtype == ph0.dtype == torch.float32
    assert tuple(q0.shape) == (16, 256, 256) and tuple(ph0.shape) == tuple(j_args[1].shape)
    # the same state from the same seed, rounded to float32 by both packages
    assert np.array_equal(q0.numpy(), np.asarray(j_args[0]))
    assert np.array_equal(ph0.numpy(), np.asarray(j_args[1]))
    q, ph = fn(q0, ph0)
    assert _scaled(q.numpy(), j_q) <= 1e-5
    assert _scaled(ph.numpy(), j_ph) <= 1e-5
    # fn.plain is the step on the kernels' plain versions: on the CPU, fn itself
    qp, php = fn.plain(q0, ph0)
    assert torch.equal(qp, q) and torch.equal(php, ph)


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip_clean_interpreter(n):
    """``dryrun_multichip(n, device="cpu")`` in a fresh interpreter: 8 cells
    (2 ensemble groups × 4 shards) and 3 (space only)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)  # the CPU cells repeat to n without JAX's forced device count
    proc = subprocess.run(
        [sys.executable, "-c",
         f"from qpsim_tpu_torch import graft_entry; graft_entry.dryrun_multichip({n}, device='cpu'); print('OK')"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    assert "OK" in proc.stdout


def test_module_main_runs_both_entry_points():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "qpsim_tpu_torch.graft_entry", "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "entry() ok: [(16, 256, 256), (47, 256, 256)]" in proc.stdout
    assert "dryrun_multichip(" in proc.stdout and "ok" in proc.stdout.splitlines()[-1]
