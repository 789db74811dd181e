"""Build and load the port's CUDA kernels: ``csrc/*.cu`` → one shared library.

The kernels are compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with ``ctypes``; no
PyTorch headers are involved, so a build takes seconds.  Each source is
compiled by its own ``nvcc`` process, all started together, and the
objects are then linked into the library.  The library is
built at first use from the sources in the checkout into
``build/qpsim_tpu_torch/`` at the checkout root, named by a hash of the
sources, their headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and an unchanged one is loaded as is.  A missing
``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["load_kernels", "build_dir", "library_path", "nvcc_version", "ptxas_report", "refuse_grad"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [
    *_ARCH,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # register, shared-memory and spill report per kernel (kept in ptxas.log)
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def refuse_grad(kernel: str, plain: str, *tensors) -> None:
    """Raise where a kernel without a backward would drop a gradient.

    A kernel writes its outputs through raw pointers, so they carry no
    ``grad_fn``: with grad mode on and any of ``tensors`` (None skipped)
    requiring grad, a later ``backward()`` would see no gradient and say
    nothing.  ``plain`` names the plain version to differentiate instead.
    """
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: an input requires grad, and the kernel's output would "
            f"carry none. Differentiate through its plain version, {plain}, or call it under "
            "torch.no_grad()."
        )


def build_dir() -> Path:
    """``build/qpsim_tpu_torch`` beside the package, at the checkout root."""
    return _PKG.parent / "build" / "qpsim_tpu_torch"


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA kernels "
        "of qpsim_tpu_torch are compiled at first use and need the CUDA toolkit."
    )


def nvcc_version() -> str | None:
    """The last line of ``nvcc --version`` (its release), or None without nvcc."""
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return None
    lines = out.strip().splitlines()
    return lines[-1] if lines else None


def library_path() -> Path:
    """The kernel library for the sources in this checkout: named by a hash of
    the sources, their headers and the flags (it exists once built)."""
    h = hashlib.sha256()
    # the headers the sources include count too
    for src in sorted(_sources() + list(_CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(repr(_NVCC_FLAGS).encode())
    return build_dir() / f"libqpsim_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    return proc


def _build(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp_dir:
        objects = [Path(tmp_dir) / f"{src.stem}.o" for src in _sources()]
        compiles = [
            [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objects)
        ]
        # one nvcc per source, all at once; the report keeps the source order
        with ThreadPoolExecutor(max_workers=len(compiles)) as pool:
            procs = list(pool.map(_run, compiles))
        # link to a private name, then rename: a concurrent or interrupted
        # build never leaves a half-written library under the final name
        tmp_lib = Path(tmp_dir) / target.name
        _run([nvcc, *_ARCH, "-shared", "-o", str(tmp_lib), *map(str, objects)])
        (target.parent / "ptxas.log").write_text("".join(p.stdout + p.stderr for p in procs))
        os.replace(tmp_lib, target)


def load_kernels() -> ctypes.CDLL:
    """The kernels' library, built on first use; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _build(path)
            _lib = _declare(ctypes.CDLL(str(path)))
        return _lib


def ptxas_report() -> str:
    """The ``-Xptxas -v`` lines of the last build in this checkout ('' if none)."""
    log = build_dir() / "ptxas.log"
    return log.read_text() if log.is_file() else ""


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument and return types of every C entry point (pointers as c_void_p)."""
    P, I, LL, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"qp_collision_step_{suffix}")
        # q_in, ph_in, gen, q_out, ph_out, consts, n_consts, per_gap,
        # scat_off, rec_off, gid, g2, gamma, s_ptr, r_ptr, s_meta, r_meta,
        # rows, n_sgroups, n_rgroups, simple, ne, nb, nw, n_pix, dt,
        # update_phonons, stream
        fn.argtypes = [P] * 6 + [LL, I, I, I, P, P, D] + [P] * 5 + [I] * 6 + [LL, D, I, P]
        fn.restype = I
        for half in ("x", "y"):
            fn = getattr(lib, f"qp_adi_{half}_{suffix}")
            # u, out, 7 planes, scale, nb, nbp, ny, nx, k, alpha, stream
            fn.argtypes = [P] * 10 + [I, I, I, I, I, D, P]
            fn.restype = I
            fn = getattr(lib, f"qp_adi_sep_{half}_{suffix}")
            # u, out, xv, yv, fac, ifc, nb, ny, nx, k, stream
            fn.argtypes = [P] * 6 + [I, I, I, I, P]
            fn.restype = I
        fn = getattr(lib, f"qp_thomas_{suffix}")
        # sub, diag, sup, rhs, x, cols, n, lines, lead, k, stream
        fn.argtypes = [P] * 5 + [I] * 5 + [P]
        fn.restype = I
        fn = getattr(lib, f"qp_column_walk_{suffix}")
        # q_in, ph_in, gen, q_out, ph_out, gid, rho, scat, scat_t, rec,
        # rec_t, qs, qr, ps, pr, ne_pad, s_pad, g2, e_bins, inv_e, e2, zim,
        # gamma, scat_k, scat_row, n_scat, rec_s, rec_row, n_rec, row_ptr,
        # row_code, k_row, k_out, s_row, s_out, x_scat, n_xs, x_rec, n_xr,
        # slow_rows, n_slow, ne, n_pix, dt, update_phonons, pixels, bins,
        # scratch, stream
        fn.argtypes = ([P] * 15 + [I, I] + [P] * 5 + [D] + [P] * 2 + [I] + [P] * 2 + [I]
                       + [P] * 7 + [I, P, I, P, I] + [I, LL, D, I, I, I, P, P])
        fn.restype = I
        fn = getattr(lib, f"qp_adi_lines_{suffix}")
        # rhs, lo, di, hi, scale, out, nb, nbp, n, batch, k, alpha, stream
        fn.argtypes = [P] * 6 + [I] * 5 + [D, P]
        fn.restype = I
        fn = getattr(lib, f"qp_snapshot_reduce_{suffix}")
        # q, ph, mask, widths, dE, ne, nw, n_pix, integrated, ph_frame, sums, partial, stream
        fn.argtypes = [P] * 4 + [D, I, I, LL] + [P] * 5
        fn.restype = I
    # blocks of the snapshot reduction's first launch (its scratch rows)
    lib.qp_snapshot_reduce_blocks.argtypes = [LL]
    lib.qp_snapshot_reduce_blocks.restype = I
    # launch plans of the staged ADI kernels (K1, K2)
    lib.qp_adi_plan.argtypes = [I] * 6 + [P]  # x_half, elem_bytes, nb, ny, nx, k, out[7]
    lib.qp_adi_plan.restype = I
    lib.qp_adi_sep_plan.argtypes = [I] * 6 + [P]  # x_half, elem_bytes, nb, ny, nx, k, out[6]
    lib.qp_adi_sep_plan.restype = I
    # launch plan of the tridiagonal solve (K10)
    lib.qp_thomas_plan.argtypes = [I] * 6 + [P]  # cols, elem_bytes, n, lines, lead, k, out[7]
    lib.qp_thomas_plan.restype = I
    return lib
