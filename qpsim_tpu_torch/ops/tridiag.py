"""Batched tridiagonal solves in PyTorch: Thomas, PCR and the Wang partition.

The counterpart of ``qpsim_tpu.ops.tridiag``: the same recurrences in the
same order, so float64 results agree to roundoff.  Every solve runs along
the last axis, batched over the leading ones; the JAX package's scans are
Python loops here, each step one batched operation over every line.

Block-diagonal systems (masked geometries give independent intervals in
one grid line) need no special casing: a zero sub-diagonal entry restarts
the forward recurrence and a zero super-diagonal entry ends the backward
one, so interval boundaries decouple exactly in every algorithm.

:func:`tridiag_solve` dispatches by :func:`set_default_solver`, which
takes the JAX package's names: 'auto' and 'pallas' (the Thomas solve of
``ops.tridiag_cuda.ThomasSolve``: the CUDA kernel K10 on CUDA tensors, the
plain Thomas sweep on CPU tensors, with K10's transposed solve as its
backward), 'thomas', 'pcr' and 'wang' (chunk 64), the plain algorithms.
:func:`solver_route` is the decision.  :func:`tridiag_solve_thomas` is the
plain Thomas solve that the kernels' plain versions call directly.
"""

from __future__ import annotations

import torch

__all__ = [
    "tridiag_solve",
    "tridiag_solve_along",
    "tridiag_solve_thomas",
    "tridiag_solve_pcr",
    "tridiag_solve_wang",
    "wang_eliminate",
    "wang_interface_sweep",
    "wang_externals",
    "wang_factor",
    "wang_apply",
    "wang_apply_rhs",
    "wang_apply_interface",
    "set_default_solver",
    "get_default_solver",
    "solver_route",
]


def tridiag_solve_thomas(
    sub: torch.Tensor, diag: torch.Tensor, sup: torch.Tensor, rhs: torch.Tensor
) -> torch.Tensor:
    """Solve T x = rhs with T tridiagonal along the last axis (Thomas sweep).

    ``sub[..., i]`` couples row i to i−1 (never read at i=0) and
    ``sup[..., i]`` couples row i to i+1 (never read at the last row).  The
    four arrays broadcast to one shape; batching is over the leading axes.
    """
    sub, diag, sup, rhs = torch.broadcast_tensors(sub, diag, sup, rhs)
    n = rhs.shape[-1]
    if n == 1:
        return rhs / diag
    # line axis first, so every sweep row is one contiguous batch of lines
    a, b, c, r = (t.movedim(-1, 0) for t in (sub, diag, sup, rhs))
    w = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    g = torch.empty_like(w)
    inv = 1.0 / b[0]
    w[0] = c[0] * inv
    g[0] = r[0] * inv
    for i in range(1, n):
        inv = 1.0 / (b[i] - a[i] * w[i - 1])
        if i < n - 1:
            w[i] = c[i] * inv
        g[i] = (r[i] - a[i] * g[i - 1]) * inv
    # back substitution in place over g (saves a third (n, ...) buffer):
    # x_i = g_i - w_i·x_{i+1}
    for i in range(n - 2, -1, -1):
        g[i] -= w[i] * g[i + 1]
    return g.movedim(0, -1)


def _shift_fwd(arr: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """Value of index i−s along the last axis (fill past the edge)."""
    pad = torch.full((*arr.shape[:-1], s), fill, dtype=arr.dtype, device=arr.device)
    return torch.cat([pad, arr[..., :-s]], dim=-1)


def _shift_bwd(arr: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """Value of index i+s along the last axis (fill past the edge)."""
    pad = torch.full((*arr.shape[:-1], s), fill, dtype=arr.dtype, device=arr.device)
    return torch.cat([arr[..., s:], pad], dim=-1)


def _open_ends(sub: torch.Tensor, sup: torch.Tensor):
    """Copies of sub and sup with the unread sub[..., 0] and sup[..., -1] zeroed."""
    a, c = sub.clone(), sup.clone()
    a[..., 0] = 0.0
    c[..., -1] = 0.0
    return a, c


def tridiag_solve_pcr(
    sub: torch.Tensor, diag: torch.Tensor, sup: torch.Tensor, rhs: torch.Tensor
) -> torch.Tensor:
    """Parallel cyclic reduction along the last axis: ⌈log₂N⌉ vectorised levels."""
    sub, diag, sup, rhs = torch.broadcast_tensors(sub, diag, sup, rhs)
    n = rhs.shape[-1]
    if n == 1:
        return rhs / diag
    a, c = _open_ends(sub, sup)
    b, d = diag, rhs
    s = 1
    while s < n:
        alpha = -a / _shift_fwd(b, s, 1.0)
        gamma = -c / _shift_bwd(b, s, 1.0)
        b = b + alpha * _shift_fwd(c, s, 0.0) + gamma * _shift_bwd(a, s, 0.0)
        d = d + alpha * _shift_fwd(d, s, 0.0) + gamma * _shift_bwd(d, s, 0.0)
        a = alpha * _shift_fwd(a, s, 0.0)
        c = gamma * _shift_bwd(c, s, 0.0)
        s *= 2
    return d / b


def wang_eliminate(a_s, b_s, c_s, d_s):
    """Stages 1–2 of the Wang partition: per-partition elimination sweeps.

    Inputs are laid out (M, *lanes), M the in-partition position.  Returns
    ``(C, A, D)`` with every unknown expressed as x_i = D_i − A_i·X_L −
    C_i·X_R in terms of the neighbouring partitions' boundary values.
    """
    m = a_s.shape[0]
    cp, ap, dp = (torch.empty_like(a_s) for _ in range(3))
    cp_prev = torch.zeros_like(a_s[0])
    ap_prev = -torch.ones_like(a_s[0])
    dp_prev = torch.zeros_like(a_s[0])
    for i in range(m):
        inv = 1.0 / (b_s[i] - a_s[i] * cp_prev)
        cp[i] = cp_prev = c_s[i] * inv
        ap[i] = ap_prev = -a_s[i] * ap_prev * inv
        dp[i] = dp_prev = (d_s[i] - a_s[i] * dp_prev) * inv
    C, A, D = (torch.empty_like(a_s) for _ in range(3))
    # at i=M−1 the final form is the stage-1 row itself (its sup couples X_R)
    c_nxt = torch.full_like(a_s[0], -1.0)
    a_nxt = torch.zeros_like(a_s[0])
    d_nxt = torch.zeros_like(a_s[0])
    for i in range(m - 1, -1, -1):
        D[i] = d_nxt = dp[i] - cp[i] * d_nxt
        A[i] = a_nxt = ap[i] - cp[i] * a_nxt
        C[i] = c_nxt = -cp[i] * c_nxt
    return C, A, D


def wang_interface_sweep(aL, cL, dL, aR, cR, dR, k: int):
    """Stage 3 of the Wang partition: the 2K-unknown interface recurrence.

    ``aL..dR`` are (K, *lanes) stacks of each partition's first/last row
    coefficients.  Returns the boundary unknowns ``(Ls, Rs)`` as K-lists.
    """
    zero = torch.zeros_like(aL[0])
    g = zero  # R_{k−1} = g − w·L_k
    w = zero
    ps, qs, gs, ws = [], [], [], []
    for j in range(k):
        inv = 1.0 / (1.0 - aL[j] * w)
        p = (dL[j] - aL[j] * g) * inv
        q = cL[j] * inv
        g = dR[j] - aR[j] * g + aR[j] * w * p
        w = cR[j] + aR[j] * w * q
        ps.append(p)
        qs.append(q)
        gs.append(g)
        ws.append(w)
    L_next = zero
    Ls, Rs = [None] * k, [None] * k
    for j in range(k - 1, -1, -1):
        Ls[j] = ps[j] - qs[j] * L_next
        Rs[j] = gs[j] - ws[j] * L_next
        L_next = Ls[j]
    return Ls, Rs


def wang_externals(Ls, Rs):
    """Stacked ``(XL, XR)``: X_L of partition j = R_{j−1} (zero at the top),
    X_R = L_{j+1} (zero at the bottom)."""
    zero = torch.zeros_like(Ls[0])
    return torch.stack([zero] + Rs[:-1]), torch.stack(Ls[1:] + [zero])


def _pad_last(t: torch.Tensor, pad: int, value: float) -> torch.Tensor:
    fill = torch.full((*t.shape[:-1], pad), value, dtype=t.dtype, device=t.device)
    return torch.cat([t, fill], dim=-1)


def _wang_layout(t: torch.Tensor, k: int, chunk: int) -> torch.Tensor:
    """(..., K·M) → (M, K, ...): sweep over in-chunk position, lanes in batch."""
    t = t.reshape(*t.shape[:-1], k, chunk)
    return t.movedim(-1, 0).movedim(-1, 1)


def _wang_unlayout(t: torch.Tensor) -> torch.Tensor:
    """(M, K, ...) → (..., K·M)."""
    t = t.movedim(1, -1).movedim(0, -1)  # (..., K, M)
    return t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])


def _wang_padded(sub, diag, sup, chunk: int):
    """Open ends, chunk count and identity padding rows shared by the Wang paths."""
    n = diag.shape[-1]
    chunk = int(min(chunk, n))
    k = -(-n // chunk)
    pad = k * chunk - n
    a, c = _open_ends(sub, sup)
    b = diag
    if pad:
        # identity padding rows: decoupled (a=c=0), x=0
        a, c, b = _pad_last(a, pad, 0.0), _pad_last(c, pad, 0.0), _pad_last(b, pad, 1.0)
    return a, b, c, k, chunk, pad


def tridiag_solve_wang(
    sub: torch.Tensor,
    diag: torch.Tensor,
    sup: torch.Tensor,
    rhs: torch.Tensor,
    chunk: int = 128,
) -> torch.Tensor:
    """Wang's partition method along the last axis (chunked Thomas + the
    reduced interface system), as ``qpsim_tpu.ops.tridiag.tridiag_solve_wang``."""
    sub, diag, sup, rhs = torch.broadcast_tensors(sub, diag, sup, rhs)
    n = rhs.shape[-1]
    if n == 1:
        return rhs / diag
    a, b, c, k, chunk, pad = _wang_padded(sub, diag, sup, chunk)
    d = _pad_last(rhs, pad, 0.0) if pad else rhs
    C, A, D = wang_eliminate(*(_wang_layout(t, k, chunk) for t in (a, b, c, d)))
    Ls, Rs = wang_interface_sweep(A[0], C[0], D[0], A[-1], C[-1], D[-1], k)
    XL, XR = wang_externals(Ls, Rs)
    x = _wang_unlayout(D - A * XL[None] - C * XR[None])
    return x[..., :n] if pad else x


def wang_factor(
    sub: torch.Tensor, diag: torch.Tensor, sup: torch.Tensor, chunk: int = 128
) -> dict[str, torch.Tensor]:
    """Precompute the Wang-partition factorization of a tridiagonal system.

    Consumed by :func:`wang_apply`; together they split
    :func:`tridiag_solve_wang` into a once-per-operator factor stage and a
    per-step solve that runs only the rhs recurrences.
    """
    sub, diag, sup = torch.broadcast_tensors(sub, diag, sup)
    a, b, c, k, chunk, _ = _wang_padded(sub, diag, sup, chunk)
    a_s, b_s, c_s = (_wang_layout(t, k, chunk) for t in (a, b, c))
    cp, ap, m, inv = (torch.empty_like(a_s) for _ in range(4))
    cp_prev = torch.zeros_like(a_s[0])
    ap_prev = -torch.ones_like(a_s[0])
    for i in range(chunk):
        inv[i] = inv_i = 1.0 / (b_s[i] - a_s[i] * cp_prev)
        cp[i] = cp_prev = c_s[i] * inv_i
        ap[i] = ap_prev = -a_s[i] * ap_prev * inv_i
        m[i] = a_s[i] * inv_i
    C, A = torch.empty_like(a_s), torch.empty_like(a_s)
    c_nxt = torch.full_like(a_s[0], -1.0)
    a_nxt = torch.zeros_like(a_s[0])
    for i in range(chunk - 1, -1, -1):
        A[i] = a_nxt = ap[i] - cp[i] * a_nxt
        C[i] = c_nxt = -cp[i] * c_nxt
    # interface coefficients (unrolled over the K chunks)
    aL, cL, aR, cR = A[0], C[0], A[-1], C[-1]
    w = torch.zeros_like(a_s[0, 0])
    inv_if, q_if, w_pre, w_post = [], [], [], []
    for j in range(k):
        invj = 1.0 / (1.0 - aL[j] * w)
        qj = cL[j] * invj
        w_new = cR[j] + aR[j] * w * qj
        inv_if.append(invj)
        q_if.append(qj)
        w_pre.append(w)
        w_post.append(w_new)
        w = w_new
    return {
        "cp": cp, "m": m, "inv": inv, "C": C, "A": A,
        "if_inv": torch.stack(inv_if), "if_q": torch.stack(q_if),
        "if_w_pre": torch.stack(w_pre), "if_w_post": torch.stack(w_post),
        "if_aL": aL, "if_aR": aR,
    }


def wang_apply_rhs(d, m, inv, cp):
    """Prefactored stages 1–2, rhs only: d → D (the boundary-coupled form).

    ``m = a·inv``, ``inv`` and ``cp`` come from :func:`wang_factor`;
    layouts are (M, *lanes).  D is the solve of each partition's block
    with its couplings to the neighbours cut.  Shared by :func:`wang_apply`
    and the sharded step's prefactored distributed y-solve.
    """
    # dp_i = d_i·inv_i − m_i·dp_{i−1}, D_i = dp_i − cp_i·D_{i+1}
    D = torch.empty_like(d)
    prev = torch.zeros_like(d[0])
    for i in range(d.shape[0]):
        D[i] = prev = d[i] * inv[i] - m[i] * prev
    nxt = torch.zeros_like(d[0])
    for i in range(d.shape[0] - 1, -1, -1):  # the backward sweep overwrites dp in place
        D[i] = nxt = D[i] - cp[i] * nxt
    return D


def wang_apply_interface(dL, dR, aL, aR, if_inv, if_q, w_pre, w_post, k: int):
    """Prefactored stage 3: the boundary unknowns ``(Ls, Rs)`` (K-lists)
    from the interface rows ``dL``/``dR`` (K, *lanes) of D.

    The coefficient parts (``aL, aR, if_inv, if_q, w_pre, w_post``, (K,
    *lanes) stacks from :func:`wang_factor`) are time-invariant.  Shared by
    :func:`wang_apply` and the sharded step's prefactored y-solve.
    """
    g = torch.zeros_like(dL[0])
    ps, gs = [], []
    for j in range(k):
        p = (dL[j] - aL[j] * g) * if_inv[j]
        g = dR[j] - aR[j] * g + aR[j] * w_pre[j] * p
        ps.append(p)
        gs.append(g)
    L_next = torch.zeros_like(g)
    Ls, Rs = [None] * k, [None] * k
    for j in range(k - 1, -1, -1):
        Ls[j] = ps[j] - if_q[j] * L_next
        Rs[j] = gs[j] - w_post[j] * L_next
        L_next = Ls[j]
    return Ls, Rs


def wang_apply(fac: dict[str, torch.Tensor], rhs: torch.Tensor) -> torch.Tensor:
    """Solve with a :func:`wang_factor` factorization (rhs recurrences only)."""
    cp, m, inv = fac["cp"], fac["m"], fac["inv"]
    chunk, k = cp.shape[0], cp.shape[1]
    n = rhs.shape[-1]
    pad = k * chunk - n
    d = _wang_layout(_pad_last(rhs, pad, 0.0) if pad else rhs, k, chunk)
    D = wang_apply_rhs(d, m, inv, cp)
    Ls, Rs = wang_apply_interface(
        D[0], D[-1], fac["if_aL"], fac["if_aR"], fac["if_inv"], fac["if_q"],
        fac["if_w_pre"], fac["if_w_post"], k,
    )
    XL, XR = wang_externals(Ls, Rs)
    x = _wang_unlayout(D - fac["A"] * XL[None] - fac["C"] * XR[None])
    return x[..., :n] if pad else x


_SOLVERS = ("auto", "thomas", "pcr", "wang", "pallas")
_DEFAULT_SOLVER = "auto"

#: Wang partition chunk length of the 'wang' solver
_WANG_CHUNK = 64


def set_default_solver(name: str) -> None:
    """Select the batched tridiagonal algorithm behind :func:`tridiag_solve`.

    'auto'   — the Thomas solve of ``ops.tridiag_cuda.ThomasSolve``: the
               CUDA kernel (K10) on CUDA tensors, the plain Thomas sweep on
               CPU tensors, differentiable on both;
    'pallas' — the same (the JAX package's name for its kernel);
    'thomas' — the plain sequential Thomas sweep;
    'pcr'    — parallel cyclic reduction;
    'wang'   — Wang partition with chunk 64.
    """
    global _DEFAULT_SOLVER
    if name not in _SOLVERS:
        raise ValueError(f"Unknown tridiagonal solver: {name!r}")
    _DEFAULT_SOLVER = name


def get_default_solver() -> str:
    """The name :func:`set_default_solver` last set ('auto' at import)."""
    return _DEFAULT_SOLVER


def solver_route(name: str, device_type: str) -> str:
    """The algorithm :func:`tridiag_solve` runs under solver ``name`` for
    tensors on ``device_type`` ("cpu" or "cuda"), at any number of lines.

    "kernel" is ``ThomasSolve``: K10 on "cuda", the plain Thomas sweep on
    "cpu" (the JAX package's 'auto' on the CPU), both with K10's transposed
    solve as the backward.  The JAX package's 'auto' chooses among its XLA
    scans, whose counterparts here are the plain versions, kept for tests;
    so on the card 'auto' launches the kernel.  'thomas', 'pcr' and 'wang'
    asked for by name are the plain algorithms on either device.
    """
    if name not in _SOLVERS:
        raise ValueError(f"Unknown tridiagonal solver: {name!r}")
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"tridiagonal solves run on 'cpu' or 'cuda' tensors, got {device_type!r}")
    return "kernel" if name in ("auto", "pallas") else name


def tridiag_solve(
    sub: torch.Tensor, diag: torch.Tensor, sup: torch.Tensor, rhs: torch.Tensor
) -> torch.Tensor:
    """Solve T x = rhs with T tridiagonal along the last axis.

    ``sub[..., i]`` couples row i to i−1 (ignored at i=0) and ``sup[..., i]``
    couples row i to i+1 (ignored at the last row).  Dispatches by
    :func:`set_default_solver` through :func:`solver_route`.
    """
    route = solver_route(_DEFAULT_SOLVER, rhs.device.type)
    if route == "kernel":
        from .tridiag_cuda import thomas

        return thomas(sub, diag, sup, rhs)
    if route == "wang":
        return tridiag_solve_wang(sub, diag, sup, rhs, chunk=_WANG_CHUNK)
    if route == "pcr":
        return tridiag_solve_pcr(sub, diag, sup, rhs)
    return tridiag_solve_thomas(sub, diag, sup, rhs)


def tridiag_solve_along(
    axis: int,
    sub: torch.Tensor,
    diag: torch.Tensor,
    sup: torch.Tensor,
    rhs: torch.Tensor,
    solve=tridiag_solve,
) -> torch.Tensor:
    """A tridiagonal solve along an arbitrary axis (moves it last and back).

    ``solve`` is :func:`tridiag_solve` (the dispatch) unless a caller pins
    one algorithm.
    """
    if axis in (-1, rhs.ndim - 1):
        return solve(sub, diag, sup, rhs)
    move = lambda t: t.movedim(axis, -1)
    return solve(move(sub), move(diag), move(sup), move(rhs)).movedim(-1, axis)
