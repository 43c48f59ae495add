"""Riccati recursions in plain PyTorch (port of
``autompc_tpu/ops/riccati.py``: the LQR pieces, ``solve_small``,
``tvlqr_backward_scan`` and the associative-scan family).

The LQR pieces (``dynamic_riccati_step``, ``lqr_gain``,
``finite_horizon_lqr``, ``infinite_horizon_lqr``) run once, when an LQR
controller is built: the JAX package's ``fori_loop`` and bounded
``while_loop`` are host loops here, with the same counts and the same
stopping rule.

``tvlqr_backward_scan`` is batch-native: every argument carries a
leading batch axis B, where the JAX package writes a per-lane function
and vmaps it. The time recursion is a Python loop over H of batched
tensor ops. It is the solver's ``backward="scan"`` and, with the
unrolled Cholesky solve of ``ops/cuda_riccati_general.py``, the plain
version of that kernel.

The associative-scan family (``tvlqr_backward_assoc`` and its element
algebra, ``affine_rollout_parallel``) is batch-first too: the time axis
is axis 1 of every sequence, and one log-depth scan (``assoc_scan``, a
Hillis-Steele sweep of batched combines) runs all lanes at once. PyTorch
has no ``lax.associative_scan``; the sweep combines the same elements in
another grouping, which is exact in float64 up to reassociation.
"""

from __future__ import annotations

import torch


def dynamic_riccati_step(P, A, B, Q, R, N):
    """One step of the discrete-time dynamic Riccati equation:
    A'PA - (A'PB + N)(R + B'PB)^{-1}(B'PA + N') + Q."""
    BtP = B.T @ P
    G = R + BtP @ B
    H = BtP @ A + N.T
    return A.T @ P @ A - (A.T @ P @ B + N) @ torch.linalg.solve(G, H) + Q


def lqr_gain(A, B, P, R, N=None):
    """K = -(R + B'PB)^{-1} (B'PA + N')."""
    BtP = B.T @ P
    rhs = BtP @ A if N is None else BtP @ A + N.T
    return -torch.linalg.solve(R + BtP @ B, rhs)


def finite_horizon_lqr(A, B, Q, R, N, F, horizon: int):
    """Finite-horizon LQR gain: from P = F, ``horizon + 1`` Riccati
    steps, then the gain of the last P. Returns (K, P)."""
    P = F
    for _ in range(int(horizon) + 1):
        P = dynamic_riccati_step(P, A, B, Q, R, N)
    return lqr_gain(A, B, P, R, N), P


def infinite_horizon_lqr(A, B, Q, R, N=None, threshold=1e-3, max_iter=10000):
    """Infinite-horizon LQR by Riccati fixed-point iteration from P = Q,
    until ``max|P1 - P2| <= threshold`` or ``max_iter`` steps past the
    first. The convergence test reads the device once a step. Returns
    (K, P)."""
    if N is None:
        N = A.new_zeros((A.shape[0], B.shape[1]))
    P_prev = Q
    P = dynamic_riccati_step(P_prev, A, B, Q, R, N)
    it = 0
    while it < max_iter and float((P - P_prev).abs().max()) > threshold:
        P_prev, P = P, dynamic_riccati_step(P, A, B, Q, R, N)
        it += 1
    return lqr_gain(A, B, P, R, N), P


def solve_small(A, b):
    """Batched linear solve ``A x = b`` for the tiny control-dimension
    systems MPC produces: A (..., n, n), b (..., n, m). Closed forms for
    n = 1 and n = 2, LU otherwise."""
    n = A.shape[-1]
    if n == 1:
        return b / A[..., 0, 0][..., None, None]
    if n == 2:
        det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
        inv = torch.stack(
            [
                torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
                torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1),
            ],
            dim=-2,
        ) / det[..., None, None]
        return inv @ b
    return torch.linalg.solve(A, b)


def tvlqr_backward_scan(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn, solve=solve_small):
    """Sequential time-varying LQR backward pass, batched over lanes.

    For t = H-1 .. 0:

      Qt = C_t + J_t' V J_t,   qt = c_t + J_t' v
      K_t = -Quu^{-1} Qux,     k_t = -Quu^{-1} qu
      V  <- Qxx + Qxu K + K' Qux + K' Quu K
      v  <- qx + Qxu k + K'(qu + Quu k)

    Jx (B, H, ds, ds), Ju (B, H, ds, dc): dynamics Jacobians; Cxx
    (B, H, ds, ds), Cuu (B, H, dc, dc), cx (B, H, ds), cu (B, H, dc):
    dt-scaled stage expansions; Vn (B, ds, ds), vn (B, ds): terminal
    expansion. ``solve(A (B, dc, dc), b (B, dc, m))`` is the Quu solve.

    Returns Ks (B, H, dc, ds), ks (B, H, dc) and the expected linear and
    quadratic cost reductions lin_red, quad_red (B,) of the line
    search's acceptance test.
    """
    B, H, ds, dc = Ju.shape
    V, v = Vn, vn
    lin = Vn.new_zeros((B,))
    quad = Vn.new_zeros((B,))
    Ks = Vn.new_empty((B, H, dc, ds))
    ks = Vn.new_empty((B, H, dc))
    for t in range(H - 1, -1, -1):
        JxT = Jx[:, t].transpose(1, 2)
        JuT = Ju[:, t].transpose(1, 2)
        JxV = JxT @ V
        JuV = JuT @ V
        Qxx = Cxx[:, t] + JxV @ Jx[:, t]
        Quu = Cuu[:, t] + JuV @ Ju[:, t]
        Qux = JuV @ Jx[:, t]
        qx = cx[:, t] + (JxT @ v[:, :, None])[:, :, 0]
        qu = cu[:, t] + (JuT @ v[:, :, None])[:, :, 0]
        sol = solve(Quu, torch.cat([Qux, qu[:, :, None]], dim=2))
        K = -sol[:, :, :ds]
        k = -sol[:, :, ds]
        Quu_k = (Quu @ k[:, :, None])[:, :, 0]
        lin = lin + (qu * k).sum(-1)
        quad = quad + (k * Quu_k).sum(-1)
        KT = K.transpose(1, 2)
        QuxT = Qux.transpose(1, 2)
        V = Qxx + QuxT @ K + KT @ Qux + KT @ Quu @ K
        v = (
            qx
            + (QuxT @ k[:, :, None])[:, :, 0]
            + (KT @ (qu + Quu_k)[:, :, None])[:, :, 0]
        )
        Ks[:, t] = K
        ks[:, t] = k
    return Ks, ks, lin, quad


# ---------------------------------------------------------------------------
# Parallel (associative-scan) time-varying LQR backward pass
# ---------------------------------------------------------------------------


def solve_unrolled(A, B):
    """Fixed-size linear solve by Gaussian elimination with partial
    pivoting, unrolled over the columns: A (..., n, n), B (..., n, k),
    every leading index its own system. The JAX package writes it for
    the TPU, whose batched LU faults at large batch; here it keeps the
    element algebra's solves those of the reference, pivots and all."""
    n = A.shape[-1]
    M = torch.cat([A, B], dim=-1)                               # (..., n, n+k)
    rows = torch.arange(n, device=A.device)
    for col in range(n):
        # Partial pivot: swap the largest-magnitude row into place.
        p = col + M[..., col:, col].abs().argmax(dim=-1)        # (...,)
        r = rows.expand(M.shape[:-1])
        perm = torch.where(r == col, p[..., None], torch.where(r == p[..., None], col, r))
        M = torch.gather(M, -2, perm[..., None].expand(M.shape))
        pivot = M[..., col, col]
        factor = M[..., :, col] / pivot[..., None]
        elim = torch.where(rows == col, torch.zeros_like(factor), factor)
        M = M - elim[..., :, None] * M[..., col, None, :]
        M = torch.cat([M[..., :col, :], (M[..., col, :] / pivot[..., None])[..., None, :],
                       M[..., col + 1:, :]], dim=-2)
    return M[..., n:]


def tvlqr_element(Jx, Ju, Q, R, q, r, d, reg=0.0):
    """Per-step element ``(A, b, C, eta, J)`` of the parallel Riccati
    recursion, batched over the leading axes: Jx (..., ds, ds), Ju
    (..., ds, dc), Q (..., ds, ds), R (..., dc, dc), q (..., ds), r
    (..., dc), d (..., ds). Sign convention: the value map uses
    ``(v + V b)`` with ``b = d - Ju (R + reg)^{-1} r``."""
    dc = Ju.shape[-1]
    Rt = R + reg * torch.eye(dc, dtype=Jx.dtype, device=Jx.device)
    RiJu = solve_small(Rt, Ju.transpose(-1, -2))                # (..., dc, ds)
    C = Ju @ RiJu                                               # (..., ds, ds)
    b = d - (Ju @ solve_small(Rt, r[..., None]))[..., 0]        # (..., ds)
    return Jx, b, C, q, Q


def tvlqr_identity_element(ds, dtype, device=None, batch=()):
    """Identity of the combine monoid (composing with it on either side
    is a no-op), with leading axes ``batch``."""
    z = dict(dtype=dtype, device=device)
    eye = torch.eye(ds, **z).expand(tuple(batch) + (ds, ds))
    vec = torch.zeros(tuple(batch) + (ds,), **z)
    mat = torch.zeros(tuple(batch) + (ds, ds), **z)
    return eye, vec, mat, vec, mat


def tvlqr_combine(earlier, later):
    """Compose two elements, batched over their leading axes;
    ``earlier`` is earlier in time (the composed element applies the
    later map first)."""
    Ai, bi, Ci, etai, Ji = earlier
    Aj, bj, Cj, etaj, Jj = later
    eye = torch.eye(Ai.shape[-1], dtype=Ai.dtype, device=Ai.device).expand(Ai.shape)
    D = solve_unrolled(eye + Ci @ Jj, eye)
    Dt = solve_unrolled(eye + Jj @ Ci, eye)
    AjD = Aj @ D
    AiT = Ai.transpose(-1, -2)
    AiTDt = AiT @ Dt
    A = AjD @ Ai
    C = AjD @ Ci @ Aj.transpose(-1, -2) + Cj
    b = (AjD @ (bi - (Ci @ etaj[..., None])[..., 0])[..., None])[..., 0] + bj
    eta = (AiTDt @ (etaj + (Jj @ bi[..., None])[..., 0])[..., None])[..., 0] + etai
    J = AiTDt @ Jj @ Ai + Ji
    return A, b, C, eta, J


def tvlqr_apply_element(elem, Vn, vn):
    """Apply a (suffix-composed) element to the terminal expansion Vn
    (..., ds, ds), vn (..., ds): the value expansion (V_t, v_t) at the
    element's start."""
    A, b, C, eta, J = elem
    ds = A.shape[-1]
    eye = torch.eye(ds, dtype=A.dtype, device=A.device).expand(A.shape)
    rhs = torch.cat([Vn.expand(A.shape), (vn + (Vn @ b[..., None])[..., 0])[..., None]], dim=-1)
    WM = solve_unrolled(eye + Vn @ C, rhs)
    W, Mv = WM[..., :ds], WM[..., ds]
    AT = A.transpose(-1, -2)
    return J + AT @ W @ A, eta + (AT @ Mv[..., None])[..., 0]


def tvlqr_gains(Jx, Ju, R, r, d, V, v, reg=0.0):
    """Pointwise gains from the NEXT-step value expansion, batched over
    the leading axes: (K (..., dc, ds), k (..., dc), lin_term (...),
    quad_term (...))."""
    dc = Ju.shape[-1]
    v_eff = v + (V @ d[..., None])[..., 0]
    JuT = Ju.transpose(-1, -2)
    JuV = JuT @ V
    Quu = R + reg * torch.eye(dc, dtype=Jx.dtype, device=Jx.device) + JuV @ Ju
    Qux = JuV @ Jx
    qu = r + (JuT @ v_eff[..., None])[..., 0]
    K = -solve_small(Quu, Qux)
    k = -solve_small(Quu, qu[..., None])[..., 0]
    quad = (k[..., None, :] @ Quu @ k[..., :, None])[..., 0, 0]
    return K, k, (qu * k).sum(-1), quad


def assoc_scan(combine, elems, axis=1, reverse=False):
    """Inclusive scan of the tuple of tensors ``elems`` along ``axis``
    with the associative ``combine(earlier, later)``, in log2(n) rounds
    of one batched ``combine`` each (Hillis-Steele): after the round of
    offset s, position t holds the composition of the 2s (or fewer)
    elements ending (``reverse``: starting) at t. ``reverse=False``
    gives prefixes e_0 .. e_t, ``reverse=True`` suffixes e_t .. e_{n-1}.
    Every element of ``elems`` is indexed along ``axis``."""
    n = elems[0].shape[axis]
    cur = tuple(elems)
    s = 1
    while s < n:
        head = tuple(e.narrow(axis, 0, n - s) for e in cur)
        tail = tuple(e.narrow(axis, s, n - s) for e in cur)
        if reverse:
            # t < n - s: e_t .. e_{t+s-1} (head) then e_{t+s} .. (tail).
            new = combine(head, tail)
            cur = tuple(torch.cat([a, e.narrow(axis, n - s, s)], dim=axis)
                        for a, e in zip(new, cur))
        else:
            # t >= s: .. e_{t-s} (head) then e_{t-s+1} .. e_t (tail).
            new = combine(head, tail)
            cur = tuple(torch.cat([e.narrow(axis, 0, s), a], dim=axis)
                        for a, e in zip(new, cur))
        s *= 2
    return cur


def tvlqr_suffix_scan(elems):
    """Suffix compositions E_t = e_t (*) e_{t+1} (*) ... (*) e_{H-1} of
    batch-first elements (every member (B, H, ...)), in O(log H) rounds
    of batched ``tvlqr_combine``."""
    return assoc_scan(tvlqr_combine, elems, axis=1, reverse=True)


def tvlqr_backward_assoc(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn, d_seq=None, reg=0.0):
    """Parallel-in-time TVLQR backward pass of B lanes: O(log H) depth.

    Takes the arguments of ``tvlqr_backward_scan``, batch-first: Jx
    (B, H, ds, ds), Ju (B, H, ds, dc), Cxx (B, H, ds, ds), Cuu
    (B, H, dc, dc), cx (B, H, ds), cu (B, H, dc), Vn (B, ds, ds), vn
    (B, ds); ``d_seq`` (B, H, ds) and ``reg`` extend it to the
    multiple-shooting trajectory QP (defects, Levenberg regularization
    of Cuu; ``ops/trajqp.py::qp_backward`` with Cux = 0). Returns Ks
    (B, H, dc, ds), ks (B, H, dc), lin_red, quad_red (B,).

    The value recursion of the scan is, in closed form,
    ``V_t = Q + F'(I + V C)^{-1} V F`` and ``v_t = q + F'(I + V C)^{-1}
    (v - V b)``, maps of the 5-tuple family (A = F, b, C, eta = q,
    J = Q) closed under ``tvlqr_combine``. Suffix compositions of the
    per-step elements give every (V_t, v_t) at once; the gains and the
    expected reductions are then pointwise. Requires Cuu + reg
    invertible. Matches ``tvlqr_backward_scan`` to float32
    reassociation; exact in float64 up to rounding.
    """
    B, H, ds, dc = Ju.shape
    if d_seq is None:
        d_seq = Vn.new_zeros((B, H, ds))
    elems = tvlqr_element(Jx, Ju, Cxx, Cuu, cx, cu, d_seq, reg=reg)
    suffix = tvlqr_suffix_scan(elems)
    V_all, v_all = tvlqr_apply_element(suffix, Vn[:, None], vn[:, None])   # t = 0..H-1
    V_next = torch.cat([V_all[:, 1:], Vn[:, None]], dim=1)
    v_next = torch.cat([v_all[:, 1:], vn[:, None]], dim=1)
    Ks, ks, lin_t, quad_t = tvlqr_gains(Jx, Ju, Cuu, cu, d_seq, V_next, v_next, reg=reg)
    return Ks, ks, lin_t.sum(1), quad_t.sum(1)


# ---------------------------------------------------------------------------
# Parallel (associative-scan) linear rollout
# ---------------------------------------------------------------------------


def affine_rollout_scan(A_seq, b_seq, x0):
    """Roll ``x_{t+1} = A_t x_t + b_t`` sequentially for B lanes: A_seq
    (B, H, ds, ds), b_seq (B, H, ds), x0 (B, ds). Returns (B, H+1, ds)."""
    xs = [x0]
    for t in range(A_seq.shape[1]):
        xs.append((A_seq[:, t] @ xs[-1][..., None])[..., 0] + b_seq[:, t])
    return torch.stack(xs, dim=1)


def _affine_combine(f, g):
    """(A2, b2) after (A1, b1): (A2 A1, A2 b1 + b2); ``f`` earlier."""
    A1, b1 = f
    A2, b2 = g
    return A2 @ A1, (A2 @ b1[..., None])[..., 0] + b2


def affine_rollout_parallel(A_seq, b_seq, x0):
    """``affine_rollout_scan`` by a parallel prefix over compositions of
    affine maps, O(log H) depth: exact for affine dynamics (LQR, ARX and
    Koopman rollouts, the iLQR forward pass on linearized dynamics).
    Returns (B, H+1, ds)."""
    As, bs = assoc_scan(_affine_combine, (A_seq, b_seq), axis=1)
    xs = (As @ x0[:, None, :, None])[..., 0] + bs
    return torch.cat([x0[:, None], xs], dim=1)
