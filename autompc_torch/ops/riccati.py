"""Riccati recursions in plain PyTorch (port of
``autompc_tpu/ops/riccati.py``: the LQR pieces, ``solve_small`` and
``tvlqr_backward_scan``).

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
version of that kernel. The associative-scan family of the JAX module
is not ported yet (ROADMAP.md §A).
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
    systems MPC produces: A (B, n, n), b (B, n, m). Closed forms for
    n = 1 and n = 2, LU otherwise."""
    n = A.shape[-1]
    if n == 1:
        return b / A[:, 0, 0][:, None, None]
    if n == 2:
        det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
        inv = torch.stack(
            [
                torch.stack([A[:, 1, 1], -A[:, 0, 1]], dim=-1),
                torch.stack([-A[:, 1, 0], A[:, 0, 0]], dim=-1),
            ],
            dim=-2,
        ) / det[:, None, None]
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
