"""Structured trajectory QP: the block-tridiagonal KKT solve by the
Riccati recursion with defects (port of ``autompc_tpu/ops/trajqp.py``:
``qp_backward``, ``qp_forward`` and ``solve_traj_qp``).

The knot-point QP of one SQP iterate

    min  sum_t 0.5 [dx;du]_t' H_t [dx;du]_t + g_t'[dx;du]_t  + terminal
    s.t. dx_{t+1} = A_t dx_t + B_t du_t + d_t,   dx_0 = 0

has a block-tridiagonal KKT matrix whose structured factorization is the
time-varying Riccati recursion with the defects d_t in its affine part:
one backward pass factors it, one forward pass recovers the step.

Batch-native: every argument carries a leading lane axis B, where the
JAX package writes a per-lane function and vmaps it; the recursions are
Python loops over H of batched tensor ops, but for ``qp_backward_assoc``,
the associative-scan factorization (O(log H) depth,
``ops/riccati.py::tvlqr_backward_assoc``).
"""

from __future__ import annotations

import torch

from .riccati import solve_small, tvlqr_backward_assoc


def qp_backward(A_seq, B_seq, Cxx, Cuu, Cux, cx, cu, d_seq, Vf, vf, reg=1e-8):
    """Backward factorization of the trajectory QP of B lanes.

    A_seq (B, H, ds, ds), B_seq (B, H, ds, dc): the dynamics'
    linearization; Cxx (B, H, ds, ds), Cuu (B, H, dc, dc), Cux
    (B, H, dc, ds): stage hessians; cx (B, H, ds), cu (B, H, dc): stage
    gradients; d_seq (B, H, ds): the defects f(x_t, u_t) - x_{t+1};
    Vf (B, ds, ds), vf (B, ds): the terminal hessian and gradient;
    ``reg``: added to the diagonal of Quu.

    Returns the gains Ks (B, H, dc, ds), ks (B, H, dc) and the expected
    reduction coefficients dV1 = sum_t k_t . qu_t, dV2 = sum_t k_t' Quu_t
    k_t (B,).

    A step of the recursion is a few batched products on the stacked
    blocks: with J = [A B] and the stage block C = [[Cxx, Cux', cx],
    [Cux, Cuu + reg I, cu]], G = C + J' [V J | v + V d] = [Q | q] holds
    Qxx, Qux, Quu, qx and qu at once, and one solve against G's control
    rows gives [-K | . | -k]. The sums associate as the JAX package's
    do only up to rounding.
    """
    Bn, H, ds, dc = B_seq.shape
    J = torch.cat([A_seq, B_seq], dim=-1)                          # (B, H, ds, ds+dc)
    eye = reg * torch.eye(dc, dtype=B_seq.dtype, device=B_seq.device)
    C = torch.cat([
        torch.cat([Cxx, Cux.transpose(-1, -2), cx[..., None]], dim=-1),
        torch.cat([Cux, Cuu + eye, cu[..., None]], dim=-1),
    ], dim=-2)                                                     # (B, H, ds+dc, ds+dc+1)
    V, v = Vf, vf[..., None]
    Ks, ks, qus, Quus = [], [], [], []
    for t in range(H - 1, -1, -1):
        Jt = J[:, t]
        # The value propagated through the defect: v_eff = v + V d.
        v_eff = torch.baddbmm(v, V, d_seq[:, t, :, None])
        G = torch.baddbmm(C[:, t], Jt.transpose(1, 2), torch.cat([V @ Jt, v_eff], dim=-1))
        Qxx, Qux, Quu = G[:, :ds, :ds], G[:, ds:, :ds], G[:, ds:, ds:ds + dc]
        qx, qu = G[:, :ds, -1:], G[:, ds:, -1:]
        sol = -solve_small(Quu, G[:, ds:])
        K, k = sol[..., :ds], sol[..., -1:]
        KT, QuxT = K.transpose(1, 2), Qux.transpose(1, 2)
        V = torch.baddbmm(torch.baddbmm(Qxx, QuxT, K), KT, Qux)
        V = torch.baddbmm(V, KT @ Quu, K)
        V = 0.5 * (V + V.transpose(1, 2))
        v = torch.baddbmm(torch.baddbmm(qx, QuxT, k), KT, torch.baddbmm(qu, Quu, k))
        Ks.append(K)
        ks.append(k)
        qus.append(qu)
        Quus.append(Quu)
    Ks, kc = torch.stack(Ks[::-1], dim=1), torch.stack(ks[::-1], dim=1)   # kc (B, H, dc, 1)
    dV1 = (kc * torch.stack(qus[::-1], dim=1)).sum((1, 2, 3))
    dV2 = (kc * (torch.stack(Quus[::-1], dim=1) @ kc)).sum((1, 2, 3))
    return Ks, kc[..., 0], dV1, dV2


def qp_backward_assoc(A_seq, B_seq, Cxx, Cuu, Cux, cx, cu, d_seq, Vf, vf, reg=1e-8):
    """``qp_backward`` in O(log H) depth: the associative-scan Riccati
    with the defects in its affine part
    (``ops/riccati.py::tvlqr_backward_assoc``). Requires Cux = 0, true
    of the separable objectives ``make_sqp_solver`` builds; matches
    ``qp_backward`` up to its per-step symmetrization (rounding)."""
    del Cux  # zero by construction; the element algebra assumes it
    return tvlqr_backward_assoc(A_seq, B_seq, Cxx, Cuu, cx, cu, Vf, vf, d_seq=d_seq, reg=reg)


def qp_forward(A_seq, B_seq, d_seq, Ks, ks, alpha=1.0, dx0=None):
    """Forward recovery of the QP step: du_t = alpha k_t + K_t dx_t,
    dx_{t+1} = A_t dx_t + B_t du_t + alpha d_t, from dx_0 = ``dx0``
    (B, ds) (zeros by default).

    The sequences lead with the lane axis B. ``alpha`` is a number or a
    1-D tensor of L step sizes; with a tensor every step size is
    recovered at once, as an axis after the lanes' (the SQP line
    search's candidates). Returns dxs (B, [L,] H+1, ds) and dus
    (B, [L,] H, dc).
    """
    Bn, H, ds, _ = A_seq.shape
    J = torch.cat([A_seq, B_seq], dim=-1)                          # (B, H, ds, ds+dc)
    if isinstance(alpha, torch.Tensor):
        L = alpha.numel()
        a = alpha.to(A_seq.dtype).reshape(1, L, 1, 1)
        J, Ks = J[:, None], Ks[:, None]
        ak, ad = a * ks[:, None], a * d_seq[:, None]               # (B, L, H, .)
        lead = (Bn, L)
        dx0 = None if dx0 is None else dx0[:, None]
    else:
        ak, ad = alpha * ks, alpha * d_seq
        lead = (Bn,)
    dx = A_seq.new_zeros(lead + (ds,)) if dx0 is None else dx0.expand(lead + (ds,))
    dxs, dus = [dx], []
    for t in range(H):
        du = ak.select(-2, t) + (Ks.select(-3, t) @ dx[..., None])[..., 0]
        dx = (J.select(-3, t) @ torch.cat([dx, du], dim=-1)[..., None])[..., 0] \
            + ad.select(-2, t)
        dxs.append(dx)
        dus.append(du)
    return torch.stack(dxs, dim=-2), torch.stack(dus, dim=-2)


def solve_traj_qp(A_seq, B_seq, Cxx, Cuu, Cux, cx, cu, d_seq, Vf, vf, reg=1e-8, alpha=1.0):
    """One-call structured KKT solve of B lanes: returns (dxs, dus)."""
    Ks, ks, _, _ = qp_backward(A_seq, B_seq, Cxx, Cuu, Cux, cx, cu, d_seq, Vf, vf, reg)
    return qp_forward(A_seq, B_seq, d_seq, Ks, ks, alpha=alpha)
