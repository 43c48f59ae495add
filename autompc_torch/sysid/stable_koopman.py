"""Stable-Koopman solver: fit A = S^{-1} U B S with A Schur-stable (port
of ``autompc_tpu/sysid/stable_koopman.py``).

The projected fast-gradient method over the (S, U, B) parameterization:
eigendecompositions, the polar factorization (by the SVD), symmetric
square roots and the discrete Lyapunov solve (60 doublings) are tensor
operations on the device of the data. The JAX package's two bounded
``while_loop``s and its ``cond`` (the line search, the restart) are host
loops here with the same bounds and the same restart rule; each trial
step reads its error on the host.
"""

from __future__ import annotations

import math

import torch

from ..ops.lstsq import pinv


def project_psd(Q, epsilon=0.0, delta=math.inf):
    """Project onto the symmetric matrices with eigenvalues in
    [epsilon, delta]."""
    Q = (Q + Q.T) / 2
    e, V = torch.linalg.eigh(Q)
    e = torch.clamp(e, min=epsilon, max=delta)
    return (V * e) @ V.T


def polar(M):
    """Polar decomposition M = U P by the SVD."""
    W, s, Vt = torch.linalg.svd(M, full_matrices=False)
    U = W @ Vt
    P = Vt.T @ (s[:, None] * Vt)
    return U, P


def sqrtm_psd(P):
    """Symmetric PSD square root by the eigendecomposition."""
    e, V = torch.linalg.eigh(P)
    return (V * torch.sqrt(torch.clamp(e, min=0.0))) @ V.T


def solve_discrete_lyapunov(A, Q, iters=60):
    """X = A X A' + Q by the doubling iteration (``iters`` doublings;
    converges for a Schur-stable A)."""
    X, Ak = Q, A
    for _ in range(iters):
        X = X + Ak @ X @ Ak.T
        Ak = Ak @ Ak
    return X


def checkdstable(A):
    """The (P, S, U, B) certificate factorization of a stable A."""
    n = A.shape[0]
    P = solve_discrete_lyapunov(A.T, torch.eye(n, dtype=A.dtype, device=A.device))
    S = sqrtm_psd(P)
    invS = torch.linalg.inv(S)
    UB = S @ A @ invS
    U, B = polar(UB)
    B = project_psd(B, 0.0, 1.0)
    return P, S, U, B


def _error_and_grads(Xs, Xu, Y, S, U, B, Bcon):
    """Frobenius error of Y - Bcon Xu - S^{-1}UBS Xs and its gradients."""
    Sinv = torch.linalg.inv(S)
    R = Sinv @ U @ B @ S
    Err = Y - Bcon @ Xu - R @ Xs
    e = torch.linalg.norm(Err)
    temp1 = Sinv.T @ (-Err) @ Xs.T
    S_grad = -temp1 @ R.T + B.T @ U.T @ temp1
    U_grad = temp1 @ S.T @ B.T
    B_grad = -U.T @ (-temp1) @ S.T
    Bcon_grad = -Err @ Xu.T
    return e, S_grad, U_grad, B_grad, Bcon_grad


def stabilize_discrete(Xs, Xu, Y, max_iter=30, ls_max_iter=20, ls_param=1.5):
    """Fit (A, Bcon) with A Schur-stable by the fast gradient method over
    (S, U, B): the step doubles each iteration and backtracks by
    ``ls_param`` for at most ``ls_max_iter`` trials, each trial projected;
    momentum between iterates; a failed line search restarts from the
    current iterate, and a second failure in a row stops.

    Returns (A, S, U, B, Bcon, error)."""
    n = Xs.shape[0]
    na2 = float(torch.linalg.norm(Y))

    X = torch.cat([Xs, Xu], dim=0)
    temp = Y @ pinv(X)
    U0, B0 = polar(temp[:n, :n])
    B0 = project_psd(B0, 0.0, 1.0)
    Bcon0 = temp[:n, n:]
    S0 = torch.eye(n, dtype=Xs.dtype, device=Xs.device)

    eS = torch.linalg.eigvalsh(S0)
    L0 = float((eS.max() / eS.min()) ** 2)
    err0 = _error_and_grads(Xs, Xu, Y, S0, U0, B0, Bcon0)[0]
    alpha0 = 0.5

    def ls_trial(Ys, Yu, Yb, Ybc, gS, gU, gB, gBc, step):
        Sn = project_psd(Ys - gS * step, 1e-15)
        Un, _ = polar(Yu - gU * step)
        Bn = project_psd(Yb - gB * step, 0.0, 1.0)
        Bcn = Ybc - gBc * step
        return Sn, Un, Bn, Bcn, _error_and_grads(Xs, Xu, Y, Sn, Un, Bn, Bcn)[0]

    S, U, B, Bcon = S0, U0, B0, Bcon0
    Ys, Yu, Yb, Ybc = S0, U0, B0, Bcon0
    error, step, alpha, restarti = err0, 1.0 / L0, alpha0, 1
    i, done = 0, False
    while i < max_iter and not done:
        _, gS, gU, gB, gBc = _error_and_grads(Xs, Xu, Y, S, U, B, Bcon)
        step = step * 2.0
        Sn, Un, Bn, Bcn, e_next = ls_trial(Ys, Yu, Yb, Ybc, gS, gU, gB, gBc, step)
        step, it = step / ls_param, 1
        while float(e_next) > float(error) and it < ls_max_iter:
            Sn, Un, Bn, Bcn, e_next = ls_trial(Ys, Yu, Yb, Ybc, gS, gU, gB, gBc, step)
            step, it = step / ls_param, it + 1

        alpha_next = (math.sqrt(alpha**4 + 4 * alpha**2) - alpha**2) / 2
        beta = alpha * (1 - alpha) / (alpha**2 + alpha_next)
        if float(e_next) > float(error):
            # Restart from the current iterate; a second failure in a row
            # stops.
            Ys, Yu, Yb, Ybc = S, U, B, Bcon
            step, alpha = 1.0 / L0, alpha0
            stop = restarti == 0
            restarti = 0
        else:
            Ys, Yu = Sn + beta * (Sn - S), Un + beta * (Un - U)
            Yb, Ybc = Bn + beta * (Bn - B), Bcn + beta * (Bcn - Bcon)
            S, U, B, Bcon = Sn, Un, Bn, Bcn
            error, alpha, restarti, stop = e_next, alpha_next, 1, False
        i += 1
        done = stop or float(error) < 1e-12 * na2
    A = torch.linalg.inv(S) @ U @ B @ S
    return A, S, U, B, Bcon, error
