"""Regression routines for system identification (port of
``autompc_tpu/ops/lstsq.py``): SVD least squares, STLSQ, and the
Gram-staged STLSQ the SINDy trainer uses, and the FISTA Lasso.

All routines run on whatever device their inputs live on; the
iteration of ``stlsq_gram`` stops on the host once the support is
unchanged, which is result-identical to the JAX package's bounded
``while_loop``.
"""

from __future__ import annotations

import torch


def lstsq(A, y, rcond=None):
    """Minimum-norm least squares via the SVD, with
    ``jnp.linalg.lstsq``'s default cutoff ``eps * max(N, d) * s_max``
    (works on every device, unlike ``torch.linalg.lstsq`` on CUDA,
    which needs full rank)."""
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(A.dtype).eps * max(A.shape[-2:])
    cutoff = rcond * S.amax(-1, keepdim=True)
    s_inv = torch.where(S >= cutoff, 1.0 / S, torch.zeros_like(S))
    return Vh.mT @ (s_inv.unsqueeze(-1) * (U.mT @ y))


def masked_lstsq(A, y, mask, rcond=None):
    """Least squares over the rows of (A, y) selected by ``mask``
    (invalid rows are zeroed on both sides)."""
    m = mask.to(A.dtype)[:, None]
    ym = y * (m if y.ndim == 2 else m[:, 0])
    return lstsq(A * m, ym, rcond=rcond)


def stlsq(A, y, threshold, n_iters=10, mask=None):
    """Sequentially-thresholded least squares on the SVD path: solve on
    the support, zero ``|coef| < threshold``, re-solve. Returns (d, k)."""
    if y.ndim == 1:
        y = y[:, None]
    if mask is not None:
        m = mask.to(A.dtype)[:, None]
        A, y = A * m, y * m

    def solve_with_support(support):
        # One column per target: (k, N, d) masked systems, batched.
        Am = A[None] * support.mT[:, None, :]
        sol = lstsq(Am, y.mT[:, :, None])[..., 0]           # (k, d)
        return sol.mT * support

    support = torch.ones((A.shape[1], y.shape[1]), dtype=A.dtype, device=A.device)
    for _ in range(n_iters):
        coefs = solve_with_support(support)
        support = (coefs.abs() >= threshold).to(A.dtype)
    return solve_with_support(support)


def gram_stage(A, y, mask=None):
    """(G, b) = (A'A, A'y) with optional row masking."""
    if y.ndim == 1:
        y = y[:, None]
    if mask is not None:
        m = mask.to(A.dtype)[:, None]
        A, y = A * m, y * m
    return A.T @ A, A.T @ y


def stlsq_gram(G, b, threshold, n_iters=10, ridge=1e-7):
    """STLSQ on the normal equations ``G = A'A``, ``b = A'y``.

    Each masked (d, d) system is Jacobi-scaled to unit diagonal, pinned
    to 1 on pruned coordinates, given a relative ``ridge``, and solved
    by Cholesky plus two triangular solves. A system that is not
    positive definite yields NaN coefficients, as the JAX package's
    Cholesky does (the trainer then falls back to the SVD path).
    Returns (d, k)."""
    if b.ndim == 1:
        b = b[:, None]
    gdiag = torch.diagonal(G)

    def solve_with_support(support):
        sup = support.mT                                    # (k, d)
        s = torch.where(
            sup > 0, 1.0 / torch.sqrt(torch.clamp(gdiag, min=1e-30)),
            torch.zeros_like(sup),
        )
        Gs = s[:, :, None] * G[None] * s[:, None, :]
        Gs = Gs + torch.diag_embed((1.0 - sup) + ridge * sup)
        L, info = torch.linalg.cholesky_ex(Gs)
        L = torch.where((info != 0)[:, None, None], torch.nan, L)
        rhs = (b.mT * s)[:, :, None]
        y_ = torch.linalg.solve_triangular(L, rhs, upper=False)
        sol = torch.linalg.solve_triangular(L.mT, y_, upper=True)[..., 0]
        return (sol * s).mT

    support = torch.ones(b.shape, dtype=G.dtype, device=G.device)
    for _ in range(n_iters):
        coefs = solve_with_support(support)
        new_support = (coefs.abs() >= threshold).to(G.dtype)
        changed = bool((new_support != support).any())
        support = new_support
        if not changed:
            break
    return solve_with_support(support)


def soft_threshold(x, thresh):
    return torch.sign(x) * torch.clamp(x.abs() - thresh, min=0.0)


def fista_lasso(A, y, alpha, n_iters=200, mask=None):
    """FISTA proximal-gradient Lasso: minimizes ``1/(2N) ||A w - y||^2 +
    alpha ||w||_1`` per target column (sklearn's scaling, N the valid
    rows) with a fixed iteration budget; the step is 1/L from 30 power
    iterations on A'A. Returns (d, k) coefficients."""
    if y.ndim == 1:
        y = y[:, None]
    if mask is not None:
        m = mask.to(A.dtype)[:, None]
        A, y = A * m, y * m
        N = torch.clamp(mask.sum().to(A.dtype), min=1.0)
    else:
        N = float(max(A.shape[0], 1))
    v = A.new_ones((A.shape[1],)) / A.shape[1] ** 0.5
    for _ in range(30):
        v = A.T @ (A @ v)
        v = v / (torch.linalg.vector_norm(v) + 1e-30)
    L = torch.dot(v, A.T @ (A @ v)) / N + 1e-12
    step = 1.0 / L
    AtA = (A.T @ A) / N
    Aty = (A.T @ y) / N
    w = z = A.new_zeros((A.shape[1], y.shape[1]))
    t = 1.0
    for _ in range(n_iters):
        w_next = soft_threshold(z - step * (AtA @ z - Aty), step * alpha)
        t_next = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
        z = w_next + ((t - 1.0) / t_next) * (w_next - w)
        w, t = w_next, t_next
    return w
