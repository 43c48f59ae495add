"""Regression routines for system identification (port of
``autompc_tpu/ops/lstsq.py``): SVD least squares, the pseudo-inverse,
STLSQ, and the Gram-staged STLSQ the SINDy trainer uses, and the FISTA
Lasso.

All routines run on whatever device their inputs live on; the
iteration of ``stlsq_gram`` stops on the host once the support is
unchanged, which is result-identical to the JAX package's bounded
``while_loop``.

``stlsq_gram`` and ``fista_lasso`` also train many lanes at once on one
data set, one regularizer a lane (a threshold or alpha of shape (B,)):
the joint fan-out's per-lane models, as the JAX package's ``vmap`` of
them. A lane's result is its own unbatched run's: an STLSQ lane whose
support has stopped changing keeps it while the others iterate. The
lanes go through in chunks (``lane_chunk``; by default as many as keep
the batched factors under ``CHUNK_BYTES``), which changes no lane's
result.
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


def pinv(A, rcond=1e-15):
    """Moore-Penrose pseudo-inverse. ``rcond`` keeps ``jnp.linalg.pinv``'s
    meaning, a cutoff relative to the largest singular value: that is
    ``torch.linalg.pinv``'s ``rtol``."""
    return torch.linalg.pinv(A, rtol=rcond)


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


# Bytes the batched Gram factors of one chunk of lanes may take (the
# (lanes, k, d, d) scaled systems and their Cholesky factors).
CHUNK_BYTES = 1 << 30


def _lane_chunk(lane_chunk, per_lane_bytes):
    if lane_chunk is not None:
        return max(1, int(lane_chunk))
    return max(1, CHUNK_BYTES // max(1, per_lane_bytes))


def stlsq_gram(G, b, threshold, n_iters=10, ridge=1e-7, lane_chunk=None):
    """STLSQ on the normal equations ``G = A'A``, ``b = A'y``.

    Each masked (d, d) system is Jacobi-scaled to unit diagonal, pinned
    to 1 on pruned coordinates, given a relative ``ridge``, and solved
    by Cholesky plus two triangular solves. A system that is not
    positive definite yields NaN coefficients, as the JAX package's
    Cholesky does (the trainer then falls back to the SVD path; a lane
    of a batched fit gets an empty support, so zero coefficients).
    Returns (d, k); with a threshold a lane, ``threshold`` (B,), the
    (B, d, k) coefficients of every lane, trained ``lane_chunk`` lanes at
    a time with at most one host read a round (whether any lane of the
    chunk still changes its support) and at most ``n_iters`` rounds."""
    if b.ndim == 1:
        b = b[:, None]
    gdiag = torch.diagonal(G)

    def solve_with_support(support):
        sup = support.mT                                    # (..., k, d)
        s = torch.where(
            sup > 0, 1.0 / torch.sqrt(torch.clamp(gdiag, min=1e-30)),
            torch.zeros_like(sup),
        )
        Gs = s[..., :, None] * G * s[..., None, :]
        Gs.diagonal(dim1=-2, dim2=-1).add_((1.0 - sup) + ridge * sup)
        L, info = torch.linalg.cholesky_ex(Gs)
        L = torch.where((info != 0)[..., None, None], torch.nan, L)
        rhs = (b.mT * s)[..., None]
        y_ = torch.linalg.solve_triangular(L, rhs, upper=False)
        sol = torch.linalg.solve_triangular(L.mT, y_, upper=True)[..., 0]
        return (sol * s).mT

    thr = torch.as_tensor(threshold, dtype=G.dtype, device=G.device)
    if thr.ndim == 0:
        support = torch.ones(b.shape, dtype=G.dtype, device=G.device)
        for _ in range(n_iters):
            coefs = solve_with_support(support)
            new_support = (coefs.abs() >= thr).to(G.dtype)
            changed = bool((new_support != support).any())
            support = new_support
            if not changed:
                break
        return solve_with_support(support)

    d, k = b.shape
    chunk = _lane_chunk(lane_chunk, 2 * k * d * d * G.element_size())
    out = []
    for t in thr.split(chunk):
        t3 = t[:, None, None]
        support = torch.ones((t.shape[0], d, k), dtype=G.dtype, device=G.device)
        live = torch.ones(t.shape[0], dtype=torch.bool, device=G.device)
        for _ in range(n_iters):
            new_support = (solve_with_support(support).abs() >= t3).to(G.dtype)
            changed = (new_support != support).any(dim=(1, 2))
            # A lane that has stopped keeps its support (JAX's batched
            # while_loop keeps a finished lane's carry).
            support = torch.where(live[:, None, None], new_support, support)
            live = live & changed
            if not bool(live.any()):
                break
        out.append(solve_with_support(support))
    return torch.cat(out)


def soft_threshold(x, thresh):
    return torch.sign(x) * torch.clamp(x.abs() - thresh, min=0.0)


def fista_lasso(A, y, alpha, n_iters=200, mask=None, lane_chunk=None):
    """FISTA proximal-gradient Lasso: minimizes ``1/(2N) ||A w - y||^2 +
    alpha ||w||_1`` per target column (sklearn's scaling, N the valid
    rows) with a fixed iteration budget; the step is 1/L from 30 power
    iterations on A'A. Returns (d, k) coefficients; with an alpha a lane,
    ``alpha`` (B,), the (B, d, k) coefficients of every lane (the power
    iteration and the step shared, the iterate (B, d, k)), ``lane_chunk``
    lanes at a time."""
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
    a = torch.as_tensor(alpha, dtype=A.dtype, device=A.device)
    lanes = a.ndim == 1

    def run(a_):
        shape = ((a_.shape[0],) if lanes else ()) + (A.shape[1], y.shape[1])
        thresh = step * (a_[:, None, None] if lanes else a_)
        w = z = A.new_zeros(shape)
        t = 1.0
        for _ in range(n_iters):
            w_next = soft_threshold(z - step * (AtA @ z - Aty), thresh)
            t_next = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
            z = w_next + ((t - 1.0) / t_next) * (w_next - w)
            w, t = w_next, t_next
        return w

    if not lanes:
        return run(a)
    chunk = _lane_chunk(lane_chunk, 4 * A.shape[1] * y.shape[1] * A.element_size())
    return torch.cat([run(part) for part in a.split(chunk)])
