"""K4: batch-major Riccati backward pass for any (ds, dc) from dense
stage expansions (port of ``autompc_tpu/ops/pallas_riccati.py``'s
``pallas_tvlqr_backward_general`` and, at dc = 1,
``pallas_tvlqr_backward``; kernel in ``csrc/riccati_general.cu``).

For t = H-1 .. 0, per lane: Quu = Cuu + Ju'V Ju, Qux = Ju'V Jx,
qu = cu + Ju'v; Cholesky Quu = L L' without pivoting or regularization
(at dc = 1 the reciprocal of the scalar Quu);
K = -Quu^-1 Qux and k = -Quu^-1 qu by forward and back substitution;
lin += qu.k, quad += k'Quu k; V <- Qxx + Qux'K + K'Qux + K'Quu K,
v <- qx + Qux'k + K'(qu + Quu k). A Quu that is not positive definite
gives NaN gains for that lane, as in the JAX kernel; nothing guards or
regularizes it.

The kernel is instantiated for the (ds, dc) pairs of
``_build.KERNEL_SHAPES["riccati_general"]``; another pair raises
``ValueError``. A CPU tensor takes the plain PyTorch version
``riccati_general_plain``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .riccati import tvlqr_backward_scan


def chol_solve(A, b):
    """``A x = b`` by the kernel's unrolled Cholesky: A (B, n, n)
    symmetric positive definite, b (B, n, m). No pivoting; a
    non-positive pivot gives NaN. At n = 1 the kernel multiplies by the
    reciprocal of the scalar, as the JAX dc = 1 kernel does, and a
    negative A gives finite values."""
    n = A.shape[-1]
    if n == 1:
        return b * (1.0 / A[:, 0, 0])[:, None, None]

    def minus_sum(head, terms):
        # head - (t0 + t1 + ...): the kernel's left fold, then one
        # subtraction.
        if not terms:
            return head
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        return head - acc

    L = [[None] * n for _ in range(n)]
    inv = [None] * n
    for a in range(n):
        L[a][a] = torch.sqrt(
            minus_sum(A[:, a, a], [L[a][m] * L[a][m] for m in range(a)])
        )
        inv[a] = 1.0 / L[a][a]
        for r in range(a + 1, n):
            L[r][a] = minus_sum(
                A[:, r, a], [L[r][m] * L[a][m] for m in range(a)]
            ) * inv[a]
    y = [None] * n
    for a in range(n):
        y[a] = minus_sum(
            b[:, a], [L[a][m][:, None] * y[m] for m in range(a)]
        ) * inv[a][:, None]
    x = [None] * n
    for a in range(n - 1, -1, -1):
        x[a] = minus_sum(
            y[a], [L[r][a][:, None] * x[r] for r in range(a + 1, n)]
        ) * inv[a][:, None]
    return torch.stack(x, dim=1)


def _shapes(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn):
    if Ju.ndim != 4:
        raise ValueError(f"Ju: shape {tuple(Ju.shape)}, expected (B, H, ds, dc)")
    B, H, ds, dc = Ju.shape
    want = {
        "Jx": (Jx, (B, H, ds, ds)), "Cxx": (Cxx, (B, H, ds, ds)),
        "Cuu": (Cuu, (B, H, dc, dc)), "cx": (cx, (B, H, ds)),
        "cu": (cu, (B, H, dc)), "Vn": (Vn, (B, ds, ds)), "vn": (vn, (B, ds)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    return B, H, ds, dc


def riccati_general_plain(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn):
    """Plain PyTorch version of the kernel: the batched scan recursion
    with the kernel's Cholesky solve."""
    _shapes(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn)
    return tvlqr_backward_scan(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn, solve=chol_solve)


def riccati_general(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn):
    """Riccati backward pass from dense expansions.

    Jx (B, H, ds, ds), Ju (B, H, ds, dc), Cxx (B, H, ds, ds), Cuu
    (B, H, dc, dc), cx (B, H, ds), cu (B, H, dc), Vn (B, ds, ds),
    vn (B, ds). Returns (Ks (B, H, dc, ds), ks (B, H, dc), lin_red
    (B,), quad_red (B,))."""
    if _build.device_kind(Jx) == "cpu":
        return riccati_general_plain(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn)
    B, H, ds, dc = _shapes(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn)
    built = _build.KERNEL_SHAPES["riccati_general"]
    if (ds, dc) not in built:
        raise ValueError(
            f"general backward kernel is built for (ds, dc) in {built}, "
            f"got {(ds, dc)}"
        )
    dev, f32 = Jx.device, torch.float32
    for name, t in (("Jx", Jx), ("Ju", Ju), ("Cxx", Cxx), ("Cuu", Cuu),
                    ("cx", cx), ("cu", cu), ("Vn", Vn), ("vn", vn)):
        _build.check_cuda(name, t, t.shape, f32, dev)
    Ks = torch.empty((B, H, dc, ds), dtype=f32, device=dev)
    ks = torch.empty((B, H, dc), dtype=f32, device=dev)
    lin = torch.empty((B,), dtype=f32, device=dev)
    quad = torch.empty((B,), dtype=f32, device=dev)
    p = _build.ptr
    rc = _build.library().ampc_riccati_general(
        p(Jx), p(Ju), p(Cxx), p(Cuu), p(cx), p(cu), p(Vn), p(vn),
        p(Ks), p(ks), p(lin), p(quad), ds, dc, H, B,
        dev.index or 0, _build.stream_of(Jx),
    )
    _build.check_rc("riccati_general", rc)
    riccati_general.launches += 1
    return Ks, ks, lin, quad


riccati_general.launches = 0
