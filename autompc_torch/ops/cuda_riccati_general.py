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

The main library holds hand-set instances at (18, 6) and (4, 1)
(``_build.KERNEL_SHAPES["riccati_general"]``); any other (ds, dc) with
ds + dc <= ``_build.MAX_D`` is compiled at first use
(``_build.kernel_library``) as the instance of a rule that sets the
tiles, threads a lane, ring and block from (ds, dc) (``general_shape``);
a shape past the limits raises ``ValueError`` before any build
(``check_general_shape``). Its launch geometry (threads a lane, lanes a
block) is chosen here, by ``general_geometry``. A CPU tensor takes the plain
PyTorch version ``riccati_general_plain``; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import functools
import math

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


# Per hand-set instance (ds, dc): threads a lane, the most lanes a block
# takes, register tiles (rows x columns) of the products ([Jx|Ju]'[V|v];
# Qxx and Qux; Quu; the next V) and steps in the input ring; a mirror of
# the RgShape specialisations in csrc/riccati_general.cu, which the main
# library holds. With 64 or more threads a lane and dc > 1 the last warp
# forms and factors Quu while the others form Qxx and Qux.
GENERAL_SHAPES = {
    (18, 6): dict(threads_per_lane=64, max_lanes=4, p1=(4, 2), p2=(3, 6), pu=(2, 2),
                  p5=(2, 3), ring=3),
    (4, 1): dict(threads_per_lane=8, max_lanes=32, p1=(1, 5), p2=(1, 4), pu=(1, 1),
                 p5=(1, 4), ring=6),
}


def _up4(n):
    return -(-n // 4) * 4


def _pow2(n):
    """The smallest power of two >= n (csrc: rg_pow2)."""
    p = 1
    while p < n:
        p *= 2
    return p


def _divisor(n, m):
    """The largest divisor of n that is at most m (csrc: rg_divisor)."""
    d = min(n, m)
    while n % d:
        d -= 1
    return d


def _slot(ds, dc):
    """Floats of one ring slot (csrc: rg_slot)."""
    return _up4(ds * (ds + dc)) + _up4(ds * ds) + _up4(dc * dc) + _up4(ds) + _up4(dc)


def rule_threads(ds, dc):
    """Threads a lane of the rule's instance (csrc: rg_tpl): ds (ds + dc)
    / 8 rounded up to a power of two, from 8 to 64, and at least ds + dc
    rounded up to a power of two."""
    return max(min(max(_pow2(-(-ds * (ds + dc) // 8)), 8), 64), _pow2(ds + dc))


def general_shape(ds, dc, rule=False):
    """K4's instance at (ds, dc): the hand-set tiling of the main library
    (``GENERAL_SHAPES``), else (or with ``rule``) the tiling of the
    primary ``RgShape`` template that a library built at first use holds:
    the tiles' widths divisors of the products' dimensions, a ring of
    3072 / slot steps (2 to 6), 256 threads a block up to a warp a lane
    and 4 lanes from two warps on."""
    if not rule and (ds, dc) in GENERAL_SHAPES:
        return GENERAL_SHAPES[(ds, dc)]
    tpl = rule_threads(ds, dc)
    return dict(threads_per_lane=tpl, max_lanes=256 // tpl if tpl <= 32 else 4,
                p1=(_divisor(ds + dc, 2), 4), p2=(_divisor(math.gcd(ds, dc), 2), _divisor(ds, 4)),
                pu=(_divisor(dc, 2), _divisor(dc, 2)), p5=(_divisor(ds, 2), 4),
                ring=min(max(3072 // _slot(ds, dc), 2), 6))


def general_lane_bytes(ds, dc, rule=False):
    """Shared memory of one lane (RgLayout in csrc/riccati_general.cu):
    the input ring and the recursion's matrices, each region padded to
    16 bytes, the row strides to whole tiles."""
    sh = general_shape(ds, dc, rule)
    nj, nv = ds + dc, ds + 1
    sv = _up4(-(-nv // sh["p1"][1]) * sh["p1"][1])
    sq = _up4(max(-(-ds // sh["p5"][1]) * sh["p5"][1], nv))
    work = (_up4(ds * sv) + _up4(ds * nj) + _up4(nj * sq) + _up4(dc * dc) + _up4(dc)
            + _up4(dc * sq) + _up4(dc * ds) + _up4(dc * dc) + _up4(dc))
    return 4 * (sh["ring"] * _slot(ds, dc) + work)


def check_general_shape(ds, dc):
    """Raise ``ValueError`` by name unless K4 takes (ds, dc): ds + dc <=
    ``_build.MAX_D`` and the largest block of the instance (its
    ``max_lanes`` lanes) within the shared memory of a block. Called
    before any build or launch."""
    _build.check_shape("riccati_general", ds, dc)
    sh = general_shape(ds, dc)
    need = sh["max_lanes"] * general_lane_bytes(ds, dc)
    if need > _build.MAX_SMEM_BYTES:
        raise ValueError(f"riccati_general: {sh['max_lanes']} lanes at (ds, dc) = {(ds, dc)} "
                         f"take {need} bytes of shared memory, over "
                         f"{_build.MAX_SMEM_BYTES}")


@functools.lru_cache(maxsize=256)
def general_geometry(ds, dc, B, sm_count=None, rule=False):
    """K4's launch geometry at (ds, dc) for B lanes: the instance's
    ``threads_per_lane`` threads share a lane (two warps at (18, 6), 8 at
    (4, 1), ``rule_threads`` elsewhere or with ``rule``), and a block takes
    ``lanes_per_block`` lanes, the most (up to the instance's limit, in
    powers of two from one warp) that still leaves a block for every one
    of ``sm_count`` SMs (an H100's 132 when not given), so a small batch
    spreads over as many SMs as it has lanes and a large one makes fewer,
    larger blocks. Raises ``ValueError`` past the kernel's limits
    (``check_general_shape``)."""
    check_general_shape(ds, dc)
    sms = sm_count or _build.H100_SMS
    sh = general_shape(ds, dc, rule)
    tpl = sh["threads_per_lane"]
    lanes = max(1, 32 // tpl)
    while 2 * lanes <= sh["max_lanes"] and -(-B // (2 * lanes)) >= sms:
        lanes *= 2
    return dict(threads_per_lane=tpl, lanes_per_block=lanes, threads=lanes * tpl,
                blocks=-(-B // lanes), smem=lanes * general_lane_bytes(ds, dc, rule))


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
    ds, dc = _shapes(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn)[2:]
    check_general_shape(ds, dc)
    return launch(_build.kernel_library("riccati_general", ds, dc), False,
                  Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn)


def launch(lib, rule, Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn):
    """K4 from the library ``lib`` on CUDA tensors: the main library's
    hand-set instance, or (``rule``) the rule's instance of a library
    built at first use (``_build.shape_library``; at (18, 6) and (4, 1)
    it stands beside the hand-set one). Counted as a launch of
    ``riccati_general``."""
    B, H, ds, dc = _shapes(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn)
    dev, f32 = Jx.device, torch.float32
    g = general_geometry(ds, dc, B, _build.sm_count(dev), rule)
    for name, t in (("Jx", Jx), ("Ju", Ju), ("Cxx", Cxx), ("Cuu", Cuu),
                    ("cx", cx), ("cu", cu), ("Vn", Vn), ("vn", vn)):
        _build.check_cuda(name, t, t.shape, f32, dev)
    Ks = torch.empty((B, H, dc, ds), dtype=f32, device=dev)
    ks = torch.empty((B, H, dc), dtype=f32, device=dev)
    lin = torch.empty((B,), dtype=f32, device=dev)
    quad = torch.empty((B,), dtype=f32, device=dev)
    p = _build.ptr
    rc = lib.ampc_riccati_general(
        p(Jx), p(Ju), p(Cxx), p(Cuu), p(cx), p(cu), p(Vn), p(vn),
        p(Ks), p(ks), p(lin), p(quad), ds, dc, H, B, g["lanes_per_block"],
        g["threads_per_lane"], dev.index or 0, _build.stream_of(Jx),
    )
    _build.check_rc("riccati_general", rc)
    riccati_general.launches += 1
    riccati_general.launches_by_B[B] = riccati_general.launches_by_B.get(B, 0) + 1
    return Ks, ks, lin, quad


riccati_general.launches = 0
riccati_general.launches_by_B = {}
