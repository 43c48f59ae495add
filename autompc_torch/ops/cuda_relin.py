"""K1: batched dynamics relinearization for linear-in-features models
(port of ``autompc_tpu/ops/pallas_relin.py``; kernel in
``csrc/relin.cu``).

Two entries compute ``J(x_t, u_t) = coeffs . dTheta/dz`` at every
(step, lane) of a trajectory, one kernel in two layouts:

``relin_jacobians`` takes a lanes-last trajectory and returns the packed
plane ``jac_p (H, ds*(ds+1), B)``, row ``i*(ds+1) + dd`` =
``d x'_i / d z_dd`` — the layout the lanes-last backward and line-search
kernels consume.

``relin_jacobians_bm`` takes the batch-major trajectory xs (B, H+1, ds),
us (B, H, 1) in place and returns Jx (B, H, ds, ds) and Ju (B, H, ds, 1):
the contract of ``pallas_feature_jacobians`` itself, for the batch-major
solver body. At the same point both entries give the same numbers, bit
for bit.

Only the sparse-gradient formulation is ported (the library's
descriptors give every term's nonzero partials); dc must be 1.

A CPU tensor takes the plain PyTorch twin (``relin_jacobians_plain``,
``relin_jacobians_bm_plain``); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..sysid.basis import feature_jacobian_rows
from . import _build


def _check_terms(terms, ds, coeffs):
    if len(terms[0].exps) != ds + 1:
        raise ValueError(
            f"terms take {len(terms[0].exps)} inputs, expected ds + 1 = {ds + 1}"
        )
    if tuple(coeffs.shape) != (ds, len(terms)):
        raise ValueError(
            f"coeffs {tuple(coeffs.shape)} must be (ds, n_active) = {(ds, len(terms))}"
        )


def _shapes(terms, xsT, usT, coeffs):
    H, B = usT.shape
    ds = xsT.shape[1]
    if xsT.ndim != 3 or xsT.shape[0] != H + 1 or xsT.shape[2] != B:
        raise ValueError(
            f"xsT {tuple(xsT.shape)} must be (H+1, ds, B) with "
            f"usT (H, B) = {tuple(usT.shape)}"
        )
    _check_terms(terms, ds, coeffs)
    return H, ds, B


def _shapes_bm(terms, xs, us, coeffs):
    if xs.ndim != 3 or us.ndim != 3 or us.shape[-1] != 1:
        raise ValueError(
            f"xs {tuple(xs.shape)} must be (B, H+1, ds) and us "
            f"{tuple(us.shape)} (B, H, 1): the kernel is built for dc = 1"
        )
    B, H = us.shape[:2]
    ds = xs.shape[2]
    if tuple(xs.shape[:2]) != (B, H + 1):
        raise ValueError(
            f"xs {tuple(xs.shape)} must be (B, H+1, ds) with us (B, H, 1) = "
            f"{tuple(us.shape)}"
        )
    _check_terms(terms, ds, coeffs)
    return B, H, ds


# Points a block holds (csrc/relin.cu): split, a warp per Jacobian column;
# whole, a thread per point.
RELIN_SPLIT_LANES = 32
RELIN_WHOLE_LANES = 256
# Threads an SM holds at most: below this many points a card, split.
SM_THREADS = 2048


def relin_geometry(B, H, n_sm=_build.H100_SMS):
    """K1's launch for B lanes x H steps: ``split`` (a thread per (point,
    Jacobian column), 32 points a block) where the points cannot fill
    the card once, else a thread per point, 256 points a block (both
    compute the same bits). ``lanes`` points and ``threads`` threads a
    block; the grid is set in C from ``lanes``."""
    split = B * H < n_sm * SM_THREADS
    lanes = RELIN_SPLIT_LANES if split else RELIN_WHOLE_LANES
    return dict(split=split, lanes=lanes, threads=lanes * (5 if split else 1))


def _count(wrapper, B):
    wrapper.launches += 1
    wrapper.launches_by_B[B] = wrapper.launches_by_B.get(B, 0) + 1


def _check_built(ds):
    built = _build.KERNEL_SHAPES["relin"]
    if (ds, 1) not in built:
        raise ValueError(
            f"relin kernel is built for (ds, dc) in {built}, got {(ds, 1)}"
        )


def relin_jacobians_plain(terms, xsT, usT, coeffs):
    """Plain PyTorch twin of the kernel (same math and summation
    order)."""
    H, ds, B = _shapes(terms, xsT, usT, coeffs)
    z = [xsT[:H, i] for i in range(ds)] + [usT]
    return torch.stack(feature_jacobian_rows(terms, coeffs, z, ds), dim=1)


def relin_jacobians(terms, xsT, usT, coeffs):
    """Packed dynamics Jacobians along a lanes-last trajectory.

    terms: tuple of active ``TermDesc``; xsT (H+1, ds, B); usT
    (H, B); coeffs (ds, len(terms)). Returns jac_p (H, ds*(ds+1), B)."""
    if _build.device_kind(xsT) == "cpu":
        return relin_jacobians_plain(terms, xsT, usT, coeffs)
    H, ds, B = _shapes(terms, xsT, usT, coeffs)
    _check_built(ds)
    dev, f32 = xsT.device, torch.float32
    _build.check_cuda("xsT", xsT, (H + 1, ds, B), f32, dev)
    _build.check_cuda("usT", usT, (H, B), f32, dev)
    _build.check_cuda("coeffs", coeffs, (ds, len(terms)), f32, dev)
    out = torch.empty((H, ds * (ds + 1), B), dtype=f32, device=dev)
    split = relin_geometry(B, H, _build.sm_count(dev))["split"]
    rc = _build.library().ampc_relin_jacobians(
        ctypes.byref(_build.feat_table(tuple(terms))),
        _build.ptr(coeffs), _build.ptr(xsT), _build.ptr(usT), _build.ptr(out),
        ds, H, B, int(split), dev.index or 0, _build.stream_of(xsT),
    )
    _build.check_rc("relin_jacobians", rc)
    _count(relin_jacobians, B)
    return out


relin_jacobians.launches = 0
relin_jacobians.launches_by_B = {}


def relin_jacobians_bm_plain(terms, xs, us, coeffs):
    """Plain PyTorch twin of the batch-major entry: the lanes-last
    twin's math at every (lane, step)."""
    B, H, ds = _shapes_bm(terms, xs, us, coeffs)
    z = [xs[:, :H, i] for i in range(ds)] + [us[:, :, 0]]
    jac = torch.stack(feature_jacobian_rows(terms, coeffs, z, ds), dim=-1)
    jac = jac.reshape(B, H, ds, ds + 1)
    return jac[..., :ds].contiguous(), jac[..., ds:].contiguous()


def relin_jacobians_bm(terms, xs, us, coeffs):
    """Dynamics Jacobians along a batch-major trajectory.

    terms: tuple of active ``TermDesc``; xs (B, H+1, ds); us (B, H, 1);
    coeffs (ds, len(terms)). Returns (Jx (B, H, ds, ds), Ju (B, H, ds, 1))
    at the first H points, as ``pallas_feature_jacobians``."""
    if _build.device_kind(xs) == "cpu":
        return relin_jacobians_bm_plain(terms, xs, us, coeffs)
    B, H, ds = _shapes_bm(terms, xs, us, coeffs)
    _check_built(ds)
    dev, f32 = xs.device, torch.float32
    _build.check_cuda("xs", xs, (B, H + 1, ds), f32, dev)
    _build.check_cuda("us", us, (B, H, 1), f32, dev)
    _build.check_cuda("coeffs", coeffs, (ds, len(terms)), f32, dev)
    Jx = torch.empty((B, H, ds, ds), dtype=f32, device=dev)
    Ju = torch.empty((B, H, ds, 1), dtype=f32, device=dev)
    p = _build.ptr
    split = relin_geometry(B, H, _build.sm_count(dev))["split"]
    rc = _build.library().ampc_relin_jacobians_bm(
        ctypes.byref(_build.feat_table(tuple(terms))),
        p(coeffs), p(xs), p(us), p(Jx), p(Ju), ds, H, B, int(split), dev.index or 0,
        _build.stream_of(xs),
    )
    _build.check_rc("relin_jacobians_bm", rc)
    _count(relin_jacobians_bm, B)
    return Jx, Ju


relin_jacobians_bm.launches = 0
relin_jacobians_bm.launches_by_B = {}
