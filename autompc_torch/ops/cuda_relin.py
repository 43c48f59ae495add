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
us (B, H, dc) in place and returns Jx (B, H, ds, ds) and Ju (B, H, ds,
dc): the contract of ``pallas_feature_jacobians`` itself, for the
batch-major solver body, at any (ds, dc) with ds + dc <=
``_build.MAX_D`` (the lanes-last entry, whose packed plane feeds the
dc = 1 kernels, takes dc = 1). At the same point both entries give the
same numbers, bit for bit.

Both take ``coeffs`` shared by every lane, (ds, n), or one model a lane,
a lanes-last (ds, n, B) plane (``coeffs.ndim == 3`` of the TPU entry,
the joint fan-out's per-lane models): the per-lane instances read lane
b's column where the shared ones read the plane staged in shared
memory, and walk up to ``_build.MAX_F_LANE`` terms (the shared ones
``_build.MAX_F``) from a device-resident table; given B copies of one
matrix they return the shared instance's bits. The per-lane instances
are built at (4, 1) only.

The shared instances are built for (4, 1) with the kernel library; any
other (ds, dc) is compiled at first use (``_build.kernel_library``).
Only the sparse-gradient formulation is ported (the library's
descriptors give every term's nonzero partials).

A CPU tensor takes the plain PyTorch twin (``relin_jacobians_plain``,
``relin_jacobians_bm_plain``); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..sysid.basis import feature_jacobian_rows
from . import _build


def _check_terms(terms, ds, coeffs, B, dc=1):
    """Raise unless the terms take ds + dc inputs and ``coeffs`` is
    (ds, n) or a lanes-last (ds, n, B) plane; True for the plane."""
    n = len(terms[0].exps)
    if n != ds + dc:
        raise ValueError(
            f"terms take {n} inputs (ds = {ds} with dc = {n - ds}), expected ds + dc = "
            f"{ds + dc}"
        )
    lane = coeffs.ndim == 3
    want = (ds, len(terms), B) if lane else (ds, len(terms))
    if tuple(coeffs.shape) != want:
        raise ValueError(
            f"coeffs {tuple(coeffs.shape)} must be (ds, n_active) = {want[:2]} or "
            f"per-lane coefficients as a lanes-last (ds, n_active, B) plane "
            f"{(ds, len(terms), B)}"
        )
    return lane


def _shapes(terms, xsT, usT, coeffs):
    H, B = usT.shape
    ds = xsT.shape[1]
    if xsT.ndim != 3 or xsT.shape[0] != H + 1 or xsT.shape[2] != B:
        raise ValueError(
            f"xsT {tuple(xsT.shape)} must be (H+1, ds, B) with "
            f"usT (H, B) = {tuple(usT.shape)}"
        )
    _check_terms(terms, ds, coeffs, B)
    return H, ds, B


def _shapes_bm(terms, xs, us, coeffs):
    if xs.ndim != 3 or us.ndim != 3:
        raise ValueError(
            f"xs {tuple(xs.shape)} must be (B, H+1, ds) and us "
            f"{tuple(us.shape)} (B, H, dc)"
        )
    B, H, dc = us.shape
    ds = xs.shape[2]
    if tuple(xs.shape[:2]) != (B, H + 1):
        raise ValueError(
            f"xs {tuple(xs.shape)} must be (B, H+1, ds) with us (B, H, dc) = "
            f"{tuple(us.shape)}"
        )
    _check_terms(terms, ds, coeffs, B, dc)
    return B, H, ds, dc


# Points a block holds (csrc/relin.cu): split, a warp per Jacobian column;
# whole, a thread per point; and the static shared memory a block may
# take (AMPC_RELIN_STATIC_SMEM).
RELIN_SPLIT_LANES = 32
RELIN_WHOLE_LANES = 256
RELIN_STATIC_SMEM = 48 * 1024
# Threads an SM holds at most: below this many points a card, split.
SM_THREADS = 2048


def relin_smem(ds, dc, bm, lanes):
    """Bytes of static shared memory of a K1 block of ``lanes`` points
    (csrc/relin.cu: relin_smem): the coefficient plane and, batch-major,
    the staged Jx and Ju rows."""
    n = lanes if bm else 1
    return 4 * (ds * _build.MAX_F + n * (ds * ds + 1) + n * (ds * dc + 1))


def relin_geometry(B, H, n_sm=_build.H100_SMS, ds=4, dc=1, bm=False):
    """K1's launch for B lanes x H steps at (ds, dc), in the lanes-last
    or (``bm``) the batch-major layout: ``split`` (a thread per (point,
    Jacobian column), 32 points a block, halved until the batch-major
    staging fits 48 KB: 16 at (18, 6)) where the points cannot fill the
    card once or where a block of 256 points' staging would not fit,
    else a thread per point, 256 points a block (both compute the same
    bits). ``lanes`` points, ``threads`` threads and ``smem`` bytes of
    shared memory a block; the grid is set in C from ``lanes``."""
    whole_fits = relin_smem(ds, dc, bm, RELIN_WHOLE_LANES) <= RELIN_STATIC_SMEM
    split = B * H < n_sm * SM_THREADS or not whole_fits
    lanes = RELIN_SPLIT_LANES
    while lanes > 1 and relin_smem(ds, dc, bm, lanes) > RELIN_STATIC_SMEM:
        lanes //= 2
    if not split:
        lanes = RELIN_WHOLE_LANES
    return dict(split=split, lanes=lanes, threads=lanes * ((ds + dc) if split else 1),
                smem=relin_smem(ds, dc, bm, lanes))


def _count(wrapper, B, lane):
    """One launch of ``wrapper``'s kernel at batch B; ``launches_lane``
    (and ``launches_lane_by_B``) count the per-lane instances' share."""
    wrapper.launches += 1
    wrapper.launches_by_B[B] = wrapper.launches_by_B.get(B, 0) + 1
    if lane:
        wrapper.launches_lane += 1
        wrapper.launches_lane_by_B[B] = wrapper.launches_lane_by_B.get(B, 0) + 1


def _table_args(terms, lane, dev):
    """The leading arguments of a launch: the table by value (shared
    coefficients) or the device table and its term count (per lane)."""
    if lane:
        return [_build.ptr(_build.feat_table_dev(tuple(terms), dev)), len(terms)]
    return [ctypes.byref(_build.feat_table(tuple(terms)))]


def relin_jacobians_plain(terms, xsT, usT, coeffs):
    """Plain PyTorch twin of the kernel (same math and summation
    order)."""
    H, ds, B = _shapes(terms, xsT, usT, coeffs)
    z = [xsT[:H, i] for i in range(ds)] + [usT]
    # A per-lane plane's coeffs[i, k] is a (B,) row against the (H, B) slabs.
    return torch.stack(feature_jacobian_rows(terms, coeffs, z, ds), dim=1)


def relin_jacobians(terms, xsT, usT, coeffs):
    """Packed dynamics Jacobians along a lanes-last trajectory.

    terms: tuple of active ``TermDesc``; xsT (H+1, ds, B); usT
    (H, B); coeffs (ds, len(terms)) or per lane (ds, len(terms), B).
    Returns jac_p (H, ds*(ds+1), B)."""
    if _build.device_kind(xsT) == "cpu":
        return relin_jacobians_plain(terms, xsT, usT, coeffs)
    H, ds, B = _shapes(terms, xsT, usT, coeffs)
    lane = coeffs.ndim == 3
    _build.check_table_size(len(terms), lane)
    lib = _build.kernel_library("relin", ds, 1, lane)
    dev, f32 = xsT.device, torch.float32
    _build.check_cuda("xsT", xsT, (H + 1, ds, B), f32, dev)
    _build.check_cuda("usT", usT, (H, B), f32, dev)
    _build.check_cuda("coeffs", coeffs, coeffs.shape, f32, dev)
    out = torch.empty((H, ds * (ds + 1), B), dtype=f32, device=dev)
    split = relin_geometry(B, H, _build.sm_count(dev), ds)["split"]
    entry = lib.ampc_relin_jacobians_lane if lane else lib.ampc_relin_jacobians
    rc = entry(
        *_table_args(terms, lane, dev),
        _build.ptr(coeffs), _build.ptr(xsT), _build.ptr(usT), _build.ptr(out),
        ds, H, B, int(split), dev.index or 0, _build.stream_of(xsT),
    )
    _build.check_rc("relin_jacobians", rc)
    _count(relin_jacobians, B, lane)
    return out


relin_jacobians.launches = 0
relin_jacobians.launches_by_B = {}
relin_jacobians.launches_lane = 0
relin_jacobians.launches_lane_by_B = {}


def relin_jacobians_bm_plain(terms, xs, us, coeffs):
    """Plain PyTorch twin of the batch-major entry: the lanes-last
    twin's math at every (lane, step)."""
    B, H, ds, dc = _shapes_bm(terms, xs, us, coeffs)
    z = [xs[:, :H, i] for i in range(ds)] + [us[:, :, j] for j in range(dc)]
    if coeffs.ndim == 3:
        coeffs = coeffs[..., None]      # coeffs[i, k]: (B, 1) against (B, H)
    jac = torch.stack(feature_jacobian_rows(terms, coeffs, z, ds), dim=-1)
    jac = jac.reshape(B, H, ds, ds + dc)
    return jac[..., :ds].contiguous(), jac[..., ds:].contiguous()


def relin_jacobians_bm(terms, xs, us, coeffs):
    """Dynamics Jacobians along a batch-major trajectory.

    terms: tuple of active ``TermDesc``; xs (B, H+1, ds); us (B, H, dc);
    coeffs (ds, len(terms)) or per lane (ds, len(terms), B). Returns
    (Jx (B, H, ds, ds), Ju (B, H, ds, dc)) at the first H points, as
    ``pallas_feature_jacobians``."""
    if _build.device_kind(xs) == "cpu":
        return relin_jacobians_bm_plain(terms, xs, us, coeffs)
    B, H, ds, dc = _shapes_bm(terms, xs, us, coeffs)
    lane = coeffs.ndim == 3
    _build.check_table_size(len(terms), lane)
    lib = _build.kernel_library("relin", ds, dc, lane)
    dev, f32 = xs.device, torch.float32
    _build.check_cuda("xs", xs, (B, H + 1, ds), f32, dev)
    _build.check_cuda("us", us, (B, H, dc), f32, dev)
    _build.check_cuda("coeffs", coeffs, coeffs.shape, f32, dev)
    Jx = torch.empty((B, H, ds, ds), dtype=f32, device=dev)
    Ju = torch.empty((B, H, ds, dc), dtype=f32, device=dev)
    p = _build.ptr
    split = relin_geometry(B, H, _build.sm_count(dev), ds, dc, bm=True)["split"]
    if lane:
        rc = lib.ampc_relin_jacobians_bm_lane(
            *_table_args(terms, lane, dev), p(coeffs), p(xs), p(us), p(Jx), p(Ju), ds, H,
            B, int(split), dev.index or 0, _build.stream_of(xs))
    else:
        rc = lib.ampc_relin_jacobians_bm(
            *_table_args(terms, lane, dev), p(coeffs), p(xs), p(us), p(Jx), p(Ju), ds, dc,
            H, B, int(split), dev.index or 0, _build.stream_of(xs))
    _build.check_rc("relin_jacobians_bm", rc)
    _count(relin_jacobians_bm, B, lane)
    return Jx, Ju


relin_jacobians_bm.launches = 0
relin_jacobians_bm.launches_by_B = {}
relin_jacobians_bm.launches_lane = 0
relin_jacobians_bm.launches_lane_by_B = {}
