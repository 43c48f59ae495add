"""K1: batched dynamics relinearization for linear-in-features models
(port of ``autompc_tpu/ops/pallas_relin.py``; kernel in
``csrc/relin.cu``).

``relin_jacobians`` computes ``J(x_t, u_t) = coeffs . dTheta/dz`` at
every (step, lane) of a lanes-last trajectory and returns the packed
plane ``jac_p (H, ds*(ds+1), B)``, row ``i*(ds+1) + dd`` =
``d x'_i / d z_dd`` — the layout the backward and line-search kernels
consume. Only the sparse-gradient formulation is ported (the library's
descriptors give every term's nonzero partials); dc must be 1.

A CPU tensor takes the plain PyTorch twin ``relin_jacobians_plain``; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..sysid.basis import feature_jacobian_rows
from . import _build


def _shapes(terms, xsT, usT, coeffs):
    H, B = usT.shape
    ds = xsT.shape[1]
    if xsT.ndim != 3 or xsT.shape[0] != H + 1 or xsT.shape[2] != B:
        raise ValueError(
            f"xsT {tuple(xsT.shape)} must be (H+1, ds, B) with "
            f"usT (H, B) = {tuple(usT.shape)}"
        )
    if len(terms[0].exps) != ds + 1:
        raise ValueError(
            f"terms take {len(terms[0].exps)} inputs, expected ds + 1 = {ds + 1}"
        )
    if tuple(coeffs.shape) != (ds, len(terms)):
        raise ValueError(
            f"coeffs {tuple(coeffs.shape)} must be (ds, n_active) = {(ds, len(terms))}"
        )
    return H, ds, B


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
    built = _build.KERNEL_SHAPES["relin"]
    if (ds, 1) not in built:
        raise ValueError(
            f"relin kernel is built for (ds, dc) in {built}, got {(ds, 1)}"
        )
    dev, f32 = xsT.device, torch.float32
    _build.check_cuda("xsT", xsT, (H + 1, ds, B), f32, dev)
    _build.check_cuda("usT", usT, (H, B), f32, dev)
    _build.check_cuda("coeffs", coeffs, (ds, len(terms)), f32, dev)
    out = torch.empty((H, ds * (ds + 1), B), dtype=f32, device=dev)
    rc = _build.library().ampc_relin_jacobians(
        ctypes.byref(_build.feat_table(tuple(terms))),
        _build.ptr(coeffs), _build.ptr(xsT), _build.ptr(usT), _build.ptr(out),
        ds, H, B, dev.index or 0, _build.stream_of(xsT),
    )
    _build.check_rc("relin_jacobians", rc)
    relin_jacobians.launches += 1
    return out


relin_jacobians.launches = 0
