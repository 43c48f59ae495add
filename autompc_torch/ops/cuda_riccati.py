"""K2: lanes-last Riccati backward pass for a diagonal quadratic cost,
dc=1 (port of ``autompc_tpu/ops/pallas_riccati.py``'s
``pallas_tvlqr_backward_quad_ll``; kernel in ``csrc/riccati_quad.cu``).

The stage and terminal expansions of the fixed diagonal QuadCost are
built inline from the trajectory, so the solver passes only the packed
Jacobian plane, the trajectory and the cost diagonals. The other TPU
backward kernels (batch-major, dense-expansion, general dc) are not
ported yet (ROADMAP.md §B).

A CPU tensor takes the plain PyTorch twin ``backward_quad_ll_plain``; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def _shapes(jac_p, xsT, usT, qd, rd, fd, goal, obsdim, carry):
    H, dsd, B = jac_p.shape
    ds = xsT.shape[1]
    if dsd != ds * (ds + 1):
        raise ValueError(f"jac_p rows {dsd} != ds*(ds+1) = {ds * (ds + 1)}")
    if tuple(xsT.shape) != (H + 1, ds, B) or tuple(usT.shape) != (H, B):
        raise ValueError(
            f"xsT {tuple(xsT.shape)} / usT {tuple(usT.shape)} must be "
            f"(H+1, ds, B) / (H, B) for jac_p {tuple(jac_p.shape)}"
        )
    if not 1 <= obsdim <= ds or len(qd) != obsdim or len(fd) != obsdim \
            or len(goal) != obsdim or len(rd) != 1:
        raise ValueError(
            "cost diagonals must be qd/fd/goal of length obsdim "
            f"({obsdim} <= ds = {ds}) and rd of length 1 (dc = 1)"
        )
    act, oK, ok = carry
    if tuple(act.shape) != (B,) or tuple(oK.shape) != (H, ds, B) \
            or tuple(ok.shape) != (H, B):
        raise ValueError("carry must be (act (B,), Ks (H, ds, B), ks (H, B))")
    return H, ds, B


def backward_quad_ll_plain(jac_p, xsT, usT, qd, rd, fd, goal, dt, obsdim,
                           carry):
    """Plain PyTorch twin of the kernel: the JAX ``_bq_step`` recursion,
    term for term in the same order, on (B,) lane vectors."""
    H, ds, B = _shapes(jac_p, xsT, usT, qd, rd, fd, goal, obsdim, carry)
    d = ds + 1

    def c(v):
        return torch.tensor(float(v), dtype=xsT.dtype, device=xsT.device)

    def seq(vals):
        s = vals[0]
        for v in vals[1:]:
            s = s + v
        return s

    two_dt = c(2.0 * dt)
    qdv = [c(qd[i]) * two_dt for i in range(obsdim)]
    rd2 = c(rd[0]) * two_dt
    gl = [c(g) for g in goal]
    zero = xsT.new_zeros((B,))
    fd2 = [c(fd[i]) * 2.0 for i in range(obsdim)]
    V = [[(fd2[i] if (i == j and i < obsdim) else zero) + zero
          for j in range(ds)] for i in range(ds)]
    v = [fd2[i] * (xsT[H, i] - gl[i]) if i < obsdim else zero for i in range(ds)]
    lin, quad = zero, zero
    KsT = torch.empty((H, ds, B), dtype=xsT.dtype, device=xsT.device)
    ksT = torch.empty((H, B), dtype=xsT.dtype, device=xsT.device)
    for t in range(H - 1, -1, -1):
        row = jac_p[t]
        Jx = [[row[k * d + j] for j in range(ds)] for k in range(ds)]
        Ju = [row[k * d + ds] for k in range(ds)]
        cx = [qdv[i] * (xsT[t, i] - gl[i]) if i < obsdim else zero for i in range(ds)]
        cu = rd2 * usT[t]
        JuV = [seq([Ju[k] * V[k][j] for k in range(ds)]) for j in range(ds)]
        Quu = rd2 + seq([JuV[k] * Ju[k] for k in range(ds)])
        inv_quu = 1.0 / Quu
        Qux = [seq([JuV[k] * Jx[k][j] for k in range(ds)]) for j in range(ds)]
        qu = cu + seq([Ju[k] * v[k] for k in range(ds)])
        K = [-Qux[j] * inv_quu for j in range(ds)]
        kff = -qu * inv_quu
        lin = lin + qu * kff
        quad = quad + kff * Quu * kff
        JxV = [[seq([Jx[k][i] * V[k][j] for k in range(ds)]) for j in range(ds)]
               for i in range(ds)]
        qx = [cx[i] + seq([Jx[k][i] * v[k] for k in range(ds)]) for i in range(ds)]
        V = [[seq([JxV[i][k] * Jx[k][j] for k in range(ds)])
              + (qdv[i] if (i == j and i < obsdim) else 0.0)
              + Qux[i] * K[j] + K[i] * Qux[j] + K[i] * K[j] * Quu
              for j in range(ds)] for i in range(ds)]
        resid = qu + Quu * kff
        v = [qx[i] + Qux[i] * kff + K[i] * resid for i in range(ds)]
        KsT[t] = torch.stack(K)
        ksT[t] = kff
    act, oK, ok = carry
    return torch.where(act, KsT, oK), torch.where(act, ksT, ok), lin, quad


def backward_quad_ll(jac_p, xsT, usT, qd, rd, fd, goal, dt, obsdim, carry):
    """Riccati backward pass on the packed lanes-last Jacobian plane.

    jac_p (H, ds*(ds+1), B); xsT (H+1, ds, B); usT (H, B); qd/fd/goal
    (obsdim,) and rd (1,) — the fixed diagonal cost as host sequences;
    dt, obsdim Python scalars. ``carry = (act (B,) bool, old Ks
    (H, ds, B), old ks (H, B))``: lanes with ``act`` False return their
    old gains.
    Returns (KsT (H, ds, B), ksT (H, B), lin_red (B,), quad_red (B,))."""
    if _build.device_kind(xsT) == "cpu":
        return backward_quad_ll_plain(
            jac_p, xsT, usT, qd, rd, fd, goal, dt, obsdim, carry
        )
    H, ds, B = _shapes(jac_p, xsT, usT, qd, rd, fd, goal, obsdim, carry)
    built = _build.KERNEL_SHAPES["riccati_quad"]
    if (ds, 1) not in built:
        raise ValueError(
            f"backward kernel is built for (ds, dc) in {built}, got {(ds, 1)}"
        )
    dev, f32 = xsT.device, torch.float32
    _build.check_cuda("jac_p", jac_p, (H, ds * (ds + 1), B), f32, dev)
    _build.check_cuda("xsT", xsT, (H + 1, ds, B), f32, dev)
    _build.check_cuda("usT", usT, (H, B), f32, dev)
    act, oK, ok = carry
    _build.check_cuda("act", act, (B,), torch.bool, dev)
    _build.check_cuda("old Ks", oK, (H, ds, B), f32, dev)
    _build.check_cuda("old ks", ok, (H, B), f32, dev)
    P = _build.QuadDiag()
    P.obsdim, P.two_dt, P.rd = int(obsdim), 2.0 * float(dt), float(rd[0])
    for i in range(obsdim):
        P.qd[i], P.fd[i], P.goal[i] = float(qd[i]), float(fd[i]), float(goal[i])
    KsT = torch.empty((H, ds, B), dtype=f32, device=dev)
    ksT = torch.empty((H, B), dtype=f32, device=dev)
    lin = torch.empty((B,), dtype=f32, device=dev)
    quad = torch.empty((B,), dtype=f32, device=dev)
    rc = _build.library().ampc_backward_quad_ll(
        ctypes.byref(P), _build.ptr(jac_p), _build.ptr(xsT), _build.ptr(usT),
        _build.ptr(act), _build.ptr(oK), _build.ptr(ok), _build.ptr(KsT),
        _build.ptr(ksT), _build.ptr(lin), _build.ptr(quad), ds, H, B,
        dev.index or 0, _build.stream_of(xsT),
    )
    _build.check_rc("backward_quad_ll", rc)
    backward_quad_ll.launches += 1
    return KsT, ksT, lin, quad


backward_quad_ll.launches = 0
