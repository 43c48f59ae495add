"""K2 and K6: the dc=1 Riccati backward pass for a diagonal quadratic
cost (port of ``autompc_tpu/ops/pallas_riccati.py``).

``backward_quad_ll`` (K2, ``pallas_tvlqr_backward_quad_ll``; kernel in
``csrc/riccati_quad.cu``) works on the lanes-last carry: the packed
Jacobian plane, the trajectory, an in-kernel carry select. Its cost is
either one fixed diagonal QuadCost as host sequences or per-lane
lanes-last planes (the tuner's cost fan-out).

``backward_quad`` (K6, ``pallas_tvlqr_backward_quad``; kernel in
``csrc/riccati_quad_bm.cu``) works on the batch-major carry with
per-lane cost diagonals and no carry select.

Both build the stage and terminal expansions inline from the trajectory
and share one recursion (``csrc/riccati_quad_step.cuh``; ``_recursion``
here). The wide-tile reshape-IO variant of the TPU module is not ported
yet (ROADMAP.md §B); the dense-expansion kernels are
``ops/cuda_riccati_general.py``.

A CPU tensor takes the plain PyTorch version (``backward_quad_ll_plain``,
``backward_quad_plain``); a CUDA tensor launches the kernel or raises.
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
    if not 1 <= obsdim <= ds or len(goal) != obsdim:
        raise ValueError(
            f"goal must have length obsdim ({obsdim} <= ds = {ds})"
        )
    lane = _build.lane_cost_planes(qd, rd, fd, obsdim, B)
    act, oK, ok = carry
    if tuple(act.shape) != (B,) or tuple(oK.shape) != (H, ds, B) \
            or tuple(ok.shape) != (H, B):
        raise ValueError("carry must be (act (B,), Ks (H, ds, B), ks (H, B))")
    return H, ds, B, lane


def _recursion(H, ds, obsdim, load_jac, x_at, u_at, qd, rd, fd, goal, dt, zero):
    """The JAX ``_bq_step`` recursion, term for term in the same order,
    on (B,) lane vectors. ``load_jac(t) -> (Jx[k][j], Ju[k])``,
    ``x_at(t, i)``, ``u_at(t)`` fetch a step's rows; qd/fd (obsdim) and
    rd are scalars or (B,) vectors. Returns the gains as lists over t
    (K (ds, B), k (B,)) and lin, quad."""

    def seq(vals):
        s = vals[0]
        for v in vals[1:]:
            s = s + v
        return s

    two_dt = 2.0 * dt
    qdv = [qd[i] * two_dt for i in range(obsdim)]
    rd2 = rd * two_dt
    fd2 = [fd[i] * 2.0 for i in range(obsdim)]
    V = [[(fd2[i] if (i == j and i < obsdim) else zero) + zero
          for j in range(ds)] for i in range(ds)]
    v = [fd2[i] * (x_at(H, i) - goal[i]) if i < obsdim else zero for i in range(ds)]
    lin, quad = zero, zero
    Ks, ks = [None] * H, [None] * H
    for t in range(H - 1, -1, -1):
        Jx, Ju = load_jac(t)
        cx = [qdv[i] * (x_at(t, i) - goal[i]) if i < obsdim else zero for i in range(ds)]
        cu = rd2 * u_at(t)
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
        Ks[t], ks[t] = torch.stack(K), kff
    return Ks, ks, lin, quad


def _scalars(vals, like):
    return [torch.tensor(float(v), dtype=like.dtype, device=like.device) for v in vals]


def backward_quad_ll_plain(jac_p, xsT, usT, qd, rd, fd, goal, dt, obsdim,
                           carry):
    """Plain PyTorch version of the lanes-last kernel; the cost in either
    form (see ``backward_quad_ll``)."""
    H, ds, B, lane = _shapes(jac_p, xsT, usT, qd, rd, fd, goal, obsdim, carry)
    d = ds + 1
    if not lane:
        qd, rd, fd = _scalars(qd, xsT), _scalars(rd, xsT), _scalars(fd, xsT)

    def load_jac(t):
        row = jac_p[t]
        return ([[row[k * d + j] for j in range(ds)] for k in range(ds)],
                [row[k * d + ds] for k in range(ds)])

    Ks, ks, lin, quad = _recursion(
        H, ds, obsdim, load_jac, lambda t, i: xsT[t, i], lambda t: usT[t],
        qd, rd[0], fd, _scalars(goal, xsT), dt, xsT.new_zeros((B,)),
    )
    act, oK, ok = carry
    return (torch.where(act, torch.stack(Ks), oK),
            torch.where(act, torch.stack(ks), ok), lin, quad)


def _quad_diag(obsdim, dt, goal, fixed=None):
    """The kernels' constant block: obsdim, 2 dt, the shared goal and,
    for a fixed cost, its diagonals ``fixed = (qd, rd, fd)``."""
    P = _build.QuadDiag()
    P.obsdim, P.two_dt = int(obsdim), 2.0 * float(dt)
    for i in range(obsdim):
        P.goal[i] = float(goal[i])
    if fixed is not None:
        qd, rd, fd = fixed
        P.rd = float(rd[0])
        for i in range(obsdim):
            P.qd[i], P.fd[i] = float(qd[i]), float(fd[i])
    return P


def backward_quad_ll(jac_p, xsT, usT, qd, rd, fd, goal, dt, obsdim, carry):
    """Riccati backward pass on the packed lanes-last Jacobian plane.

    jac_p (H, ds*(ds+1), B); xsT (H+1, ds, B); usT (H, B). The cost is
    either one fixed diagonal cost — qd/fd (obsdim,) and rd (1,) as host
    sequences — or one cost per lane — qd/fd (obsdim, B) and rd (1, B)
    as lanes-last tensors; goal (obsdim,) is a host sequence shared by
    every lane; dt, obsdim Python scalars. ``carry = (act (B,) bool, old Ks
    (H, ds, B), old ks (H, B))``: lanes with ``act`` False return their
    old gains.
    Returns (KsT (H, ds, B), ksT (H, B), lin_red (B,), quad_red (B,))."""
    if _build.device_kind(xsT) == "cpu":
        return backward_quad_ll_plain(
            jac_p, xsT, usT, qd, rd, fd, goal, dt, obsdim, carry
        )
    H, ds, B, lane = _shapes(jac_p, xsT, usT, qd, rd, fd, goal, obsdim, carry)
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
    P = _quad_diag(obsdim, dt, goal, None if lane else (qd, rd, fd))
    planes = _build.cost_plane_ptrs(lane, qd, rd, fd, f32, dev)
    KsT = torch.empty((H, ds, B), dtype=f32, device=dev)
    ksT = torch.empty((H, B), dtype=f32, device=dev)
    lin = torch.empty((B,), dtype=f32, device=dev)
    quad = torch.empty((B,), dtype=f32, device=dev)
    rc = _build.library().ampc_backward_quad_ll(
        ctypes.byref(P), _build.ptr(jac_p), _build.ptr(xsT), _build.ptr(usT),
        *planes, _build.ptr(act), _build.ptr(oK), _build.ptr(ok), _build.ptr(KsT),
        _build.ptr(ksT), _build.ptr(lin), _build.ptr(quad), ds, H, B,
        dev.index or 0, _build.stream_of(xsT),
    )
    _build.check_rc("backward_quad_ll", rc)
    backward_quad_ll.launches += 1
    return KsT, ksT, lin, quad


backward_quad_ll.launches = 0


def _shapes_bm(Jx, Ju, xs, us, Qdiag, Rdiag, Fdiag, goal, obsdim):
    if Jx.ndim != 4 or Jx.shape[2] != Jx.shape[3]:
        raise ValueError(f"Jx {tuple(Jx.shape)} must be (B, H, ds, ds)")
    B, H, ds, _ = Jx.shape
    if Ju.ndim != 4 or Ju.shape[-1] != 1 or us.shape[-1] != 1:
        raise ValueError(
            "backward_quad (the batch-major diagonal-cost backward pass) is "
            f"built for dc = 1, got Ju {tuple(Ju.shape)}, us {tuple(us.shape)}"
        )
    want = {"Ju": (Ju, (B, H, ds, 1)), "xs": (xs, (B, H + 1, ds)),
            "us": (us, (B, H, 1)), "Qdiag": (Qdiag, (B, obsdim)),
            "Rdiag": (Rdiag, (B, 1)), "Fdiag": (Fdiag, (B, obsdim))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not 1 <= obsdim <= ds or len(goal) != obsdim:
        raise ValueError(f"goal must have length obsdim ({obsdim} <= ds = {ds})")
    return B, H, ds


def backward_quad_plain(Jx, Ju, xs, us, Qdiag, Rdiag, Fdiag, goal, dt, obsdim):
    """Plain PyTorch version of the batch-major kernel: the same
    recursion as ``backward_quad_ll_plain`` on the batch-major rows."""
    B, H, ds = _shapes_bm(Jx, Ju, xs, us, Qdiag, Rdiag, Fdiag, goal, obsdim)

    def load_jac(t):
        return ([[Jx[:, t, k, j] for j in range(ds)] for k in range(ds)],
                [Ju[:, t, k, 0] for k in range(ds)])

    Ks, ks, lin, quad = _recursion(
        H, ds, obsdim, load_jac, lambda t, i: xs[:, t, i], lambda t: us[:, t, 0],
        [Qdiag[:, i] for i in range(obsdim)], Rdiag[:, 0],
        [Fdiag[:, i] for i in range(obsdim)], _scalars(goal, xs), dt,
        xs.new_zeros((B,)),
    )
    Ks = torch.stack(Ks, dim=0).permute(2, 0, 1)[:, :, None, :]     # (B, H, 1, ds)
    return Ks.contiguous(), torch.stack(ks, dim=1)[:, :, None], lin, quad


def backward_quad(Jx, Ju, xs, us, Qdiag, Rdiag, Fdiag, goal, dt, obsdim):
    """Riccati backward pass on the batch-major carry, per-lane diagonal
    cost, dc = 1.

    Jx (B, H, ds, ds); Ju (B, H, ds, 1); xs (B, H+1, ds); us (B, H, 1);
    Qdiag/Fdiag (B, obsdim); Rdiag (B, 1); goal (obsdim,) host sequence;
    dt, obsdim Python scalars. A caller with one fixed cost broadcasts
    its diagonals to (B, ...). No carry select: every lane gets its new
    gains.
    Returns (Ks (B, H, 1, ds), ks (B, H, 1), lin_red (B,), quad_red (B,))."""
    if _build.device_kind(xs) == "cpu":
        return backward_quad_plain(Jx, Ju, xs, us, Qdiag, Rdiag, Fdiag, goal, dt, obsdim)
    B, H, ds = _shapes_bm(Jx, Ju, xs, us, Qdiag, Rdiag, Fdiag, goal, obsdim)
    built = _build.KERNEL_SHAPES["riccati_quad_bm"]
    if (ds, 1) not in built:
        raise ValueError(
            f"batch-major backward kernel is built for (ds, dc) in {built}, "
            f"got {(ds, 1)}"
        )
    dev, f32 = xs.device, torch.float32
    for name, t, shape in (
        ("Jx", Jx, (B, H, ds, ds)), ("Ju", Ju, (B, H, ds, 1)),
        ("xs", xs, (B, H + 1, ds)), ("us", us, (B, H, 1)),
        ("Qdiag", Qdiag, (B, obsdim)), ("Rdiag", Rdiag, (B, 1)),
        ("Fdiag", Fdiag, (B, obsdim)),
    ):
        _build.check_cuda(name, t, shape, f32, dev)
    for name, t in (("Jx", Jx), ("Ju", Ju), ("xs", xs)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte rows; its "
                             "storage must start on a 16-byte boundary")
    Ks = torch.empty((B, H, 1, ds), dtype=f32, device=dev)
    ks = torch.empty((B, H, 1), dtype=f32, device=dev)
    lin = torch.empty((B,), dtype=f32, device=dev)
    quad = torch.empty((B,), dtype=f32, device=dev)
    p = _build.ptr
    rc = _build.library().ampc_backward_quad_bm(
        ctypes.byref(_quad_diag(obsdim, dt, goal)), p(Jx), p(Ju), p(xs), p(us),
        p(Qdiag), p(Rdiag), p(Fdiag), p(Ks), p(ks), p(lin), p(quad),
        ds, H, B, dev.index or 0, _build.stream_of(xs),
    )
    _build.check_rc("backward_quad", rc)
    backward_quad.launches += 1
    return Ks, ks, lin, quad


backward_quad.launches = 0
