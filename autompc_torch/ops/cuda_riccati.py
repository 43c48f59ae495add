"""K2 and K6: the dc=1 Riccati backward pass for a diagonal quadratic
cost (port of ``autompc_tpu/ops/pallas_riccati.py``).

``backward_quad_ll`` (K2, ``pallas_tvlqr_backward_quad_ll``; kernel in
``csrc/riccati_quad.cu``) works on the lanes-last carry: the packed
Jacobian plane (float32, or bfloat16 for the ``jac_dtype="bf16"`` carry,
upcast at the read), the trajectory, an in-kernel carry select. Its cost
is either one fixed diagonal QuadCost as host sequences or per-lane
lanes-last planes (the tuner's cost fan-out). ``wide`` and ``wide_io``
keep the TPU entry's names, defaults and dispatch: at B % 1024 == 0 the
TPU runs its wide-tile kernel, through in-VMEM layout casts
(``wide_io="cast"``) or through arrays pre-split to ``(..., B/128, 128)``
(``"reshape"``, the entry ``_backward_quad_ll_wide_4d``). One kernel
serves all three here: the cast form is K2 itself, and the reshape form
goes through ``backward_quad_ll_wide_4d``, which launches K2 on views of
the 4D arrays (a split of the last axis is a view of the lanes-last
layout, so nothing is copied) and counts its own launches.

``backward_quad`` (K6, ``pallas_tvlqr_backward_quad``; kernel in
``csrc/riccati_quad_bm.cu``) works on the batch-major carry with
per-lane cost diagonals and no carry select.

Both build the stage and terminal expansions inline from the trajectory
and share one recursion (``csrc/riccati_quad_step.cuh``; ``_recursion``
here). The TPU's wide-kernel tile knobs (``AMPC_BQ_WIDE_S``,
``AMPC_BQ_WIDE_T``) are layout choices and are not read; its
``AMPC_BQ_WIDE_STEP`` variants are not ported (ROADMAP.md §B). The
dense-expansion kernels are ``ops/cuda_riccati_general.py``.

K2's launch geometry (lanes a block) is chosen here, by ``bq_geometry``,
and K6's (lanes a block, ring depth), by ``bq_bm_geometry``.
A CPU tensor takes the plain PyTorch version (``backward_quad_ll_plain``,
``backward_quad_plain``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build


def _shapes(jac_p, xsT, usT, qd, rd, fd, goal, obsdim, carry, xterm=None):
    """Check the lanes-last arguments; ``xsT`` is (H+1, ds, B), or
    (H, ds, B) beside a separate terminal state ``xterm`` (ds, B).
    Returns (H, ds, B, lane)."""
    H, dsd, B = jac_p.shape
    ds = xsT.shape[1]
    if dsd != ds * (ds + 1):
        raise ValueError(f"jac_p rows {dsd} != ds*(ds+1) = {ds * (ds + 1)}")
    rows = H + 1 if xterm is None else H
    if tuple(xsT.shape) != (rows, ds, B) or tuple(usT.shape) != (H, B):
        raise ValueError(
            f"xsT {tuple(xsT.shape)} / usT {tuple(usT.shape)} must be "
            f"(H+1, ds, B) / (H, B) for jac_p {tuple(jac_p.shape)}"
        )
    if xterm is not None and tuple(xterm.shape) != (ds, B):
        raise ValueError(f"xterm {tuple(xterm.shape)} must be (ds, B) = {(ds, B)}")
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


def _reshape_io(wide, wide_io, B):
    """The TPU entry's option checks (``pallas_riccati.py:706-711``);
    True where it would take the reshape-IO wide kernel."""
    if wide not in ("auto", "on", "off"):
        raise ValueError(f"wide must be auto/on/off, got {wide!r}")
    if wide_io not in ("cast", "reshape"):
        raise ValueError(f"wide_io must be cast/reshape, got {wide_io!r}")
    if wide == "on" and B % _build.WIDE_B != 0:
        raise ValueError(f"wide='on' needs B % {_build.WIDE_B} == 0, got {B}")
    return wide != "off" and B % _build.WIDE_B == 0 and wide_io == "reshape"


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


def _plain_ll(jac_p, xsT, xterm, usT, qd, rd, fd, goal, dt, obsdim, carry, lane):
    H, _, B = jac_p.shape
    ds = xsT.shape[1]
    d = ds + 1
    if not lane:
        qd, rd, fd = _scalars(qd, xsT), _scalars(rd, xsT), _scalars(fd, xsT)

    def load_jac(t):
        row = jac_p[t].to(xsT.dtype)     # a bfloat16 carry is upcast at the read
        return ([[row[k * d + j] for j in range(ds)] for k in range(ds)],
                [row[k * d + ds] for k in range(ds)])

    Ks, ks, lin, quad = _recursion(
        H, ds, obsdim, load_jac, lambda t, i: xsT[t, i] if t < H else xterm[i],
        lambda t: usT[t], qd, rd[0], fd, _scalars(goal, xsT), dt, xsT.new_zeros((B,)),
    )
    act, oK, ok = carry
    return (torch.where(act, torch.stack(Ks), oK),
            torch.where(act, torch.stack(ks), ok), lin, quad)


def backward_quad_ll_plain(jac_p, xsT, usT, qd, rd, fd, goal, dt, obsdim,
                           carry):
    """Plain PyTorch version of the lanes-last kernel; the cost in either
    form, the Jacobian plane in either storage type (see
    ``backward_quad_ll``)."""
    H, ds, B, lane = _shapes(jac_p, xsT, usT, qd, rd, fd, goal, obsdim, carry)
    return _plain_ll(jac_p, xsT, xsT[H], usT, qd, rd, fd, goal, dt, obsdim, carry, lane)


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


@functools.lru_cache(maxsize=256)
def bq_geometry(B, ds=4, sm_count=None):
    """K2's launch geometry: one thread a lane, ``lanes_per_block``
    lanes a block, the smallest block (32, 64 or 128 lanes) that keeps
    the grid within about four blocks an SM of ``sm_count`` (an H100's
    132 when not given), so that the few warps a batch makes spread over
    as many SMs as they can; ``smem`` bytes of shared memory a block hold
    its ring of ``_build.BQ_RING`` time steps (riccati_quad.cu), a 4-byte
    word a Jacobian element for either storage type. Raises
    ``ValueError`` for a ds the kernel is not built for."""
    built = _build.KERNEL_SHAPES["riccati_quad"]
    if (ds, 1) not in built:
        raise ValueError(
            f"backward kernel is built for (ds, dc) in {built}, got {(ds, 1)}"
        )
    sms = sm_count or _build.H100_SMS
    lanes = 32
    while -(-B // lanes) > 4 * sms and lanes < _build.BQ_MAX_LANES:
        lanes *= 2
    per_lane = _build.BQ_RING * (ds * (ds + 1) + 2 * (ds + 1)) * 4
    return dict(lanes_per_block=lanes, blocks=-(-B // lanes), smem=lanes * per_lane)


def _launch_ll(name, jac_p, xsT, xterm, usT, qd, rd, fd, goal, dt, obsdim,
               carry, lane):
    """Check the CUDA tensors and launch K2; ``xsT`` holds rows 0..H-1
    (or 0..H) and ``xterm`` the terminal state."""
    H, dsd, B = jac_p.shape
    ds = xsT.shape[1]
    dev, f32 = xsT.device, torch.float32
    bf16 = _build.jac_bf16("jac_p", jac_p)
    g = bq_geometry(B, ds, _build.sm_count(dev))
    _build.check_cuda("jac_p", jac_p, (H, dsd, B), jac_p.dtype, dev)
    _build.check_cuda("xsT", xsT, tuple(xsT.shape), f32, dev)
    _build.check_cuda("xterm", xterm, (ds, B), f32, dev)
    _build.check_cuda("usT", usT, (H, B), f32, dev)
    act, oK, ok = carry
    _build.check_cuda("act", act, (B,), torch.bool, dev)
    _build.check_cuda("old Ks", oK, (H, ds, B), f32, dev)
    _build.check_cuda("old ks", ok, (H, B), f32, dev)
    P = _quad_diag(obsdim, dt, goal, None if lane else (qd, rd, fd))
    planes = _build.cost_plane_ptrs(lane, qd, rd, fd, f32, dev)
    if g["smem"] > _build.MAX_SMEM_BYTES:
        raise ValueError(f"{name}: a block of {g['lanes_per_block']} lanes needs "
                         f"{g['smem']} bytes of shared memory")
    KsT = torch.empty((H, ds, B), dtype=f32, device=dev)
    ksT = torch.empty((H, B), dtype=f32, device=dev)
    lin = torch.empty((B,), dtype=f32, device=dev)
    quad = torch.empty((B,), dtype=f32, device=dev)
    p = _build.ptr
    rc = _build.library().ampc_backward_quad_ll(
        ctypes.byref(P), p(jac_p), p(xsT), p(xterm), p(usT), *planes, p(act), p(oK),
        p(ok), p(KsT), p(ksT), p(lin), p(quad), bf16, ds, H, B, g["lanes_per_block"],
        dev.index or 0, _build.stream_of(xsT),
    )
    _build.check_rc(name, rc)
    return KsT, ksT, lin, quad


def backward_quad_ll(jac_p, xsT, usT, qd, rd, fd, goal, dt, obsdim, carry,
                     wide="auto", wide_io="cast"):
    """Riccati backward pass on the packed lanes-last Jacobian plane.

    jac_p (H, ds*(ds+1), B), float32 or bfloat16; xsT (H+1, ds, B); usT
    (H, B). The cost is either one fixed diagonal cost — qd/fd (obsdim,)
    and rd (1,) as host sequences — or one cost per lane — qd/fd
    (obsdim, B) and rd (1, B) as lanes-last tensors; goal (obsdim,) is a
    host sequence shared by every lane; dt, obsdim Python scalars.
    ``carry = (act (B,) bool, old Ks (H, ds, B), old ks (H, B))``: lanes
    with ``act`` False return their old gains. ``wide`` ("auto", "on",
    "off") and ``wide_io`` ("cast", "reshape") as in the TPU entry: with
    B % 1024 == 0 and ``wide`` not "off", "reshape" takes the route of
    ``backward_quad_ll_wide_4d`` (fixed costs as planes, as the TPU's
    wrapper hands them over; counted as its launch); the values are the
    same in every form.
    Returns (KsT (H, ds, B), ksT (H, B), lin_red (B,), quad_red (B,))."""
    H, ds, B, lane = _shapes(jac_p, xsT, usT, qd, rd, fd, goal, obsdim, carry)
    if _reshape_io(wide, wide_io, B):
        if not lane:
            # One fill per row: no host-to-device copy on the way.
            rows = xsT.new_empty((2 * obsdim + 1, B))
            for row, v in zip(rows, (*qd, *rd, *fd)):
                row.fill_(float(v))
            qd, rd, fd = rows[:obsdim], rows[obsdim:obsdim + 1], rows[obsdim + 1:]
        return _run_4d(jac_p, xsT[:H], xsT[H], usT, qd, rd, fd, goal, dt, obsdim, carry)
    if _build.device_kind(xsT) == "cpu":
        return _plain_ll(jac_p, xsT, xsT[H], usT, qd, rd, fd, goal, dt, obsdim,
                         carry, lane)
    out = _launch_ll("backward_quad_ll", jac_p, xsT, xsT[H], usT, qd, rd, fd, goal,
                     dt, obsdim, carry, lane)
    backward_quad_ll.launches += 1
    backward_quad_ll.launches_bf16 += int(jac_p.dtype == torch.bfloat16)
    return out


backward_quad_ll.launches = 0
backward_quad_ll.launches_bf16 = 0


def backward_quad_ll_wide_4d(jac4, xs4, xterm, us4, Qd4, Rd4, Fd4, goal2, dt,
                             obsdim, carry):
    """The reshape-IO entry (``_backward_quad_ll_wide_4d``): every batch
    array arrives pre-split as ``(..., nl, 128)``, B = 128 nl, B % 1024
    == 0. jac4 (H, ds*(ds+1), nl, 128) float32 or bfloat16; xs4 (H, ds,
    nl, 128) the first H states; xterm (ds, nl, 128) the terminal state;
    us4 (H, nl, 128); cost planes Qd4/Fd4 (obsdim, nl, 128), Rd4 (1, nl,
    128); goal2 (obsdim, 1) or (obsdim,); ``carry = (act4 (1, nl, 128),
    old Ks (H, ds, nl, 128), old ks (H, nl, 128))``, act4 bool or a 0/1
    float plane (> 0.5 is active, as the TPU's).
    Returns (Ks (H, ds, nl, 128), ks (H, nl, 128), lin (1, nl, 128),
    quad (1, nl, 128)). On the card K2 runs on views of these arrays
    (they must be contiguous), its terminal row read from ``xterm``."""
    if jac4.ndim != 4 or jac4.shape[-1] != 128 or jac4.shape[-2] % 8:
        raise ValueError(
            f"jac4 {tuple(jac4.shape)}: the wide backward takes (H, ds*(ds+1), "
            f"B/128, 128) arrays with B % {_build.WIDE_B} == 0"
        )
    H, dsd, nl, _ = jac4.shape
    B, ds = nl * 128, xs4.shape[1]
    goal = [float(v) for v in np.asarray(
        goal2.detach().cpu() if isinstance(goal2, torch.Tensor) else goal2).reshape(-1)]
    act4, oK4, ok4 = carry
    act = act4.view(B)
    if act.is_floating_point():
        act = act > 0.5
    flat = lambda t, *lead: t.view(*lead, B)
    jac, xs, xt, us = flat(jac4, H, dsd), flat(xs4, H, ds), flat(xterm, ds), flat(us4, H)
    qd, rd, fd = flat(Qd4, obsdim), flat(Rd4, 1), flat(Fd4, obsdim)
    carry3 = (act, flat(oK4, H, ds), flat(ok4, H))
    if not _shapes(jac, xs, us, qd, rd, fd, goal, obsdim, carry3, xterm=xt)[3]:
        raise ValueError("the wide backward takes its cost as planes (obsdim, nl, 128)")
    Ks, ks, lin, quad = _run_4d(jac, xs, xt, us, qd, rd, fd, goal, dt, obsdim, carry3)
    return (Ks.view(H, ds, nl, 128), ks.view(H, nl, 128), lin.view(1, nl, 128),
            quad.view(1, nl, 128))


def _run_4d(jac, xs, xterm, us, qd, rd, fd, goal, dt, obsdim, carry):
    """The reshape-IO route on lanes-last views of the split arrays, cost
    planes: K2 as the 4D entry's launch, or the plain version on the
    CPU."""
    args = (jac, xs, xterm, us, qd, rd, fd, goal, dt, obsdim, carry, True)
    if _build.device_kind(xs) == "cpu":
        return _plain_ll(*args)
    out = _launch_ll("backward_quad_ll_wide_4d", *args)
    backward_quad_ll_wide_4d.launches += 1
    backward_quad_ll_wide_4d.launches_bf16 += int(jac.dtype == torch.bfloat16)
    return out


backward_quad_ll_wide_4d.launches = 0
backward_quad_ll_wide_4d.launches_bf16 = 0


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


def _check_built_bm(ds):
    built = _build.KERNEL_SHAPES["riccati_quad_bm"]
    if (ds, 1) not in built:
        raise ValueError(
            f"batch-major backward kernel is built for (ds, dc) in {built}, "
            f"got {(ds, 1)}"
        )


def bq_bm_geometry(B, H, ds=4, sm_count=None):
    """K6's launch geometry: ``group`` = ds threads a lane, thread ``tid``
    of block ``bx`` being thread ``g = tid % group`` of lane ``bx *
    lanes_per_block + tid // group``, which owns row g of the value
    matrix; ``threads`` = lanes x group, the smallest of 32, 64 and 128
    that keeps the grid within about four blocks an SM of ``sm_count``
    (an H100's 132 when not given), so that the few warps of a small batch
    spread over as many SMs as they can; ``ring`` time steps of inputs in
    shared memory (the whole horizon where H <= ``_build.BQBM_RING``);
    ``smem`` bytes of shared memory a block (riccati_quad_bm.cu:
    bqbm_floats_per_lane). Raises ``ValueError`` for a ds the kernel is
    not built for."""
    _check_built_bm(ds)
    sms = sm_count or _build.H100_SMS
    group = ds
    threads = 32
    while -(-B * group // threads) > 4 * sms and threads < _build.BQBM_MAX_THREADS:
        threads *= 2
    lanes = threads // group
    ring = min(H, _build.BQBM_RING)
    per_lane = ring * 30 + 40
    return dict(group=group, lanes_per_block=lanes, threads=threads,
                blocks=-(-B // lanes), ring=ring, smem=lanes * per_lane * 4)


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
    _check_built_bm(ds)
    dev, f32 = xs.device, torch.float32
    g = bq_bm_geometry(B, H, ds, _build.sm_count(dev))
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
        ds, H, B, g["lanes_per_block"], dev.index or 0, _build.stream_of(xs),
    )
    _build.check_rc("backward_quad", rc)
    backward_quad.launches += 1
    backward_quad.launches_by_B[B] = backward_quad.launches_by_B.get(B, 0) + 1
    return Ks, ks, lin, quad


backward_quad.launches = 0
backward_quad.launches_by_B = {}
