"""K3, K7, K8 and K9: the iLQR line search for linear-in-features models
(port of ``autompc_tpu/ops/pallas_linesearch.py``).

``fused_line_search`` (K3, ``pallas_fused_line_search`` with
``ll_io=True``, ``carry=(act, old_jac)``, ``grad_terms`` and shared
coefficients; kernel in ``csrc/linesearch_fused.cu``): one call rolls
all L step sizes through the feature-library dynamics, sums the
quadratic objective, applies the reference acceptance rule, writes the
chosen rollout, relinearizes along it and applies the iLQR carry
select. The kernel runs each (lane, step size) in a thread of its own
and keeps every candidate's trajectory in a scratch buffer that the
wrapper allocates, (H, ds+1, L, B) floats, so the chosen one is read
back instead of rolled again (``fused_geometry`` sets the block).
Inputs and outputs are lanes-last and dc = 1; the cost is a diagonal
QuadCost, either one fixed cost as host sequences or per-lane lanes-last
planes (``per_lane_diag_cost=True`` of the TPU kernel). The Jacobian
carry is float32 or bfloat16 (``jac_dtype="bf16"`` of the solver): old
rows are read and new rows written in its own storage type.

``fused_line_search_wide`` (``pallas_fused_line_search_wide``, the
solver's ``ls_wide=True``): the same contract split in three. K8
(``wide_objectives``, ``csrc/ls_obj_wide.cu``) rolls and scores every
(lane, step size) in K3's geometry and returns the (L, B) objectives,
every candidate's trajectory in a scratch stash (H, ds+1, L, B) and
its du2 (L, B); the acceptance rule runs in tensor ops
(``wide_accept``), as the TPU package runs it in XLA; K9
(``wide_reroll``, ``csrc/ls_reroll_wide.cu``) reads the selected
candidate back from the stash, relinearizes along it and applies the
carry select, in parallel over (step, lane): where the TPU's second
kernel rolls the chosen step size again, the stash already holds that
roll to the bit. K8's candidate pass is K3's (``csrc/ls_step.cuh``).

``sindy_line_search`` (K7, ``pallas_sindy_line_search``; kernel in
``csrc/sindy_linesearch.cu``): the unfused form on the batch-major
carry, which rolls out every step size and returns all L trajectories;
the objective and the choice are the caller's. A group of threads
(``sindy_geometry``: 8, or 4 from B=2048) rolls each candidate, the
feature terms summed across the group by shuffles. K7 takes any (ds, dc)
with ds + dc <= ``_build.MAX_D``, each control its own bounds; K3, K8
and K9 any ds at dc = 1 (obsdim <= ``_build.MAX_OBS``). The kernel
library holds (4, 1); another shape is compiled at first use
(``_build.kernel_library``), its shared- and per-lane-coefficient
instances in one library.

K3 and K7 also take one model a lane (``coeffs.ndim == 3`` of the TPU
entries, the joint fan-out's per-lane models) as a lanes-last (ds, n, B)
coefficient plane: their per-lane instances read lane b's column in
place of the shared plane staged in shared memory, walk up to
``_build.MAX_F_LANE`` terms (the shared instances ``_build.MAX_F``) from a
device-resident table, and given B copies of one matrix return the
shared instances' bits; they take the shapes the shared instances take.
K3's per-lane instances take per-lane cost
planes and a float32 Jacobian carry (the joint fan-out's form); the
split search (K8, K9) refuses per-lane coefficients.

``fused_line_search_bm`` (K3's batch-major entry, ``pallas_fused_line_search``
with ``ll_io=False``, ``grad_terms`` and optionally ``reg=(S, mu, w)``; at
dc > 1 the multi-control instances of ``csrc/linesearch_fused_mc.cu``, each
control with its own bounds and feedback row, any obsdim <= ds):
the same kernel body with its ``BM`` switch, on the batch-major carry of
the solver's batch-major body, and without the carry select (the TPU
entry returns every lane's chosen rollout; the body selects). Its cost
is per-lane diagonal planes (``per_lane_diag_cost=True``) or, with its
``DENSE`` switch, one fixed dense cost (``per_lane_diag_cost=False`` with
a Q or F that is not diagonal: each quadratic form summed over all
obsdim^2 entries, as the TPU kernel sums it). Its ``REG`` switch adds
the GaussReg stage term ``w_b (x - mu)' S (x - mu)`` to every
candidate's objective, summed over the upper triangle of S with the
off-diagonal entries doubled, as the TPU kernel sums it. Shared (up to
``_build.MAX_F`` terms) or per-lane coefficients (up to
``_build.MAX_F_LANE``, the lanes-last per-lane entry's table and trees),
float32 Jacobians, or none (``jac=False``, the solver's relin="xla").

A CPU tensor takes the plain PyTorch version (``fused_line_search_plain``,
``fused_line_search_bm_plain``, ``sindy_line_search_plain``,
``wide_objectives_plain``,
``wide_reroll_plain``, ``fused_line_search_wide_plain``); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..sysid.basis import feature_dynamics, feature_jacobian_rows, tree_sum
from . import _build


def _check_coeffs(terms, coeffs, ds, B):
    """Raise unless ``coeffs`` is (ds, n) or per lane a lanes-last
    (ds, n, B) plane, n = len(terms)."""
    want = (ds, len(terms)) + ((B,) if coeffs.ndim == 3 else ())
    if tuple(coeffs.shape) != want:
        raise ValueError(
            f"coeffs: shape {tuple(coeffs.shape)}, expected {(ds, len(terms))}, or "
            f"per-lane coefficients as a lanes-last (ds, n, B) plane {(ds, len(terms), B)}"
        )


def _shapes(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, qd, rd, fd, goal, act,
            old_jac):
    Hp1, ds, B = xsT.shape
    H = Hp1 - 1
    want = {
        "x0T": (x0T, (ds, B)), "usT": (usT, (H, B)), "KsT": (KsT, (H, ds, B)),
        "ksT": (ksT, (H, B)),
        "act": (act, (B,)), "old_jac": (old_jac, (H, ds * (ds + 1), B)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    _check_coeffs(terms, coeffs, ds, B)
    if len(terms[0].exps) != ds + 1:
        raise ValueError(
            f"terms take {len(terms[0].exps)} inputs, expected ds + 1 = {ds + 1}"
        )
    obsdim = len(goal)
    if not 1 <= obsdim <= ds:
        raise ValueError(f"goal must have length obsdim <= ds = {ds}")
    lane = _build.lane_cost_planes(qd, rd, fd, obsdim, B)
    if not 1 <= len(alphas) <= _build.MAX_L:
        raise ValueError(f"1..{_build.MAX_L} step sizes supported, got {len(alphas)}")
    return H, ds, B, obsdim, lane


def _consts(like, alphas, qd, rd, fd, goal, dt, lane):
    def c(v):
        return torch.tensor(float(v), dtype=like.dtype, device=like.device)

    a_col = torch.tensor([float(a) for a in alphas], dtype=like.dtype,
                         device=like.device)[:, None]
    gl = [c(v) for v in goal]
    if lane:
        # Per-lane planes: row i is the (B,) vector of lane diagonals.
        return a_col, list(qd), rd[0], list(fd), gl, c(dt)
    return a_col, [c(v) for v in qd], c(rd[0]), [c(v) for v in fd], gl, c(dt)


def _controls(x, xbar, K, ubar, k, alpha, umin, umax):
    fb = tree_sum([K[i] * (x[i] - xbar[i]) for i in range(len(x))])
    return torch.clamp(alpha * k + ubar + fb, umin, umax)


def _quad_form(w, x, goal):
    return tree_sum([w[i] * (x[i] - goal[i]) * (x[i] - goal[i]) for i in range(len(w))])


def _host(a):
    """A host float64 array of a tensor or an array-like."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _reg_entries(S):
    """The GaussReg form's terms in the kernels' order: (i, j, c S_ij) for
    i <= j in row order, c = 1 on the diagonal and 2 off it."""
    S = _host(S)
    n = S.shape[0]
    return [(i, j, (1.0 if i == j else 2.0) * float(S[i, j]))
            for i in range(n) for j in range(i, n)]


def _reg_form(entries, x, mu):
    """(x - mu)' S (x - mu) over the entries of ``_reg_entries``, each
    term (c S_ij (x_i - mu_i)) (x_j - mu_j), in the balanced tree."""
    d = [x[i] - mu[i] for i in range(len(mu))]
    return tree_sum([c * d[i] * d[j] for i, j, c in entries])


def _dense_form(M, x, goal):
    """(x - g)' M (x - g) over every entry of the dense M (a list of rows
    of scalars), each term (M_ij (x_i - g_i)) (x_j - g_j), in the
    balanced tree (the TPU kernel's quad_form of a full matrix)."""
    d = [x[i] - goal[i] for i in range(len(M))]
    return tree_sum([M[i][j] * d[i] * d[j] for i in range(len(M)) for j in range(len(M))])


def _sweep(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, umin, umax, qd, rd, fd,
           goal, dt, lane, keep, reg=None, dense=False):
    """Every candidate step size rolled from x0T: the objectives (L, B)
    and, with ``keep``, the stash (H, ds+1, L, B) (row (t, i < ds, l)
    x_{t+1}, row (t, ds, l) u_t) and du2 (L, B), else two Nones. ``reg``
    ``(S, mu, w (B,))`` adds ``w (x - mu)' S (x - mu)`` to every stage's
    state cost. ``dense``: qd, rd, fd are one fixed dense cost's Q, R, F
    (host arrays)."""
    H, ds = usT.shape[0], xsT.shape[1]
    if dense:
        c = lambda v: xsT.new_tensor(float(v))
        Qm, Fm = ([[c(v) for v in row] for row in _host(M)] for M in (qd, fd))
        a_col = xsT.new_tensor([float(a) for a in alphas])[:, None]
        rdv, gl, dtv = c(_host(rd).reshape(-1)[0]), [c(v) for v in goal], c(dt)
        state_cost = lambda x: _dense_form(Qm, x, gl)
        term_cost = lambda x: _dense_form(Fm, x, gl)
    else:
        if lane is None:
            lane = _build.lane_cost_planes(qd, rd, fd, len(goal), xsT.shape[2])
        a_col, qdv, rdv, fdv, gl, dtv = _consts(xsT, alphas, qd, rd, fd, goal, dt, lane)
        state_cost = lambda x: _quad_form(qdv, x, gl)
        term_cost = lambda x: _quad_form(fdv, x, gl)
    if reg is not None:
        S, mu, w = reg
        entries = [(i, j, xsT.new_tensor(c)) for i, j, c in _reg_entries(S)]
        mu = [xsT.new_tensor(v) for v in _host(mu)]
        w = w.to(xsT.dtype)[None, :]
    L, B = len(alphas), xsT.shape[2]
    x = [x0T[i][None, :].expand(L, -1) for i in range(ds)]
    obj = xsT.new_zeros((L, B))
    stash = xsT.new_empty((H, ds + 1, L, B)) if keep else None
    du2 = xsT.new_zeros((L, B)) if keep else None
    for t in range(H):
        xbar = [xsT[t, i][None, :] for i in range(ds)]
        K = [KsT[t, i][None, :] for i in range(ds)]
        u = _controls(x, xbar, K, usT[t][None, :], ksT[t][None, :], a_col, umin, umax)
        oc = state_cost(x)
        if reg is not None:
            oc = oc + w * _reg_form(entries, x, mu)
        cc = rdv * u * u
        obj = obj + dtv * (oc + cc)
        x = feature_dynamics(terms, coeffs, x + [u], ds)
        if keep:
            du2 = du2 + (u - usT[t][None, :]) ** 2
            stash[t, :ds] = torch.stack(x)
            stash[t, ds] = u
    return obj + term_cost(x), stash, du2


def line_search_objectives(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas,
                           umin, umax, qd, rd, fd, goal, dt, lane=None):
    """Pass 1 of the plain twin: the objective of every candidate step
    size, (L, B). ``lane`` says whether the cost is per-lane planes
    (None: decided from the arguments)."""
    return _sweep(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, umin, umax, qd, rd,
                  fd, goal, dt, lane, keep=False)[0]


def wide_objectives_plain(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, umin, umax,
                          qd, rd, fd, goal, dt, lane=None):
    """Plain PyTorch version of K8: (objs (L, B), stash (H, ds+1, L, B),
    du2 (L, B)), as ``wide_objectives`` returns them."""
    return _sweep(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, umin, umax, qd, rd,
                  fd, goal, dt, lane, keep=True)


def fused_line_search_plain(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas,
                            umin, umax, qd, rd, fd, goal, dt, obj0, lin_red,
                            quad_red, ks_small, act, old_jac,
                            ls_cost_threshold=0.3):
    """Plain PyTorch twin of the kernel (same math, same summation
    order; the JAX kernel's acceptance rule line for line). New Jacobian
    rows are rounded to ``old_jac``'s storage type (a float64 -> bfloat16
    cast goes through float32, in PyTorch as in JAX)."""
    _, _, B, _, lane = _shapes(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, qd, rd, fd,
                               goal, act, old_jac)
    objs = line_search_objectives(terms, x0T, xsT, usT, KsT, ksT, coeffs,
                                  alphas, umin, umax, qd, rd, fd, goal, dt, lane)
    success, failed, a_sel, new_obj = _accept(objs, alphas, obj0, lin_red, quad_red,
                                              ks_small, ls_cost_threshold)
    traj_mask = act & ~failed
    jac_mask = traj_mask & success

    # ---- pass 2: re-roll the chosen step size ------------------------
    out_xs, out_us, out_jac, du2 = reroll_plain(
        terms, x0T, xsT, usT, KsT, ksT, coeffs, a_sel, umin, umax, traj_mask, jac_mask,
        old_jac)
    new_obj = torch.where(traj_mask, new_obj, obj0)
    return out_xs, out_us, new_obj, success, failed, out_jac, du2


def _accept(objs, alphas, obj0, lin_red, quad_red, ks_small, ls_cost_threshold):
    """The JAX kernel's acceptance rule line for line on the objectives
    (L, B): (success, failed, the chosen step size (B,), the chosen
    objective (B,))."""
    L, B = objs.shape
    a_col = torch.tensor([float(a) for a in alphas], dtype=objs.dtype, device=objs.device)
    accept = []
    for l in range(L):
        expect = a_col[l] * lin_red + (a_col[l] ** 2) * quad_red * 0.5
        denom = -expect
        ratio = torch.where(
            denom.abs() > 1e-30, (obj0 - objs[l]) / denom,
            torch.full_like(denom, -float("inf")),
        )
        accept.append(ratio > ls_cost_threshold)
    any_acc = torch.stack(accept).any(0)
    first_acc = torch.full((B,), L, dtype=torch.long, device=objs.device)
    for l in range(L - 1, -1, -1):
        first_acc = torch.where(accept[l], l, first_acc)
    best_idx = torch.zeros((B,), dtype=torch.long, device=objs.device)
    best_val = objs[0]
    for l in range(1, L):
        better = objs[l] < best_val
        best_idx = torch.where(better, l, best_idx)
        best_val = torch.where(better, objs[l], best_val)
    chosen = torch.where(ks_small, 0, torch.where(any_acc, first_acc, best_idx))
    idx_last = torch.where(ks_small, 0, torch.where(any_acc, first_acc, L - 1))
    chosen_obj = objs.gather(0, chosen[None])[0]
    last_obj = objs.gather(0, idx_last[None])[0]
    success = (chosen_obj < obj0) | ks_small
    failed = ~success & (last_obj > obj0 + 1e-3)
    sel = torch.where(success, chosen, idx_last)
    return success, failed, a_col[sel], torch.where(success, chosen_obj, last_obj)


def reroll_plain(terms, x0T, xsT, usT, KsT, ksT, coeffs, alpha_sel, umin, umax,
                 traj_mask, jac_mask, old_jac, jac=True):
    """Pass 2 of the fused plain version: every lane rolled again at its
    step size ``alpha_sel`` (B,), relinearized along the roll, and the
    carry select applied (``traj_mask``, ``jac_mask`` (B,) bool). Returns
    (xs (H+1, ds, B), us (H, B), jac (H, ds*(ds+1), B) in ``old_jac``'s
    type, or None with ``jac=False``, du2 (B,))."""
    H, ds = usT.shape[0], xsT.shape[1]
    out_xs, out_us = torch.empty_like(xsT), torch.empty_like(usT)
    out_jac = torch.empty_like(old_jac)
    x = [x0T[i] for i in range(ds)]
    out_xs[0] = torch.where(traj_mask, x0T, xsT[0])
    du2 = xsT.new_zeros((xsT.shape[2],))
    for t in range(H):
        xbar = [xsT[t, i] for i in range(ds)]
        K = [KsT[t, i] for i in range(ds)]
        u = _controls(x, xbar, K, usT[t], ksT[t], alpha_sel, umin, umax)
        z = x + [u]
        xn = feature_dynamics(terms, coeffs, z, ds)
        out_xs[t + 1] = torch.where(traj_mask, torch.stack(xn), xsT[t + 1])
        du2 = du2 + (u - usT[t]) ** 2
        out_us[t] = torch.where(traj_mask, u, usT[t])
        if jac:
            rows = torch.stack(feature_jacobian_rows(terms, coeffs, z, ds))
            out_jac[t] = torch.where(jac_mask, rows, old_jac[t].to(rows.dtype))
        x = xn
    return out_xs, out_us, out_jac if jac else None, du2


def fused_line_search(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas,
                      umin, umax, qd, rd, fd, goal, dt, obj0, lin_red,
                      quad_red, ks_small, act, old_jac,
                      ls_cost_threshold=0.3):
    """Fused line search + acceptance + relinearization + carry select.

    terms: tuple of active ``TermDesc``; x0T (ds, B); xsT (H+1, ds, B);
    usT (H, B); KsT (H, ds, B); ksT (H, B); coeffs (ds, len(terms)) or
    per lane (ds, len(terms), B); alphas, goal (obsdim,): host sequences; the cost either fixed —
    qd/fd (obsdim,), rd (1,) host sequences — or per lane — qd/fd
    (obsdim, B), rd (1, B) lanes-last tensors; umin/umax, dt: floats;
    obj0/lin_red/quad_red (B,); ks_small/act (B,) bool; old_jac (H, ds*(ds+1), B).

    Returns (xsT, usT, obj, success, failed, jac_p, du2) — the next
    carry values: active lanes that did not fail take the chosen
    trajectory, those that also succeeded take its Jacobians, stored in
    ``old_jac``'s type (float32 or bfloat16). The kernel's limit on the
    step sizes holds on every device."""
    on_cpu = _build.device_kind(xsT) == "cpu"
    geom = fused_geometry(xsT.shape[2], len(alphas),
                          _build.H100_SMS if on_cpu else _build.sm_count(xsT.device))
    if on_cpu:
        return fused_line_search_plain(
            terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, umin, umax, qd,
            rd, fd, goal, dt, obj0, lin_red, quad_red, ks_small, act, old_jac,
            ls_cost_threshold,
        )
    H, ds, B, obsdim, lane = _shapes(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas,
                                     qd, rd, fd, goal, act, old_jac)
    lane_coef = coeffs.ndim == 3
    _build.check_obsdim("linesearch_fused", obsdim)
    _build.check_table_size(len(terms), lane_coef)
    lib = _build.kernel_library("linesearch_fused", ds, 1)
    if lane_coef and not (lane and old_jac.dtype == torch.float32):
        raise ValueError(
            "fused_line_search with per-lane coefficients takes per-lane cost "
            "planes and a float32 Jacobian carry (the joint fan-out's form)"
        )
    dev, f32, b8 = xsT.device, torch.float32, torch.bool
    dsd = ds * (ds + 1)
    for name, t, shape, dt_ in (
        ("x0T", x0T, (ds, B), f32), ("xsT", xsT, (H + 1, ds, B), f32),
        ("usT", usT, (H, B), f32), ("KsT", KsT, (H, ds, B), f32),
        ("ksT", ksT, (H, B), f32), ("coeffs", coeffs, coeffs.shape, f32),
        ("obj0", obj0, (B,), f32), ("lin_red", lin_red, (B,), f32),
        ("quad_red", quad_red, (B,), f32), ("ks_small", ks_small, (B,), b8),
        ("act", act, (B,), b8), ("old_jac", old_jac, (H, dsd, B), old_jac.dtype),
    ):
        _build.check_cuda(name, t, shape, dt_, dev)
    bf16 = _build.jac_bf16("old_jac", old_jac)
    P = _ls_params(alphas, umin, umax, qd, rd, fd, goal, dt, ls_cost_threshold, lane)
    planes = _build.cost_plane_ptrs(lane, qd, rd, fd, f32, dev)
    stash = torch.empty((H, ds + 1, len(alphas), B), dtype=f32, device=dev)
    out_xs = torch.empty((H + 1, ds, B), dtype=f32, device=dev)
    out_us = torch.empty((H, B), dtype=f32, device=dev)
    out_obj = torch.empty((B,), dtype=f32, device=dev)
    succ = torch.empty((B,), dtype=b8, device=dev)
    fail = torch.empty((B,), dtype=b8, device=dev)
    out_jac = torch.empty((H, dsd, B), dtype=old_jac.dtype, device=dev)
    du2 = torch.empty((B,), dtype=f32, device=dev)
    p = _build.ptr
    args = (p(coeffs), p(x0T), p(xsT), p(usT), p(KsT), p(ksT), *planes, p(obj0),
            p(lin_red), p(quad_red), p(ks_small), p(act), p(old_jac), p(stash),
            p(out_xs), p(out_us), p(out_obj), p(succ), p(fail), p(out_jac), p(du2))
    tail = (ds, H, B, geom["lanes_per_block"], dev.index or 0, _build.stream_of(xsT))
    if lane_coef:
        table = _build.feat_table_dev(tuple(terms), dev)
        rc = lib.ampc_fused_line_search_lane(p(table), len(terms), ctypes.byref(P),
                                             *args, *tail)
    else:
        rc = lib.ampc_fused_line_search(ctypes.byref(_build.feat_table(tuple(terms))),
                                        ctypes.byref(P), *args, bf16, *tail)
    _build.check_rc("fused_line_search", rc)
    fused_line_search.launches += 1
    fused_line_search.launches_bf16 += bf16
    if lane_coef:
        fused_line_search.launches_lane += 1
        fused_line_search.launches_lane_by_B[B] = \
            fused_line_search.launches_lane_by_B.get(B, 0) + 1
    return out_xs, out_us, out_obj, succ, fail, out_jac, du2


fused_line_search.launches = 0
fused_line_search.launches_bf16 = 0
fused_line_search.launches_lane = 0
fused_line_search.launches_lane_by_B = {}

def _bm_planes(x0, xs, us, Ks, ks):
    """The batch-major carry as the lanes-last one: x0T (ds, B), xsT
    (H+1, ds, B), usT, ksT (H, B), KsT (H, ds, B)."""
    return (x0.T, xs.permute(1, 2, 0), us[:, :, 0].T, Ks[:, :, 0].permute(1, 2, 0),
            ks[:, :, 0].T)


def _bm_dense(qd, rd, fd, obsdim, B):
    """Which cost form K3's batch-major entry was given: False for
    per-lane planes qd/fd (obsdim, B), rd (1, B) (tensors), True for one
    fixed dense cost Q/F (obsdim, obsdim), R (1, 1) (host arrays); any
    other form raises."""
    if all(isinstance(v, torch.Tensor) and v.ndim == 2 for v in (qd, rd, fd)):
        if _build.lane_cost_planes(qd, rd, fd, obsdim, B):
            return False
    elif not any(isinstance(v, torch.Tensor) for v in (qd, rd, fd)):
        shapes = tuple(np.shape(v) for v in (qd, rd, fd))
        if shapes == ((obsdim, obsdim), (1, 1), (obsdim, obsdim)):
            return True
    raise ValueError("the batch-major entry takes per-lane cost planes qd/fd (obsdim, B), "
                     "rd (1, B) (tensors), or one fixed dense cost Q/F (obsdim, obsdim), "
                     "R (1, 1) (host arrays)")


def _mc_dense(qd, rd, fd, obsdim, dc, B):
    """``_bm_dense`` at dc > 1: False for per-lane planes qd/fd (obsdim, B),
    rd (dc, B) (tensors), True for one fixed dense cost Q/F (obsdim,
    obsdim), R (dc, dc) (host arrays); any other form raises."""
    if all(isinstance(v, torch.Tensor) and v.ndim == 2 for v in (qd, rd, fd)):
        if tuple(qd.shape) == tuple(fd.shape) == (obsdim, B) and tuple(rd.shape) == (dc, B):
            return False
    elif not any(isinstance(v, torch.Tensor) for v in (qd, rd, fd)):
        if tuple(np.shape(v) for v in (qd, rd, fd)) == ((obsdim, obsdim), (dc, dc),
                                                        (obsdim, obsdim)):
            return True
    raise ValueError(f"the batch-major entry at dc = {dc} takes per-lane cost planes qd/fd "
                     "(obsdim, B), rd (dc, B) (tensors), or one fixed dense cost Q/F "
                     "(obsdim, obsdim), R (dc, dc) (host arrays)")


def _shapes_bm(terms, x0, xs, us, Ks, ks, coeffs, alphas, qd, rd, fd, goal, reg):
    B, Hp1, ds = xs.shape
    H = Hp1 - 1
    dc = us.shape[-1] if us.ndim == 3 else 1
    want = {"x0": (x0, (B, ds)), "us": (us, (B, H, dc)), "Ks": (Ks, (B, H, dc, ds)),
            "ks": (ks, (B, H, dc))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    _check_coeffs(terms, coeffs, ds, B)
    if len(terms[0].exps) != ds + dc:
        raise ValueError(f"terms take {len(terms[0].exps)} inputs, expected ds + dc = "
                         f"{ds + dc}")
    obsdim = len(goal)
    if not 1 <= obsdim <= ds:
        raise ValueError(f"goal must have length obsdim <= ds = {ds}")
    if dc == 1:
        _build.check_obsdim("linesearch_fused", obsdim)
        dense = _bm_dense(qd, rd, fd, obsdim, B)
    else:
        dense = _mc_dense(qd, rd, fd, obsdim, dc, B)
    if coeffs.ndim == 3:
        _build.check_table_size(len(terms), True)
    if not 1 <= len(alphas) <= _build.MAX_L:
        raise ValueError(f"1..{_build.MAX_L} step sizes supported, got {len(alphas)}")
    if reg is not None and dense:
        raise ValueError("reg (the GaussReg term) takes per-lane cost planes, not a dense "
                         "fixed cost")
    if reg is not None:
        S, mu, w = reg
        if _host(S).shape != (obsdim, obsdim) or _host(mu).shape != (obsdim,) \
                or tuple(w.shape) != (B,):
            raise ValueError(f"reg: S (obsdim, obsdim), mu (obsdim,) and w (B,) with "
                             f"obsdim = {obsdim}, B = {B}")
    return B, H, ds, dc, dense


def fused_line_search_bm_plain(terms, x0, xs, us, Ks, ks, coeffs, alphas, umin, umax,
                               qd, rd, fd, goal, dt, obj0, lin_red, quad_red, ks_small,
                               reg=None, ls_cost_threshold=0.3, jac=True):
    """Plain PyTorch twin of K3's batch-major entry: the lanes-last twin's
    sweep (with the GaussReg term, or under the dense fixed cost),
    acceptance and re-roll on the transposed carry, every lane's chosen
    rollout returned. At dc > 1 (``us`` (B, H, dc)) the multi-control
    form (``_mc_plain``)."""
    B, H, ds, dc, dense = _shapes_bm(terms, x0, xs, us, Ks, ks, coeffs, alphas, qd, rd, fd,
                                     goal, reg)
    if dc > 1:
        return _mc_plain(terms, x0, xs, us, Ks, ks, coeffs, alphas, umin, umax, qd, rd, fd,
                         goal, dt, obj0, lin_red, quad_red, ks_small, reg, ls_cost_threshold,
                         jac, dense)
    x0T, xsT, usT, KsT, ksT = _bm_planes(x0, xs, us, Ks, ks)
    objs = _sweep(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, umin, umax, qd, rd,
                  fd, goal, dt, True, keep=False, reg=reg, dense=dense)[0]
    success, failed, a_sel, new_obj = _accept(objs, alphas, obj0, lin_red, quad_red,
                                              ks_small, ls_cost_threshold)
    every = torch.ones_like(success)
    out_xs, out_us, jac_p, du2 = reroll_plain(
        terms, x0T, xsT, usT, KsT, ksT, coeffs, a_sel, umin, umax, every, every,
        xsT.new_zeros((H, ds * (ds + 1), B)), jac=jac)
    Jx = Ju = None
    if jac:
        jac_p = jac_p.reshape(H, ds, ds + 1, B).permute(3, 0, 1, 2)
        Jx, Ju = jac_p[..., :ds].contiguous(), jac_p[..., ds:].contiguous()
    return (out_xs.permute(2, 0, 1).contiguous(), out_us.T[:, :, None].contiguous(),
            new_obj, success, failed, Jx, Ju, du2)


def _mc_bounds(v, dc):
    """Per-control bounds: a float (every control) or a sequence of dc."""
    a = np.broadcast_to(np.asarray(_host(v), dtype=np.float64).reshape(-1), (dc,))
    return [float(x) for x in a]


def _mc_forms(like, qd, rd, fd, goal, dense, reg):
    """The multi-control cost forms on (L, B) slabs, in the TPU kernel's
    order: (state form, control form, terminal form), each a function of
    the state (or control) list; the GaussReg term (``reg``) added to the
    state form as ``oc + w r``."""
    c = lambda v: like.new_tensor(float(v))
    gl = [c(v) for v in goal]
    o = len(goal)
    if dense:
        Qm, Rm, Fm = ([[c(v) for v in row] for row in _host(M)] for M in (qd, rd, fd))
        state = lambda x: _dense_form(Qm, x, gl)
        term = lambda x: _dense_form(Fm, x, gl)
        ctrl = lambda u: tree_sum([Rm[j][m] * u[j] * u[m] for j in range(len(u))
                                   for m in range(len(u))])
    else:
        state = lambda x: tree_sum([qd[i] * (x[i] - gl[i]) * (x[i] - gl[i]) for i in range(o)])
        term = lambda x: tree_sum([fd[i] * (x[i] - gl[i]) * (x[i] - gl[i]) for i in range(o)])
        ctrl = lambda u: tree_sum([rd[j] * u[j] * u[j] for j in range(len(u))])
    if reg is not None:
        S, mu, w = reg
        entries = [(i, j, like.new_tensor(v)) for i, j, v in _reg_entries(S)]
        mu = [like.new_tensor(v) for v in _host(mu)]
        w = w.to(like.dtype)[None, :]
        base = state
        state = lambda x: base(x) + w * _reg_form(entries, x, mu)
    return state, ctrl, term


def _mc_roll(terms, x0T, xsT, usT, KsT, ksT, coeffs, alpha, lo, hi, forms, dt, record, jac):
    """Roll every lane's candidates at ``alpha`` ((L, 1) for the L step
    sizes, or (1, B) for one chosen step size a lane) on the multi-control
    carry x0T (ds, B), xsT (H+1, ds, B), usT (H, dc, B), KsT (H, dc, ds, B),
    ksT (H, dc, B): u_j = clip(alpha k_j + ubar_j + tree_i K_ji (x_i -
    xbar_i), lo_j, hi_j), the objective (L or 1, B) and, with ``record``,
    the states (H+1 lists of ds slabs), controls, the Jacobian rows
    (``jac``) and du2 (the tree over j of (u_j - ubar_j)^2, folded over
    t)."""
    state, ctrl, term = forms
    H, dc = usT.shape[0], usT.shape[1]
    ds = xsT.shape[1]
    shape = torch.broadcast_shapes(tuple(alpha.shape), (1, x0T.shape[1]))
    x = [x0T[i][None, :].expand(shape) for i in range(ds)]
    obj = x0T.new_zeros(shape)
    xs_out, us_out, rows, du2 = [x], [], [], x0T.new_zeros(shape)
    for t in range(H):
        dx = [x[i] - xsT[t, i][None, :] for i in range(ds)]
        u = []
        for j in range(dc):
            fb = tree_sum([KsT[t, j, i][None, :] * dx[i] for i in range(ds)])
            uj = alpha * ksT[t, j][None, :] + usT[t, j][None, :] + fb
            u.append(torch.clamp(uj, lo[j], hi[j]))
        obj = obj + dt * (state(x) + ctrl(u))
        z = x + u
        x = feature_dynamics(terms, coeffs, z, ds)
        if record:
            du2 = du2 + tree_sum([(u[j] - usT[t, j][None, :]) ** 2 for j in range(dc)])
            xs_out.append(x)
            us_out.append(u)
            if jac:
                rows.append(feature_jacobian_rows(terms, coeffs, z, ds))
    return obj + term(x), xs_out, us_out, rows, du2


def _mc_plain(terms, x0, xs, us, Ks, ks, coeffs, alphas, umin, umax, qd, rd, fd, goal, dt,
              obj0, lin_red, quad_red, ks_small, reg, ls_cost_threshold, jac, dense):
    """The plain version of K3's batch-major entry at dc > 1 (the TPU
    kernel with ll_io=False and any dc): every step size rolled and
    scored, the reference acceptance rule, the chosen step size rolled
    again with its Jacobians."""
    B, H, ds = xs.shape[0], xs.shape[1] - 1, xs.shape[2]
    dc = us.shape[-1]
    x0T, xsT = x0.T, xs.permute(1, 2, 0)
    usT, KsT, ksT = us.permute(1, 2, 0), Ks.permute(1, 2, 3, 0), ks.permute(1, 2, 0)
    lo, hi = _mc_bounds(umin, dc), _mc_bounds(umax, dc)
    forms = _mc_forms(xs, qd, rd, fd, goal, dense, reg)
    dtv = xs.new_tensor(float(dt))
    a_col = xs.new_tensor([float(a) for a in alphas])[:, None]
    objs = _mc_roll(terms, x0T, xsT, usT, KsT, ksT, coeffs, a_col, lo, hi, forms, dtv,
                    False, False)[0]
    success, failed, a_sel, new_obj = _accept(objs, alphas, obj0, lin_red, quad_red,
                                              ks_small, ls_cost_threshold)
    _, xs_l, us_l, rows, du2 = _mc_roll(terms, x0T, xsT, usT, KsT, ksT, coeffs,
                                        a_sel[None, :], lo, hi, forms, dtv, True, jac)
    out_xs = torch.stack([torch.stack(x)[:, 0] for x in xs_l]).permute(2, 0, 1)
    out_us = torch.stack([torch.stack(u)[:, 0] for u in us_l]).permute(2, 0, 1)
    Jx = Ju = None
    if jac:
        J = torch.stack([torch.stack([r.expand(1, B)[0] for r in rw]) for rw in rows])
        J = J.reshape(H, ds, ds + dc, B).permute(3, 0, 1, 2)
        Jx, Ju = J[..., :ds].contiguous(), J[..., ds:].contiguous()
    return (out_xs.contiguous(), out_us.contiguous(), new_obj, success, failed, Jx, Ju,
            du2[0])


def _reg_params(S, mu):
    """The GaussReg constants of the kernel (ls_step.cuh: RegParams)."""
    R = _build.RegParams()
    m = _build.MAX_OBS
    for i, j, c in _reg_entries(S):
        R.cS[i * m + j] = c
    for i, v in enumerate(_host(mu)):
        R.mu[i] = float(v)
    return R


def fused_line_search_bm(terms, x0, xs, us, Ks, ks, coeffs, alphas, umin, umax,
                         qd, rd, fd, goal, dt, obj0, lin_red, quad_red, ks_small,
                         reg=None, ls_cost_threshold=0.3, jac=True):
    """K3's batch-major entry: every step size rolled, scored and the
    reference acceptance rule applied, the chosen rollout written and
    relinearized, for every lane (no carry select).

    terms: tuple of active ``TermDesc``; x0 (B, ds); xs (B, H+1, ds);
    us (B, H, dc); Ks (B, H, dc, ds); ks (B, H, dc); coeffs (ds, len(terms))
    or per lane a lanes-last (ds, len(terms), B) plane; alphas, goal
    (obsdim,): host sequences; the cost either per-lane lanes-last
    planes, qd/fd (obsdim, B), rd (dc, B) tensors, or one fixed dense
    cost, Q/F (obsdim, obsdim), R (dc, dc) host arrays; umin/umax: floats,
    or at dc > 1 a float or a sequence of dc (each control its own
    bounds); dt a float; obj0/lin_red/quad_red (B,); ks_small (B,) bool;
    ``reg`` (per-lane planes only): None or ``(S (obsdim, obsdim), mu
    (obsdim,), w (B,))``, the GaussReg term ``w (x - mu)' S (x - mu)`` (S
    and mu host arrays or tensors, w a tensor); ``jac=False``: no
    relinearization (Jx, Ju returned as None). At dc > 1 the card runs
    the multi-control instances (``csrc/linesearch_fused_mc.cu``, built at
    the (ds, dc) at first use, counted in ``launches_mc`` too).

    Returns (xs (B, H+1, ds), us (B, H, dc), obj (B,), success (B,),
    failed (B,), Jx (B, H, ds, ds), Ju (B, H, ds, dc), du2 (B,)). The
    kernel's limits hold on every device."""
    B, H, ds, dc, dense = _shapes_bm(terms, x0, xs, us, Ks, ks, coeffs, alphas, qd, rd, fd,
                                     goal, reg)
    lane_coef = coeffs.ndim == 3
    if _build.device_kind(xs) == "cpu":
        return fused_line_search_bm_plain(
            terms, x0, xs, us, Ks, ks, coeffs, alphas, umin, umax, qd, rd, fd, goal, dt,
            obj0, lin_red, quad_red, ks_small, reg, ls_cost_threshold, jac)
    if dc > 1:
        return _launch_mc(terms, x0, xs, us, Ks, ks, coeffs, alphas, umin, umax, qd, rd, fd,
                          goal, dt, obj0, lin_red, quad_red, ks_small, reg,
                          ls_cost_threshold, jac, dense)
    _build.check_table_size(len(terms), lane_coef)
    lib = _build.kernel_library("linesearch_fused", ds, 1)
    dev, f32, b8 = xs.device, torch.float32, torch.bool
    L = len(alphas)
    for name, t, shape, dt_ in (
        ("x0", x0, (B, ds), f32), ("xs", xs, (B, H + 1, ds), f32),
        ("us", us, (B, H, 1), f32), ("Ks", Ks, (B, H, 1, ds), f32),
        ("ks", ks, (B, H, 1), f32), ("coeffs", coeffs, coeffs.shape, f32),
        ("obj0", obj0, (B,), f32), ("lin_red", lin_red, (B,), f32),
        ("quad_red", quad_red, (B,), f32), ("ks_small", ks_small, (B,), b8),
    ):
        _build.check_cuda(name, t, shape, dt_, dev)
    if dense:
        P = _ls_params(alphas, umin, umax, (0.0,) * len(goal), (float(_host(rd)[0, 0]),),
                       (0.0,) * len(goal), goal, dt, ls_cost_threshold, False)
        QF = (_on(qd, dev), _on(fd, dev))
    else:
        P = _ls_params(alphas, umin, umax, qd, rd, fd, goal, dt, ls_cost_threshold, True)
        planes = _build.cost_plane_ptrs(True, qd, rd, fd, f32, dev)
    if reg is not None:
        _build.check_cuda("reg w", reg[2], (B,), f32, dev)
        R, regw = ctypes.byref(_reg_params(reg[0], reg[1])), _build.ptr(reg[2])
    else:
        R = regw = None
    stash = torch.empty((H, ds + 1, L, B), dtype=f32, device=dev)
    out_xs = torch.empty((B, H + 1, ds), dtype=f32, device=dev)
    out_us = torch.empty((B, H, 1), dtype=f32, device=dev)
    out_obj = torch.empty((B,), dtype=f32, device=dev)
    succ = torch.empty((B,), dtype=b8, device=dev)
    fail = torch.empty((B,), dtype=b8, device=dev)
    Jx = torch.empty((B, H, ds, ds), dtype=f32, device=dev) if jac else None
    Ju = torch.empty((B, H, ds, 1), dtype=f32, device=dev) if jac else None
    du2 = torch.empty((B,), dtype=f32, device=dev)
    geom = fused_geometry(B, L, _build.sm_count(dev))
    p = _build.ptr
    jp = (p(Jx), p(Ju)) if jac else (None, None)
    tail = (ds, H, B, geom["lanes_per_block"], dev.index or 0, _build.stream_of(xs))
    if dense:
        table = _build.feat_table_dev(tuple(terms), dev) if lane_coef else None
        rc = lib.ampc_fused_line_search_bm_dense(
            None if lane_coef else ctypes.byref(_build.feat_table(tuple(terms))),
            None if table is None else p(table), len(terms), ctypes.byref(P), p(QF[0]),
            p(QF[1]), p(coeffs), p(x0), p(xs), p(us), p(Ks), p(ks), p(obj0), p(lin_red),
            p(quad_red), p(ks_small), p(stash), p(out_xs), p(out_us), p(out_obj), p(succ),
            p(fail), *jp, p(du2), *tail)
    else:
        args = (R, p(coeffs), p(x0), p(xs), p(us), p(Ks), p(ks), *planes, p(obj0),
                p(lin_red), p(quad_red), p(ks_small), regw, p(stash), p(out_xs), p(out_us),
                p(out_obj), p(succ), p(fail), *jp, p(du2), *tail)
        if lane_coef:
            table = _build.feat_table_dev(tuple(terms), dev)
            rc = lib.ampc_fused_line_search_bm_lane(p(table), len(terms), ctypes.byref(P),
                                                    *args)
        else:
            rc = lib.ampc_fused_line_search_bm(
                ctypes.byref(_build.feat_table(tuple(terms))), ctypes.byref(P), *args)
    _build.check_rc("fused_line_search_bm", rc)
    w = fused_line_search_bm
    w.launches += 1
    w.launches_by_B[B] = w.launches_by_B.get(B, 0) + 1
    if reg is not None:
        w.launches_reg += 1
    if dense:
        w.launches_dense += 1
        w.launches_dense_lane += lane_coef
    if lane_coef:
        w.launches_lane += 1
        w.launches_lane_by_B[B] = w.launches_lane_by_B.get(B, 0) + 1
        if len(terms) > _build.MAX_F:
            w.launches_lane_big += 1
    if not jac:
        w.launches_no_jac += 1
    return out_xs, out_us, out_obj, succ, fail, Jx, Ju, du2


def fused_mc_smem(ds, dc, obsdim, lane_coef, dense, reg):
    """Bytes of dynamic shared memory of K3's multi-control block
    (linesearch_fused_mc.cu): the shared coefficient plane (none with
    per-lane coefficients), the dense Q, R, F or the GaussReg S and mu,
    the objectives, du2 and picks of up to 256 threads."""
    up4 = lambda n: -(-n // 4) * 4
    cost = (2 * up4(obsdim ** 2) + up4(dc * dc) if dense
            else up4(obsdim ** 2) + up4(obsdim) if reg else 0)
    return 4 * ((0 if lane_coef else up4(ds * _build.MAX_F)) + cost
                + 3 * _build.LS_MAX_THREADS)


@functools.lru_cache(maxsize=32)
def _host_on(raw, shape, device):
    return torch.frombuffer(bytearray(raw), dtype=torch.float32).reshape(shape).to(device)


def _on(a, device):
    """A host array (the dense cost's Q, R, F; the GaussReg S and mu) as a
    contiguous float32 tensor on ``device`` (the kernels stage it in
    shared memory), copied there once for each value: a host-to-device
    copy each call would wait for the card's queue."""
    a = np.ascontiguousarray(_host(a), np.float32)
    return _host_on(a.tobytes(), a.shape, device)


def _launch_mc(terms, x0, xs, us, Ks, ks, coeffs, alphas, umin, umax, qd, rd, fd, goal, dt,
               obj0, lin_red, quad_red, ks_small, reg, thresh, jac, dense):
    """K3's batch-major entry at dc > 1 on CUDA tensors
    (``ampc_fused_line_search_mc``, the (ds, dc) library built at first
    use). Counted as a launch of ``fused_line_search_bm``."""
    B, H, ds = xs.shape[0], xs.shape[1] - 1, xs.shape[2]
    dc, L, obsdim = us.shape[-1], len(alphas), len(goal)
    lane_coef = coeffs.ndim == 3
    _build.check_table_size(len(terms), lane_coef)
    lib = _build.kernel_library("linesearch_fused_mc", ds, dc)
    dev, f32, b8 = xs.device, torch.float32, torch.bool
    for name, t, shape, dt_ in (
        ("x0", x0, (B, ds), f32), ("xs", xs, (B, H + 1, ds), f32),
        ("us", us, (B, H, dc), f32), ("Ks", Ks, (B, H, dc, ds), f32),
        ("ks", ks, (B, H, dc), f32), ("coeffs", coeffs, coeffs.shape, f32),
        ("obj0", obj0, (B,), f32), ("lin_red", lin_red, (B,), f32),
        ("quad_red", quad_red, (B,), f32), ("ks_small", ks_small, (B,), b8),
    ):
        _build.check_cuda(name, t, shape, dt_, dev)
    P = _build.LSParamsMC()
    P.L, P.obsdim, P.dt, P.thresh = L, obsdim, float(dt), float(thresh)
    for l, a in enumerate(alphas):
        P.alphas[l] = float(a)
    for j, (lo, hi) in enumerate(zip(_mc_bounds(umin, dc), _mc_bounds(umax, dc))):
        P.umin[j], P.umax[j] = lo, hi
    for i, g in enumerate(goal):
        P.goal[i] = float(g)
    if dense:
        cost = [_on(M, dev) for M in (qd, rd, fd)]
    else:
        cost = [qd, rd, fd]
        for name, v, shape in (("qd", qd, (obsdim, B)), ("rd", rd, (dc, B)),
                               ("fd", fd, (obsdim, B))):
            _build.check_cuda(name, v, shape, f32, dev)
    p = _build.ptr
    regp = (None, None, None)
    if reg is not None:
        _build.check_cuda("reg w", reg[2], (B,), f32, dev)
        cS = np.zeros((obsdim, obsdim))
        for i, j, c in _reg_entries(reg[0]):
            cS[i, j] = c
        regp = (p(_on(cS, dev)), p(_on(reg[1], dev)), p(reg[2]))
    stash = torch.empty((H, ds + dc, L, B), dtype=f32, device=dev)
    out_xs = torch.empty((B, H + 1, ds), dtype=f32, device=dev)
    out_us = torch.empty((B, H, dc), dtype=f32, device=dev)
    out_obj = torch.empty((B,), dtype=f32, device=dev)
    succ = torch.empty((B,), dtype=b8, device=dev)
    fail = torch.empty((B,), dtype=b8, device=dev)
    Jx = torch.empty((B, H, ds, ds), dtype=f32, device=dev) if jac else None
    Ju = torch.empty((B, H, ds, dc), dtype=f32, device=dev) if jac else None
    du2 = torch.empty((B,), dtype=f32, device=dev)
    geom = fused_geometry(B, L, _build.sm_count(dev))
    smem = fused_mc_smem(ds, dc, obsdim, lane_coef, dense, reg is not None)
    table = _build.feat_table_dev(tuple(terms), dev) if lane_coef else None
    rc = lib.ampc_fused_line_search_mc(
        None if lane_coef else ctypes.byref(_build.feat_table(tuple(terms))),
        None if table is None else p(table), len(terms), ctypes.byref(P), int(dense),
        *(p(v) for v in cost), *regp, p(coeffs), p(x0), p(xs), p(us), p(Ks), p(ks),
        p(obj0), p(lin_red), p(quad_red), p(ks_small), p(stash), p(out_xs), p(out_us),
        p(out_obj), p(succ), p(fail), p(Jx) if jac else None, p(Ju) if jac else None,
        p(du2), ds, dc, H, B, geom["lanes_per_block"], smem, dev.index or 0,
        _build.stream_of(xs))
    _build.check_rc("fused_line_search_bm", rc)
    w = fused_line_search_bm
    w.launches += 1
    w.launches_by_B[B] = w.launches_by_B.get(B, 0) + 1
    w.launches_mc += 1
    w.launches_reg += reg is not None
    w.launches_dense += dense
    w.launches_dense_lane += dense and lane_coef
    w.launches_no_jac += not jac
    if lane_coef:
        w.launches_lane += 1
        w.launches_lane_by_B[B] = w.launches_lane_by_B.get(B, 0) + 1
        w.launches_lane_big += len(terms) > _build.MAX_F
    return out_xs, out_us, out_obj, succ, fail, Jx, Ju, du2


def reset_bm_counters():
    """Set every launch count of ``fused_line_search_bm`` to 0."""
    w = fused_line_search_bm
    w.launches = w.launches_reg = w.launches_dense = w.launches_lane = 0
    w.launches_dense_lane = w.launches_lane_big = w.launches_no_jac = w.launches_mc = 0
    w.launches_by_B, w.launches_lane_by_B = {}, {}


reset_bm_counters()


# Lanes a K3 block may hold, each with its L step sizes in L threads:
# the groups that the paths' L = 10 selects (16 at B >= 4096, 8 at the
# fan-out's 1,024).
_LANE_GROUPS = (16, 8)


def fused_geometry(B, L, n_sm=_build.H100_SMS):
    """K3's and K8's launch: ``lanes_per_block`` lanes of L threads each
    (thread ``l * lanes_per_block + j`` rolls step size l of the block's
    lane j), ``blocks`` of them. The lanes per block are the most that
    still keep the most SMs busy, at most 256 threads a block."""
    if not 1 <= L <= _build.MAX_L:
        raise ValueError(f"fused_line_search: 1..{_build.MAX_L} step sizes supported, "
                         f"got {L}")
    fits = [n for n in _LANE_GROUPS if n * L <= _build.LS_MAX_THREADS]

    def busy(n):
        return min(-(-B // n), n_sm)

    most = max(busy(n) for n in fits)
    nl = max(n for n in fits if busy(n) == most)
    return dict(lanes_per_block=nl, threads=nl * L, blocks=-(-B // nl))


# K7's threads a candidate: 8 below SINDY_G4_FROM lanes, 4 from there. At
# the fan-out's batches (B <= 1,024, H=10) the card is short of warps and
# eight threads sum the cartpole model's 7 active terms in one round; at
# B=4096, H=200 the chains fill it and a group of four, with fewer
# threads repeating the control and the shuffles, takes 0.59 ms against
# 0.83 for eight (tools/ab_torch_kernels.py on an H100, 700 W; PERF.md).
SINDY_G4_FROM = 2048
# The groups csrc/sindy_linesearch.cu is instantiated for.
SINDY_GROUPS = (4, 8)
# Threads a K7 block (16 or 32 candidates), at most
# csrc/sindy_linesearch.cu's AMPC_SLS_MAX_THREADS: small enough that the
# fan-out's smallest batch (B=128) still spreads over 80 blocks.
SINDY_THREADS = 128


def sindy_smem(ds):
    """Bytes of static shared memory of a K7 block with shared
    coefficients at ds (sindy_linesearch.cu: the table, the (ds, n)
    plane and the decoded term words)."""
    return ctypes.sizeof(_build.FeatTable) + 4 * (ds + 1) * _build.MAX_F


def sindy_geometry(B, L, ds=4):
    """K7's launch: ``group`` threads a candidate (lane b, step size l),
    ``threads`` a block, ``blocks`` of them: thread ``tid`` of block
    ``bx`` is thread ``g = tid % group`` of candidate ``c = (bx * threads
    + tid) // group``, ``b = c // L``, ``l = c % L``; ``smem`` bytes of
    static shared memory a block at ds. Every group computes the same
    bits, at every (ds, dc)."""
    if not 1 <= L <= _build.MAX_L:
        raise ValueError(f"sindy_line_search: 1..{_build.MAX_L} step sizes supported, "
                         f"got {L}")
    group = 8 if B < SINDY_G4_FROM else 4
    return dict(group=group, threads=SINDY_THREADS,
                blocks=-(-(B * L * group) // SINDY_THREADS), smem=sindy_smem(ds))


def _ls_params(alphas, umin, umax, qd, rd, fd, goal, dt, thresh, lane):
    """The line-search kernels' constant block; the cost diagonals only
    for a fixed cost (``lane`` False)."""
    P = _build.LSParams()
    P.L, P.obsdim = len(alphas), len(goal)
    for l, a in enumerate(alphas):
        P.alphas[l] = float(a)
    P.umin, P.umax = float(umin), float(umax)
    for i in range(len(goal)):
        P.goal[i] = float(goal[i])
    if not lane:
        P.rd = float(rd[0])
        for i in range(len(goal)):
            P.qd[i], P.fd[i] = float(qd[i]), float(fd[i])
    P.dt, P.thresh = float(dt), float(thresh)
    return P


def _check_wide(B, coeffs):
    if B % _build.WIDE_B != 0:
        raise ValueError(f"wide line search needs B % {_build.WIDE_B} == 0, got {B}")
    if coeffs.ndim == 3:
        raise ValueError(
            "per-lane coefficients (coeffs (ds, F, B), the solver's batch_params) "
            "are not ported to the wide line search in autompc_torch yet"
        )


def wide_objectives(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, umin, umax,
                    qd, rd, fd, goal, dt, lane=None):
    """K8: every candidate step size rolled and scored; arguments as
    ``fused_line_search``'s first fifteen, B % 1024 == 0; ``lane`` as
    in ``line_search_objectives``. Returns (objs (L, B), stash (H, ds+1,
    L, B), du2 (L, B)): stash row (t, i < ds, l) holds candidate l's
    x_{t+1}, row (t, ds, l) its u_t. The launch is K3's
    (``fused_geometry``). A CPU tensor takes ``wide_objectives_plain``."""
    Hp1, ds, B = xsT.shape
    _check_wide(B, coeffs)
    if lane is None:
        lane = _build.lane_cost_planes(qd, rd, fd, len(goal), B)
    if not 1 <= len(alphas) <= _build.MAX_L:
        raise ValueError(f"wide_objectives: 1..{_build.MAX_L} step sizes supported, "
                         f"got {len(alphas)}")
    if _build.device_kind(xsT) == "cpu":
        return wide_objectives_plain(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas,
                                     umin, umax, qd, rd, fd, goal, dt, lane)
    H, L = Hp1 - 1, len(alphas)
    geom = fused_geometry(B, L, _build.sm_count(xsT.device))
    _build.check_obsdim("ls_obj_wide", len(goal))
    lib = _build.kernel_library("ls_obj_wide", ds, 1)
    dev, f32 = xsT.device, torch.float32
    for name, t, shape in (
        ("x0T", x0T, (ds, B)), ("xsT", xsT, (H + 1, ds, B)), ("usT", usT, (H, B)),
        ("KsT", KsT, (H, ds, B)), ("ksT", ksT, (H, B)),
        ("coeffs", coeffs, (ds, len(terms))),
    ):
        _build.check_cuda(name, t, shape, f32, dev)
    P = _ls_params(alphas, umin, umax, qd, rd, fd, goal, dt, 0.0, lane)
    planes = _build.cost_plane_ptrs(lane, qd, rd, fd, f32, dev)
    stash = torch.empty((H, ds + 1, L, B), dtype=f32, device=dev)
    objs = torch.empty((L, B), dtype=f32, device=dev)
    du2s = torch.empty((L, B), dtype=f32, device=dev)
    p = _build.ptr
    rc = lib.ampc_ls_obj_wide(
        ctypes.byref(_build.feat_table(tuple(terms))), ctypes.byref(P), p(coeffs),
        p(x0T), p(xsT), p(usT), p(KsT), p(ksT), *planes, p(stash), p(objs), p(du2s),
        ds, H, B, geom["lanes_per_block"], dev.index or 0, _build.stream_of(xsT),
    )
    _build.check_rc("wide_objectives", rc)
    wide_objectives.launches += 1
    wide_objectives.launches_by_B[B] = wide_objectives.launches_by_B.get(B, 0) + 1
    return objs, stash, du2s


wide_objectives.launches = 0
wide_objectives.launches_by_B = {}


def wide_accept(objs, alphas, obj0, lin_red, quad_red, ks_small, act,
                ls_cost_threshold=0.3):
    """The reference acceptance rule on the (L, B) objectives, in tensor
    ops, line for line as ``pallas_linesearch.py:1155-1184``. Returns
    (sel, traj_mask, jac_mask, new_obj, ls_success, failed), all (B,):
    ``sel`` the index of the selected step size (int64)."""
    L = objs.shape[0]
    a = objs.new_tensor([float(v) for v in alphas])
    expect = a[:, None] * lin_red[None] + (a[:, None] ** 2) * (quad_red[None] * 0.5)
    denom = -expect
    ratio = torch.where(denom.abs() > 1e-30, (obj0[None] - objs) / denom,
                        torch.full_like(denom, -float("inf")))
    accept = ratio > ls_cost_threshold
    any_acc = accept.any(0)
    first_acc = accept.to(torch.uint8).argmax(0)       # the first accepted
    best_idx = objs.argmin(0)
    zero = torch.zeros_like(first_acc)
    chosen = torch.where(ks_small, zero, torch.where(any_acc, first_acc, best_idx))

    def take(idx):
        return objs.gather(0, idx[None])[0]

    chosen_obj = take(chosen)
    ls_success = (chosen_obj < obj0) | ks_small
    idx_last = torch.where(ks_small, zero,
                           torch.where(any_acc, first_acc, torch.full_like(zero, L - 1)))
    last_obj = take(idx_last)
    failed = ~ls_success & (last_obj > obj0 + 1e-3)
    sel = torch.where(ls_success, chosen, idx_last)
    new_obj_raw = torch.where(ls_success, chosen_obj, last_obj)
    traj_mask = act & ~failed
    jac_mask = traj_mask & ls_success
    new_obj = torch.where(traj_mask, new_obj_raw, obj0)
    return sel, traj_mask, jac_mask, new_obj, ls_success, failed


def wide_reroll_plain(terms, x0T, xsT, usT, coeffs, stash, du2s, sel, traj_mask,
                      jac_mask, old_jac):
    """Plain PyTorch version of K9: the selected candidate's rows read
    back from the stash, its Jacobians, the carry select."""
    H, ds, B = usT.shape[0], xsT.shape[1], xsT.shape[2]
    rows = stash.gather(2, sel.view(1, 1, 1, B).expand(H, ds + 1, 1, B))[:, :, 0]
    xs = torch.cat([x0T[None], rows[:, :ds]])
    us = rows[:, ds]
    jac = torch.stack(feature_jacobian_rows(
        terms, coeffs, [xs[:H, i] for i in range(ds)] + [us], ds), dim=1)
    return (torch.where(traj_mask, xs, xsT), torch.where(traj_mask, us, usT),
            torch.where(jac_mask, jac, old_jac.to(jac.dtype)).to(old_jac.dtype),
            du2s.gather(0, sel[None])[0])


def wide_reroll(terms, x0T, xsT, usT, coeffs, stash, du2s, sel, traj_mask, jac_mask,
                old_jac):
    """K9: every lane's selected candidate ``sel`` (B,) int64 read back
    from K8's ``stash`` (H, ds+1, L, B), relinearized, and the carry
    select applied (``traj_mask``, ``jac_mask`` (B,) bool); du2 from
    K8's ``du2s`` (L, B). Returns (xs (H+1, ds, B), us (H, B), jac
    (H, ds*(ds+1), B) in ``old_jac``'s type, du2 (B,))."""
    if _build.device_kind(xsT) == "cpu":
        return wide_reroll_plain(terms, x0T, xsT, usT, coeffs, stash, du2s, sel,
                                 traj_mask, jac_mask, old_jac)
    Hp1, ds, B = xsT.shape
    H, dsd, L = Hp1 - 1, ds * (ds + 1), stash.shape[2]
    lib = _build.kernel_library("ls_reroll_wide", ds, 1)
    if len(terms[0].exps) != ds + 1:
        raise ValueError(f"terms take {len(terms[0].exps)} inputs, expected ds + 1")
    if not 1 <= L <= _build.MAX_L:
        raise ValueError(f"1..{_build.MAX_L} step sizes supported, got {L}")
    dev, f32, b8 = xsT.device, torch.float32, torch.bool
    for name, t, shape, dt_ in (
        ("x0T", x0T, (ds, B), f32), ("xsT", xsT, (H + 1, ds, B), f32),
        ("usT", usT, (H, B), f32), ("coeffs", coeffs, (ds, len(terms)), f32),
        ("stash", stash, (H, ds + 1, L, B), f32), ("du2s", du2s, (L, B), f32),
        ("sel", sel, (B,), torch.int64), ("traj_mask", traj_mask, (B,), b8),
        ("jac_mask", jac_mask, (B,), b8), ("old_jac", old_jac, (H, dsd, B), old_jac.dtype),
    ):
        _build.check_cuda(name, t, shape, dt_, dev)
    bf16 = _build.jac_bf16("old_jac", old_jac)
    out_xs = torch.empty((H + 1, ds, B), dtype=f32, device=dev)
    out_us = torch.empty((H, B), dtype=f32, device=dev)
    out_jac = torch.empty((H, dsd, B), dtype=old_jac.dtype, device=dev)
    du2 = torch.empty((B,), dtype=f32, device=dev)
    p = _build.ptr
    rc = lib.ampc_ls_reroll_wide(
        ctypes.byref(_build.feat_table(tuple(terms))), p(coeffs), p(x0T), p(xsT),
        p(usT), p(old_jac), p(stash), p(du2s), p(sel), p(traj_mask), p(jac_mask),
        p(out_xs), p(out_us), p(out_jac), p(du2),
        bf16, ds, L, H, B, dev.index or 0, _build.stream_of(xsT),
    )
    _build.check_rc("wide_reroll", rc)
    wide_reroll.launches += 1
    wide_reroll.launches_bf16 += bf16
    wide_reroll.launches_by_B[B] = wide_reroll.launches_by_B.get(B, 0) + 1
    return out_xs, out_us, out_jac, du2


wide_reroll.launches = 0
wide_reroll.launches_bf16 = 0
wide_reroll.launches_by_B = {}


def _wide(objectives, reroll, terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, umin,
          umax, qd, rd, fd, goal, dt, obj0, lin_red, quad_red, ks_small, act, old_jac,
          ls_cost_threshold):
    lane = _shapes(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, qd, rd, fd, goal,
                   act, old_jac)[4]
    _check_wide(xsT.shape[2], coeffs)
    objs, stash, du2s = objectives(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, umin,
                                   umax, qd, rd, fd, goal, dt, lane)
    sel, tmask, jmask, new_obj, success, failed = wide_accept(
        objs, alphas, obj0, lin_red, quad_red, ks_small, act, ls_cost_threshold)
    xs, us, jac, du2 = reroll(terms, x0T, xsT, usT, coeffs, stash, du2s, sel, tmask,
                              jmask, old_jac)
    return xs, us, new_obj, success, failed, jac, du2


def fused_line_search_wide_plain(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas,
                                 umin, umax, qd, rd, fd, goal, dt, obj0, lin_red,
                                 quad_red, ks_small, act, old_jac,
                                 ls_cost_threshold=0.3):
    """Plain PyTorch version of the split line search: the plain K8
    (``wide_objectives_plain``), ``wide_accept``, the plain K9
    (``wide_reroll_plain``)."""
    return _wide(wide_objectives_plain, wide_reroll_plain, terms, x0T, xsT, usT, KsT,
                 ksT, coeffs, alphas, umin, umax, qd, rd, fd, goal, dt, obj0, lin_red,
                 quad_red, ks_small, act, old_jac, ls_cost_threshold)


def fused_line_search_wide(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas,
                           umin, umax, qd, rd, fd, goal, dt, obj0, lin_red,
                           quad_red, ks_small, act, old_jac,
                           ls_cost_threshold=0.3):
    """The split ("wide") line search: ``fused_line_search``'s contract
    and return tuple (xsT (H+1, ds, B), usT (H, B), obj, success, failed,
    jac_p (H, ds*(ds+1), B), du2), B % 1024 == 0, as K8 (every
    candidate rolled, scored and kept in a scratch stash of H (ds+1) L B
    floats, 655 MB at B=16384, H=200, from PyTorch's caching allocator),
    the acceptance rule in tensor ops and K9 (the chosen candidate read
    back, relinearized and carry-selected). Every term descriptor carries
    its partials, which is what the TPU entry's ``grad_terms`` gives it;
    per-lane coefficients raise."""
    return _wide(wide_objectives, wide_reroll, terms, x0T, xsT, usT, KsT, ksT, coeffs,
                 alphas, umin, umax, qd, rd, fd, goal, dt, obj0, lin_red, quad_red,
                 ks_small, act, old_jac, ls_cost_threshold)


def _shapes_sindy(terms, x0, xs, us, Ks, ks, coeffs, alphas):
    B, Hp1, ds = xs.shape
    H, dc = Hp1 - 1, us.shape[-1]
    want = {
        "x0": (x0, (B, ds)), "us": (us, (B, H, dc)), "Ks": (Ks, (B, H, dc, ds)),
        "ks": (ks, (B, H, dc)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    _check_coeffs(terms, coeffs, ds, B)
    if len(terms[0].exps) != ds + dc:
        raise ValueError(
            f"terms take {len(terms[0].exps)} inputs, expected ds + dc = {ds + dc}"
        )
    if not 1 <= len(alphas) <= _build.MAX_L:
        raise ValueError(f"1..{_build.MAX_L} step sizes supported, got {len(alphas)}")
    return B, H, ds, dc


def _bounds(v, dc):
    """A scalar or (dc,) bound as a list of dc floats."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    flat = [float(a) for a in (v.reshape(-1) if hasattr(v, "reshape") else [v])]
    return flat * dc if len(flat) == 1 else flat


def sindy_line_search_plain(terms, x0, xs, us, Ks, ks, coeffs, alphas, umin, umax):
    """Plain PyTorch version of the rollout kernel, any dc: the feedback
    sum is a left fold over the state components, the feature sum the
    balanced tree, and the clip propagates NaN."""
    B, H, ds, dc = _shapes_sindy(terms, x0, xs, us, Ks, ks, coeffs, alphas)
    L = len(alphas)
    a_row = torch.tensor([float(a) for a in alphas], dtype=xs.dtype,
                         device=xs.device)[None, :]
    lo, hi = _bounds(umin, dc), _bounds(umax, dc)
    if coeffs.ndim == 3:
        coeffs = coeffs[..., None]      # coeffs[i, k]: (B, 1) against (B, L)
    x = [x0[:, i][:, None].expand(B, L) for i in range(ds)]
    out_xs, out_us = [torch.stack(x, dim=-1)], []
    for t in range(H):
        dx = [x[i] - xs[:, t, i][:, None] for i in range(ds)]
        u = []
        for j in range(dc):
            fb = Ks[:, t, j, 0][:, None] * dx[0]
            for i in range(1, ds):
                fb = fb + Ks[:, t, j, i][:, None] * dx[i]
            uj = a_row * ks[:, t, j][:, None] + us[:, t, j][:, None] + fb
            u.append(torch.clamp(uj, lo[j], hi[j]))
        x = feature_dynamics(terms, coeffs, x + u, ds)
        out_xs.append(torch.stack(x, dim=-1))
        out_us.append(torch.stack(u, dim=-1))
    return torch.stack(out_xs, dim=2), torch.stack(out_us, dim=2)


def sindy_line_search(terms, x0, xs, us, Ks, ks, coeffs, alphas, umin, umax):
    """Rollouts of every line-search step size, written out.

    terms: tuple of active ``TermDesc``; x0 (B, ds); xs (B, H+1, ds);
    us (B, H, dc); Ks (B, H, dc, ds); ks (B, H, dc); coeffs
    (ds, len(terms)) shared by every lane, or per lane a lanes-last
    (ds, len(terms), B) plane; alphas: host sequence of L
    step sizes; umin/umax: scalars or (dc,).
    Returns (ls_xs (B, L, H+1, ds), ls_us (B, L, H, dc)) with
    ``u = clip(alpha k + ubar + K (x - xbar))``, ``x' = coeffs @
    features([x, u])``."""
    if _build.device_kind(xs) == "cpu":
        return sindy_line_search_plain(terms, x0, xs, us, Ks, ks, coeffs, alphas,
                                       umin, umax)
    B, H, ds, dc = _shapes_sindy(terms, x0, xs, us, Ks, ks, coeffs, alphas)
    lane = coeffs.ndim == 3
    _build.check_table_size(len(terms), lane)
    lib = _build.kernel_library("sindy_linesearch", ds, dc)
    dev, f32 = xs.device, torch.float32
    for name, t, shape in (
        ("x0", x0, (B, ds)), ("xs", xs, (B, H + 1, ds)), ("us", us, (B, H, dc)),
        ("Ks", Ks, (B, H, dc, ds)), ("ks", ks, (B, H, dc)),
        ("coeffs", coeffs, coeffs.shape),
    ):
        _build.check_cuda(name, t, shape, f32, dev)
    if (ds, dc) == (4, 1):
        for name, t in (("xs", xs), ("Ks", Ks)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the kernel reads 16-byte rows; its "
                                 "storage must start on a 16-byte boundary")
    L = len(alphas)
    geo = sindy_geometry(B, L, ds)
    P = _build.SindyLS()
    P.L = L
    for l, a in enumerate(alphas):
        P.alphas[l] = float(a)
    for j, (lo, hi) in enumerate(zip(_bounds(umin, dc), _bounds(umax, dc))):
        P.umin[j], P.umax[j] = lo, hi
    ls_xs = torch.empty((B, L, H + 1, ds), dtype=f32, device=dev)
    ls_us = torch.empty((B, L, H, dc), dtype=f32, device=dev)
    p = _build.ptr
    ptrs = (ctypes.byref(P), p(coeffs), p(x0), p(xs), p(us), p(Ks), p(ks), p(ls_xs),
            p(ls_us))
    tail = (H, B, geo["group"], geo["threads"], dev.index or 0, _build.stream_of(xs))
    if lane:
        table = _build.feat_table_dev(tuple(terms), dev)
        rc = lib.ampc_sindy_line_search_lane(p(table), len(terms), *ptrs, ds, dc, *tail)
    else:
        rc = lib.ampc_sindy_line_search(ctypes.byref(_build.feat_table(tuple(terms))),
                                        *ptrs, ds, dc, *tail)
    _build.check_rc("sindy_line_search", rc)
    sindy_line_search.launches += 1
    sindy_line_search.launches_by_B[B] = sindy_line_search.launches_by_B.get(B, 0) + 1
    if lane:
        sindy_line_search.launches_lane += 1
        sindy_line_search.launches_lane_by_B[B] = \
            sindy_line_search.launches_lane_by_B.get(B, 0) + 1
    return ls_xs, ls_us


sindy_line_search.launches = 0
sindy_line_search.launches_by_B = {}
sindy_line_search.launches_lane = 0
sindy_line_search.launches_lane_by_B = {}
