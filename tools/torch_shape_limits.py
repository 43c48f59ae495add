"""The feature-path kernels at the edges of their stated limits, on the
card: each shape built at first use from the checkout's sources, each
kernel launched on it and held against its plain version on the same
inputs.

The limits (``autompc_torch/ops/_build.py``: ``KERNEL_SHAPES``,
``check_shape``) are ds + dc <= ``MAX_D`` = 24, K2 ds <= ``BQ_MAX_DS`` =
13 (its ring in shared memory), dc = 1 and obsdim <= ``MAX_OBS`` = 8 for
the diagonal-cost kernels. The shapes here are the largest and the smallest
ds each source takes:

- K1 (``relin``) at (23, 1), both entries, and at (1, 23), batch-major;
- K7 (``sindy_linesearch``) at (23, 1) and (1, 23);
- K2 (``riccati_quad``) at (13, 1), K6 (``riccati_quad_bm``) and K3
  (``linesearch_fused``, fixed cost) at (23, 1), obsdim 8, and all three
  at (1, 1);
- K4 (``riccati_general``) at (23, 1) and (1, 23), and at (18, 6) both
  the main library's hand-set instance and the rule's instance of a
  library built at first use, side by side on the same inputs;
- the per-lane-coefficient instances: K1's batch-major entry and K7 at
  (18, 6), K1's lanes-last entry and K3 at (23, 1) (a lanes-last
  (ds, F, B) plane, per-lane cost planes for K3);
- K8 (``ls_obj_wide``) and K9 (``ls_reroll_wide``) at (23, 1), B = 1024
  (the split search takes B % 1024 == 0), against their plain versions.

The model is the quadratic basis (``poly_basis=True, poly_degree=2``: 48
terms at d = 24) with coefficients near the identity map, the inputs
random (seed 0), B = 256, H = 8, L = 10. Tolerances are
``chip_smoke.py``'s: K1 ``TOL_K1``, K2 ``TOL_K2``, K6 ``TOL_K6``, K7
``TOL_K7`` (finite rollouts), K3 its flags equal on ``K3_FAN_AGREE_MIN``
of the active lanes and, on those, states and objectives within
``TOL_K3`` normwise, K4 ``TOL_K4`` normwise on expansions whose Quu is
positive definite by construction (``ab_torch_kernels.k4_inputs``), K8
its objectives and K9 its Jacobians as K3's and K1's. A shape past
each limit (K4 (20, 5), K8 and K9 (23, 2) and (24, 1)) raises before
any build. Prints the builds' time, the ``-Xptxas -v`` report
and each check; exits non-zero if a shape does not build, launch or
agree.

Run (on the card):
    python3 tools/torch_shape_limits.py
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, H, L, OBS = 256, 8, 10, 8


def main():
    import chip_smoke as cs
    from autompc_torch.ops import _build
    from autompc_torch.ops import cuda_linesearch as K3
    from autompc_torch.ops import cuda_relin as K1
    from autompc_torch.ops import cuda_riccati as K2
    from autompc_torch.sysid.basis import FeatureLibrary

    dev = cs.check_device()
    print(cs.card_line(), flush=True)
    k2_ds = _build.BQ_MAX_DS
    top = _build.MAX_D - 1
    shapes = (("relin", top, 1), ("relin", 1, top), ("sindy_linesearch", top, 1),
              ("sindy_linesearch", 1, top), ("riccati_quad", k2_ds, 1),
              ("riccati_quad", 1, 1), ("riccati_quad_bm", top, 1), ("riccati_quad_bm", 1, 1),
              ("linesearch_fused", top, 1), ("linesearch_fused", 1, 1),
              ("riccati_general", top, 1), ("riccati_general", 1, top),
              ("riccati_general", 18, 6), ("relin", 18, 6), ("sindy_linesearch", 18, 6),
              ("ls_obj_wide", top, 1), ("ls_reroll_wide", top, 1))
    t0 = time.perf_counter()
    _build.build_shapes(shapes, main=True)
    print(f"build of {len(shapes)} shapes (one nvcc each, with the main library): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for shape in shapes:
        for name, regs, spill in cs.ptxas_report(_build.shape_build_log(*shape)):
            print(f"    ptxas {shape}: {name}: {regs} registers, {spill} bytes spilled")

    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), **f32)
    failures = []

    def check(name, err, tol):
        ok = err <= tol
        print(f"{name}: rel err {err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)

    def model(ds, dc):
        terms = FeatureLibrary.from_config(ds + dc, poly_basis=True, poly_degree=2).terms
        c = rng.normal(0.0, 0.05 / np.sqrt(len(terms)), (ds, len(terms)))
        c[:, :ds] += np.eye(ds)
        return terms, T(c)

    for ds, dc in ((top, 1), (1, top)):
        terms, coeffs = model(ds, dc)
        xs, us = T(rng.uniform(-1, 1, (B, H + 1, ds))), T(rng.uniform(-1, 1, (B, H, dc)))
        jk = K1.relin_jacobians_bm(terms, xs, us, coeffs)
        jp = K1.relin_jacobians_bm_plain(terms, xs, us, coeffs)
        check(f"K1 batch-major ({ds}, {dc}), {len(terms)} terms",
              max(cs.rel_err(a, b) for a, b in zip(jk, jp)), cs.TOL_K1)
        if dc == 1:
            args = (terms, xs.permute(1, 2, 0).contiguous(), us[:, :, 0].T.contiguous(),
                    coeffs)
            check(f"K1 lanes-last ({ds}, {dc})",
                  cs.rel_err(K1.relin_jacobians(*args), K1.relin_jacobians_plain(*args)),
                  cs.TOL_K1)
        alphas = tuple(0.2 ** k for k in range(L))
        k7 = (terms, T(rng.uniform(-1, 1, (B, ds))), xs, us,
              T(rng.normal(0, 0.3 / np.sqrt(ds), (B, H, dc, ds))),
              T(rng.normal(0, 1, (B, H, dc))), coeffs, alphas, -np.ones(dc), np.ones(dc))
        kk, kp = K3.sindy_line_search(*k7), K3.sindy_line_search_plain(*k7)
        fin = torch.isfinite(kp[0]).all() and torch.isfinite(kk[0]).all()
        check(f"K7 ({ds}, {dc}), rollouts finite {bool(fin)}",
              max(cs.rel_err(a, b) for a, b in zip(kk, kp)) if fin else float("inf"),
              cs.TOL_K7)

    # The diagonal-cost kernels: a near-identity Jx, obsdim min(OBS, ds).
    def cost(ds):
        m = min(OBS, ds)
        return (tuple(rng.uniform(0.1, 2, m)), (0.1,), tuple(rng.uniform(0.1, 2, m)),
                tuple(rng.normal(0, 0.5, m)))

    for ds in (k2_ds, 1):
        jx = np.eye(ds)[:, :, None] + rng.normal(0, 0.1 / np.sqrt(ds), (H, ds, ds, B))
        ju = rng.normal(0, 0.5, (H, ds, 1, B))
        jac = T(np.concatenate([jx, ju], axis=2).reshape(H, ds * (ds + 1), B))
        act = torch.as_tensor(rng.uniform(size=B) > 0.2, device=dev)
        args = (jac, T(rng.normal(size=(H + 1, ds, B))), T(rng.normal(size=(H, B))),
                *cost(ds), 0.05, min(OBS, ds))
        carry = (act, T(rng.normal(size=(H, ds, B))), T(rng.normal(size=(H, B))))
        g = K2.bq_geometry(B, ds, _build.sm_count(dev))
        bk = K2.backward_quad_ll(*args, carry=carry)
        bp = K2.backward_quad_ll_plain(*args, carry=carry)
        check(f"K2 ({ds}, 1), {g['lanes_per_block']} lanes a block, {g['smem']} bytes",
              max(cs.rel_err(a, b) for a, b in zip(bk, bp)), cs.TOL_K2)
    for ds in (top, 1):
        m = min(OBS, ds)
        Jx = T(np.eye(ds) + rng.normal(0, 0.1 / np.sqrt(ds), (B, H, ds, ds)))
        args = (Jx, T(rng.normal(0, 0.5, (B, H, ds, 1))), T(rng.normal(size=(B, H + 1, ds))),
                T(rng.normal(size=(B, H, 1))), T(rng.uniform(0.1, 2, (B, m))),
                T(rng.uniform(0.01, 1, (B, 1))), T(rng.uniform(0.1, 2, (B, m))),
                tuple(rng.normal(0, 0.5, m)), 0.05, m)
        g = K2.bq_bm_geometry(B, H, ds, sm_count=_build.sm_count(dev))
        gk, gp = K2.backward_quad(*args), K2.backward_quad_plain(*args)
        check(f"K6 ({ds}, 1), {g['group']} threads a lane, {g['smem']} bytes",
              max(cs.rel_err(a, b) for a, b in zip(gk, gp)), cs.TOL_K6)

    # K3: random gains on a near-identity model.
    def k3_args(ds, terms, coeffs, cost_, Bw=B):
        """The line search's 21 arguments at ds for Bw lanes under
        ``cost_`` (fixed, or per-lane planes)."""
        obj0 = rng.uniform(2.0, 30.0, Bw)
        return (terms, T(rng.uniform(-1, 1, (ds, Bw))), T(rng.uniform(-1, 1, (H + 1, ds, Bw))),
                T(rng.uniform(-1, 1, (H, Bw))), T(rng.normal(0, 0.3 / np.sqrt(ds), (H, ds, Bw))),
                T(rng.normal(size=(H, Bw))), coeffs, tuple(0.2 ** k for k in range(L)), -2.0,
                2.0, *cost_, 0.05, T(obj0), T(-rng.uniform(0.1, 5.0, Bw) * obj0 / 10),
                T(-rng.uniform(0.1, 5.0, Bw)),
                torch.as_tensor(rng.uniform(size=Bw) < 0.15, device=dev),
                torch.as_tensor(rng.uniform(size=Bw) > 0.2, device=dev),
                T(rng.normal(size=(H, ds * (ds + 1), Bw))))

    def k3_compare(name, ls):
        lk, lp = K3.fused_line_search(*ls), K3.fused_line_search_plain(*ls)
        xsT, act = ls[2], ls[-2]
        same = (lk[3] == lp[3]) & (lk[4] == lp[4])
        agree = same[act].float().mean().item()
        held = torch.equal(lk[0][..., ~act], xsT[..., ~act])
        lanes = same & act
        print(f"{name}: flags agree on {agree:.4f} of {int(act.sum())} active lanes (min "
              f"{cs.K3_FAN_AGREE_MIN}); inactive lanes bit for bit {held}", flush=True)
        if agree < cs.K3_FAN_AGREE_MIN or not held:
            failures.append(f"{name} flags")
        check(f"{name} states and objectives on those lanes",
              max(cs.rel_err(lk[0][..., lanes], lp[0][..., lanes]),
                  cs.rel_err(lk[2][lanes], lp[2][lanes])), cs.TOL_K3)

    for ds in (top, 1):
        terms, coeffs = model(ds, 1)
        k3_compare(f"K3 ({ds}, 1), {len(terms)} terms", k3_args(ds, terms, coeffs, cost(ds)))

    # K4 at its largest shapes, and the rule's instance at (18, 6) beside
    # the main library's hand-set one.
    from autompc_torch.ops import cuda_riccati_general as K4
    from tools.ab_torch_kernels import k4_inputs

    def k4_check(name, run, args):
        got, ref = run(), K4.riccati_general_plain(*args)
        check(name, max(cs.rel_err(a, b) for a, b in zip(got, ref)), cs.TOL_K4)
        return got

    for ds, dc in ((top, 1), (1, top), (18, 6)):
        args = k4_inputs(ds, dc, B, H, dev)
        g = K4.general_geometry(ds, dc, B, _build.sm_count(dev), rule=True)
        rule = k4_check(f"K4 ({ds}, {dc}), the rule's instance ({g['threads_per_lane']} "
                        f"threads a lane, {g['lanes_per_block']} lanes a block, {g['smem']} "
                        f"bytes)", lambda: K4.launch(_build.shape_library(
                            "riccati_general", ds, dc), True, *args), args)
        if (ds, dc) == (18, 6):
            hand = k4_check("K4 (18, 6), the main library's hand-set instance",
                            lambda: K4.riccati_general(*args), args)
            print(f"K4 (18, 6): the rule's instance against the hand-set one, normwise "
                  f"{max(cs.rel_err(a, b) for a, b in zip(rule, hand)):.3e}", flush=True)

    # The per-lane instances at their largest stated shapes.
    for ds, dc in ((18, 6), (top, 1)):
        terms, coeffs = model(ds, dc)
        plane = (coeffs[:, :, None] + T(rng.normal(0, 1e-3 / len(terms),
                                                   (ds, len(terms), B)))).contiguous()
        xs, us = T(rng.uniform(-1, 1, (B, H + 1, ds))), T(rng.uniform(-1, 1, (B, H, dc)))
        if dc > 1:
            jk = K1.relin_jacobians_bm(terms, xs, us, plane)
            jp = K1.relin_jacobians_bm_plain(terms, xs, us, plane)
            check(f"K1 batch-major, per-lane ({ds}, {dc}), {len(terms)} terms",
                  max(cs.rel_err(a, b) for a, b in zip(jk, jp)), cs.TOL_K1)
            k7 = (terms, T(rng.uniform(-1, 1, (B, ds))), xs, us,
                  T(rng.normal(0, 0.3 / np.sqrt(ds), (B, H, dc, ds))),
                  T(rng.normal(0, 1, (B, H, dc))), plane, tuple(0.2 ** k for k in range(L)),
                  -np.ones(dc), np.ones(dc))
            kk, kp = K3.sindy_line_search(*k7), K3.sindy_line_search_plain(*k7)
            fin = torch.isfinite(kp[0]).all() and torch.isfinite(kk[0]).all()
            check(f"K7 per-lane ({ds}, {dc}), rollouts finite {bool(fin)}",
                  max(cs.rel_err(a, b) for a, b in zip(kk, kp)) if fin else float("inf"),
                  cs.TOL_K7)
            continue
        args = (terms, xs.permute(1, 2, 0).contiguous(), us[:, :, 0].T.contiguous(), plane)
        check(f"K1 lanes-last, per-lane ({ds}, {dc})",
              cs.rel_err(K1.relin_jacobians(*args), K1.relin_jacobians_plain(*args)), cs.TOL_K1)
        m = min(OBS, ds)
        lane_cost = (T(rng.uniform(0.1, 2, (m, B))), T(rng.uniform(0.01, 1, (1, B))),
                     T(rng.uniform(0.1, 2, (m, B))), tuple(rng.normal(0, 0.5, m)))
        ls = k3_args(ds, terms, plane, lane_cost)
        k3_compare(f"K3 per-lane ({ds}, 1), {len(terms)} terms", ls)

    # K8 and K9 at (23, 1): the split search's B % 1024 == 0.
    Bw = _build.WIDE_B
    terms, coeffs = model(top, 1)
    ls = k3_args(top, terms, coeffs, cost(top), Bw=Bw)
    ok, sk, dk = K3.wide_objectives(*ls[:15])
    op, spl, dp = K3.wide_objectives_plain(*ls[:15])
    fin = torch.isfinite(ok) & torch.isfinite(op)
    check(f"K8 ({top}, 1), objectives of the {int(fin.sum())} finite candidates",
          cs.rel_err(ok[fin], op[fin]), cs.TOL_K3)
    sel, tm, jm = K3.wide_accept(ok, ls[7], *ls[15:20])[:3]
    rr = (terms, ls[1], ls[2], ls[3], coeffs, sk, dk, sel, tm, jm, ls[20])
    rk, rp = K3.wide_reroll(*rr), K3.wide_reroll_plain(*rr)
    same = all(cs.bits_equal(rk[i], rp[i]) for i in (0, 1, 3))
    print(f"K9 ({top}, 1): read-back (xs, us, du2) bit for bit the plain version's: {same}",
          flush=True)
    if not same:
        failures.append(f"K9 ({top}, 1) read-back")
    check(f"K9 ({top}, 1) Jacobians", cs.rel_err(rk[2], rp[2]), cs.TOL_K1)

    for source, ds, dc in (("riccati_quad", k2_ds + 1, 1), ("relin", top, 2),
                           ("riccati_general", 20, 5), ("ls_obj_wide", top, 2),
                           ("ls_reroll_wide", top + 1, 1)):
        try:
            _build.kernel_library(source, ds, dc)
            failures.append(f"{source} {(ds, dc)} did not raise")
        except ValueError as e:
            print(f"past the limits, before any build: {e}", flush=True)
    if failures:
        raise SystemExit("FAILED: " + ", ".join(failures))
    print("all shapes at the limits build, launch and agree", flush=True)


if __name__ == "__main__":
    main()
