"""Time the port's redesigned kernels of one or more checkouts of this
repository on the card, at the shapes their paths give them, and check
that every checkout computes the same bits:

- K2, the lanes-last backward (``backward_quad_ll``): each of its four
  instances (fixed or per-lane cost, float32 or bfloat16 Jacobians) at
  B=4096 and B=16384 (H=200, the main path), B=256, H=20 (the gate) and
  B=1,024, H=10 (the cost fan-out); its 4D entry
  (``backward_quad_ll_wide_4d``) at B=4096 and B=16384;
- K4, the general backward (``riccati_general``): (ds, dc) = (18, 6) at
  B=1024, H=200 (the cheetah solve) and B=32, H=20 (its closed loop),
  (4, 1) at B=4096, H=200 (the dense-cost path), with a positive
  definite Quu at every step, so that no lane is NaN by construction;
- K5, the MLP line search (``mlp_line_search``, 10 step sizes): the
  cheetah MLP 24-64-64-18 at B=1024, H=200 and B=32, H=20, the
  dense-cost cartpole MLP 5-64-64-4 at B=4096, H=200; for a tree whose
  wrapper picks its block from the card's SM count (``mlp_geometry``),
  also the block it picks when the whole grid fits on the card at once
  (``one_wave``) and when it does not (``many_waves``);
- the kernels that evaluate the feature library (``csrc/features.cuh``),
  on the main path's carry (the cartpole SINDy model fitted on the CPU
  from the smoke's data, so that every checkout gets the same
  coefficients; the carry after the solver's ``make_carry0`` and one
  backward pass): K8, the split search's objective sweep
  (``wide_objectives``, fixed and per-lane cost), K9, its read-back or
  re-roll (``wide_reroll``, float32 and bfloat16 carry), and the whole
  split entry (``fused_line_search_wide``, both cost forms and carry
  types) at B=1024, 4096 and 16384, H=200 (the llw solve's compaction
  stages); K3 (``fused_line_search``) there and at the gate's B=256,
  H=20 and the fan-out's B=1,024, H=10; K1 (``relin_jacobians``) at the
  same shapes and at the batches of the fan-out's batch-major
  configuration (B=512, 256 and 128 at H=10, its compaction stages);
  there and at B=4096, H=200 also K1's batch-major entry
  (``relin_jacobians_bm``, also at B=16384; in a tree without it the
  lanes-last entry behind the solver's old layout adapter), K6
  (``backward_quad``, per-lane cost, also at B=16384, and at B=1,024
  with H=20 and 40, whose times against H=10 give a step's cost) and K7
  (``sindy_line_search``); the per-lane-coefficient instances of K1
  (both entries), K3 and K7 (``lane_*``: every lane its own model over
  the whole 55-term library, the fitted model plus a seeded per-lane
  perturbation, per-lane costs) at the joint fan-out's B=1,024, H=10 and
  its last compaction stage, B=128. Each tree is driven through its
  own wrappers (the signatures of K8 and K9 differ between trees); K8's
  digest covers its objectives only, K9's its outputs (xs, us, jac,
  du2), which every tree computes alike;
- K6 at (ds, dc) = (12, 1) (the cartpole's trig Koopman lift) at B=1,024,
  H=10 and B=4096, H=200, on a carry near the identity made from the seed;
- the instances off the cartpole's shape (``*_2x1_*``, ``*_18x6_*``):
  the pendulum's (2, 1), on its main path's carry (its SINDy, the trig +
  interaction library at d = 3, fitted on the CPU from 50 x 100
  trajectories, seed 42; Q = F = diag(10, .1), R = 0.001) at B=16384 and
  4096, H=200 (its solve), B=256, H=20 (its closed loop) and B=1,024,
  H=10 (its fan-out): K1 (both entries), K2, K3, K6 and K7, K8, K9 and
  K2's 4D entry at B=16384 and 4096, H=200 (its solve with ``ls_wide``
  or the reshape IO), the per-lane K1 (both entries), K3 and K7 at
  B=1,024, H=10 (``lane_*_2x1``, a plane over the whole 21-term
  library); K4 at (12, 1), (8, 1) and (2, 1) (``K4_12x1`` ...); and the
  halfcheetah's (18, 6), K1's batch-major entry and K7 at B=1024, H=200
  on a model near the identity over the 48-term quadratic library. A
  tree without an instance (built before it) records ``*_skipped`` for
  that shape, and its digest is compared among the trees that have it.

The inputs are made from a seed with numpy, so every checkout gets the
same work.

    python3 tools/ab_torch_kernels.py [--only K1,K3,...] ROOT [ROOT ...]

A tree whose K7 wrapper picks its threads a candidate by batch also
times K7 at each group (``_g4``, ``_g8``), and one whose K1 wrappers
pick a thread per (point, column) or per point times both entries in
both (``_split``, ``_whole``); every variant must give the same bits. A
tree with ``bq_bm_geometry`` records the geometry each K6 call took
(``_geometry``).

``--only`` keeps the shapes whose tag starts with one of the prefixes
(K1, K2, K3, K4, K5, K6, K7, K8, K9, split, lane), a kernel's name
taking its per-lane shapes (``lane_K1...``) too.

    python3 tools/ab_torch_kernels.py --only K1,K2,K3,K4,K7,K8,K9 _archive/_parent .

holds every instance of K4, K1, K3, K7, K8, K9 and K2 (its 4D entry
among them) of the two trees against each other, and times the shapes a
tree built before them lacks (K4 at (12, 1), (8, 1), (2, 1); the
per-lane K1, K3, K7, K8, K9 and K2's 4D entry at (2, 1)) in the tree
that has them.

    python3 tools/ab_torch_kernels.py --only K1,K2,K3,K4,K6,K7,K8,K9,split,lane \
        _archive/_parent . . _archive/_parent

is the check that a change to the kernels' sources leaves every
existing instance's bits as they were.

Each ROOT is a checkout whose ``autompc_torch`` is imported in a process
of its own (two trees cannot share one), in the order given, so that
``A B B A`` compares two trees within one run. Prints the card's name
and power limit, then one JSON line per ROOT: at each shape the
CUDA-event median of a call in ms, the kernels' device time a call
under torch.profiler (``_device_ms``) and a SHA-256 digest of the
outputs. The last line says, per kernel and for all of them, whether
every ROOT (and block) gave the same outputs bit for bit."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np

L = 10
SEED = 0
# K2: (tag, B, H, per-lane cost, bfloat16 Jacobians, 4D entry)
K2_SHAPES = tuple(
    (f"K2_B{B}_H{H}_{'lane' if lane else 'fixed'}_{'bf16' if bf16 else 'f32'}{'_4d' if d4 else ''}",
     B, H, lane, bf16, d4)
    for B, H in ((4096, 200), (16384, 200), (256, 20), (1024, 10))
    for lane in (False, True) for bf16 in (False, True) for d4 in (False, True)
    if not d4 or (lane and B % 1024 == 0)
)
# K4: (tag, ds, dc, B, H)
K4_SHAPES = (
    ("K4_18x6_B1024_H200", 18, 6, 1024, 200),
    ("K4_18x6_B32_H20", 18, 6, 32, 20),
    ("K4_4x1_B4096_H200", 4, 1, 4096, 200),
    # The rule's instances, built at first use: the joint-Koopman lifts
    # (12, 1) and (8, 1) at their fan-out's shapes, the pendulum's (2, 1).
    ("K4_12x1_B1024_H10", 12, 1, 1024, 10),
    ("K4_8x1_B128_H10", 8, 1, 128, 10),
    ("K4_2x1_B1024_H20", 2, 1, 1024, 20),
)
# K5: (tag, widths, ds, dc, B, H)
K5_SHAPES = (
    ("K5_cheetah_B1024_H200", (24, 64, 64, 18), 18, 6, 1024, 200),
    ("K5_cheetah_B32_H20", (24, 64, 64, 18), 18, 6, 32, 20),
    ("K5_dense_B4096_H200", (5, 64, 64, 4), 4, 1, 4096, 200),
)
# SM counts the K5 wrapper is told, so that it takes each of its two blocks.
BLOCKS = (("one_wave", 10 ** 6), ("many_waves", 1))
# The geometries a tree's wrappers pick between by batch, each also timed
# in a tree that has the picker, forced by its threshold constant: K7's
# threads a candidate (``SINDY_G4_FROM``: 4 or 8), K1's thread per
# (point, column) or per point (``SM_THREADS``), both entries. Every
# variant must give the same bits.
VARIANTS = {
    "K7": (("g4", "SINDY_G4_FROM", 0), ("g8", "SINDY_G4_FROM", 1 << 40)),
    "K1": (("whole", "SM_THREADS", 0), ("split", "SM_THREADS", 1 << 40)),
}
VARIANTS["K1bm"] = VARIANTS["K1"]
VARIANT_NAMES = sorted({v[0] for vs in VARIANTS.values() for v in vs})
# The feature-library kernels: (tag, kernel, B, H, cost form, Jacobian
# carry type), grouped by (B, H) so that one carry serves each group.
WIDE_BH = ((1024, 200), (4096, 200), (16384, 200))
# The batches of the cost fan-out's batch-major configuration (b) at
# H=10: B=1,024 and its compaction stages (FAN_SCHEDULE of chip_smoke.py).
FAN_BH = ((1024, 10), (512, 10), (256, 10), (128, 10))
LS_SHAPES = tuple(sorted(
    [(f"K8_B{B}_H{H}_{c}", "K8", B, H, c, "f32") for B, H in WIDE_BH for c in ("fixed", "lane")]
    + [(f"K9_B{B}_H{H}_{j}", "K9", B, H, "fixed", j) for B, H in WIDE_BH for j in ("f32", "bf16")]
    + [(f"split_B{B}_H{H}_{c}_{j}", "split", B, H, c, j) for B, H in WIDE_BH
       for c in ("fixed", "lane") for j in ("f32", "bf16")]
    + [(f"K3_B{B}_H{H}_{c}_{j}", "K3", B, H, c, j) for B, H, c, j in (
        (1024, 200, "fixed", "f32"), (4096, 200, "fixed", "f32"), (4096, 200, "fixed", "bf16"),
        (4096, 200, "lane", "f32"), (16384, 200, "fixed", "f32"), (256, 20, "fixed", "f32"),
        (256, 20, "fixed", "bf16"), (1024, 10, "lane", "f32"))]
    + [(f"K1_B{B}_H{H}", "K1", B, H, "fixed", "f32")
       for B, H in ((4096, 200), (16384, 200), (256, 20)) + FAN_BH]
    + [(f"K1_bm_B{B}_H{H}", "K1bm", B, H, "fixed", "f32")
       for B, H in ((4096, 200), (16384, 200)) + FAN_BH]
    + [(f"K6_B{B}_H{H}", "K6", B, H, "lane", "f32")
       for B, H in ((4096, 200), (16384, 200), (1024, 20), (1024, 40)) + FAN_BH]
    + [(f"K7_B{B}_H{H}", "K7", B, H, "fixed", "f32") for B, H in ((4096, 200),) + FAN_BH]
    + [(f"lane_{k}_B{B}_H{H}", k, B, H, "coef", "f32") for B, H in ((1024, 10), (128, 10))
       for k in ("K1", "K1bm", "K3", "K7")],
    key=lambda r: (r[2], r[3])))
# The pendulum's (2, 1) instances on its own carry: (tag, kernel, B, H,
# cost form, Jacobian carry type), grouped by (B, H).
PENDULUM_SHAPES = tuple(sorted(
    [(f"K1_2x1_B{B}_H{H}", "K1", B, H, "fixed", "f32") for B, H in
     ((16384, 200), (4096, 200), (256, 20), (1024, 10))]
    + [(f"K1_bm_2x1_B{B}_H{H}", "K1bm", B, H, "fixed", "f32") for B, H in
       ((4096, 200), (1024, 10))]
    + [(f"K2_2x1_B{B}_H{H}", "K2", B, H, "fixed", "f32") for B, H in
       ((16384, 200), (4096, 200), (256, 20), (1024, 10))]
    + [(f"K3_2x1_B{B}_H{H}", "K3", B, H, "fixed", "f32") for B, H in
       ((16384, 200), (4096, 200), (256, 20))]
    + [(f"K3_2x1_B1024_H10_lane", "K3", 1024, 10, "lane", "f32")]
    + [(f"K6_2x1_B{B}_H{H}", "K6", B, H, "lane", "f32") for B, H in ((4096, 200), (1024, 10))]
    + [(f"K7_2x1_B{B}_H{H}", "K7", B, H, "fixed", "f32") for B, H in ((4096, 200), (1024, 10))]
    + [(f"{k}_2x1_B{B}_H200", k, B, 200, "fixed", "f32") for B in (16384, 4096)
       for k in ("K8", "K9", "K2_4d")]
    + [(f"lane_{k}_2x1_B1024_H10", k, 1024, 10, "coef", "f32") for k in ("K1", "K1bm", "K3", "K7")],
    key=lambda r: (r[2], r[3])))
# The halfcheetah's (18, 6) instances: (tag, kernel, B, H).
CHEETAH_SHAPES = (("K1_bm_18x6_B1024_H200", "K1bm", 1024, 200),
                  ("K7_18x6_B1024_H200", "K7", 1024, 200))
# K6's (12, 1) instance: (tag, B, H).
K6_WIDE_SHAPES = (("K6_12x1_B1024_H10", 1024, 10), ("K6_12x1_B4096_H200", 4096, 200))
ALPHAS = tuple(0.2 ** k for k in range(L))
ALL_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "split", "lane")


def _tensor(a, dev, dtype=None):
    import torch

    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype or torch.float32, device=dev)


def k2_inputs(B, H, lane, bf16, d4, dev):
    """The lanes-last carry and cost of one K2 call: Jx near the
    identity, Ju small, a random active mask and old gains."""
    import torch

    rng = np.random.default_rng(SEED)
    jac = np.empty((H, 4, 5, B), np.float32)
    jac[:, :, :4] = np.eye(4, dtype=np.float32)[None, :, :, None] \
        + rng.normal(0, 0.05, (H, 4, 4, B))
    jac[:, :, 4] = rng.normal(0, 0.1, (H, 4, B))
    jac = _tensor(jac.reshape(H, 20, B), dev, torch.bfloat16 if bf16 else torch.float32)
    xs, us = _tensor(rng.normal(0, 1, (H + 1, 4, B)), dev), _tensor(rng.normal(0, 1, (H, B)), dev)
    carry = (_tensor(rng.uniform(size=B) < 0.7, dev, torch.bool),
             _tensor(rng.normal(0, 1, (H, 4, B)), dev), _tensor(rng.normal(0, 1, (H, B)), dev))
    if lane or d4:
        qd = _tensor(10 ** rng.uniform(-1, 1.5, (4, B)), dev)
        rd = _tensor(10 ** rng.uniform(-3, 0, (1, B)), dev)
        fd = _tensor(10 ** rng.uniform(-1, 1.5, (4, B)), dev)
    else:
        qd, rd, fd = (10.0, 0.1, 0.01, 0.01), (0.001,), (10.0, 0.1, 0.01, 0.01)
    goal = (0.0,) * 4
    if not d4:
        return (jac, xs, us, qd, rd, fd, goal, 0.05, 4, carry)
    n = B // 128
    split = lambda t, *lead: t.view(*lead, n, 128)
    act, oK, ok = carry
    return (split(jac, H, 20), split(xs[:H].contiguous(), H, 4), split(xs[H].contiguous(), 4),
            split(us, H), split(qd, 4), split(rd, 1), split(fd, 4), goal, 0.05, 4,
            (split(act, 1), split(oK, H, 4), split(ok, H)))


def k4_inputs(ds, dc, B, H, dev):
    """Dense stage expansions with Cxx, Vn positive semidefinite and Cuu
    positive definite, so Quu = Cuu + Ju'V Ju is positive definite."""
    rng = np.random.default_rng(SEED)
    Jx = np.eye(ds, dtype=np.float32) * 0.98 + rng.normal(0, 0.02, (B, H, ds, ds)).astype(np.float32)
    Ju = rng.normal(0, 0.1, (B, H, ds, dc)).astype(np.float32)
    M = rng.normal(0, 1, (B, H, ds, ds)).astype(np.float32)
    Cxx = (M @ M.swapaxes(-1, -2)) / ds * 0.05
    del M
    N = rng.normal(0, 1, (B, H, dc, dc)).astype(np.float32)
    Cuu = (N @ N.swapaxes(-1, -2)) / dc * 0.01 + 0.01 * np.eye(dc, dtype=np.float32)
    cx = rng.normal(0, 0.05, (B, H, ds))
    cu = rng.normal(0, 0.05, (B, H, dc))
    P = rng.normal(0, 1, (B, ds, ds))
    Vn = P @ P.swapaxes(-1, -2) / ds
    vn = rng.normal(0, 1, (B, ds))
    return tuple(_tensor(a, dev) for a in (Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn))


def k5_inputs(widths, ds, dc, B, H, dev):
    rng = np.random.default_rng(SEED)
    layers = []
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        scale = (0.1 if i == len(widths) - 2 else 1.0) / np.sqrt(a)
        layers.append((_tensor(rng.normal(0, scale, (a, b)), dev),
                       _tensor(rng.normal(0, 0.01, b), dev)))
    x0 = rng.uniform(-0.1, 0.1, (B, ds))
    xs = x0[:, None] + rng.normal(0, 0.01, (B, H + 1, ds))
    return (tuple(layers), "relu", _tensor(x0, dev), _tensor(xs, dev),
            _tensor(rng.normal(0, 0.1, (B, H, dc)), dev),
            _tensor(rng.normal(0, 0.1, (B, H, dc, ds)), dev),
            _tensor(rng.normal(0, 0.1, (B, H, dc)), dev),
            tuple(0.2 ** k for k in range(L)), -1.0, 1.0)


def cheetah_inputs(B, H, dev):
    """K7's arguments at the halfcheetah's (18, 6) (K1's batch-major entry
    takes terms, xs, us and coeffs of them): the 48-term quadratic library
    (``poly_basis=True, poly_degree=2``), coefficients near the identity
    map, a carry of small states and controls, small gains."""
    from autompc_torch.sysid.basis import FeatureLibrary

    rng = np.random.default_rng(SEED)
    ds, dc = 18, 6
    lib = FeatureLibrary.from_config(ds + dc, poly_basis=True, poly_degree=2)
    n = lib.n_features
    coeffs = rng.normal(0, 0.01 / np.sqrt(n), (ds, n))
    coeffs[:, :ds] += np.eye(ds)
    xs = rng.uniform(-0.2, 0.2, (B, H + 1, ds))
    us = rng.uniform(-0.2, 0.2, (B, H, dc))
    return (lib.terms, _tensor(xs[:, 0], dev), _tensor(xs, dev), _tensor(us, dev),
            _tensor(rng.normal(0, 0.01, (B, H, dc, ds)), dev),
            _tensor(rng.normal(0, 0.05, (B, H, dc)), dev), _tensor(coeffs, dev), ALPHAS,
            -1.0, 1.0)


def k6_wide_inputs(B, H, dev):
    """K6's arguments at ds = 12: Jx near the identity, Ju small, per-lane
    cost diagonals over obsdim = 4 (the Koopman lift's first four
    coordinates are the cartpole's state)."""
    rng = np.random.default_rng(SEED)
    ds = 12
    Jx = np.eye(ds)[None, None] * 0.99 + rng.normal(0, 0.02, (B, H, ds, ds))
    return (_tensor(Jx, dev), _tensor(rng.normal(0, 0.1, (B, H, ds, 1)), dev),
            _tensor(rng.normal(0, 1, (B, H + 1, ds)), dev), _tensor(rng.normal(0, 1, (B, H, 1)), dev),
            _tensor(10 ** rng.uniform(-1, 1.5, (B, 4)), dev),
            _tensor(10 ** rng.uniform(-3, 0, (B, 1)), dev),
            _tensor(10 ** rng.uniform(-1, 1.5, (B, 4)), dev), (0.0,) * 4, 0.05, 4)


def ls_model(dev, system="cartpole"):
    """The main path's model, cost and solver options: the cartpole
    SINDy fit (trig + interaction library, data 50 x 100, seed 42) made
    on the CPU in float64, its coefficients then moved to the card; Q =
    F = diag(10, .1, .01, .01), R = 0.001. ``system="pendulum"``: the
    same for the pendulum, Q = F = diag(10, .1)."""
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark, PendulumSwingupBenchmark
    from autompc_torch.costs import QuadCost
    from autompc_torch.sysid import SINDy

    pend = system == "pendulum"
    bench = PendulumSwingupBenchmark() if pend else CartpoleSwingupBenchmark()
    kw = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
              trig_interaction=True, time_mode="discrete")
    fit = SINDy(bench.system, device="cpu", **kw)
    fit.train(bench.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100, device="cpu"))
    model = SINDy(bench.system, device=dev, **kw)
    model.set_parameters(fit.get_parameters())
    coeffs = fit.coeffs.numpy()
    active = tuple(int(k) for k in np.flatnonzero(np.any(coeffs != 0, axis=0)))
    ds = 2 if pend else 4
    qd = np.diag([10.0, 0.1] if pend else [10.0, 0.1, 0.01, 0.01])
    cost = QuadCost(bench.system, qd, 0.001 * np.eye(1), qd, goal=np.zeros(ds))
    bounds = bench.task.get_ctrl_bounds()
    common = dict(ds=ds, dc=1, obsdim=ds, dt=bench.system.dt,
                  ubounds=(bounds[:, 0], bounds[:, 1]), backward="pallas",
                  feature_spec=(model.library, "coeffs"), fuse_ls=True, lanes_last=True,
                  feature_mask=active)
    return model, cost, common, active


def ls_carry(model, cost, common, active, B, H, dev):
    """The lanes-last carry after ``make_carry0`` at (B, H) from x0 drawn
    from the seed, one backward pass on it (fixed cost), and the line
    search's arguments under the fixed cost, under per-lane planes
    (the fan-out's weighting draw), and under those planes with a
    lanes-last (ds, F, B) coefficient plane over the whole library
    (``coef``: the fitted model plus 1e-5 * N(0, 1) a coefficient and
    lane)."""
    import torch
    from autompc_torch.control import make_batched_ilqr_solver
    from autompc_torch.ops import cuda_riccati as K2

    _, make_carry0, _, _ = make_batched_ilqr_solver(model.pred_core, cost, H=H,
                                                    return_pieces=True, **common)
    rng = np.random.default_rng(SEED)
    f = model.coeffs.dtype
    ds = common["ds"]
    x0 = _tensor(rng.uniform(-1, 1, (B, ds)) * np.array([3.1] + [1.0] * (ds - 1)), dev, f)
    c = make_carry0(model.params, x0, x0.new_zeros((B, H, 1)))
    act = ~c["converged"] & ~c["failed"]
    qd = (10.0, 0.1, 0.01, 0.01)[:ds]
    fixed = (qd, (0.001,), qd, (0.0,) * ds)
    lane = (_tensor(10 ** rng.uniform(-1, 1.5, (ds, B)), dev, f),
            _tensor(10 ** rng.uniform(-3, 0, (1, B)), dev, f),
            _tensor(10 ** rng.uniform(-1, 1.5, (ds, B)), dev, f), (0.0,) * ds)
    KsT, ksT, lin, quad = K2.backward_quad_ll(c["jac"], c["xs"], c["us"], *fixed, common["dt"],
                                              ds, carry=(act, c["Ks"], c["ks"]))
    ks_small = torch.sqrt((ksT * ksT).sum(0)) < 1e-3
    terms = tuple(model.library.terms[k] for k in active)
    ca = model.coeffs[:, list(active)].contiguous()
    bounds = common["ubounds"]
    head = (terms, c["x0s"], c["xs"], c["us"], KsT, ksT, ca, ALPHAS,
            float(bounds[0][0]), float(bounds[1][0]))
    ls = {form: head + cost_ + (common["dt"],) for form, cost_ in (("fixed", fixed), ("lane", lane))}
    C = model.coeffs
    plane = (C[:, :, None] + _tensor(rng.standard_normal(tuple(C.shape) + (B,)), dev, f) * 1e-5)
    ls["coef"] = ((tuple(model.library.terms),) + head[1:6] + (plane.contiguous(),) + head[7:]
                  + lane + (common["dt"],))
    jac = {"f32": c["jac"], "bf16": c["jac"].to(torch.bfloat16)}
    k2 = (c["jac"], c["xs"], c["us"], *fixed, common["dt"], ds)
    return ls, (c["obj"], lin, quad, ks_small, act), jac, dict(args=k2, carry=(act, c["Ks"],
                                                                             c["ks"]))


def ls_call(kind, ls, tail, jac, K1, K2, K3):
    """The call that ``kind`` times on one carry: each tree through its
    own wrappers. K8's digest is of its objectives, K9's of its outputs;
    K9's inputs (K8's outputs and the acceptance rule's) are made once,
    in the tree's own signature. K1's batch-major entry is, in a tree
    without it, the lanes-last entry behind the solver's old layout
    adapter (permute in, unpack out), whose copies its time includes. K6
    and K7 take the carry in batch-major form, K6 with the per-lane
    planes of ``ls`` (the ``lane`` form)."""
    terms, x0T, xsT, usT, KsT, ksT, ca, alphas, lo, hi = ls[:10]
    H, B = usT.shape
    ds = xsT.shape[1]
    bm = dict(xs=xsT.permute(2, 0, 1).contiguous(), us=usT.T[:, :, None].contiguous())
    if kind == "K1bm":
        if hasattr(K1, "relin_jacobians_bm"):
            return lambda: K1.relin_jacobians_bm(terms, bm["xs"], bm["us"], ca)

        def adapter():
            j = K1.relin_jacobians(terms, bm["xs"].permute(1, 2, 0).contiguous(),
                                   bm["us"][:, :, 0].T.contiguous(), ca)
            j = j.reshape(H, ds, ds + 1, B).permute(3, 0, 1, 2)
            return j[..., :ds].contiguous(), j[..., ds:].contiguous()

        return adapter
    if kind == "K6":
        j = jac.reshape(H, ds, ds + 1, B).permute(3, 0, 1, 2)
        args = (j[..., :ds].contiguous(), j[..., ds:].contiguous(), bm["xs"], bm["us"],
                *(v.T.contiguous() for v in ls[10:13]), ls[13], ls[14], ds)
        return lambda: K2.backward_quad(*args)
    if kind == "K8":
        return lambda: (lambda o: o[0] if isinstance(o, tuple) else o)(K3.wide_objectives(*ls))
    if kind == "split":
        return lambda: K3.fused_line_search_wide(*ls, *tail, jac)
    if kind == "K3":
        return lambda: K3.fused_line_search(*ls, *tail, jac)
    if kind == "K1":
        return lambda: K1.relin_jacobians(terms, xsT, usT, ca)
    if kind == "K7":
        args = (x0T.T.contiguous(), bm["xs"], bm["us"],
                KsT.permute(2, 0, 1)[:, :, None].contiguous(), ksT.T[:, :, None].contiguous())
        return lambda: K3.sindy_line_search(terms, *args, ca, alphas, lo, hi)
    out = K3.wide_objectives(*ls)
    if isinstance(out, tuple):
        objs, stash, du2s = out
        sel, tm, jm = K3.wide_accept(objs, alphas, *tail)[:3]
        args = (terms, x0T, xsT, usT, ca, stash, du2s, sel, tm, jm, jac)
    else:
        a_sel, tm, jm = K3.wide_accept(out, alphas, *tail)[:3]
        args = (terms, x0T, xsT, usT, KsT, ksT, ca, a_sel, lo, hi, tm, jm, jac)
    return lambda: K3.wide_reroll(*args)


def time_ms(fn, reps=20):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    two untimed warm-up runs first)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps=10, windows=3):
    """Milliseconds of device time a call of ``fn()`` takes: the kernels'
    own time under torch.profiler, without the host's time between
    launches (which the CUDA-event median above includes when a call is
    shorter than its wrapper's host work). The profiler now and then
    loses a window's records, which only shortens the sum, so the
    longest of ``windows`` windows of ``reps`` calls is taken."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = 0.0
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        best = max(best, total_us / reps / 1e3)
    return best


def digest(outputs):
    """SHA-256 of the bytes of a tuple of tensors."""
    import torch

    return hashlib.sha256(b"".join(
        t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes()
        for t in outputs)).hexdigest()


def time_one(root, only):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from autompc_torch.ops import cuda_linesearch as K3
    from autompc_torch.ops import cuda_mlp_linesearch as K5
    from autompc_torch.ops import cuda_relin as K1
    from autompc_torch.ops import cuda_riccati as K2
    from autompc_torch.ops import cuda_riccati_general as K4

    dev = torch.device("cuda", 0)
    out = {"root": root, "card": torch.cuda.get_device_name(0)}

    def wanted(tag):
        return any(tag.startswith(p) or tag.startswith(f"lane_{p}") for p in only)

    def record(tag, run):
        res = run()
        out[f"{tag}_sha256"] = digest(res if isinstance(res, tuple) else (res,))
        out[tag] = time_ms(run)
        out[f"{tag}_device_ms"] = device_ms(run)

    def record_built(tag, run):
        """``record``, or ``*_skipped`` where the tree refuses the shape
        (a tree built before its instance)."""
        try:
            record(tag, run)
        except ValueError as e:
            out[f"{tag}_skipped"] = str(e)

    shapes = [r for r in LS_SHAPES if wanted(r[0])]
    if shapes:
        problem = ls_model(dev)
    group = None
    for tag, kind, B, H, form, jt in shapes:
        if group != (B, H):
            group, carry = (B, H), None
            torch.cuda.empty_cache()
            carry = ls_carry(*problem, B, H, dev)
        ls, tail, jac, _ = carry
        run = ls_call(kind, ls[form], tail, jac[jt], K1, K2, K3)
        record(tag, run)
        for name, const, value in VARIANTS.get(kind, ()):
            module = K3 if kind == "K7" else K1
            if not hasattr(module, const):
                continue
            kept = getattr(module, const)
            setattr(module, const, value)
            try:
                record(f"{tag}_{name}", run)
            finally:
                setattr(module, const, kept)
        if kind == "K6" and hasattr(K2, "bq_bm_geometry"):
            g = K2.bq_bm_geometry(B, H, sm_count=K2._build.sm_count(dev))
            out[f"{tag}_geometry"] = (f"{g['group']} threads a lane, {g['lanes_per_block']} "
                                      f"lanes a block, {g['blocks']} blocks, ring {g['ring']}, "
                                      f"{g['smem']} bytes of shared memory a block")
    carry = None
    shapes = [r for r in PENDULUM_SHAPES if wanted(r[0])]
    if shapes:
        problem = ls_model(dev, "pendulum")
    group = None
    for tag, kind, B, H, form, jt in shapes:
        if group != (B, H):
            group, carry = (B, H), None
            torch.cuda.empty_cache()
            try:
                carry = ls_carry(*problem, B, H, dev)
            except ValueError as e:     # a tree without the (2, 1) instances
                carry = str(e)
        if isinstance(carry, str):
            out[f"{tag}_skipped"] = carry
            continue
        ls, tail, jac, k2 = carry
        if kind == "K2":
            record_built(tag, lambda: K2.backward_quad_ll(*k2["args"], carry=k2["carry"]))
        elif kind == "K2_4d":
            record_built(tag, lambda: K2.backward_quad_ll(*k2["args"], carry=k2["carry"],
                                                          wide_io="reshape"))
        else:
            try:    # K9's inputs come from K8, which a tree without it refuses
                run = ls_call(kind, ls[form], tail, jac[jt], K1, K2, K3)
            except ValueError as e:
                out[f"{tag}_skipped"] = str(e)
                continue
            record_built(tag, run)
    carry = None
    for tag, kind, B, H in CHEETAH_SHAPES:
        if not wanted(tag):
            continue
        args = cheetah_inputs(B, H, dev)
        if kind == "K1bm":
            record_built(tag, lambda: K1.relin_jacobians_bm(args[0], args[2], args[3], args[6]))
        else:
            record_built(tag, lambda: K3.sindy_line_search(*args))
        del args
    for tag, B, H in K6_WIDE_SHAPES:
        if not wanted(tag):
            continue
        args = k6_wide_inputs(B, H, dev)
        record(tag, lambda: K2.backward_quad(*args))
        del args
    for tag, B, H, lane, bf16, d4 in K2_SHAPES:
        if not wanted(tag):
            continue
        args = k2_inputs(B, H, lane, bf16, d4, dev)
        fn = K2.backward_quad_ll_wide_4d if d4 else K2.backward_quad_ll
        record(tag, lambda: fn(*args))
        del args
    for tag, ds, dc, B, H in K4_SHAPES:
        if not wanted(tag):
            continue
        args = k4_inputs(ds, dc, B, H, dev)
        record_built(tag, lambda: K4.riccati_general(*args))
        del args
    for tag, widths, ds, dc, B, H in K5_SHAPES:
        if not wanted(tag):
            continue
        args = k5_inputs(widths, ds, dc, B, H, dev)
        record(tag, lambda: K5.mlp_line_search(*args))
        if not hasattr(K5, "mlp_geometry"):
            continue
        sm_count = K5._build.sm_count
        for block, n_sm in BLOCKS:
            K5._build.sm_count = lambda device: n_sm
            try:
                g = K5.mlp_geometry(list(widths), ds, dc, L, B, n_sm)
                out[f"{tag}_{block}_block"] = f"{g['rollouts']} rollouts, {g['threads']} threads"
                record(f"{tag}_{block}", lambda: K5.mlp_line_search(*args))
            finally:
                K5._build.sm_count = sm_count
        del args
    print(json.dumps(out), flush=True)


def main(argv):
    only = ALL_KERNELS
    if argv[:1] == ["--only"]:
        only, argv = tuple(argv[1].split(",")), argv[2:]
    if len(argv) == 2 and argv[0] == "--one":
        time_one(argv[1], only)
        return 0
    if not argv:
        print(__doc__)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0], flush=True)
    tags = [s[0] for s in K2_SHAPES + K4_SHAPES + K5_SHAPES + LS_SHAPES + PENDULUM_SHAPES
            + CHEETAH_SHAPES + K6_WIDE_SHAPES
            if any(s[0].startswith(p) or s[0].startswith(f"lane_{p}") for p in only)]
    digests = {tag: set() for tag in tags}
    for root in argv:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--only",
                              ",".join(only), "--one", root],
                             check=True, stdout=subprocess.PIPE, text=True)
        line = run.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        out = json.loads(line)
        for tag in digests:
            keys = ([f"{tag}_sha256"] + [f"{tag}_{block}_sha256" for block, _ in BLOCKS]
                    + [f"{tag}_{name}_sha256" for name in VARIANT_NAMES])
            digests[tag] |= {out[k] for k in keys if k in out}
    same = {kernel: all(len(d) <= 1 for tag, d in digests.items()
                        if tag.startswith(kernel + "_") or tag.startswith(f"lane_{kernel}"))
            for kernel in only}
    differ = sorted(tag for tag, d in digests.items() if len(d) > 1)
    missing = sorted(tag for tag, d in digests.items() if not d)
    print(json.dumps({"same_outputs_bit_for_bit": all(same.values()), **same, "differ": differ,
                      "run_by_no_tree": missing}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
