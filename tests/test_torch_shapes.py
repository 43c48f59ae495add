"""The feature kernels off the cartpole's shape, against the JAX package,
float64 on the CPU (the kernels' plain versions: a CPU tensor takes them).

(a) K1's plain versions (both entries at dc = 1, the batch-major entry
    at any dc) against ``pallas_feature_jacobians(..., interpret=True)``
    and K7's against ``pallas_sindy_line_search(..., interpret=True)`` at
    (ds, dc) = (2, 1) (the pendulum, the main path's trig + interaction
    library at d = 3: 21 terms), (3, 2) (trig basis), (18, 6) (the
    halfcheetah, ``poly_basis=True, poly_degree=2``: 48 terms) and (1, 2)
    (trig basis; the smallest ds), 1e-10;
(b) K2's, K3's and K6's plain versions against their JAX kernels in
    interpret mode at ds = 2, 1e-10;
(c) the pendulum's SINDy (lstsq, threshold 1e-3) through the port's
    scheduled lanes-last solver against JAX's
    ``make_scheduled_ilqr_solver(lanes_last=True, pallas_interpret=True)``
    (converged flags equal, xs/us/Ks/ks to 1e-9), ``QuadCostFanout`` with
    the feature spec in both bodies against JAX's (1e-8), and one "ilqr"
    tune against JAX's tuner (1e-6);
(d) the batch-major solve with ``feature_spec`` at (3, 2) and (18, 6)
    (K1's batch-major entry, K4's and K7's plain versions) against JAX's
    ``make_batched_ilqr_solver(feature_spec=None, backward="scan")``: the
    same math through jacfwd and the plain line search, because JAX's
    feature body cannot run its general backward kernel and its rollout
    line search in interpret mode (1e-8);
(e) the launch geometry at (2, 1) and (18, 6) and the limits, raised by
    name.
The SINDy models of both packages carry the same coefficients
(``SINDy.set_parameters``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import PendulumSwingupBenchmark as TPendulum
from autompc_torch.control import ilqr as tilqr
from autompc_torch.core import System as TSystem
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.ops import _build
from autompc_torch.ops import cuda_linesearch as K3
from autompc_torch.ops import cuda_relin as K1
from autompc_torch.ops import cuda_riccati as K2
from autompc_torch.parallel import QuadCostFanout as TFanout
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.sysid.basis import FeatureLibrary as TLibrary
from autompc_tpu.benchmarks import PendulumSwingupBenchmark
from autompc_tpu.control import ilqr as jilqr
from autompc_tpu.core.system import System
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.ops.pallas_linesearch import pallas_fused_line_search, pallas_sindy_line_search
from autompc_tpu.ops.pallas_relin import pallas_feature_jacobians
from autompc_tpu.ops.pallas_riccati import (
    pallas_tvlqr_backward_quad,
    pallas_tvlqr_backward_quad_ll,
)
from autompc_tpu.parallel import QuadCostFanout
from autompc_tpu.sysid import SINDy
from autompc_tpu.sysid.basis import FeatureLibrary

torch.set_num_threads(1)

SINDY_KW = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
                trig_interaction=True)
# The library of each shape: the pendulum's main-path library, a trig
# basis, the halfcheetah's quadratic basis.
LIBS = {(2, 1): dict(trig_basis=True, trig_interaction=True),
        (3, 2): dict(trig_basis=True),
        (18, 6): dict(poly_basis=True, poly_degree=2),
        (1, 2): dict(trig_basis=True)}
N_TERMS = {(2, 1): 21, (3, 2): 15, (18, 6): 48, (1, 2): 9}
SHAPES = list(LIBS)
QP = np.array([10.0, 0.1])


def _libraries(ds, dc):
    return (FeatureLibrary.from_config(ds + dc, **LIBS[(ds, dc)]),
            TLibrary.from_config(ds + dc, **LIBS[(ds, dc)]))


def _coeffs(rng, ds, n, d):
    """A model near the identity map: x' = x + 0.05 (small coefficients
    on every term)."""
    c = rng.normal(0.0, 0.05 / np.sqrt(n), (ds, n))
    c[:, :ds] += np.eye(ds)
    return c


@pytest.fixture(scope="module")
def pendulum():
    b = PendulumSwingupBenchmark()
    m = SINDy(b.system, **SINDY_KW)
    m.train(b.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100))
    tb = TPendulum()
    t = TSINDy(tb.system, device="cpu", **SINDY_KW)
    t.set_parameters({**m.get_parameters(), "feature_names": m.get_feature_names()})
    active = tuple(int(k) for k in np.flatnonzero(np.any(np.asarray(m.coeffs) != 0, axis=0)))
    bounds = b.task.get_ctrl_bounds()
    return dict(b=b, tb=tb, m=m, t=t, active=active, bounds=bounds)


def test_pendulum_library_and_support(pendulum):
    """The main path's library at d = 3 has 21 terms; lstsq at threshold
    1e-3 keeps a few of them, and both packages name the same features."""
    m, t = pendulum["m"], pendulum["t"]
    assert m.library.n_features == t.library.n_features == N_TERMS[(2, 1)]
    assert 2 <= len(pendulum["active"]) < N_TERMS[(2, 1)]
    assert t.get_feature_names() == m.get_feature_names()


# ---- (a) K1 and K7 at (2, 1), (3, 2), (18, 6) --------------------------------


@pytest.mark.parametrize("ds, dc", SHAPES)
def test_relin_plain_matches_pallas(ds, dc):
    jl, tl = _libraries(ds, dc)
    assert jl.n_features == tl.n_features == N_TERMS[(ds, dc)]
    rng = np.random.default_rng(ds * 10 + dc)
    B, H = 3, 4
    coeffs = _coeffs(rng, ds, jl.n_features, ds + dc)
    xs = rng.uniform(-1.5, 1.5, (B, H + 1, ds))
    us = rng.uniform(-1.0, 1.0, (B, H, dc))
    Jx, Ju = pallas_feature_jacobians(tuple(jl._fns), jnp.asarray(xs), jnp.asarray(us),
                                      jnp.asarray(coeffs), grad_terms=jl.grad_terms,
                                      block_b=B, interpret=True)
    T = torch.as_tensor
    got = K1.relin_jacobians_bm(tl.terms, T(xs), T(us), T(coeffs))
    assert tuple(got[1].shape) == (B, H, ds, dc)
    for g, r in zip(got, (Jx, Ju)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-10)
    if dc == 1:
        # The lanes-last entry on the same points: the batch-major rows,
        # bit for bit.
        jac = K1.relin_jacobians(tl.terms, T(xs).permute(1, 2, 0).contiguous(),
                                 T(us)[:, :, 0].T.contiguous(), T(coeffs))
        jac = jac.reshape(H, ds, ds + 1, B).permute(3, 0, 1, 2)
        assert torch.equal(jac[..., :ds], got[0]) and torch.equal(jac[..., ds:], got[1])
    else:
        # The packed lanes-last plane feeds the dc = 1 kernels only.
        with pytest.raises(ValueError, match="expected ds \\+ dc"):
            K1.relin_jacobians(tl.terms, T(xs).permute(1, 2, 0).contiguous(),
                               T(us)[:, :, 0].T.contiguous(), T(coeffs))


@pytest.mark.parametrize("ds, dc", SHAPES)
def test_sindy_line_search_plain_matches_pallas(ds, dc):
    jl, tl = _libraries(ds, dc)
    rng = np.random.default_rng(100 + ds * 10 + dc)
    B, H, L = 3, 5, 4
    coeffs = _coeffs(rng, ds, jl.n_features, ds + dc)
    d = dict(x0=rng.uniform(-1, 1, (B, ds)), xs=rng.uniform(-1, 1, (B, H + 1, ds)),
             us=rng.uniform(-1, 1, (B, H, dc)), Ks=rng.normal(size=(B, H, dc, ds)) * 0.3,
             ks=rng.normal(size=(B, H, dc)))
    keys = ("x0", "xs", "us", "Ks", "ks")
    alphas = tuple(0.2 ** k for k in range(L))
    # Each control its own bounds; the first one's bind.
    umax = np.linspace(0.4, 3.0, dc)
    ref = pallas_sindy_line_search(
        tuple(jl._fns), *(jnp.asarray(d[k]) for k in keys), jnp.asarray(coeffs),
        jnp.asarray(alphas), jnp.asarray(-umax), jnp.asarray(umax), block_b=B, block_l=L,
        interpret=True)
    got = K3.sindy_line_search(tl.terms, *(torch.as_tensor(d[k]) for k in keys),
                               torch.as_tensor(coeffs), alphas, -umax, umax)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-10)
    assert (got[1].abs() <= torch.as_tensor(umax)).all()
    assert (got[1][..., 0].abs() == umax[0]).any()


# ---- (b) K2, K3 and K6 at ds = 2 ------------------------------------------------


def test_backward_quad_ll_plain_matches_pallas_at_ds2():
    rng = np.random.default_rng(7)
    B, H, ds = 6, 9, 2
    d = dict(jac=rng.normal(0, 0.3, (H, ds * (ds + 1), B)), xs=rng.normal(size=(H + 1, ds, B)),
             us=rng.normal(size=(H, B)), act=rng.uniform(size=B) > 0.3,
             oK=rng.normal(size=(H, ds, B)), ok=rng.normal(size=(H, B)))
    qd, rd, fd, goal = rng.uniform(0.1, 2, ds), rng.uniform(0.1, 2, 1), rng.uniform(0.1, 2, ds), \
        rng.normal(size=ds)
    col = lambda v: jnp.asarray(np.repeat(v[:, None], B, axis=1))
    ref = pallas_tvlqr_backward_quad_ll(
        jnp.asarray(d["jac"]), jnp.asarray(d["xs"]), jnp.asarray(d["us"]), col(qd), col(rd),
        col(fd), jnp.asarray(goal), 0.05, ds, block_b=B, interpret=True,
        carry=(jnp.asarray(d["act"]), jnp.asarray(d["oK"]), jnp.asarray(d["ok"])))
    T = torch.as_tensor
    got = K2.backward_quad_ll(T(d["jac"]), T(d["xs"]), T(d["us"]), tuple(qd), tuple(rd),
                              tuple(fd), tuple(goal), 0.05, ds,
                              carry=(T(d["act"]), T(d["oK"]), T(d["ok"])))
    for name, g, r in zip(("Ks", "ks", "lin", "quad"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-10,
                                   err_msg=name)


def test_backward_quad_plain_matches_pallas_at_ds2():
    rng = np.random.default_rng(8)
    B, H, ds = 6, 9, 2
    d = dict(Jx=rng.normal(size=(B, H, ds, ds)) * 0.3, Ju=rng.normal(size=(B, H, ds, 1)),
             xs=rng.normal(size=(B, H + 1, ds)), us=rng.normal(size=(B, H, 1)),
             Qd=rng.uniform(0.1, 5.0, (B, ds)), Rd=rng.uniform(0.01, 1.0, (B, 1)),
             Fd=rng.uniform(0.1, 5.0, (B, ds)))
    keys = ("Jx", "Ju", "xs", "us", "Qd", "Rd", "Fd")
    goal = rng.normal(size=ds)
    ref = pallas_tvlqr_backward_quad(*(jnp.asarray(d[k]) for k in keys), jnp.asarray(goal),
                                     0.05, ds, block_b=B, interpret=True)
    got = K2.backward_quad(*(torch.as_tensor(d[k]) for k in keys), tuple(goal), 0.05, ds)
    for name, g, r in zip(("Ks", "ks", "lin", "quad"), got, ref):
        assert tuple(g.shape) == tuple(r.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-10,
                                   err_msg=name)


@pytest.mark.parametrize("per_lane", [False, True], ids=["fixed_cost", "per_lane_cost"])
def test_fused_line_search_plain_matches_pallas_at_ds2(pendulum, per_lane):
    m, t, active = pendulum["m"], pendulum["t"], pendulum["active"]
    rng = np.random.default_rng(9 + per_lane)
    B, H, ds = 12, 8, 2
    obj0 = rng.uniform(2.0, 30.0, B)
    d = dict(x0=rng.uniform(-1, 1, (ds, B)), xs=rng.uniform(-1, 1, (H + 1, ds, B)),
             us=rng.uniform(-2, 2, (H, B)), Ks=rng.normal(size=(H, ds, B)) * 0.3,
             ks=rng.normal(size=(H, B)), obj0=obj0,
             lin=-rng.uniform(0.1, 5.0, B) * obj0 / 10, quad=-rng.uniform(0.1, 5.0, B),
             ks_small=rng.uniform(size=B) < 0.15, act=rng.uniform(size=B) > 0.25,
             old_jac=rng.normal(size=(H, ds * (ds + 1), B)))
    alphas = tuple(0.2 ** k for k in range(10))
    if per_lane:
        qd, rd, fd = (rng.uniform(0.1, 10, (ds, B)), rng.uniform(1e-3, 1, (1, B)),
                      rng.uniform(0.1, 10, (ds, B)))
        jcost, tcost = (qd, rd, fd), tuple(torch.as_tensor(v) for v in (qd, rd, fd))
    else:
        jcost = (np.diag(QP), 0.001 * np.eye(1), np.diag(QP))
        tcost = (tuple(QP), (0.001,), tuple(QP))
    goal = np.zeros(ds)
    gts = m.library.grad_terms
    ref = pallas_fused_line_search(
        tuple(m.library._fns[k] for k in active),
        *(jnp.asarray(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")),
        m.coeffs[:, jnp.asarray(active)], jnp.asarray(alphas), -2.0, 2.0,
        *(jnp.asarray(v) for v in jcost), jnp.asarray(goal), 0.05,
        *(jnp.asarray(d[k]) for k in ("obj0", "lin", "quad", "ks_small")),
        grad_terms=tuple(gts[k] for k in active), block_b=B, interpret=True, ll_io=True,
        per_lane_diag_cost=per_lane, carry=(jnp.asarray(d["act"]), jnp.asarray(d["old_jac"])))
    T = torch.as_tensor
    got = K3.fused_line_search(
        tuple(t.library.terms[k] for k in active),
        *(T(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")), t.coeffs[:, list(active)],
        alphas, -2.0, 2.0, *tcost, tuple(goal), 0.05,
        *(T(d[k]) for k in ("obj0", "lin", "quad", "ks_small", "act", "old_jac")))
    for name, g, r in zip(("xs", "us", "obj", "succ", "fail", "jac", "du2"), got, ref):
        r = np.asarray(r).reshape(g.shape)
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-10, atol=1e-10, err_msg=name)


# ---- (c) the pendulum through the solver, the fan-out and the tuner --------------


def _pendulum_common(p, H=8):
    return dict(H=H, ds=2, dc=1, obsdim=2, dt=p["b"].system.dt,
                ubounds=(p["bounds"][:, 0], p["bounds"][:, 1]), max_iter=10)


LL = dict(backward="pallas", fuse_ls=True, lanes_last=True)
BM = dict(backward="pallas", fuse_ls=False, lanes_last=False)


def test_pendulum_scheduled_lanes_last_solve_matches_jax(pendulum):
    p = pendulum
    m, t = p["m"], p["t"]
    common = dict(_pendulum_common(p), feature_mask=p["active"], schedule=((3, 0.5),), **LL)
    jcost = JQuad(p["b"].system, jnp.diag(jnp.asarray(QP)), 0.001 * jnp.eye(1),
                  jnp.diag(jnp.asarray(QP)), goal=jnp.zeros(2))
    tcost = TQuad(p["tb"].system, np.diag(QP), 0.001 * np.eye(1), np.diag(QP), goal=np.zeros(2))
    jsolve = jax.jit(jilqr.make_scheduled_ilqr_solver(
        m.pred_core, jcost, feature_spec=(m.library, "coeffs"), pallas_interpret=True,
        **common))
    tsolve = tilqr.make_scheduled_ilqr_solver(t.pred_core, tcost,
                                              feature_spec=(t.library, "coeffs"), **common)
    rng = np.random.default_rng(6)
    x0 = rng.uniform(-1, 1, (8, 2)) * np.array([np.pi, 1.0])
    out_j = jsolve(m.params, jnp.asarray(x0), jnp.zeros((8, 8, 1)))
    out_t = tsolve(t.params, torch.as_tensor(x0), torch.zeros((8, 8, 1), dtype=torch.float64))
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    for i, name in zip((1, 2, 3, 4), ("xs", "us", "Ks", "ks")):
        np.testing.assert_allclose(out_t[i].numpy(), np.asarray(out_j[i]), rtol=1e-9,
                                   atol=1e-9, err_msg=name)
    assert out_t[0].any()


def _quad_task(bench, cost_cls, steps=None):
    """The pendulum from near upright (where the torque bound of 2 can
    hold it: from further out every weighting saturates the control alike
    and scores the same), scored by a quadratic task cost (a continuous
    score)."""
    task = bench.task.copy()
    task.set_cost(cost_cls(bench.system, Q=np.eye(2), R=0.01 * np.eye(1), F=np.eye(2),
                           goal=np.zeros(2)))
    task.set_init_obs(np.array([0.15, 0.0]))
    if steps is not None:
        task.set_num_steps(steps)
    return task


@pytest.mark.parametrize("opts", [LL, BM], ids=["lanes_last", "batch_major"])
def test_pendulum_fanout_matches_jax(pendulum, opts):
    """QuadCostFanout on the pendulum's SINDy through the feature kernels'
    plain versions (lanes-last: K1, K2, K3; batch-major: K1's batch-major
    entry, K6, K7) against JAX's fan-out (its CPU-safe form: backward
    "scan", no feature kernels)."""
    p = pendulum
    b, m, tb, t = p["b"], p["m"], p["tb"], p["t"]
    rng = np.random.default_rng(0)
    n = 6
    cand = {"Qdiag": rng.uniform(0.1, 20.0, (n, 2)), "Fdiag": rng.uniform(0.1, 20.0, (n, 2)),
            "Rdiag": rng.uniform(0.001, 1.0, (n, 1))}
    kw = dict(horizon=8, n_steps=5, goal=np.zeros(2))
    ref = np.asarray(QuadCostFanout(b.system, _quad_task(b, JQuad), m, m, **kw)(
        {k: jnp.asarray(v) for k, v in cand.items()}))
    got = TFanout(tb.system, _quad_task(tb, TQuad), t, t, feature_spec=(t.library, "coeffs"),
                  device="cpu", **kw, **opts)(cand)
    assert tuple(got.shape) == (n,) and np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8)
    assert len(set(ref.round(6))) == n


def test_pendulum_ilqr_tune_matches_jax(pendulum):
    """One tiny "ilqr" tune through the fan-out with the feature kernels
    (K1's batch-major entry, K7, the plain Riccati recursion), against
    JAX's tuner: the same configurations, costs and true-dynamics costs."""
    from autompc_torch.control import IterativeLQRFactory as TILQRFactory
    from autompc_torch.costs import QuadCostFactory as TQuadFactory
    from autompc_torch.pipeline import Pipeline as TPipeline
    from autompc_torch.tuning import PipelineTuner as TTuner
    from autompc_tpu.control import IterativeLQRFactory
    from autompc_tpu.costs import QuadCostFactory
    from autompc_tpu.pipeline import Pipeline
    from autompc_tpu.tuning import PipelineTuner

    p = pendulum
    b, m, tb, t = p["b"], p["m"], p["tb"], p["t"]
    jp = Pipeline(b.system, m, QuadCostFactory(b.system, goal=np.zeros(2)),
                  IterativeLQRFactory(b.system, horizon=8))
    tp = TPipeline(tb.system, t, TQuadFactory(tb.system, goal=np.zeros(2)),
                   TILQRFactory(tb.system, horizon=8))
    trajs = tb.gen_trajs_batch(seed=1, n_trajs=4, traj_len=10, device="cpu")
    _, jres = PipelineTuner(surrogate_mode="pretrain", eval_batch=4, use_fanout=True).run(
        jp, _quad_task(b, JQuad, 12), trajs, n_iters=4, rng=np.random.default_rng(3),
        surrogate=m, truedyn=b.dynamics)
    _, tres = TTuner(surrogate_mode="pretrain", eval_batch=4, use_fanout=True,
                     fanout_backward="scan", fanout_feature_kernels=True).run(
        tp, _quad_task(tb, TQuad, 12), trajs, n_iters=4, rng=np.random.default_rng(3),
        surrogate=t, truedyn=tb.dynamics)
    assert [c.get_dictionary() for c in tres.cfgs] == [c.get_dictionary() for c in jres.cfgs]
    for got, ref in ((tres.costs, jres.costs), (tres.truedyn_costs, jres.truedyn_costs)):
        assert len(got) == len(ref) == 4
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert len(set(np.round(tres.costs, 6))) > 1, tres.costs


# ---- (d) the batch-major solve with feature_spec at dc > 1 -------------------------


@pytest.mark.parametrize("ds, dc", [(3, 2), (18, 6)])
def test_batch_major_feature_solve_matches_jax_at_dc_above_one(ds, dc):
    """K1's batch-major entry, the general Riccati kernel (K4) and the
    rollout line search (K7), plain, against JAX's jacfwd + scan body on
    the same model, starts and cost."""
    H, B = (5, 2) if ds < 10 else (4, 2)
    names = ([f"x{i}" for i in range(ds)], [f"u{j}" for j in range(dc)])
    jsys, tsys = System(*names, dt=0.05), TSystem(*names, dt=0.05)
    lib = LIBS[(ds, dc)]
    m, t = SINDy(jsys, method="lstsq", **lib), TSINDy(tsys, device="cpu", method="lstsq", **lib)
    rng = np.random.default_rng(ds)
    coeffs = _coeffs(rng, ds, m.library.n_features, ds + dc)
    m.set_parameters({"coeffs": coeffs})
    t.set_parameters({"coeffs": coeffs, "feature_names": m.get_feature_names()})
    Q, R = np.diag(rng.uniform(0.5, 2.0, ds)), np.diag(rng.uniform(0.01, 0.1, dc))
    goal = rng.normal(0.0, 0.3, ds)
    common = dict(H=H, ds=ds, dc=dc, obsdim=ds, dt=0.05,
                  ubounds=(-np.ones(dc), np.ones(dc)), max_iter=6)
    jsolve = jax.jit(jilqr.make_batched_ilqr_solver(
        m.pred_core, JQuad(jsys, jnp.asarray(Q), jnp.asarray(R), jnp.asarray(Q),
                           goal=jnp.asarray(goal)), backward="scan", **common))
    tsolve = tilqr.make_batched_ilqr_solver(
        t.pred_core, TQuad(tsys, Q, R, Q, goal=goal), feature_spec=(t.library, "coeffs"),
        **BM, **common)
    x0 = rng.uniform(-0.5, 0.5, (B, ds))
    ug = rng.uniform(-0.2, 0.2, (B, H, dc))
    out_j = tuple(np.asarray(a) for a in jsolve(m.params, jnp.asarray(x0), jnp.asarray(ug)))
    out_t = tsolve(t.params, torch.as_tensor(x0), torch.as_tensor(ug))
    np.testing.assert_array_equal(out_t[0].numpy(), out_j[0])
    for i, name in zip((1, 2, 3, 4), ("xs", "us", "Ks", "ks")):
        assert tuple(out_t[i].shape) == out_j[i].shape, name
        np.testing.assert_allclose(out_t[i].numpy(), out_j[i], rtol=1e-8, atol=1e-8,
                                   err_msg=name)
    assert np.isfinite(out_t[1].numpy()).all()
    assert not np.allclose(out_t[2].numpy(), ug)       # the solve moved the controls


def test_batch_major_feature_solve_runs_the_kernels_at_dc_above_one(monkeypatch):
    """At dc > 1 the batch-major feature body calls K1's batch-major
    entry, the general Riccati kernel and K7; with fuse_ls, K3's
    batch-major entry (its multi-control instances) in place of K7."""
    ds, dc = 3, 2
    names = ([f"x{i}" for i in range(ds)], [f"u{j}" for j in range(dc)])
    tsys = TSystem(*names, dt=0.05)
    t = TSINDy(tsys, device="cpu", method="lstsq", **LIBS[(ds, dc)])
    t.set_parameters({"coeffs": _coeffs(np.random.default_rng(1), ds, t.library.n_features,
                                        ds + dc)})
    calls = []
    for name in ("relin_jacobians_bm", "riccati_general", "sindy_line_search",
                 "fused_line_search_bm"):
        real = getattr(tilqr, name)
        monkeypatch.setattr(tilqr, name,
                            lambda *a, _r=real, _n=name, **k: (calls.append(_n), _r(*a, **k))[1])
    common = dict(H=4, ds=ds, dc=dc, obsdim=ds, dt=0.05, ubounds=(-np.ones(dc), np.ones(dc)),
                  max_iter=2, feature_spec=(t.library, "coeffs"))
    cost = TQuad(tsys, np.eye(ds), 0.1 * np.eye(dc), np.eye(ds))
    tilqr.make_batched_ilqr_solver(t.pred_core, cost, **BM, **common)(
        t.params, torch.zeros((2, ds), dtype=torch.float64) + 0.3,
        torch.zeros((2, 4, dc), dtype=torch.float64))
    assert set(calls) == {"relin_jacobians_bm", "riccati_general", "sindy_line_search"}
    calls.clear()
    tilqr.make_batched_ilqr_solver(t.pred_core, cost, **dict(BM, fuse_ls=True), **common)(
        t.params, torch.zeros((2, ds), dtype=torch.float64) + 0.3,
        torch.zeros((2, 4, dc), dtype=torch.float64))
    assert set(calls) == {"relin_jacobians_bm", "riccati_general", "fused_line_search_bm"}


# ---- (e) the launch geometry and the limits ---------------------------------------


def test_geometry_at_the_new_shapes():
    """K1's threads a point and points a block, K6's group and K7's group
    at (2, 1) and (18, 6); every block's shared memory under 227 KB."""
    g = K1.relin_geometry(1024, 200, ds=18, dc=6, bm=True)     # the cheetah's solve
    assert (g["split"], g["lanes"], g["threads"]) == (True, 16, 16 * 24)
    assert g["smem"] <= K1.RELIN_STATIC_SMEM
    g = K1.relin_geometry(16384, 200, ds=18, dc=6, bm=True)   # too many points to split
    assert g["split"] and g["lanes"] == 16                      # whole blocks do not fit
    g = K1.relin_geometry(256, 20, ds=2)                        # the pendulum's gate
    assert (g["split"], g["lanes"], g["threads"]) == (True, 32, 96)
    g = K1.relin_geometry(16384, 200, ds=2)                     # the pendulum's solve
    assert (g["split"], g["lanes"], g["threads"]) == (False, 256, 256)
    for B in (1024, 512, 128, 16384):
        g = K2.bq_bm_geometry(B, 10, ds=2)
        assert g["group"] == 2 and g["threads"] % 32 == 0 and g["smem"] <= _build.MAX_SMEM_BYTES
        assert g["lanes_per_block"] * g["group"] == g["threads"]
        g = K2.bq_geometry(B, ds=2)
        assert g["smem"] <= _build.MAX_SMEM_BYTES
    for B, group in ((1024, 8), (4096, 4)):
        g = K3.sindy_geometry(B, 10)
        assert g["group"] == group
        assert g["smem"] <= 48 * 1024
    assert K3.sindy_smem(18) <= 48 * 1024 and K3.sindy_smem(2) < K3.sindy_smem(18)


def test_every_shape_within_the_limits_fits():
    """At every (ds, dc) each source's limits take (``_build.check_shape``),
    its blocks' shared memory fits: K1's (both entries) and K7's static
    48 KB, K3's static coefficient plane and reductions, K2's ring at
    every batch (up to ``_build.BQ_MAX_DS``, past which 32 lanes' ring
    does not fit) and K6's at every batch; K6's group fits a warp."""
    import re

    src = (_build.CSRC_DIR / "linesearch_fused.cu").read_text()
    decls = re.findall(r"__shared__ (\w+) s_\w+\[([^\]]+)\];", src)
    assert decls == [("float", "DS * AMPC_MAX_F"), ("float", "AMPC_LS_MAX_THREADS"),
                     ("float", "AMPC_LS_MAX_THREADS"), ("int", "AMPC_LS_MAX_THREADS"),
                     ("float", "2 * AMPC_MAX_OBS * AMPC_MAX_OBS")]
    Bs = (16, 256, 1024, 16384, 1 << 18)
    for ds in range(1, _build.MAX_D):
        for dc in range(1, _build.MAX_D - ds + 1):
            for source in ("relin", "sindy_linesearch"):
                _build.check_shape(source, ds, dc)
            for B in Bs:
                assert K1.relin_geometry(B, 200, ds=ds, dc=dc, bm=True)["smem"] \
                    <= K1.RELIN_STATIC_SMEM
            assert K3.sindy_smem(ds) <= 48 * 1024
        for B in Bs:
            assert K1.relin_geometry(B, 200, ds=ds)["smem"] <= K1.RELIN_STATIC_SMEM
        _build.check_shape("linesearch_fused", ds, 1)
        assert 4 * (ds * _build.MAX_F + 3 * _build.LS_MAX_THREADS
                    + 2 * _build.MAX_OBS ** 2) <= 48 * 1024
        _build.check_shape("riccati_quad_bm", ds, 1)
        for B in Bs:
            g = K2.bq_bm_geometry(B, 200, ds=ds)
            assert g["smem"] <= _build.MAX_SMEM_BYTES and 32 % g["group"] == 0
        if ds <= _build.BQ_MAX_DS:
            for B in Bs:
                assert K2.bq_geometry(B, ds=ds)["smem"] <= _build.MAX_SMEM_BYTES
        else:
            with pytest.raises(ValueError, match=f"ds <= {_build.BQ_MAX_DS}"):
                K2.bq_geometry(256, ds=ds)
    assert _build.BQ_MAX_DS == 13
    assert _build.BQ_MIN_LANES * _build.bq_ring_bytes(14) > _build.MAX_SMEM_BYTES


@pytest.mark.parametrize("source, ds, dc, match", [
    ("relin", 20, 5, "MAX_D = 24"),
    ("sindy_linesearch", 18, 7, "MAX_D = 24"),
    ("riccati_quad", 2, 2, "dc = 1"),
    ("riccati_quad", 14, 1, "ds <= 13"),
    ("riccati_general", 20, 5, "MAX_D = 24"),
])
def test_limits_raise_by_name(source, ds, dc, match):
    with pytest.raises(ValueError, match=match):
        _build.check_shape(source, ds, dc)
    with pytest.raises(ValueError, match=match):
        _build.kernel_library(source, ds, dc)


def test_shapes_within_the_limits_build_at_first_use(monkeypatch):
    """A shape the main library lacks goes to its own library, built at
    first use from the same source with the shape on the command line; a
    prebuilt shape takes the main library; per-lane coefficients take
    the same libraries (a shape's own library holds its per-lane
    instances too)."""
    built = []
    monkeypatch.setattr(_build, "library", lambda: "main")
    monkeypatch.setattr(_build, "shape_library", lambda *a: built.append(a) or "shape")
    assert _build.kernel_library("relin", 4, 1) == "main"
    assert _build.kernel_library("relin", 18, 6) == "shape"
    assert _build.kernel_library("riccati_quad_bm", 12, 1) == "main"
    assert _build.kernel_library("riccati_quad_bm", 2, 1) == "shape"
    assert _build.kernel_library("sindy_linesearch", 2, 1) == "shape"
    assert _build.kernel_library("riccati_general", 2, 1) == "shape"
    assert _build.kernel_library("riccati_general", 18, 6) == "main"
    assert built == [("relin", 18, 6), ("riccati_quad_bm", 2, 1), ("sindy_linesearch", 2, 1),
                     ("riccati_general", 2, 1)]
    assert _build.shape_library_path("relin", 18, 6).name.startswith("librelin_18x6_")
