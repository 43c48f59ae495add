"""The joint-SINDy fan-out and tune of the port against the JAX package,
float64 on the CPU, at small sizes.

(a) batched training: ``stlsq_gram`` over per-lane thresholds and
    ``fista_lasso`` over per-lane alphas against JAX's ``vmap`` of the
    same functions (1e-9); a non-positive-definite Gram gives every lane
    zero coefficients, as in JAX; a chunked run equals the unchunked one
    and a lane equals its own unbatched run;
(b) the per-lane plain twins of K1 (both entries), K7 and K3 against the
    JAX Pallas kernels in interpret mode with per-lane coefficients
    (1e-12; K3's flags exactly) at F = 15, 55 and 65 (a library past the
    shared instances' 64 terms), and, given B copies of one matrix, equal
    to the shared twins;
(c) ``JointSINDyQuadCostFanout`` against the JAX fan-out (its CPU form:
    no feature kernels, backward "scan") on the same candidates, costs to
    1e-8: the batch-major body with the feature kernels' twins, the
    lanes-last fused body, a continuous-time bucket (the autodiff
    relinearization) and ``method="lasso"``; and against a lane-by-lane
    sequential run (``SINDy.train`` + ``make_ilqr_solver``), as
    tests/test_joint_fanout.py does in JAX;
(d) ``PipelineTuner`` with kind "joint_sindy" against the JAX tuner,
    feature kernels off and on (their twins): costs to 1e-6, the same
    incumbent; a refusal by name reaches the caller of the sequential
    objective.

Both packages see the same data (JAX's draw carried across) and the
same surrogate coefficients (``SINDy.set_parameters``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch import NotPortedError
from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.control import IterativeLQRFactory as TILQRFactory
from autompc_torch.control import ilqr as tilqr
from autompc_torch.core.trajectory import TrajectoryBatch as TTB
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.costs import QuadCostFactory as TQuadFactory
from autompc_torch.ops import cuda_linesearch as TK3
from autompc_torch.ops import cuda_relin as TK1
from autompc_torch.ops import lstsq as tlstsq
from autompc_torch.parallel import JointSINDyQuadCostFanout as TJoint
from autompc_torch.pipeline import Pipeline as TPipeline
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.sysid import SINDyFactory as TSINDyFactory
from autompc_torch.sysid.basis import FeatureLibrary as TLib
from autompc_torch.tuning import PipelineTuner as TTuner
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.control import IterativeLQRFactory
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.costs import QuadCostFactory
from autompc_tpu.ops import lstsq as jlstsq
from autompc_tpu.ops.pallas_linesearch import pallas_fused_line_search, pallas_sindy_line_search
from autompc_tpu.ops.pallas_relin import pallas_feature_jacobians
from autompc_tpu.parallel.fanout import JointSINDyQuadCostFanout as JJoint
from autompc_tpu.pipeline import Pipeline
from autompc_tpu.sysid import SINDy, SINDyFactory
from autompc_tpu.sysid.basis import FeatureLibrary as JLib
from autompc_tpu.tuning import PipelineTuner

torch.set_num_threads(1)

SURR = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
            trig_interaction=True)
# Libraries by their size F on cartpole's 5 inputs: trig (15), trig +
# interaction (55, the main path's), and that with the cubic polynomial
# powers (65: past the shared instances' 64 terms, so the kernels' large
# table and trees).
LIBS = {15: dict(trig_basis=True), 55: dict(trig_basis=True, trig_interaction=True),
        65: dict(trig_basis=True, trig_interaction=True, poly_basis=True, poly_degree=3)}
ALPHAS = tuple(0.2 ** k for k in range(10))
# The kernel twins' step sizes: the Pallas kernels unroll them, so fewer
# keep interpret mode cheap.
ALPHAS_K = tuple(0.2 ** k for k in range(4))
H_FAN, STEPS_FAN = 5, 4
INIT = np.array([0.5, 0.0, 0.0, 0.0])


@pytest.fixture(scope="module")
def setup():
    """Both benchmarks, one sysid data set (JAX's draw), one surrogate,
    and a near-upright task with a quadratic task cost (a continuous
    score) in each package."""
    b, tb = CartpoleSwingupBenchmark(), TBench()
    jtr = b.gen_trajs_batch(seed=42, n_trajs=20, traj_len=30)
    ttr = TTB(tb.system, torch.as_tensor(np.array(jtr.obs)), torch.as_tensor(np.array(jtr.ctrls)))
    # The surrogate trained once (by the port) and carried across.
    tsurr = TSINDy(tb.system, device="cpu", **SURR)
    tsurr.train(ttr)
    surr = SINDy(b.system, **SURR)
    surr.set_parameters({"coeffs": tsurr.coeffs.numpy()})
    task, ttask = b.task.copy(), tb.task.copy()
    for tk, Q, eye in ((task, JQuad, jnp.eye), (ttask, TQuad, np.eye)):
        tk.set_num_steps(STEPS_FAN + 1)
        tk.set_init_obs(INIT)
    task.set_cost(JQuad(b.system, jnp.eye(4), 0.01 * jnp.eye(1), jnp.eye(4), goal=jnp.zeros(4)))
    ttask.set_cost(TQuad(tb.system, np.eye(4), 0.01 * np.eye(1), np.eye(4), goal=np.zeros(4)))
    return dict(b=b, tb=tb, jtr=jtr, ttr=ttr, surr=surr, tsurr=tsurr, task=task, ttask=ttask)


def _gram(s, lib_kw, continuous=False):
    """A SINDy bucket's staged regression (A, y, row mask) in both
    packages' arrays: the same features, targets and mask the fan-out
    stages."""
    m = TSINDy(s["tb"].system, device="cpu", method="lstsq", **lib_kw,
               time_mode="continuous" if continuous else "discrete")
    obs, ctrls = s["ttr"].obs, s["ttr"].ctrls
    A = m.library(torch.cat([obs, ctrls], -1)).reshape(-1, m.library.n_features)
    y = torch.roll(obs, -1, dims=1).reshape(-1, 4)
    mask = s["ttr"].step_mask().reshape(-1)
    return A, y, mask


# ---- (a) batched training --------------------------------------------------


@pytest.mark.parametrize("F", [15, 55])
def test_batched_stlsq_gram_matches_jax_vmap(setup, F):
    A, y, mask = _gram(setup, LIBS[F])
    G, b = tlstsq.gram_stage(A, y, mask=mask)
    thr = 10.0 ** np.random.default_rng(F).uniform(-4, -1, 9)
    got = tlstsq.stlsq_gram(G, b, torch.as_tensor(thr))
    ref = jax.vmap(lambda t: jlstsq.stlsq_gram(jnp.asarray(G.numpy()), jnp.asarray(b.numpy()),
                                               t))(jnp.asarray(thr))
    assert tuple(got.shape) == (9, F, 4)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max())
    # The thresholds give the lanes different supports.
    assert len({int((got[i] != 0).sum()) for i in range(9)}) > 1


def test_batched_stlsq_gram_indefinite_gram_gives_zero_coefficients(setup):
    """A Gram that is not positive definite: the Cholesky gives NaN, the
    support empties and every lane's coefficients are zero, in both
    packages (JAX's Cholesky NaN; the port's cholesky_ex, which never
    raises)."""
    A, y, mask = _gram(setup, LIBS[15])
    G, b = tlstsq.gram_stage(A, y, mask=mask)
    G = G.clone()
    G[0, 1] = G[1, 0] = 2.0 * torch.sqrt(G[0, 0] * G[1, 1])
    thr = np.array([1e-4, 1e-3, 1e-2])
    got = tlstsq.stlsq_gram(G, b, torch.as_tensor(thr))
    ref = jax.vmap(lambda t: jlstsq.stlsq_gram(jnp.asarray(G.numpy()), jnp.asarray(b.numpy()),
                                               t))(jnp.asarray(thr))
    np.testing.assert_array_equal(np.asarray(ref), 0.0)
    np.testing.assert_array_equal(got.numpy(), 0.0)


def test_chunked_training_equals_unchunked_and_each_lane_its_own_run(setup):
    A, y, mask = _gram(setup, LIBS[55])
    G, b = tlstsq.gram_stage(A, y, mask=mask)
    thr = torch.as_tensor(10.0 ** np.random.default_rng(1).uniform(-4, -1, 7))
    whole = tlstsq.stlsq_gram(G, b, thr)
    assert torch.equal(tlstsq.stlsq_gram(G, b, thr, lane_chunk=3), whole)
    for i in (0, 4):
        np.testing.assert_allclose(tlstsq.stlsq_gram(G, b, float(thr[i])).numpy(),
                                   whole[i].numpy(), rtol=1e-12, atol=1e-12)
    alpha = torch.as_tensor([1e-4, 1e-3, 1e-2])
    lw = tlstsq.fista_lasso(A, y, alpha, n_iters=40, mask=mask)
    assert torch.equal(tlstsq.fista_lasso(A, y, alpha, n_iters=40, mask=mask, lane_chunk=2), lw)
    # The batched product sums in another order than the one-lane one.
    np.testing.assert_allclose(tlstsq.fista_lasso(A, y, 1e-3, n_iters=40, mask=mask).numpy(),
                               lw[1].numpy(), rtol=1e-9, atol=1e-9 * float(lw.abs().max()))


def test_batched_fista_lasso_matches_jax_vmap(setup):
    A, y, mask = _gram(setup, LIBS[15])
    alpha = np.array([1e-4, 3e-3, 1e-2, 1e-1])
    got = tlstsq.fista_lasso(A, y, torch.as_tensor(alpha), n_iters=60, mask=mask)
    jA, jy, jm = (jnp.asarray(v.numpy()) for v in (A, y, mask))
    ref = np.asarray(jax.vmap(lambda a: jlstsq.fista_lasso(jA, jy, a, n_iters=60, mask=jm))(
        jnp.asarray(alpha)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max())


# ---- (b) the per-lane kernel twins -------------------------------------------


def _lane_inputs(F, B=8, H=4, seed=0):
    rng = np.random.default_rng(seed + F)
    return dict(
        C=rng.normal(size=(B, 4, F)) * 0.1 + np.eye(4, F)[None],
        x0=rng.uniform(-1, 1, (B, 4)), xs=rng.uniform(-2, 2, (B, H + 1, 4)),
        us=rng.uniform(-5, 5, (B, H, 1)), Ks=rng.normal(size=(B, H, 1, 4)) * 0.3,
        ks=rng.normal(size=(B, H, 1)),
    )


def _plane(C):
    """JAX's per-lane (B, ds, F) -> the port's lanes-last (ds, F, B)."""
    return torch.as_tensor(np.ascontiguousarray(np.transpose(C, (1, 2, 0))))


def _libs(F):
    return JLib.from_config(5, **LIBS[F]), TLib.from_config(5, **LIBS[F])


@pytest.mark.parametrize("F", sorted(LIBS))
def test_per_lane_relin_twins_match_pallas(F):
    jl, tl = _libs(F)
    assert jl.n_features == tl.n_features == F
    d = _lane_inputs(F)
    Jx, Ju = pallas_feature_jacobians(
        tuple(jl._fns), jnp.asarray(d["xs"]), jnp.asarray(d["us"]), jnp.asarray(d["C"]),
        grad_terms=tuple(jl.grad_terms), block_b=8, interpret=True)
    T = torch.as_tensor
    got = TK1.relin_jacobians_bm(tl.terms, T(d["xs"]), T(d["us"]), _plane(d["C"]))
    for g, r in zip(got, (Jx, Ju)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12)
    ll = TK1.relin_jacobians(tl.terms, T(d["xs"]).permute(1, 2, 0).contiguous(),
                             T(d["us"][:, :, 0].T.copy()), _plane(d["C"]))
    ll = ll.reshape(4, 4, 5, 8).permute(3, 0, 1, 2)
    assert torch.equal(ll[..., :4], got[0]) and torch.equal(ll[..., 4:], got[1])


@pytest.mark.parametrize("F", sorted(LIBS))
def test_per_lane_sindy_line_search_twin_matches_pallas(F):
    jl, tl = _libs(F)
    d = _lane_inputs(F, seed=1)
    keys = ("x0", "xs", "us", "Ks", "ks")
    rx, ru = pallas_sindy_line_search(
        tuple(jl._fns), *(jnp.asarray(d[k]) for k in keys), jnp.asarray(d["C"]),
        jnp.asarray(ALPHAS_K), -20.0, 20.0, block_b=8, block_l=4, interpret=True)
    gx, gu = TK3.sindy_line_search(tl.terms, *(torch.as_tensor(d[k]) for k in keys),
                                   _plane(d["C"]), ALPHAS_K, -20.0, 20.0)
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(gu.numpy(), np.asarray(ru), rtol=1e-12, atol=1e-12)


def _fused_inputs(F, seed):
    """A lanes-last carry with per-lane costs for K3 (B=8, H=4)."""
    rng = np.random.default_rng(seed + 7 * F)
    B, H = 8, 4
    obj0 = rng.uniform(2.0, 30.0, B)
    return dict(
        x0=rng.uniform(-1, 1, (4, B)), xs=rng.uniform(-1, 1, (H + 1, 4, B)),
        us=rng.uniform(-2, 2, (H, B)), Ks=rng.normal(size=(H, 4, B)) * 0.3,
        ks=rng.normal(size=(H, B)), obj0=obj0, lin=-rng.uniform(0.1, 5.0, B) * obj0 / 10,
        quad=-rng.uniform(0.1, 5.0, B), ks_small=rng.uniform(size=B) < 0.15,
        act=rng.uniform(size=B) > 0.25, old_jac=rng.normal(size=(H, 20, B)),
        qd=10 ** rng.uniform(-1, 1.5, (4, B)), rd=10 ** rng.uniform(-3, 0, (1, B)),
        fd=10 ** rng.uniform(-1, 1.5, (4, B)),
        C=rng.normal(size=(B, 4, F)) * 0.05 + np.eye(4, F)[None],
    )


def _fused_port(tl, d, coeffs):
    T = torch.as_tensor
    return TK3.fused_line_search(
        tl.terms, *(T(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")), coeffs, ALPHAS_K,
        -20.0, 20.0, T(d["qd"]), T(d["rd"]), T(d["fd"]), (0.0,) * 4, 0.05,
        *(T(d[k]) for k in ("obj0", "lin", "quad", "ks_small", "act", "old_jac")))


@pytest.mark.parametrize("F", sorted(LIBS))
def test_per_lane_fused_line_search_twin_matches_pallas(F):
    jl, tl = _libs(F)
    d = _fused_inputs(F, 3)
    ref = pallas_fused_line_search(
        tuple(jl._fns), *(jnp.asarray(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")),
        jnp.asarray(np.transpose(d["C"], (1, 2, 0))), jnp.asarray(ALPHAS_K), -20.0, 20.0,
        *(jnp.asarray(d[k]) for k in ("qd", "rd", "fd")), jnp.zeros(4), 0.05,
        *(jnp.asarray(d[k]) for k in ("obj0", "lin", "quad", "ks_small")),
        grad_terms=tuple(jl.grad_terms), block_b=8, interpret=True, ll_io=True,
        per_lane_diag_cost=True, carry=(jnp.asarray(d["act"]), jnp.asarray(d["old_jac"])))
    got = _fused_port(tl, d, _plane(d["C"]))
    for name, g, r in zip(("xs", "us", "obj", "succ", "fail", "jac", "du2"), got, ref):
        if name in ("succ", "fail"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12,
                                       err_msg=name)
    assert got[3].numpy().any()


def test_per_lane_twins_given_copies_equal_the_shared_twins():
    """B copies of one matrix through the per-lane twins give the shared
    twins' results exactly (what the kernels' per-lane instances must give
    their shared instances on the card)."""
    _, tl = _libs(55)
    d = _fused_inputs(55, 9)
    T = torch.as_tensor
    C = T(d["C"][0])
    copies = C[:, :, None].expand(-1, -1, 8).contiguous()
    for a, b in zip(_fused_port(tl, d, copies), _fused_port(tl, d, C)):
        assert torch.equal(a, b)
    xsT, usT = T(d["xs"]), T(d["us"])
    assert torch.equal(TK1.relin_jacobians(tl.terms, xsT, usT, copies),
                       TK1.relin_jacobians(tl.terms, xsT, usT, C))
    b = _lane_inputs(55, seed=4)
    args = [T(b[k]) for k in ("x0", "xs", "us", "Ks", "ks")]
    for a, c in zip(TK3.sindy_line_search(tl.terms, *args, copies, ALPHAS, -20.0, 20.0),
                    TK3.sindy_line_search(tl.terms, *args, C, ALPHAS, -20.0, 20.0)):
        assert torch.equal(a, c)
    for a, c in zip(TK1.relin_jacobians_bm(tl.terms, args[1], args[2], copies),
                    TK1.relin_jacobians_bm(tl.terms, args[1], args[2], C)):
        assert torch.equal(a, c)


# ---- (c) the fan-out -----------------------------------------------------------

FAN_CASES = {
    "batch-major": (dict(time_mode="discrete", method="lstsq"),
                    dict(backward="pallas", use_feature_kernels=True)),
    "lanes-last": (dict(time_mode="discrete", method="lstsq"),
                   dict(backward="pallas", use_feature_kernels=True, fuse_ls=True,
                        lanes_last=True, compact_schedule=((2, 0.5),))),
    "continuous": (dict(time_mode="continuous", method="lstsq"), dict(backward="scan")),
    "lasso": (dict(time_mode="discrete", method="lasso"),
              dict(backward="pallas", use_feature_kernels=True)),
}


def _candidates(method, B=6, seed=0):
    rng = np.random.default_rng(seed)
    reg = 10.0 ** rng.uniform(-4, -1 if method == "lstsq" else -2, B)
    return {"reg": reg, "Qdiag": rng.uniform(0.01, 10, (B, 4)),
            "Rdiag": rng.uniform(1e-3, 1, (B, 1)), "Fdiag": rng.uniform(0.01, 10, (B, 4))}


@pytest.fixture(scope="module")
def jax_fan_costs(setup):
    """The JAX fan-out's costs, once per bucket (its CPU form)."""
    s, out = setup, {}
    for bucket in ({"time_mode": "discrete", "method": "lstsq"},
                   {"time_mode": "continuous", "method": "lstsq"},
                   {"time_mode": "discrete", "method": "lasso"}):
        cfg = dict(LIBS[55], **bucket)
        fan = JJoint(s["b"].system, s["task"], cfg, s["jtr"].to_list(), s["surr"],
                     horizon=H_FAN, n_steps=STEPS_FAN, backward="scan",
                     use_feature_kernels=False)
        batch = _candidates(bucket["method"])
        out[tuple(sorted(bucket.items()))] = np.asarray(
            fan({k: jnp.asarray(v) for k, v in batch.items()}))
    return out


@pytest.mark.parametrize("case", sorted(FAN_CASES))
def test_fanout_matches_jax(setup, jax_fan_costs, case):
    s = setup
    bucket, kw = FAN_CASES[case]
    fan = TJoint(s["tb"].system, s["ttask"], dict(LIBS[55], **bucket), s["ttr"], s["tsurr"],
                 horizon=H_FAN, n_steps=STEPS_FAN, device="cpu", **kw)
    assert fan.n_features == 55
    assert (fan.solver_kw["feature_spec"] is not None) == ("use_feature_kernels" in kw)
    got = fan(_candidates(bucket["method"])).numpy()
    ref = jax_fan_costs[tuple(sorted(bucket.items()))]
    assert got.shape == (6,) and np.all(np.isfinite(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-8)
    assert len(set(np.round(ref, 6))) > 1      # the candidates discriminate


def test_fanout_matches_sequential_training(setup):
    """Each lane equals its own sequential pipeline: a SINDy trained with
    the lane's threshold, a single-lane iLQR solve each closed-loop step,
    the surrogate stepped, the task cost summed."""
    s = setup
    cfg = dict(LIBS[55], method="lstsq", time_mode="discrete")
    batch = _candidates("lstsq", B=3, seed=5)
    fan = TJoint(s["tb"].system, s["ttask"], cfg, s["ttr"], s["tsurr"], horizon=H_FAN,
                 n_steps=STEPS_FAN, backward="scan", device="cpu")
    got = fan(batch).numpy()
    tc = s["ttask"].get_cost()
    bounds = s["ttask"].get_ctrl_bounds()
    for i in range(3):
        m = TSINDy(s["tb"].system, device="cpu", threshold=float(batch["reg"][i]), **cfg)
        m.train(s["ttr"])
        cost = TQuad(s["tb"].system, np.diag(batch["Qdiag"][i]), np.diag(batch["Rdiag"][i]),
                     np.diag(batch["Fdiag"][i]), goal=np.zeros(4))
        solve = tilqr.make_ilqr_solver(m.pred_core, cost, H=H_FAN, ds=4, dc=1, obsdim=4,
                                       dt=s["tb"].system.dt,
                                       ubounds=(bounds[:, 0], bounds[:, 1]))
        obs, total = torch.as_tensor(INIT), 0.0
        for _ in range(STEPS_FAN):
            total += float(tc.eval_obs_cost(obs))
            u = solve(m.params, obs, obs.new_zeros((H_FAN, 1)))[2][0]
            total += float(tc.eval_ctrl_cost(u))
            obs = s["tsurr"].pred_core(s["tsurr"].params, obs, u)[:4]
        total += float(tc.eval_obs_cost(obs)) + float(tc.eval_term_obs_cost(obs))
        np.testing.assert_allclose(got[i], total, rtol=1e-8, err_msg=f"lane {i}")


def test_fanout_refuses_mesh_and_reg_matrix(setup):
    s = setup
    args = (s["tb"].system, s["ttask"], dict(LIBS[15]), s["ttr"], s["tsurr"])
    with pytest.raises(ValueError, match="mesh"):
        TJoint(*args, mesh=object(), device="cpu")
    # Built with the GaussReg term, it refuses a batch without the weights.
    fan = TJoint(s["tb"].system, s["ttask"], dict(LIBS[15], method="lstsq"), s["ttr"],
                 s["tsurr"], horizon=H_FAN, n_steps=STEPS_FAN, reg_matrix=np.eye(4),
                 device="cpu")
    with pytest.raises(ValueError, match="regw"):
        fan(_candidates("lstsq"))


# ---- (d) the tuner ---------------------------------------------------------------

# The SINDy space with the basis pinned to the 15-term trig library (the
# factory's keywords win over the configuration's values): the method,
# the time mode and the regularizers stay free, so the buckets differ in
# fit and time mode.
PIN = dict(poly_basis="false", trig_basis="true", trig_freq=1, trig_interaction="false")


def _tune(s, port, **kw):
    system = (s["tb"] if port else s["b"]).system
    if port:
        pipe = TPipeline(system, TSINDyFactory(system, device="cpu", **PIN),
                         TQuadFactory(system, goal=np.zeros(4)), TILQRFactory(system, horizon=4))
        tuner = TTuner(surrogate_mode="pretrain", eval_batch=4, use_fanout=True, **kw)
        return tuner.run(pipe, s["ttask"], s["ttr"].to_list(), n_iters=8,
                         rng=np.random.default_rng(7), surrogate=s["tsurr"])[1]
    pipe = Pipeline(system, SINDyFactory(system, **PIN), QuadCostFactory(system, goal=np.zeros(4)),
                    IterativeLQRFactory(system, horizon=4))
    tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=4, use_fanout=True,
                          fanout_backward="scan", fanout_feature_kernels=False)
    return tuner.run(pipe, s["task"], s["jtr"].to_list(), n_iters=8,
                     rng=np.random.default_rng(7), surrogate=s["surr"])[1]


@pytest.fixture(scope="module")
def jax_tune(setup):
    return _tune(setup, port=False)


@pytest.mark.parametrize("kernels", [False, True])
def test_joint_sindy_tune_matches_jax(setup, jax_tune, kernels):
    res = _tune(setup, port=True, fanout_backward="pallas" if kernels else "scan",
                fanout_feature_kernels=kernels)
    assert [c.get_dictionary() for c in res.cfgs] == \
        [c.get_dictionary() for c in jax_tune.cfgs]
    buckets = {(c["_model:method"], c["_model:time_mode"]) for c in res.cfgs}
    assert len(buckets) > 1, buckets
    np.testing.assert_allclose(res.costs, jax_tune.costs, rtol=1e-6)
    assert res.inc_cfg.get_dictionary() == jax_tune.inc_cfg.get_dictionary()


def test_a_refusal_by_name_reaches_the_sequential_objectives_caller(setup, monkeypatch):
    """The sequential objective scores a failing candidate inf, but a
    refusal by name (NotPortedError, a ValueError) reaches the caller."""
    s = setup
    system = s["tb"].system
    pipe = TPipeline(system, s["tsurr"], TQuadFactory(system, goal=np.zeros(4)),
                     TILQRFactory(system, horizon=4))
    tuner = TTuner(surrogate_mode="pretrain", eval_batch=1)
    run = dict(pipeline=pipe, task=s["ttask"], trajs=s["ttr"].to_list(), n_iters=1,
               rng=np.random.default_rng(0), surrogate=s["tsurr"])

    def failing(exc):
        def make(*a, **k):
            raise exc
        return make

    scores = []

    def hook(cfg, info):
        scores.append(info["surr_cost"])

    monkeypatch.setattr(tilqr, "make_ilqr_solver", failing(ValueError("a bad candidate")))
    with pytest.raises(Exception):       # no incumbent: the final controller fails
        tuner.run(eval_cfg_hook=hook, **run)
    assert scores == [float("inf")]
    scores.clear()
    monkeypatch.setattr(tilqr, "make_ilqr_solver", failing(tilqr._unsupported("mode x")))
    with pytest.raises(NotPortedError, match="mode x is not ported"):
        tuner.run(eval_cfg_hook=hook, **run)
    assert scores == [] and issubclass(NotPortedError, ValueError)
