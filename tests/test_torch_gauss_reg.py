"""The GaussReg and SumCost costs of the port against the JAX package,
float64 on the CPU:

(a) the cost algebra: SumCost, ``Cost.__add__``, ``CostFactory.__add__``,
    SumCostFactory and GaussRegFactory: values, gradients, hessians,
    flags, configuration-space names, the factory's Q and goal (1e-12);
(b) the tuner's GaussReg statistics (1e-12) and ``_cost_fanout_spec``'s
    layouts, with the fallback warning for one it does not cover;
(c) K3's batch-major plain twin with the GaussReg term against the
    Pallas kernel ``pallas_fused_line_search(ll_io=False, reg=...,
    per_lane_diag_cost=True, grad_terms=...)`` in interpret mode: flags
    exactly, every other output to 1e-12, shared and per-lane
    coefficients;
(d) the solver's batch-major body with ``reg_matrix``, plain and fused
    (K3's batch-major entry), against the JAX solver (1e-9 on the lanes
    converged in both), the compacted solve against the uncompacted one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.control import ilqr as tilqr
from autompc_torch.core.trajectory import TrajectoryBatch as TTB
from autompc_torch.costs import Cost as TCost
from autompc_torch.costs import GaussRegFactory as TGaussReg
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.costs import QuadCostFactory as TQuadFactory
from autompc_torch.costs import SumCost as TSum
from autompc_torch.costs import SumCostFactory as TSumFactory
from autompc_torch.ops.cuda_linesearch import fused_line_search_bm, fused_line_search_bm_plain
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.tuning import PipelineTuner as TTuner
from autompc_torch.tuning import pipeline_tuner as tpt
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.control import ilqr as jilqr
from autompc_tpu.costs import GaussRegFactory, QuadCost, QuadCostFactory, SumCost
from autompc_tpu.ops.pallas_linesearch import pallas_fused_line_search
from autompc_tpu.sysid import SINDy
from autompc_tpu.tuning import pipeline_tuner as jpt

torch.set_num_threads(1)

SINDY_KW = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
                trig_interaction=True)
TOL = 1e-12


@pytest.fixture(scope="module")
def setup():
    """Both benchmarks, one data set (JAX's draw) in both packages' types,
    both SINDy models with the JAX fit's coefficients."""
    b, tb = CartpoleSwingupBenchmark(), TBench()
    jtr = b.gen_trajs_batch(seed=42, n_trajs=30, traj_len=60)
    ttr = TTB(tb.system, torch.as_tensor(np.array(jtr.obs)), torch.as_tensor(np.array(jtr.ctrls)))
    m = SINDy(b.system, **SINDY_KW)
    m.train(jtr)
    t = TSINDy(tb.system, device="cpu", **SINDY_KW)
    t.set_parameters({**m.get_parameters(), "feature_names": m.get_feature_names()})
    return dict(b=b, tb=tb, jtr=jtr, ttr=ttr, m=m, t=t)


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol, atol=tol)


# ---- (a) the cost algebra ------------------------------------------------------


def _pair(s, seed):
    """One quadratic cost with a goal in both packages (a dense Q)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(4, 4))
    Q, F = A @ A.T, np.diag(rng.uniform(0.1, 2.0, 4))
    R, goal = np.diag(rng.uniform(0.01, 1.0, 1)), rng.normal(size=4)
    return (QuadCost(s["b"].system, jnp.asarray(Q), jnp.asarray(R), jnp.asarray(F),
                     goal=jnp.asarray(goal)),
            TQuad(s["tb"].system, Q, R, F, goal=goal))


def test_sum_cost_evaluations_and_flags_equal_jax(setup):
    s = setup
    (j1, t1), (j2, t2) = _pair(s, 0), _pair(s, 1)
    js, ts = j1 + j2, t1 + t2
    assert isinstance(ts, TSum) and isinstance(js, SumCost) and len(ts.costs) == 2
    x = np.random.default_rng(2).normal(size=(3, 4))
    u = np.random.default_rng(3).normal(size=(3, 1))
    for name, arg in (("obs", x), ("ctrl", u), ("term_obs", x)):
        for suffix in ("", "_diff", "_hess"):
            attr = f"eval_{name}_cost{suffix}"
            ref = jax.vmap(getattr(js, attr))(jnp.asarray(arg))
            got = getattr(ts, attr)(torch.as_tensor(arg))
            if suffix == "":
                ref, got = (ref,), (got,)
            for g, r in zip(got, ref):
                # A quadratic hessian is one matrix for every point.
                r = np.asarray(r)
                _close(np.broadcast_to(g.numpy(), r.shape), r)
    for flag in ("is_quad", "is_convex", "is_diff", "is_twice_diff", "has_goal"):
        assert getattr(ts, flag) == getattr(js, flag), flag
    assert not ts.is_quad and not ts.has_goal         # two goals
    # One goal: quadratic, with the summed matrices and the shared goal.
    j3, t3 = _pair(s, 4)
    t_same = t3 + TQuad(s["tb"].system, np.eye(4), np.eye(1), np.eye(4), goal=t3.get_goal())
    j_same = j3 + QuadCost(s["b"].system, jnp.eye(4), jnp.eye(1), jnp.eye(4), goal=j3._goal)
    assert t_same.is_quad and j_same.is_quad and t_same.has_goal
    for g, r in zip(t_same.get_cost_matrices(), j_same.get_cost_matrices()):
        _close(g, r)
    _close(t_same.get_goal(), j_same.get_goal())
    # The algebra keeps a flat list in order on either side.
    t4 = _pair(s, 5)[1]
    assert [c is t4 for c in (ts + t4).costs] == [False, False, True]
    assert [c is t4 for c in (t4 + ts).costs] == [True, False, False]
    assert len((ts + ts).costs) == 4
    fns = t1.stage_fns()
    _close(fns[0](torch.as_tensor(x)).numpy(), t1.eval_obs_cost(torch.as_tensor(x)).numpy())


def test_autodiff_fallback_of_a_differentiable_cost(setup):
    """A cost with only ``eval_*_cost`` and the diff flags gets its
    gradient and hessian by autodiff, as the JAX package's by jax.grad
    and jax.hessian."""
    s = setup

    class Quartic(TCost):
        def __init__(self, system):
            super().__init__(system)
            self._is_diff = self._is_twice_diff = True

        def eval_obs_cost(self, obs):
            return (obs ** 4).sum(-1) + obs[..., 0] * obs[..., 1]

        def eval_ctrl_cost(self, ctrl):
            return (ctrl ** 2).sum(-1)

        def eval_term_obs_cost(self, obs):
            return (obs ** 2).sum(-1)

    c = Quartic(s["tb"].system)
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(2, 3, 4)))
    v, g, h = c.eval_obs_cost_hess(x)
    f = lambda z: jnp.sum(z ** 4) + z[0] * z[1]
    xj = jnp.asarray(x.numpy().reshape(-1, 4))
    _close(g.numpy().reshape(-1, 4), jax.vmap(jax.grad(f))(xj))
    _close(h.numpy().reshape(-1, 4, 4), jax.vmap(jax.hessian(f))(xj))
    _close(c.eval_obs_cost_diff(x)[1].numpy(), g.numpy())
    # Summed with a quadratic cost: the closed form plus the autodiff.
    t1 = _pair(s, 0)[1]
    hs = (c + t1).eval_obs_cost_hess(x)[2]
    _close(hs.numpy(), (h + t1.eval_obs_cost_hess(x)[2]).numpy())


def test_factories_spaces_and_gauss_reg_cost_equal_jax(setup):
    s = setup
    jq, tq = QuadCostFactory(s["b"].system, goal=np.zeros(4)), \
        TQuadFactory(s["tb"].system, goal=np.zeros(4))
    jg, tg = GaussRegFactory(s["b"].system), TGaussReg(s["tb"].system)
    js, ts = jq + jg, tq + tg
    assert isinstance(ts, TSumFactory) and [type(f).__name__ for f in ts.factories] == \
        ["QuadCostFactory", "GaussRegFactory"]
    assert len((ts + tq).factories) == 3 and (tg + ts).factories[0] is tg
    jcs, tcs = js.get_configuration_space(), ts.get_configuration_space()
    assert tcs.get_hyperparameter_names() == jcs.get_hyperparameter_names()
    assert "_sum_1:reg_weight" in tcs.get_hyperparameter_names()
    hp = tg.get_configuration_space().get_hyperparameter("reg_weight")
    assert (hp.lower, hp.upper, hp.default_value, hp.log) == (1e-3, 1e4, 1.0, True)
    assert ts.is_compatible(s["tb"].system, s["tb"].task, None)
    # One sampled configuration through both.
    vals = jcs.sample_configuration(np.random.default_rng(3)).get_dictionary()
    jcfg, tcfg = jcs.configuration_from_dict(vals), tcs.configuration_from_dict(vals)
    jcost = js(jcfg, s["b"].task, s["jtr"].to_list())
    tcost = ts(tcfg, s["tb"].task, s["ttr"].to_list())
    assert [type(c).__name__ for c in tcost.costs] == ["QuadCost", "QuadCost"]
    for jc, tc in zip(jcost.costs, tcost.costs):
        for g, r in zip(tc.get_cost_matrices(), jc.get_cost_matrices()):
            _close(g, r)
        _close(tc.get_goal(), jc.get_goal())
    reg = tcost.costs[1]
    S, mu = tpt._gauss_reg_stats(s["ttr"].to_list())
    _close(reg.get_cost_matrices()[0], vals["_sum_1:reg_weight"] * S)
    _close(reg.get_goal(), mu)
    x = np.random.default_rng(9).normal(size=(5, 4))
    _close(tcost.eval_obs_cost(torch.as_tensor(x)).numpy(),
           jax.vmap(jcost.eval_obs_cost)(jnp.asarray(x)))


# ---- (b) the tuner's statistics and cost layouts --------------------------------


def test_gauss_reg_stats_equal_jax(setup):
    s = setup
    S, mu = tpt._gauss_reg_stats(s["ttr"].to_list())
    jS, jmu = jpt._gauss_reg_stats(s["jtr"].to_list())
    _close(S, jS)
    _close(mu, jmu)


def test_cost_fanout_spec_layouts_equal_jax(setup):
    s = setup
    tsys, jsys = s["tb"].system, s["b"].system
    layouts = {
        "quad": lambda q, g, sy: q(sy),
        "reg": lambda q, g, sy: g(sy),
        "quad+reg": lambda q, g, sy: q(sy) + g(sy),
        "reg+quad": lambda q, g, sy: g(sy) + q(sy),
        "reg+reg": lambda q, g, sy: g(sy) + g(sy),
        "quad+quad": lambda q, g, sy: q(sy) + q(sy),
    }
    for name, build in layouts.items():
        jspec = jpt._cost_fanout_spec(build(QuadCostFactory, GaussRegFactory, jsys))
        tspec = tpt._cost_fanout_spec(build(TQuadFactory, TGaussReg, tsys))
        if jspec is None:
            assert tspec is None, name
            continue
        for key in ("quad_prefix", "reg_prefix"):
            assert tspec[key] == jspec[key], (name, key)
        assert (tspec["quad_factory"] is None) == (jspec["quad_factory"] is None), name
    assert tpt._cost_fanout_spec(object()) is None
    # A layout outside the spec falls back to the sequential objective,
    # with a warning that says why.
    from autompc_torch.control import IterativeLQRFactory as TILQRFactory
    from autompc_torch.pipeline import Pipeline as TPipeline

    pipe = TPipeline(tsys, s["t"], TQuadFactory(tsys, goal=np.zeros(4))
                     + TQuadFactory(tsys, goal=np.zeros(4)), TILQRFactory(tsys, horizon=5))
    tuner = TTuner(surrogate_mode="pretrain", eval_batch=1, use_fanout=True)
    kind, why = tuner._fanout_kind(pipe, s["t"])
    assert kind is None and "QuadCostFactory" in why
    reg_pipe = TPipeline(tsys, s["t"], TGaussReg(tsys), TILQRFactory(tsys, horizon=5))
    assert tuner._fanout_kind(reg_pipe, s["t"]) == ("ilqr", "")
    task = s["tb"].task.copy()
    task.set_num_steps(3)
    with pytest.warns(UserWarning, match="no fan-out fast path"):
        tuner.run(pipe, task, s["ttr"].to_list(), n_iters=1, rng=np.random.default_rng(0),
                  surrogate=s["t"])


# ---- (c) K3's batch-major twin with the GaussReg term ---------------------------

ALPHAS_K = tuple(0.2 ** k for k in range(5))


def _k3_inputs(seed, B=4, H=7, ds=4):
    rng = np.random.default_rng(seed)
    obj0 = rng.uniform(2.0, 30.0, B)
    A = rng.normal(size=(ds, ds))
    return dict(
        x0=rng.uniform(-1, 1, (B, ds)), xs=rng.uniform(-1, 1, (B, H + 1, ds)),
        us=rng.uniform(-2, 2, (B, H, 1)), Ks=rng.normal(size=(B, H, 1, ds)) * 0.3,
        ks=rng.normal(size=(B, H, 1)), obj0=obj0, lin=-rng.uniform(0.1, 5.0, B) * obj0 / 10,
        quad=-rng.uniform(0.1, 5.0, B), ks_small=np.array([False, True, False, False]),
        qd=rng.uniform(0.1, 10, (B, ds)), rd=rng.uniform(1e-3, 1, (B, 1)),
        fd=rng.uniform(0.1, 10, (B, ds)), goal=rng.normal(0, 0.1, ds),
        S=A @ A.T + ds * np.eye(ds), mu=rng.normal(0, 0.2, ds),
        w=10.0 ** rng.uniform(-3, 1, B),
    )


@pytest.mark.parametrize("coef", ["shared", "per-lane"])
def test_batch_major_fused_twin_with_reg_matches_pallas(setup, coef):
    s, d = setup, _k3_inputs(0 if coef == "shared" else 1)
    m, t = s["m"], s["t"]
    B = d["x0"].shape[0]
    if coef == "shared":
        active = tuple(int(k) for k in np.flatnonzero(np.any(np.asarray(m.coeffs) != 0, 0)))
        jc = m.coeffs[:, jnp.asarray(active)]
        tc = t.coeffs[:, list(active)]
    else:
        # Every lane its own model over the whole of the 15-term trig
        # library (the interpret-mode kernel unrolls every term).
        m = SINDy(s["b"].system, method="lstsq", trig_basis=True)
        t = TSINDy(s["tb"].system, "lstsq", device="cpu", trig_basis=True)
        active = tuple(range(m.library.n_features))
        C = np.random.default_rng(5).normal(0, 0.1, (B, 4, len(active)))
        C[:, :, :4] += np.eye(4)
        jc, tc = jnp.asarray(C), torch.as_tensor(C).permute(1, 2, 0).contiguous()
    J = jnp.asarray
    ref = pallas_fused_line_search(
        tuple(m.library._fns[k] for k in active), *(J(d[k]) for k in ("x0", "xs", "us", "Ks",
                                                                       "ks")),
        jc, J(ALPHAS_K), -20.0, 20.0, J(d["qd"]), J(d["rd"]), J(d["fd"]), J(d["goal"]), 0.05,
        *(J(d[k]) for k in ("obj0", "lin", "quad", "ks_small")),
        grad_terms=tuple(m.library.grad_terms[k] for k in active), block_b=B, interpret=True,
        ll_io=False, per_lane_diag_cost=True, reg=(J(d["S"]), J(d["mu"]), J(d["w"])),
    )
    T = torch.as_tensor
    args = (tuple(t.library.terms[k] for k in active),
            *(T(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")), tc, ALPHAS_K, -20.0, 20.0,
            T(d["qd"]).T.contiguous(), T(d["rd"]).T.contiguous(), T(d["fd"]).T.contiguous(),
            tuple(d["goal"]), 0.05, *(T(d[k]) for k in ("obj0", "lin", "quad", "ks_small")))
    got = fused_line_search_bm(*args, reg=(d["S"], d["mu"], T(d["w"])))
    names = ("xs", "us", "obj", "succ", "fail", "Jx", "Ju")
    for name, g, r in zip(names, got, ref):
        if name in ("succ", "fail"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        else:
            _close(g.numpy(), r)
    assert got[3].numpy().any() and (~got[3].numpy()).any()
    # du2 is the convergence norm's square of the chosen controls.
    _close(got[7].numpy(), ((got[1] - T(d["us"])) ** 2).sum((1, 2)).numpy())
    # A zero weight is the no-reg search to the bit; a positive one moves it.
    zero = fused_line_search_bm_plain(*args, reg=(d["S"], d["mu"], T(np.zeros(B))))
    for a, b_ in zip(zero, fused_line_search_bm_plain(*args)):
        assert torch.equal(a, b_)
    assert not torch.equal(got[2], zero[2])


def test_batch_major_fused_twin_refuses_what_the_kernel_does_not_take(setup):
    s, d = setup, _k3_inputs(2)
    t = s["t"]
    T = torch.as_tensor
    terms = tuple(t.library.terms)
    base = [terms, *(T(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")), t.coeffs, ALPHAS_K,
            -20.0, 20.0, T(d["qd"]).T.contiguous(), T(d["rd"]).T.contiguous(),
            T(d["fd"]).T.contiguous(), tuple(d["goal"]), 0.05,
            *(T(d[k]) for k in ("obj0", "lin", "quad", "ks_small"))]
    fixed = list(base)
    fixed[10:13] = tuple(d["qd"][0]), tuple(d["rd"][0]), tuple(d["fd"][0])
    with pytest.raises(ValueError, match="per-lane cost planes"):
        fused_line_search_bm(*fixed)
    with pytest.raises(ValueError, match="reg"):
        fused_line_search_bm(*base, reg=(np.eye(3), d["mu"], T(d["w"])))
    # Per-lane coefficients past the per-lane instances' 2,048 terms (past
    # the shared instances' 64 they run: tests/test_torch_solver_options.py).
    big = TSINDy(s["tb"].system, "lstsq", device="cpu", trig_basis=True, trig_freq=2,
                 trig_interaction=True).library
    huge = tuple(big.terms) * 20
    plane = torch.zeros((4, len(huge), 4), dtype=torch.float64)
    lane = list(base)
    lane[0], lane[6] = huge, plane
    with pytest.raises(ValueError, match="terms"):
        fused_line_search_bm(*lane)


# ---- (d) the solver's batch-major body with reg_matrix ----------------------------

B_S, H_S = 8, 6


@pytest.fixture(scope="module")
def reg_problem(setup):
    s = setup
    rng = np.random.default_rng(0)
    S, mu = jpt._gauss_reg_stats(s["jtr"].to_list())
    cp = dict(Qdiag=10 ** rng.uniform(-1, 1.5, (B_S, 4)), Rdiag=10 ** rng.uniform(-3, 0, (B_S, 1)),
              Fdiag=10 ** rng.uniform(-1, 1.5, (B_S, 4)), regw=10 ** rng.uniform(-3, 1, B_S))
    bounds = s["b"].task.get_ctrl_bounds()
    common = dict(H=H_S, ds=4, dc=1, obsdim=4, dt=s["b"].system.dt,
                  ubounds=(bounds[:, 0], bounds[:, 1]), max_iter=15, ls_max_iter=5,
                  quad_cost_batch=True,
                  quad_goal=np.zeros(4), reg_matrix=S, reg_goal=mu, backward="pallas")
    x0 = rng.uniform(-0.5, 0.5, (B_S, 4))
    return dict(cp=cp, common=common, x0=x0, ug=np.zeros((B_S, H_S, 1)))


def _t_solve(s, p, make=tilqr.make_batched_ilqr_solver, cp=None, **kw):
    t = s["t"]
    solve = make(t.pred_core, None, feature_spec=(t.library, "coeffs"), **p["common"], **kw)
    T = torch.as_tensor
    return solve(t.params, T(p["x0"]), T(p["ug"]), {k: T(v) for k, v in (cp or p["cp"]).items()})


@pytest.mark.parametrize("body", ["plain", "fused"])
def test_batch_major_bodies_with_reg_match_jax(setup, reg_problem, body):
    s, p = setup, reg_problem
    m = s["m"]
    jkw = dict(p["common"], pallas_interpret=True)
    if body == "fused":
        jkw.update(feature_spec=(m.library, "coeffs"), fuse_ls=True)
    jsolve = jax.jit(jilqr.make_batched_ilqr_solver(m.pred_core, None, **jkw))
    ref = jsolve(m.params, jnp.asarray(p["x0"]), jnp.asarray(p["ug"]),
                 {k: jnp.asarray(v) for k, v in p["cp"].items()})
    got = _t_solve(s, p, fuse_ls=body == "fused")
    both = np.asarray(ref[0]) & got[0].numpy()
    assert both.sum() >= B_S - 1
    for i, name in zip((1, 2, 3, 4), ("xs", "us", "Ks", "ks")):
        np.testing.assert_allclose(got[i].numpy()[both], np.asarray(ref[i])[both], rtol=1e-9,
                                   atol=1e-9, err_msg=name)


def test_reg_solves_compacted_fused_and_per_lane(setup, reg_problem):
    """The compacted solve equals the uncompacted one (the weights ride
    the compaction's gather); the fused body equals the plain one; with
    one model a lane (B copies of the model) the fused per-lane search
    equals the shared one; a zero weight is the solve without the term."""
    s, p = setup, reg_problem
    ref = _t_solve(s, p, fuse_ls=True)
    sched = _t_solve(s, p, make=tilqr.make_scheduled_ilqr_solver, fuse_ls=True,
                     schedule=((2, 0.5), (4, 0.25)))
    for a, b_ in zip(sched, ref):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-12, atol=1e-12)
    t = s["t"]
    def lane_pred(prm, x, u):
        return torch.einsum("bf,bnf->bn", t.library(torch.cat([x, u], -1)), prm["coeffs"])

    lane_fused = tilqr.make_batched_ilqr_solver(
        lane_pred, None, feature_spec=(t.library, "coeffs"), batch_params=True, fuse_ls=True,
        **p["common"])
    T = torch.as_tensor
    C = t.coeffs[None].expand(B_S, -1, -1).contiguous()
    got = lane_fused({"coeffs": C}, T(p["x0"]), T(p["ug"]), {k: T(v) for k, v in p["cp"].items()})
    for a, b_ in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-12, atol=1e-12)
    no_reg = dict(p["common"], reg_matrix=None, reg_goal=None)
    q = dict(p, common=no_reg)
    cp0 = dict(p["cp"], regw=np.zeros(B_S))
    with_zero = _t_solve(s, p, cp=cp0, fuse_ls=True)
    without = _t_solve(s, q, fuse_ls=True)
    for a, b_ in zip(with_zero, without):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kwargs, match", [
    (dict(quad_cost_batch=False), "quad_cost_batch"),
    (dict(lanes_last=True, fuse_ls=True), "lanes_last"),
])
def test_reg_matrix_refusals_as_in_jax(setup, reg_problem, kwargs, match):
    s, p = setup, reg_problem
    t = s["t"]
    kw = dict(p["common"], feature_spec=(t.library, "coeffs"), **kwargs)
    for pkg, pred in ((tilqr, t.pred_core), (jilqr, s["m"].pred_core)):
        with pytest.raises(ValueError, match=match):
            pkg.make_batched_ilqr_solver(pred, None, **kw)
    solve = tilqr.make_batched_ilqr_solver(t.pred_core, None,
                                           feature_spec=(t.library, "coeffs"), **p["common"])
    cp = {k: torch.as_tensor(v) for k, v in p["cp"].items() if k != "regw"}
    with pytest.raises(ValueError, match="regw"):
        solve(t.params, torch.as_tensor(p["x0"]), torch.as_tensor(p["ug"]), cp)



def test_fused_batch_major_body_refuses_a_non_diagonal_fixed_cost(setup):
    """A fixed cost with an off-diagonal Q on the fused batch-major body,
    once refused, now takes K3's dense form (the JAX kernel's
    per_lane_diag_cost=False; against the JAX kernel in
    tests/test_torch_solver_options.py): the solve equals the unfused
    body's (K7, the acceptance rule in tensor ops, K1) to 1e-9."""
    s = setup
    t = s["t"]
    Q = np.eye(4) + 0.1 * np.ones((4, 4))
    cost = TQuad(s["tb"].system, Q, 0.01 * np.eye(1), Q)
    kw = dict(H=4, ds=4, dc=1, obsdim=4, dt=0.05, feature_spec=(t.library, "coeffs"),
              ubounds=(-np.ones(1), np.ones(1)), max_iter=6)
    x0 = torch.as_tensor(np.random.default_rng(3).uniform(-0.5, 0.5, (5, 4)))
    ug = torch.zeros((5, 4, 1), dtype=torch.float64)
    outs = [tilqr.make_batched_ilqr_solver(t.pred_core, cost, fuse_ls=f, **kw)(t.params, x0, ug)
            for f in (True, False)]
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][0].any()
    for a, b in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-9)
