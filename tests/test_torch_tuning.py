"""The tuner of the port against the JAX package, float64 on the CPU.

(a) configuration spaces: the same defaults, samples, encodings and
    joint Pipeline space for the same numpy seed, exactly;
(b) the native random forest (and the Python one): the same predictions,
    exactly;
(c) BatchBayesOpt: three ask/tell rounds ask the same configurations;
(d) QuadCostFactory: the same matrices and goal;
(e) make_ilqr_solver on the cartpole SINDy at H=20 from 3 starts (rel
    1e-9), IterativeLQR + simulate for 20 steps on the true dynamics
    (rel 1e-8);
(f) PipelineTuner.run with a fixed model through the fan-out, port
    against JAX: the same configurations, costs and true-dynamics costs
    (rel 1e-6); the port's sequential tuner against its fan-out tuner;
(g) a resumed run gives the uninterrupted run's history;
(h) every refused kind, mode and option raises by name (the surrogate
    modes "autotune" and "autoselect" run: tests/test_torch_model_tuner.py
    holds them against the JAX package).

The SINDy models of both packages carry the same coefficients
(``SINDy.set_parameters``). The JAX fan-out runs its CPU-safe form
(backward "scan", no feature kernels), the port's its feature kernels'
plain versions (K1's batch-major entry, K7) with the plain Riccati
recursion in (f), where 8 closed loops of 39 steps run, and with K6's
plain version in (g): the same algorithm.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.config import ConfigurationSpace as TSpace
from autompc_torch.control import ControllerFactory as TControllerFactory
from autompc_torch.control import IterativeLQR as TILQR
from autompc_torch.control import IterativeLQRFactory as TILQRFactory
from autompc_torch.control import make_ilqr_solver as t_make_ilqr_solver
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.costs import QuadCostFactory as TQuadFactory
from autompc_torch.costs import ThresholdCost as TThreshold
from autompc_torch.native import NativeRandomForest as TNative
from autompc_torch.native import library_path as t_rf_library
from autompc_torch.native import make_forest as t_make_forest
from autompc_torch.pipeline import Pipeline as TPipeline
from autompc_torch.sysid import ModelFactory as TModelFactory
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.sysid import SINDyFactory as TSINDyFactory
from autompc_torch.tuning import BatchBayesOpt as TBO
from autompc_torch.tuning import PipelineTuner as TTuner
from autompc_torch.tuning import RandomForestSurrogate as TPyForest
from autompc_torch.tuning import pipeline_tuner
from autompc_torch.utils import simulate as t_simulate
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.control import IterativeLQR, IterativeLQRFactory
from autompc_tpu.control.ilqr import make_ilqr_solver
from autompc_tpu.costs import QuadCost, QuadCostFactory, ThresholdCost
from autompc_tpu.native import make_forest
from autompc_tpu.pipeline import Pipeline
from autompc_tpu.sysid import SINDy, SINDyFactory
from autompc_tpu.tuning import BatchBayesOpt, PipelineTuner, RandomForestSurrogate
from autompc_tpu.utils import simulate

torch.set_num_threads(1)

SINDY_KW = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
                trig_interaction=True)
QD = np.array([10.0, 0.1, 0.01, 0.01])


@pytest.fixture(scope="module", autouse=True)
def native_forests():
    """Both packages' native forests loaded. The JAX package builds its
    library next to its sources with g++ straight into the final name, so
    a process that loaded it while another test process was still
    writing it has marked it unavailable for good: let it load again."""
    import autompc_tpu.native as jax_native

    if not jax_native.NativeRandomForest.available():
        jax_native._build_failed = False
    assert jax_native.NativeRandomForest.available() and TNative.available()


@pytest.fixture(scope="module")
def setup():
    """Both packages' cartpole benchmark and SINDy with one set of
    coefficients (the JAX fit), and the port's training set."""
    b, tb = CartpoleSwingupBenchmark(), TBench()
    m = SINDy(b.system, **SINDY_KW)
    m.train(b.gen_trajs_batch(seed=42, n_trajs=60, traj_len=80))
    t = TSINDy(tb.system, device="cpu", **SINDY_KW)
    t.set_parameters({**m.get_parameters(), "feature_names": m.get_feature_names()})
    ttrajs = tb.gen_trajs(seed=1, n_trajs=4, traj_len=10, device="cpu")
    return dict(b=b, tb=tb, m=m, t=t, ttrajs=ttrajs)


def _near_upright(bench, cost_cls, num_steps):
    """tests/test_parallel.py's task: score the pole dimensions only and
    start near upright, so that the scores discriminate."""
    task = bench.task.copy()
    task.set_cost(cost_cls(bench.system, goal=np.zeros(4), threshold=0.2, obs_range=(0, 2)))
    task.set_init_obs(np.array([0.5, 0.0, 0.0, 0.0]))
    task.set_num_steps(num_steps)
    return task


def _pipelines(s, horizon=None, model_factory=False):
    """The same pipeline in both packages: the fixed SINDy (or a SINDy
    factory), QuadCostFactory with a zero goal, IterativeLQRFactory."""
    kw = {} if horizon is None else {"horizon": horizon}
    jm = SINDyFactory(s["b"].system) if model_factory else s["m"]
    tm = TSINDyFactory(s["tb"].system, device="cpu") if model_factory else s["t"]
    return (
        Pipeline(s["b"].system, jm, QuadCostFactory(s["b"].system, goal=np.zeros(4)),
                 IterativeLQRFactory(s["b"].system, **kw)),
        TPipeline(s["tb"].system, tm, TQuadFactory(s["tb"].system, goal=np.zeros(4)),
                  TILQRFactory(s["tb"].system, **kw)),
    )


def _dicts(cfgs):
    return [c.get_dictionary() for c in cfgs]


# ---- (a) configuration spaces --------------------------------------------


def test_joint_space_defaults_samples_and_encodings_equal_jax(setup):
    jp, tp = _pipelines(setup, model_factory=True)
    js, ts = jp.get_configuration_space(), tp.get_configuration_space()
    assert isinstance(ts, TSpace)
    assert [h.name for h in ts.get_hyperparameters()] == \
        [h.name for h in js.get_hyperparameters()]
    assert ts.get_default_configuration().get_dictionary() == \
        js.get_default_configuration().get_dictionary()
    jc = js.sample_configuration(np.random.default_rng(7), size=40)
    tc = ts.sample_configuration(np.random.default_rng(7), size=40)
    assert _dicts(tc) == _dicts(jc)
    np.testing.assert_array_equal(ts.encode_batch(tc), js.encode_batch(jc))
    assert _dicts([ts.decode(ts.encode(c)) for c in tc]) == \
        _dicts([js.decode(js.encode(c)) for c in jc])


def test_factory_spaces_equal_jax(setup):
    b, tb = setup["b"], setup["tb"]
    goal = np.array([0.0, np.nan, 0.0, 0.0])
    for jf, tf in ((SINDyFactory(b.system), TSINDyFactory(tb.system)),
                   (QuadCostFactory(b.system, goal=goal), TQuadFactory(tb.system, goal=goal)),
                   (IterativeLQRFactory(b.system), TILQRFactory(tb.system))):
        js, ts = jf.get_configuration_space(), tf.get_configuration_space()
        assert str(ts) == str(js)
        assert _dicts(ts.sample_configuration(np.random.default_rng(3), size=10)) == \
            _dicts(js.sample_configuration(np.random.default_rng(3), size=10))


# ---- (b) forests ------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_forest_predictions_equal_jax(native):
    rng = np.random.default_rng(0)
    X, Xq = rng.uniform(0, 1, (60, 7)), rng.uniform(0, 1, (30, 7))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.05 * rng.normal(size=60)
    if native:
        jf = make_forest(rng=np.random.default_rng(5))
        tf = t_make_forest(rng=np.random.default_rng(5))
        assert isinstance(tf, TNative)
    else:
        jf = RandomForestSurrogate(rng=np.random.default_rng(5))
        tf = TPyForest(rng=np.random.default_rng(5))
    jmu, jsd = jf.fit(X, y).predict(Xq)
    tmu, tsd = tf.fit(X, y).predict(Xq)
    np.testing.assert_array_equal(tmu, jmu)
    np.testing.assert_array_equal(tsd, jsd)


def test_native_forest_builds_into_the_port_build_directory():
    assert TNative.available()
    path = t_rf_library()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "autompc_torch"


# ---- (c) BatchBayesOpt ------------------------------------------------------


def test_batch_bo_asks_the_same_configurations(setup):
    """Three rounds of 4: the default and the initial design, then a
    forest-guided round with fantasized picks; one inf cost."""
    jp, tp = _pipelines(setup, model_factory=True)
    jbo = BatchBayesOpt(jp.get_configuration_space(), rng=np.random.default_rng(9),
                        batch_size=4, n_candidates=200)
    tbo = TBO(tp.get_configuration_space(), rng=np.random.default_rng(9), batch_size=4,
              n_candidates=200)
    for r in range(3):
        jb, tb_ = jbo.ask(), tbo.ask()
        assert _dicts(tb_) == _dicts(jb), r
        x = jbo.space.encode_batch(jb)
        costs = list(((x - 0.3) ** 2).sum(1))
        if r == 0:
            costs[2] = float("inf")
        jbo.tell(jb, costs)
        tbo.tell(tb_, costs)
    assert tbo.incumbent[1] == jbo.incumbent[1]


# ---- (d) QuadCostFactory ----------------------------------------------------


@pytest.mark.parametrize("goal", [None, [0.1, np.nan, 0.0, -0.2]], ids=["task_goal", "nan_goal"])
def test_quad_cost_factory_matrices_equal_jax(setup, goal):
    b, tb = setup["b"], setup["tb"]
    jf, tf = QuadCostFactory(b.system, goal=goal), TQuadFactory(tb.system, goal=goal)
    jtask, ttask = b.task.copy(), tb.task.copy()
    jtask.set_cost(QuadCost(b.system, np.eye(4), np.eye(1), goal=[0.3, 0, 0, 0]))
    ttask.set_cost(TQuad(tb.system, np.eye(4), np.eye(1), goal=[0.3, 0, 0, 0]))
    for cfg in tf.get_configuration_space().sample_configuration(np.random.default_rng(2),
                                                                 size=3):
        jc, tc = jf(cfg, jtask, None), tf(cfg, ttask, None)
        for a, c in zip(tc.get_cost_matrices(), jc.get_cost_matrices()):
            np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(tc.get_goal(), jc.get_goal())


# ---- (e) the single-lane solver, IterativeLQR and simulate -----------------


def test_single_lane_solver_matches_jax(setup):
    b, tb, m, t = setup["b"], setup["tb"], setup["m"], setup["t"]
    bounds = b.task.get_ctrl_bounds()
    common = dict(H=20, ds=4, dc=1, obsdim=4, dt=b.system.dt,
                  ubounds=(bounds[:, 0], bounds[:, 1]))
    jsolve = make_ilqr_solver(m.pred_core, QuadCost(b.system, np.diag(QD), 1e-3 * np.eye(1),
                                                    np.diag(QD)), **common)
    tsolve = t_make_ilqr_solver(t.pred_core, TQuad(tb.system, np.diag(QD), 1e-3 * np.eye(1),
                                                   np.diag(QD)), **common)
    import jax

    jsolve = jax.jit(jsolve)
    for x0 in ([3.1, 0.0, 0.0, 0.0], [0.6, -0.4, 0.2, 0.1], [-1.2, 0.3, -0.5, 0.0]):
        ref = jsolve(m.params, jnp.asarray(x0), jnp.zeros((20, 1)))
        got = tsolve(t.params, torch.tensor(x0, dtype=torch.float64),
                     torch.zeros((20, 1), dtype=torch.float64))
        assert bool(got[0]) == bool(ref[0])
        for g, r in zip(got[1:], ref[1:]):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-9,
                                       atol=1e-9 * max(1.0, np.abs(r).max()))


def test_iterative_lqr_simulate_matches_jax(setup):
    """20 closed-loop steps on the true dynamics, the task's own
    termination condition checked after every step."""
    b, tb, m, t = setup["b"], setup["tb"], setup["m"], setup["t"]
    jtask, ttask = b.task.copy(), tb.task.copy()
    jtask.set_cost(QuadCost(b.system, np.diag(QD), 1e-3 * np.eye(1), np.diag(QD)))
    ttask.set_cost(TQuad(tb.system, np.diag(QD), 1e-3 * np.eye(1), np.diag(QD)))
    jc, tc = IterativeLQR(b.system, jtask, m, horizon=20), TILQR(tb.system, ttask, t, horizon=20)
    init = np.array([2.5, 0.0, 0.0, 0.0])
    jtraj = simulate(jc, init, jtask.term_cond, dynamics=b.dynamics, max_steps=20)
    ttraj = t_simulate(tc, init, ttask.term_cond, dynamics=tb.dynamics, max_steps=20)
    assert len(ttraj) == len(jtraj) == 21
    np.testing.assert_allclose(ttraj.obs.numpy(), np.asarray(jtraj.obs), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(ttraj.ctrls.numpy(), np.asarray(jtraj.ctrls), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(jtraj.ctrls)).max())
    assert float(ttask.get_cost()(ttraj)) == pytest.approx(float(jtask.get_cost()(jtraj)),
                                                           rel=1e-8)


# ---- (f) the tuner ----------------------------------------------------------


def test_fanout_tune_matches_jax(setup):
    """pretrain, use_fanout, eval_batch 4, 8 candidates, 40-step task,
    true dynamics given (a second fan-out), one horizon bucket."""
    s = setup
    jp, tp = _pipelines(s, horizon=10)
    jtask, ttask = _near_upright(s["b"], ThresholdCost, 40), _near_upright(s["tb"], TThreshold, 40)
    _, jres = PipelineTuner(surrogate_mode="pretrain", eval_batch=4, use_fanout=True).run(
        jp, jtask, s["ttrajs"], n_iters=8, rng=np.random.default_rng(3), surrogate=s["m"],
        truedyn=s["b"].dynamics)
    tctrl, tres = TTuner(surrogate_mode="pretrain", eval_batch=4, use_fanout=True,
                         fanout_backward="scan", fanout_feature_kernels=True).run(
        tp, ttask, s["ttrajs"], n_iters=8, rng=np.random.default_rng(3), surrogate=s["t"],
        truedyn=s["tb"].dynamics)
    assert _dicts(tres.cfgs) == _dicts(jres.cfgs)
    for got, ref in ((tres.costs, jres.costs), (tres.truedyn_costs, jres.truedyn_costs)):
        assert len(got) == len(ref) == 8
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert len(set(tres.costs)) > 1, tres.costs     # the scores discriminate
    assert tres.inc_costs == jres.inc_costs
    assert tres.inc_cfg.get_dictionary() == jres.inc_cfg.get_dictionary()
    assert isinstance(tctrl, TILQR) and tctrl.horizon == 10


def test_sequential_tune_matches_fanout_tune(setup):
    """The port's twin of tests/test_tuning.py's
    test_fanout_matches_sequential: horizons unpinned (several buckets),
    the same seed asks the same configurations, and simulate-based
    scores equal the fan-out's."""
    s = setup
    _, tp = _pipelines(s)
    task = _near_upright(s["tb"], TThreshold, 40)
    runs = [
        TTuner(surrogate_mode="pretrain", eval_batch=4, **kw).run(
            tp, task, s["ttrajs"], n_iters=4, rng=np.random.default_rng(3),
            surrogate=s["t"])[1]
        for kw in ({}, dict(use_fanout=True, fanout_backward="scan",
                            fanout_feature_kernels=True))
    ]
    seq, fan = runs
    assert _dicts(seq.cfgs) == _dicts(fan.cfgs)
    assert len({c["_ctrlr:horizon"] for c in seq.cfgs}) > 1
    assert all(t_ is not None for t_ in seq.surr_trajs) and fan.surr_trajs == [None] * 4
    np.testing.assert_allclose(fan.costs, seq.costs, rtol=1e-6)


def test_sequential_joint_sindy_tune_runs(setup):
    """examples/5_tuning.py's path: a SINDy surrogate from its default
    configuration, a SINDy model trained for each candidate, each
    simulated on the surrogate and on the true dynamics."""
    s = setup
    _, tp = _pipelines(s, horizon=5, model_factory=True)
    trajs = s["tb"].gen_trajs(seed=2, n_trajs=20, traj_len=30, device="cpu")
    tuner = TTuner(surrogate_mode="defaultcfg", surrogate_split=0.5, eval_batch=2,
                   surrogate_factory=TSINDyFactory(s["tb"].system, device="cpu"))
    ctrl, res = tuner.run(tp, _near_upright(s["tb"], TThreshold, 8), trajs, n_iters=2,
                          rng=np.random.default_rng(0), truedyn=s["tb"].dynamics)
    assert len(res.costs) == len(res.truedyn_costs) == 2
    assert all(np.isfinite(res.costs)) and all(0 <= c <= 8 for c in res.truedyn_costs)
    assert isinstance(ctrl, TILQR) and isinstance(ctrl.model, TSINDy)


def test_lasso_sindy_matches_jax(setup):
    b, tb = setup["b"], setup["tb"]
    jtr = b.gen_trajs_batch(seed=4, n_trajs=10, traj_len=30)
    ttr = tb.gen_trajs_batch(seed=0, n_trajs=10, traj_len=30, device="cpu")
    ttr.obs, ttr.ctrls = (torch.as_tensor(np.asarray(a)) for a in (jtr.obs, jtr.ctrls))
    cfg = dict(method="lasso", lasso_alpha=1e-3, trig_basis="true", trig_freq=1,
               time_mode="continuous")
    j = SINDy(b.system, **cfg)
    j.train(jtr)
    t = TSINDy(tb.system, device="cpu", **cfg)
    t.train(ttr)
    ref = np.asarray(j.coeffs)
    np.testing.assert_allclose(t.coeffs.numpy(), ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max())


# ---- (g) checkpoint resume ------------------------------------------------


def test_resumed_tune_gives_the_uninterrupted_history(setup, tmp_path):
    s = setup
    _, tp = _pipelines(s, horizon=5)
    task = _near_upright(s["tb"], TThreshold, 10)
    tuner = TTuner(surrogate_mode="pretrain", eval_batch=4, use_fanout=True,
                   fanout_backward="pallas", fanout_feature_kernels=True)
    run = dict(pipeline=tp, task=task, trajs=s["ttrajs"], surrogate=s["t"])
    _, full = tuner.run(n_iters=12, rng=np.random.default_rng(4), **run)
    path = str(tmp_path / "tune.ckpt")
    rng = np.random.default_rng(4)
    _, first = tuner.run(n_iters=4, rng=rng, checkpoint_path=path, **run)
    assert os.path.exists(path)
    _, resumed = tuner.run(n_iters=12, rng=rng, checkpoint_path=path, **run)
    assert first.costs == full.costs[:4]
    assert _dicts(resumed.cfgs) == _dicts(full.cfgs)
    assert resumed.costs == full.costs and resumed.inc_costs == full.inc_costs


# ---- (h) what raises by name ----------------------------------------------


def _named(base, name):
    return type(name, (base,), {"get_configuration_space": lambda self: TSpace()})


@pytest.mark.parametrize("model_factory, controller_factory, kind", [
    (None, "MPPIFactory", "mppi"),
    (None, "DirectTranscriptionControllerFactory", "dt"),
    ("SINDyFactory", "IterativeLQRFactory", "joint_sindy"),
    ("ARXFactory", "IterativeLQRFactory", "joint_arx"),
    ("MLPFactory", "IterativeLQRFactory", "joint_mlp"),
    ("KoopmanFactory", "IterativeLQRFactory", "joint_koopman"),
    ("ApproximateGPModelFactory", "IterativeLQRFactory", "joint_gp"),
])
def test_unported_fanout_kinds_raise(setup, model_factory, controller_factory, kind):
    s = setup
    system = s["tb"].system
    model = s["t"] if model_factory is None else (
        TSINDyFactory(system, device="cpu") if model_factory == "SINDyFactory"
        else _named(TModelFactory, model_factory)(system))
    cf = (TILQRFactory(system) if controller_factory == "IterativeLQRFactory"
          else _named(TControllerFactory, controller_factory)(system))
    pipe = TPipeline(system, model, TQuadFactory(system, goal=np.zeros(4)), cf)
    tuner = TTuner(surrogate_mode="pretrain", use_fanout=True)
    if kind in ("mppi", "dt", "joint_mlp", "joint_sindy", "joint_arx", "joint_koopman",
                "joint_gp"):
        # Ported: the tuner selects the kind and does not refuse it
        # (tests/test_torch_controller_tune.py, tests/test_torch_joint_mlp.py,
        # tests/test_torch_joint_sindy.py, tests/test_torch_joint_koopman.py
        # and tests/test_torch_joint_gp.py run them).
        assert tuner._fanout_kind(pipe, s["t"]) == (kind, "")
        assert kind in pipeline_tuner._PORTED_KINDS
        return
    with pytest.raises(ValueError, match=f"'{kind}' fan-out"):
        tuner.run(pipe, s["tb"].task, s["ttrajs"], n_iters=1, rng=np.random.default_rng(0),
                  surrogate=s["t"])


def test_a_pipeline_without_a_fanout_warns_and_falls_back(setup):
    s = setup
    system = s["tb"].system
    pipe = TPipeline(system, s["t"], TQuadFactory(system, goal=np.zeros(4)),
                     _named(TControllerFactory, "ZeroFactory")(system))
    kind, why = TTuner(use_fanout=True)._fanout_kind(pipe, s["t"])
    assert kind is None and "ZeroFactory has no fan-out" in why
    assert TTuner()._fanout_kind(pipe, s["t"]) == (None, "use_fanout=False")


def test_pretrain_without_surrogate_and_mesh_raise(setup):
    s = setup
    _, tp = _pipelines(s)
    with pytest.raises(ValueError, match="pretrain"):
        TTuner(surrogate_mode="pretrain", surrogate_split=0.5).run(
            tp, s["tb"].task, s["ttrajs"], n_iters=1, rng=np.random.default_rng(0))
    with pytest.raises(ValueError, match="mesh"):
        TTuner(mesh=object())


def test_assoc_backward_raises_by_name(setup):
    """``backward="assoc"`` runs in the single-lane solver (against the
    JAX package in tests/test_torch_solver_options.py: here it equals the
    scan recursion's solve, 1e-9); the lanes-last body refuses it by
    name, as the JAX package's does."""
    from autompc_torch.control import make_batched_ilqr_solver

    t, tb = setup["t"], setup["tb"]
    cost = TQuad(tb.system, np.eye(4), np.eye(1))
    kw = dict(H=5, ds=4, dc=1, obsdim=4, dt=0.05, max_iter=5)
    x0, ug = torch.tensor([0.3, 0.0, 0.1, 0.0], dtype=torch.float64), torch.zeros((5, 1),
                                                                              dtype=torch.float64)
    outs = [t_make_ilqr_solver(t.pred_core, cost, backward=b, **kw)(t.params, x0, ug)
            for b in ("assoc", "scan")]
    assert bool(outs[0][0]) == bool(outs[1][0])
    for a, b in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-9)
    with pytest.raises(ValueError, match="backward='assoc'"):
        make_batched_ilqr_solver(t.pred_core, cost, backward="assoc", lanes_last=True,
                                 fuse_ls=True, feature_spec=(t.library, "coeffs"), **kw)
