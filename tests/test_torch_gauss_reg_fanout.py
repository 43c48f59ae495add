"""The GaussReg term through the port's fan-outs and tuner, against the
JAX package, float64 on the CPU:

(a) ``QuadCostFanout``, ``JointSINDyQuadCostFanout`` and
    ``JointMLPQuadCostFanout`` built with ``reg_matrix``/``reg_goal``,
    every batch with ``regw``, against the JAX fan-outs (1e-8; the JAX
    side in its CPU form, the port's kernels through their plain
    versions, the fused batch-major body included);
(b) ``PipelineTuner`` with a ``QuadCostFactory + GaussRegFactory``
    pipeline: the fan-out tune against the sequential one (the explicit
    SumCost through the generic cost-hessian path) with no fallback
    warning, and the joint kinds (a ``SINDyFactory``, an ``MLPFactory``)
    through their fan-outs with the term;
(c) the JAX package's golden GaussReg tune
    (``tests/golden/gauss_reg_tune_golden.json``,
    ``tools/gen_golden_tune.py``) run with the port's modules: costs and
    incumbent curve at rtol 1e-6, the incumbent's configuration exactly.
"""

import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.benchmarks import CartpoleSwingupV2Benchmark as TBenchV2
from autompc_torch.control import IterativeLQRFactory as TILQRFactory
from autompc_torch.core.trajectory import TrajectoryBatch as TTB
from autompc_torch.costs import GaussRegFactory as TGaussReg
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.costs import QuadCostFactory as TQuadFactory
from autompc_torch.parallel import JointMLPQuadCostFanout as TJointMLP
from autompc_torch.parallel import JointSINDyQuadCostFanout as TJointSINDy
from autompc_torch.parallel import QuadCostFanout as TFanout
from autompc_torch.parallel import fanout as fanout_module
from autompc_torch.pipeline import Pipeline as TPipeline
from autompc_torch.sysid import MLP as TMLP
from autompc_torch.sysid import MLPFactory as TMLPFactory
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.sysid import SINDyFactory as TSINDyFactory
from autompc_torch.tuning import PipelineTuner as TTuner
from autompc_torch.tuning import pipeline_tuner as tpt
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark, CartpoleSwingupV2Benchmark
from autompc_tpu.core.trajectory import batch as jbatch
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.parallel.fanout import JointMLPQuadCostFanout as JJointMLP
from autompc_tpu.parallel.fanout import JointSINDyQuadCostFanout as JJointSINDy
from autompc_tpu.parallel.fanout import QuadCostFanout as JFanout
from autompc_tpu.sysid import MLP, SINDy
from test_torch_joint_mlp import BUCKET, EPOCHS, MAXW, NB, SEED, WIDTHS, _jax_draws

torch.set_num_threads(1)

SINDY_KW = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
                trig_interaction=True)
H_FAN, STEPS_FAN = 5, 4
INIT = np.array([0.5, 0.0, 0.0, 0.0])


def _as_port(tb, jtr):
    """JAX's trajectories as the port's TrajectoryBatch."""
    jb = jbatch(jtr)
    return TTB(tb.system, torch.as_tensor(np.array(jb.obs)), torch.as_tensor(np.array(jb.ctrls)),
               [int(n) for n in np.asarray(jb.lengths)])


def _tasks(b, tb, steps, init=INIT):
    """The benchmark's task in both packages with a quadratic task cost
    (a continuous score), ``steps`` steps from ``init``."""
    out = []
    for bench, cls, eye in ((b, JQuad, jnp.eye), (tb, TQuad, np.eye)):
        task = bench.task.copy()
        task.set_num_steps(steps)
        task.set_init_obs(init)
        task.set_cost(cls(bench.system, eye(4), 0.01 * eye(1), eye(4), goal=np.zeros(4)))
        out.append(task)
    return out


@pytest.fixture(scope="module")
def setup():
    b, tb = CartpoleSwingupBenchmark(), TBench()
    jtr = b.gen_trajs_batch(seed=42, n_trajs=20, traj_len=30)
    ttr = _as_port(tb, jtr)
    m = SINDy(b.system, **SINDY_KW)
    m.train(jtr)
    t = TSINDy(tb.system, device="cpu", **SINDY_KW)
    t.set_parameters({**m.get_parameters(), "feature_names": m.get_feature_names()})
    task, ttask = _tasks(b, tb, STEPS_FAN + 1)
    S, mu = tpt._gauss_reg_stats(ttr.to_list())
    rng = np.random.default_rng(0)
    batch = {"Qdiag": rng.uniform(0.01, 10, (6, 4)), "Rdiag": rng.uniform(1e-3, 1, (6, 1)),
             "Fdiag": rng.uniform(0.01, 10, (6, 4)), "regw": 10.0 ** rng.uniform(-3, 1, 6),
             "reg": 10.0 ** rng.uniform(-4, -1, 6)}
    return dict(b=b, tb=tb, jtr=jtr, ttr=ttr, m=m, t=t, task=task, ttask=ttask,
                reg=dict(reg_matrix=S, reg_goal=mu), batch=batch)


def _j(batch, keys):
    return {k: jnp.asarray(batch[k]) for k in keys}


# ---- (a) the fan-outs ---------------------------------------------------------------

COST = ("Qdiag", "Rdiag", "Fdiag", "regw")


@pytest.fixture(scope="module")
def jax_fixed(setup):
    s = setup
    fan = JFanout(s["b"].system, s["task"], s["m"], s["m"], horizon=H_FAN, n_steps=STEPS_FAN,
                  goal=np.zeros(4), backward="scan", **s["reg"])
    return np.asarray(fan(_j(s["batch"], COST)))


@pytest.mark.parametrize("kw", [
    dict(backward="scan"),
    dict(backward="pallas", fuse_ls=True, compact_schedule=((2, 0.5),)),
], ids=["plain", "fused"])
def test_quad_cost_fanout_with_reg_matches_jax(setup, jax_fixed, kw):
    s = setup
    fan = TFanout(s["tb"].system, s["ttask"], s["t"], s["t"], horizon=H_FAN, n_steps=STEPS_FAN,
                  goal=np.zeros(4), feature_spec=(s["t"].library, "coeffs"), device="cpu",
                  **s["reg"], **kw)
    got = fan({k: s["batch"][k] for k in COST}).numpy()
    np.testing.assert_allclose(got, jax_fixed, rtol=1e-8)
    assert len(set(np.round(jax_fixed, 6))) > 1
    # Without the term the scores differ: the term is on.
    base = TFanout(s["tb"].system, s["ttask"], s["t"], s["t"], horizon=H_FAN,
                   n_steps=STEPS_FAN, goal=np.zeros(4), device="cpu", backward="scan")
    assert not np.allclose(base({k: s["batch"][k] for k in COST[:3]}).numpy(), got)


def test_joint_sindy_fanout_with_reg_matches_jax(setup):
    s = setup
    keys = ("reg",) + COST
    bucket = {k: v for k, v in SINDY_KW.items() if k != "threshold"}
    jfan = JJointSINDy(s["b"].system, s["task"], bucket, s["jtr"].to_list(), s["m"],
                       horizon=H_FAN, n_steps=STEPS_FAN, backward="scan",
                       use_feature_kernels=False, **s["reg"])
    ref = np.asarray(jfan(_j(s["batch"], keys)))
    tfan = TJointSINDy(s["tb"].system, s["ttask"], bucket, s["ttr"], s["t"], horizon=H_FAN,
                       n_steps=STEPS_FAN, backward="pallas", use_feature_kernels=True,
                       device="cpu", **s["reg"])
    got = tfan({k: s["batch"][k] for k in keys}).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-8)
    # The term rides the solver, and a batch without its weights raises.
    assert tfan.solver_kw["reg_matrix"] is not None
    with pytest.raises(ValueError, match="regw"):
        tfan({k: s["batch"][k] for k in ("reg",) + COST[:3]})


def test_joint_mlp_fanout_with_reg_matches_jax():
    jb, tb = CartpoleSwingupV2Benchmark(), TBenchV2()
    jtr = jb.gen_trajs_batch(seed=5, n_trajs=4, traj_len=25)
    ttr = _as_port(tb, jtr).to_list()
    jtr = jtr.to_list()
    jsur = MLP(jb.system, n_hidden_layers=1, hidden_size=16, nonlintype="tanh",
               n_train_iters=2, n_batch=NB)
    jsur.train(jtr)
    tsur = TMLP(tb.system, n_hidden_layers=1, hidden_size=16, nonlintype="tanh", device="cpu")
    tsur.set_parameters(jsur.get_parameters())
    jtask, ttask = _tasks(jb, tb, 7, init=np.array([0.4, 0.0, 0.0, 0.0]))
    S, mu = tpt._gauss_reg_stats(ttr)
    common = dict(horizon=6, n_steps=6, max_width=MAXW, n_train_iters=EPOCHS, n_batch=NB,
                  seed=SEED, horizon_mask=True, reg_matrix=S, reg_goal=mu)
    jf = JJointMLP(jb.system, jtask, BUCKET, jtr, jsur, **common)
    tf = TJointMLP(tb.system, ttask, BUCKET, ttr, tsur, device="cpu", **common)
    rng = np.random.default_rng(11)
    batch = dict(widths=WIDTHS, lr=np.array([1e-2, 3e-3, 3e-2]),
                 Qdiag=rng.uniform(0.5, 5.0, (3, 4)), Rdiag=rng.uniform(1e-3, 0.05, (3, 1)),
                 Fdiag=rng.uniform(0.5, 5.0, (3, 4)), horizons=np.array([4, 6, 5]),
                 regw=np.array([1e-2, 3.0, 0.3]))
    ref = np.asarray(jf(batch))
    init, perms = _jax_draws(tf._XUt.shape[0], list(WIDTHS) + [WIDTHS[-1]] * 5)
    got = tf(batch, init_nets=[{k: v[:3] for k, v in la.items()} for la in init],
             perms=perms).numpy()
    assert got.shape == (3,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-8)
    # A padded lane is a copy of the last candidate, its weight too.
    full, _ = tf._prepare(batch)
    assert full["regw"].tolist() == [1e-2, 3.0, 0.3] + [0.3] * 5
    with pytest.raises(ValueError, match="regw"):
        tf({k: v for k, v in batch.items() if k != "regw"})


@pytest.mark.parametrize("kwargs, match", [
    (dict(impl="vmap"), "reg_matrix requires impl='batched'"),
    (dict(lanes_last=True, fuse_ls=True, backward="pallas"), "lanes_last"),
])
def test_quad_cost_fanout_refusals_with_reg_as_in_jax(setup, kwargs, match):
    s = setup
    for cls, task, model in ((TFanout, s["ttask"], s["t"]), (JFanout, s["task"], s["m"])):
        with pytest.raises(ValueError, match=match):
            cls(s["tb"].system, task, model, model, horizon=H_FAN, n_steps=STEPS_FAN,
                goal=np.zeros(4), feature_spec=(model.library, "coeffs"),
                **({"device": "cpu"} if cls is TFanout else {}), **s["reg"], **kwargs)


# ---- (b) the tuner ------------------------------------------------------------------


def _reg_pipeline(system, model, horizon=6):
    return TPipeline(system, model, TQuadFactory(system, goal=np.zeros(4)) + TGaussReg(system),
                     TILQRFactory(system, horizon=horizon))


def test_sum_cost_fanout_tune_matches_sequential(setup):
    """The port's twin of tests/test_tuning.py's
    test_gauss_reg_sum_cost_fanout_matches_sequential."""
    s = setup
    pipe = _reg_pipeline(s["tb"].system, s["t"])
    task = s["tb"].task.copy()
    task.set_num_steps(25)
    trajs = s["ttr"].to_list()
    _, seq = TTuner(surrogate_mode="pretrain", eval_batch=2).run(
        pipe, task, trajs, n_iters=4, rng=np.random.default_rng(3), surrogate=s["t"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # a fallback warning fails the test
        _, fan = TTuner(surrogate_mode="pretrain", eval_batch=2, use_fanout=True,
                        fanout_backward="pallas", fanout_feature_kernels=True).run(
            pipe, task, trajs, n_iters=4, rng=np.random.default_rng(3), surrogate=s["t"])
    assert [c.get_dictionary() for c in fan.cfgs] == [c.get_dictionary() for c in seq.cfgs]
    assert fan.surr_trajs == [None] * 4
    np.testing.assert_allclose(fan.costs, seq.costs, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["joint_sindy", "joint_mlp"])
def test_joint_kinds_take_the_reg_term_through_the_fanout(setup, kind, monkeypatch):
    """A model factory with the SumCost: the joint fan-out is built with
    the run's statistics as its reg_matrix and scores every candidate,
    with no fallback warning."""
    s = setup
    system = s["tb"].system
    factory = (TSINDyFactory(system, device="cpu") if kind == "joint_sindy"
               else TMLPFactory(system, n_train_iters=1, n_batch=NB, device="cpu"))
    pipe = TPipeline(system, factory, TQuadFactory(system, goal=np.zeros(4)) + TGaussReg(system),
                     TILQRFactory(system, horizon=5))
    built = []
    cls = TJointSINDy if kind == "joint_sindy" else TJointMLP

    class Recorded(cls):
        def __init__(self, *args, **kw):
            built.append(kw)
            super().__init__(*args, **kw)

    monkeypatch.setattr(fanout_module, cls.__name__, Recorded)
    task = s["ttask"].copy()
    task.set_num_steps(3)
    tuner = TTuner(surrogate_mode="pretrain", eval_batch=2, use_fanout=True)
    assert tuner._fanout_kind(pipe, s["t"]) == (kind, "")
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        _, res = tuner.run(pipe, task, s["ttr"].to_list(), n_iters=2,
                           rng=np.random.default_rng(1), surrogate=s["t"])
    assert len(res.costs) == 2 and not np.isnan(res.costs).any()
    S, mu = tpt._gauss_reg_stats(s["ttr"].to_list())
    assert built and all(np.array_equal(kw["reg_matrix"], S) and np.array_equal(kw["reg_goal"], mu)
                         for kw in built)


# ---- (c) the golden tune --------------------------------------------------------------

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "gauss_reg_tune_golden.json")


def test_gauss_reg_tune_matches_the_jax_golden():
    """tools/gen_golden_tune.py's run_tune with the port's modules: the
    JAX package's data draw, the port's SINDy trained on it, the
    SumCostFactory(QuadCostFactory + GaussRegFactory) space, the
    sequential objective at H=6 (the explicit SumCost)."""
    b, tb = CartpoleSwingupBenchmark(), TBench()
    trajs = _as_port(tb, b.gen_trajs(seed=42, n_trajs=40, traj_len=60)).to_list()
    model = TSINDy(tb.system, device="cpu", time_mode="discrete", **SINDY_KW)
    model.train(trajs)
    task = _tasks(b, tb, 40, init=np.array([0.9, 0.0, 0.0, 0.0]))[1]
    _, res = TTuner(surrogate_mode="pretrain", eval_batch=2).run(
        _reg_pipeline(tb.system, model), task, trajs, n_iters=6,
        rng=np.random.default_rng(1234), surrogate=model)
    with open(GOLDEN) as f:
        golden = json.load(f)
    np.testing.assert_allclose(res.costs, golden["costs"], rtol=1e-6)
    np.testing.assert_allclose(res.inc_costs, golden["inc_costs"], rtol=1e-6)
    assert res.inc_cfg.get_dictionary() == golden["inc_cfg"]
