"""The joint Koopman fan-out and the tuner's kinds "joint_arx" and
"joint_koopman" of the port against the JAX package, float64 on the CPU,
at small sizes:

- ``JointKoopmanLassoQuadCostFanout`` (trig basis, ds = 12) against the
  JAX fan-out at B = 8, H = 5, 3 closed-loop steps, with and without the
  GaussReg term (``reg_matrix``), at 1e-8; with ``backward="pallas"``
  too (on the CPU: K6's plain version at ds = 12, and with the GaussReg
  term K4's, the dense-expansion recursion at (12, 1)); its per-lane (A, B)
  against the Koopman model trained alone with the lane's alpha;
- the tuner: kind selection, one small round of each kind against the
  JAX tuner (costs at 1e-6, the same configurations and incumbent),
  "joint_gp" among the ported kinds;
- a pipeline with an ``LQRFactory`` (no fan-out) warns and runs the
  sequential objective, each cost the task cost of its own simulation.

Both packages see the same data (the port's draw carried across) and the
same surrogate coefficients (``SINDy.set_parameters``).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.control import IterativeLQRFactory as TILQRFactory
from autompc_torch.control import LQRFactory as TLQRFactory
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.costs import QuadCostFactory as TQuadFactory
from autompc_torch.parallel import JointKoopmanLassoQuadCostFanout as TJoint
from autompc_torch.pipeline import Pipeline as TPipeline
from autompc_torch.sysid import ARXFactory as TARXFactory
from autompc_torch.sysid import Koopman as TK
from autompc_torch.sysid import KoopmanFactory as TKF
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.tuning import PipelineTuner as TTuner
from autompc_torch.tuning import pipeline_tuner
from autompc_torch.utils.simulation import simulate as t_simulate
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.control import IterativeLQRFactory
from autompc_tpu.core.trajectory import TrajectoryBatch as JTB
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.costs import QuadCostFactory
from autompc_tpu.parallel.fanout import JointKoopmanLassoQuadCostFanout as JJoint
from autompc_tpu.pipeline import Pipeline
from autompc_tpu.sysid import ARXFactory, KoopmanFactory, SINDy
from autompc_tpu.tuning import PipelineTuner

torch.set_num_threads(1)

SURR = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
            trig_interaction=True)
BASIS = dict(trig_basis=True, trig_freq=1)
H_FAN, STEPS_FAN, B_FAN = 5, 3, 8
INIT = np.array([0.5, 0.0, 0.0, 0.0])


@pytest.fixture(scope="module")
def setup():
    """Both benchmarks, one sysid data set, one surrogate and a
    near-upright task with a quadratic task cost in each package."""
    b, tb = JBench(), TBench()
    ttr = tb.gen_trajs_batch(seed=42, n_trajs=20, traj_len=30, device="cpu")
    jtr = JTB(b.system, ttr.obs.numpy(), ttr.ctrls.numpy(), ttr.lengths.numpy())
    tsurr = TSINDy(tb.system, device="cpu", **SURR)
    tsurr.train(ttr)
    surr = SINDy(b.system, **SURR)
    surr.set_parameters({"coeffs": tsurr.coeffs.numpy()})
    task, ttask = b.task.copy(), tb.task.copy()
    for tk in (task, ttask):
        tk.set_num_steps(STEPS_FAN + 1)
        tk.set_init_obs(INIT)
    task.set_cost(JQuad(b.system, jnp.eye(4), 0.01 * jnp.eye(1), jnp.eye(4), goal=jnp.zeros(4)))
    ttask.set_cost(TQuad(tb.system, np.eye(4), 0.01 * np.eye(1), np.eye(4), goal=np.zeros(4)))
    rng = np.random.default_rng(0)
    batch = {"reg": 10.0 ** rng.uniform(-6, 0, B_FAN),
             "Qdiag": 10 ** rng.uniform(-1, 1.5, (B_FAN, 4)),
             "Fdiag": 10 ** rng.uniform(-1, 1.5, (B_FAN, 4)),
             "Rdiag": 10 ** rng.uniform(-3, 0, (B_FAN, 1)),
             "regw": 10 ** rng.uniform(-3, 1, B_FAN)}
    S = np.diag([2.0, 0.5, 1.0, 0.25])
    mu = np.array([0.1, 0.0, -0.05, 0.0])
    return dict(b=b, tb=tb, jtr=jtr, ttr=ttr, surr=surr, tsurr=tsurr, task=task, ttask=ttask,
                batch=batch, S=S, mu=mu)


def _reg(s, reg):
    return dict(reg_matrix=s["S"], reg_goal=s["mu"]) if reg else {}


@pytest.fixture(scope="module")
def jax_costs(setup):
    s, out = setup, {}
    for reg in (False, True):
        fan = JJoint(s["b"].system, s["task"], BASIS, s["jtr"].to_list(), s["surr"],
                     horizon=H_FAN, n_steps=STEPS_FAN, backward="scan", **_reg(s, reg))
        batch = {k: v for k, v in s["batch"].items() if reg or k != "regw"}
        out[reg] = np.asarray(fan({k: jnp.asarray(v) for k, v in batch.items()}))
    return out


@pytest.mark.parametrize("reg, backward", [(False, "scan"), (True, "scan"),
                                           (False, "pallas"), (True, "pallas")])
def test_joint_koopman_fanout_matches_jax(setup, jax_costs, reg, backward):
    s = setup
    fan = TJoint(s["tb"].system, s["ttask"], BASIS, s["ttr"], s["tsurr"], horizon=H_FAN,
                 n_steps=STEPS_FAN, backward=backward, device="cpu", **_reg(s, reg))
    assert fan.state_dim == 12 and fan.solver_kw["obsdim"] == 4
    batch = {k: v for k, v in s["batch"].items() if reg or k != "regw"}
    got = fan(batch).numpy()
    ref = jax_costs[reg]
    assert got.shape == (B_FAN,) and np.all(np.isfinite(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-8)
    assert len(set(np.round(ref, 6))) > 1      # the candidates discriminate


def test_lanes_train_as_the_model_alone(setup):
    """Lane b's (A, B) is the Koopman model trained alone with lane b's
    alpha; a batch of 5 pads to 8 lanes and returns 5 costs."""
    s = setup
    fan = TJoint(s["tb"].system, s["ttask"], BASIS, s["ttr"], s["tsurr"], horizon=H_FAN,
                 n_steps=STEPS_FAN, device="cpu")
    alphas = torch.as_tensor(s["batch"]["reg"][:3])
    params = fan.train_lanes(alphas)
    for i in range(3):
        m = TK(s["tb"].system, method="lasso", lasso_alpha=float(alphas[i]), device="cpu",
               **BASIS)
        m.train(s["ttr"])
        np.testing.assert_allclose(params["A"][i].numpy(), m.A.numpy(), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(params["B"][i].numpy(), m.B.numpy(), rtol=1e-10,
                                   atol=1e-12)
    five = {k: v[:5] for k, v in s["batch"].items() if k != "regw"}
    assert fan(five).shape == (5,)


def test_joint_koopman_fanout_refuses_by_name(setup):
    s = setup
    args = (s["tb"].system, s["ttask"], BASIS, s["ttr"], s["tsurr"])
    with pytest.raises(ValueError, match="mesh"):
        TJoint(*args, mesh=object(), device="cpu")
    fan = TJoint(*args, horizon=H_FAN, n_steps=STEPS_FAN, device="cpu", **_reg(s, True))
    with pytest.raises(ValueError, match="regw"):
        fan({k: v for k, v in s["batch"].items() if k != "regw"})


# ---- the tuner ---------------------------------------------------------------

# The factory's keywords win over the configuration's values: ARX's history
# pinned (one bucket); Koopman's basis pinned to the trig library, its
# method and alpha free (lstsq, lasso and stable buckets).
ARX_PIN = dict(history=2)
KOOP_PIN = dict(poly_basis="false", trig_basis="true", trig_freq=1)


def _factories(port, kind, system):
    if kind == "joint_arx":
        return (TARXFactory(system, device="cpu", **ARX_PIN) if port
                else ARXFactory(system, **ARX_PIN))
    return TKF(system, device="cpu", **KOOP_PIN) if port else KoopmanFactory(system, **KOOP_PIN)


def _tune(s, kind, port, n_iters=6):
    system = (s["tb"] if port else s["b"]).system
    mf = _factories(port, kind, system)
    if port:
        pipe = TPipeline(system, mf, TQuadFactory(system, goal=np.zeros(4)),
                         TILQRFactory(system, horizon=4))
        tuner = TTuner(surrogate_mode="pretrain", eval_batch=n_iters, use_fanout=True)
        assert tuner._fanout_kind(pipe, s["tsurr"]) == (kind, "")
        return tuner.run(pipe, s["ttask"], s["ttr"].to_list(), n_iters=n_iters,
                         rng=np.random.default_rng(7), surrogate=s["tsurr"])[1]
    pipe = Pipeline(system, mf, QuadCostFactory(system, goal=np.zeros(4)),
                    IterativeLQRFactory(system, horizon=4))
    tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=n_iters, use_fanout=True,
                          fanout_backward="scan")
    return tuner.run(pipe, s["task"], s["jtr"].to_list(), n_iters=n_iters,
                     rng=np.random.default_rng(7), surrogate=s["surr"])[1]


@pytest.mark.parametrize("kind", ["joint_arx", "joint_koopman"])
def test_tuner_kind_matches_jax(setup, kind):
    assert kind in pipeline_tuner._PORTED_KINDS
    res, ref = _tune(setup, kind, port=True), _tune(setup, kind, port=False)
    assert [c.get_dictionary() for c in res.cfgs] == [c.get_dictionary() for c in ref.cfgs]
    if kind == "joint_koopman":
        methods = {c["_model:method"] for c in res.cfgs}
        assert {"lasso", "lstsq"} <= methods, methods
    assert np.isfinite(ref.costs).any()
    np.testing.assert_allclose(res.costs, ref.costs, rtol=1e-6)
    assert res.inc_cfg.get_dictionary() == ref.inc_cfg.get_dictionary()


def test_joint_gp_still_refused_by_name():
    """The kind "joint_gp" is ported now (tests/test_torch_joint_gp.py
    holds it against the JAX tuner); the name is kept."""
    assert "joint_gp" in pipeline_tuner._PORTED_KINDS
    assert pipeline_tuner._JOINT_KINDS["ApproximateGPModelFactory"] == "joint_gp"


def test_lqr_pipeline_runs_the_sequential_objective(setup):
    """ARX + QuadCost + LQR (configs[0]) has no fan-out: use_fanout=True
    warns and falls back; each candidate's cost is the task cost of its
    own simulation on the surrogate, the incumbent finite."""
    s = setup
    system = s["tb"].system
    pipe = TPipeline(system, TARXFactory(system, device="cpu", **ARX_PIN),
                     TQuadFactory(system, goal=np.zeros(4)), TLQRFactory(system))
    tuner = TTuner(surrogate_mode="pretrain", eval_batch=2, use_fanout=True)
    assert tuner._fanout_kind(pipe, s["tsurr"])[0] is None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        controller, res = tuner.run(pipe, s["ttask"], s["ttr"].to_list(), n_iters=2,
                                    rng=np.random.default_rng(3), surrogate=s["tsurr"])
    assert any("falling back" in str(w.message) for w in caught)
    assert len(res.costs) == 2 and np.isfinite(res.inc_costs[-1])
    for cfg, cost in zip(res.cfgs, res.costs):
        con, _, _ = pipe(cfg, s["ttask"], s["ttr"].to_list())
        traj = t_simulate(con, INIT, s["ttask"].term_cond, sim_model=s["tsurr"],
                          max_steps=s["ttask"].get_num_steps())
        assert cost == pytest.approx(float(s["ttask"].get_cost()(traj)), rel=1e-12)
    assert type(controller).__name__ == "LQR"
