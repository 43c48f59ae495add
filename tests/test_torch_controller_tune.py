"""The port's controllers through its tuner, and the zero controller,
float64 on the CPU.

- ``ZeroController``/``ZeroControllerFactory`` and ``Controller.run``
  against the JAX package's shapes and values;
- ``PipelineTuner(use_fanout=True)`` with an ``MPPIFactory`` (kind
  "mppi", one bucket of (horizon, num_path)) and with a
  ``DirectTranscriptionControllerFactory`` pinned at 0.5 s (kind "dt",
  10 knots at dt = 0.05) takes the fan-out and scores every candidate as
  the sequential objective does (``simulate`` of the controller the
  Pipeline builds), surrogate and true-dynamics scores alike: 1e-9, and
  ``inf`` where the other side has ``inf`` (tests/test_tuning.py:706,
  :812);
- the same with a ``QuadCostFactory + GaussRegFactory`` SumCost space,
  with no fallback warning (tests/test_tuning.py:748-803);
- the receding SQP loop with and without ``warm_start`` against the JAX
  package's ``make_receding_sqp_loop`` on the cartpole SINDy model: 1e-9;
- ``DirectTranscriptionController`` with the task's observation bounds on
  the double integrator of tests/test_nmpc_state_bounds.py: the controls
  and warm starts of three steps against the JAX package's (1e-6: the
  augmented Lagrangian amplifies rounding ~1e7-fold) and the cap on the
  plan.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.control import DirectTranscriptionController as TDT
from autompc_torch.control import DirectTranscriptionControllerFactory as TDTFactory
from autompc_torch.control import IterativeLQR as TILQR
from autompc_torch.control import MPPI as TMPPI
from autompc_torch.control import MPPIFactory as TMPPIFactory
from autompc_torch.control import ZeroController as TZero
from autompc_torch.control import ZeroControllerFactory as TZeroFactory
from autompc_torch.control import make_receding_sqp_loop as t_loop
from autompc_torch.core.trajectory import zeros as tzeros
from autompc_torch.costs import GaussRegFactory as TGaussReg
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.costs import QuadCostFactory as TQuadFactory
from autompc_torch.costs import SumCostFactory as TSumFactory
from autompc_torch.pipeline import Pipeline as TPipeline
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.tuning import PipelineTuner as TTuner
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.control import DirectTranscriptionController as JDT
from autompc_tpu.control import ZeroController as JZero
from autompc_tpu.control import ZeroControllerFactory as JZeroFactory
from autompc_tpu.control.receding import make_receding_sqp_loop as j_loop
from autompc_tpu.core.trajectory import zeros as jzeros
from test_torch_dt import A, B, DT, VEL_CAP, X0, integrator
from test_torch_mppi import quad_tasks, sindy_pair

torch.set_num_threads(1)

SINDY_KW = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
                trig_interaction=True)


@pytest.fixture(scope="module")
def setup():
    tb = TBench()
    trajs = tb.gen_trajs_batch(seed=42, n_trajs=20, traj_len=50, device="cpu")
    model = TSINDy(tb.system, device="cpu", **SINDY_KW)
    model.train(trajs)
    task = tb.task.copy()
    task.set_num_steps(6)
    # A quadratic task cost: a continuous score, so that the comparison
    # sees every digit.
    task.set_cost(TQuad(tb.system, np.eye(4), 0.01 * np.eye(1), np.eye(4), goal=np.zeros(4)))
    task.set_init_obs(np.array([0.5, 0.0, 0.0, 0.0]))
    return tb, trajs.to_list() if hasattr(trajs, "to_list") else trajs, model, task


def test_zero_controller_matches_jax():
    tb, jb = TBench(), JBench()
    assert TZeroFactory(tb.system).get_configuration_space().get_hyperparameter_names() == \
        JZeroFactory(jb.system).get_configuration_space().get_hyperparameter_names() == []
    jc, tc = JZero(jb.system, jb.task, None), TZero(tb.system, tb.task, None)
    js = jc.traj_to_state(jzeros(jb.system, 1))
    ts = tc.traj_to_state(tzeros(tb.system, 1, device="cpu"))
    assert tuple(ts.shape) == tuple(js.shape) == (0,)
    obs = np.array([3.1, 0.2, 0.0, 0.0])
    uj, _ = jc.run(js, jnp.asarray(obs))
    ut, ts2 = tc.run(ts, torch.as_tensor(obs))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    assert ut.shape == (1,) and ts2 is ts and tc.state_dim == 0


@pytest.mark.parametrize("Controller, kw", [
    (TMPPI, dict(horizon=5, num_path=8, sigma=0.5, lmda=0.4, seed=1)),
    (TILQR, dict(horizon=5)),
])
def test_run_is_a_call_of_step(setup, Controller, kw):
    tb, _, model, task = setup
    c = Controller(tb.system, task, model, **kw)
    cs = c.traj_to_state(tzeros(tb.system, 1, device="cpu"))
    obs = torch.as_tensor(task.get_init_obs())
    u_run, s_run = c.run(cs, obs)
    u_step, s_step = c.step(cs, obs)
    np.testing.assert_array_equal(u_run.numpy(), u_step.numpy())
    assert s_run.keys() == s_step.keys()


def _compare(seq, fan, truedyn=False):
    pairs = list(zip(seq.costs, fan.costs))
    if truedyn:
        pairs += list(zip(seq.truedyn_costs, fan.truedyn_costs))
    for cs, cf in pairs:
        if np.isfinite(cs) or np.isfinite(cf):
            assert cf == pytest.approx(cs, rel=1e-9, abs=1e-9), (seq.costs, fan.costs)
        else:
            assert np.isinf(cs) and np.isinf(cf)


def _tunes(pipe, task, trajs, model, n_iters, batch, seed, **run_kw):
    """(sequential, fan-out) tune results; the fan-out's warns of no
    fallback."""
    run = dict(pipeline=pipe, task=task, trajs=trajs, n_iters=n_iters, surrogate=model,
               **run_kw)
    _, seq = TTuner(surrogate_mode="pretrain", eval_batch=batch).run(
        rng=np.random.default_rng(seed), **run)
    fan_tuner = TTuner(surrogate_mode="pretrain", eval_batch=batch, use_fanout=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, fan = fan_tuner.run(rng=np.random.default_rng(seed), **run)
    assert not [w for w in caught if "fan-out" in str(w.message)]
    return seq, fan, fan_tuner


def test_mppi_fanout_matches_sequential(setup):
    tb, trajs, model, task = setup
    pipe = TPipeline(tb.system, model, TQuadFactory(tb.system, goal=np.zeros(4)),
                     TMPPIFactory(tb.system, num_path=16, horizon=6))
    assert TTuner(use_fanout=True)._fanout_kind(pipe, model) == ("mppi", "")
    seq, fan, _ = _tunes(pipe, task, trajs, model, 3, 3, 4, truedyn=tb.dynamics)
    assert len(fan.truedyn_costs) == 3 and np.all(np.isfinite(fan.costs))
    _compare(seq, fan, truedyn=True)


def test_dt_fanout_matches_sequential(setup, monkeypatch):
    """0.5 s at dt = 0.05: one bucket of 10 knots."""
    from autompc_torch.parallel import fanout as fanout_module

    knots = []
    real = fanout_module.DirectTranscriptionFanout

    def spy(*args, **kw):
        knots.append(kw["horizon_knots"])
        return real(*args, **kw)

    monkeypatch.setattr(fanout_module, "DirectTranscriptionFanout", spy)
    tb, trajs, model, task = setup
    pipe = TPipeline(tb.system, model, TQuadFactory(tb.system, goal=np.zeros(4)),
                     TDTFactory(tb.system, horizon=0.5))
    assert TTuner(use_fanout=True)._fanout_kind(pipe, model) == ("dt", "")
    seq, fan, _ = _tunes(pipe, task, trajs, model, 2, 2, 5)
    assert knots == [10]
    _compare(seq, fan)


@pytest.mark.parametrize("ctrl", ["mppi", "dt"])
def test_gauss_reg_fanout_matches_sequential(setup, ctrl):
    tb, trajs, model, task = setup
    cf = (TMPPIFactory(tb.system, num_path=16, horizon=5) if ctrl == "mppi"
          else TDTFactory(tb.system, horizon=0.25))
    pipe = TPipeline(tb.system, model, TSumFactory(tb.system, [
        TQuadFactory(tb.system, goal=np.zeros(4)), TGaussReg(tb.system)]), cf)
    seq, fan, tuner = _tunes(pipe, task, trajs, model, 2, 2, 6)
    assert tuner._reg_stats is not None
    _compare(seq, fan)


@pytest.mark.parametrize("warm_start", [False, True])
def test_receding_sqp_loop_matches_jax(warm_start):
    jb, tb, m, t = sindy_pair()
    jtask, ttask = quad_tasks(jb, tb)
    bounds = ttask.get_ctrl_bounds()
    kw = dict(H=5, ds=4, dc=1, obsdim=4, dt=tb.system.dt, n_steps=4, sqp_iters=4,
              ubounds=(bounds[:, 0], bounds[:, 1]), warm_start=warm_start)
    x0 = np.random.default_rng(2).uniform(-1, 1, (2, 4)) * np.array([1.0, 0.3, 0.3, 0.3])
    xs_j, us_j = jax.jit(j_loop(m.pred_core, jtask.get_cost(), jb.dynamics, **kw))(
        m.params, jnp.asarray(x0))
    xs_t, us_t = t_loop(t.pred_core, ttask.get_cost(), tb.dynamics, **kw)(
        t.params, torch.as_tensor(x0))
    assert xs_t.shape == (2, 5, 4) and us_t.shape == (2, 4, 1)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-9, atol=1e-9)


def test_controller_applies_obs_bounds_as_jax():
    jm, jtask, tm, ttask = integrator(bounded=True)
    H = 16
    jc, tc = JDT(jm.system, jtask, jm, horizon=H * DT), TDT(tm.system, ttask, tm, horizon=H * DT)
    assert tc.horizon == jc.horizon == H
    # The augmented-Lagrangian solve amplifies rounding ~1e7-fold: the JAX
    # controller itself moves its second control by 6e-9 (4e-8 relative)
    # when the start moves by 1e-15. So the two packages, whose sums
    # associate differently, are held to 1e-6 here; make_sqp_solver's
    # bounded SINDy solve is held to 1e-9 (tests/test_torch_dt.py).
    js = jc.traj_to_state(jzeros(jm.system, 1))
    ts = tc.traj_to_state(tzeros(tm.system, 1, device="cpu"))
    jstep = jax.jit(jc.step)
    obs = X0
    for k in range(3):
        uj, js = jstep(js, jnp.asarray(obs))
        ut, ts = tc.run(ts, torch.as_tensor(obs))
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-6, atol=1e-6)
        for key in ("xs_guess", "us_guess"):
            np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"step {k} {key}")
        obs = A @ obs + B @ ut.numpy()
    assert ts["xs_guess"][1:, 1].max() <= VEL_CAP + 5e-3
