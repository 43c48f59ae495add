"""Port's data generation, SINDy fit, costs and trajectory batch vs the
JAX package on the same arrays (float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.benchmarks.data_generation import rollout_batch
from autompc_torch.core import TrajectoryBatch as TBatch
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.ops import lstsq as tl
from autompc_torch.sysid import SINDy as TSINDy
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.benchmarks.data_generation import _rollout_batch
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.ops import lstsq as jl
from autompc_tpu.sysid import SINDy as JSINDy

# The tensors here are small: one intra-op thread (six test workers with a
# thread pool each oversubscribe the cores).
torch.set_num_threads(1)

SINDY_KW = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
                trig_interaction=True)


@pytest.fixture(scope="module")
def data():
    jb, tb = JBench(), TBench()
    trajs = jb.gen_trajs_batch(seed=42, n_trajs=30, traj_len=60)
    tt = TBatch(tb.system, torch.as_tensor(np.array(trajs.obs)),
                torch.as_tensor(np.array(trajs.ctrls)))
    return jb, tb, trajs, tt


def test_cartpole_rollout_matches(data):
    jb, tb, _, _ = data
    rng = np.random.default_rng(0)
    y0 = rng.uniform(-1, 1, (6, 4))
    U = rng.uniform(-20, 20, (6, 25, 1))
    ref = _rollout_batch(jb.system, jb.dynamics, jnp.asarray(y0), jnp.asarray(U))
    got = rollout_batch(tb.system, tb.dynamics, torch.as_tensor(y0), torch.as_tensor(U))
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(ref.obs), rtol=1e-12, atol=1e-12)


def test_gen_trajs_batch_shapes_and_bounds():
    tb = TBench().gen_trajs_batch(seed=42, n_trajs=5, traj_len=7, device="cpu")
    assert tb.obs.shape == (5, 7, 4) and tb.ctrls.shape == (5, 7, 1)
    assert tb.obs.dtype == torch.float64
    assert float(tb.ctrls.abs().max()) <= 20.0
    np.testing.assert_array_equal(tb.obs[:, 0, 1:].numpy(), 0.0)
    again = TBench().gen_trajs_batch(seed=42, n_trajs=5, traj_len=7, device="cpu")
    assert torch.equal(tb.obs, again.obs)


def test_trajectory_batch_masks_match():
    from autompc_tpu.core import TrajectoryBatch as JBatch
    from autompc_tpu.core import System

    sys_ = System(["a", "b"], ["u"])
    obs, ctrls, lengths = np.zeros((3, 5, 2)), np.zeros((3, 5, 1)), [5, 3, 1]
    j = JBatch(sys_, obs, ctrls, lengths)
    t = TBatch(sys_, torch.as_tensor(obs), torch.as_tensor(ctrls), lengths)
    np.testing.assert_array_equal(t.mask().numpy(), np.asarray(j.mask()))
    np.testing.assert_array_equal(t.step_mask().numpy(), np.asarray(j.step_mask()))
    assert len(t[1]) == 3 and t.to_list()[2].obs.shape == (1, 2)


@pytest.mark.parametrize("time_mode", ["discrete", "continuous"])
def test_sindy_fit_matches(data, time_mode):
    jb, tb, trajs, tt = data
    jm = JSINDy(jb.system, time_mode=time_mode, **SINDY_KW)
    jm.train(trajs)
    tm = TSINDy(tb.system, device="cpu", time_mode=time_mode, **SINDY_KW)
    tm.train(tt)
    jc = np.asarray(jm.coeffs)
    tc = tm.coeffs.numpy()
    np.testing.assert_array_equal(tc != 0, jc != 0)
    np.testing.assert_allclose(tc, jc, rtol=1e-8, atol=1e-12)
    if time_mode == "discrete":
        assert int(np.any(jc != 0, axis=0).sum()) == 7


def test_stlsq_svd_path_matches():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(80, 9))
    y = A @ (rng.normal(size=(9, 3)) * (rng.uniform(size=(9, 3)) > 0.5))
    y = y + 1e-3 * rng.normal(size=y.shape)
    mask = rng.uniform(size=80) > 0.1
    ref = np.asarray(jl.stlsq(jnp.asarray(A), jnp.asarray(y), 0.05, mask=jnp.asarray(mask)))
    got = tl.stlsq(torch.as_tensor(A), torch.as_tensor(y), 0.05, mask=torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8, atol=1e-12)


def test_masked_lstsq_matches():
    rng = np.random.default_rng(8)
    A, y = rng.normal(size=(30, 5)), rng.normal(size=(30, 2))
    mask = rng.uniform(size=30) > 0.3
    ref = np.asarray(jl.masked_lstsq(jnp.asarray(A), jnp.asarray(y), jnp.asarray(mask)))
    got = tl.masked_lstsq(torch.as_tensor(A), torch.as_tensor(y), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)


def test_stlsq_gram_matches_on_rank_deficient_gram():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(40, 6))
    A[:, 5] = A[:, 4]  # duplicate column: the ridge keeps the solve defined
    y = rng.normal(size=(40, 2))
    G, b = jl.gram_stage(jnp.asarray(A), jnp.asarray(y))
    ref = np.asarray(jl.stlsq_gram(G, b, 0.01))
    got = tl.stlsq_gram(*tl.gram_stage(torch.as_tensor(A), torch.as_tensor(y)), 0.01)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-9)


def test_set_parameters_carries_the_jax_model_over(data):
    jb, tb, trajs, _ = data
    jm = JSINDy(jb.system, **SINDY_KW)
    jm.train(trajs)
    tm = TSINDy(tb.system, device="cpu", **SINDY_KW)
    tm.set_parameters({**jm.get_parameters(), "feature_names": jm.get_feature_names()})
    rng = np.random.default_rng(6)
    x, u = rng.uniform(-2, 2, (10, 4)), rng.uniform(-5, 5, (10, 1))
    ref = np.stack([np.asarray(jm.pred_core(jm.params, jnp.asarray(a), jnp.asarray(b)))
                    for a, b in zip(x, u)])
    got = tm.pred_core(tm.params, torch.as_tensor(x), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    round_trip = TSINDy(tb.system, device="cpu", **SINDY_KW)
    round_trip.set_parameters(tm.get_parameters())
    assert torch.equal(round_trip.coeffs, tm.coeffs)


def test_set_parameters_rejects_another_library(data):
    jb, tb, trajs, _ = data
    jm = JSINDy(jb.system, **SINDY_KW)
    jm.train(trajs)
    poly = TSINDy(tb.system, device="cpu", method="lstsq", poly_basis=True, poly_degree=2)
    with pytest.raises(ValueError, match="shape"):
        poly.set_parameters(jm.get_parameters())
    tm = TSINDy(tb.system, device="cpu", **SINDY_KW)
    names = jm.get_feature_names()
    with pytest.raises(ValueError, match="another feature library"):
        tm.set_parameters({"coeffs": np.asarray(jm.coeffs),
                           "feature_names": names[1:] + names[:1]})


def test_unported_options_raise():
    """The Lasso is ported (tests/test_torch_tuning.py holds it against
    the JAX package); an unknown method still raises by name."""
    tb = TBench()
    with pytest.raises(ValueError, match="ridge"):
        TSINDy(tb.system, device="cpu", method="ridge")
    # Every data-generation method of the JAX package is ported; an
    # unknown one raises by name.
    TBench(data_gen_method="prbs")
    with pytest.raises(ValueError, match="no_such_method"):
        TBench(data_gen_method="no_such_method")


def test_costs_match():
    jb, tb = JBench(), TBench()
    Q, R, F = np.diag([10.0, 0.1, 0.01, 0.01]), 0.001 * np.eye(1), np.diag([3.0, 1, 1, 1])
    goal = np.array([0.1, 0.0, -0.2, 0.0])
    jc = JQuad(jb.system, jnp.asarray(Q), jnp.asarray(R), jnp.asarray(F), goal=jnp.asarray(goal))
    tc = TQuad(tb.system, Q, R, F, goal=goal)
    rng = np.random.default_rng(7)
    x, u = rng.normal(size=(5, 4)), rng.normal(size=(5, 1))
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    for jf, tf, arg, targ in (
        (jc.eval_obs_cost, tc.eval_obs_cost, x, tx),
        (jc.eval_ctrl_cost, tc.eval_ctrl_cost, u, tu),
        (jc.eval_term_obs_cost, tc.eval_term_obs_cost, x, tx),
    ):
        ref = np.array([float(jf(jnp.asarray(a))) for a in arg])
        np.testing.assert_allclose(tf(targ).numpy(), ref, rtol=1e-12)
    # Terminal derivatives keep the goal offset (DESIGN.md §7).
    assert tc.is_quad and tc.has_goal
    for i in range(5):
        _, g, h = jc.eval_term_obs_cost_hess(jnp.asarray(x[i]))
        _, tg, th = tc.eval_term_obs_cost_hess(tx[i])
        np.testing.assert_allclose(tg.numpy(), np.asarray(g), rtol=1e-12)
        np.testing.assert_allclose(th.numpy(), np.asarray(h), rtol=1e-12)
    thr = tb.task.get_cost()
    jthr = jb.task.get_cost()
    xs = rng.uniform(-0.4, 0.4, (6, 4))
    np.testing.assert_array_equal(
        thr.eval_obs_cost(torch.as_tensor(xs)).numpy(),
        [float(jthr.eval_obs_cost(jnp.asarray(a))) for a in xs],
    )
