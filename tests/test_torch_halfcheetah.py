"""The port's halfcheetah plant (benchmarks/halfcheetah.py, batch-native
closed-form kinematics) vs the pinned oracle trajectories
assets/golden/halfcheetah_oracle.npz at the tolerance
tests/test_halfcheetah_golden.py uses, and vs the JAX package's
halfcheetah_dynamics (jacfwd kinematics) to 1e-9, float64."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import HalfcheetahBenchmark as TBench
from autompc_torch.benchmarks.halfcheetah import HalfcheetahCost, halfcheetah_dynamics
from autompc_torch.core.trajectory import Trajectory
from autompc_tpu.benchmarks.halfcheetah import halfcheetah_dynamics as j_dynamics

# The tensors here are tiny: one intra-op thread. Six test workers with
# a thread pool each oversubscribe the cores and slow these loops of
# small ops a hundredfold.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "assets", "golden",
                      "halfcheetah_oracle.npz")
RTOL, ATOL = 1e-6, 1e-8          # tests/test_halfcheetah_golden.py


@pytest.fixture(scope="module")
def golden():
    data = np.load(GOLDEN)
    return (np.stack([data[f"obs_{i}"] for i in range(3)]),
            np.stack([data[f"ctrl_{i}"] for i in range(3)]))


def test_every_golden_transition(golden):
    """All 600 pinned transitions in one batch: one control step from
    the golden state gives the next golden state."""
    obs, ctrls = golden
    x = torch.as_tensor(obs[:, :-1].reshape(-1, 18))
    u = torch.as_tensor(ctrls[:, :obs.shape[1] - 1].reshape(-1, 6))
    got = halfcheetah_dynamics(x, u).numpy()
    np.testing.assert_allclose(got, obs[:, 1:].reshape(-1, 18), rtol=RTOL, atol=ATOL)


def test_golden_rollout_prefix(golden):
    """Rolled out from the task's initial state the port follows the
    oracle. The contact dynamics amplify last-digit differences about
    tenfold every 25 control steps (1e-13 after 10 steps, 1e-7 after
    200, measured), so the rollout is held to the golden tolerance over
    its first 60 steps and the whole horizon by the test above."""
    obs, ctrls = golden
    bench = TBench()
    x = torch.as_tensor(np.tile(np.asarray(bench.task.get_init_obs(), dtype=float), (3, 1)))
    np.testing.assert_array_equal(x.numpy(), obs[:, 0])
    for t in range(60):
        x = bench.dynamics(x, torch.as_tensor(ctrls[:, t]))
        np.testing.assert_allclose(x.numpy(), obs[:, t + 1], rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {t + 1}")
    assert np.isfinite(x.numpy()).all()


def test_five_steps_match_jax_dynamics():
    """Random states near and in the ground (contacts active, joints
    outside their range, controls beyond [-1, 1]) through 5 control
    steps of both packages."""
    rng = np.random.default_rng(0)
    B = 6
    x = np.zeros((B, 18))
    x[:, 1] = rng.uniform(0.45, 0.75, B)
    x[:, 2:9] = rng.uniform(-0.9, 0.9, (B, 7))
    x[:, 9:] = rng.normal(0, 1.0, (B, 9))
    us = rng.uniform(-1.3, 1.3, (5, B, 6))

    @jax.jit
    def roll(x0, us):
        def step(xc, u):
            x1 = jax.vmap(j_dynamics)(xc, u)
            return x1, x1
        return jax.lax.scan(step, x0, us)[1]

    ref = np.asarray(roll(jnp.asarray(x), jnp.asarray(us)))
    xt = torch.as_tensor(x)
    for t in range(5):
        xt = halfcheetah_dynamics(xt, torch.as_tensor(us[t]))
        np.testing.assert_allclose(xt.numpy(), ref[t], rtol=1e-9, atol=1e-9,
                                   err_msg=f"step {t + 1}")
    # Leading axes are batch axes, whatever their number.
    one = halfcheetah_dynamics(torch.as_tensor(x[0]), torch.as_tensor(us[0, 0]))
    grid = halfcheetah_dynamics(torch.as_tensor(x).reshape(2, 3, 18),
                                torch.as_tensor(us[0]).reshape(2, 3, 6))
    np.testing.assert_allclose(one.numpy(), ref[0, 0], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(grid.reshape(B, 18).numpy(), ref[0], rtol=1e-9, atol=1e-9)


def test_benchmark_task_cost_and_data():
    from autompc_tpu.benchmarks import HalfcheetahBenchmark as JBench

    jb, tb = JBench(), TBench()
    assert (tb.system.obs_dim, tb.system.ctrl_dim, tb.system.dt) == (18, 6, jb.system.dt)
    np.testing.assert_array_equal(tb.task.get_init_obs(), jb.task.get_init_obs())
    np.testing.assert_array_equal(tb.task.get_ctrl_bounds(), jb.task.get_ctrl_bounds())
    assert tb.task.get_num_steps() == jb.task.get_num_steps() == 200

    rng = np.random.default_rng(1)
    obs, ctrls = rng.normal(size=(7, 18)), rng.normal(size=(7, 6))
    tc, jc = tb.task.get_cost(), jb.task.get_cost()
    assert isinstance(tc, HalfcheetahCost)
    np.testing.assert_allclose(
        tc.eval_ctrl_cost(torch.as_tensor(ctrls)).numpy(),
        np.asarray(jax.vmap(jc.eval_ctrl_cost)(jnp.asarray(ctrls))), rtol=1e-12)
    np.testing.assert_allclose(
        tc.eval_term_obs_cost(torch.as_tensor(obs)).numpy(),
        np.asarray(jax.vmap(jc.eval_term_obs_cost)(jnp.asarray(obs))), rtol=1e-12)
    assert float(tc.eval_obs_cost(torch.as_tensor(obs)).abs().max()) == 0.0
    traj = Trajectory(tb.system, 7, torch.as_tensor(obs), torch.as_tensor(ctrls))
    want = 200.0 - (-0.1 * (ctrls[:-1] ** 2).sum() + (obs[-1, 0] - obs[0, 0]) / 0.05)
    np.testing.assert_allclose(float(tc(traj)), want, rtol=1e-12)

    trajs = tb.gen_trajs_batch(seed=0, n_trajs=3, traj_len=4, device="cpu")
    assert tuple(trajs.obs.shape) == (3, 4, 18) and tuple(trajs.ctrls.shape) == (3, 4, 6)
    assert torch.isfinite(trajs.obs).all() and float(trajs.ctrls.abs().max()) <= 1.0
    x1 = tb.dynamics(trajs.obs[:, 0], trajs.ctrls[:, 0])
    np.testing.assert_allclose(trajs.obs[:, 1].numpy(), x1.numpy(), rtol=1e-12, atol=1e-12)
    again = tb.gen_trajs_batch(seed=0, n_trajs=3, traj_len=4, device="cpu")
    np.testing.assert_array_equal(again.obs.numpy(), trajs.obs.numpy())
    # The cheetah takes uniform_random, multisine and random_walk, as in
    # the JAX package; an unknown method raises by name.
    TBench(data_gen_method="multisine")
    with pytest.raises(ValueError, match="no_such_method"):
        TBench(data_gen_method="no_such_method")
