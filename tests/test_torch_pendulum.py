"""The pendulum benchmark and the data-generation signals of the port
against the JAX package, float64 on the CPU.

Each signal of ``autompc_torch/benchmarks/data_generation.py`` is a
deterministic function of named draws; the tests rebuild the JAX
package's draws from its key chain (``jax.random.split`` of the key
its generator derives) and pass them through ``draws=``, so the two
packages' trajectories must agree to 1e-12: the four signals on the
cartpole, the pendulum's dynamics and its data for each of its three
methods. The benchmarks' method lists are the JAX package's, and an
unknown method raises by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TCart
from autompc_torch.benchmarks import HalfcheetahBenchmark as THC
from autompc_torch.benchmarks import PendulumSwingupBenchmark as TPend
from autompc_torch.benchmarks import data_generation as tdg
from autompc_torch.benchmarks.pendulum import pendulum_dynamics
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JCart
from autompc_tpu.benchmarks import HalfcheetahBenchmark as JHC
from autompc_tpu.benchmarks import PendulumSwingupBenchmark as JPend
from autompc_tpu.benchmarks import data_generation as jdg
from autompc_tpu.benchmarks.pendulum import pendulum_dynamics as j_pendulum_dynamics

torch.set_num_threads(1)

TOL = 1e-12
N, T = 5, 30
CART_MIN, CART_MAX = np.array([-1.0, 0.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.0, 0.0])


def jax_draws(method, key, n, T, n_obs, m, **kw):
    """The draws the JAX package's generator makes from ``key``, named
    as the port's generators take them."""
    r = jax.random
    if method == "periodic_control":
        return {"inits": r.uniform(key, (len(tdg.periodic_periods(T, n)), n_obs))}
    if method == "uniform_random":
        k_init, k_u = r.split(key)
        return {"inits": r.uniform(k_init, (n, n_obs)), "u": r.uniform(k_u, (n, T, m))}
    k_init, k_a, k_b = r.split(key, 3)
    out = {"inits": r.uniform(k_init, (n, n_obs))}
    if method == "prbs":
        out["switches"] = r.randint(k_a, (n, kw["Nswitch"]), 0, T)
        out["levels"] = r.choice(k_b, jnp.asarray(kw["states"], dtype=float),
                                 (n, kw["Nswitch"] + 1))
    elif method == "random_walk":
        out["u0"] = r.uniform(k_a, (n, m))
        out["w"] = r.uniform(k_b, (n, T, m), minval=-1.0, maxval=1.0)
    elif method == "multisine":
        P = len(range(1, T, kw["n_freqs"]))
        out["vals"] = r.uniform(k_a, (n, m, P - 1))
        out["phases"] = r.uniform(k_b, (n, P), maxval=2 * jnp.pi)
    return out


def as_torch(draws):
    return {k: torch.as_tensor(np.array(v)) for k, v in draws.items()}


def assert_same(tb, jtb):
    np.testing.assert_allclose(tb.ctrls.numpy(), np.asarray(jtb.ctrls), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.obs.numpy(), np.asarray(jtb.obs), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("method, kw", [
    ("prbs", dict(states=np.array([-20.0, 20.0]), Nswitch=10)),
    ("random_walk", dict(walk_rate=1.0)),
    ("periodic_control", dict(U_1=np.ones(1))),
    ("multisine", dict(n_freqs=4)),
])
def test_signals_match_jax(method, kw):
    """Each signal on the cartpole: the port given JAX's draws gives JAX's
    trajectories."""
    jb, tb = JCart(), TCart()
    seed = 11
    common = dict(init_min=CART_MIN, init_max=CART_MAX, traj_len=T, n_trajs=N)
    ref = getattr(jdg, f"{method}_generate_batch")(
        system=jb.system, task=jb.task, dynamics=jb.dynamics, rng=seed, **common, **kw)
    draws = as_torch(jax_draws(method, jax.random.PRNGKey(seed), N, T, 4, 1, **kw))
    got = getattr(tdg, f"{method}_generate_batch")(
        system=tb.system, task=tb.task, dynamics=tb.dynamics, rng=None, draws=draws,
        **common, **kw)
    assert_same(got, ref)
    if method == "prbs":
        assert set(np.unique(got.ctrls.numpy())) <= {-20.0, 20.0}
    # Drawn by the port's own generator: the same shapes, on its device,
    # inside the bounds.
    own = getattr(tdg, f"{method}_generate_batch")(
        system=tb.system, task=tb.task, dynamics=tb.dynamics,
        rng=torch.Generator().manual_seed(seed), **common, **kw)
    assert own.obs.shape == got.obs.shape and own.obs.dtype == torch.float64
    assert float(own.ctrls.abs().max()) <= 20.0


def test_prbs_holds_each_level_between_switches():
    """``prbs_signal``: searchsorted with side="right" — the level index
    at step t counts the switches at or before t."""
    sw = torch.tensor([[3, 1, 3]])
    lv = torch.tensor([[0.0, 1.0, 2.0, 3.0]])
    got = tdg.prbs_signal(sw, lv, 6, 2)
    want = torch.tensor([0.0, 1.0, 1.0, 3.0, 3.0, 3.0])
    assert torch.equal(got[0, :, 0], want) and torch.equal(got[0, :, 1], want)


def test_pendulum_dynamics_match_jax():
    rng = np.random.default_rng(0)
    y = rng.uniform(-4, 4, (64, 2))
    u = rng.uniform(-2, 2, (64, 1))
    ref = jax.vmap(j_pendulum_dynamics)(jnp.asarray(y), jnp.asarray(u))
    got = pendulum_dynamics(torch.as_tensor(y), torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    # Leading axes are batch axes; a torque a state works too.
    got2 = pendulum_dynamics(torch.as_tensor(y).reshape(8, 8, 2),
                             torch.as_tensor(u[:, 0]).reshape(8, 8))
    np.testing.assert_allclose(got2.reshape(64, 2).numpy(), got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("method", ["uniform_random", "multisine", "random_walk"])
def test_pendulum_data_match_jax(method):
    """The benchmark's own generation (its init ranges, n_freqs=20,
    walk_rate=1) given the draws JAX's makes for the same seed."""
    jb, tb = JPend(method), TPend(method)
    seed, n, T_ = 3, 4, 45
    ref = jb.gen_trajs_batch(seed, n, T_)
    key = jax.random.PRNGKey(int(np.random.default_rng(seed).integers(1 << 31)))
    draws = as_torch(jax_draws(method, key, n, T_, 2, 1, n_freqs=20))
    got = tb._gen_trajs(n, T_, None, draws=draws)
    assert_same(got, ref)
    own = tb.gen_trajs_batch(seed, n, T_, device="cpu")
    assert own.obs.shape == (n, T_, 2) and float(own.ctrls.abs().max()) <= 2.0
    again = tb.gen_trajs_batch(seed, n, T_, device="cpu")
    assert torch.equal(own.obs, again.obs)


def test_pendulum_benchmark_matches_jax():
    jb, tb = JPend(), TPend()
    assert tb.system.observations == jb.system.observations and tb.system.dt == jb.system.dt
    np.testing.assert_array_equal(tb.task.get_ctrl_bounds(), jb.task.get_ctrl_bounds())
    np.testing.assert_array_equal(tb.task.get_init_obs(), np.asarray(jb.task.get_init_obs()))
    assert tb.task.get_num_steps() == jb.task.get_num_steps() == 200
    obs = np.random.default_rng(1).uniform(-0.5, 0.5, (50, 2))
    np.testing.assert_array_equal(
        tb.task.get_cost().eval_obs_cost(torch.as_tensor(obs)).numpy(),
        np.asarray(jax.vmap(jb.task.get_cost().eval_obs_cost)(jnp.asarray(obs))))
    trajs = tb.gen_trajs(0, 2, 5, device="cpu")
    assert len(trajs) == 2 and trajs[0].obs.shape == (5, 2)


@pytest.mark.parametrize("T_bench, J_bench", [(TCart, JCart), (TPend, JPend), (THC, JHC)])
def test_methods_lists_and_unknown_method(T_bench, J_bench):
    assert T_bench.data_gen_methods() == J_bench.data_gen_methods()
    for method in T_bench.data_gen_methods():
        T_bench(method)
    with pytest.raises(ValueError, match="no_such_signal"):
        T_bench(data_gen_method="no_such_signal")


@pytest.mark.parametrize("method", ["multisine", "random_walk"])
def test_halfcheetah_takes_the_new_signals(method):
    tb = THC(method)
    trajs = tb.gen_trajs(0, 2, 3, device="cpu")
    assert len(trajs) == 2 and trajs[0].obs.shape == (3, 18)
    ctrls = torch.stack([t.ctrls for t in trajs])
    assert torch.isfinite(ctrls).all() and float(ctrls.abs().max()) <= 1.0
