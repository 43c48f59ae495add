"""The port's receding-horizon loop (batched lanes-last solver inside)
vs the JAX package's make_receding_ilqr_loop (vmapped single-lane
solver inside) on the same SINDy model and plant, float64: xs/us to
1e-8 and equal converged counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.control import make_receding_ilqr_loop as t_loop
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.sysid import SINDy as TSINDy
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.control.receding import make_receding_ilqr_loop as j_loop
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.sysid import SINDy

QD = np.diag([10.0, 0.1, 0.01, 0.01])


@pytest.fixture(scope="module")
def setup():
    jb, tb = JBench(), TBench()
    kw = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
              trig_interaction=True)
    m = SINDy(jb.system, **kw)
    m.train(jb.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100))
    t = TSINDy(tb.system, device="cpu", **kw)
    t.set_parameters({**m.get_parameters(), "feature_names": m.get_feature_names()})
    active = tuple(int(k) for k in np.flatnonzero(np.any(np.asarray(m.coeffs) != 0, axis=0)))
    bounds = jb.task.get_ctrl_bounds()
    common = dict(H=8, ds=4, dc=1, obsdim=4, dt=jb.system.dt, n_steps=5,
                  ubounds=(bounds[:, 0], bounds[:, 1]))
    return jb, tb, m, t, active, common


@pytest.mark.parametrize("warm_start", [True, False])
def test_receding_loop_matches_jax(setup, warm_start):
    jb, tb, m, t, active, common = setup
    jrun = jax.jit(j_loop(
        m.pred_core,
        JQuad(jb.system, jnp.asarray(QD), 0.001 * jnp.eye(1), jnp.asarray(QD),
              goal=jnp.zeros(4)),
        jb.dynamics, warm_start=warm_start, **common,
    ))
    trun = t_loop(
        t.pred_core, TQuad(tb.system, QD, 0.001 * np.eye(1), QD, goal=np.zeros(4)),
        tb.dynamics, warm_start=warm_start,
        feature_spec=(t.library, "coeffs"), feature_mask=active, **common,
    )
    x0 = np.random.default_rng(0).uniform(-1, 1, (4, 4)) * np.array([3.1, 1, 1, 1])
    xs_j, us_j, nc_j = jrun(m.params, jnp.asarray(x0))
    xs_t, us_t, nc_t = trun(t.params, torch.as_tensor(x0))
    assert xs_t.shape == (4, 6, 4) and us_t.shape == (4, 5, 1)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=1e-8, atol=1e-8)
    np.testing.assert_array_equal(nc_t.numpy(), np.asarray(nc_j))


def test_receding_loop_needs_feature_spec(setup):
    jb, tb, m, t, active, common = setup
    cost = TQuad(tb.system, QD, 0.001 * np.eye(1), QD)
    with pytest.raises(ValueError, match="feature_spec"):
        t_loop(t.pred_core, cost, tb.dynamics, **common)
