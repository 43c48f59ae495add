"""The port's scheduled lanes-last iLQR solver vs the JAX package's
make_scheduled_ilqr_solver(lanes_last=True, pallas_interpret=True), in
the setup of tests/test_lanes_last.py, float64: converged flags equal,
xs/us/Ks/ks to 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.control import ilqr as tilqr
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.sysid import SINDy as TSINDy
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.control import ilqr as jilqr
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.sysid import SINDy

QD = np.diag([10.0, 0.1, 0.01, 0.01])


@pytest.fixture(scope="module")
def setup():
    b = CartpoleSwingupBenchmark()
    kw = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
              trig_interaction=True)
    m = SINDy(b.system, **kw)
    m.train(b.gen_trajs_batch(seed=42, n_trajs=60, traj_len=80))
    t = TSINDy(b.system, device="cpu", **kw)
    t.set_parameters({**m.get_parameters(), "feature_names": m.get_feature_names()})
    jcost = JQuad(b.system, jnp.asarray(QD), 0.001 * jnp.eye(1), jnp.asarray(QD),
                  goal=jnp.zeros(4))
    tcost = TQuad(b.system, QD, 0.001 * np.eye(1), QD, goal=np.zeros(4))
    bounds = b.task.get_ctrl_bounds()
    active = tuple(int(k) for k in np.flatnonzero(np.any(np.asarray(m.coeffs) != 0, axis=0)))
    common = dict(H=8, ds=4, dc=1, obsdim=4, dt=b.system.dt,
                  ubounds=(bounds[:, 0], bounds[:, 1]), max_iter=10,
                  backward="pallas", fuse_ls=True, lanes_last=True,
                  feature_mask=active)
    return m, t, jcost, tcost, common


def _jax_solver(setup, make, **kw):
    m, _, jcost, _, common = setup
    return jax.jit(make(m.pred_core, jcost, feature_spec=(m.library, "coeffs"),
                        pallas_interpret=True, **common, **kw))


def _torch_solver(setup, make, **kw):
    _, t, _, tcost, common = setup
    return make(t.pred_core, tcost, feature_spec=(t.library, "coeffs"), **common, **kw)


def _check(out_t, out_j):
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    for i, name in zip((1, 2, 3, 4), ("xs", "us", "Ks", "ks")):
        np.testing.assert_allclose(out_t[i].numpy(), np.asarray(out_j[i]),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


def test_scheduled_solver_matches_jax(setup):
    m, t = setup[0], setup[1]
    sched = dict(schedule=((3, 0.5),))
    jsolve = _jax_solver(setup, jilqr.make_scheduled_ilqr_solver, **sched)
    tsolve = _torch_solver(setup, tilqr.make_scheduled_ilqr_solver, **sched)
    rng = np.random.default_rng(6)
    x0 = rng.uniform(-1, 1, (8, 4))
    out_j = jsolve(m.params, jnp.asarray(x0), jnp.zeros((8, 8, 1)))
    out_t = tsolve(t.params, torch.as_tensor(x0), torch.zeros((8, 8, 1), dtype=torch.float64))
    _check(out_t, out_j)
    assert out_t[0].any()


def test_batched_solver_matches_jax_from_swingup_starts(setup):
    """Far-from-goal starts (the bench's x0 distribution), warm
    controls, no compaction."""
    m, t = setup[0], setup[1]
    jsolve = _jax_solver(setup, jilqr.make_batched_ilqr_solver)
    tsolve = _torch_solver(setup, tilqr.make_batched_ilqr_solver)
    rng = np.random.default_rng(8)
    x0 = rng.uniform(-1, 1, (6, 4)) * np.array([3.1, 1.0, 1.0, 1.0])
    ug = rng.uniform(-1, 1, (6, 8, 1))
    out_j = jsolve(m.params, jnp.asarray(x0), jnp.asarray(ug))
    out_t = tsolve(t.params, torch.as_tensor(x0), torch.as_tensor(ug))
    _check(out_t, out_j)


def test_scheduled_equals_batched_in_port(setup):
    t = setup[1]
    batched = _torch_solver(setup, tilqr.make_batched_ilqr_solver)
    rng = np.random.default_rng(9)
    x0 = torch.as_tensor(rng.uniform(-1, 1, (10, 4)))
    ug = torch.zeros((10, 8, 1), dtype=torch.float64)
    ref = batched(t.params, x0, ug)
    for sched in (((2, 0.5), (4, 0.3)), ((1, 0.1),), ((3, 0.6), (5, 0.5), (7, 0.2))):
        out = _torch_solver(setup, tilqr.make_scheduled_ilqr_solver, schedule=sched)(
            t.params, x0, ug)
        np.testing.assert_array_equal(out[0].numpy(), ref[0].numpy())
        for i in (1, 2, 3, 4):
            np.testing.assert_allclose(out[i].numpy(), ref[i].numpy(), rtol=1e-12, atol=1e-12)


def test_parse_schedule_matches():
    for s in ("8:0.75,15:0.5,22:0.25,30:0.125,40:0.0625", "20:0.5", ""):
        assert tilqr.parse_schedule(s) == jilqr.parse_schedule(s)
    with pytest.raises(ValueError):
        tilqr.parse_schedule("3:1.5")


@pytest.mark.parametrize("option, value, match", [
    ("lanes_last", False, "batch-major"),
    ("horizon_mask", True, "horizon_mask"),
    ("pad_to", 64, "pad_to"),
    ("batch_params", True, "batch_params"),
    ("feature_mask", (), "masks out every feature"),
    ("reg_matrix", np.eye(4), "reg_matrix"),
    ("mlp_ls", object(), "mlp_ls"),
    ("analytic_jac", True, "analytic_jac"),
    ("jac_dtype", "f16", "jac_dtype must be"),
    ("dc", 2, "dc > 1"),
    ("backward", "scan", "backward"),
    ("relin", "xla", "relin"),
    ("fuse_ls", False, "fuse_ls"),
])
def test_unported_options_raise(setup, option, value, match):
    _, t, _, tcost, common = setup
    kw = dict(common, feature_spec=(t.library, "coeffs"))
    kw[option] = value
    # pad_to belongs to JointMLPQuadCostFanout, not to the solver (as in
    # the JAX package): the solver does not take the keyword.
    with pytest.raises(TypeError if option == "pad_to" else ValueError, match=match):
        tilqr.make_batched_ilqr_solver(t.pred_core, tcost, **kw)


def test_non_diagonal_cost_raises(setup):
    _, t, _, _, common = setup
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TB

    Qf = QD + 0.1 * np.ones((4, 4))
    cost = TQuad(TB().system, Qf, np.eye(1), Qf)
    with pytest.raises(ValueError, match="diagonal"):
        tilqr.make_batched_ilqr_solver(t.pred_core, cost,
                                       feature_spec=(t.library, "coeffs"), **common)
