"""The port's MPPI against the JAX package's, float64 on the CPU.

``jax.random`` cannot be matched bit for bit, so every standard-normal
draw of the port (``autompc_torch.control.mppi.standard_normal``, the
one function its controller, receding loop and fan-out draw through)
is replaced by the draw the JAX package takes at the same place of its
key chain: ``PRNGKey(seed)`` (``fold_in(lane)`` in the receding loop),
then one ``split`` for the initial sequence and one for each
perturbation draw (``jax_draws``).

- ``_do_rollouts`` given the perturbations and ``_update_sequence``:
  1e-12; a chain of three ``MPPI.step`` calls, ``niter`` 1 and 2: 1e-10;
- ``MPPIFactory``'s space: names, bounds and defaults exactly;
- the receding loop (3 lanes, 5 steps) against ``make_receding_mppi_loop``
  (1e-10) and against a host loop of the port's own controller pieces on
  the port's own draws (1e-12);
- ``MPPIFanout``, with and without the GaussReg term: 1e-8; a batch
  without ``regw`` raises; ``mesh`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.control import MPPI as TMPPI
from autompc_torch.control import MPPIFactory as TMPPIFactory
from autompc_torch.control import make_receding_mppi_loop as t_loop
from autompc_torch.control import mppi as tmppi
from autompc_torch.core.trajectory import zeros as tzeros
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.parallel import MPPIFanout as TFanout
from autompc_torch.sysid import SINDy as TSINDy
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.control.mppi import MPPI as JMPPI
from autompc_tpu.control.mppi import MPPIFactory as JMPPIFactory
from autompc_tpu.control.receding import make_receding_mppi_loop as j_loop
from autompc_tpu.core.trajectory import zeros as jzeros
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.parallel.fanout import MPPIFanout as JFanout
from autompc_tpu.sysid import SINDy

torch.set_num_threads(1)

SINDY_KW = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
                trig_interaction=True)
QD = np.diag([10.0, 0.1, 0.01, 0.01])
H, P = 6, 16


def jax_draw(shape, stream, lane=None):
    """The JAX package's standard normals of draw ``n`` of the chain of
    ``seed``: PRNGKey(seed) (fold_in(lane)), then n + 1 splits, the last
    subkey drawn."""
    seed, n = stream
    key = jax.random.PRNGKey(int(seed))
    if lane is not None:
        key = jax.random.fold_in(key, lane)
    for _ in range(int(n) + 1):
        key, sub = jax.random.split(key)
    return np.array(jax.random.normal(sub, tuple(shape)))


def jax_normal(shape, stream, like, lanes=None):
    """``standard_normal`` with the JAX package's draws."""
    z = (jax_draw(shape, stream) if lanes is None
         else np.stack([jax_draw(shape, stream, b) for b in range(lanes)]))
    return torch.as_tensor(z, dtype=like.dtype, device=like.device)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tmppi, "standard_normal", jax_normal)


def sindy_pair(n_trajs=20, traj_len=50):
    """A SINDy model trained by the port and the JAX package's copy of it
    (the fit is the port's: tests/test_torch_sindy.py holds it against
    the JAX package's), with both benchmarks."""
    jb, tb = JBench(), TBench()
    t = TSINDy(tb.system, device="cpu", **SINDY_KW)
    t.train(tb.gen_trajs_batch(seed=42, n_trajs=n_trajs, traj_len=traj_len, device="cpu"))
    m = SINDy(jb.system, **SINDY_KW)
    m.set_parameters({"coeffs": t.coeffs.numpy()})
    return jb, tb, m, t


def quad_tasks(jb, tb, steps=None, init=None):
    """The benchmark task in both packages with the bench's quadratic
    cost."""
    out = []
    for bench, cls, eye, asa in ((jb, JQuad, jnp.eye, jnp.asarray),
                                 (tb, TQuad, np.eye, np.asarray)):
        task = bench.task.copy()
        task.set_cost(cls(bench.system, asa(QD), 0.001 * eye(1), asa(QD), goal=np.zeros(4)))
        if steps is not None:
            task.set_num_steps(steps)
        if init is not None:
            task.set_init_obs(init)
        out.append(task)
    return out


@pytest.fixture(scope="module")
def setup():
    jb, tb, m, t = sindy_pair()
    jtask, ttask = quad_tasks(jb, tb)
    return jb, tb, m, t, jtask, ttask


def test_factory_space_matches_jax():
    def hps(space):
        return [(h.name, type(h).__name__, h.lower, h.upper, h.default_value,
                 getattr(h, "log", False)) for h in space.get_hyperparameters()]

    tb, jb = TBench(), JBench()
    assert hps(TMPPIFactory(tb.system).get_configuration_space()) == \
        hps(JMPPIFactory(jb.system).get_configuration_space())


@pytest.mark.parametrize("sigma, lmda", [(1.0, 1.0), (0.6, 0.35)])
def test_rollouts_and_update_match_jax(setup, sigma, lmda):
    jb, tb, m, t, jtask, ttask = setup
    kw = dict(horizon=H, num_path=P, sigma=sigma, lmda=lmda)
    jc, tc = JMPPI(jb.system, jtask, m, **kw), TMPPI(tb.system, ttask, t, **kw)
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-1, 1, 4) * np.array([3.0, 1.0, 1.0, 1.0])
    seq = 0.3 * rng.standard_normal((H, 1))
    # Large draws so that the clipping at the bounds is exercised.
    eps = 30.0 * np.sqrt(sigma) * rng.standard_normal((H, P, 1))
    cj, ej = jc._do_rollouts(m.params, jnp.asarray(x0), jnp.asarray(seq), None,
                             eps=jnp.asarray(eps))
    ct, et = tc._do_rollouts(t.params, torch.as_tensor(x0), torch.as_tensor(seq), None,
                             eps=torch.as_tensor(eps))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-12, atol=1e-12)
    assert np.any(np.abs(np.asarray(ej) - eps) > 0), "no perturbation was clipped"
    sj = jc._update_sequence(jnp.asarray(seq), cj, ej)
    st = tc._update_sequence(torch.as_tensor(seq), ct, et)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("niter", [1, 2])
def test_step_chain_matches_jax(setup, jax_draws, niter):
    jb, tb, m, t, jtask, ttask = setup
    kw = dict(horizon=H, num_path=P, sigma=0.8, lmda=0.3, niter=niter, seed=3)
    jc, tc = JMPPI(jb.system, jtask, m, **kw), TMPPI(tb.system, ttask, t, **kw)
    js = jc.traj_to_state(jzeros(jb.system, 1))
    ts = tc.traj_to_state(tzeros(tb.system, 1, device="cpu"))
    np.testing.assert_allclose(ts["act_sequence"].numpy(), np.asarray(js["act_sequence"]),
                               rtol=1e-12, atol=1e-12)
    obs = np.array([3.1, 0.0, 0.0, 0.0])
    jstep = jax.jit(jc.step)
    for k in range(3):
        uj, js = jstep(js, jnp.asarray(obs))
        ut, ts = tc.run(ts, torch.as_tensor(obs))
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-10, atol=1e-10,
                                   err_msg=f"step {k}")
        np.testing.assert_allclose(ts["act_sequence"].numpy(), np.asarray(js["act_sequence"]),
                                   rtol=1e-10, atol=1e-10, err_msg=f"step {k}")
        obs = np.asarray(tb.dynamics(torch.as_tensor(obs), ut))
    assert ts["draws"] == 1 + 3 * niter


def test_receding_loop_matches_jax(setup, jax_draws):
    jb, tb, m, t, jtask, ttask = setup
    kw = dict(horizon=H, num_path=P, sigma=1.0, lmda=0.5)
    x0 = np.random.default_rng(1).uniform(-1, 1, (3, 4)) * np.array([2.0, 0.5, 0.5, 0.5])
    xs_j, us_j = jax.jit(j_loop(jb.system, jtask, m, jb.dynamics, n_steps=5, seed=3, **kw))(
        m.params, jnp.asarray(x0))
    xs_t, us_t = t_loop(tb.system, ttask, t, tb.dynamics, n_steps=5, seed=3, **kw)(
        t.params, torch.as_tensor(x0))
    assert xs_t.shape == (3, 6, 4) and us_t.shape == (3, 5, 1)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-10, atol=1e-10)


def test_receding_loop_matches_host_loop(setup):
    """The loop is a host loop of the controller's pieces, lane b on lane
    b's draws (the port's own generator)."""
    jb, tb, m, t, jtask, ttask = setup
    kw = dict(horizon=H, num_path=P, sigma=1.0, lmda=0.5)
    x0s = torch.as_tensor(np.random.default_rng(2).uniform(-1, 1, (2, 4)))
    xs_d, us_d = t_loop(tb.system, ttask, t, tb.dynamics, n_steps=4, seed=7, **kw)(t.params, x0s)
    c = TMPPI(tb.system, ttask, t, **kw)
    scale = c._scaling(x0s)[2]
    for b in range(2):
        seq = tmppi.standard_normal((H, 1), (7, 0), x0s, lanes=2)[b]
        x = x0s[b]
        for k in range(4):
            seq = torch.cat([seq[1:], seq[-1:]])
            eps = tmppi.standard_normal((H, P, 1), (7, k + 1), x0s, lanes=2)[b]
            costs, eps = c._do_rollouts(t.params, x, seq, None, eps=eps)
            seq = c._update_sequence(seq, costs, eps)
            u = seq[0] * scale
            x = tb.dynamics(x, u)
            np.testing.assert_allclose(us_d[b, k].numpy(), u.numpy(), rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(xs_d[b, k + 1].numpy(), x.numpy(), rtol=1e-12,
                                       atol=1e-12)


def _batch(B, seed, reg=False):
    rng = np.random.default_rng(seed)
    batch = {"Qdiag": 10 ** rng.uniform(-1, 1.5, (B, 4)), "Rdiag": 10 ** rng.uniform(-3, 0, (B, 1)),
             "Fdiag": 10 ** rng.uniform(-1, 1.5, (B, 4)), "sigma": rng.uniform(0.1, 2, B),
             "lmda": rng.uniform(0.1, 2, B)}
    if reg:
        batch["regw"] = 10 ** rng.uniform(-3, 2, B)
    return batch


@pytest.mark.parametrize("reg", [False, True])
def test_fanout_matches_jax(setup, jax_draws, reg):
    jb, tb, m, t, _, _ = setup
    jtask, ttask = quad_tasks(jb, tb, steps=7, init=np.array([0.4, 0.0, 0.0, 0.0]))
    S = np.linalg.inv(np.diag([1.0, 4.0, 2.0, 3.0]) + 0.1)
    rk = dict(reg_matrix=S, reg_goal=np.array([0.1, 0.0, -0.2, 0.0])) if reg else {}
    batch = _batch(4, 11 + reg, reg)
    cj = JFanout(jb.system, jtask, m, m, horizon=H, num_path=P, seed=2, **rk)(
        {k: jnp.asarray(v) for k, v in batch.items()})
    ct = TFanout(tb.system, ttask, t, t, horizon=H, num_path=P, seed=2, device="cpu", **rk)(batch)
    assert np.all(np.isfinite(np.asarray(cj)))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-8, atol=1e-8)


def test_fanout_lane_scores_as_the_sequential_controller(setup):
    """A fan-out lane draws the sequential controller's chain: B copies of
    one candidate score as that candidate's MPPI under a host loop."""
    from autompc_torch.utils.simulation import simulate

    jb, tb, m, t, _, _ = setup
    _, ttask = quad_tasks(jb, tb, steps=6, init=np.array([0.4, 0.0, 0.0, 0.0]))
    one = {k: v[:1] for k, v in _batch(1, 3).items()}
    ct = TFanout(tb.system, ttask, t, t, horizon=H, num_path=P, device="cpu")(
        {k: np.repeat(v, 3, axis=0) for k, v in one.items()})
    task = ttask.copy()
    task.set_cost(TQuad(tb.system, np.diag(one["Qdiag"][0]), np.diag(one["Rdiag"][0]),
                        np.diag(one["Fdiag"][0]), goal=np.zeros(4)))
    c = TMPPI(tb.system, task, t, horizon=H, num_path=P, sigma=float(one["sigma"][0]),
              lmda=float(one["lmda"][0]))
    traj = simulate(c, ttask.get_init_obs(), ttask.term_cond, sim_model=t, max_steps=6)
    seq = float(ttask.get_cost()(traj))
    np.testing.assert_allclose(ct.numpy(), np.full(3, seq), rtol=1e-9)


def test_fanout_needs_regw_and_refuses_mesh(setup):
    jb, tb, m, t, _, ttask = setup
    fan = TFanout(tb.system, ttask, t, t, horizon=H, num_path=P, n_steps=2, device="cpu",
                  reg_matrix=np.eye(4))
    with pytest.raises(ValueError, match="regw"):
        fan(_batch(2, 0))
    with pytest.raises(ValueError, match="mesh"):
        TFanout(tb.system, ttask, t, t, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        TMPPI(tb.system, ttask, t, mesh=object())
