"""The port's direct transcription against the JAX package's, float64 on
the CPU:

- ``qp_backward``, ``qp_forward`` and ``solve_traj_qp`` against the JAX
  functions vmapped over the lanes (1e-12) and against a dense KKT solve;
  every step size at once equals one call a step size;
- ``make_sqp_solver`` at H=6 on the cartpole SINDy model, with and
  without observation bounds (the augmented Lagrangian): 1e-9;
- ``DirectTranscriptionController.set_guess`` with and without
  ``xs_guess`` (the controller with the task's observation bounds:
  tests/test_torch_controller_tune.py);
- ``DirectTranscriptionFanout`` with observation bounds and the GaussReg
  term: 1e-8 (the receding SQP loop: tests/test_torch_controller_tune.py);
- ``qp_backward_assoc`` (``backward="assoc"``, against the JAX package in
  tests/test_torch_solver_options.py) equals ``qp_backward`` with Cux = 0
  (1e-9), and an unknown ``backward`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.control import DirectTranscriptionController as TDT
from autompc_torch.control import DirectTranscriptionControllerFactory as TDTFactory
from autompc_torch.control.nmpc import make_sqp_solver as t_sqp
from autompc_torch.core import System as TSystem
from autompc_torch.core import Task as TTask
from autompc_torch.core.trajectory import zeros as tzeros
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.ops import trajqp as tqp
from autompc_torch.parallel import DirectTranscriptionFanout as TFanout
from autompc_torch.sysid.model import Model as TModel
from autompc_tpu.control.nmpc import DirectTranscriptionController as JDT
from autompc_tpu.control.nmpc import DirectTranscriptionControllerFactory as JDTFactory
from autompc_tpu.control.nmpc import make_sqp_solver as j_sqp
from autompc_tpu.core.system import System as JSystem
from autompc_tpu.core.task import Task as JTask
from autompc_tpu.core.trajectory import zeros as jzeros
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.ops import trajqp as jqp
from autompc_tpu.parallel.fanout import DirectTranscriptionFanout as JFanout
from autompc_tpu.sysid.dummy import DummyLinear
from test_torch_mppi import quad_tasks, sindy_pair

torch.set_num_threads(1)

# The double integrator of tests/test_nmpc_state_bounds.py.
DT = 0.1
A = np.array([[1.0, DT], [0.0, 1.0]])
B = np.array([[0.0], [DT]])
Q, R, F = np.diag([4.0, 0.01]), np.array([[0.01]]), np.diag([40.0, 1.0])
GOAL, X0, UB, VEL_CAP = np.array([1.5, 0.0]), np.array([0.0, 0.0]), 50.0, 0.45


class TLinear(TModel):
    """x' = A x + B u (the JAX package's DummyLinear)."""

    def __init__(self, system, A, B):
        super().__init__(system)
        self.A, self.B = torch.as_tensor(A), torch.as_tensor(B)

    @property
    def state_dim(self):
        return self.system.obs_dim

    @property
    def params(self):
        return {}

    def traj_to_state(self, traj):
        return traj[-1].obs

    def pred_core(self, params, state, ctrl):
        return state @ self.A.T + ctrl @ self.B.T


def integrator(bounded, steps=None):
    """(JAX model, task; port model, task) of the double integrator, its
    velocity capped when ``bounded``."""
    out = []
    for Sys, Task, Quad, model in ((JSystem, JTask, JQuad, lambda s: DummyLinear(s, A, B)),
                                   (TSystem, TTask, TQuad, lambda s: TLinear(s, A, B))):
        system = Sys(["pos", "vel"], ["acc"], dt=DT)
        task = Task(system)
        task.set_ctrl_bounds(np.array([-UB]), np.array([UB]))
        if bounded:
            task.set_obs_bound("vel", -np.inf, VEL_CAP)
        task.set_cost(Quad(system, Q, R, F, goal=GOAL))
        task.set_init_obs(X0)
        if steps is not None:
            task.set_num_steps(steps)
        out += [model(system), task]
    return out


@pytest.fixture(scope="module")
def setup():
    return sindy_pair()


def _qp_data(rng, Bn, H, ds, dc):
    M = rng.normal(size=(Bn, H, ds, ds))
    Cxx = np.eye(ds) + 0.1 * M @ M.transpose(0, 1, 3, 2)
    return dict(
        A_seq=0.5 * rng.normal(size=(Bn, H, ds, ds)), B_seq=rng.normal(size=(Bn, H, ds, dc)),
        Cxx=Cxx, Cuu=np.broadcast_to(np.eye(dc), (Bn, H, dc, dc)).copy(),
        Cux=0.1 * rng.normal(size=(Bn, H, dc, ds)), cx=rng.normal(size=(Bn, H, ds)),
        cu=rng.normal(size=(Bn, H, dc)), d_seq=0.1 * rng.normal(size=(Bn, H, ds)),
        Vf=np.broadcast_to(2 * np.eye(ds), (Bn, ds, ds)).copy(), vf=rng.normal(size=(Bn, ds)))


@pytest.mark.parametrize("dc", [1, 3])
def test_traj_qp_matches_jax(dc):
    d = _qp_data(np.random.default_rng(dc), 3, 5, 3, dc)
    td = {k: torch.as_tensor(v) for k, v in d.items()}
    fw = ("A_seq", "B_seq", "d_seq")

    def jax_side(*args):
        dd = dict(zip(d, args))
        back = jqp.qp_backward(*args, reg=1e-8)
        fwd = jqp.qp_forward(*(dd[k] for k in fw), back[0], back[1], alpha=0.25)
        return back, fwd, jqp.solve_traj_qp(*args)

    jb, jf, js = jax.jit(jax.vmap(jax_side))(*(jnp.asarray(v) for v in d.values()))
    tb = tqp.qp_backward(*td.values(), reg=1e-8)
    tf = tqp.qp_forward(*(td[k] for k in fw), tb[0], tb[1], alpha=0.25)
    ts = tqp.solve_traj_qp(*td.values())
    for a, b in zip(tb + tf + ts, jb + jf + js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    # Every step size at once == one call a step size.
    alphas = torch.tensor([1.0, 0.5, 0.125])
    dxs, dus = tqp.qp_forward(*(td[k] for k in fw), tb[0], tb[1], alpha=alphas)
    for j, a in enumerate(alphas.tolist()):
        ref = tqp.qp_forward(*(td[k] for k in fw), tb[0], tb[1], alpha=a)
        np.testing.assert_allclose(dxs[:, j].numpy(), ref[0].numpy(), rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(dus[:, j].numpy(), ref[1].numpy(), rtol=1e-13, atol=1e-13)


def test_traj_qp_matches_dense_kkt():
    """The structured solve is the dense KKT system's solution
    (tests/test_koopman_dt.py's construction, Cux = 0, reg = 0)."""
    H, ds, dc = 5, 3, 2
    d = _qp_data(np.random.default_rng(11), 2, H, ds, dc)
    d["Cux"] = np.zeros_like(d["Cux"])
    dxs, dus = tqp.solve_traj_qp(*(torch.as_tensor(v) for v in d.values()), reg=0.0)
    nx, nu = H * ds, H * dc
    for b in range(2):
        Hm, g = np.zeros((nx + nu, nx + nu)), np.zeros(nx + nu)
        C, r = np.zeros((nx, nx + nu)), np.zeros(nx)
        for t in range(H):
            xs_, us_ = slice(t * ds, (t + 1) * ds), slice(nx + t * dc, nx + (t + 1) * dc)
            Hm[xs_, xs_] = d["Cxx"][b, t + 1] if t < H - 1 else d["Vf"][b]
            g[xs_] = d["cx"][b, t + 1] if t < H - 1 else d["vf"][b]
            Hm[us_, us_] = d["Cuu"][b, t]
            g[us_] = d["cu"][b, t]
            C[xs_, xs_] = -np.eye(ds)
            if t > 0:
                C[xs_, (t - 1) * ds:t * ds] = d["A_seq"][b, t]
            C[xs_, us_] = d["B_seq"][b, t]
            r[xs_] = -d["d_seq"][b, t]
        sol = np.linalg.solve(np.block([[Hm, C.T], [C, np.zeros((nx, nx))]]),
                              np.concatenate([-g, r]))
        np.testing.assert_allclose(dxs[b, 1:].numpy(), sol[:nx].reshape(H, ds), rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(dus[b].numpy(), sol[nx:nx + nu].reshape(H, dc), rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_array_equal(dxs[b, 0].numpy(), np.zeros(ds))


@pytest.mark.parametrize("bounded", [False, True])
def test_sqp_solver_matches_jax(setup, bounded):
    jb, tb, m, t = setup
    jtask, ttask = quad_tasks(jb, tb)
    bounds = ttask.get_ctrl_bounds()
    xb = (np.array([-np.inf, -np.inf, -0.02, -np.inf]), np.array([np.inf, 1.0, np.inf, np.inf]))
    kw = dict(H=6, ds=4, dc=1, obsdim=4, dt=tb.system.dt, ubounds=(bounds[:, 0], bounds[:, 1]),
              xbounds=xb if bounded else None)
    jsolve = jax.jit(j_sqp(m.pred_core, jtask.get_cost(), **kw))
    tsolve = t_sqp(t.pred_core, ttask.get_cost(), **kw)
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-1, 1, (3, 4)) * np.array([3.0, 1.0, 0.3, 0.3])
    usg = rng.normal(size=(3, 6, 1))
    xs_t, us_t, steps = tsolve(t.params, torch.as_tensor(x0), torch.zeros(3, 7, 4),
                               torch.as_tensor(usg), steps=True)
    for b in range(3):
        xs_j, us_j = jsolve(m.params, jnp.asarray(x0[b]), jnp.zeros((7, 4)), jnp.asarray(usg[b]))
        np.testing.assert_allclose(us_t[b].numpy(), np.asarray(us_j), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(xs_t[b].numpy(), np.asarray(xs_j), rtol=1e-9, atol=1e-9)
    assert steps.shape == (3, 10) and (steps >= -1).all() and (steps < 8).all()
    if bounded:
        # The bounds bind: the plan moves the cart less than unbounded.
        xs_u, _ = t_sqp(t.pred_core, ttask.get_cost(), **dict(kw, xbounds=None))(
            t.params, torch.as_tensor(x0), torch.zeros(3, 7, 4), torch.as_tensor(usg))
        assert not torch.allclose(xs_u, xs_t)


def test_set_guess():
    """With ``us_guess`` alone the states are the model rolled forward
    from the model state (the JAX package's, which rounds the guesses to
    float32: values held at float32's precision); a given ``xs_guess`` is
    taken as it is, and the next step solves from the guesses."""
    jm, jtask, tm, ttask = integrator(bounded=False)
    jc, tc = JDT(jm.system, jtask, jm, horizon=0.5), TDT(tm.system, ttask, tm, horizon=0.5)
    us = np.linspace(-2.0, 2.0, 5)[:, None]
    js = jc.set_guess(jc.traj_to_state(jzeros(jm.system, 1)), jnp.asarray(us))
    ts = tc.set_guess(tc.traj_to_state(tzeros(tm.system, 1, device="cpu")), us)
    np.testing.assert_array_equal(ts["us_guess"].numpy(), us)
    np.testing.assert_allclose(ts["xs_guess"].numpy(), np.asarray(js["xs_guess"]), rtol=1e-6,
                               atol=1e-7)
    xs = np.random.default_rng(0).normal(size=(6, 2))
    ts2 = tc.set_guess(ts, us, xs_guess=xs)
    np.testing.assert_array_equal(ts2["xs_guess"].numpy(), xs)
    u, _ = tc.step(ts2, torch.as_tensor(X0))
    _, us_s = tc._solve({}, torch.as_tensor(X0)[None], torch.as_tensor(xs)[None],
                        torch.as_tensor(us)[None])
    np.testing.assert_array_equal(u.numpy(), us_s[0, 0].numpy())


def test_fanout_with_obs_bounds_and_gauss_reg_matches_jax():
    """The task's observation bounds and the GaussReg term reach the
    fan-out's solver: the bounded task scores as the JAX package's, and
    otherwise than the unbounded one; a batch without ``regw`` raises."""
    rng = np.random.default_rng(4)
    batch = {"Qdiag": np.diag(Q) * 10 ** rng.uniform(-0.5, 0.5, (3, 2)),
             "Rdiag": np.diag(R) * 10 ** rng.uniform(-0.5, 0.5, (3, 1)),
             "Fdiag": np.diag(F) * 10 ** rng.uniform(-0.5, 0.5, (3, 2)),
             "regw": 10 ** rng.uniform(-3, 0, 3)}
    rk = dict(reg_matrix=np.array([[2.0, 0.3], [0.3, 1.0]]), reg_goal=np.array([0.5, 0.1]))
    jm, jtask, tm, ttask = integrator(True, steps=4)
    cj = JFanout(jm.system, jtask, jm, jm, horizon_knots=6, **rk)(
        {k: jnp.asarray(v) for k, v in batch.items()})
    ct = TFanout(tm.system, ttask, tm, tm, horizon_knots=6, device="cpu", **rk)(batch)
    assert np.all(np.isfinite(np.asarray(cj)))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-8, atol=1e-8)
    _, _, tm, ttask = integrator(False, steps=4)
    fan = TFanout(tm.system, ttask, tm, tm, horizon_knots=6, device="cpu", **rk)
    assert np.all(np.abs(ct.numpy() - fan(batch).numpy()) > 1e-6)
    with pytest.raises(ValueError, match="regw"):
        fan({k: v for k, v in batch.items() if k != "regw"})


def test_factory_and_refusals(setup):
    jb, tb, m, t = setup
    def hps(space):
        return [(h.name, h.lower, h.upper, h.default_value) for h in space.get_hyperparameters()]

    assert hps(TDTFactory(tb.system).get_configuration_space()) == \
        hps(JDTFactory(jb.system).get_configuration_space())
    _, ttask = quad_tasks(jb, tb)
    with pytest.raises(ValueError, match="backward"):
        t_sqp(t.pred_core, ttask.get_cost(), H=4, ds=4, dc=1, obsdim=4, dt=0.05,
              ubounds=None, backward="bogus")
    # The associative-scan factorization is the sequential one's.
    d = _qp_data(np.random.default_rng(4), 2, 5, 3, 2)
    d["Cux"] = np.zeros_like(d["Cux"])
    td = [torch.as_tensor(v) for v in d.values()]
    for a, b in zip(tqp.qp_backward_assoc(*td, 1e-6), tqp.qp_backward(*td, 1e-6)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-9)
    with pytest.raises(ValueError, match="mesh"):
        TFanout(tb.system, ttask, t, t, mesh=object(), device="cpu")
