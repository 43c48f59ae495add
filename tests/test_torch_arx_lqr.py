"""The port's ARX model, LQR pieces and controllers, Model API and stand-in
models against the JAX package's, float64 on the CPU (BASELINE.json
configs[0], ARX + QuadCost + LQR):

- ARX features, fit, companion (A, B), state handling and pred_diff
  (1e-10), the closed-form Jacobian against the port's jacfwd;
- the public Model API (pred, pred_batch, pred_diff, pred_diff_batch,
  update_state, state_to_obs, is_linear, is_diff) on ARX, SINDy and MLP;
- dynamic_riccati_step, lqr_gain, finite_horizon_lqr and
  infinite_horizon_lqr, FiniteHorizonLQR and InfiniteHorizonLQR against
  JAX and the numpy Riccati of tests/test_slice_arx_lqr.py (1e-10);
- a 60-step LQR closed loop on the true cartpole against JAX's simulate
  (1e-9), and the 200-step stabilization gate of the slice test;
- LQRFactory's space; DummyLinear, DummyNonlinear and LinearizedModel.

The data are made once by the port (CPU) and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch import from_arrays as t_from_arrays
from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.benchmarks.data_generation import uniform_random_generate_batch
from autompc_torch.control import FiniteHorizonLQR as TFinite
from autompc_torch.control import InfiniteHorizonLQR as TInfinite
from autompc_torch.control import LQRFactory as TLQRFactory
from autompc_torch.control.ilqr import jacfwd_pred_diff
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.ops import riccati as triccati
from autompc_torch.sysid import ARX as TARX
from autompc_torch.sysid import ARXFactory as TARXFactory
from autompc_torch.sysid import DummyLinear as TDummyLinear
from autompc_torch.sysid import DummyNonlinear as TDummyNonlinear
from autompc_torch.sysid import LinearizedModel as TLinearized
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.utils.simulation import simulate as t_simulate
from autompc_tpu import from_arrays as j_from_arrays
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.control import FiniteHorizonLQR as JFinite
from autompc_tpu.control import InfiniteHorizonLQR as JInfinite
from autompc_tpu.control import LQRFactory as JLQRFactory
from autompc_tpu.core.trajectory import TrajectoryBatch as JTB
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.ops import riccati as jriccati
from autompc_tpu.sysid import ARX as JARX
from autompc_tpu.sysid import SINDy as JSINDy
from autompc_tpu.sysid.dummy import DummyLinear as JDummyLinear
from autompc_tpu.sysid.dummy import DummyNonlinear as JDummyNonlinear
from autompc_tpu.sysid.dummy import LinearizedModel as JLinearized
from autompc_tpu.utils import simulate as j_simulate
from test_slice_arx_lqr import np_finite_lqr, np_riccati
from test_torch_mlp import _pair as mlp_pair

torch.set_num_threads(1)

TOL = 1e-10


def close(a, b, tol=TOL):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def jax_batch(jb, tt):
    return JTB(jb.system, tt.obs.numpy(), tt.ctrls.numpy(), tt.lengths.numpy())


@pytest.fixture(scope="module")
def data():
    jb, tb = JBench(), TBench()
    tt = tb.gen_trajs_batch(seed=42, n_trajs=20, traj_len=60, device="cpu")
    return jb, tb, tt, jax_batch(jb, tt)


_PAIRS = {}


def arx_pair(data, history):
    """(JAX ARX, port ARX) trained on ``data``, once per history (the
    tests only read them)."""
    key = (id(data), history)
    if key not in _PAIRS:
        jb, tb, tt, jt = data
        t = TARX(tb.system, history=history, device="cpu")
        t.train(tt)
        j = JARX(jb.system, history=history)
        j.train(jt)
        _PAIRS[key] = j, t
    return _PAIRS[key]


@pytest.mark.parametrize("history", [1, 2, 4])
def test_arx_fit_and_companion_match(data, history):
    j, t = arx_pair(data, history)
    assert t.state_dim == j.state_dim == 4 + (history - 1) * 5 + 1
    close(t.coeffs, j.coeffs)
    close(t.A, j.A)
    close(t.B, j.B)
    assert t.is_linear and t.is_diff and j.is_linear


@pytest.mark.parametrize("history", [1, 3])
def test_arx_features_and_state_handling_match(data, history):
    j, t = arx_pair(data, history)
    tr = data[2][0]
    jtr = data[3][0]
    # Whole trajectories, and histories shorter than the window.
    for T in (tr.size, 2):
        close(t._all_features(tr.obs[:T], tr.ctrls[:T]),
              j._all_features(jtr.obs[:T], jtr.ctrls[:T]))
    close(t.traj_to_states(tr), j.traj_to_states(jtr))
    close(t.traj_to_state(tr[:10]), j.traj_to_state(jtr[:10]))
    s = t.traj_to_state(tr[:10])
    close(t.update_state(s, tr.ctrls[9], tr.obs[10]), t.traj_to_state(tr[:11]))
    close(t.update_state(s, tr.ctrls[9], tr.obs[10]),
          j.update_state(jnp.asarray(s.numpy()), jtr.ctrls[9], jtr.obs[10]))
    # Batched over a leading axis (the fan-out's (B, ds) states).
    S = t.traj_to_states(tr)[:-1]
    got = t.update_state_core(t.params, S, tr.ctrls[:-1], tr.obs[1:])
    close(got, t.traj_to_states(tr)[1:])
    close(t.state_to_obs(s), tr.obs[9])


def test_arx_pred_diff_is_closed_form(data):
    j, t = arx_pair(data, 2)
    tr, jtr = data[2][0], data[3][0]
    s, u = t.traj_to_state(tr[:5]), torch.ones(1, dtype=torch.float64)
    pt, jxt, jut = t.pred_diff(s, u)
    pj, jxj, juj = j.pred_diff(jnp.asarray(s.numpy()), jnp.ones(1))
    close(pt, pj)
    close(jxt, jxj)
    close(jut, juj)
    S, U = t.traj_to_states(tr), tr.ctrls
    P, Jx, Ju = t.pred_diff_batch(S, U)
    Pj, Jxj, Juj = j.pred_diff_batch(jnp.asarray(S.numpy()), jtr.ctrls)
    close(P, Pj)
    close(Jx, Jxj)
    close(Ju, Juj)
    # The closed form equals the port's autodiff of pred_core.
    auto = jacfwd_pred_diff(t.pred_core, t.state_dim)(t.params, S, U)
    for a, b in zip((P, Jx, Ju), auto):
        close(a, b.numpy())
    assert Jx.is_contiguous() and Ju.is_contiguous()


def test_arx_parameters_cross_and_factory(data):
    j, t = arx_pair(data, 3)
    t2 = TARX(t.system, history=3, device="cpu")
    t2.set_parameters(j.get_parameters())
    close(t2.A, j.A)
    close(t2.coeffs, j.coeffs)
    cs = TARXFactory(t.system).get_configuration_space()
    cfg = cs.get_default_configuration()
    assert cfg["history"] == 4
    m = TARXFactory(t.system, device="cpu")(cfg, data[2])
    assert m.k == 4 and m.A.shape == (m.state_dim, m.state_dim)


def test_from_arrays_matches():
    jb, tb = JBench(), TBench()
    rng = np.random.default_rng(0)
    obs, ctrls = rng.normal(size=(7, 4)), rng.normal(size=(7, 1))
    t, j = t_from_arrays(tb.system, obs, ctrls), j_from_arrays(jb.system, obs, ctrls)
    assert t.size == j.size == 7
    close(t.obs, j.obs)
    close(t.ctrls, j.ctrls)


def _sindy_pair(data):
    jb, tb, tt, _ = data
    kw = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1)
    t = TSINDy(tb.system, device="cpu", **kw)
    t.train(tt)
    j = JSINDy(jb.system, **kw)
    j.set_parameters({"coeffs": t.coeffs.numpy()})
    return j, t


@pytest.mark.parametrize("which", ["ARX", "SINDy", "MLP"])
def test_model_api_matches(data, which):
    if which == "ARX":
        j, t = arx_pair(data, 2)
    elif which == "SINDy":
        j, t = _sindy_pair(data)
    else:
        j, t = mlp_pair("tanh", 2)
    rng = np.random.default_rng(3)
    ds, dc = t.state_dim, t.system.ctrl_dim
    S, U = rng.normal(size=(6, ds)) * 0.5, rng.normal(size=(6, dc))
    T = torch.as_tensor
    # JAX's batched methods (its single-point ones are their vmapped
    # bodies); the port's single-point ones against its batched ones.
    jb_ = jax.jit(lambda S, U: j.pred_diff_batch(S, U))(S, U)
    close(t.pred_batch(T(S), T(U)), jb_[0])
    close(t.pred(T(S[0]), T(U[0])), jb_[0][0])
    for a, b in zip(t.pred_diff_batch(T(S), T(U)), jb_):
        close(a, b)
    for a, b in zip(t.pred_diff(T(S[0]), T(U[0])), jb_):
        close(a, b[0])
    n = t.system.obs_dim
    obs = rng.normal(size=n)
    close(t.update_state(T(S[0]), T(U[0]), T(obs)), j.update_state(S[0], U[0], obs))
    close(t.state_to_obs(T(S[0])), j.state_to_obs(jnp.asarray(S[0])))
    assert (t.is_linear, t.is_diff) == (j.is_linear, j.is_diff) == (which == "ARX", True)


# ---- LQR ----------------------------------------------------------------


def _lqr_problem(seed, ds=6, dc=2):
    rng = np.random.default_rng(seed)
    A = np.eye(ds) + 0.1 * rng.normal(size=(ds, ds))
    B = rng.normal(size=(ds, dc))
    M = rng.normal(size=(ds, ds))
    Q = M @ M.T + np.eye(ds)
    R = np.diag(rng.uniform(0.1, 1.0, dc))
    N = 0.05 * rng.normal(size=(ds, dc))
    F = np.diag(rng.uniform(0.5, 2.0, ds))
    return A, B, Q, R, N, F


@pytest.mark.parametrize("seed", [0, 1])
def test_riccati_pieces_match_jax_and_numpy(seed):
    A, B, Q, R, N, F = _lqr_problem(seed)
    T, J = torch.as_tensor, jnp.asarray
    close(triccati.dynamic_riccati_step(T(F), T(A), T(B), T(Q), T(R), T(N)),
          np_riccati(A, B, Q, R, N, F))
    close(triccati.dynamic_riccati_step(T(F), T(A), T(B), T(Q), T(R), T(N)),
          jriccati.dynamic_riccati_step(J(F), J(A), J(B), J(Q), J(R), J(N)))
    close(triccati.lqr_gain(T(A), T(B), T(F), T(R), T(N)),
          jriccati.lqr_gain(J(A), J(B), J(F), J(R), J(N)))
    close(triccati.lqr_gain(T(A), T(B), T(F), T(R)), jriccati.lqr_gain(J(A), J(B), J(F), J(R)))
    for H in (0, 7, 30):
        K, P = triccati.finite_horizon_lqr(T(A), T(B), T(Q), T(R), T(N), T(F), H)
        Kj, Pj = jriccati.finite_horizon_lqr(J(A), J(B), J(Q), J(R), J(N), J(F), H)
        close(K, Kj)
        close(P, Pj)
        if not N.any():
            close(K, np_finite_lqr(A, B, Q, R, N, F, H))
    close(triccati.finite_horizon_lqr(T(A), T(B), T(Q), T(R), T(0 * N), T(F), 12)[0],
          np_finite_lqr(A, B, Q, R, 0 * N, F, 12))
    # A stable closed loop: the fixed point and its stopping rule.
    A = A / (1.1 * np.abs(np.linalg.eigvals(A)).max())
    for thr in (1e-3, 1e-9):
        K, P = triccati.infinite_horizon_lqr(T(A), T(B), T(Q), T(R), threshold=thr)
        Kj, Pj = jriccati.infinite_horizon_lqr(J(A), J(B), J(Q), J(R), threshold=thr)
        close(K, Kj)
        close(P, Pj)


def _tasks(jb, tb, Q, R, F):
    out = []
    for bench, cls, asa in ((jb, JQuad, jnp.asarray), (tb, TQuad, np.asarray)):
        task = bench.task.copy()
        task.set_cost(cls(bench.system, asa(Q), asa(R), asa(F), goal=np.zeros(4)))
        out.append(task)
    return out


def test_lqr_controllers_match_jax_and_numpy(data):
    j, t = arx_pair(data, 2)
    jb, tb = data[0], data[1]
    Q, R, F = np.diag([10.0, 1.0, 1.0, 1.0]), 0.1 * np.eye(1), np.eye(4)
    jtask, ttask = _tasks(jb, tb, Q, R, F)
    for H in (1, 50):
        ct, cj = TFinite(tb.system, ttask, t, horizon=H), JFinite(jb.system, jtask, j, horizon=H)
        close(ct.K, cj.K)
        ds = t.state_dim
        Qp, Fp = np.zeros((ds, ds)), np.zeros((ds, ds))
        Qp[:4, :4], Fp[:4, :4] = Q, F
        close(ct.K, np_finite_lqr(t.A.numpy(), t.B.numpy(), Qp, R, np.zeros((ds, 1)), Fp, H))
    ti, ji = TInfinite(tb.system, ttask, t), JInfinite(jb.system, jtask, j)
    close(ti.K, ji.K)
    # One step of each from the same history.
    tr, jtr = data[2][0][:6], data[3][0][:6]
    for con_t, con_j in ((ct, cj), (ti, ji)):
        cs_t, cs_j = con_t.traj_to_state(tr), con_j.traj_to_state(jtr)
        close(cs_t, cs_j)
        ut, cs_t = con_t.step(cs_t, data[2][0].obs[6])
        uj, cs_j = con_j.step(cs_j, jtr.obs[5] * 0 + np.asarray(data[3][0].obs[6]))
        close(ut, uj)
        close(cs_t, cs_j)
        assert con_t.state_dim == t.state_dim + 1


def _local_fit(tb, jb, history=2):
    """The slice test's model: ARX on 300 uniform-random 8-step
    trajectories near upright (init +-0.15, |u| <= 2), the data made by
    the port and handed to both packages."""
    task_small = tb.task.copy()
    task_small.set_ctrl_bound("u", -2.0, 2.0)
    local = uniform_random_generate_batch(
        tb.system, task_small, tb.dynamics, torch.Generator().manual_seed(42),
        init_min=-0.15 * np.ones(4), init_max=0.15 * np.ones(4), traj_len=8, n_trajs=300,
    )
    t = TARX(tb.system, history=history, device="cpu")
    t.train(local)
    j = JARX(jb.system, history=history)
    j.train(jax_batch(jb, local))
    return j, t


def test_lqr_closed_loop_matches_jax_simulate():
    jb, tb = JBench(), TBench()
    j, t = _local_fit(tb, jb)
    close(t.A, j.A)
    q = np.diag([100.0, 10.0, 1.0, 1.0])
    jtask, ttask = _tasks(jb, tb, q, 0.01 * np.eye(1), q)
    ct = TFinite(tb.system, ttask, t, horizon=80)
    cj = JFinite(jb.system, jtask, j, horizon=80)
    init = np.array([0.3, 0.0, 0.0, 0.0])
    trt = t_simulate(ct, init, dynamics=tb.dynamics, max_steps=60)
    trj = j_simulate(cj, init, dynamics=jb.dynamics, max_steps=60)
    assert trt.size == trj.size == 61
    close(trt.obs, trj.obs, 1e-9)
    close(trt.ctrls, trj.ctrls, 1e-9)


def test_lqr_stabilizes_near_upright():
    """tests/test_slice_arx_lqr.py's gate through the port: 200 steps from
    (0.3, 0, 0, 0) on the true dynamics end with |theta|, |omega| < 0.05."""
    jb, tb = JBench(), TBench()
    _, t = _local_fit(tb, jb)
    q = np.diag([100.0, 10.0, 1.0, 1.0])
    _, ttask = _tasks(jb, tb, q, 0.01 * np.eye(1), q)
    traj = t_simulate(TFinite(tb.system, ttask, t, horizon=80), np.array([0.3, 0.0, 0.0, 0.0]),
                      dynamics=tb.dynamics, max_steps=200)
    final = traj.obs[-1].numpy()
    assert traj.size == 201 and abs(final[0]) < 0.05 and abs(final[1]) < 0.05


def test_lqr_factory_space_matches_jax(data):
    jb, tb = data[0], data[1]
    spaces = [f(b.system).get_configuration_space() for f, b in
              ((JLQRFactory, jb), (TLQRFactory, tb))]
    hps = [[(h.name, type(h).__name__, getattr(h, "lower", None), getattr(h, "upper", None),
             h.default_value) for h in s.get_hyperparameters()] for s in spaces]
    assert hps[0] == hps[1]
    cfg = spaces[1].get_default_configuration()
    assert cfg["finite_horizon"] == "true" and cfg["horizon"] == 10
    cfg["finite_horizon"] = "false"
    assert "horizon" not in cfg
    _, t = arx_pair(data, 2)
    task = tb.task.copy()
    task.set_cost(TQuad(tb.system, np.eye(4), np.eye(1), goal=np.zeros(4)))
    con = TLQRFactory(tb.system)(spaces[1].get_default_configuration(), task, t)
    assert con.state_dim == t.state_dim + 1 and con.device == torch.device("cpu")
    assert con.is_compatible(tb.system, task, t)


def test_dummy_models_match_jax():
    from autompc_torch.core.system import System as TSystem
    from autompc_tpu.core.system import System as JSystem

    names = (["x1", "x2"], ["u"])
    js, ts = JSystem(*names, dt=0.1), TSystem(*names, dt=0.1)
    rng = np.random.default_rng(5)
    A, B = np.eye(2) + 0.1 * rng.normal(size=(2, 2)), rng.normal(size=(2, 1))
    x, u = rng.normal(size=2), rng.normal(size=1)
    T = torch.as_tensor
    tl, jl = TDummyLinear(ts, A, B, device="cpu"), JDummyLinear(js, A, B)
    for a, b in zip(tl.pred_diff(T(x), T(u)), jl.pred_diff(x, u)):
        close(a, b)
    assert tl.is_linear and tl.to_linear()[0].dtype == torch.float64
    tn, jn = TDummyNonlinear(ts, device="cpu"), JDummyNonlinear(js)
    X, U = rng.normal(size=(5, 2)), rng.normal(size=(5, 1))
    close(tn.pred_batch(T(X), T(U)), np.asarray(jax_vmap_pred(jn, X, U)))
    for a, b in zip(tn.pred_diff(T(x), T(u)), jn.pred_diff(x, u)):
        close(a, b)
    assert not tn.is_linear and tn.is_diff
    tz, jz = TLinearized(ts, x, tn), JLinearized(js, x, jn)
    close(tz.A, jz.A)
    close(tz.B, jz.B)
    close(tz.pred(T(x), T(u)), jz.pred(x, u))
    assert tz.is_linear and tz.state_dim == 2
    tl.set_parameters(jl.get_parameters())
    close(tl.A, A)


def jax_vmap_pred(model, X, U):
    return jax.vmap(lambda s, u: model.pred(s, u))(jnp.asarray(X), jnp.asarray(U))
