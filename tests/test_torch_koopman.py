"""The port's Koopman model and stable-Koopman solver against the JAX
package's, float64 on the CPU (BASELINE.json configs[3], Koopman +
DirectTranscription):

- the basis lifting (identity, powers, sin/cos, the product terms) and
  the state handling (traj_to_state(s), the batched re-lift);
- the lstsq (pinv) and lasso fits at 1e-8, pinv's relative cutoff;
- the stable-Koopman operators (project_psd, polar, sqrtm_psd,
  solve_discrete_lyapunov, checkdstable, _error_and_grads) at 1e-10 and
  stabilize_discrete (its host loops against JAX's while_loops) at 1e-6,
  the stable fit's spectral radius below 1;
- KoopmanFactory's space;
- Koopman + DirectTranscriptionController's first solve at 1e-9.

The data are made once by the port (CPU) and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.control import DirectTranscriptionController as TDT
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.ops.lstsq import pinv as t_pinv
from autompc_torch.sysid import Koopman as TK
from autompc_torch.sysid import KoopmanFactory as TKF
from autompc_torch.sysid import stable_koopman as tsk
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.control import DirectTranscriptionController as JDT
from autompc_tpu.core.trajectory import TrajectoryBatch as JTB
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.ops.lstsq import pinv as j_pinv
from autompc_tpu.sysid import Koopman as JK
from autompc_tpu.sysid import KoopmanFactory as JKF
from autompc_tpu.sysid import stable_koopman as jsk

torch.set_num_threads(1)


def close(a, b, tol=1e-10):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def data():
    jb, tb = JBench(), TBench()
    tt = tb.gen_trajs_batch(seed=42, n_trajs=12, traj_len=50, device="cpu")
    return jb, tb, tt, JTB(jb.system, tt.obs.numpy(), tt.ctrls.numpy(), tt.lengths.numpy())


BASES = {
    "identity": {},
    "trig": dict(trig_basis=True, trig_freq=1),
    "poly+trig": dict(poly_basis=True, poly_degree=3, trig_basis=True, trig_freq=2),
    "products": dict(poly_basis=True, poly_degree=2, product_terms=True),
}


@pytest.mark.parametrize("basis", list(BASES))
def test_basis_lifting_and_state_handling_match(data, basis):
    jb, tb, tt, jt = data
    t = TK(tb.system, method="lstsq", device="cpu", **BASES[basis])
    j = JK(jb.system, method="lstsq", **BASES[basis])
    assert t.state_dim == j.state_dim
    tr, jtr = tt[0], jt[0]
    ref = jax.jit(jax.vmap(j._apply_basis))(jtr.obs)      # JAX's traj_to_states
    close(t.traj_to_states(tr), ref)
    close(t.traj_to_state(tr[:7]), ref[6])
    # The re-lift of update_state_core, batched over the leading axes.
    got = t.update_state_core(t.params, None, tr.ctrls[:5], tr.obs[:5])
    close(got, t.traj_to_states(tr)[:5])
    assert (t.state_dim == 12) == (basis == "trig")


@pytest.mark.parametrize("method, basis", [("lstsq", "trig"), ("lstsq", "poly+trig"),
                                           ("lasso", "trig"), ("lasso", "identity")])
def test_lstsq_and_lasso_fits_match(data, method, basis):
    jb, tb, tt, jt = data
    kw = dict(BASES[basis], lasso_alpha=1e-3 if method == "lasso" else None)
    t = TK(tb.system, method=method, device="cpu", **kw)
    t.train(tt)
    j = JK(jb.system, method=method, **kw)
    j.train(jt)
    close(t.A, j.A, 1e-8)
    close(t.B, j.B, 1e-8)
    assert t.is_linear and t.to_linear()[0] is t.A
    S = t.traj_to_states(tt[1])
    P, Jx, Ju = t.pred_diff_batch(S, tt[1].ctrls)
    Pj, Jxj, Juj = j.pred_diff_batch(jnp.asarray(S.numpy()), jt[1].ctrls)
    close(P, Pj, 1e-8)
    close(Jx[3], t.A)
    t2 = TK(tb.system, method=method, device="cpu", **kw)
    t2.set_parameters(j.get_parameters())
    close(t2.A, j.A)


def test_pinv_cutoff_is_relative_as_jax():
    """``rcond`` is a cutoff relative to the largest singular value, as
    in ``jnp.linalg.pinv``: at each cutoff the same singular values are
    dropped and the pseudo-inverses agree (normwise, relative to the
    largest entry: 1e-15 keeps a condition number of 3e8)."""
    rng = np.random.default_rng(0)
    U, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    V, _ = np.linalg.qr(rng.normal(size=(4, 4)))
    A = U[:, :4] @ np.diag([3.0, 1.0, 1e-4, 1e-8]) @ V.T
    for rcond, rank, tol in ((1e-15, 4, 1e-6), (1e-7, 3, 1e-10), (1e-3, 2, 1e-10)):
        got = t_pinv(torch.as_tensor(A), rcond=rcond).numpy()
        ref = np.asarray(j_pinv(jnp.asarray(A), rcond=rcond))
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), rcond
        assert np.linalg.matrix_rank(got, 1e-3 * np.linalg.norm(got, 2) / 1e8) == rank


def _sym_problem(seed, n=5):
    rng = np.random.default_rng(seed)
    return rng, rng.normal(size=(n, n))


def test_stable_koopman_operators_match():
    T, J = torch.as_tensor, jnp.asarray
    rng, M = _sym_problem(0)
    close(tsk.project_psd(T(M), 0.0, 1.0), jsk.project_psd(J(M), 0.0, 1.0))
    close(tsk.project_psd(T(M), 1e-15), jsk.project_psd(J(M), 1e-15))
    for a, b in zip(tsk.polar(T(M)), jsk.polar(J(M))):
        close(a, b)
    P = M @ M.T
    close(tsk.sqrtm_psd(T(P)), jsk.sqrtm_psd(J(P)))
    A = 0.9 * np.linalg.qr(rng.normal(size=(5, 5)))[0]
    X = tsk.solve_discrete_lyapunov(T(A), T(np.eye(5)))
    close(X, jsk.solve_discrete_lyapunov(J(A), J(np.eye(5))))
    close(A @ X.numpy() @ A.T + np.eye(5), X, 1e-8)
    As = 0.8 * np.linalg.qr(rng.normal(size=(4, 4)))[0]
    for a, b in zip(tsk.checkdstable(T(As)), jsk.checkdstable(J(As))):
        close(a, b, 1e-9)
    n, m, N = 4, 1, 30
    Xs, Xu, Y = rng.normal(size=(n, N)), rng.normal(size=(m, N)), rng.normal(size=(n, N))
    S = tsk.project_psd(T(P[:n, :n]) + T(np.eye(n)), 1e-15).numpy()
    U = tsk.polar(T(rng.normal(size=(n, n))))[0].numpy()
    B = tsk.project_psd(T(rng.normal(size=(n, n))), 0.0, 1.0).numpy()
    Bc = rng.normal(size=(n, m))
    args = (Xs, Xu, Y, S, U, B, Bc)
    for a, b in zip(tsk._error_and_grads(*map(T, args)), jsk._error_and_grads(*map(J, args))):
        close(a, b)


@pytest.mark.parametrize("seed", [5, 6])
def test_stabilize_discrete_matches_jax(seed):
    """The FGM's host loops against JAX's while_loops (n = 4, a slightly
    unstable plant): every output within 1e-6, A Schur-stable."""
    rng = np.random.default_rng(seed)
    n, m, N = 4, 1, 200
    A_true = np.diag([1.05, 0.9, 0.8, 0.7])
    B_true = rng.normal(size=(n, m))
    X, U = rng.normal(size=(n, N)), rng.normal(size=(m, N))
    Y = A_true @ X + B_true @ U + 0.01 * rng.normal(size=(n, N))
    got = tsk.stabilize_discrete(*map(torch.as_tensor, (X, U, Y)))
    ref = jsk.stabilize_discrete(*map(jnp.asarray, (X, U, Y)))
    for a, b in zip(got, ref):
        close(a, b, 1e-6)
    assert np.abs(np.linalg.eigvals(got[0].numpy())).max() < 1.0


def test_stable_fit_matches_and_is_stable(data):
    jb, tb, tt, jt = data
    t = TK(tb.system, method="stable", device="cpu")
    t.train(tt)
    j = JK(jb.system, method="stable")
    j.train(jt)
    close(t.A, j.A, 1e-6)
    close(t.B, j.B, 1e-6)
    assert np.abs(np.linalg.eigvals(t.A.numpy())).max() < 1.0


def test_factory_space_matches_jax(data):
    jb, tb = data[0], data[1]
    spaces = [JKF(jb.system).get_configuration_space(), TKF(tb.system).get_configuration_space()]
    hps = [sorted((h.name, type(h).__name__, getattr(h, "lower", None),
                   getattr(h, "upper", None), h.default_value)
                  for h in s.get_hyperparameters()) for s in spaces]
    assert hps[0] == hps[1]
    cfg = spaces[1].get_default_configuration()
    cfg["method"] = "lasso"
    assert "lasso_alpha" in cfg
    cfg["method"] = "lstsq"
    assert "lasso_alpha" not in cfg
    cfg["trig_basis"] = "true"
    m = TKF(tb.system, device="cpu")(cfg, data[2])
    assert m.state_dim == 12 and m.A.shape == (12, 12)
    with pytest.raises(ValueError, match="Unknown method"):
        TK(tb.system, method="dmd", device="cpu")


def test_koopman_dt_first_solve_matches(data):
    """configs[3]: DirectTranscriptionController on the trig-basis lstsq
    Koopman model (ds = 12), one controller step from the same history:
    the control and the solved knots at 1e-9."""
    jb, tb, tt, jt = data
    t = TK(tb.system, method="lstsq", device="cpu", **BASES["trig"])
    t.train(tt)
    j = JK(jb.system, method="lstsq", **BASES["trig"])
    j.set_parameters(t.get_parameters())
    q = np.diag([10.0, 0.1, 0.01, 0.01])
    tasks = []
    for bench, cls in ((jb, JQuad), (tb, TQuad)):
        task = bench.task.copy()
        task.set_cost(cls(bench.system, q, 0.001 * np.eye(1), q, goal=np.zeros(4)))
        tasks.append(task)
    cj, ct = JDT(jb.system, tasks[0], j, horizon=0.3), TDT(tb.system, tasks[1], t, horizon=0.3)
    assert ct.horizon == cj.horizon == 6
    obs = np.array([0.4, -0.2, 0.1, 0.0])
    csj, cst = cj.traj_to_state(jt[0][:3]), ct.traj_to_state(tt[0][:3])
    uj, nj = cj.step(csj, jnp.asarray(obs))
    ut, nt = ct.step(cst, torch.as_tensor(obs))
    close(ut, uj, 1e-9)
    close(nt["xs_guess"], nj["xs_guess"], 1e-9)
    close(nt["us_guess"], nj["us_guess"], 1e-9)


def test_koopman_receding_sqp_loop_matches_jax(data):
    """configs[3]'s receding loop: the SQP solve on the trig-basis lstsq
    Koopman model (ds = 12, the cost on the observation's 4 dimensions),
    its first control applied to the true cartpole and the next lifted
    state re-lifted from the plant's observation, warm-started, 4 steps
    from the canonical start, against the JAX package's
    ``make_receding_sqp_loop`` on the same (A, B): 1e-8 (no observation
    bounds)."""
    from autompc_torch.control import make_receding_sqp_loop as t_loop
    from autompc_tpu.control.receding import make_receding_sqp_loop as j_loop

    jb, tb, tt, jt = data
    t = TK(tb.system, method="lstsq", device="cpu", **BASES["trig"])
    t.train(tt)
    j = JK(jb.system, method="lstsq", **BASES["trig"])
    j.set_parameters(t.get_parameters())
    q = np.diag([10.0, 0.1, 0.01, 0.01])
    jcost = JQuad(jb.system, q, 0.001 * np.eye(1), q, goal=np.zeros(4))
    tcost = TQuad(tb.system, q, 0.001 * np.eye(1), q, goal=np.zeros(4))
    bounds = tb.task.get_ctrl_bounds()
    kw = dict(H=6, ds=12, dc=1, obsdim=4, dt=tb.system.dt, n_steps=4,
              ubounds=(bounds[:, 0], bounds[:, 1]))
    obs0 = np.asarray(tb.task.get_init_obs())[None]

    def j_plant(z, u):
        return j._apply_basis(jb.dynamics(z[:4], u))

    def t_plant(z, u):
        return t._apply_basis(tb.dynamics(z[..., :4], u))

    xs_j, us_j = jax.jit(j_loop(j.pred_core, jcost, j_plant, **kw))(
        j.params, jax.vmap(j._apply_basis)(jnp.asarray(obs0)))
    xs_t, us_t = t_loop(t.pred_core, tcost, t_plant, **kw)(
        t.params, t._apply_basis(torch.as_tensor(obs0)))
    assert xs_t.shape == (1, 5, 12) and us_t.shape == (1, 4, 1)
    assert float(np.abs(np.asarray(us_j)).max()) > 0.1      # the loop acts
    close(us_t, us_j, 1e-8)
    close(xs_t, xs_j, 1e-8)
