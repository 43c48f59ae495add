"""The port's batch-major iLQR body (control/ilqr.py, lanes_last=False)
vs the JAX package's make_batched_ilqr_solver with the same options,
float64: a tiny MLP model at the halfcheetah widths (ds=18, dc=6) and at
dc=1 with a dense (non-diagonal) QuadCost. Trajectories and objectives
are compared at 1e-8 on the lanes whose converged flag agrees; the
flags themselves are knife-edge (ROADMAP §C1, §C3) and may differ on one
lane."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.control import ilqr as tilqr
from autompc_torch.control import make_receding_ilqr_loop as t_loop
from autompc_torch.core.system import System as TSystem
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.ops import cuda_mlp_linesearch as K5
from autompc_torch.ops import cuda_riccati_general as K4
from autompc_torch.sysid.mlp import MLP as TMLP
from autompc_tpu.control import ilqr as jilqr
from autompc_tpu.control.receding import make_receding_ilqr_loop as j_loop
from autompc_tpu.core.system import System as JSystem
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.sysid.mlp import MLP as JMLP

# The tensors here are tiny: one intra-op thread. Six test workers with
# a thread pool each oversubscribe the cores and slow these loops of
# small ops a hundredfold.
torch.set_num_threads(1)


def _models(ds, dc, seed, nonlin="tanh"):
    names = [f"x{i}" for i in range(ds)], [f"u{i}" for i in range(dc)]
    js, ts = JSystem(*names, dt=0.05), TSystem(*names, dt=0.05)
    kw = dict(n_hidden_layers=2, hidden_size=8, nonlintype=nonlin)
    jm, tm = JMLP(js, **kw), TMLP(ts, device="cpu", **kw)
    rng = np.random.default_rng(seed)
    sizes = jm._sizes
    jm.set_parameters({
        "net_params": [
            {"W": rng.normal(0, 1 / np.sqrt(a), (a, b)), "b": rng.normal(0, 0.1, b)}
            for a, b in zip(sizes[:-1], sizes[1:])
        ],
        "xu_means": rng.normal(0, 0.1, ds + dc), "xu_std": rng.uniform(0.5, 1.5, ds + dc),
        "dy_means": np.zeros(ds), "dy_std": rng.uniform(0.05, 0.15, ds),
    })
    tm.set_parameters(jm.get_parameters())
    return js, ts, jm, tm


@pytest.fixture(scope="module")
def cheetah():
    """ds=18, dc=6, H=12, identity costs as the harness row, B=6."""
    js, ts, jm, tm = _models(18, 6, seed=0)
    Q, R = np.eye(18), 0.01 * np.eye(6)
    jcost = JQuad(js, jnp.asarray(Q), jnp.asarray(R), jnp.asarray(Q), goal=jnp.zeros(18))
    tcost = TQuad(ts, Q, R, Q, goal=np.zeros(18))
    common = dict(H=12, ds=18, dc=6, obsdim=18, dt=0.05,
                  ubounds=(-np.ones(6), np.ones(6)), max_iter=12)
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-0.3, 0.3, (6, 18))
    ug = rng.uniform(-0.2, 0.2, (6, 12, 6))
    jsolve = jax.jit(jilqr.make_batched_ilqr_solver(
        jm.pred_core, jcost, backward="scan", pred_diff=jm.pred_diff_core,
        mlp_ls=dict(nonlin="tanh", interpret=True, layout="feat", precision="highest"),
        **common))
    ref = jsolve(jm.params, jnp.asarray(x0), jnp.asarray(ug))
    return dict(jm=jm, tm=tm, jcost=jcost, tcost=tcost, common=common, x0=x0, ug=ug,
                ref=tuple(np.asarray(a) for a in ref))


@pytest.fixture(scope="module")
def dense():
    """ds=4, dc=1 with a coupled Q: the dc=1 dense-expansion backward."""
    js, ts, jm, tm = _models(4, 1, seed=2, nonlin="relu")
    Q = np.diag([2.0, 0.5, 1.0, 0.1])
    Q[1, 2] = Q[2, 1] = 0.05
    R = 0.01 * np.eye(1)
    jcost = JQuad(js, jnp.asarray(Q), jnp.asarray(R), jnp.asarray(Q), goal=jnp.zeros(4))
    tcost = TQuad(ts, Q, R, Q, goal=np.zeros(4))
    common = dict(H=10, ds=4, dc=1, obsdim=4, dt=0.05, ubounds=(-np.ones(1), np.ones(1)),
                  max_iter=10)
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-0.5, 0.5, (8, 4))
    ug = np.zeros((8, 10, 1))
    jsolve = jax.jit(jilqr.make_batched_ilqr_solver(
        jm.pred_core, jcost, backward="pallas", pallas_interpret=True,
        pred_diff=jm.pred_diff_core,
        mlp_ls=dict(nonlin="relu", interpret=True), **common))
    ref = jsolve(jm.params, jnp.asarray(x0), jnp.asarray(ug))
    return dict(jm=jm, tm=tm, jcost=jcost, tcost=tcost, common=common, x0=x0, ug=ug,
                ref=tuple(np.asarray(a) for a in ref))


def _objective(s, xs, us):
    c, H, dt = s["tcost"], s["common"]["H"], s["common"]["dt"]
    xs, us = torch.as_tensor(np.array(xs)), torch.as_tensor(np.array(us))
    return (dt * (c.eval_obs_cost(xs[:, :H]).sum(-1) + c.eval_ctrl_cost(us).sum(-1))
            + c.eval_term_obs_cost(xs[:, H])).numpy()


def _solve(s, make=None, **kw):
    make = make or tilqr.make_batched_ilqr_solver
    solve = make(s["tm"].pred_core, s["tcost"], pred_diff=s["tm"].pred_diff_core,
                 **s["common"], **kw)
    out = solve(s["tm"].params, torch.as_tensor(s["x0"]), torch.as_tensor(s["ug"]))
    return tuple(a.numpy() for a in out)


def _check(s, got, ref, tol=1e-8):
    """Every lane whose converged flag agrees (all but one at most) is
    compared, converged or not; at least half converged on both sides."""
    both = got[0] == ref[0]
    B = len(both)
    assert both.sum() >= B - 1 and (got[0] & ref[0]).sum() >= B // 2, (got[0], ref[0])
    for i, name in zip((1, 2, 3, 4), ("xs", "us", "Ks", "ks")):
        assert got[i].shape == ref[i].shape, name
        np.testing.assert_allclose(got[i][both], ref[i][both], rtol=tol,
                                   atol=tol * max(1.0, np.abs(ref[i][both]).max()),
                                   err_msg=name)
    np.testing.assert_allclose(_objective(s, got[1], got[2])[both],
                               _objective(s, ref[1], ref[2])[both], rtol=tol)
    assert np.isfinite(got[1]).all()


MLP_LS = dict(nonlin="tanh", layout="feat", precision="highest")


@pytest.mark.parametrize("backward", ["pallas", "scan"])
@pytest.mark.parametrize("ls", ["mlp_ls", "rollout"])
def test_cheetah_widths_match_jax(cheetah, backward, ls):
    kw = dict(mlp_ls=MLP_LS) if ls == "mlp_ls" else {}
    _check(cheetah, _solve(cheetah, backward=backward, **kw), cheetah["ref"])


@pytest.mark.parametrize("backward", ["pallas", "scan"])
@pytest.mark.parametrize("ls", ["mlp_ls", "rollout"])
def test_dense_cost_dc1_matches_jax(dense, backward, ls):
    kw = dict(mlp_ls=dict(nonlin="relu")) if ls == "mlp_ls" else {}
    _check(dense, _solve(dense, backward=backward, **kw), dense["ref"])


def test_solver_goes_through_the_kernel_wrappers(cheetah, monkeypatch):
    """backward="pallas" and mlp_ls reach the K4 and K5 wrappers (which
    give a CPU tensor the plain version); "scan" and no mlp_ls do not."""
    calls = []
    k4, k5 = tilqr.riccati_general, tilqr.mlp_line_search
    monkeypatch.setattr(tilqr, "riccati_general",
                        lambda *a: calls.append("K4") or k4(*a))
    monkeypatch.setattr(tilqr, "mlp_line_search",
                        lambda *a, **k: calls.append("K5") or k5(*a, **k))
    s = dict(cheetah, common=dict(cheetah["common"], max_iter=2))
    _solve(s, backward="pallas", mlp_ls=MLP_LS)
    assert calls.count("K4") == 2 and calls.count("K5") == 2
    del calls[:]
    _solve(s, backward="scan")
    assert calls == []
    assert K4.riccati_general.launches == 0 and K5.mlp_line_search.launches == 0


@pytest.mark.parametrize("schedule", [((2, 0.5), (4, 0.34)), ((1, 0.17),),
                                      ((3, 0.67), (5, 0.5), (7, 0.17))])
def test_scheduled_equals_batched_on_batch_major_carry(cheetah, schedule):
    ref = _solve(cheetah, backward="pallas", mlp_ls=MLP_LS)
    out = _solve(cheetah, make=tilqr.make_scheduled_ilqr_solver, schedule=schedule,
                 backward="pallas", mlp_ls=MLP_LS)
    np.testing.assert_array_equal(out[0], ref[0])
    for i in (1, 2, 3, 4):
        np.testing.assert_allclose(out[i], ref[i], rtol=1e-12, atol=1e-12)


def test_scheduled_matches_jax_scheduled(dense):
    sched = ((3, 0.5),)
    jsolve = jax.jit(jilqr.make_scheduled_ilqr_solver(
        dense["jm"].pred_core, dense["jcost"], schedule=sched, backward="scan",
        pred_diff=dense["jm"].pred_diff_core, **dense["common"]))
    ref = jsolve(dense["jm"].params, jnp.asarray(dense["x0"]), jnp.asarray(dense["ug"]))
    got = _solve(dense, make=tilqr.make_scheduled_ilqr_solver, schedule=sched,
                 backward="scan")
    _check(dense, got, tuple(np.asarray(a) for a in ref))


def test_pieces_and_carry_layout(cheetah):
    tm, c = cheetah["tm"], cheetah["common"]
    solve, make_carry0, cond, make_body = tilqr.make_batched_ilqr_solver(
        tm.pred_core, cheetah["tcost"], pred_diff=tm.pred_diff_core, return_pieces=True,
        backward="pallas", mlp_ls=MLP_LS, **c)
    carry = make_carry0(tm.params, torch.as_tensor(cheetah["x0"]), torch.as_tensor(cheetah["ug"]))
    B, H = 6, c["H"]
    shapes = {k: tuple(v.shape) for k, v in carry.items() if isinstance(v, torch.Tensor)}
    assert shapes == dict(
        x0s=(B, 18), xs=(B, H + 1, 18), us=(B, H, 6), Jx=(B, H, 18, 18), Ju=(B, H, 18, 6),
        obj=(B,), Ks=(B, H, 6, 18), ks=(B, H, 6), converged=(B,), failed=(B,))
    assert all(v.is_contiguous() for v in carry.values() if isinstance(v, torch.Tensor))
    # The entry rollout is pred_core's and the Jacobians are pred_diff's.
    x1 = tm.pred_core(tm.params, carry["xs"][:, 3], carry["us"][:, 3])
    np.testing.assert_allclose(carry["xs"][:, 4].numpy(), x1.numpy(), rtol=1e-13, atol=1e-13)
    _, jx, ju = tm.pred_diff_core(tm.params, carry["xs"][:, :H], carry["us"])
    np.testing.assert_allclose(carry["Jx"].numpy(), jx.numpy(), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(carry["Ju"].numpy(), ju.numpy(), rtol=1e-13, atol=1e-13)
    assert cond(carry) and carry["itr"] == 0
    nxt = make_body(tm.params)(carry)
    assert nxt["itr"] == 1 and bool((nxt["obj"] <= carry["obj"] + 1e-12).all())
    assert not cond(dict(carry, itr=c["max_iter"]))


def test_receding_loop_matches_jax_at_dc6(cheetah):
    """Closed loop through the batch-major body against the JAX
    package's vmapped single-lane loop; the plant is the model."""
    jm, tm = cheetah["jm"], cheetah["tm"]
    kw = dict(H=6, ds=18, dc=6, obsdim=18, dt=0.05, n_steps=3,
              ubounds=(-np.ones(6), np.ones(6)), max_iter=8)
    jrun = jax.jit(j_loop(jm.pred_core, cheetah["jcost"],
                          lambda x, u: jm.pred_core(jm.params, x, u),
                          pred_diff=jm.pred_diff_core, **kw))
    trun = t_loop(tm.pred_core, cheetah["tcost"],
                  lambda x, u: tm.pred_core(tm.params, x, u),
                  pred_diff=tm.pred_diff_core, mlp_ls=MLP_LS, **kw)
    x0 = cheetah["x0"][:3]
    xs_j, us_j, _ = jrun(jm.params, jnp.asarray(x0))
    xs_t, us_t, nc_t = trun(tm.params, torch.as_tensor(x0))
    assert xs_t.shape == (3, 4, 18) and us_t.shape == (3, 3, 6) and nc_t.shape == (3,)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kwargs, match", [
    (dict(quad_cost_batch=True, quad_goal=np.zeros(3)), "quad_goal"),
    (dict(batch_params=True, mlp_ls=dict(nonlin="relu")), "batch_params"),
    (dict(reg_matrix=np.eye(4)), "reg_matrix"),
    (dict(horizon_mask=True), "horizon_mask"),
    (dict(pad_to=64), "pad_to"),
    (dict(feature_spec=(None, "coeffs"), fuse_ls=True), "batch-major"),
    (dict(fuse_ls=True), "batch-major"),
    (dict(ls_wide=True, jac_dtype="bf16"), "lanes-last"),
    (dict(jac_dtype="bf16"), "bf16"),
    (dict(jac_dtype="f16"), "jac_dtype"),
    (dict(backward="assoc"), "assoc"),
    (dict(relin="xla"), "relin"),
    (dict(analytic_jac=True), "analytic_jac"),
    (dict(pred_diff=None), "jacfwd"),
    (dict(feature_mask=(0, 1)), "feature_mask needs feature_spec"),
    (dict(mlp_ls=dict(nonlin="relu", precision="default")), "precision"),
    (dict(mlp_ls=dict(nonlin="relu", precision="bf16x3", layout="feat")), "precision"),
    (dict(mlp_ls=dict(layout="feat")), "nonlin"),
])
def test_options_that_still_raise(dense, kwargs, match):
    kwargs = dict(kwargs)
    cost = dense["tcost"]
    if kwargs.pop("diag", False):
        cost = TQuad(cost.system, np.eye(4), np.eye(1), np.eye(4))
    kw = dict(dense["common"], pred_diff=dense["tm"].pred_diff_core)
    kw.update(kwargs)
    # pad_to belongs to JointMLPQuadCostFanout, not to the solver (as in
    # the JAX package): the solver does not take the keyword.
    with pytest.raises(TypeError if "pad_to" in kwargs else ValueError, match=match):
        tilqr.make_batched_ilqr_solver(dense["tm"].pred_core, cost, **kw)


def test_ls_wide_is_ignored_by_the_batch_major_body(dense):
    """``ls_wide`` picks a line search of the lanes-last body only, as in
    the JAX package: at a batch the split search would take (B = 1024)
    the batch-major solve with it equals the solve without it."""
    x0 = torch.as_tensor(np.random.default_rng(5).uniform(-0.5, 0.5, (1024, 4)))
    kw = dict(dense["common"], max_iter=3)
    outs = [
        tilqr.make_batched_ilqr_solver(
            dense["tm"].pred_core, dense["tcost"], pred_diff=dense["tm"].pred_diff_core,
            ls_wide=wide, **kw,
        )(dense["tm"].params, x0, torch.zeros((1024, 10, 1), dtype=torch.float64))
        for wide in (False, True)
    ]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert outs[0][0].any()


def test_unbuilt_shape_raises_on_the_kernel_path_only():
    """(ds, dc) = (5, 2) has no instance of the backward kernel: its
    wrapper refuses a non-CPU tensor before any launch, and the plain
    version (a CPU tensor) takes every shape."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        K4.riccati_general(z(2, 3, 5, 5), z(2, 3, 5, 2), z(2, 3, 5, 5), z(2, 3, 2, 2),
                           z(2, 3, 5), z(2, 3, 2), z(2, 5, 5), z(2, 5))
