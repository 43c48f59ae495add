"""The cost fan-out path of the port against the JAX package, float64.

(i)   make_batched_ilqr_solver(quad_cost_batch=True) in the port, in the
      lanes-last fused body and in the batch-major unfused body, against
      the JAX solver on the same SINDy coefficients, starts and per-lane
      costs: trajectories and objectives to 1e-8 on the lanes converged on
      both sides. The JAX solver cannot run its unfused feature kernel on
      the CPU, so the batch-major reference is its backward="scan",
      feature_spec=None form (the same rollouts through the plain line
      search).
(ii)  scheduled against unscheduled in the port, lane for lane.
(iii) QuadCostFanout scores against the JAX QuadCostFanout on the
      near-upright task of tests/test_parallel.py at a reduced n_steps;
      impl="vmap" (a single-lane solver a candidate) against JAX's
      impl="vmap" and against the port's batched body on a quadratic task
      cost (1e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.control import ilqr as tilqr
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.costs import ThresholdCost as TThreshold
from autompc_torch.parallel import QuadCostFanout as TFanout
from autompc_torch.parallel import pad_to_multiple
from autompc_torch.sysid import SINDy as TSINDy
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.control import ilqr as jilqr
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.costs import ThresholdCost
from autompc_tpu.parallel import QuadCostFanout, make_mesh
from autompc_tpu.sysid import SINDy

torch.set_num_threads(1)

B, H, MAX_ITER = 12, 10, 20
QD = np.array([10.0, 0.1, 0.01, 0.01])


@pytest.fixture(scope="module")
def setup():
    b = CartpoleSwingupBenchmark()
    kw = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
              trig_interaction=True)
    m = SINDy(b.system, **kw)
    m.train(b.gen_trajs_batch(seed=42, n_trajs=60, traj_len=80))
    tb = TBench()
    t = TSINDy(tb.system, device="cpu", **kw)
    t.set_parameters({**m.get_parameters(), "feature_names": m.get_feature_names()})
    bounds = b.task.get_ctrl_bounds()
    active = tuple(int(k) for k in np.flatnonzero(np.any(np.asarray(m.coeffs) != 0, axis=0)))
    common = dict(H=H, ds=4, dc=1, obsdim=4, dt=b.system.dt,
                  ubounds=(bounds[:, 0], bounds[:, 1]), max_iter=MAX_ITER)
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-1, 1, (B, 4)) * np.array([1.5, 1.0, 1.0, 1.0])
    cp = dict(Qdiag=10 ** rng.uniform(-1, 1.5, (B, 4)),
              Rdiag=10 ** rng.uniform(-3, 0, (B, 1)),
              Fdiag=10 ** rng.uniform(-1, 1.5, (B, 4)))
    return dict(b=b, tb=tb, m=m, t=t, active=active, common=common, x0=x0, cp=cp)


LL = dict(backward="pallas", fuse_ls=True, lanes_last=True)
BM = dict(backward="pallas", fuse_ls=False, lanes_last=False)
BM_SCAN = dict(backward="scan", fuse_ls=False, lanes_last=False)


def _torch_solver(s, make, opts, cost=None, **kw):
    per_lane = cost is None
    return make(s["t"].pred_core, cost, feature_spec=(s["t"].library, "coeffs"),
                feature_mask=s["active"], quad_cost_batch=per_lane,
                quad_goal=np.zeros(4) if per_lane else None, **s["common"], **opts, **kw)


def _torch_args(s, per_lane=True):
    T = torch.as_tensor
    args = (s["t"].params, T(s["x0"]), torch.zeros((B, H, 1), dtype=torch.float64))
    return args + (({k: T(v) for k, v in s["cp"].items()},) if per_lane else ())


@pytest.fixture(scope="module")
def jax_refs(setup):
    """The JAX solver's outputs, each form compiled once."""
    s = setup
    m = s["m"]
    x0, ug = jnp.asarray(s["x0"]), jnp.zeros((B, H, 1))
    cp = {k: jnp.asarray(v) for k, v in s["cp"].items()}
    lane = dict(quad_cost_batch=True, quad_goal=jnp.zeros(4))
    ll = jax.jit(jilqr.make_batched_ilqr_solver(
        m.pred_core, None, feature_spec=(m.library, "coeffs"), feature_mask=s["active"],
        pallas_interpret=True, **lane, **LL, **s["common"]))
    scan = jax.jit(jilqr.make_batched_ilqr_solver(
        m.pred_core, None, backward="scan", **lane, **s["common"]))
    jcost = JQuad(s["b"].system, jnp.diag(jnp.asarray(QD)), 0.001 * jnp.eye(1),
                  jnp.diag(jnp.asarray(QD)), goal=jnp.zeros(4))
    fixed = jax.jit(jilqr.make_batched_ilqr_solver(
        m.pred_core, jcost, backward="scan", **s["common"]))
    as_np = lambda out: tuple(np.asarray(a) for a in out)
    return dict(ll=as_np(ll(m.params, x0, ug, cp)), scan=as_np(scan(m.params, x0, ug, cp)),
                fixed=as_np(fixed(m.params, x0, ug)))


def _objective(s, xs, us, cp):
    xs, us = np.asarray(xs), np.asarray(us)
    dt = s["common"]["dt"]
    oc = (xs[:, :H] ** 2 * cp["Qdiag"][:, None, :]).sum((1, 2))
    cc = (us ** 2 * cp["Rdiag"][:, None, :]).sum((1, 2))
    return dt * (oc + cc) + (xs[:, H] ** 2 * cp["Fdiag"]).sum(1)


def _check(s, got, ref, cp, tol=1e-8):
    """Trajectories, gains and objectives on the lanes converged on both
    sides; the converged flags may differ on one knife-edge lane."""
    got = tuple(a.numpy() for a in got)
    both = got[0] & ref[0]
    assert both.sum() >= B // 2 and (got[0] == ref[0]).sum() >= B - 1, (got[0], ref[0])
    for i, name in zip((1, 2, 3, 4), ("xs", "us", "Ks", "ks")):
        assert got[i].shape == ref[i].shape, name
        np.testing.assert_allclose(got[i][both], ref[i][both], rtol=tol,
                                   atol=tol * max(1.0, np.abs(ref[i][both]).max()),
                                   err_msg=name)
    np.testing.assert_allclose(_objective(s, got[1], got[2], cp)[both],
                               _objective(s, ref[1], ref[2], cp)[both], rtol=tol)
    assert np.isfinite(got[1]).all()


@pytest.mark.parametrize("name, opts, ref", [
    ("lanes_last_fused", LL, "ll"),
    ("batch_major_kernel_backward", BM, "scan"),
    ("batch_major_scan_backward", BM_SCAN, "scan"),
    ("lanes_last_vs_jax_scan", LL, "scan"),
])
def test_per_lane_cost_solver_matches_jax(setup, jax_refs, name, opts, ref):
    solve = _torch_solver(setup, tilqr.make_batched_ilqr_solver, opts)
    _check(setup, solve(*_torch_args(setup)), jax_refs[ref], setup["cp"])


@pytest.mark.parametrize("opts", [BM, BM_SCAN], ids=["kernel_backward", "scan_backward"])
def test_fixed_diagonal_cost_batch_major_matches_jax(setup, jax_refs, opts):
    """A fixed diagonal QuadCost through the batch-major feature body:
    with backward="pallas" its diagonals are broadcast to the batch for
    the inline-expansion backward pass."""
    tcost = TQuad(setup["tb"].system, np.diag(QD), 0.001 * np.eye(1), np.diag(QD),
                  goal=np.zeros(4))
    solve = _torch_solver(setup, tilqr.make_batched_ilqr_solver, opts, cost=tcost)
    fixed_cp = dict(Qdiag=np.tile(QD, (B, 1)), Rdiag=np.full((B, 1), 0.001),
                    Fdiag=np.tile(QD, (B, 1)))
    _check(setup, solve(*_torch_args(setup, per_lane=False)), jax_refs["fixed"], fixed_cp)


def test_lanes_last_equals_batch_major_in_port(setup):
    """The fused kernel's in-kernel objective, ks_small and failure rule
    against the same computed in tensor code around the unfused
    kernel."""
    ll = _torch_solver(setup, tilqr.make_batched_ilqr_solver, LL)(*_torch_args(setup))
    bm = _torch_solver(setup, tilqr.make_batched_ilqr_solver, BM)(*_torch_args(setup))
    np.testing.assert_array_equal(ll[0].numpy(), bm[0].numpy())
    for a, b in zip(ll[1:], bm[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("opts", [LL, BM, BM_SCAN],
                         ids=["lanes_last", "batch_major", "batch_major_scan"])
@pytest.mark.parametrize("schedule", [((2, 0.5), (4, 0.34)), ((1, 0.17),),
                                      ((3, 0.75), (5, 0.5), (8, 0.25))])
def test_scheduled_equals_unscheduled_with_lane_costs(setup, opts, schedule):
    """Compaction gathers the cost planes with their lanes, in both
    layouts: lane for lane the uncompacted solve."""
    ref = _torch_solver(setup, tilqr.make_batched_ilqr_solver, opts)(*_torch_args(setup))
    out = _torch_solver(setup, tilqr.make_scheduled_ilqr_solver, opts, schedule=schedule)(
        *_torch_args(setup))
    np.testing.assert_array_equal(out[0].numpy(), ref[0].numpy())
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)


def test_solver_goes_through_the_fanout_kernels(setup, monkeypatch):
    """The batch-major feature body calls the wrappers of the three
    kernels of its path (K1 through its batch-major entry), the
    lanes-last body those of its own."""
    calls = []
    for name in ("backward_quad", "sindy_line_search", "relin_jacobians",
                 "relin_jacobians_bm", "backward_quad_ll", "fused_line_search"):
        real = getattr(tilqr, name)
        monkeypatch.setattr(tilqr, name,
                            lambda *a, _r=real, _n=name, **k: (calls.append(_n), _r(*a, **k))[1])
    kw = dict(setup["common"], max_iter=2)
    s = dict(setup, common=kw)
    _torch_solver(s, tilqr.make_batched_ilqr_solver, BM)(*_torch_args(s))
    assert set(calls) == {"backward_quad", "sindy_line_search", "relin_jacobians_bm"}
    calls.clear()
    _torch_solver(s, tilqr.make_batched_ilqr_solver, LL)(*_torch_args(s))
    assert set(calls) == {"backward_quad_ll", "fused_line_search", "relin_jacobians"}


def test_cost_params_are_required_and_checked(setup):
    solve = _torch_solver(setup, tilqr.make_batched_ilqr_solver, BM)
    args = _torch_args(setup)
    with pytest.raises(ValueError, match="needs cost_params"):
        solve(*args[:3])
    bad = dict(args[3], Rdiag=args[3]["Rdiag"][:5])
    with pytest.raises(ValueError, match="Rdiag"):
        solve(*args[:3], bad)


def test_pad_to_multiple_pads_with_the_last_row():
    batch = {"Qdiag": torch.arange(24.0).reshape(12, 2), "Rdiag": torch.arange(12.0)[:, None] + 1}
    padded, n = pad_to_multiple(batch, 8)
    assert n == 12 and padded["Qdiag"].shape == (16, 2) and padded["Rdiag"].shape == (16, 1)
    np.testing.assert_array_equal(padded["Qdiag"][12:].numpy(), np.tile([22.0, 23.0], (4, 1)))
    assert (padded["Rdiag"] > 0).all()
    same, n = pad_to_multiple(batch, 4)
    assert n == 12 and same is batch


def test_fanout_takes_a_model_with_a_closed_form_jacobian():
    """Without a feature_spec the fan-out hands the solver the model's
    ``pred_diff_core`` (an MLP's layer chain)."""
    from autompc_torch.sysid import MLP

    tb = TBench()
    mlp = MLP(tb.system, n_hidden_layers=1, hidden_size=8, n_train_iters=2, n_batch=16,
              device="cpu")
    mlp.train(tb.gen_trajs_batch(seed=1, n_trajs=4, traj_len=20, device="cpu"))
    fanout = TFanout(tb.system, tb.task, mlp, mlp, horizon=4, n_steps=2, goal=np.zeros(4),
                     device="cpu")
    rng = np.random.default_rng(2)
    scores = fanout({"Qdiag": rng.uniform(0.1, 5, (3, 4)), "Fdiag": rng.uniform(0.1, 5, (3, 4)),
                     "Rdiag": rng.uniform(0.01, 1, (3, 1))})
    assert tuple(scores.shape) == (3,) and not torch.isnan(scores).any()


# ---- (iii) the fan-out ----------------------------------------------------

N_STEPS = 6


def _near_upright_task(bench, cost_cls):
    """tests/test_parallel.py's task: score the pole dimensions only,
    start near upright."""
    task = bench.task.copy()
    task.set_cost(cost_cls(bench.system, goal=np.zeros(4), threshold=0.2, obs_range=(0, 2)))
    task.set_init_obs(np.array([0.5, 0.0, 0.0, 0.0]))
    return task


@pytest.fixture(scope="module")
def candidates():
    rng = np.random.default_rng(0)
    return {"Qdiag": rng.uniform(0.1, 20.0, (B, 4)), "Fdiag": rng.uniform(0.1, 20.0, (B, 4)),
            "Rdiag": rng.uniform(0.001, 1.0, (B, 1))}


@pytest.fixture(scope="module")
def jax_scores(setup, candidates):
    b, m = setup["b"], setup["m"]
    fanout = QuadCostFanout(b.system, _near_upright_task(b, ThresholdCost), m, m, horizon=H,
                            n_steps=N_STEPS, mesh=make_mesh(), goal=np.zeros(4))
    return np.asarray(fanout({k: jnp.asarray(v) for k, v in candidates.items()}))


@pytest.mark.parametrize("name, opts", [
    ("lanes_last_fused", LL), ("batch_major_kernels", BM), ("batch_major_scan", BM_SCAN),
    ("lanes_last_scheduled", dict(LL, compact_schedule="2:0.5,4:0.25")),
    ("batch_major_scheduled", dict(BM, compact_schedule=((2, 0.5), (4, 0.25)))),
    ("batch_major_warm_start", dict(BM, warm_start=True)),
])
def test_fanout_scores_match_jax(setup, candidates, jax_scores, name, opts):
    """B = 12 pads to 16 and returns 12; scores equal where finite and
    inf in the same places."""
    tb, t = setup["tb"], setup["t"]
    fanout = TFanout(tb.system, _near_upright_task(tb, TThreshold), t, t, horizon=H,
                     n_steps=N_STEPS, goal=np.zeros(4), feature_spec=(t.library, "coeffs"),
                     device="cpu", **opts)
    got = fanout(candidates)
    assert tuple(got.shape) == (B,) and got.device.type == "cpu"
    got = got.numpy()
    assert not np.isnan(got).any()
    if opts.get("warm_start"):
        # Another algorithm (a shifted guess): finite scores in range.
        assert np.isfinite(got).all() and (got >= 0).all() and (got <= N_STEPS + 1).all()
        return
    np.testing.assert_array_equal(np.isinf(got), np.isinf(jax_scores))
    fin = np.isfinite(jax_scores)
    np.testing.assert_array_equal(got[fin], jax_scores[fin])
    assert fanout.solver_kw["feature_mask"] == setup["active"]


def _quad_task(bench, cost_cls):
    """The near-upright start scored by a quadratic task cost (a
    continuous score)."""
    task = bench.task.copy()
    task.set_cost(cost_cls(bench.system, Q=np.eye(4), R=0.01 * np.eye(1), F=np.eye(4),
                           goal=np.zeros(4)))
    task.set_init_obs(np.array([0.5, 0.0, 0.0, 0.0]))
    return task


def test_vmap_impl_matches_jax_and_the_batched_body(setup, candidates):
    """Four candidates, four closed-loop steps: each candidate's own
    QuadCost and single-lane solver against JAX's vmap of the same, and
    against the per-lane-cost batched body."""
    b, m, tb, t = setup["b"], setup["m"], setup["tb"], setup["t"]
    cand = {k: v[:4] for k, v in candidates.items()}
    kw = dict(horizon=H, n_steps=4, goal=np.zeros(4))
    ref = np.asarray(QuadCostFanout(b.system, _quad_task(b, JQuad), m, m, impl="vmap", **kw)(
        {k: jnp.asarray(v) for k, v in cand.items()}))
    task = _quad_task(tb, TQuad)
    got = TFanout(tb.system, task, t, t, impl="vmap", device="cpu", **kw)(cand)
    batched = TFanout(tb.system, task, t, t, device="cpu", **kw, **BM_SCAN)(cand)
    assert tuple(got.shape) == (4,) and got.device.type == "cpu" and np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9)
    np.testing.assert_allclose(batched.numpy(), got.numpy(), rtol=1e-9)
    assert len(set(ref.round(6))) == 4
    with pytest.raises(ValueError, match="reg_matrix requires impl='batched'"):
        TFanout(tb.system, task, t, t, impl="vmap", reg_matrix=np.eye(4), device="cpu", **kw)
