"""K3's batch-major entry at dc > 1 and the lanes-last body's two repaired
refusals, against the JAX package, float64 on the CPU (a CPU tensor
takes the kernels' plain versions):

- K3's batch-major plain version at (ds, dc) = (3, 2) (a trig basis of
  15 terms), B = 4, H = 7, L = 4, against
  ``pallas_fused_line_search(..., ll_io=False, interpret=True)`` with
  ``grad_terms`` (the Jacobians Jx, Ju along the chosen rollout) at
  1e-10: shared and per-lane coefficients, per-lane diagonal, dense fixed
  and GaussReg costs, each control with its own bounds;
- the fused dc > 1 solve (the batch-major body with ``fuse_ls``: K1's
  batch-major entry at solve entry, K4 and K3) against JAX's batch-major
  fused body (its fused kernel in interpret mode, the scan backward pass)
  at 1e-8, and ``QuadCostFanout(fuse_ls=True)`` at (3, 2) against JAX's
  fan-out at 1e-8;
- the lanes-last body with per-lane coefficients under a fixed diagonal
  ``QuadCost`` (the fixed diagonals broadcast to per-lane planes) against
  JAX's batch-major solve of the same inputs at 1e-8;
- ``lanes_last=True`` with dc > 1 refused with the JAX package's
  ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.control import ilqr as tilqr
from autompc_torch.core import System as TSystem
from autompc_torch.core import Task as TTask
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.ops import cuda_linesearch as K3
from autompc_torch.parallel import QuadCostFanout as TFanout
from autompc_torch.sysid import SINDy as TSINDy
from autompc_tpu.control import ilqr as jilqr
from autompc_tpu.core.system import System
from autompc_tpu.core.task import Task
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.ops.pallas_linesearch import pallas_fused_line_search
from autompc_tpu.parallel import QuadCostFanout
from autompc_tpu.sysid import SINDy

torch.set_num_threads(1)

DS, DC = 3, 2
LIB = dict(trig_basis=True)
N_TERMS = 15
ALPHAS = tuple(0.3 ** k for k in range(4))
UMIN, UMAX = np.array([-1.0, -0.4]), np.array([0.9, 0.6])


def _coeffs(rng, ds, n):
    """A model near the identity map (small coefficients on every term)."""
    c = rng.normal(0.0, 0.05 / np.sqrt(n), (ds, n))
    c[:, :ds] += np.eye(ds)
    return c


@pytest.fixture(scope="module")
def models():
    names = ([f"x{i}" for i in range(DS)], [f"u{j}" for j in range(DC)])
    jsys, tsys = System(*names, dt=0.05), TSystem(*names, dt=0.05)
    m = SINDy(jsys, method="lstsq", **LIB)
    t = TSINDy(tsys, device="cpu", method="lstsq", **LIB)
    assert m.library.n_features == t.library.n_features == N_TERMS
    coeffs = _coeffs(np.random.default_rng(2), DS, N_TERMS)
    m.set_parameters({"coeffs": coeffs})
    t.set_parameters({"coeffs": coeffs, "feature_names": m.get_feature_names()})
    return dict(jsys=jsys, tsys=tsys, m=m, t=t, coeffs=coeffs)


def _inputs(seed, B=4, H=7):
    rng = np.random.default_rng(seed)
    obj0 = rng.uniform(2.0, 30.0, B)
    obj0[-1] = 1e-3        # no step size beats it: the last lane fails its search
    A = rng.normal(size=(DS, DS))
    Qm, Rm = rng.normal(size=(DS, DS)), rng.normal(size=(DC, DC))
    return dict(
        x0=rng.uniform(-1, 1, (B, DS)), xs=rng.uniform(-1, 1, (B, H + 1, DS)),
        us=rng.uniform(-0.8, 0.8, (B, H, DC)), Ks=rng.normal(size=(B, H, DC, DS)) * 0.3,
        ks=rng.normal(size=(B, H, DC)) * 0.5, obj0=obj0,
        lin=-rng.uniform(0.1, 5.0, B) * obj0 / 10, quad=-rng.uniform(0.1, 5.0, B),
        ks_small=np.array([False, True, False, False]),
        qd=rng.uniform(0.1, 10, (B, DS)), rd=rng.uniform(1e-3, 1, (B, DC)),
        fd=rng.uniform(0.1, 10, (B, DS)), goal=rng.normal(0, 0.1, DS),
        Q=Qm @ Qm.T + np.eye(DS), R=Rm @ Rm.T + 0.1 * np.eye(DC), F=A @ A.T + np.eye(DS),
        S=A @ A.T + DS * np.eye(DS), mu=rng.normal(0, 0.2, DS), w=10.0 ** rng.uniform(-3, 1, B),
    )


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("coef", ["shared", "per-lane"])
@pytest.mark.parametrize("cost", ["diag", "dense", "reg"])
def test_k3_batch_major_at_dc_above_one_matches_pallas(models, coef, cost):
    d = _inputs({"diag": 0, "dense": 1, "reg": 2}[cost])
    m, t = models["m"], models["t"]
    B = d["x0"].shape[0]
    if coef == "shared":
        jc, tc = jnp.asarray(models["coeffs"]), torch.as_tensor(models["coeffs"])
    else:
        C = np.random.default_rng(5).normal(0, 0.05, (B, DS, N_TERMS))
        C[:, :, :DS] += np.eye(DS)
        jc, tc = jnp.asarray(C), torch.as_tensor(C).permute(1, 2, 0).contiguous()
    J, T = jnp.asarray, torch.as_tensor
    if cost == "dense":
        jcost, per_lane = (J(d["Q"]), J(d["R"]), J(d["F"])), False
        tcost = (d["Q"], d["R"], d["F"])
    else:
        jcost, per_lane = (J(d["qd"]), J(d["rd"]), J(d["fd"])), True
        tcost = tuple(T(d[k]).T.contiguous() for k in ("qd", "rd", "fd"))
    reg = cost == "reg"
    ref = pallas_fused_line_search(
        tuple(m.library._fns), *(J(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")), jc,
        J(ALPHAS), J(UMIN), J(UMAX), *jcost, J(d["goal"]), 0.05,
        *(J(d[k]) for k in ("obj0", "lin", "quad", "ks_small")),
        grad_terms=tuple(m.library.grad_terms), block_b=B, interpret=True, ll_io=False,
        per_lane_diag_cost=per_lane,
        reg=(J(d["S"]), J(d["mu"]), J(d["w"])) if reg else None,
    )
    got = K3.fused_line_search_bm(
        tuple(t.library.terms), *(T(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")), tc, ALPHAS,
        UMIN, UMAX, *tcost, tuple(d["goal"]), 0.05,
        *(T(d[k]) for k in ("obj0", "lin", "quad", "ks_small")),
        reg=(d["S"], d["mu"], T(d["w"])) if reg else None)
    names = ("xs", "us", "obj", "succ", "fail", "Jx", "Ju")
    assert tuple(got[1].shape) == (B, 7, DC) and tuple(got[6].shape) == (B, 7, DS, DC)
    for name, g, r in zip(names, got, ref):
        if name in ("succ", "fail"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        else:
            _close(g.numpy(), r, 1e-10)
    assert got[3].numpy()[1] and not got[3].numpy()[-1] and got[4].numpy()[-1]
    # Each control clipped to its own bounds, both bounds reached.
    us = got[1].numpy()
    assert (us >= UMIN - 1e-12).all() and (us <= UMAX + 1e-12).all()
    assert np.isclose(us[..., 1], UMAX[1]).any() or np.isclose(us[..., 1], UMIN[1]).any()
    # du2: the chosen controls' squared distance from the carry's.
    _close(got[7].numpy(), ((got[1] - T(d["us"])) ** 2).sum((1, 2)).numpy(), 1e-12)


def _solve_inputs(B=4, H=5):
    rng = np.random.default_rng(11)
    return rng.uniform(-0.5, 0.5, (B, DS)), rng.uniform(-0.2, 0.2, (B, H, DC))


@pytest.mark.parametrize("cost", ["fixed", "per-lane"])
def test_fused_solve_at_dc_above_one_matches_jax(models, cost, monkeypatch):
    """The batch-major body with fuse_ls at (3, 2) runs K1's batch-major
    entry, K4 and K3's multi-control plain versions and gives JAX's fused
    batch-major solve (its fused kernel in interpret mode, the scan
    backward pass): converged flags equal, xs/us/Ks/ks to 1e-8."""
    m, t = models["m"], models["t"]
    H = 5
    x0, ug = _solve_inputs(H=H)
    rng = np.random.default_rng(4)
    goal = rng.normal(0.0, 0.3, DS)
    common = dict(H=H, ds=DS, dc=DC, obsdim=DS, dt=0.05, ubounds=(UMIN, UMAX), max_iter=6,
                  fuse_ls=True)
    if cost == "fixed":
        Q, R = np.diag(rng.uniform(0.5, 2.0, DS)), np.diag(rng.uniform(0.01, 0.1, DC))
        jcost = JQuad(models["jsys"], jnp.asarray(Q), jnp.asarray(R), jnp.asarray(Q),
                      goal=jnp.asarray(goal))
        tcost, cp, kw = TQuad(models["tsys"], Q, R, Q, goal=goal), None, {}
    else:
        jcost = tcost = None
        cp = {"Qdiag": rng.uniform(0.5, 2.0, (4, DS)), "Rdiag": rng.uniform(0.01, 0.1, (4, DC)),
              "Fdiag": rng.uniform(0.5, 2.0, (4, DS))}
        kw = dict(quad_cost_batch=True, quad_goal=goal)
    jsolve = jax.jit(jilqr.make_batched_ilqr_solver(
        m.pred_core, jcost, feature_spec=(m.library, "coeffs"), backward="scan",
        pallas_interpret=True, **common, **kw))
    calls = []
    for name in ("relin_jacobians_bm", "riccati_general", "fused_line_search_bm"):
        real = getattr(tilqr, name)
        monkeypatch.setattr(tilqr, name,
                            lambda *a, _r=real, _n=name, **k: (calls.append(_n), _r(*a, **k))[1])
    tsolve = tilqr.make_batched_ilqr_solver(
        t.pred_core, tcost, feature_spec=(t.library, "coeffs"), backward="pallas",
        **common, **kw)
    jargs = (m.params, jnp.asarray(x0), jnp.asarray(ug))
    targs = (t.params, torch.as_tensor(x0), torch.as_tensor(ug))
    if cp is not None:
        jargs += ({k: jnp.asarray(v) for k, v in cp.items()},)
        targs += ({k: torch.as_tensor(v) for k, v in cp.items()},)
    out_j = tuple(np.asarray(a) for a in jsolve(*jargs))
    out_t = tsolve(*targs)
    assert set(calls) == {"relin_jacobians_bm", "riccati_general", "fused_line_search_bm"}
    np.testing.assert_array_equal(out_t[0].numpy(), out_j[0])
    for i, name in zip((1, 2, 3, 4), ("xs", "us", "Ks", "ks")):
        _close(out_t[i].numpy(), out_j[i], 1e-8)
    assert not np.allclose(out_t[2].numpy(), ug)


def _task(cls, system, cost_cls):
    task = cls(system)
    task.set_ctrl_bounds(UMIN, UMAX)
    task.set_init_obs(np.array([0.4, -0.2, 0.1]))
    task.set_num_steps(5)
    task.set_cost(cost_cls(system, np.eye(DS), 0.01 * np.eye(DC), np.eye(DS),
                           goal=np.zeros(DS)))
    return task


def test_quad_cost_fanout_fused_at_dc_above_one_matches_jax(models, monkeypatch):
    """QuadCostFanout(fuse_ls=True) at (3, 2) (K3's multi-control plain
    version in every MPC step) against JAX's fan-out (backward "scan",
    no feature kernels: the same math) at 1e-8."""
    m, t = models["m"], models["t"]
    rng = np.random.default_rng(8)
    n = 6
    cand = {"Qdiag": rng.uniform(0.1, 20.0, (n, DS)), "Fdiag": rng.uniform(0.1, 20.0, (n, DS)),
            "Rdiag": rng.uniform(0.001, 1.0, (n, DC))}
    kw = dict(horizon=6, n_steps=4, goal=np.zeros(DS))
    jtask = _task(Task, models["jsys"], lambda s, Q, R, F, goal: JQuad(
        s, jnp.asarray(Q), jnp.asarray(R), jnp.asarray(F), goal=jnp.asarray(goal)))
    ref = np.asarray(QuadCostFanout(models["jsys"], jtask, m, m, **kw)(
        {k: jnp.asarray(v) for k, v in cand.items()}))
    seen = []
    real = tilqr.fused_line_search_bm
    monkeypatch.setattr(tilqr, "fused_line_search_bm",
                        lambda *a, **k: (seen.append(a[3].shape), real(*a, **k))[1])
    fan = TFanout(models["tsys"], _task(TTask, models["tsys"], TQuad), t, t,
                  feature_spec=(t.library, "coeffs"), fuse_ls=True, backward="pallas",
                  device="cpu", **kw)
    got = fan(cand)
    assert seen and all(s[-1] == DC for s in seen)
    assert tuple(got.shape) == (n,) and np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8)
    assert len(set(ref.round(6))) >= n - 1      # the candidates discriminate


# ---- the lanes-last body: per-lane coefficients under a fixed cost ------------------


def test_lanes_last_per_lane_coefficients_under_a_fixed_cost_match_jax():
    """The lanes-last body with batch_params and one fixed diagonal
    QuadCost (its diagonals broadcast to per-lane planes, fed to K2 and
    K3's per-lane-coefficient instance; compaction gathers them) against
    JAX's batch-major solve of the same per-lane models, costs and starts:
    converged flags equal, xs/us/Ks/ks to 1e-8."""
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
    from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench

    b, tb = JBench(), TBench()
    kw = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
              trig_interaction=True)
    m, t = SINDy(b.system, **kw), TSINDy(tb.system, device="cpu", **kw)
    t.train(tb.gen_trajs_batch(seed=42, n_trajs=20, traj_len=30, device="cpu"))
    B, H, n = 8, 8, m.library.n_features
    rng = np.random.default_rng(21)
    # Every lane its own model: the fit, each nonzero coefficient moved by
    # up to 2%.
    base = t.coeffs.numpy()
    C = base[None] * (1.0 + rng.uniform(-0.02, 0.02, (B,) + base.shape))
    Q, R = np.diag([10.0, 0.1, 1.0, 0.1]), 0.01 * np.eye(1)
    bounds = b.task.get_ctrl_bounds()
    common = dict(H=H, ds=4, dc=1, obsdim=4, dt=b.system.dt, max_iter=20, batch_params=True,
                  ubounds=(bounds[:, 0], bounds[:, 1]))

    def jpred(prm, x, u):
        return jnp.einsum("f,nf->n", m.library(jnp.concatenate([x, u], -1)), prm["coeffs"])

    def tpred(prm, x, u):
        return torch.einsum("bf,bnf->bn", t.library(torch.cat([x, u], -1)), prm["coeffs"])

    jsolve = jax.jit(jilqr.make_batched_ilqr_solver(
        jpred, JQuad(b.system, jnp.asarray(Q), jnp.asarray(R), jnp.asarray(Q)),
        backward="scan", **common))
    tsolve = tilqr.make_scheduled_ilqr_solver(
        tpred, TQuad(tb.system, Q, R, Q), feature_spec=(t.library, "coeffs"),
        backward="pallas", fuse_ls=True, lanes_last=True, schedule=((3, 0.5),), **common)
    x0 = rng.uniform(-0.4, 0.4, (B, 4))
    ug = np.zeros((B, H, 1))
    out_j = tuple(np.asarray(a) for a in jsolve({"coeffs": jnp.asarray(C)}, jnp.asarray(x0),
                                                jnp.asarray(ug)))
    out_t = tsolve({"coeffs": torch.as_tensor(C)}, torch.as_tensor(x0), torch.as_tensor(ug))
    np.testing.assert_array_equal(out_t[0].numpy(), out_j[0])
    assert out_j[0].sum() >= B // 2
    for i, name in zip((1, 2, 3, 4), ("xs", "us", "Ks", "ks")):
        _close(out_t[i].numpy(), out_j[i], 1e-8)


def test_lanes_last_refuses_dc_above_one_as_jax_does(models):
    """lanes_last=True at dc > 1: a ValueError with the JAX package's
    message (a bad configuration, which the tuner scores inf), not a
    NotPortedError."""
    from autompc_torch import NotPortedError

    t = models["t"]
    kw = dict(H=4, ds=DS, dc=DC, obsdim=DS, dt=0.05, ubounds=(UMIN, UMAX),
              feature_spec=(t.library, "coeffs"), backward="pallas", fuse_ls=True,
              lanes_last=True)
    cost = TQuad(models["tsys"], np.eye(DS), np.eye(DC), np.eye(DS))
    match = (r"lanes_last=True requires the fully-fused dc=1 diagonal-quadratic path: "
             r"fuse_ls=True, a feature_spec whose library has grad_terms, relin != 'xla', "
             r"and a diagonal quadratic cost \(fixed QuadCost or quad_cost_batch\); got "
             r"quad_backward=True, fuse_ls=True, relin_pallas=True, dc=2, grad_terms=yes, "
             r"mlp_ls=None")
    with pytest.raises(ValueError, match=match) as err:
        tilqr.make_batched_ilqr_solver(t.pred_core, cost, **kw)
    assert not isinstance(err.value, NotPortedError)
    with pytest.raises(ValueError, match=match.split(":")[0]):
        jilqr.make_batched_ilqr_solver(models["m"].pred_core, JQuad(
            models["jsys"], jnp.eye(DS), jnp.eye(DC), jnp.eye(DS)),
            **{**kw, "feature_spec": (models["m"].library, "coeffs")})


# ---- the multi-control instances' shapes, constants and routing --------------------


def test_multicontrol_source_shapes_and_constants(monkeypatch):
    """K3 at dc > 1 builds at first use at any (ds, dc > 1) with ds + dc
    <= 24 (the cheetah's (18, 6) included), refuses dc = 1 (which
    linesearch_fused's instances take) and ds + dc > 24 by name; its
    constants mirror linesearch_fused_mc.cu, its block's shared memory
    fits at every shape, and the main library's build leaves it out."""
    import ctypes
    import re

    from autompc_torch.ops import _build

    src = (_build.CSRC_DIR / "linesearch_fused_mc.cu").read_text()
    defs = dict(re.findall(r"#define (AMPC_MC_\w+) (\d+)", src))
    assert int(defs["AMPC_MC_MAX_L"]) == _build.MAX_L
    assert int(defs["AMPC_MC_MAX_THREADS"]) == _build.LS_MAX_THREADS
    assert ctypes.sizeof(_build.LSParamsMC) == 4 * (2 + _build.MAX_L + 3 * _build.MAX_D + 2)
    _build.check_shape("linesearch_fused_mc", 18, 6)
    with pytest.raises(ValueError, match=r"linesearch_fused_mc: .*dc > 1"):
        _build.check_shape("linesearch_fused_mc", 4, 1)
    with pytest.raises(ValueError, match=r"linesearch_fused_mc: .*MAX_D = 24"):
        _build.check_shape("linesearch_fused_mc", 19, 6)
    for ds in range(1, _build.MAX_D - 1):
        for dc in range(2, _build.MAX_D - ds + 1):
            for lane, dense, reg in ((0, 0, 0), (1, 0, 1), (0, 1, 0), (1, 1, 0)):
                assert K3.fused_mc_smem(ds, dc, ds, lane, dense, reg) <= _build.MAX_SMEM_BYTES
    built = []
    monkeypatch.setattr(_build, "library", lambda: "main")
    monkeypatch.setattr(_build, "shape_library", lambda *k: built.append(k) or "shape")
    assert _build.kernel_library("linesearch_fused_mc", 18, 6) == "shape"
    assert built == [("linesearch_fused_mc", 18, 6)]
    assert "linesearch_fused_mc.cu" not in {p.name for p in _build.main_sources()}
    assert "linesearch_fused.cu" in {p.name for p in _build.main_sources()}
