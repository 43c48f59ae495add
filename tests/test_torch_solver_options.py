"""The solver's remaining options of the port against the JAX package on
the CPU, float64 unless stated:

(a) the associative-scan Riccati family (``tvlqr_backward_assoc`` with
    and without defects and regularization, ``qp_backward_assoc``,
    ``tvlqr_suffix_scan``, ``solve_unrolled``, ``affine_rollout_parallel``
    and ``affine_rollout_scan``) at H = 5, a horizon that is not a power
    of two: 1e-9;
(b) ``backward="assoc"`` in the single-lane solver, the batch-major body
    and the SQP; ``relin="xla"``, ``analytic_jac`` (with and without the
    fused line search, which then writes no Jacobians) and
    ``make_staged_ilqr_solver``; ``IterativeLQR.compute_ilqr``: 1e-8,
    on the lanes whose converged flags agree;
(c) ``FeatureLibrary.jacobian`` and ``grad_terms``: 1e-12;
(d) the kernels' plain versions: K3's batch-major entry under a fixed
    dense cost (``DENSE``) and with per-lane coefficients past 64 terms,
    each against ``pallas_fused_line_search`` in interpret mode, 1e-9;
    K5 at ``precision="bf16x3"`` against the TPU kernel's ``feat3`` form
    in interpret mode, in float32 (the JAX kernel sums in float32 whatever
    x64 says): 1e-5 relative to the largest state, the rounding of a
    float32 sum of 13 products compounded over 5 steps; K5 at
    ``precision="default"`` against a float64 rollout built from the JAX
    package's own line search with each product's operands rounded to
    bfloat16 as each TPU layout rounds them, 1e-9 (XLA on the CPU does
    not round a ``DEFAULT`` product, so the JAX package on the CPU cannot
    show the TPU's single pass).

The JAX references of the solvers run without feature kernels (jacfwd,
the plain line search): the same function the port's options compute
through their feature kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.control import IterativeLQR as TILQR
from autompc_torch.control import ilqr as tilqr
from autompc_torch.control.nmpc import make_sqp_solver as t_sqp
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.ops import cuda_linesearch as TK3
from autompc_torch.ops import cuda_mlp_linesearch as TK5
from autompc_torch.ops import riccati as tr
from autompc_torch.ops import trajqp as tq
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.sysid.basis import FeatureLibrary as TLib
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.control import IterativeLQR as JILQR
from autompc_tpu.control import ilqr as jilqr
from autompc_tpu.control.nmpc import make_sqp_solver as j_sqp
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.ops import riccati as jr
from autompc_tpu.ops import trajqp as jq
from autompc_tpu.ops.pallas_linesearch import pallas_fused_line_search
from autompc_tpu.ops.pallas_mlp_linesearch import pallas_mlp_line_search
from autompc_tpu.sysid import SINDy as JSINDy
from autompc_tpu.sysid.basis import FeatureLibrary as JLib

# The tensors here are tiny: one intra-op thread (six test workers with a
# thread pool each oversubscribe the cores).
torch.set_num_threads(1)

T, J = torch.as_tensor, jnp.asarray


def _close(got, ref, tol, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol, atol=tol,
                               err_msg=err_msg)


# ---- (a) the associative-scan family -------------------------------------------

@pytest.fixture(scope="module")
def lqr():
    """B = 3 random well-posed backward passes, H = 5, ds = 3, dc = 2."""
    rng = np.random.default_rng(0)
    B, H, ds, dc = 3, 5, 3, 2
    M = rng.normal(size=(B, H, ds, ds))
    N = rng.normal(size=(B, H, dc, dc))
    P = rng.normal(size=(B, ds, ds))
    return dict(
        Jx=rng.normal(0, 0.3, (B, H, ds, ds)) + np.eye(ds), Ju=rng.normal(0, 0.5, (B, H, ds, dc)),
        Cxx=0.1 * M @ M.transpose(0, 1, 3, 2) + 0.1 * np.eye(ds),
        Cuu=0.1 * N @ N.transpose(0, 1, 3, 2) + np.eye(dc),
        cx=rng.normal(size=(B, H, ds)), cu=rng.normal(size=(B, H, dc)),
        Vn=P @ P.transpose(0, 2, 1), vn=rng.normal(size=(B, ds)),
        d=rng.normal(0, 0.1, (B, H, ds)), A=rng.normal(0, 0.4, (B, H, ds, ds)),
        b=rng.normal(size=(B, H, ds)), x0=rng.normal(size=(B, ds)),
    )


KEYS = ("Jx", "Ju", "Cxx", "Cuu", "cx", "cu", "Vn", "vn")


@pytest.fixture(scope="module")
def jax_family(lqr):
    """The JAX package's family on ``lqr``, in one compiled program run
    twice (the defects and the regularization are arguments): with
    defects and reg = 1e-3, and with zero defects and reg = 0 (the
    function ``d_seq=None`` computes); the suffix compositions, both
    affine rollouts and ``solve_unrolled``."""
    def f(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn, d, reg, A, b, x0, M, R):
        one = lambda *a: jr.tvlqr_backward_assoc(*a[:8], d_seq=a[8], reg=reg)
        elems = jax.vmap(jax.vmap(lambda *a: jr.tvlqr_element(*a, reg=reg)))(
            Jx, Ju, Cxx, Cuu, cx, cu, d)
        return dict(
            assoc=jax.vmap(one)(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn, d),
            suffix=jax.vmap(jr.tvlqr_suffix_scan)(elems),
            par=jax.vmap(jr.affine_rollout_parallel)(A, b, x0),
            seq=jax.vmap(jr.affine_rollout_scan)(A, b, x0),
            unrolled=jax.vmap(jr.solve_unrolled)(M, R),
        )

    rng = np.random.default_rng(1)
    extra = dict(M=rng.normal(size=(3, 5, 5)), R=rng.normal(size=(3, 5, 2)))
    jf = jax.jit(f)
    run = lambda d, reg: jf(*(J(lqr[k]) for k in KEYS), J(d), reg,
                            *(J(lqr[k]) for k in ("A", "b", "x0")), J(extra["M"]),
                            J(extra["R"]))
    return dict(run(lqr["d"], 1e-3), plain=run(np.zeros_like(lqr["d"]), 0.0)["assoc"],
                **extra)


def test_assoc_family_matches_jax(lqr, jax_family):
    """``tvlqr_backward_assoc`` with defects and regularization, and
    without (d_seq None, reg 0; the JAX program run with zero defects and
    reg 0, the same function), against the sequential recursion too;
    ``qp_backward_assoc`` (JAX's is the same call) and ``qp_backward`` to
    its per-step symmetrization; the suffix compositions, the identity
    element on either side of one; both affine rollouts;
    ``solve_unrolled``."""
    args = [T(lqr[k]) for k in KEYS]
    for name, g, r in zip(("Ks", "ks", "lin", "quad"),
                          tr.tvlqr_backward_assoc(*args, d_seq=T(lqr["d"]), reg=1e-3),
                          jax_family["assoc"]):
        _close(g, r, 1e-9, name)
    plain = tr.tvlqr_backward_assoc(*args)
    for name, g, r in zip(("Ks", "ks", "lin", "quad"), plain, jax_family["plain"]):
        _close(g, r, 1e-9, name)
    for g, s_ in zip(plain, tr.tvlqr_backward_scan(*args)):
        _close(g, s_, 1e-9)

    qargs = ("Jx", "Ju", "Cxx", "Cuu", "Cux", "cx", "cu", "d", "Vn", "vn")
    d = dict(lqr, Cux=np.zeros(lqr["Ju"].shape[:2] + (2, 3)))
    got = tq.qp_backward_assoc(*(T(d[k]) for k in qargs), 1e-3)
    for g, r in zip(got, jax_family["assoc"]):
        _close(g, r, 1e-9)
    for g, s_ in zip(got, tq.qp_backward(*(T(d[k]) for k in qargs), 1e-3)):
        _close(g, s_, 1e-9)

    el = ("Jx", "Ju", "Cxx", "Cuu", "cx", "cu", "d")
    tsuf = tr.tvlqr_suffix_scan(tr.tvlqr_element(*(T(lqr[k]) for k in el), reg=1e-3))
    for g, r in zip(tsuf, jax_family["suffix"]):
        _close(g, r, 1e-9)
    first = tuple(e[:, 0] for e in tsuf)
    ident = tr.tvlqr_identity_element(3, torch.float64, batch=(3,))
    for a, b_, c in zip(tr.tvlqr_combine(ident, first), tr.tvlqr_combine(first, ident), first):
        _close(a, c, 1e-12)
        _close(b_, c, 1e-12)

    A, b, x0 = (T(lqr[k]) for k in ("A", "b", "x0"))
    par, seq = tr.affine_rollout_parallel(A, b, x0), tr.affine_rollout_scan(A, b, x0)
    assert par.shape == (3, 6, 3)
    _close(par, jax_family["par"], 1e-9)
    _close(seq, jax_family["seq"], 1e-9)
    _close(par, seq, 1e-9)
    _close(tr.solve_unrolled(T(jax_family["M"]), T(jax_family["R"])), jax_family["unrolled"],
           1e-12)


# ---- (b) the solvers' options ---------------------------------------------------

H_S, B_S = 8, 6
QD = np.diag([10.0, 0.1, 0.01, 0.01])
SINDY_KW = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1)


@pytest.fixture(scope="module")
def cartpole():
    """The cartpole SINDy (the 15-term trig library), fitted by the port
    and given to the JAX package's model, its quadratic cost, and starts."""
    jb, tb = JBench(), TBench()
    t = TSINDy(tb.system, device="cpu", **SINDY_KW)
    t.train(tb.gen_trajs_batch(seed=42, n_trajs=20, traj_len=60, device="cpu"))
    m = JSINDy(jb.system, **SINDY_KW)
    m.set_parameters(t.get_parameters())
    jcost = JQuad(jb.system, J(QD), 0.001 * jnp.eye(1), J(QD), goal=jnp.zeros(4))
    tcost = TQuad(tb.system, QD, 0.001 * np.eye(1), QD, goal=np.zeros(4))
    bounds = tb.task.get_ctrl_bounds()
    common = dict(H=H_S, ds=4, dc=1, obsdim=4, dt=tb.system.dt,
                  ubounds=(bounds[:, 0], bounds[:, 1]), max_iter=12)
    rng = np.random.default_rng(4)
    x0 = rng.uniform(-1, 1, (B_S, 4)) * np.array([0.8, 0.5, 0.5, 0.5])
    return dict(jb=jb, tb=tb, m=m, t=t, jcost=jcost, tcost=tcost, common=common, x0=x0,
                ug=np.zeros((B_S, H_S, 1)))


def _check(out_t, out_j, tol=1e-8, min_agree=None):
    """Converged flags equal (on ``min_agree`` of the lanes at least, when
    given), trajectories and gains within ``tol`` on the lanes whose
    flags agree."""
    conv_t, conv_j = out_t[0].numpy(), np.asarray(out_j[0])
    same = conv_t == conv_j
    if min_agree is None:
        np.testing.assert_array_equal(conv_t, conv_j)
    else:
        assert same.mean() >= min_agree, (conv_t, conv_j)
    for i, name in zip((1, 2, 3, 4), ("xs", "us", "Ks", "ks")):
        _close(out_t[i].numpy()[same], np.asarray(out_j[i])[same], tol, name)
    return conv_t


@pytest.fixture(scope="module")
def jax_batched(cartpole):
    """The JAX package's batch-major solve under backward="assoc"."""
    c = cartpole
    solve = jax.jit(jilqr.make_batched_ilqr_solver(c["m"].pred_core, c["jcost"],
                                                   backward="assoc", **c["common"]))
    return solve(c["m"].params, J(c["x0"]), J(c["ug"]))


BATCH_OPTIONS = (
    dict(backward="assoc"),
    dict(backward="assoc", feature_spec=None),
    dict(relin="xla"),
    dict(relin="xla", analytic_jac=True),
    dict(relin="xla", analytic_jac=True, fuse_ls=True),
)


def test_batch_major_options_match_jax(cartpole, jax_batched):
    """Each option through the port's batch-major body against the JAX
    package's: backward="assoc" with the feature kernels' plain versions
    (K1, K7) and with none (jacfwd, the plain line search); relin="xla"
    (jacfwd), and with analytic_jac, unfused (K7) and fused (K3 without
    its Jacobians)."""
    c = cartpole
    t = c["t"]
    for opts in BATCH_OPTIONS:
        kw = dict({"feature_spec": (t.library, "coeffs")}, **opts)
        solve = tilqr.make_batched_ilqr_solver(t.pred_core, c["tcost"], **c["common"], **kw)
        out = solve(t.params, T(c["x0"]), T(c["ug"]))
        assert _check(out, jax_batched).any(), opts


def test_single_lane_solver_and_compute_ilqr_match_jax(cartpole, jax_batched):
    """``make_ilqr_solver(backward="assoc")`` against the JAX package's
    batch-major assoc solve (its single-lane solver's function, lane for
    lane) and ``IterativeLQR.compute_ilqr`` (the scan recursion) against
    the JAX package's, from two starts."""
    c = cartpole
    tsolve = tilqr.make_ilqr_solver(c["t"].pred_core, c["tcost"], backward="assoc",
                                    **c["common"])
    tasks = []
    for bench, cost in ((c["jb"], c["jcost"]), (c["tb"], c["tcost"])):
        task = bench.task.copy()
        task.set_cost(cost)
        tasks.append(task)
    jctl = JILQR(c["jb"].system, tasks[0], c["m"], horizon=H_S)
    tctl = TILQR(c["tb"].system, tasks[1], c["t"], horizon=H_S)
    for b in range(2):
        x0, ug = c["x0"][b], c["ug"][b]
        out_t = tsolve(c["t"].params, T(x0), T(ug))
        out_j = tuple(np.asarray(a)[b] for a in jax_batched)
        assert bool(out_t[0]) == bool(out_j[0])
        for g, r in zip(out_t[1:], out_j[1:]):
            _close(g, r, 1e-8)
        out_t = tctl.compute_ilqr(x0, ug)
        out_j = jctl.compute_ilqr(x0, ug)
        assert bool(out_t[0]) == bool(out_j[0])
        for g, r in zip(out_t[1:], out_j[1:]):
            _close(g, r, 1e-8)


def test_staged_solver_matches_jax(cartpole):
    """Chunks of 2 iterations, buckets down to 4 of the 6 lanes (one
    compaction): the converged lanes of both drivers, within 1e-8; the
    lanes-last body refused as in the JAX package."""
    c = cartpole
    kw = dict(c["common"], chunk_iters=2, min_bucket=4, backward="scan")
    jout = jilqr.make_staged_ilqr_solver(c["m"].pred_core, c["jcost"], **kw)(
        c["m"].params, J(c["x0"]), J(c["ug"]))
    t = c["t"]
    tout = tilqr.make_staged_ilqr_solver(t.pred_core, c["tcost"],
                                         feature_spec=(t.library, "coeffs"), **kw)(
        t.params, T(c["x0"]), T(c["ug"]))
    both = tout[0].numpy() & np.asarray(jout[0])
    assert both.sum() >= 2
    for g, r in zip(tout[1:], jout[1:]):
        _close(g.numpy()[both], np.asarray(r)[both], 1e-8)
    for pkg, pred in ((tilqr, t.pred_core), (jilqr, c["m"].pred_core)):
        with pytest.raises(ValueError, match="staged driver"):
            pkg.make_staged_ilqr_solver(pred, None, lanes_last=True, **kw)


def test_sqp_assoc_matches_jax(cartpole):
    """``make_sqp_solver(backward="assoc")`` (``qp_backward_assoc``) on the
    cartpole SINDy, three starts from zero state guesses (defects on
    every knot), against the JAX package's."""
    c = cartpole
    kw = dict(c["common"], sqp_iters=4)
    kw.pop("max_iter")
    jsolve = jax.jit(j_sqp(c["m"].pred_core, c["jcost"], backward="assoc", **kw))
    tsolve = t_sqp(c["t"].pred_core, c["tcost"], backward="assoc", **kw)
    usg = np.random.default_rng(3).normal(size=(3, H_S, 1))
    xs_t, us_t = tsolve(c["t"].params, T(c["x0"][:3]), torch.zeros(3, H_S + 1, 4), T(usg))
    for b in range(3):
        xs_j, us_j = jsolve(c["m"].params, J(c["x0"][b]), jnp.zeros((H_S + 1, 4)), J(usg[b]))
        _close(us_t[b], us_j, 1e-8)
        _close(xs_t[b], xs_j, 1e-8)


# ---- (c) the feature library's closed-form Jacobian ----------------------------

def test_feature_jacobian_and_grad_terms_match_jax():
    """The cartpole's trig + interaction library and a polynomial one with
    cross terms and two trig frequencies; ``compositions`` as the JAX
    library enumerates the cross terms' exponents."""
    from autompc_torch.sysid.basis import compositions

    for cfg in (dict(trig_basis=True, trig_freq=1, trig_interaction=True),
                dict(poly_basis=True, poly_degree=3, poly_cross_terms=True, trig_basis=True,
                     trig_freq=2)):
        jl, tl = JLib.from_config(5, **cfg), TLib.from_config(5, **cfg)
        z = np.random.default_rng(2).normal(size=(3, 7, 5))
        Jt = tl.jacobian(T(z))
        assert Jt.shape == (3, 7, tl.n_features, 5)
        _close(Jt, jl.jacobian(J(z)), 1e-12)
        for gj, gt in zip(jl.grad_terms, tl.grad_terms):
            assert [ci for ci, _ in gt] == [ci for ci, _ in gj]
            for (_, fj), (_, ft) in zip(gj, gt):
                _close(float(ft(T(z[0, 0]))), float(fj(J(z[0, 0]))), 1e-12)
    assert list(compositions(4, 2)) == [(1, 3), (2, 2), (3, 1)]


# ---- (d) the kernels' new modes, plain versions ---------------------------------

ALPHAS = tuple(0.2 ** k for k in range(5))


def _k3_inputs(seed, B=6, H=6, ds=4):
    rng = np.random.default_rng(seed)
    obj0 = rng.uniform(2.0, 30.0, B)
    return dict(
        x0=rng.uniform(-1, 1, (B, ds)), xs=rng.uniform(-1, 1, (B, H + 1, ds)),
        us=rng.uniform(-2, 2, (B, H, 1)), Ks=rng.normal(size=(B, H, 1, ds)) * 0.3,
        ks=rng.normal(size=(B, H, 1)), obj0=obj0, lin=-rng.uniform(0.1, 5.0, B) * obj0 / 10,
        quad=-rng.uniform(0.1, 5.0, B), ks_small=np.arange(B) == 1,
        goal=rng.normal(0, 0.1, ds),
    )


def _k3_pair(d, jterms, jgrads, jcoef, tterms, tcoef, cost_j, cost_t, per_lane):
    ref = pallas_fused_line_search(
        jterms, *(J(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")), jcoef, J(ALPHAS),
        -20.0, 20.0, *cost_j, J(d["goal"]), 0.05,
        *(J(d[k]) for k in ("obj0", "lin", "quad", "ks_small")),
        grad_terms=jgrads, block_b=d["x0"].shape[0], interpret=True, ll_io=False,
        per_lane_diag_cost=per_lane)
    got = TK3.fused_line_search_bm(
        tterms, *(T(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")), tcoef, ALPHAS, -20.0,
        20.0, *cost_t, tuple(d["goal"]), 0.05,
        *(T(d[k]) for k in ("obj0", "lin", "quad", "ks_small")))
    for name, g, r in zip(("xs", "us", "obj", "succ", "fail", "Jx", "Ju"), got, ref):
        if name in ("succ", "fail"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        else:
            _close(g.numpy(), r, 1e-9, name)
    return got


def test_dense_fixed_cost_plain_matches_pallas(cartpole):
    """K3's DENSE form: one fixed Q, R, F with off-diagonal entries, every
    quadratic form over all obsdim^2 terms."""
    c, d = cartpole, _k3_inputs(0)
    m, t = c["m"], c["t"]
    active = tuple(int(k) for k in np.flatnonzero(np.any(np.asarray(m.coeffs) != 0, 0)))
    Q = np.diag([3.0, 0.5, 0.2, 0.1])
    Q[0, 1] = Q[1, 0] = 0.4
    F = 2.0 * Q
    F[2, 3] = F[3, 2] = 0.05
    R = np.array([[0.01]])
    got = _k3_pair(d, tuple(m.library._fns[k] for k in active),
                   tuple(m.library.grad_terms[k] for k in active),
                   m.coeffs[:, jnp.asarray(active)], tuple(t.library.terms[k] for k in active),
                   t.coeffs[:, list(active)], (J(Q), J(R), J(F)), (Q, R, F), False)
    # Without Jacobians (relin="xla") the rest is the same, to the bit.
    args = (tuple(t.library.terms[k] for k in active),
            *(T(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")), t.coeffs[:, list(active)],
            ALPHAS, -20.0, 20.0, Q, R, F, tuple(d["goal"]), 0.05,
            *(T(d[k]) for k in ("obj0", "lin", "quad", "ks_small")))
    nojac = TK3.fused_line_search_bm(*args, jac=False)
    assert nojac[5] is None and nojac[6] is None
    for a, b_ in zip(nojac[:5] + nojac[7:], got[:5] + got[7:]):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("n_terms", [None, 65])
def test_dense_fixed_cost_per_lane_coefficients_match_pallas(cartpole, n_terms):
    """K3's DENSE form with a model a lane (the batch-major body's
    batch_params under a fixed non-diagonal cost): the cartpole model's
    active terms at (4, 1), each lane's coefficients scaled apart (the
    <= 64-term instance), and 65 terms of a (1, 1) trig + interaction
    library (the instance past 64, on the device table)."""
    if n_terms is None:
        c, d = cartpole, _k3_inputs(2)
        m, t = c["m"], c["t"]
        active = tuple(int(k) for k in np.flatnonzero(np.any(np.asarray(m.coeffs) != 0, 0)))
        scale = 1 + 0.05 * np.random.default_rng(8).normal(size=(6, 4, len(active)))
        C = np.asarray(m.coeffs)[None][:, :, list(active)] * scale
        jfns = tuple(m.library._fns[k] for k in active)
        jgrads = tuple(m.library.grad_terms[k] for k in active)
        tterms = tuple(t.library.terms[k] for k in active)
        Q = np.diag([3.0, 0.5, 0.2, 0.1])
        Q[0, 1] = Q[1, 0] = 0.4
        F = 2.0 * Q
        F[2, 3] = F[3, 2] = 0.05
    else:
        cfg = dict(trig_basis=True, trig_freq=8, trig_interaction=True)
        jl, tl = JLib.from_config(2, **cfg), TLib.from_config(2, **cfg)
        d = _k3_inputs(3, B=4, H=4, ds=1)
        C = np.random.default_rng(9).normal(0, 0.02, (4, 1, n_terms))
        C[:, :, :1] += 1.0
        jfns, jgrads = tuple(jl._fns[:n_terms]), tuple(jl.grad_terms[:n_terms])
        tterms = tuple(tl.terms[:n_terms])
        Q, F = np.array([[1.5]]), np.array([[4.0]])
    R = np.array([[0.01]])
    _k3_pair(d, jfns, jgrads, J(C), tterms, T(C).permute(1, 2, 0).contiguous(),
             (J(Q), J(R), J(F)), (Q, R, F), False)


def test_per_lane_plain_past_64_terms_matches_pallas():
    """K3's batch-major entry with per-lane coefficients over 65 terms
    (past the shared instances' 64: the first 65 of a (ds, dc) = (1, 1)
    trig + interaction library to the eighth frequency), each lane its
    own model."""
    cfg = dict(trig_basis=True, trig_freq=8, trig_interaction=True)
    jl, tl = JLib.from_config(2, **cfg), TLib.from_config(2, **cfg)
    n = 65
    d = _k3_inputs(1, B=4, H=4, ds=1)
    C = np.random.default_rng(5).normal(0, 0.02, (4, 1, n))
    C[:, :, :1] += 1.0
    qd, rd, fd = (np.random.default_rng(6).uniform(0.1, 5, (4, 1)) for _ in range(3))
    _k3_pair(d, tuple(jl._fns[:n]), tuple(jl.grad_terms[:n]), J(C), tuple(tl.terms[:n]),
             T(C).permute(1, 2, 0).contiguous(), (J(qd), J(rd), J(fd)),
             tuple(T(v).T.contiguous() for v in (qd, rd, fd)), True)


def _mlp(widths, seed, dtype):
    rng = np.random.default_rng(seed)
    layers = [(rng.normal(0, 1 / np.sqrt(a), (a, b)), rng.normal(0, 0.1, b))
              for a, b in zip(widths[:-1], widths[1:])]
    return [tuple(v.astype(dtype) for v in la) for la in layers]


def _mlp_inputs(seed, B, H, ds, dc, dtype):
    rng = np.random.default_rng(seed)
    return {k: v.astype(dtype) for k, v in dict(
        x0=rng.uniform(-0.5, 0.5, (B, ds)), xs=rng.uniform(-0.5, 0.5, (B, H + 1, ds)),
        us=rng.uniform(-0.3, 0.3, (B, H, dc)), Ks=rng.normal(0, 0.3, (B, H, dc, ds)),
        ks=rng.normal(0, 0.3, (B, H, dc))).items()}


MLP_W, MLP_DS, MLP_DC, MLP_B, MLP_H = [6, 12, 12, 4], 4, 2, 4, 5
MLP_KEYS = ("x0", "xs", "us", "Ks", "ks")


def test_mlp_bf16x3_plain_matches_pallas_feat3(cartpole):
    """K5's three-pass split (float32) against the TPU kernel's feat3 form
    in interpret mode; the solver's ``mlp_ls`` precision reaches K5."""
    layers = _mlp(MLP_W, 0, np.float32)
    d = _mlp_inputs(1, MLP_B, MLP_H, MLP_DS, MLP_DC, np.float32)
    ref = pallas_mlp_line_search(
        tuple((J(W), J(b)) for W, b in layers), "tanh", *(J(d[k]) for k in MLP_KEYS),
        J(np.asarray(ALPHAS, np.float32)), -1.0, 1.0, block_b=MLP_B, interpret=True,
        layout="feat", precision="bf16x3")
    got = TK5.mlp_line_search(tuple((T(W), T(b)) for W, b in layers), "tanh",
                              *(T(d[k]) for k in MLP_KEYS), ALPHAS, -1.0, 1.0,
                              layout="feat", precision="bf16x3")
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        scale = float(np.abs(np.asarray(r)).max())
        _close(g.numpy() / scale, np.asarray(r) / scale, 1e-5)
    # The split is not the true float32 product: it moves the rollout.
    full = TK5.mlp_line_search(tuple((T(W), T(b)) for W, b in layers), "tanh",
                               *(T(d[k]) for k in MLP_KEYS), ALPHAS, -1.0, 1.0)
    assert not torch.equal(full[0], got[0])
    with pytest.raises(ValueError, match="layout='feat'"):
        TK5.mlp_line_search(tuple((T(W), T(b)) for W, b in layers), "tanh",
                            *(T(d[k]) for k in MLP_KEYS), ALPHAS, -1.0, 1.0,
                            layout="slab", precision="bf16x3")
    _precision_reaches_the_line_search(cartpole, "bf16x3")


def _bf16(a):
    """bfloat16 rounding of a float64 array through float32, as the
    port's plain version rounds."""
    return jnp.asarray(a).astype(jnp.float32).astype(jnp.bfloat16).astype(jnp.float64)


def test_mlp_default_plain_matches_bf16_reference(cartpole):
    """K5's single bfloat16 pass (float64 sums) against the JAX package's
    line search rollout (``tests/test_pallas_mlp_linesearch.py``'s
    ``_reference_ls``) with each product rounded as the TPU kernel of
    each layout rounds it at ``Precision.DEFAULT``: "feat" every
    product's operands (``_mlp_ls_kernel_feat``'s dot_generals), "mxu"
    all but the first layer's control rows (``_mlp_ls_kernel_mxu`` adds
    them as float32 rank-1 updates), "slab" none (``_mlp_ls_kernel``
    multiplies on the VPU whatever the precision); the solver's
    ``mlp_ls`` precision reaches K5."""
    layers = _mlp(MLP_W, 2, np.float64)
    d = _mlp_inputs(3, MLP_B, MLP_H, MLP_DS, MLP_DC, np.float64)

    def reference(layout):
        rnd = (lambda a: J(a)) if layout == "slab" else _bf16
        jlayers = [(rnd(W), J(b)) for W, b in layers]

        def pred(x, u):
            (W1, b1), rest = jlayers[0], jlayers[1:]
            if layout == "mxu":
                a = _bf16(x) @ W1[:MLP_DS] + u @ J(layers[0][0][MLP_DS:]) + b1
            else:
                a = rnd(jnp.concatenate([x, u])) @ W1 + b1
            h = a if not rest else jnp.tanh(a)
            for li, (W, b) in enumerate(rest):
                a = rnd(h) @ W + b
                h = a if li == len(rest) - 1 else jnp.tanh(a)
            return x + h

        def one(x0, xs, us, Ks, ks):
            def rollout(alpha):
                def step(x, inp):
                    xbar, ubar, K, k = inp
                    u = jnp.clip(alpha * k + ubar + K @ (x - xbar), -1.0, 1.0)
                    x1 = pred(x, u)
                    return x1, (x1, u)

                _, (xs1, us1) = jax.lax.scan(step, x0, (xs[:MLP_H], us, Ks, ks))
                return jnp.concatenate([x0[None], xs1], axis=0), us1

            return jax.vmap(rollout)(J(ALPHAS))

        return jax.vmap(one)(*(J(d[k]) for k in MLP_KEYS))

    outs = {}
    for layout in ("slab", "feat", "mxu"):
        got = TK5.mlp_line_search(tuple((T(W), T(b)) for W, b in layers), "tanh",
                                  *(T(d[k]) for k in MLP_KEYS), ALPHAS, -1.0, 1.0,
                                  layout=layout, precision="default")
        for g, r in zip(got, reference(layout)):
            _close(g, r, 1e-9, layout)
        outs[layout] = got[0]
    # The three layouts' roundings are three functions.
    assert not torch.equal(outs["slab"], outs["feat"])
    assert not torch.equal(outs["mxu"], outs["feat"])
    _precision_reaches_the_line_search(cartpole, "default")


def _precision_reaches_the_line_search(cartpole, precision):
    """The batch-major body's ``mlp_ls`` precision reaches K5 (JAX's own
    CPU run cannot show the TPU's rounding): its first iteration's
    rollouts are the line search's at that precision, not at "highest"."""
    c = cartpole
    system = c["tb"].system
    from autompc_torch.sysid.mlp import MLP as TMLP

    mlp = TMLP(system, n_hidden_layers=2, hidden_size=8, nonlintype="tanh", device="cpu")
    rng = np.random.default_rng(7)
    mlp.set_parameters({
        "net_params": [{"W": rng.normal(0, 1 / np.sqrt(a), (a, b)), "b": rng.normal(0, 0.1, b)}
                       for a, b in zip(mlp._sizes[:-1], mlp._sizes[1:])],
        "xu_means": np.zeros(5), "xu_std": np.ones(5), "dy_means": np.zeros(4),
        "dy_std": 0.1 * np.ones(4)})
    kw = dict(c["common"], max_iter=1, pred_diff=mlp.pred_diff_core,
              mlp_ls=dict(nonlin="tanh", layout="feat", precision=precision))
    seen = []
    real = tilqr.mlp_line_search

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append((a, k, out))
        return out

    tilqr.mlp_line_search = spy
    try:
        tilqr.make_batched_ilqr_solver(mlp.pred_core, c["tcost"], **kw)(
            mlp.params, T(c["x0"]), T(c["ug"]))
    finally:
        tilqr.mlp_line_search = real
    (a, k, out), = seen
    assert k["precision"] == precision
    plain = TK5.mlp_line_search_plain(*a, layout="feat", precision=precision)
    full = TK5.mlp_line_search_plain(*a, layout="feat", precision="highest")
    assert all(torch.equal(x, y) for x, y in zip(out, plain))
    assert not torch.equal(out[0], full[0])
