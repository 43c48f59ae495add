"""K3 plain twin (ops/cuda_linesearch.py) vs the JAX Pallas kernel
pallas_fused_line_search(ll_io=True, carry=(act, old_jac), grad_terms)
in interpret mode, float64: success/failure flags exactly, every other
output to 1e-12; with the fixed cost and with per-lane cost planes
(per_lane_diag_cost=True)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.ops.cuda_linesearch import fused_line_search, line_search_objectives
from autompc_torch.sysid import SINDy as TSINDy
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.ops.pallas_linesearch import pallas_fused_line_search
from autompc_tpu.sysid import SINDy

Q = np.diag([10.0, 0.1, 0.01, 0.01])
R = 0.001 * np.eye(1)
ALPHAS = tuple(0.2 ** k for k in range(10))


@pytest.fixture(scope="module")
def model():
    b = CartpoleSwingupBenchmark()
    m = SINDy(b.system, method="lstsq", threshold=1e-3, trig_basis=True,
              trig_freq=1, trig_interaction=True)
    m.train(b.gen_trajs_batch(seed=42, n_trajs=40, traj_len=60))
    t = TSINDy(b.system, device="cpu", method="lstsq", trig_basis=True, trig_freq=1,
               trig_interaction=True)
    t.set_parameters({**m.get_parameters(), "feature_names": m.get_feature_names()})
    active = tuple(int(k) for k in np.flatnonzero(np.any(np.asarray(m.coeffs) != 0, axis=0)))
    return m, t, active


def _inputs(seed, B=16, H=10, ds=4):
    rng = np.random.default_rng(seed)
    obj0 = rng.uniform(2.0, 30.0, B)
    return dict(
        x0=rng.uniform(-1, 1, (ds, B)),
        xs=rng.uniform(-1, 1, (H + 1, ds, B)),
        us=rng.uniform(-2, 2, (H, B)),
        Ks=rng.normal(size=(H, ds, B)) * 0.3,
        ks=rng.normal(size=(H, B)),
        obj0=obj0,
        lin=-rng.uniform(0.1, 5.0, B) * obj0 / 10,
        quad=-rng.uniform(0.1, 5.0, B),
        ks_small=rng.uniform(size=B) < 0.15,
        act=rng.uniform(size=B) > 0.25,
        old_jac=rng.normal(size=(H, ds * (ds + 1), B)),
    )


def _run_both(model, d, F, goal, dt=0.05):
    m, t, active = model
    gts = m.library.grad_terms
    ref = pallas_fused_line_search(
        tuple(m.library._fns[k] for k in active), *(jnp.asarray(d[k]) for k in
                                                    ("x0", "xs", "us", "Ks", "ks")),
        m.coeffs[:, jnp.asarray(active)], jnp.asarray(ALPHAS), -20.0, 20.0,
        jnp.asarray(Q), jnp.asarray(R), jnp.asarray(F), jnp.asarray(goal), dt,
        *(jnp.asarray(d[k]) for k in ("obj0", "lin", "quad", "ks_small")),
        grad_terms=tuple(gts[k] for k in active), block_b=d["us"].shape[1],
        interpret=True, ll_io=True,
        carry=(jnp.asarray(d["act"]), jnp.asarray(d["old_jac"])),
    )
    T = torch.as_tensor
    got = fused_line_search(
        tuple(t.library.terms[k] for k in active),
        *(T(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")),
        t.coeffs[:, list(active)], ALPHAS, -20.0, 20.0, tuple(np.diag(Q)),
        tuple(np.diag(R)), tuple(np.diag(F)), tuple(goal), dt,
        *(T(d[k]) for k in ("obj0", "lin", "quad", "ks_small", "act", "old_jac")),
    )
    return ref, got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_line_search_twin_matches_pallas(model, seed):
    d = _inputs(seed)
    ref, got = _run_both(model, d, F=Q, goal=np.zeros(4))
    names = ("xs", "us", "obj", "succ", "fail", "jac", "du2")
    for name, g, r in zip(names, got, ref):
        if name in ("succ", "fail"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                       atol=1e-12, err_msg=name)
    succ, fail = got[3].numpy(), got[4].numpy()
    assert succ.any() and (~succ).any()
    # Lanes that are inactive or failed keep their old carry.
    keep = ~d["act"] | fail
    np.testing.assert_array_equal(got[0].numpy()[:, :, keep], d["xs"][:, :, keep])


def test_fused_line_search_twin_goal_and_terminal_cost(model):
    d = _inputs(7)
    F = np.diag([3.0, 0.5, 0.2, 0.1])
    goal = np.array([0.3, -0.1, 0.2, 0.0])
    ref, got = _run_both(model, d, F=F, goal=goal)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12)


def test_objectives_pick_the_twin_choice(model):
    """Pass 1 alone (what chip_smoke.py uses to read the kernel's chosen
    step size) returns the objective the full twin accepts."""
    m, t, active = model
    d = _inputs(3)
    d["act"][:] = True
    T = torch.as_tensor
    terms = tuple(t.library.terms[k] for k in active)
    coeffs = t.coeffs[:, list(active)]
    args = (terms, *(T(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")), coeffs,
            ALPHAS, -20.0, 20.0, tuple(np.diag(Q)), (0.001,), tuple(np.diag(Q)),
            (0.0,) * 4, 0.05)
    objs = line_search_objectives(*args)
    out = fused_line_search(*args, *(T(d[k]) for k in
                                     ("obj0", "lin", "quad", "ks_small", "act", "old_jac")))
    moved = ~out[4].numpy()
    dist = (objs - out[2][None]).abs().min(0).values.numpy()
    np.testing.assert_array_equal(dist[moved], 0.0)


def _run_both_per_lane(model, d, qd, rd, fd, goal, dt=0.05):
    m, t, active = model
    gts = m.library.grad_terms
    ref = pallas_fused_line_search(
        tuple(m.library._fns[k] for k in active), *(jnp.asarray(d[k]) for k in
                                                    ("x0", "xs", "us", "Ks", "ks")),
        m.coeffs[:, jnp.asarray(active)], jnp.asarray(ALPHAS), -20.0, 20.0,
        jnp.asarray(qd), jnp.asarray(rd), jnp.asarray(fd), jnp.asarray(goal), dt,
        *(jnp.asarray(d[k]) for k in ("obj0", "lin", "quad", "ks_small")),
        grad_terms=tuple(gts[k] for k in active), block_b=d["us"].shape[1],
        interpret=True, ll_io=True, per_lane_diag_cost=True,
        carry=(jnp.asarray(d["act"]), jnp.asarray(d["old_jac"])),
    )
    T = torch.as_tensor
    got = fused_line_search(
        tuple(t.library.terms[k] for k in active),
        *(T(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")),
        t.coeffs[:, list(active)], ALPHAS, -20.0, 20.0, T(qd), T(rd), T(fd),
        tuple(goal), dt,
        *(T(d[k]) for k in ("obj0", "lin", "quad", "ks_small", "act", "old_jac")),
    )
    return ref, got


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_fused_line_search_per_lane_cost_matches_pallas(model, seed):
    d = _inputs(seed)
    B = d["us"].shape[1]
    rng = np.random.default_rng(seed + 100)
    qd = 10 ** rng.uniform(-1, 1.5, (4, B))
    rd = 10 ** rng.uniform(-3, 0, (1, B))
    fd = 10 ** rng.uniform(-1, 1.5, (4, B))
    goal = np.array([0.1, 0.0, -0.2, 0.0]) if seed == 22 else np.zeros(4)
    ref, got = _run_both_per_lane(model, d, qd, rd, fd, goal)
    names = ("xs", "us", "obj", "succ", "fail", "jac", "du2")
    for name, g, r in zip(names, got, ref):
        if name in ("succ", "fail"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10,
                                       atol=1e-10, err_msg=name)
    assert got[3].numpy().any()


def test_fused_line_search_identical_rows_equal_fixed_cost(model):
    """Per-lane planes that repeat the fixed cost give the fixed-cost
    call's outputs exactly."""
    _, t, active = model
    d = _inputs(23)
    B = d["us"].shape[1]
    T = torch.as_tensor
    F = np.diag([3.0, 0.5, 0.2, 0.1])
    head = (tuple(t.library.terms[k] for k in active),
            *(T(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")),
            t.coeffs[:, list(active)], ALPHAS, -20.0, 20.0)
    tail = (tuple(np.zeros(4)), 0.05,
            *(T(d[k]) for k in ("obj0", "lin", "quad", "ks_small", "act", "old_jac")))
    fixed = fused_line_search(*head, tuple(np.diag(Q)), tuple(np.diag(R)),
                              tuple(np.diag(F)), *tail)
    rows = lambda v: T(np.repeat(np.asarray(v, dtype=float)[:, None], B, axis=1))
    lane = fused_line_search(*head, rows(np.diag(Q)), rows(np.diag(R)),
                             rows(np.diag(F)), *tail)
    for f, l in zip(fixed, lane):
        np.testing.assert_array_equal(f.numpy(), l.numpy())
