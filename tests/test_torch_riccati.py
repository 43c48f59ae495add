"""K2 plain twin (ops/cuda_riccati.py) vs the JAX Pallas kernel
pallas_tvlqr_backward_quad_ll (interpret mode), float64, 1e-12, with the
cost as host constants and as per-lane planes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.ops.cuda_riccati import backward_quad_ll
from autompc_tpu.ops.pallas_riccati import pallas_tvlqr_backward_quad_ll


def _inputs(seed, B=8, H=12, ds=4):
    rng = np.random.default_rng(seed)
    return dict(
        jac=rng.normal(0, 0.3, (H, ds * (ds + 1), B)),
        xs=rng.normal(size=(H + 1, ds, B)),
        us=rng.normal(size=(H, B)),
        act=rng.uniform(size=B) > 0.4,
        oK=rng.normal(size=(H, ds, B)),
        ok=rng.normal(size=(H, B)),
        qd=rng.uniform(0.1, 2.0, 4), rd=rng.uniform(0.1, 2.0, 1),
        fd=rng.uniform(0.1, 2.0, 4), goal=rng.normal(size=4),
    )


@pytest.mark.parametrize("lanes", ["mixed", "all_active"])
def test_backward_twin_matches_pallas(lanes):
    d = _inputs(3)
    if lanes == "all_active":
        d["act"][:] = True
    B, dt = d["us"].shape[1], 0.05
    col = lambda v: jnp.asarray(np.repeat(v[:, None], B, axis=1))
    ref = pallas_tvlqr_backward_quad_ll(
        jnp.asarray(d["jac"]), jnp.asarray(d["xs"]), jnp.asarray(d["us"]),
        col(d["qd"]), col(d["rd"]), col(d["fd"]), jnp.asarray(d["goal"]),
        dt, 4, block_b=B, interpret=True,
        carry=(jnp.asarray(d["act"]), jnp.asarray(d["oK"]), jnp.asarray(d["ok"])),
    )
    T = torch.as_tensor
    got = backward_quad_ll(
        T(d["jac"]), T(d["xs"]), T(d["us"]), tuple(d["qd"]), tuple(d["rd"]),
        tuple(d["fd"]), tuple(d["goal"]), dt, 4,
        carry=(T(d["act"]), T(d["oK"]), T(d["ok"])),
    )
    for name, g, r in zip(("Ks", "ks", "lin", "quad"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    inactive = ~d["act"]
    np.testing.assert_array_equal(got[0].numpy()[:, :, inactive], d["oK"][:, :, inactive])


def test_backward_twin_obsdim_below_ds():
    """obsdim < ds: the unobserved state dims carry no stage or terminal
    cost."""
    d = _inputs(4)
    B = d["us"].shape[1]
    col = lambda v: jnp.asarray(np.repeat(v[:3, None], B, axis=1))
    ref = pallas_tvlqr_backward_quad_ll(
        jnp.asarray(d["jac"]), jnp.asarray(d["xs"]), jnp.asarray(d["us"]),
        col(d["qd"]), jnp.asarray(np.repeat(d["rd"][:, None], B, axis=1)),
        col(d["fd"]), jnp.asarray(d["goal"][:3]), 0.05, 3, block_b=B,
        interpret=True,
    )
    T = torch.as_tensor
    got = backward_quad_ll(
        T(d["jac"]), T(d["xs"]), T(d["us"]), tuple(d["qd"][:3]), tuple(d["rd"]),
        tuple(d["fd"][:3]), tuple(d["goal"][:3]), 0.05, 3,
        carry=(torch.ones(B, dtype=torch.bool), T(d["oK"]), T(d["ok"])),
    )
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12)


def test_backward_wrapper_validates():
    d = _inputs(5)
    T = torch.as_tensor
    carry = (T(d["act"]), T(d["oK"]), T(d["ok"]))
    with pytest.raises(ValueError, match="rows"):
        backward_quad_ll(T(d["jac"][:, :19]), T(d["xs"]), T(d["us"]),
                         tuple(d["qd"]), tuple(d["rd"]), tuple(d["fd"]),
                         tuple(d["goal"]), 0.05, 4, carry)
    with pytest.raises(ValueError, match="carry"):
        backward_quad_ll(T(d["jac"]), T(d["xs"]), T(d["us"]), tuple(d["qd"]),
                         tuple(d["rd"]), tuple(d["fd"]), tuple(d["goal"]), 0.05, 4,
                         (carry[0][:3], carry[1], carry[2]))
    with pytest.raises(ValueError, match="meta"):
        backward_quad_ll(T(d["jac"]).to("meta"), T(d["xs"]).to("meta"),
                         T(d["us"]).to("meta"), tuple(d["qd"]), tuple(d["rd"]),
                         tuple(d["fd"]), tuple(d["goal"]), 0.05, 4,
                         tuple(t.to("meta") for t in carry))


def _planes(seed, B, obsdim=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 5.0, (obsdim, B)), rng.uniform(0.01, 1.0, (1, B)),
            rng.uniform(0.1, 5.0, (obsdim, B)))


@pytest.mark.parametrize("seed, obsdim", [(11, 4), (12, 4), (13, 3)])
def test_backward_per_lane_planes_match_pallas(seed, obsdim):
    """Per-lane cost planes (obsdim, B) / (1, B): every lane its own
    diagonals, as the cost fan-out hands them to the kernel."""
    d = _inputs(seed)
    B = d["us"].shape[1]
    qd, rd, fd = _planes(seed, B, obsdim)
    goal = d["goal"][:obsdim]
    carry = (d["act"], d["oK"], d["ok"])
    ref = pallas_tvlqr_backward_quad_ll(
        jnp.asarray(d["jac"]), jnp.asarray(d["xs"]), jnp.asarray(d["us"]),
        jnp.asarray(qd), jnp.asarray(rd), jnp.asarray(fd), jnp.asarray(goal),
        0.05, obsdim, block_b=B, interpret=True,
        carry=tuple(jnp.asarray(a) for a in carry),
    )
    T = torch.as_tensor
    got = backward_quad_ll(
        T(d["jac"]), T(d["xs"]), T(d["us"]), T(qd), T(rd), T(fd), tuple(goal),
        0.05, obsdim, carry=tuple(T(a) for a in carry),
    )
    for name, g, r in zip(("Ks", "ks", "lin", "quad"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-10, err_msg=name)


def test_backward_per_lane_identical_rows_equal_fixed_cost():
    """Planes whose lanes all hold the fixed cost give the fixed-cost
    call's result exactly."""
    d = _inputs(14)
    B = d["us"].shape[1]
    T = torch.as_tensor
    args = (T(d["jac"]), T(d["xs"]), T(d["us"]))
    kw = dict(carry=(T(d["act"]), T(d["oK"]), T(d["ok"])))
    fixed = backward_quad_ll(*args, tuple(d["qd"]), tuple(d["rd"]), tuple(d["fd"]),
                             tuple(d["goal"]), 0.05, 4, **kw)
    rows = lambda v: T(np.repeat(np.asarray(v)[:, None], B, axis=1))
    lane = backward_quad_ll(*args, rows(d["qd"]), rows(d["rd"]), rows(d["fd"]),
                            tuple(d["goal"]), 0.05, 4, **kw)
    for f, l in zip(fixed, lane):
        np.testing.assert_array_equal(f.numpy(), l.numpy())


def test_backward_cost_forms_do_not_mix():
    d = _inputs(15)
    B = d["us"].shape[1]
    T = torch.as_tensor
    qd, rd, fd = _planes(15, B)
    carry = (T(d["act"]), T(d["oK"]), T(d["ok"]))
    with pytest.raises(ValueError, match="all host sequences"):
        backward_quad_ll(T(d["jac"]), T(d["xs"]), T(d["us"]), T(qd), tuple(d["rd"]),
                         T(fd), tuple(d["goal"]), 0.05, 4, carry)
    with pytest.raises(ValueError, match="qd: shape"):
        backward_quad_ll(T(d["jac"]), T(d["xs"]), T(d["us"]), T(qd[:, :3]), T(rd),
                         T(fd), tuple(d["goal"]), 0.05, 4, carry)
