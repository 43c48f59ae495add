"""K2 plain twin (ops/cuda_riccati.py) vs the JAX Pallas kernel
pallas_tvlqr_backward_quad_ll (interpret mode), float64, 1e-12."""

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
