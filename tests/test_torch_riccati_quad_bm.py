"""K6 plain version (ops/cuda_riccati.py::backward_quad_plain) vs the JAX
Pallas kernel pallas_tvlqr_backward_quad in interpret mode, float64,
1e-10: batch-major arrays, per-lane cost diagonals, ds >= obsdim (ds = 12,
obsdim = 4: the Koopman lift that K6's second instance takes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.ops.cuda_riccati import (
    backward_quad,
    backward_quad_ll,
    backward_quad_plain,
)
from autompc_tpu.ops.pallas_riccati import pallas_tvlqr_backward_quad

torch.set_num_threads(1)


def _inputs(seed, B=8, H=9, ds=5, obsdim=4):
    rng = np.random.default_rng(seed)
    return dict(
        Jx=rng.normal(size=(B, H, ds, ds)) * 0.3, Ju=rng.normal(size=(B, H, ds, 1)),
        xs=rng.normal(size=(B, H + 1, ds)), us=rng.normal(size=(B, H, 1)),
        Qd=rng.uniform(0.1, 5.0, (B, obsdim)), Rd=rng.uniform(0.01, 1.0, (B, 1)),
        Fd=rng.uniform(0.1, 5.0, (B, obsdim)), goal=rng.normal(size=(obsdim,)),
    )


KEYS = ("Jx", "Ju", "xs", "us", "Qd", "Rd", "Fd")


@pytest.mark.parametrize("seed, ds, obsdim", [(3, 5, 4), (4, 4, 4), (5, 4, 2), (6, 3, 3),
                                             (9, 12, 4)])
def test_backward_quad_plain_matches_pallas(seed, ds, obsdim):
    d = _inputs(seed, ds=ds, obsdim=obsdim)
    ref = pallas_tvlqr_backward_quad(
        *(jnp.asarray(d[k]) for k in KEYS), jnp.asarray(d["goal"]), 0.05, obsdim,
        block_b=d["us"].shape[0], interpret=True,
    )
    got = backward_quad(*(torch.as_tensor(d[k]) for k in KEYS), tuple(d["goal"]),
                        0.05, obsdim)
    for name, g, r in zip(("Ks", "ks", "lin", "quad"), got, ref):
        assert tuple(g.shape) == tuple(r.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-10,
                                   err_msg=name)


def test_backward_quad_equals_the_lanes_last_recursion():
    """The batch-major and the lanes-last entry run one recursion: the
    same problem in both layouts gives the same gains exactly."""
    d = _inputs(7, ds=4, obsdim=4)
    T = torch.as_tensor
    B, H = d["us"].shape[:2]
    bm = backward_quad_plain(*(T(d[k]) for k in KEYS), tuple(d["goal"]), 0.05, 4)
    jac = torch.cat([T(d["Jx"]), T(d["Ju"])], dim=-1)               # (B, H, ds, ds+1)
    ll = backward_quad_ll(
        jac.permute(1, 2, 3, 0).reshape(H, 20, B), T(d["xs"]).permute(1, 2, 0),
        T(d["us"])[:, :, 0].T, T(d["Qd"]).T, T(d["Rd"]).T, T(d["Fd"]).T,
        tuple(d["goal"]), 0.05, 4,
        carry=(torch.ones(B, dtype=torch.bool), torch.zeros(H, 4, B, dtype=torch.float64),
               torch.zeros(H, B, dtype=torch.float64)),
    )
    np.testing.assert_array_equal(bm[0][:, :, 0].numpy(), ll[0].permute(2, 0, 1).numpy())
    np.testing.assert_array_equal(bm[1][:, :, 0].numpy(), ll[1].T.numpy())
    np.testing.assert_array_equal(bm[2].numpy(), ll[2].numpy())
    np.testing.assert_array_equal(bm[3].numpy(), ll[3].numpy())


@pytest.mark.parametrize("bad, match", [
    ("dc", "dc = 1"), ("Qd", "Qdiag: shape"), ("goal", "goal must have length"),
    ("meta", "meta"),
])
def test_backward_quad_validates(bad, match):
    d = _inputs(8, ds=4, obsdim=4)
    a = {k: torch.as_tensor(d[k]) for k in KEYS}
    goal = tuple(d["goal"])
    if bad == "dc":
        a["Ju"] = torch.zeros(8, 9, 4, 2, dtype=torch.float64)
    elif bad == "Qd":
        a["Qd"] = a["Qd"][:, :3]
    elif bad == "goal":
        goal = goal[:3]
    elif bad == "meta":
        a = {k: v.to("meta") for k, v in a.items()}
    with pytest.raises(ValueError, match=match):
        backward_quad(*(a[k] for k in KEYS), goal, 0.05, 4)
