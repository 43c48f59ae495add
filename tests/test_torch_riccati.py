"""K2 plain twin (ops/cuda_riccati.py) vs the JAX Pallas kernel
pallas_tvlqr_backward_quad_ll (interpret mode), float64, 1e-12, with the
cost as host constants and as per-lane planes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.ops.cuda_riccati import backward_quad_ll
from autompc_tpu.ops.pallas_riccati import pallas_tvlqr_backward_quad_ll

# The tensors here are small: one intra-op thread (six test workers with a
# thread pool each oversubscribe the cores).
torch.set_num_threads(1)


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


# ---- the wide forms (B % 1024 == 0): rows 3 and 4 of the kernel table ----
# The JAX wide kernels run T time steps per grid cell, fully unrolled;
# T = 1 (AMPC_BQ_WIDE_T, a tile knob that does not change the math)
# keeps their interpret-mode compile to seconds.

def _wide_inputs(seed, B=1024, H=10, jac_dtype=np.float64):
    d = _inputs(seed, B=B, H=H)
    qd, rd, fd = _planes(seed, B)
    d.update(qdT=qd, rdT=rd, fdT=fd)
    d["jac_j"] = jnp.asarray(d["jac"]).astype(jac_dtype)
    d["jac_t"] = torch.as_tensor(d["jac"]).to(
        torch.bfloat16 if jac_dtype == jnp.bfloat16 else torch.float64)
    return d


def _cost_args(d, form):
    """(JAX planes, port cost) for one cost form: the fixed cost, which
    the JAX solver hands the kernel as broadcast planes and the port as
    host constants, or random per-lane planes."""
    B = d["us"].shape[1]
    T = torch.as_tensor
    if form == "fixed":
        col = lambda v: np.repeat(np.asarray(v)[:, None], B, axis=1)
        return ((col(d["qd"]), col(d["rd"]), col(d["fd"])),
                (tuple(d["qd"]), tuple(d["rd"]), tuple(d["fd"])))
    planes = (d["qdT"], d["rdT"], d["fdT"])
    return planes, tuple(T(p) for p in planes)


@pytest.mark.parametrize("wide_io", ["cast", "reshape"])
@pytest.mark.parametrize("form", ["fixed", "per_lane"])
def test_backward_wide_forms_match_pallas(monkeypatch, wide_io, form):
    """K2's plain version against the TPU's wide kernels (rows 3 and 4:
    ``wide="on"`` with cast IO and with reshape IO), with carry, 1e-12."""
    monkeypatch.setenv("AMPC_BQ_WIDE_T", "1")
    d = _wide_inputs(30)
    jplanes, tcost = _cost_args(d, form)
    ref = pallas_tvlqr_backward_quad_ll(
        d["jac_j"], jnp.asarray(d["xs"]), jnp.asarray(d["us"]),
        *(jnp.asarray(p) for p in jplanes), jnp.asarray(d["goal"]), 0.05, 4,
        interpret=True, wide="on", wide_io=wide_io,
        carry=(jnp.asarray(d["act"]), jnp.asarray(d["oK"]), jnp.asarray(d["ok"])),
    )
    T = torch.as_tensor
    got = backward_quad_ll(
        d["jac_t"], T(d["xs"]), T(d["us"]), *tcost, tuple(d["goal"]), 0.05, 4,
        carry=(T(d["act"]), T(d["oK"]), T(d["ok"])), wide="on", wide_io=wide_io,
    )
    for name, g, r in zip(("Ks", "ks", "lin", "quad"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("form", ["fixed", "per_lane"])
def test_backward_wide_4d_matches_pallas(monkeypatch, form):
    """The reshape-IO entry itself (row 4): pre-split (..., nl, 128)
    arrays, a separate terminal state, cost planes, a 0/1 float act plane
    as the TPU's wrapper builds it; every output against
    ``_backward_quad_ll_wide_4d``, 1e-12."""
    from autompc_torch.ops.cuda_riccati import backward_quad_ll_wide_4d
    from autompc_tpu.ops.pallas_riccati import _backward_quad_ll_wide_4d

    monkeypatch.setenv("AMPC_BQ_WIDE_T", "1")
    d = _wide_inputs(31)
    H, B = d["us"].shape
    nl = B // 128
    planes, _ = _cost_args(d, form)
    four = dict(
        jac4=d["jac"].reshape(H, 20, nl, 128), xs4=d["xs"][:H].reshape(H, 4, nl, 128),
        xterm=d["xs"][H].reshape(4, nl, 128), us4=d["us"].reshape(H, nl, 128),
        Qd4=planes[0].reshape(4, nl, 128), Rd4=planes[1].reshape(1, nl, 128),
        Fd4=planes[2].reshape(4, nl, 128),
    )
    goal2 = d["goal"].reshape(4, 1)
    carry4 = (d["act"].astype(float).reshape(1, nl, 128), d["oK"].reshape(H, 4, nl, 128),
              d["ok"].reshape(H, nl, 128))
    ref = _backward_quad_ll_wide_4d(
        *(jnp.asarray(v) for v in four.values()), jnp.asarray(goal2), 0.05, 4, True,
        tuple(jnp.asarray(a) for a in carry4),
    )
    T = torch.as_tensor
    got = backward_quad_ll_wide_4d(
        *(T(v) for v in four.values()), T(goal2), 0.05, 4, tuple(T(a) for a in carry4),
    )
    for name, g, r in zip(("Ks", "ks", "lin", "quad"), got, ref):
        assert tuple(g.shape) == tuple(r.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("wide_io", ["cast", "reshape"])
def test_backward_bf16_jacobians_match_pallas(monkeypatch, wide_io):
    """A bfloat16 Jacobian plane (the ``jac_dtype="bf16"`` carry), upcast
    at the read in both packages; the rest in float64, 1e-12."""
    monkeypatch.setenv("AMPC_BQ_WIDE_T", "1")
    d = _wide_inputs(32, jac_dtype=jnp.bfloat16)
    assert d["jac_t"].dtype == torch.bfloat16
    np.testing.assert_array_equal(d["jac_t"].double().numpy(),
                                  np.asarray(d["jac_j"].astype(jnp.float64)))
    jplanes, tcost = _cost_args(d, "per_lane")
    ref = pallas_tvlqr_backward_quad_ll(
        d["jac_j"], jnp.asarray(d["xs"]), jnp.asarray(d["us"]),
        *(jnp.asarray(p) for p in jplanes), jnp.asarray(d["goal"]), 0.05, 4,
        interpret=True, wide_io=wide_io,
        carry=(jnp.asarray(d["act"]), jnp.asarray(d["oK"]), jnp.asarray(d["ok"])),
    )
    T = torch.as_tensor
    got = backward_quad_ll(
        d["jac_t"], T(d["xs"]), T(d["us"]), *tcost, tuple(d["goal"]), 0.05, 4,
        carry=(T(d["act"]), T(d["oK"]), T(d["ok"])), wide_io=wide_io,
    )
    for name, g, r in zip(("Ks", "ks", "lin", "quad"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


def test_backward_wide_options_validate():
    """The TPU entry's checks, and every form giving the same values."""
    d = _inputs(33)
    T = torch.as_tensor
    args = (T(d["jac"]), T(d["xs"]), T(d["us"]), tuple(d["qd"]), tuple(d["rd"]),
            tuple(d["fd"]), tuple(d["goal"]), 0.05, 4, (T(d["act"]), T(d["oK"]), T(d["ok"])))
    with pytest.raises(ValueError, match="wide must be"):
        backward_quad_ll(*args, wide="yes")
    with pytest.raises(ValueError, match="wide_io must be"):
        backward_quad_ll(*args, wide_io="copy")
    with pytest.raises(ValueError, match="B % 1024"):
        backward_quad_ll(*args, wide="on")
    ref = backward_quad_ll(*args)
    for kw in (dict(wide="off"), dict(wide_io="reshape")):
        for a, b in zip(backward_quad_ll(*args, **kw), ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["fixed", "per_lane"])
def test_backward_reshape_io_equals_cast_io(form):
    """At B = 1024 the reshape-IO route (the 4D entry on views, fixed
    costs as planes) returns the cast-IO route's values bit for bit."""
    d = _wide_inputs(34)
    _, tcost = _cost_args(d, form)
    T = torch.as_tensor
    args = (d["jac_t"], T(d["xs"]), T(d["us"]), *tcost, tuple(d["goal"]), 0.05, 4,
            (T(d["act"]), T(d["oK"]), T(d["ok"])))
    for a, b in zip(backward_quad_ll(*args, wide_io="reshape"),
                    backward_quad_ll(*args, wide_io="cast")):
        assert torch.equal(a, b)
