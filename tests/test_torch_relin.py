"""K1 plain twins (ops/cuda_relin.py: the lanes-last and the batch-major
entry) vs the JAX Pallas kernel pallas_feature_jacobians (interpret
mode), float64, rtol/atol 1e-12; the batch-major entry is the lanes-last
one passed through the solver's former layout adapter, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.ops.cuda_relin import (
    relin_jacobians,
    relin_jacobians_bm,
    relin_jacobians_bm_plain,
    relin_jacobians_plain,
)
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.sysid.basis import FeatureLibrary
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.ops.pallas_relin import pallas_feature_jacobians
from autompc_tpu.sysid import SINDy


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


def _pack(Jx, Ju):
    """JAX batch-major (B,H,ds,ds)+(B,H,ds,1) -> packed (H, ds*(ds+1), B)."""
    jac = np.concatenate([np.asarray(Jx), np.asarray(Ju)], axis=-1)
    B, H, ds, d = jac.shape
    return jac.transpose(1, 2, 3, 0).reshape(H, ds * d, B)


def _check_batch_major(terms, xs, us, coeffs, Jx, Ju):
    """The batch-major entry against the JAX kernel's (Jx, Ju), and bit
    for bit against the lanes-last entry behind the adapter the
    batch-major solver body used before it had its own entry."""
    xs, us = torch.as_tensor(xs), torch.as_tensor(us)
    got = relin_jacobians_bm(terms, xs, us, coeffs)
    B, H = us.shape[:2]
    assert tuple(got[0].shape) == (B, H, 4, 4) and tuple(got[1].shape) == (B, H, 4, 1)
    for a, b in zip(got, (Jx, Ju)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    jac = relin_jacobians(terms, xs.permute(1, 2, 0).contiguous(),
                          us[:, :, 0].T.contiguous(), coeffs)
    jac = jac.reshape(H, 4, 5, B).permute(3, 0, 1, 2)
    assert torch.equal(got[0], jac[..., :4].contiguous())
    assert torch.equal(got[1], jac[..., 4:].contiguous())


@pytest.mark.parametrize("masked", [True, False])
def test_relin_twin_matches_pallas(model, masked):
    m, t, active = model
    idx = active if masked else tuple(range(m.library.n_features))
    rng = np.random.default_rng(0)
    B, H = 8, 12
    xs = rng.uniform(-2, 2, (B, H + 1, 4))
    us = rng.uniform(-5, 5, (B, H, 1))
    gts = m.library.grad_terms
    Jx, Ju = pallas_feature_jacobians(
        tuple(m.library._fns[k] for k in idx), jnp.asarray(xs), jnp.asarray(us),
        m.coeffs[:, jnp.asarray(idx)], grad_terms=tuple(gts[k] for k in idx),
        block_b=B, interpret=True,
    )
    terms = tuple(t.library.terms[k] for k in idx)
    got = relin_jacobians(
        terms, torch.as_tensor(xs.transpose(1, 2, 0).copy()),
        torch.as_tensor(us[:, :, 0].T.copy()), t.coeffs[:, list(idx)],
    )
    assert got.shape == (H, 20, B)
    np.testing.assert_allclose(got.numpy(), _pack(Jx, Ju), rtol=1e-12, atol=1e-12)
    _check_batch_major(terms, xs, us, t.coeffs[:, list(idx)], Jx, Ju)


def test_relin_twin_poly_cross_library():
    """Product-rule partials of power and cross terms (not on the main
    path) against the JAX kernel."""
    from autompc_tpu.sysid.basis import FeatureLibrary as JLib

    rng = np.random.default_rng(1)
    cfg = dict(poly_basis=True, poly_degree=3, poly_cross_terms=True)
    jlib, tlib = JLib.from_config(5, **cfg), FeatureLibrary.from_config(5, **cfg)
    coeffs = rng.normal(size=(4, jlib.n_features)) * 0.3
    B, H = 3, 5
    xs = rng.uniform(0.2, 1.5, (B, H + 1, 4))
    us = rng.uniform(0.2, 1.5, (B, H, 1))
    Jx, Ju = pallas_feature_jacobians(
        tuple(jlib._fns), jnp.asarray(xs), jnp.asarray(us), jnp.asarray(coeffs),
        grad_terms=jlib.grad_terms, block_b=B, interpret=True,
    )
    got = relin_jacobians_plain(
        tlib.terms, torch.as_tensor(xs.transpose(1, 2, 0).copy()),
        torch.as_tensor(us[:, :, 0].T.copy()), torch.as_tensor(coeffs),
    )
    np.testing.assert_allclose(got.numpy(), _pack(Jx, Ju), rtol=1e-12, atol=1e-12)
    _check_batch_major(tlib.terms, xs, us, torch.as_tensor(coeffs), Jx, Ju)


def test_relin_wrapper_rejects_other_devices_and_shapes(model):
    m, t, active = model
    terms = tuple(t.library.terms[k] for k in active)
    xs = torch.zeros((5, 4, 3), device="meta")
    with pytest.raises(ValueError, match="meta"):
        relin_jacobians(terms, xs, torch.zeros((4, 3), device="meta"),
                        torch.zeros((4, len(terms)), device="meta"))
    with pytest.raises(ValueError, match="coeffs"):
        relin_jacobians(terms, torch.zeros((5, 4, 3)), torch.zeros((4, 3)),
                        torch.zeros((4, len(terms) + 1)))


@pytest.mark.parametrize("bad, match", [
    ("meta", "meta"), ("coeffs", "coeffs"), ("dc", "dc = 1"), ("H", "must be"),
])
def test_relin_bm_wrapper_rejects_other_devices_and_shapes(model, bad, match):
    _, t, active = model
    terms = tuple(t.library.terms[k] for k in active)
    xs, us = torch.zeros((3, 5, 4)), torch.zeros((3, 4, 1))
    coeffs = torch.zeros((4, len(terms)))
    if bad == "meta":
        xs, us, coeffs = xs.to("meta"), us.to("meta"), coeffs.to("meta")
    elif bad == "coeffs":
        coeffs = torch.zeros((4, len(terms) + 1))
    elif bad == "dc":
        us = torch.zeros((3, 4, 2))
    elif bad == "H":
        xs = torch.zeros((3, 4, 4))
    with pytest.raises(ValueError, match=match):
        relin_jacobians_bm(terms, xs, us, coeffs)


def test_relin_bm_twin_is_the_lanes_last_twin_unpacked(model):
    """The two plain twins on the same float32 points, the layouts
    converted as the solver converted them: the same bits."""
    _, t, active = model
    terms = tuple(t.library.terms[k] for k in active)
    rng = np.random.default_rng(3)
    xs = torch.as_tensor(rng.uniform(-2, 2, (7, 6, 4)), dtype=torch.float32)
    us = torch.as_tensor(rng.uniform(-5, 5, (7, 5, 1)), dtype=torch.float32)
    coeffs = t.coeffs[:, list(active)].to(torch.float32)
    Jx, Ju = relin_jacobians_bm_plain(terms, xs, us, coeffs)
    jac = relin_jacobians_plain(terms, xs.permute(1, 2, 0).contiguous(),
                                us[:, :, 0].T.contiguous(), coeffs)
    jac = jac.reshape(5, 4, 5, 7).permute(3, 0, 1, 2)
    assert torch.equal(Jx, jac[..., :4]) and torch.equal(Ju, jac[..., 4:])
