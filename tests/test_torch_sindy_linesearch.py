"""K7 plain version (ops/cuda_linesearch.py::sindy_line_search_plain) vs
the JAX Pallas kernel pallas_sindy_line_search in interpret mode, float64,
1e-10: every step size rolled out and written, batch-major."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.ops.cuda_linesearch import sindy_line_search, sindy_line_search_plain
from autompc_torch.sysid import SINDy as TSINDy
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.ops.pallas_linesearch import pallas_sindy_line_search
from autompc_tpu.sysid import SINDy

torch.set_num_threads(1)


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


def _inputs(seed, B=6, H=9, ds=4):
    rng = np.random.default_rng(seed)
    return dict(
        x0=rng.uniform(-1, 1, (B, ds)), xs=rng.uniform(-1, 1, (B, H + 1, ds)),
        us=rng.uniform(-2, 2, (B, H, 1)), Ks=rng.normal(size=(B, H, 1, ds)) * 0.3,
        ks=rng.normal(size=(B, H, 1)),
    )


KEYS = ("x0", "xs", "us", "Ks", "ks")


@pytest.mark.parametrize("seed, L, masked, bound", [
    (0, 5, False, 20.0), (1, 10, True, 20.0), (2, 10, True, 0.5), (3, 2, True, np.inf),
])
def test_sindy_line_search_plain_matches_pallas(model, seed, L, masked, bound):
    m, t, active = model
    idx = active if masked else tuple(range(m.coeffs.shape[1]))
    d = _inputs(seed)
    alphas = tuple(0.2 ** k for k in range(L))
    ref_xs, ref_us = pallas_sindy_line_search(
        tuple(m.library._fns[k] for k in idx), *(jnp.asarray(d[k]) for k in KEYS),
        m.coeffs[:, jnp.asarray(idx)], jnp.asarray(alphas), -bound, bound,
        block_b=d["x0"].shape[0], block_l=L, interpret=True,
    )
    xs, us = sindy_line_search(
        tuple(t.library.terms[k] for k in idx), *(torch.as_tensor(d[k]) for k in KEYS),
        t.coeffs[:, list(idx)], alphas, -bound, bound,
    )
    assert tuple(xs.shape) == (6, L, 10, 4) and tuple(us.shape) == (6, L, 9, 1)
    np.testing.assert_allclose(xs.numpy(), np.asarray(ref_xs), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(us.numpy(), np.asarray(ref_us), rtol=1e-10, atol=1e-10)
    if bound == 0.5:
        assert (np.abs(us.numpy()) == 0.5).any()


def test_nan_gain_stays_nan_through_the_clip(model):
    """A lane whose feedforward gain is NaN (an indefinite Quu in the
    backward pass) keeps NaN controls; its neighbours are untouched."""
    _, t, active = model
    d = {k: torch.as_tensor(v) for k, v in _inputs(4).items()}
    terms = tuple(t.library.terms[k] for k in active)
    coeffs = t.coeffs[:, list(active)]
    alphas = tuple(0.2 ** k for k in range(4))
    clean = sindy_line_search_plain(terms, *(d[k] for k in KEYS), coeffs, alphas, -20.0, 20.0)
    d["ks"][2, 3, 0] = float("nan")
    xs, us = sindy_line_search_plain(terms, *(d[k] for k in KEYS), coeffs, alphas, -20.0, 20.0)
    assert torch.isnan(us[2, :, 3:]).all() and torch.isnan(xs[2, :, 4:]).all()
    assert torch.isfinite(us[2, :, :3]).all()
    keep = [0, 1, 3, 4, 5]
    np.testing.assert_array_equal(xs[keep].numpy(), clean[0][keep].numpy())


@pytest.mark.parametrize("bad, match", [
    ("coeffs3", "per-lane coefficients"), ("alphas", "step sizes"),
    ("Ks", "Ks: shape"), ("meta", "meta"),
])
def test_sindy_line_search_validates(model, bad, match):
    _, t, active = model
    d = {k: torch.as_tensor(v) for k, v in _inputs(5).items()}
    terms = tuple(t.library.terms[k] for k in active)
    coeffs = t.coeffs[:, list(active)]
    alphas = (1.0, 0.2)
    if bad == "coeffs3":
        coeffs = coeffs[None].expand(6, -1, -1)
    elif bad == "alphas":
        alphas = tuple(0.5 ** k for k in range(11))
    elif bad == "Ks":
        d["Ks"] = d["Ks"][:, :, :, :3]
    elif bad == "meta":
        d = {k: v.to("meta") for k, v in d.items()}
    with pytest.raises(ValueError, match=match):
        sindy_line_search(terms, *(d[k] for k in KEYS), coeffs, alphas, -20.0, 20.0)
