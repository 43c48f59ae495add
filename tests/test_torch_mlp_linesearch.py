"""K5 plain version (ops/cuda_mlp_linesearch.py) vs the JAX Pallas kernel
pallas_mlp_line_search in interpret mode, float64, 1e-9: the three TPU
layouts ("slab", "feat", "mxu") are one function, which the port
computes with one kernel; all four activations, one- and two-hidden-
layer nets, scalar and per-control bounds; and fold_mlp_params against
MLP.pred_core."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.core.system import System as TSystem
from autompc_torch.ops import _build
from autompc_torch.ops import cuda_mlp_linesearch as K5
from autompc_torch.sysid.mlp import MLP as TMLP
from autompc_torch.sysid.mlp import net_apply
from autompc_tpu.ops.pallas_mlp_linesearch import (
    fold_mlp_params as j_fold,
    pallas_mlp_line_search,
)

# The tensors here are tiny: one intra-op thread. Six test workers with
# a thread pool each oversubscribe the cores and slow these loops of
# small ops a hundredfold.
torch.set_num_threads(1)

DS, DC, B, H, L = 5, 2, 4, 7, 5


def _params(sizes, seed):
    rng = np.random.default_rng(seed)
    nin, nout = sizes[0], sizes[-1]
    return {
        "net": [
            {"W": rng.normal(0, 1 / np.sqrt(a), (a, b)), "b": rng.normal(0, 0.3, b)}
            for a, b in zip(sizes[:-1], sizes[1:])
        ],
        "xu_means": rng.normal(0, 0.2, nin), "xu_std": rng.uniform(0.5, 2.0, nin),
        "dy_means": rng.normal(0, 0.05, nout), "dy_std": rng.uniform(0.05, 0.2, nout),
    }


def _map(params, f):
    return {k: ([{n: f(a) for n, a in la.items()} for la in v] if k == "net" else f(v))
            for k, v in params.items()}


def _inputs(seed, ds=DS, dc=DC, b=B, h=H):
    rng = np.random.default_rng(seed)
    return dict(
        x0=rng.uniform(-0.1, 0.1, (b, ds)), xs=rng.uniform(-0.2, 0.2, (b, h + 1, ds)),
        us=rng.uniform(-0.5, 0.5, (b, h, dc)), Ks=rng.uniform(-0.6, 0.6, (b, h, dc, ds)),
        ks=rng.uniform(-1.5, 1.5, (b, h, dc)),
    )


def _both(params, nonlin, d, umin, umax, layout, n_alpha=L):
    alphas = 0.2 ** np.arange(n_alpha)
    jl = j_fold(_map(params, jnp.asarray), nonlin)
    ref = pallas_mlp_line_search(
        jl, nonlin, *(jnp.asarray(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")),
        jnp.asarray(alphas), umin, umax, block_b=d["x0"].shape[0], interpret=True,
        layout=layout,
    )
    tl = K5.fold_mlp_params(_map(params, torch.as_tensor))
    got = K5.mlp_line_search(
        tl, nonlin, *(torch.as_tensor(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")),
        tuple(alphas), umin, umax, layout=layout,
    )
    return got, ref


def _check(got, ref):
    for name, g, r in zip(("ls_xs", "ls_us"), got, ref):
        assert tuple(g.shape) == tuple(r.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-9,
                                   err_msg=name)


@pytest.mark.parametrize("layout", K5.LAYOUTS)
@pytest.mark.parametrize("nonlin", K5.ACTIVATIONS)
def test_plain_matches_pallas(layout, nonlin):
    params = _params([DS + DC, 8, 8, DS], seed=1)
    got, ref = _both(params, nonlin, _inputs(2), -0.8, 0.8, layout)
    _check(got, ref)
    # The bounds bind somewhere and the x0 row leads every rollout.
    assert float(got[1].abs().max()) == 0.8
    np.testing.assert_array_equal(got[0][:, :, 0].numpy(),
                                  np.repeat(_inputs(2)["x0"][:, None], L, axis=1))


@pytest.mark.parametrize("layout", K5.LAYOUTS)
def test_one_hidden_layer_and_vector_bounds(layout):
    params = _params([DS + DC, 16, DS], seed=3)
    umin, umax = np.array([-0.3, -1.0]), np.array([0.5, 0.2])
    got, ref = _both(params, "tanh", _inputs(4), umin, umax, layout, n_alpha=3)
    _check(got, ref)
    us = got[1].numpy()
    assert (us >= umin - 1e-15).all() and (us <= umax + 1e-15).all()


def test_head_only_net_has_no_activation():
    """A one-layer net is its linear head (slab layout; the JAX mxu
    layout needs a hidden layer)."""
    params = _params([DS + DC, DS], seed=5)
    got, ref = _both(params, "relu", _inputs(6), -1.0, 1.0, "slab")
    _check(got, ref)


def test_cheetah_widths():
    params = _params([24, 16, 16, 18], seed=7)
    d = _inputs(8, ds=18, dc=6, b=2, h=4)
    got, ref = _both(params, "relu", d, -np.ones(6), np.ones(6), "feat", n_alpha=3)
    _check(got, ref)


@pytest.mark.parametrize("nonlin", K5.ACTIVATIONS)
def test_fold_matches_pred_core(nonlin):
    names = [f"x{i}" for i in range(DS)], [f"u{i}" for i in range(DC)]
    m = TMLP(TSystem(*names, dt=0.05), device="cpu", n_hidden_layers=2, hidden_size=8,
             nonlintype=nonlin)
    p = _params(m._sizes, seed=9)
    m.set_parameters({"net_params": p["net"], **{k: v for k, v in p.items() if k != "net"}})
    rng = np.random.default_rng(10)
    x, u = torch.as_tensor(rng.normal(size=(6, DS))), torch.as_tensor(rng.normal(size=(6, DC)))
    layers = K5.fold_mlp_params(m.params)
    plain = [{"W": W, "b": b} for W, b in layers]
    got = x + net_apply(plain, torch.cat([x, u], dim=-1), nonlin)
    np.testing.assert_allclose(got.numpy(), m.pred_core(m.params, x, u).numpy(),
                               rtol=1e-11, atol=1e-12)
    for (W, b), (jW, jb) in zip(layers, j_fold(_map(m.params, lambda a: jnp.asarray(a.numpy())),
                                               nonlin)):
        np.testing.assert_allclose(W.numpy(), np.asarray(jW), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("kwargs, match", [
    (dict(precision="default"), "precision"),
    (dict(precision="bf16x3"), "precision"),
    (dict(layout="rows"), "layout"),
    (dict(nonlin="gelu"), "activation"),
    (dict(n_alpha=_build.MAX_L + 1), "step sizes"),
    (dict(umax=np.ones(3)), "bound"),
    (dict(drop="Ks"), "Ks"),
])
def test_rejected_arguments(kwargs, match):
    kwargs = dict(kwargs)
    params = _map(_params([DS + DC, 8, DS], seed=11), torch.as_tensor)
    d = {k: torch.as_tensor(v) for k, v in _inputs(12).items()}
    if "drop" in kwargs:
        d[kwargs.pop("drop")] = torch.zeros((B, H, DC, DS + 1), dtype=torch.float64)
    nonlin = kwargs.pop("nonlin", "relu")
    alphas = tuple(0.2 ** k for k in range(kwargs.pop("n_alpha", 3)))
    umax = kwargs.pop("umax", 1.0)
    with pytest.raises(ValueError, match=match):
        K5.mlp_line_search(K5.fold_mlp_params(params), nonlin, d["x0"], d["xs"],
                           d["us"], d["Ks"], d["ks"], alphas, -1.0, umax, **kwargs)


def test_shared_memory_formula_fits_the_main_path_widths():
    """The launcher's shared-memory need at the widths the solver uses
    (24-64-64-18 and 5-64-64-4, 10 step sizes, the main path's batches)
    leaves room for two blocks an SM, and at the compiled maximum it
    stays under what a block can use, or the geometry raises."""
    for widths, ds, dc, B in (([24, 64, 64, 18], 18, 6, 1024),
                              ([5, 64, 64, 4], 4, 1, 4096)):
        g = K5.mlp_geometry(widths, ds, dc, 10, B)
        assert g["lanes_per_block"] >= 2 and g["smem"] < 110 * 1024
    w = _build.MLP_MAX_W
    g = K5.mlp_geometry([w, w, w, w - 32], w - 32, 32, 10, 1024)
    assert g["lanes_per_block"] == 1 and g["smem"] <= _build.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="mlp_line_search: .* shared memory"):
        K5.mlp_geometry([w] * 5 + [w - 32], w - 32, 32, 10, 1024)


def test_nan_gains_stay_nan_through_clip_and_relu():
    """A lane whose gains are NaN gets NaN controls and states, not
    controls at the bounds (the kernel's clip and relu are comparisons
    for the same reason); the other lanes are untouched."""
    params = _map(_params([DS + DC, 8, DS], seed=13), torch.as_tensor)
    d = {k: torch.as_tensor(v) for k, v in _inputs(14).items()}
    layers = K5.fold_mlp_params(params)
    alphas = (1.0, 0.2)
    ref = K5.mlp_line_search(layers, "relu", d["x0"], d["xs"], d["us"], d["Ks"], d["ks"],
                             alphas, -0.8, 0.8)
    d["ks"][1, 2] = float("nan")
    got = K5.mlp_line_search(layers, "relu", d["x0"], d["xs"], d["us"], d["Ks"], d["ks"],
                             alphas, -0.8, 0.8)
    assert torch.isnan(got[1][1, :, 2:]).all() and torch.isnan(got[0][1, :, 3:]).all()
    assert torch.isfinite(got[1][1, :, :2]).all()
    keep = [0, 2, 3]
    np.testing.assert_array_equal(got[0][keep].numpy(), ref[0][keep].numpy())
    np.testing.assert_array_equal(got[1][keep].numpy(), ref[1][keep].numpy())
