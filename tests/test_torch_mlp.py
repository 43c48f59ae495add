"""The port's MLP model (sysid/mlp.py) vs the JAX package's, float64:
weights carried across by set_parameters, then pred_core and
pred_diff_core to 1e-10 (and the closed-form Jacobian against
torch.autograd), and one epoch of Adam on the Huber loss against the
optax step on the same batches to 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autompc_torch.core.system import System as TSystem
from autompc_torch.sysid.mlp import MLP as TMLP
from autompc_torch.sysid.mlp import net_apply as t_net_apply
from autompc_tpu.core.system import System as JSystem
from autompc_tpu.sysid.mlp import MLP as JMLP
from autompc_tpu.sysid.mlp import net_apply as j_net_apply

# The tensors here are tiny: one intra-op thread. Six test workers with
# a thread pool each oversubscribe the cores and slow these loops of
# small ops a hundredfold.
torch.set_num_threads(1)

ACTS = ("relu", "tanh", "sigmoid", "selu")
NX, NU = 5, 2


def _systems(nx=NX, nu=NU):
    names = [f"x{i}" for i in range(nx)], [f"u{i}" for i in range(nu)]
    return JSystem(*names, dt=0.05), TSystem(*names, dt=0.05)


def _random_parameters(sizes, seed):
    """A get_parameters() dict of numpy arrays with non-trivial
    z-scoring."""
    rng = np.random.default_rng(seed)
    nin, nout = sizes[0], sizes[-1]
    return {
        "net_params": [
            {"W": rng.normal(0, 1 / np.sqrt(a), (a, b)), "b": rng.normal(0, 0.3, b)}
            for a, b in zip(sizes[:-1], sizes[1:])
        ],
        "xu_means": rng.normal(size=nin), "xu_std": rng.uniform(0.5, 2.0, nin),
        "dy_means": rng.normal(0, 0.1, nout), "dy_std": rng.uniform(0.5, 2.0, nout),
    }


def _pair(nonlin, n_hidden, seed=0, **kw):
    js, ts = _systems()
    jm = JMLP(js, n_hidden_layers=n_hidden, hidden_size=8, nonlintype=nonlin, **kw)
    tm = TMLP(ts, device="cpu", n_hidden_layers=n_hidden, hidden_size=8, nonlintype=nonlin, **kw)
    jm.set_parameters(_random_parameters(jm._sizes, seed))
    tm.set_parameters(jm.get_parameters())
    return jm, tm


@pytest.mark.parametrize("nonlin", ACTS)
@pytest.mark.parametrize("n_hidden", [1, 2])
def test_pred_core_and_diff_match_jax(nonlin, n_hidden):
    jm, tm = _pair(nonlin, n_hidden, seed=n_hidden)
    rng = np.random.default_rng(1)
    x, u = rng.normal(size=(3, 4, NX)), rng.normal(size=(3, 4, NU))
    jpred = jax.vmap(jax.vmap(lambda a, b: jm.pred_diff_core(jm.params, a, b)))
    ref = jpred(jnp.asarray(x), jnp.asarray(u))
    got = tm.pred_diff_core(tm.params, torch.as_tensor(x), torch.as_tensor(u))
    for name, g, r in zip(("pred", "Jx", "Ju"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-10, err_msg=name)
    pred = tm.pred_core(tm.params, torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref[0]), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("nonlin", ACTS)
def test_closed_form_jacobian_matches_autograd(nonlin):
    _, tm = _pair(nonlin, 2, seed=5)
    rng = np.random.default_rng(2)
    x, u = torch.as_tensor(rng.normal(size=NX)), torch.as_tensor(rng.normal(size=NU))
    _, Jx, Ju = tm.pred_diff_core(tm.params, x, u)
    ax, au = torch.autograd.functional.jacobian(
        lambda a, b: tm.pred_core(tm.params, a, b), (x, u))
    np.testing.assert_allclose(Jx.numpy(), ax.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(Ju.numpy(), au.numpy(), rtol=1e-10, atol=1e-10)


def test_parameters_round_trip_and_shape_check():
    jm, tm = _pair("tanh", 2)
    back = tm.get_parameters()
    ref = jm.get_parameters()
    for la, lb in zip(back["net_params"], ref["net_params"]):
        np.testing.assert_array_equal(la["W"], lb["W"])
        np.testing.assert_array_equal(la["b"], lb["b"])
    for k in ("xu_means", "xu_std", "dy_means", "dy_std"):
        np.testing.assert_array_equal(back[k], ref[k])
    wider = TMLP(_systems()[1], device="cpu", n_hidden_layers=2, hidden_size=9)
    with pytest.raises(ValueError, match="layer shapes"):
        wider.set_parameters(ref)
    with pytest.raises(ValueError, match="nonlintype"):
        TMLP(_systems()[1], device="cpu", nonlintype="gelu")


def test_hidden_size_overrides_match_jax():
    js, ts = _systems()
    kw = dict(n_hidden_layers=3, hidden_size=8, hidden_size_2=6, hidden_size_4=99)
    assert TMLP(ts, device="cpu", **kw)._sizes == JMLP(js, **kw)._sizes == [7, 8, 6, 8, 5]


@pytest.mark.parametrize("nonlin", ["relu", "tanh"])
def test_one_epoch_matches_optax(nonlin):
    """Same initial weights, same batches in the same order: Adam
    (lr 1e-3, eps 1e-8) on the mean Huber loss (delta 1)."""
    jm, tm = _pair(nonlin, 2, seed=9, n_batch=16)
    rng = np.random.default_rng(3)
    n = 70                                     # 4 full batches, 6 samples unused
    XU, dY = rng.normal(size=(n, NX + NU)), rng.normal(0, 1.5, (n, NX))
    perm = rng.permutation(n)[:64]

    params = jm.net_params
    opt = optax.adam(jm.lr)
    state = opt.init(params)

    def loss_fn(p, xb, yb):
        return jnp.mean(optax.huber_loss(j_net_apply(p, xb, nonlin), yb, delta=1.0))

    losses = []
    for idx in perm.reshape(4, 16):
        loss, grads = jax.value_and_grad(loss_fn)(params, jnp.asarray(XU[idx]),
                                                  jnp.asarray(dY[idx]))
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))

    got = tm.run_epochs(torch.as_tensor(XU), torch.as_tensor(dY), [torch.as_tensor(perm)])
    np.testing.assert_allclose(float(got[0]), np.mean(losses), rtol=1e-8)
    for la, lb in zip(tm.params["net"], params):
        np.testing.assert_allclose(la["W"].numpy(), np.asarray(lb["W"]), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(la["b"].numpy(), np.asarray(lb["b"]), rtol=1e-8, atol=1e-8)


def test_train_fits_zscoring_like_jax_and_is_seeded():
    """train(): the z-scoring statistics equal the JAX package's on the
    same trajectories; the loss falls; the same seed gives the same
    net and another seed another one."""
    from autompc_torch.core.trajectory import TrajectoryBatch as TTB
    from autompc_tpu.core.trajectory import TrajectoryBatch as JTB

    js, ts = _systems()
    rng = np.random.default_rng(4)
    obs = np.cumsum(rng.normal(0, 0.1, (6, 15, NX)), axis=1)
    ctrls = rng.uniform(-1, 1, (6, 15, NU))
    lengths = np.array([15, 15, 12, 15, 9, 15])
    jm = JMLP(js, n_hidden_layers=1, hidden_size=8, n_train_iters=1, n_batch=16)
    jm.train(JTB(js, jnp.asarray(obs), jnp.asarray(ctrls), jnp.asarray(lengths)))
    kw = dict(n_hidden_layers=1, hidden_size=8, n_train_iters=6, n_batch=16)
    tm = TMLP(ts, device="cpu", **kw)
    tb = TTB(ts, torch.as_tensor(obs), torch.as_tensor(ctrls), torch.as_tensor(lengths))
    tm.train(tb)
    for k in ("xu_means", "xu_std", "dy_means", "dy_std"):
        np.testing.assert_allclose(getattr(tm, k).numpy(), np.asarray(getattr(jm, k)),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
    assert tm._losses.shape == (6,) and float(tm._losses[-1]) < float(tm._losses[0])
    again, other = TMLP(ts, device="cpu", **kw), TMLP(ts, device="cpu", **kw)
    again.train(tb)
    other.train(tb, seed=7)
    w = lambda m: m.params["net"][0]["W"].numpy()
    np.testing.assert_array_equal(w(again), w(tm))
    assert np.abs(w(other) - w(tm)).max() > 1e-3
    np.testing.assert_allclose(
        t_net_apply(tm.params["net"], torch.zeros(7, dtype=torch.float64), "relu").numpy(),
        tm.net(torch.zeros(7, dtype=torch.float64), "relu").detach().numpy())
