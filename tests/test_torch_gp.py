"""The port's approximate GP (``autompc_torch/sysid/gp.py``) against the
JAX package's, float64 on the CPU, at a tiny size (4 cartpole
trajectories of 20 steps, 76 training pairs, batches of 32):

- the math: ``_rbf``, ``_task_predict``, ``_task_elbo`` (batched over
  tasks, against JAX's one task at a time) and ``pad_inducing_params`` at
  1e-12, the ELBO's gradient against ``jax.grad`` at 1e-10;
- training: ``ApproximateGPModel.train`` given the JAX package's epoch
  orders (rebuilt from its key chain) against JAX's trained parameters
  and losses at 1e-9; each padded bucket of ``train_svgp_buckets``
  against the port's own standalone training, the dummy rows of ``w``
  exactly 0 and the dummy inducing points exactly where they started;
- prediction: ``svgp_mean_weights``/``gp_pred_core_cached`` against the
  predictive mean at 1e-10, ``pred_diff`` (``jacfwd``) against JAX's;
- sampling: ``sample_core`` with an injected draw at 1e-12, and
  ``sample``/``sample_parallel``/``get_sampler`` given JAX's draws
  (``standard_normal`` replaced);
- a failed float32-style Cholesky gives NaN, not an exception.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.sysid import gp as tgp
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.core.trajectory import TrajectoryBatch as JTB
from autompc_tpu.sysid import gp as jgp

torch.set_num_threads(1)

GP_KW = dict(niter=2, lr=0.1, batch_size=32, induce_count=12, seed=3)
N_TOTAL, N_USED = 4 * 19, 64
MS, PAD = [6, 10], 16


def jax_perms(seed, niter, n_total=N_TOTAL, n_used=N_USED):
    """The epoch orders of the JAX package's training for ``seed``."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(niter):
        key, kp = jax.random.split(key)
        out.append(np.array(jax.random.permutation(kp, n_total)[:n_used]))
    return out


def t64(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup():
    jb, tb = JBench(), TBench()
    ttr = tb.gen_trajs_batch(seed=1, n_trajs=4, traj_len=20, device="cpu")
    jtr = JTB(jb.system, ttr.obs.numpy(), ttr.ctrls.numpy(), ttr.lengths.numpy())
    jm = jgp.ApproximateGPModel(jb.system, **GP_KW)
    jm.train(jtr.to_list())
    tm = tgp.ApproximateGPModel(tb.system, device="cpu", **GP_KW)
    tm.train(ttr, perms=jax_perms(GP_KW["seed"], GP_KW["niter"]))
    rng = np.random.default_rng(0)
    return dict(jb=jb, tb=tb, jtr=jtr, ttr=ttr, jm=jm, tm=tm,
                x=rng.uniform(-1, 1, (7, 4)), u=rng.uniform(-1, 1, (7, 1)))


def one_task(params, t):
    return {k: v[t] for k, v in params.items()}


def test_rbf_and_task_predict_match_jax(setup):
    jp = setup["jm"].get_parameters()["gp_params"]
    x = np.random.default_rng(2).normal(size=(6, 5))
    for t in range(4):
        tp = one_task(jp, t)
        k_ref = jax.jit(jgp._rbf)(jnp.asarray(x), jnp.asarray(tp["Z"]),
                                   jnp.exp(tp["log_lengthscale"]), jnp.exp(tp["log_outputscale"]))
        k = tgp._rbf(torch.as_tensor(x), torch.as_tensor(tp["Z"]),
                     torch.as_tensor(np.exp(tp["log_lengthscale"])),
                     torch.as_tensor(np.exp(tp["log_outputscale"])))
        np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), rtol=1e-12, atol=1e-14)
    # Every task at once (a leading task axis) against JAX task by task.
    mean, cov = tgp._task_predict(t64(jp), torch.as_tensor(x))
    for t in range(4):
        m_ref, c_ref = jax.jit(jgp._task_predict)(
            {k: jnp.asarray(v) for k, v in one_task(jp, t).items()}, jnp.asarray(x))
        np.testing.assert_allclose(mean[t].numpy(), np.asarray(m_ref), rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(cov[t].numpy(), np.asarray(c_ref), rtol=1e-12, atol=1e-13)
        # The diagonal alone, as the ELBO takes it.
        _, var = tgp._task_mean_var(t64(jp), torch.as_tensor(x))
        np.testing.assert_allclose(var[t].numpy(), np.diag(np.asarray(c_ref)), rtol=1e-12,
                                   atol=1e-13)


def test_task_elbo_and_its_gradient_match_jax(setup):
    jp = setup["jm"].get_parameters()["gp_params"]
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=(16, 5)), rng.normal(size=(16, 4))
    tp = {k: torch.as_tensor(v).requires_grad_(True) for k, v in jp.items()}
    elbo = tgp._task_elbo(tp, torch.as_tensor(x), torch.as_tensor(y.T), N_TOTAL)
    grads = torch.autograd.grad(elbo.sum(), list(tp.values()))
    jelbo = jax.jit(jgp._task_elbo, static_argnums=3)
    jgrad = jax.jit(jax.grad(jgp._task_elbo), static_argnums=3)
    for t in range(4):
        tj = {k: jnp.asarray(v[t]) for k, v in jp.items()}
        ref = float(jelbo(tj, jnp.asarray(x), jnp.asarray(y[:, t]), N_TOTAL))
        np.testing.assert_allclose(float(elbo[t].detach()), ref, rtol=1e-12)
        g_ref = jgrad(tj, jnp.asarray(x), jnp.asarray(y[:, t]), N_TOTAL)
        for k, g in zip(tp, grads):
            np.testing.assert_allclose(g[t].numpy(), np.asarray(g_ref[k]), rtol=1e-10,
                                       atol=1e-10 * max(1.0, float(np.abs(g_ref[k]).max())),
                                       err_msg=k)


def test_pad_inducing_params_matches_jax(setup):
    jp = setup["jm"].get_parameters()["gp_params"]
    ref = jgp.pad_inducing_params({k: jnp.asarray(v) for k, v in jp.items()}, 12, 20)
    got = tgp.pad_inducing_params(t64(jp), 12, 20)
    for k in jp:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert tgp.pad_inducing_params(t64(jp), 12, 12)["Z"].shape == (4, 12, 5)


def test_train_matches_jax(setup):
    """The trained parameters and the epochs' losses, the JAX package's
    epoch orders given to the port."""
    jm, tm = setup["jm"], setup["tm"]
    jp, tp = jm.get_parameters(), tm.get_parameters()
    for k, v in jp["gp_params"].items():
        np.testing.assert_allclose(tp["gp_params"][k], v, rtol=1e-9, atol=1e-9, err_msg=k)
    for k in ("xu_means", "xu_std", "dy_means", "dy_std"):
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(tm._losses.numpy(), np.asarray(jm._losses), rtol=1e-9)
    # The port's own epoch orders: a different run, still finite and
    # improving.
    own = tgp.ApproximateGPModel(setup["tb"].system, device="cpu", **GP_KW)
    own.train(setup["ttr"])
    assert torch.isfinite(own._losses).all() and own._losses[-1] < own._losses[0]


def test_train_svgp_buckets_matches_standalone(setup):
    """Each padded bucket against the port's model trained alone (the same
    epoch orders): the real rows agree (the batched BLAS and LAPACK calls
    sum in another order at pad_to than at M, so to rounding, not bit for
    bit); the dummies stay exact. (tests/test_torch_joint_gp.py holds the
    buckets against the JAX package's.)"""
    s = setup
    kw = dict(niter=2, lr=0.1, batch_size=32, seed=3, pad_to=PAD)
    own, w_own, _ = tgp.train_svgp_buckets(s["tb"].system, s["ttr"], MS, device="cpu", **kw)
    for b, M in enumerate(MS):
        Z0 = tgp.pad_inducing_params(
            tgp._init_params(torch.zeros((N_TOTAL, 5), dtype=torch.float64), 4, M), M, PAD)["Z"]
        solo = tgp.ApproximateGPModel(s["tb"].system, device="cpu", **dict(GP_KW, induce_count=M))
        solo.train(s["ttr"])
        real = {"Z": own["Z"][b, :, :M], "m": own["m"][b, :, :M],
                "Ls": own["Ls"][b, :, :M, :M]}
        for k, v in solo._params.items():
            np.testing.assert_allclose(real.get(k, own[k][b]).numpy(), v.numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=k)
        np.testing.assert_allclose(w_own[b, :, :M].numpy(), solo._w.numpy(), rtol=1e-11,
                                   atol=1e-12)
        assert torch.equal(w_own[b, :, M:], torch.zeros_like(w_own[b, :, M:]))
        assert torch.equal(own["Z"][b, :, M:], Z0[:, M:])


def test_cached_mean_matches_the_predictive_mean(setup):
    """``gp_pred_core_cached`` (``pred_core`` with ``w``) against the
    predictive mean with its per-call factorization, in the port and
    against JAX; one model a lane as the fan-outs give it."""
    jm, tm = setup["jm"], setup["tm"]
    x, u = torch.as_tensor(setup["x"]), torch.as_tensor(setup["u"])
    params = tm.params
    cached = tgp.gp_pred_core_cached(params, x, u)
    mean_t, _ = tm._predictive(params, x, u)
    plain = x + mean_t * params["dy_std"] + params["dy_means"]
    np.testing.assert_allclose(cached.numpy(), plain.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tm.pred_core({k: v for k, v in params.items() if k != "w"}, x,
                                            u).numpy(), plain.numpy(), rtol=1e-12)
    ref = jax.jit(jax.vmap(lambda s_, c: jgp.gp_pred_core_cached(jm.params, s_, c)))(
        jnp.asarray(setup["x"]), jnp.asarray(setup["u"]))
    np.testing.assert_allclose(cached.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tgp.svgp_mean_weights(params["gp"]).numpy(),
                               np.asarray(jgp.svgp_mean_weights(jm.params["gp"])), rtol=1e-10,
                               atol=1e-12)
    # Per lane: 3 lanes of 7 points, each its own copy of the model.
    lanes = {"gp": {k: v.expand((3,) + v.shape) for k, v in params["gp"].items()},
             **{k: params[k].expand((3,) + params[k].shape)
                for k in ("w", "xu_means", "xu_std", "dy_means", "dy_std")}}
    got = tgp.gp_pred_core_cached(lanes, x.expand(3, 7, 4), u.expand(3, 7, 1))
    np.testing.assert_allclose(got.numpy(), cached.expand(3, 7, 4).numpy(), rtol=1e-13)


def test_pred_diff_matches_jax(setup):
    jm, tm = setup["jm"], setup["tm"]
    ref = jax.jit(jax.vmap(jm.pred_diff))(jnp.asarray(setup["x"]), jnp.asarray(setup["u"]))
    got = tm.pred_diff_parallel(torch.as_tensor(setup["x"]), torch.as_tensor(setup["u"]))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tm.pred_parallel(torch.as_tensor(setup["x"]),
                                                torch.as_tensor(setup["u"])).numpy(),
                               np.asarray(ref[0]), rtol=1e-10)


def test_sample_core_with_an_injected_draw(setup):
    jm, tm = setup["jm"], setup["tm"]
    s_, c = setup["x"][0], setup["u"][0]
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, a, b, k: jm.sample_core(p, a, b, k))(jm.params, jnp.asarray(s_),
                                                                  jnp.asarray(c), key)
    eps = torch.as_tensor(np.array(jax.random.normal(key, (4,))))
    got = tm.sample_core(tm.params, torch.as_tensor(s_), torch.as_tensor(c), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-13)


def test_sampling_entry_points_with_jax_draws(setup, monkeypatch):
    """``sample``, ``sample_parallel`` and ``get_sampler`` through JAX's
    draws (``standard_normal`` replaced by the JAX package's key use)."""
    jm, tm = setup["jm"], setup["tm"]
    x, u = setup["x"], setup["u"]

    def jax_normal(shape, like, key=None):
        k = jax.random.PRNGKey(key)
        if len(shape) == 2:        # sample_parallel: a key a row
            z = np.stack([np.array(jax.random.normal(kk, shape[1:]))
                          for kk in jax.random.split(k, shape[0])])
        else:
            z = np.array(jax.random.normal(k, shape))
        return torch.as_tensor(z, dtype=like.dtype)

    monkeypatch.setattr(tgp, "standard_normal", jax_normal)
    # JAX's entry points, jitted (their eager calls cost seconds).
    sample = jax.jit(lambda s_, c, k: jm.sample(s_, c, key=k))
    sample_parallel = jax.jit(lambda s_, c, k: jm.sample_parallel(s_, c, key=k))
    one = tm.sample(x[0], u[0], key=4)
    np.testing.assert_allclose(one.numpy(), np.asarray(sample(
        jnp.asarray(x[0]), jnp.asarray(u[0]), jax.random.PRNGKey(4))), rtol=1e-12)
    many = tm.sample_parallel(x, u, key=6)
    np.testing.assert_allclose(many.numpy(), np.asarray(sample_parallel(
        jnp.asarray(x), jnp.asarray(u), jax.random.PRNGKey(6))), rtol=1e-12)
    sampler = tm.get_sampler(key=8)
    jsampler = jax.jit(jm.get_sampler(key=jax.random.PRNGKey(8)))
    for i in range(2):
        np.testing.assert_allclose(sampler(x[i], u[i]).numpy(),
                                   np.asarray(jsampler(jnp.asarray(x[i]), jnp.asarray(u[i]))),
                                   rtol=1e-12)
    monkeypatch.undo()
    # The port's own draws: the same key gives the same sample.
    assert torch.equal(tm.sample(x[0], u[0], key=1), tm.sample(x[0], u[0], key=1))
    assert not torch.equal(tm.sample(x[0], u[0], key=1), tm.sample(x[0], u[0], key=2))


def test_parameters_factory_and_names(setup):
    s = setup
    m = tgp.ApproximateGPModel(s["tb"].system, device="cpu")
    m.set_parameters(s["jm"].get_parameters())
    np.testing.assert_allclose(m.pred(torch.as_tensor(s["x"][0]), torch.as_tensor(s["u"][0])),
                               s["tm"].pred(torch.as_tensor(s["x"][0]),
                                            torch.as_tensor(s["u"][0])), rtol=1e-9)
    back = m.get_parameters()
    assert set(back) == set(s["jm"].get_parameters()) and set(back["gp_params"]) == set(
        s["jm"].get_parameters()["gp_params"])
    f = tgp.ApproximateGPModelFactory(s["tb"].system, device="cpu")
    hp = f.get_configuration_space().get_hyperparameter("induce_count")
    assert (hp.lower, hp.upper, hp.default_value) == (50, 200, 100)
    model = f({"induce_count": 8, "niter": 1, "batch_size": 32}, s["ttr"])
    assert model._params["Z"].shape == (4, 8, 5) and model.state_dim == 4
    assert tgp.LargeGaussianProcess is tgp.ApproximateGPModel
    with pytest.raises(ValueError, match="RBF"):
        tgp.ApproximateGPModel(s["tb"].system, kernel="Matern", device="cpu")


def test_a_failed_factorization_gives_nan(setup):
    """A Kzz that the Cholesky rejects (duplicate inducing points at a
    huge outputscale) gives NaN weights and predictions, as JAX's
    Cholesky does, and raises nothing."""
    p = dict(setup["tm"]._params)
    p["Z"] = p["Z"][:, :1].expand_as(p["Z"]).clone()
    p["log_outputscale"] = torch.full_like(p["log_outputscale"], 30.0)
    w = tgp.svgp_mean_weights(p)
    assert torch.isnan(w).all()
    ref = jgp.svgp_mean_weights({k: jnp.asarray(v.numpy()) for k, v in p.items()})
    assert np.isnan(np.asarray(ref)).all()
