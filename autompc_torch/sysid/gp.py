"""Approximate (variational sparse) Gaussian-process dynamics model (port
of ``autompc_tpu/sysid/gp.py``).

A batch-independent multitask SVGP — one independent sparse GP per
observation dimension ("task") — over the z-scored state delta, with
learned inducing points, an RBF(+scale) kernel, a constant mean and a
Gaussian likelihood, trained by Adam on the variational ELBO in the
whitened parametrization (``_task_predict``).

Layout: every task's GP, and with ``train_svgp_buckets`` every bucket's,
is one leading axis of each parameter tensor — ``Z`` (..., M, d),
``log_lengthscale`` (..., d), ``log_outputscale``, ``log_noise``,
``mean_const`` (...), ``m`` (..., M), ``Ls`` (..., M, M) with ``...``
= (n_task,) or (K, n_task) — so kernel matrices, Cholesky factorizations
(``torch.linalg.cholesky_ex``), triangular solves, the ELBO and the
predictions of all tasks and buckets are batched tensor operations. A
Cholesky factorization that fails gives NaN, as the JAX package's does
(no jitter is added and nothing falls back); a model or a fan-out lane
with a NaN factor then predicts NaN, and a tuner scores it ``inf``.

Training takes each epoch's row order from ``svgp_epoch_perms`` (a
``torch.Generator``) unless the caller passes its own (``perms``: the
JAX package's orders, in the parity tests). Sampling draws its standard
normals through ``standard_normal`` (a ``torch.Generator``), which a
caller may replace. The mean-prediction Jacobians come from
``torch.func.jacfwd`` of the predictive mean (``Model.pred_diff_batch``,
``control/ilqr.py::jacfwd_pred_diff``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..config import ConfigurationSpace, UniformIntegerHyperparameter
from .mlp import zscore_pairs
from .model import Model, ModelFactory

_JITTER = 1e-6
# Dummy inducing points sit this far apart (pad_inducing_params).
_PAD_DIST = 1e4
_LEAVES = ("Z", "log_lengthscale", "log_outputscale", "log_noise", "mean_const", "m", "Ls")


def _rbf(x1, x2, lengthscale, outputscale):
    """Scaled RBF kernel matrix: x1 (..., N, d), x2 (..., M, d),
    lengthscale (..., d), outputscale (...) -> (..., N, M)."""
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    sq = ((diff / lengthscale[..., None, None, :]) ** 2).sum(-1)
    return outputscale[..., None, None] * torch.exp(-0.5 * sq)


def _cholesky(K):
    """Lower Cholesky factor of every matrix of ``K``; NaN where the
    factorization fails (the JAX package's ``jnp.linalg.cholesky``)."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def _whitened(tp, x):
    """``A = Lz^-1 Kzx`` (..., M, N) of every task at inputs x (..., N, d),
    with the lengthscale and outputscale."""
    Z = tp["Z"]
    ls = torch.exp(tp["log_lengthscale"])
    os_ = torch.exp(tp["log_outputscale"])
    M = Z.shape[-2]
    Kzz = _rbf(Z, Z, ls, os_) + _JITTER * torch.eye(M, dtype=Z.dtype, device=Z.device)
    Kxz = _rbf(x, Z, ls, os_)
    Lz = _cholesky(Kzz)
    A = torch.linalg.solve_triangular(Lz, Kxz.mT, upper=False)
    return A, ls, os_


def _task_predict(tp, x):
    """Predictive mean (..., N) and covariance (..., N, N) of each task's
    SVGP at inputs x (..., N, d). Whitened variational parametrization:
    ``q(u) = N(mu0 + Lz v, Lz V Lz')`` with ``V = L_V L_V'``,

      A    = Lz^{-1} Kzx
      mean = mu0 + A' v
      cov  = Kxx - A'A + A' V A.
    """
    A, ls, os_ = _whitened(tp, x)
    mean = tp["mean_const"][..., None] + (A.mT @ tp["m"][..., None])[..., 0]
    VA = torch.tril(tp["Ls"]).mT @ A
    cov = _rbf(x, x, ls, os_) - A.mT @ A + VA.mT @ VA
    return mean, cov


def _task_mean_var(tp, x):
    """``_task_predict``'s mean and the diagonal of its covariance alone,
    (..., N) each: the same math, without the (N, N) matrices. Kxx's
    diagonal is the outputscale (the RBF at distance 0)."""
    A, _, os_ = _whitened(tp, x)
    mean = tp["mean_const"][..., None] + (A.mT @ tp["m"][..., None])[..., 0]
    VA = torch.tril(tp["Ls"]).mT @ A
    var = os_[..., None] - (A * A).sum(-2) + (VA * VA).sum(-2)
    return mean, var


def _task_elbo(tp, x, y, n_total):
    """Minibatch ELBO of each task (whitened KL): x (B, d) the inputs, y
    (..., B) each task's targets; returns (...). Only the predictive
    variances enter the expected log likelihood, so the covariance's
    diagonal is computed alone (``_task_mean_var``)."""
    M = tp["Z"].shape[-2]
    noise = torch.exp(tp["log_noise"])[..., None]
    mean, var = _task_mean_var(tp, x)
    var_f = torch.clamp_min(var, 1e-10)
    # Expected log likelihood under q(f) for the Gaussian likelihood.
    ell = -0.5 * (torch.log(2 * math.pi * noise) + ((y - mean) ** 2 + var_f) / noise)
    ell_scaled = n_total / x.shape[-2] * ell.sum(-1)
    # Whitened KL(q||p) = 0.5 (||L_V||_F^2 + ||v||^2 - M - 2 log|det L_V|).
    Lv = torch.tril(tp["Ls"])
    logdet_q = 2 * torch.log(torch.diagonal(Lv, dim1=-2, dim2=-1).abs() + 1e-12).sum(-1)
    kl = 0.5 * ((Lv ** 2).sum((-2, -1)) + (tp["m"] ** 2).sum(-1) - M - logdet_q)
    return ell_scaled - kl


def pad_inducing_params(params, M_real, pad_to):
    """Pad an SVGP parameter dict from ``M_real`` to ``pad_to`` inducing
    points with exact no-op dummies: the dummy points sit pairwise far
    apart (``_PAD_DIST * (i + 1)`` in every coordinate), so every RBF
    entry that involves one underflows to exactly 0; with their ``v``
    rows zero and their block of ``L_V`` the identity, the ELBO's
    gradient with respect to every real parameter and the predictive
    mean equal the unpadded model's (adding exact zeros to a sum is
    exact; the KL's +n_pad from ``||I||_F^2`` cancels its -M term)."""
    Z = params["Z"]
    assert Z.shape[-2] == M_real
    n_pad = pad_to - M_real
    if n_pad == 0:
        return params
    lead, d = Z.shape[:-2], Z.shape[-1]
    pad_z = _PAD_DIST * (1.0 + torch.arange(n_pad, dtype=Z.dtype, device=Z.device))[:, None] \
        * torch.ones((n_pad, d), dtype=Z.dtype, device=Z.device)
    Zp = torch.cat([Z, pad_z.expand(lead + (n_pad, d))], dim=-2)
    m = torch.cat([params["m"], params["m"].new_zeros(lead + (n_pad,))], dim=-1)
    Ls = params["Ls"].new_zeros(lead + (pad_to, pad_to))
    Ls[..., :M_real, :M_real] = params["Ls"]
    idx = torch.arange(M_real, pad_to, device=Z.device)
    Ls[..., idx, idx] = 1.0
    return {**params, "Z": Zp, "m": m, "Ls": Ls}


def _init_params(XUt, n_task, M):
    """The initial parameters of one model of M inducing points: the
    inducing points at the first M training inputs in every task."""
    d = XUt.shape[1]
    like = dict(dtype=XUt.dtype, device=XUt.device)
    return {
        "Z": XUt[:M].expand(n_task, M, d).clone(),
        "log_lengthscale": torch.zeros((n_task, d), **like),
        "log_outputscale": torch.zeros((n_task,), **like),
        "log_noise": torch.full((n_task,), math.log(0.1), **like),
        "mean_const": torch.zeros((n_task,), **like),
        "m": torch.zeros((n_task, M), **like),
        "Ls": torch.eye(M, **like).expand(n_task, M, M).clone(),
    }


def svgp_epoch_perms(n_total, n_used, n_epochs, seed, device):
    """Each epoch's row order: a permutation of the ``n_total`` training
    pairs from a ``torch.Generator`` seeded ``seed``, cut to its first
    ``n_used`` (whole batches)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return [torch.randperm(n_total, generator=gen, device=device)[:n_used]
            for _ in range(n_epochs)]


def _train_svgp(params0, XUt, dYt, perms, batch, lr, n_total):
    """Adam (optax's: b1 0.9, b2 0.999, eps 1e-8, eps_root 0) on the
    summed negative ELBO of every task (and bucket) of ``params0``, one
    epoch per index tensor of ``perms`` cut into consecutive batches of
    ``batch``; every leaf trains, the inducing points too. Returns the
    trained parameters and each epoch's mean loss."""
    from ..parallel.fanout import scale_by_adam

    p = {k: params0[k].detach().clone().requires_grad_(True) for k in _LEAVES}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    count, losses = 0, []
    for perm in perms:
        xb = XUt[perm].reshape(-1, batch, XUt.shape[1])
        yb = dYt[perm].reshape(-1, batch, dYt.shape[1])
        epoch = []
        for x, y in zip(xb, yb):
            count += 1
            loss = -_task_elbo(p, x, y.T, n_total).sum()
            grads = torch.autograd.grad(loss, [p[k] for k in _LEAVES])
            with torch.no_grad():
                for k, g in zip(_LEAVES, grads):
                    p[k].sub_(lr * scale_by_adam(g, mu[k], nu[k], count))
            epoch.append(loss.detach())
        losses.append(torch.stack(epoch).mean())
    out = {k: v.detach() for k, v in p.items()}
    return out, (torch.stack(losses) if losses else XUt.new_zeros((0,)))


def _staging(trajs, device, batch_size):
    """The z-scored training pairs on ``device`` and the batching:
    (XUt, dYt, norm dict, batch, n_used)."""
    XUt, dYt, (xu_means, xu_std, dy_means, dy_std) = zscore_pairs(trajs)
    on = dict(dtype=default_dtype(device), device=device)
    XUt, dYt = XUt.to(**on), dYt.to(**on)
    norm = {"xu_means": xu_means.to(**on), "xu_std": xu_std.to(**on),
            "dy_means": dy_means.to(**on), "dy_std": dy_std.to(**on)}
    n_total = XUt.shape[0]
    B = min(int(batch_size), n_total)
    return XUt, dYt, norm, B, max(n_total // B, 1) * B


def svgp_mean_weights(gp_params):
    """Cached mean-prediction weights ``w = Lz^{-T} v`` (..., M) of every
    task (the input-independent triangular solve of ``_task_predict``'s
    mean, hoisted out)."""
    Z = gp_params["Z"]
    M = Z.shape[-2]
    Kzz = _rbf(Z, Z, torch.exp(gp_params["log_lengthscale"]),
               torch.exp(gp_params["log_outputscale"])) \
        + _JITTER * torch.eye(M, dtype=Z.dtype, device=Z.device)
    Lz = _cholesky(Kzz)
    return torch.linalg.solve_triangular(Lz.mT, gp_params["m"][..., None], upper=True)[..., 0]


def _cached_mean(gp, w, xut):
    """``mean_const + k(x, Z) @ w`` of every task: the leaves of ``gp``
    and ``w`` lead with (..., n_task), xut (..., d) broadcasts against
    their leading axes; returns (..., n_task)."""
    ls = torch.exp(gp["log_lengthscale"])
    os_ = torch.exp(gp["log_outputscale"])
    diff = xut[..., None, None, :] - gp["Z"]
    k = os_[..., None] * torch.exp(-0.5 * ((diff / ls[..., None, :]) ** 2).sum(-1))
    return gp["mean_const"] + (k * w).sum(-1)


def gp_pred_core_cached(params, state, ctrl):
    """The cached-mean-weights GP predictor as a free function: one kernel
    row of M entries a task, ``mean = mean_const + k(x, Z) @ w``; padded
    dummy inducing points contribute exact zeros. ``params`` holds
    ``gp`` (the SVGP parameters), ``w`` and the z-scoring
    (``xu_means``, ``xu_std``, ``dy_means``, ``dy_std``). One model for
    every point (``Z`` (n_task, M, d)), or one a lane (``Z`` (B, n_task,
    M, d), every other tensor leading with B too): lane b's points
    ``state`` (B, ..., ds) through lane b's model."""
    gp, w = params["gp"], params["w"]
    xu = torch.cat([state, ctrl], dim=-1)
    if gp["Z"].ndim == 4:
        lead, B = state.shape, state.shape[0]
        xu = xu.reshape(B, -1, xu.shape[-1])

        def lane(a):
            return a[:, None]

        xut = (xu - lane(params["xu_means"])) / lane(params["xu_std"])
        mean_t = _cached_mean({k: lane(v) for k, v in gp.items()}, lane(w), xut)
        dy = mean_t * lane(params["dy_std"]) + lane(params["dy_means"])
        return state + dy.reshape(lead)
    xut = (xu - params["xu_means"]) / params["xu_std"]
    mean_t = _cached_mean(gp, w, xut)
    return state + (mean_t * params["dy_std"] + params["dy_means"])


def standard_normal(shape, like, key=None):
    """Standard-normal draws of ``shape`` with ``like``'s dtype and
    device: ``key`` a ``torch.Generator``, an integer seed, or None (a
    seed from numpy's global generator)."""
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=like.device)
        gen.manual_seed(int(np.random.randint(1 << 31)) if key is None else int(key))
    return torch.randn(tuple(shape), generator=gen, dtype=like.dtype, device=like.device)


class ApproximateGPModelFactory(ModelFactory):
    """Hyperparameters:

    - *induce_count* (int, 50..200, default 100): inducing points.

    The models run on the card unless the factory is given ``device``.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Model = ApproximateGPModel
        self.name = "ApproximateGP"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        cs.add_hyperparameter(
            UniformIntegerHyperparameter("induce_count", lower=50, upper=200, default_value=100))
        return cs


class ApproximateGPModel(Model):
    """The SVGP dynamics model: ``niter`` epochs of Adam at rate ``lr``
    over batches of ``batch_size`` pairs, ``min(induce_count, n)``
    inducing points, each epoch's order from ``seed``. ``use_cuda`` is
    accepted and ignored; the model runs on ``device`` (None: the card)
    and trains on the device its trajectories lie on."""

    def __init__(self, system, mean="constant", kernel="RBF", niter=5, lr=0.1,
                 batch_size=1024, induce_count=500, seed=100, use_cuda=None, device=None):
        super().__init__(system)
        del mean, use_cuda
        if kernel != "RBF":
            raise ValueError("Only the RBF kernel is supported")
        self.niter = int(niter)
        self.lr = float(lr)
        self.batch_size = int(batch_size)
        self.induce_count = int(induce_count)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._params = None
        self._w = None
        self.xu_means = None

    def traj_to_state(self, traj):
        return traj[-1].obs

    @property
    def state_dim(self):
        return self.system.obs_dim

    # -- training ---------------------------------------------------------
    def train(self, trajs, silent=False, perms=None):
        """Fit the z-scoring and train the SVGP on the valid (x_t, u_t) ->
        x_{t+1} - x_t pairs of ``trajs``, on their device. ``perms``
        replaces the epochs' row orders (``niter`` index tensors of the
        whole batches' length)."""
        from ..core.trajectory import batch as traj_batch

        self.device = traj_batch(trajs).obs.device
        XUt, dYt, norm, B, n_used = _staging(trajs, self.device, self.batch_size)
        self.xu_means, self.xu_std = norm["xu_means"], norm["xu_std"]
        self.dy_means, self.dy_std = norm["dy_means"], norm["dy_std"]
        n_total = XUt.shape[0]
        params0 = _init_params(XUt, self.system.obs_dim, min(self.induce_count, n_total))
        if perms is None:
            perms = svgp_epoch_perms(n_total, n_used, self.niter, self.seed, self.device)
        else:
            perms = [torch.as_tensor(np.array(p), device=self.device) for p in perms]
        self._params, self._losses = _train_svgp(params0, XUt, dYt, perms, B, self.lr, n_total)
        self._w = svgp_mean_weights(self._params)

    # -- prediction -------------------------------------------------------
    @property
    def params(self):
        """The SVGP parameters (``gp``), the z-scoring and the cached
        mean weights ``w = Lz^{-T} v`` (``svgp_mean_weights``), with which
        ``pred_core`` costs one kernel row a task and no factorization."""
        return {
            "gp": self._params, "w": self._w,
            "xu_means": self.xu_means, "xu_std": self.xu_std,
            "dy_means": self.dy_means, "dy_std": self.dy_std,
        }

    def _predictive(self, params, state, ctrl):
        """Each task's predictive mean and variance (the likelihood's
        noise included) at every (state, ctrl) of the leading axes, in
        normalized units: (mean (..., n_task), var (..., n_task))."""
        xu = torch.cat([state, ctrl], dim=-1)
        xut = (xu - params["xu_means"]) / params["xu_std"]
        lead = xut.shape[:-1]
        x = xut.reshape(-1, xut.shape[-1])
        gp = params["gp"]
        mean, var = _task_mean_var(gp, x)                      # (n_task, N)
        var = var + torch.exp(gp["log_noise"])[:, None]
        return mean.mT.reshape(lead + (-1,)), var.mT.reshape(lead + (-1,))

    def pred_core(self, params, state, ctrl):
        if params.get("w") is not None:
            # The cached-weights mean: identical to the predictive mean by
            # construction.
            return gp_pred_core_cached(params, state, ctrl)
        mean_t, _ = self._predictive(params, state, ctrl)
        return state + (mean_t * params["dy_std"] + params["dy_means"])

    def sample_core(self, params, state, ctrl, eps):
        """A posterior-predictive sample (independent tasks: a diagonal
        predictive covariance) with the standard-normal draw ``eps``
        (..., n_task)."""
        mean_t, var_t = self._predictive(params, state, ctrl)
        draw = mean_t + torch.sqrt(torch.clamp_min(var_t, 1e-12)) * eps
        return state + (draw * params["dy_std"] + params["dy_means"])

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                               dtype=default_dtype(self.device), device=self.device)

    def sample(self, state, ctrl, key=None):
        """One sample at (state, ctrl); ``key`` seeds the draw (a
        ``torch.Generator``, an integer, or None)."""
        state, ctrl = self._tensor(state), self._tensor(ctrl)
        eps = standard_normal((self.system.obs_dim,), state, key)
        return self.sample_core(self.params, state, ctrl, eps)

    def sample_parallel(self, states, ctrls, key=None):
        """An independent sample at every row of ``states`` (N, n)."""
        states, ctrls = self._tensor(states), self._tensor(ctrls)
        eps = standard_normal(states.shape[:-1] + (self.system.obs_dim,), states, key)
        return self.sample_core(self.params, states, ctrls, eps)

    def get_sampler(self, key=None):
        """A sampler with one frozen normal draw shared across calls
        (trajectory-consistent sampling)."""
        params = self.params
        u = standard_normal((self.system.obs_dim,), params["xu_means"], key)

        def sampler(state, ctrl):
            return self.sample_core(params, self._tensor(state), self._tensor(ctrl), u)

        return sampler

    def pred_parallel(self, states, ctrls):
        return self.pred_batch(states, ctrls)

    def pred_diff_parallel(self, states, ctrls):
        return self.pred_diff_batch(states, ctrls)

    def get_parameters(self):
        def host(t):
            return t.detach().cpu().numpy().copy()

        return {
            "gp_params": {k: host(v) for k, v in self._params.items()},
            "xu_means": host(self.xu_means), "xu_std": host(self.xu_std),
            "dy_means": host(self.dy_means), "dy_std": host(self.dy_std),
        }

    def set_parameters(self, params):
        """Load a ``get_parameters()`` dict — e.g. the JAX package's
        ``ApproximateGPModel.get_parameters()`` output of numpy arrays —
        onto the model's device."""
        self._params = {k: self._tensor(params["gp_params"][k]) for k in _LEAVES}
        for k in ("xu_means", "xu_std", "dy_means", "dy_std"):
            setattr(self, k, self._tensor(params[k]))
        self._w = svgp_mean_weights(self._params)


# The reference's name.
LargeGaussianProcess = ApproximateGPModel


def train_svgp_buckets(system, trajs, induce_counts, niter=5, lr=0.1, batch_size=1024,
                       seed=100, pad_to=None, perms=None, device=None):
    """Train one SVGP per distinct ``induce_count`` — every bucket in one
    batched program: each bucket trains at ``pad_to`` inducing points
    (default the largest count) with exact no-op dummies
    (``pad_inducing_params``), the loss is the sum of the buckets' ELBOs
    (independent gradients; Adam is elementwise), and the staging,
    initialization and epoch orders are ``ApproximateGPModel.train``'s,
    so each bucket equals a model trained alone with the same seed.
    ``perms`` replaces the epochs' row orders. Runs on ``device`` (None:
    the card).

    Returns ``(params, w, norm)``: the buckets' parameters with leading
    axis K (padded), their cached mean weights ``w`` (K, n_task, pad_to)
    and the z-scoring shared by every bucket."""
    device = resolve_device(device)
    counts = [int(m) for m in induce_counts]
    XUt, dYt, norm, B, n_used = _staging(trajs, device, batch_size)
    n_total, n_task = XUt.shape[0], system.obs_dim
    pad_to = int(pad_to or max(min(m, n_total) for m in counts))
    inits = [pad_inducing_params(_init_params(XUt, n_task, min(m, n_total)), min(m, n_total),
                                 pad_to) for m in counts]
    params0 = {k: torch.stack([p[k] for p in inits]) for k in _LEAVES}
    if perms is None:
        perms = svgp_epoch_perms(n_total, n_used, int(niter), int(seed), device)
    else:
        perms = [torch.as_tensor(np.array(p), device=device) for p in perms]
    params, _ = _train_svgp(params0, XUt, dYt, perms, B, float(lr), n_total)
    return params, svgp_mean_weights(params), norm
