"""MLP dynamics model (port of ``autompc_tpu/sysid/mlp.py``: ``net_apply``,
``net_apply_jac``, ``MLP`` and ``MLPFactory``).

A feed-forward net predicts the z-scored state delta. The net is an
``nn.Module``; the pure functions ``net_apply``/``net_apply_jac`` take
its parameters as the JAX package's list of ``{"W": (n_in, n_out),
"b": (n_out,)}`` dicts and are batch-native: every leading axis of the
input is a batch axis. They also take one net per lane, ``{"W":
(B, n_in, n_out), "b": (B, n_out)}``, with the input's first axis the
lane axis (the joint-MLP fan-out's per-lane models). Training is Adam
(lr, eps 1e-8) on the mean Huber loss (delta 1) over ``n // n_batch``
full batches per epoch, shuffled by an explicit ``torch.Generator``.
The closed-form input Jacobian replaces the JAX package's per-sample
``jacfwd`` fallback.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import default_dtype, resolve_device
from ..config import (
    CategoricalHyperparameter,
    ConfigurationSpace,
    InCondition,
    UniformFloatHyperparameter,
    UniformIntegerHyperparameter,
)
from ..core.trajectory import batch as traj_batch
from .model import Model, ModelFactory

_SELU_SCALE = 1.0507009873554805
_SELU_ALPHA = 1.6732632423543772

_NONLIN = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "selu": torch.selu,
}

_NONLIN_DERIV = {
    # d act / d a, elementwise, in terms of the pre-activation a.
    "relu": lambda a: (a > 0).to(a.dtype),
    "tanh": lambda a: 1.0 - torch.tanh(a) ** 2,
    "sigmoid": lambda a: torch.sigmoid(a) * (1.0 - torch.sigmoid(a)),
    "selu": lambda a: _SELU_SCALE * torch.where(
        a > 0, torch.ones_like(a), _SELU_ALPHA * torch.exp(a)
    ),
}


def _per_lane(params):
    """Whether ``params`` holds one net per lane (3-D weights)."""
    return params[0]["W"].ndim == 3


def net_apply(params, x, nonlin):
    """Hidden layers with nonlinearity, linear output head; ``x``
    (..., n_in) -> (..., n_out). Per-lane nets take ``x`` (B, ...,
    n_in), lane b through net b."""
    act = _NONLIN[nonlin]
    if _per_lane(params):
        lead = x.shape[:-1]
        x = x.reshape(lead[0], -1, x.shape[-1])
        for layer in params[:-1]:
            x = act(torch.baddbmm(layer["b"][:, None, :], x, layer["W"]))
        out = params[-1]
        x = torch.baddbmm(out["b"][:, None, :], x, out["W"])
        return x.reshape(lead + x.shape[-1:])
    for layer in params[:-1]:
        x = act(x @ layer["W"] + layer["b"])
    out = params[-1]
    return x @ out["W"] + out["b"]


def net_apply_jac(params, x, nonlin):
    """Forward pass and the closed-form input Jacobian in one sweep:
    ``J = W_L' D_{L-1} W_{L-1}' ... D_1 W_1'`` with ``D_i`` the diagonal
    of activation derivatives at layer i.

    ``x`` (..., n_in) -> ``(out (..., n_out), J (..., n_out, n_in))``;
    per-lane nets take ``x`` (B, ..., n_in) (``_lane_net_apply_jac``)."""
    if _per_lane(params):
        return _lane_net_apply_jac(params, x, nonlin)
    act = _NONLIN[nonlin]
    dact = _NONLIN_DERIV[nonlin]
    J = None  # (..., cur_dim, n_in)
    for layer in params[:-1]:
        a = x @ layer["W"] + layer["b"]
        d = dact(a)
        WT = layer["W"].T
        J = d[..., :, None] * (WT if J is None else WT @ J)
        x = act(a)
    out = params[-1]
    WT = out["W"].T
    if J is None:
        J = WT.expand(x.shape[:-1] + WT.shape)
    else:
        J = WT @ J
    return x @ out["W"] + out["b"], J


def _lane_net_apply_jac(params, x, nonlin):
    """``net_apply_jac`` of one net per lane: the chain is carried
    transposed, ``J' = W_1 D_1 W_2 ... D_{L-1} W_L``, so that each
    layer's product is one batched matmul of the lane's points
    (B, N n_in, cur) by its weights (B, cur, out)."""
    act = _NONLIN[nonlin]
    dact = _NONLIN_DERIV[nonlin]
    lead = x.shape[:-1]
    B, n_in = lead[0], x.shape[-1]
    x = x.reshape(B, -1, n_in)
    N = x.shape[1]
    JT = None  # (B, N, n_in, cur)
    for layer in params[:-1]:
        a = torch.baddbmm(layer["b"][:, None, :], x, layer["W"])
        d = dact(a)[:, :, None, :]
        W = layer["W"]
        JT = d * (W[:, None] if JT is None else
                  torch.bmm(JT.reshape(B, N * n_in, -1), W).reshape(B, N, n_in, -1))
        x = act(a)
    out = params[-1]
    W = out["W"]
    y = torch.baddbmm(out["b"][:, None, :], x, W)
    if JT is None:
        J = W.transpose(1, 2)[:, None].expand(B, N, W.shape[2], n_in)
    else:
        J = torch.bmm(JT.reshape(B, N * n_in, -1), W).reshape(B, N, n_in, -1).transpose(2, 3)
    return y.reshape(lead + y.shape[-1:]), J.reshape(lead + J.shape[-2:])


def zscore_pairs(trajs):
    """The training pairs of ``trajs``: every valid (x_t, u_t) ->
    x_{t+1} - x_t, z-scored per dimension (a spread below 1e-12 counts
    as 1), on the device the trajectories lie on. Returns (XU_t (n,
    nx+nu), dY_t (n, nx), (xu_means, xu_std, dy_means, dy_std))."""
    tb = traj_batch(trajs)
    mask = tb.step_mask()
    X = tb.obs[mask]
    U = tb.ctrls[mask]
    dY = torch.roll(tb.obs, -1, dims=1)[mask] - X
    XU = torch.cat([X, U], dim=1)

    def stats(A):
        mean = A.mean(dim=0)
        std = A.std(dim=0, unbiased=False)
        return mean, torch.where(std > 1e-12, std, torch.ones_like(std))

    xu_means, xu_std = stats(XU)
    dy_means, dy_std = stats(dY)
    return ((XU - xu_means) / xu_std, (dY - dy_means) / dy_std,
            (xu_means, xu_std, dy_means, dy_std))


def epoch_perms(n, n_batch, n_epochs, seed, device):
    """Each epoch's row order: a permutation of the ``n`` pairs from a
    ``torch.Generator`` seeded ``seed + 1``, cut to ``n // n_batch``
    full batches (at least one)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    n_used = max(n // n_batch, 1) * n_batch
    return [torch.randperm(n, generator=gen, device=device)[:n_used]
            for _ in range(n_epochs)]


def net_init(sizes, seed, dtype, device):
    """The initial layers of a net of ``sizes``, drawn as ``MLP``
    draws them for ``seed``: a list of ``{"W", "b"}`` tensors."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return [{"W": la["W"].detach(), "b": la["b"].detach()}
            for la in _Net(sizes, gen, dtype, device).layers()]


class MLPFactory(ModelFactory):
    """Hyperparameters:

    - *n_hidden_layers* (categorical ["1","2","3","4"], default "2")
    - *hidden_size_i* (int, 16..256, default 128; conditioned on
      n_hidden_layers >= i)
    - *nonlintype* (categorical [relu, tanh, sigmoid, selu])
    - *lr* (float, 1e-5..1, log, default 1e-3)

    The models run on the card unless the factory is given ``device``.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Model = MLP
        self.name = "MLP"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        nonlintype = CategoricalHyperparameter(
            "nonlintype", choices=["relu", "tanh", "sigmoid", "selu"], default_value="relu")
        n_hidden_layers = CategoricalHyperparameter(
            "n_hidden_layers", choices=["1", "2", "3", "4"], default_value="2")
        hs = [UniformIntegerHyperparameter(f"hidden_size_{i}", lower=16, upper=256,
                                           default_value=128)
              for i in (1, 2, 3, 4)]
        lr = UniformFloatHyperparameter("lr", lower=1e-5, upper=1.0, default_value=1e-3, log=True)
        cs.add_hyperparameters([nonlintype, n_hidden_layers, *hs, lr])
        cs.add_conditions([
            InCondition("hidden_size_2", "n_hidden_layers", ["2", "3", "4"]),
            InCondition("hidden_size_3", "n_hidden_layers", ["3", "4"]),
            InCondition("hidden_size_4", "n_hidden_layers", ["4"]),
        ])
        return cs


class _Net(nn.Module):
    """The layer stack; weights are stored (n_in, n_out) as in the JAX
    package and initialised like ``torch.nn.Linear``
    (U[-1/sqrt(fan_in), 1/sqrt(fan_in)])."""

    def __init__(self, sizes, generator, dtype, device):
        super().__init__()
        self.Ws = nn.ParameterList()
        self.bs = nn.ParameterList()
        for n_in, n_out in zip(sizes[:-1], sizes[1:]):
            bound = 1.0 / math.sqrt(n_in)

            def draw(*shape):
                u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
                return nn.Parameter((2.0 * u - 1.0) * bound)

            self.Ws.append(draw(n_in, n_out))
            self.bs.append(draw(n_out))

    def layers(self):
        return [{"W": W, "b": b} for W, b in zip(self.Ws, self.bs)]

    def forward(self, x, nonlin):
        return net_apply(self.layers(), x, nonlin)


class MLP(Model):
    def __init__(
        self,
        system,
        n_hidden_layers=3,
        hidden_size=128,
        nonlintype="relu",
        n_train_iters=50,
        n_batch=64,
        lr=1e-3,
        hidden_size_1=None,
        hidden_size_2=None,
        hidden_size_3=None,
        hidden_size_4=None,
        seed=100,
        device=None,
    ):
        super().__init__(system)
        if nonlintype not in _NONLIN:
            raise ValueError(f"unknown nonlintype {nonlintype!r}")
        nx, nu = system.obs_dim, system.ctrl_dim
        n_hidden_layers = int(n_hidden_layers)
        hidden_sizes = [int(hidden_size)] * n_hidden_layers
        for i, size in enumerate(
            [hidden_size_1, hidden_size_2, hidden_size_3, hidden_size_4]
        ):
            if size is not None and i < n_hidden_layers:
                hidden_sizes[i] = int(size)
        self.hidden_sizes = hidden_sizes
        self.nonlintype = nonlintype
        self.n_train_iters = int(n_train_iters)
        self.n_batch = int(n_batch)
        self.lr = float(lr)
        self.seed = int(seed)
        self._sizes = [nx + nu] + hidden_sizes + [nx]
        self._place(resolve_device(device))

    def _place(self, device):
        """(Re)create the net and unit z-scoring on ``device``."""
        self.device = torch.device(device)
        dtype = default_dtype(self.device)
        nx, nu = self.system.obs_dim, self.system.ctrl_dim
        self.net = self._new_net(self.seed)
        like = dict(dtype=dtype, device=self.device)
        self.xu_means = torch.zeros(nx + nu, **like)
        self.xu_std = torch.ones(nx + nu, **like)
        self.dy_means = torch.zeros(nx, **like)
        self.dy_std = torch.ones(nx, **like)

    def _new_net(self, seed):
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return _Net(self._sizes, gen, default_dtype(self.device), self.device)

    def traj_to_state(self, traj):
        return traj[-1].obs

    @property
    def state_dim(self):
        return self.system.obs_dim

    # -- training -------------------------------------------------------
    def train(self, trajs, silent=False, seed=None):
        """Fit the z-scoring and train a freshly initialised net on the
        valid (x_t, u_t) -> x_{t+1} - x_t pairs of ``trajs``, on the
        device the trajectories lie on."""
        XUt, dYt, norm = zscore_pairs(trajs)
        if XUt.device != self.device:
            self._place(XUt.device)
        self.xu_means, self.xu_std, self.dy_means, self.dy_std = norm

        seed = self.seed if seed is None else int(seed)
        self.net = self._new_net(seed)
        perms = epoch_perms(XUt.shape[0], self.n_batch, self.n_train_iters, seed, self.device)
        self._losses = self.run_epochs(XUt, dYt, perms)

    def run_epochs(self, XUt, dYt, perms):
        """Adam on the mean Huber loss from the net's current weights:
        one epoch per index tensor of ``perms``, cut into consecutive
        batches of ``n_batch``. Returns the mean loss of each epoch."""
        opt = torch.optim.Adam(self.net.parameters(), lr=self.lr, eps=1e-8)
        losses = []
        for perm in perms:
            total = 0.0
            batches = perm.reshape(-1, min(self.n_batch, perm.shape[0]))
            for idx in batches:
                opt.zero_grad(set_to_none=True)
                pred = self.net(XUt[idx], self.nonlintype)
                loss = nn.functional.huber_loss(pred, dYt[idx], delta=1.0)
                loss.backward()
                opt.step()
                total = total + loss.detach()
            losses.append(total / batches.shape[0])
        return torch.stack(losses) if losses else XUt.new_zeros((0,))

    # -- prediction ------------------------------------------------------
    @property
    def params(self):
        return {
            "net": [
                {"W": la["W"].detach(), "b": la["b"].detach()}
                for la in self.net.layers()
            ],
            "xu_means": self.xu_means,
            "xu_std": self.xu_std,
            "dy_means": self.dy_means,
            "dy_std": self.dy_std,
        }

    def pred_core(self, params, state, ctrl):
        xu = torch.cat([state, ctrl], dim=-1)
        xut = (xu - params["xu_means"]) / params["xu_std"]
        dyt = net_apply(params["net"], xut, self.nonlintype)
        return state + (dyt * params["dy_std"] + params["dy_means"])

    def pred_diff_core(self, params, state, ctrl):
        """(pred, Jx, Ju) with the closed-form net Jacobian scaled
        through the z-scoring: the model Jacobian is ``I`` (state part)
        ``+ diag(dy_std) J_net diag(1 / xu_std)``. Batched over every
        leading axis: Jx (..., ds, ds), Ju (..., ds, dc)."""
        n = state.shape[-1]
        xu = torch.cat([state, ctrl], dim=-1)
        xut = (xu - params["xu_means"]) / params["xu_std"]
        dyt, Jt = net_apply_jac(params["net"], xut, self.nonlintype)
        dy = dyt * params["dy_std"] + params["dy_means"]
        J = (params["dy_std"][:, None] * Jt) / params["xu_std"][None, :]
        Jx = torch.eye(n, dtype=J.dtype, device=J.device) + J[..., :n]
        return state + dy, Jx, J[..., n:]

    def get_parameters(self):
        def host(t):
            return t.detach().cpu().numpy().copy()

        return {
            "net_params": [
                {"W": host(la["W"]), "b": host(la["b"])}
                for la in self.net.layers()
            ],
            "xu_means": host(self.xu_means),
            "xu_std": host(self.xu_std),
            "dy_means": host(self.dy_means),
            "dy_std": host(self.dy_std),
        }

    def set_parameters(self, params):
        """Load the ``get_parameters()`` dict — e.g. the JAX package's
        ``MLP.get_parameters()`` output of numpy arrays. The layer
        shapes must equal this model's."""
        layers = params["net_params"]
        want = list(zip(self._sizes[:-1], self._sizes[1:]))
        got = [tuple(np.shape(la["W"])) for la in layers]
        if got != want:
            raise ValueError(
                f"net_params layer shapes {got} do not match this model's {want}"
            )
        like = dict(dtype=default_dtype(self.device), device=self.device)

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), **like)

        with torch.no_grad():
            for W, b, la in zip(self.net.Ws, self.net.bs, layers):
                W.copy_(dev(la["W"]))
                b.copy_(dev(la["b"]))
        self.xu_means = dev(params["xu_means"])
        self.xu_std = dev(params["xu_std"])
        self.dy_means = dev(params["dy_means"])
        self.dy_std = dev(params["dy_std"])
