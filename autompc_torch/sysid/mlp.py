"""MLP dynamics model (port of ``autompc_tpu/sysid/mlp.py``: ``net_apply``,
``net_apply_jac`` and ``MLP``).

A feed-forward net predicts the z-scored state delta. The net is an
``nn.Module``; the pure functions ``net_apply``/``net_apply_jac`` take
its parameters as the JAX package's list of ``{"W": (n_in, n_out),
"b": (n_out,)}`` dicts and are batch-native: every leading axis of the
input is a batch axis. Training is Adam (lr, eps 1e-8) on the mean
Huber loss (delta 1) over ``n // n_batch`` full batches per epoch,
shuffled by an explicit ``torch.Generator``. The closed-form input
Jacobian replaces the JAX package's per-sample ``jacfwd`` fallback.
``MLPFactory`` is not ported yet (it needs the configuration space).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import default_dtype, resolve_device
from ..core.trajectory import batch as traj_batch
from .model import Model

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


def net_apply(params, x, nonlin):
    """Hidden layers with nonlinearity, linear output head; ``x``
    (..., n_in) -> (..., n_out)."""
    act = _NONLIN[nonlin]
    for layer in params[:-1]:
        x = act(x @ layer["W"] + layer["b"])
    out = params[-1]
    return x @ out["W"] + out["b"]


def net_apply_jac(params, x, nonlin):
    """Forward pass and the closed-form input Jacobian in one sweep:
    ``J = W_L' D_{L-1} W_{L-1}' ... D_1 W_1'`` with ``D_i`` the diagonal
    of activation derivatives at layer i.

    ``x`` (..., n_in) -> ``(out (..., n_out), J (..., n_out, n_in))``."""
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
        tb = traj_batch(trajs)
        if tb.obs.device != self.device:
            self._place(tb.obs.device)
        mask = tb.step_mask()
        X = tb.obs[mask]
        U = tb.ctrls[mask]
        dY = torch.roll(tb.obs, -1, dims=1)[mask] - X
        XU = torch.cat([X, U], dim=1)

        def stats(A):
            mean = A.mean(dim=0)
            std = A.std(dim=0, unbiased=False)
            return mean, torch.where(std > 1e-12, std, torch.ones_like(std))

        self.xu_means, self.xu_std = stats(XU)
        self.dy_means, self.dy_std = stats(dY)
        XUt = (XU - self.xu_means) / self.xu_std
        dYt = (dY - self.dy_means) / self.dy_std

        seed = self.seed if seed is None else int(seed)
        self.net = self._new_net(seed)
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        n = XUt.shape[0]
        nb = max(n // self.n_batch, 1)
        perms = [
            torch.randperm(n, generator=gen, device=self.device)[: nb * self.n_batch]
            for _ in range(self.n_train_iters)
        ]
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
