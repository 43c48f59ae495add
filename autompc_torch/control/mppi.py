"""MPPI: model-predictive path-integral control (port of
``autompc_tpu/control/mppi.py``: ``MPPI`` and ``MPPIFactory``).

Per control step (``niter`` times): shift the nominal control sequence
one step, draw ``num_path`` perturbed sequences, roll every one through
the model over the horizon, and move the nominal sequence by the
perturbations weighted by ``exp(-(cost - min cost) / lmda)``. Controls
are optimized in units of the finite control bound and scaled by it.

The rollouts of B lanes (controllers, or fan-out candidates), each with
its own nominal sequence, perturbations, temperature and cost, run in
one batched loop over the horizon: ``mppi_rollouts`` and
``mppi_update``. ``MPPI`` is that code at B = 1.

Random draws: every standard-normal draw of the controller, its
receding loop (``control/receding.py``) and its fan-out
(``parallel/fanout.py``) goes through ``standard_normal``, named by
``(seed, n)``: the controller's seed and the draw's number in its
chain (draw 0 is the initial nominal sequence, draw n >= 1 the n-th
perturbation draw). On the card the draws come from a
``torch.Generator`` on the device seeded from (seed, n). The JAX
package's ``jax.random`` chain cannot be matched bit for bit; tests
replace this one function by that chain's draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import (
    ConfigurationSpace,
    UniformFloatHyperparameter,
    UniformIntegerHyperparameter,
)
from ..costs.lane_costs import SharedCost
from ..sysid.model import model_device
from .controller import Controller, ControllerFactory

_GENERATORS = {}


def standard_normal(shape, stream, like, lanes=None):
    """Standard-normal draws of ``shape`` for the draw ``stream`` =
    (seed, n), with ``like``'s dtype and device. ``lanes`` = B gives B
    independent draws (B, *shape), lane b's as the JAX package's
    ``fold_in(key, b)`` gives it; None one draw that every lane shares.
    Draws no host value and reads none back."""
    seed, n = (int(v) for v in stream)
    dev = like.device
    gen = _GENERATORS.get(dev)
    if gen is None:
        gen = _GENERATORS[dev] = torch.Generator(device=dev)
    # splitmix64 of (seed, n): distinct streams for distinct draws.
    z = (seed * 0x9E3779B97F4A7C15 + (n + 1) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    gen.manual_seed((z ^ (z >> 31)) & (2**63 - 1))
    full = tuple(shape) if lanes is None else (int(lanes),) + tuple(shape)
    return torch.randn(full, generator=gen, dtype=like.dtype, device=dev)


def mppi_rollouts(pred_core, params, x0, seq, eps, lane_cost, lmda, sigma, umin_n, umax_n,
                  scale, obsdim):
    """Per-path costs of B lanes: x0 (B, ds) the start, seq (B, H, dc) the
    shifted nominal sequence, eps (B, H, P, dc) the perturbations (units
    of ``scale``), ``lane_cost`` the lanes' stage costs
    (``costs/lane_costs.py``), lmda and sigma (B,) or numbers. Returns
    (costs (B, P), the clipped perturbations (B, H, P, dc)): the stage
    costs of the scaled controls, the terminal cost and the action term
    ``lmda / sigma * sum_t a_t . eps_t``."""
    B, H, P = eps.shape[0], eps.shape[1], eps.shape[2]
    path = x0[:, None, :].expand(B, P, x0.shape[-1])
    costs = x0.new_zeros((B, P))
    act_cost = x0.new_zeros((B, P))
    ratio = lmda / sigma
    if isinstance(ratio, torch.Tensor):
        ratio = ratio[:, None]
    out = []
    for t in range(H):
        seq_t = seq[:, t, None, :]
        actions = torch.clamp(eps[:, t] + seq_t, umin_n, umax_n)
        eps_adj = actions - seq_t
        scaled = actions * scale
        costs = costs + (lane_cost.obs(path[..., :obsdim]) + lane_cost.ctrl(scaled))
        act_cost = act_cost + ratio * (actions * eps_adj).sum(-1)
        path = pred_core(params, path, scaled)
        out.append(eps_adj)
    term = lane_cost.term(path[..., :obsdim])
    return costs + term + act_cost, torch.stack(out, dim=1)


def mppi_update(seq, costs, eps, lmda):
    """The exponential-weighting update of B lanes' nominal sequences:
    seq (B, H, dc), costs (B, P), eps (B, H, P, dc), lmda (B,) or a
    number. NaN costs propagate, as in the JAX package."""
    if isinstance(lmda, torch.Tensor):
        lmda = lmda[:, None]
    S = torch.exp(-(costs - torch.amin(costs, dim=1, keepdim=True)) / lmda)
    weight = S / S.sum(1, keepdim=True)
    return seq + (eps * weight[:, None, :, None]).sum(2)


def ctrl_scaling(bounds):
    """(umin / scale, umax / scale, scale) host arrays of a task's control
    bounds: controls are optimized in units of the finite upper bound (1
    where it is infinite)."""
    scale = np.where(np.isfinite(bounds[:, 1]), bounds[:, 1], 1.0)
    return bounds[:, 0] / scale, bounds[:, 1] / scale, scale


class MPPIFactory(ControllerFactory):
    """Hyperparameters:

    - *horizon* (int, 5..30, default 20)
    - *sigma* (float, 1e-4..2.0, default 1.0): perturbation variance
    - *lmda* (float, 0.1..2.0, default 1.0): temperature
    - *num_path* (int, 100..1000, default 200): sampled rollouts a step
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Controller = MPPI
        self.name = "MPPI"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        cs.add_hyperparameter(
            UniformIntegerHyperparameter("horizon", lower=5, upper=30, default_value=20))
        cs.add_hyperparameter(
            UniformFloatHyperparameter("sigma", lower=1e-4, upper=2.0, default_value=1.0))
        cs.add_hyperparameter(
            UniformFloatHyperparameter("lmda", lower=0.1, upper=2.0, default_value=1.0))
        cs.add_hyperparameter(
            UniformIntegerHyperparameter("num_path", lower=100, upper=1000, default_value=200))
        return cs


class MPPI(Controller):
    """The MPPI controller on ``model``: keyword arguments ``horizon``
    (20), ``num_path`` (1000), ``niter`` (1), ``sigma`` (1.0), ``lmda``
    (1.0) and ``seed`` (0). Runs on the device of the model's
    parameters. ``mesh`` (the JAX package's rollouts sharded over
    devices) raises."""

    def __init__(self, system, task, model, **kwargs):
        super().__init__(system, task, model)
        if kwargs.get("mesh") is not None:
            raise ValueError(
                "mesh (the sampled rollouts sharded over several cards) is not ported "
                "to autompc_torch yet; pass mesh=None"
            )
        self.H = int(kwargs.get("horizon", 20))
        self.num_path = int(kwargs.get("num_path", 1000))
        self.niter = int(kwargs.get("niter", 1))
        self.sigma = float(kwargs.get("sigma", 1.0))
        self.lmda = float(kwargs.get("lmda", 1.0))
        self.seed = int(kwargs.get("seed", 0))
        self.dim_ctrl = system.ctrl_dim
        self.device = model_device(model)
        self._bounds = ctrl_scaling(task.get_ctrl_bounds())
        self._on = {}
        self._cost = SharedCost(task.get_cost())
        self._model_params = model.params
        self._obs_dim = system.obs_dim

    def _scaling(self, like):
        """(umin_n, umax_n, scale) tensors like ``like``, made once."""
        key = (like.device, like.dtype)
        if key not in self._on:
            self._on[key] = tuple(like.new_tensor(v) for v in self._bounds)
        return self._on[key]

    def traj_to_state(self, traj):
        """The model's state, the last control, the initial nominal
        sequence (draw 0: std sqrt(sigma)) and the draw chain's seed and
        next draw's number."""
        like = traj.obs
        return dict(
            model_state=self.model.traj_to_state(traj),
            last_u=traj[-1].ctrl,
            act_sequence=math.sqrt(self.sigma) * standard_normal(
                (self.H, self.dim_ctrl), (self.seed, 0), like),
            seed=self.seed,
            draws=1,
        )

    @property
    def state_dim(self):
        return self.model.state_dim + self.system.ctrl_dim

    @staticmethod
    def is_compatible(system, task, model):
        return True

    def _do_rollouts(self, params, x0, act_sequence, gen, eps=None):
        """(costs (num_path,), clipped perturbations (H, num_path, dc)) of
        one shifted nominal sequence. ``gen`` = (seed, n) names the draw;
        ``eps`` (H, num_path, dc) injects the perturbations instead."""
        if eps is None:
            eps = math.sqrt(self.sigma) * standard_normal(
                (self.H, self.num_path, self.dim_ctrl), gen, x0)
        umin_n, umax_n, scale = self._scaling(x0)
        costs, eps_out = mppi_rollouts(
            self.model.pred_core, params, x0[None], act_sequence[None], eps[None], self._cost,
            self.lmda, self.sigma, umin_n, umax_n, scale, self._obs_dim)
        return costs[0], eps_out[0]

    def _update_sequence(self, seq, costs, eps):
        return mppi_update(seq[None], costs[None], eps[None], self.lmda)[0]

    def step(self, cstate, new_obs):
        params = self._model_params
        x0 = self.model.update_state_core(
            params, cstate["model_state"], cstate["last_u"], new_obs)
        seq, seed, n = cstate["act_sequence"], cstate["seed"], cstate["draws"]
        for _ in range(self.niter):
            # Shift the nominal sequence before drawing.
            seq = torch.cat([seq[1:], seq[-1:]], dim=0)
            costs, eps = self._do_rollouts(params, x0, seq, (seed, n))
            n += 1
            seq = self._update_sequence(seq, costs, eps)
        u = seq[0] * self._scaling(seq)[2]
        return u, dict(model_state=x0, last_u=u, act_sequence=seq, seed=seed, draws=n)
