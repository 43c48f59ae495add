"""Stand-in models (port of ``autompc_tpu/sysid/dummy.py``): a fixed
linear model, a two-state nonlinear one, a dynamics function as a model
and the point linearization of a model."""

from __future__ import annotations

import numpy as np
import torch

from .. import default_dtype, resolve_device
from .arx import linear_pred, linear_pred_diff
from .model import Model


def _on(a, device):
    """A tensor keeps its device; an array goes to ``device`` (the card
    unless named) in its default dtype."""
    if isinstance(a, torch.Tensor):
        return a
    device = resolve_device(device)
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=default_dtype(device),
                           device=device)


class _Linear(Model):
    """``x' = A x + B u`` with a fixed (A, B)."""

    @property
    def params(self):
        return {"A": self.A, "B": self.B}

    def pred_core(self, params, state, ctrl):
        return linear_pred(params, state, ctrl)

    def pred_diff_core(self, params, state, ctrl):
        return linear_pred_diff(params, state, ctrl)

    def to_linear(self):
        return self.A, self.B

    def get_parameters(self):
        return {"A": self.A.detach().cpu().numpy().copy(),
                "B": self.B.detach().cpu().numpy().copy()}

    def set_parameters(self, params):
        like = self.A
        self.A = like.new_tensor(np.asarray(params["A"], dtype=float))
        self.B = like.new_tensor(np.asarray(params["B"], dtype=float))


class DummyLinear(_Linear):
    """A fixed (A, B) linear model; no training. Arrays go to the card
    unless ``device`` names another device; tensors keep theirs."""

    def __init__(self, system, A, B, device=None):
        super().__init__(system)
        self.A = _on(A, device)
        self.B = _on(B, self.A.device).to(self.A)
        self.device = self.A.device

    def traj_to_state(self, traj):
        return traj[-1].obs

    @property
    def state_dim(self):
        return self.system.obs_dim

    def train(self, trajs, silent=False):
        pass


class DummyNonlinear(Model):
    """A two-state nonlinear test system: x1' = x1 + x2^3, x2' = x2 + u.
    Runs on the card unless ``device`` names another device."""

    def __init__(self, system, device=None):
        super().__init__(system)
        self.device = resolve_device(device)

    @property
    def state_dim(self):
        return 2

    def train(self, trajs, silent=False):
        pass

    def traj_to_state(self, traj):
        return traj[-1].obs

    @property
    def params(self):
        return {}

    def pred_core(self, params, state, ctrl):
        x1, x2 = state[..., 0], state[..., 1]
        return torch.stack([x1 + x2**3, x2 + ctrl[..., 0]], dim=-1)


class FunctionModel(Model):
    """A dynamics function as a Model: a benchmark's true dynamics act as
    a perfect trained model (the tuner's true-dynamics fan-out uses it as
    its surrogate). ``dynamics_fn(state (..., n), ctrl (..., m))`` is
    batched over every leading axis."""

    def __init__(self, system, dynamics_fn):
        super().__init__(system)
        self._fn = dynamics_fn

    @property
    def state_dim(self):
        return self.system.obs_dim

    def traj_to_state(self, traj):
        return traj[-1].obs

    def train(self, trajs, silent=False):
        pass

    @property
    def params(self):
        return {}

    def pred_core(self, params, state, ctrl):
        return self._fn(state, ctrl)


class LinearizedModel(_Linear):
    """The linearization of ``nonlinear_model`` at ``x0`` (an array or a
    tensor on the model's device) with zero control."""

    def __init__(self, system, x0, nonlinear_model):
        super().__init__(system)
        self._model = nonlinear_model
        dev = getattr(nonlinear_model, "device", None)
        self.x0 = _on(x0, dev)
        self.device = self.x0.device
        _, self.A, self.B = nonlinear_model.pred_diff(
            self.x0, self.x0.new_zeros(system.ctrl_dim))

    @property
    def state_dim(self):
        return self._model.state_dim

    def traj_to_state(self, traj):
        return self._model.traj_to_state(traj)
