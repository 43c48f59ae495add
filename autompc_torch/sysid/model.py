"""Model layer (port of ``autompc_tpu/sysid/model.py``).

A model separates static configuration (attributes) from trained
parameters (``model.params``, a dict of tensors) and exposes one pure
batched step function ``pred_core(params, state (..., ds),
ctrl (..., dc)) -> state (..., ds)``; controllers close over
``(model.params, model.pred_core)``. The public methods (``pred``,
``pred_batch``, ``pred_diff``, ``update_state``, ...) are conveniences
over the same functions: Jacobians come from the model's closed form
``pred_diff_core`` where it has one, else from ``torch.func.jacfwd``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch


def model_device(model):
    """The device of a model's tensors: its ``device`` attribute, else
    that of its first tensor parameter; None when it has neither (a
    ``FunctionModel``)."""
    dev = getattr(model, "device", None)
    if dev is not None:
        return torch.device(dev)
    for v in model.params.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return None


class Model(ABC):
    def __init__(self, system):
        self.system = system

    @property
    def params(self):
        """Trained parameters. Default: the get_parameters dict."""
        return self.get_parameters()

    def pred_core(self, params, state, ctrl):
        """Batched single-step prediction over every leading axis."""
        raise NotImplementedError

    def update_state_core(self, params, state, new_ctrl, new_obs):
        """Pure model-state update on a new measurement, batched over
        every leading axis. Default: a model whose state is the
        observation adopts the new observation."""
        del params, state, new_ctrl
        return new_obs

    @abstractmethod
    def traj_to_state(self, traj):
        """Map a trajectory history to the current model state."""
        raise NotImplementedError

    def state_to_obs(self, state):
        """Observation part of a model state: its leading obs_dim
        entries."""
        return state[..., : self.system.obs_dim]

    def update_state(self, state, new_ctrl, new_obs):
        return self.update_state_core(self.params, state, new_ctrl, new_obs)

    def pred(self, state, ctrl):
        return self.pred_core(self.params, state, ctrl)

    def pred_batch(self, states, ctrls):
        return self.pred_core(self.params, states, ctrls)

    def pred_diff(self, state, ctrl):
        """(prediction (ds,), Jx (ds, ds), Ju (ds, dc)) at one point."""
        return self.pred_diff_batch(state, ctrl)

    def pred_diff_batch(self, states, ctrls):
        """Predictions and Jacobians at every point of the leading axes:
        the model's ``pred_diff_core`` where it has one, else forward-mode
        autodiff of ``pred_core`` (the JAX package's ``jax.jacfwd``)."""
        core = getattr(self, "pred_diff_core", None)
        if core is None:
            from ..control.ilqr import jacfwd_pred_diff

            core = jacfwd_pred_diff(self.pred_core, self.state_dim)
        return core(self.params, states, ctrls)

    def to_linear(self):
        """(A, B) for linear models only."""
        raise NotImplementedError

    def train(self, trajs, silent=False):
        raise NotImplementedError

    def get_parameters(self):
        raise NotImplementedError

    def set_parameters(self, params):
        raise NotImplementedError

    @property
    @abstractmethod
    def state_dim(self):
        raise NotImplementedError

    @property
    def is_linear(self):
        return type(self).to_linear is not Model.to_linear

    @property
    def is_diff(self):
        # Every model with a pred_core is differentiable by jacfwd.
        return type(self).pred_core is not Model.pred_core


class ModelFactory(ABC):
    """Creates and trains a system-ID model from a hyperparameter
    configuration. The factory's own keyword arguments override the
    configuration's values (``SINDyFactory(system, device="cpu")``)."""

    def __init__(self, system, **kwargs):
        self.system = system
        self.kwargs = kwargs

    def __call__(self, cfg, train_trajs, silent=False, skip_train_model=False):
        model_args = cfg.get_dictionary() if hasattr(cfg, "get_dictionary") else dict(cfg)
        model_args.update(self.kwargs)
        model = self.Model(self.system, **model_args)
        model.factory = self
        if not skip_train_model:
            model.train(train_trajs, silent=silent)
        return model

    @abstractmethod
    def get_configuration_space(self):
        raise NotImplementedError
