"""Model layer (port of ``autompc_tpu/sysid/model.py``).

A model separates static configuration (attributes) from trained
parameters (``model.params``, a dict of tensors) and exposes one pure
batched step function ``pred_core(params, state (..., ds),
ctrl (..., dc)) -> state (..., ds)``; controllers close over
``(model.params, model.pred_core)``.
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
