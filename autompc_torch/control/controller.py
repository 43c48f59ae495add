"""Controller layer (port of ``autompc_tpu/control/controller.py``).

A controller exposes a step function ``step(cstate, obs) -> (ctrl,
cstate)`` over a dict of tensors, the controller state; a closed loop
(``utils/simulation.py::simulate``) calls it once a time step from a
host loop.
"""

from __future__ import annotations

from abc import ABC, abstractmethod


class ControllerFactory(ABC):
    """Creates a controller from a hyperparameter configuration. The
    factory's own keyword arguments override the configuration's values
    (``IterativeLQRFactory(system, horizon=20)`` pins the horizon)."""

    def __init__(self, system, **kwargs):
        self.system = system
        self.kwargs = kwargs

    def __call__(self, cfg, task, model):
        controller_kwargs = (
            cfg.get_dictionary() if hasattr(cfg, "get_dictionary") else dict(cfg)
        )
        controller_kwargs.update(self.kwargs)
        return self.Controller(self.system, task, model, **controller_kwargs)

    def get_configuration_space(self):
        raise NotImplementedError


class Controller(ABC):
    def __init__(self, system, task, model):
        self.system = system
        self.task = task
        self.model = model

    @abstractmethod
    def step(self, cstate, new_obs):
        """(controller state, obs (n,)) -> (ctrl (m,), new controller
        state)."""
        raise NotImplementedError

    @abstractmethod
    def traj_to_state(self, traj):
        """Initial controller state from a trajectory history."""
        raise NotImplementedError

    def run(self, cstate, new_obs):
        """One controller step: a plain call of ``step`` (the JAX
        package's jitted step)."""
        return self.step(cstate, new_obs)

    def reset(self):
        """Warm-start caches live in the controller state, so reset is a
        no-op kept for API parity."""

    @property
    @abstractmethod
    def state_dim(self):
        raise NotImplementedError

    @staticmethod
    def is_compatible(system, task, model):
        return True
