"""Zero controller for debugging (port of
``autompc_tpu/control/zero.py``)."""

from __future__ import annotations

from ..config import ConfigurationSpace
from ..sysid.model import model_device
from .controller import Controller, ControllerFactory


class ZeroControllerFactory(ControllerFactory):
    """Outputs all-zero controls. Hyperparameters: none."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Controller = ZeroController
        self.name = "ZeroController"

    def get_configuration_space(self):
        return ConfigurationSpace()


class ZeroController(Controller):
    @property
    def device(self):
        """The device of the model's parameters (where ``simulate`` runs)."""
        return None if self.model is None else model_device(self.model)

    @property
    def state_dim(self):
        return 0

    @staticmethod
    def is_compatible(system, task, model):
        return True

    def traj_to_state(self, traj):
        return traj.obs.new_zeros(0)

    def step(self, cstate, new_obs):
        return new_obs.new_zeros(self.system.ctrl_dim), cstate
