"""Stand-in models (port of ``autompc_tpu/sysid/dummy.py``:
``FunctionModel``; ``DummyLinear``, ``DummyNonlinear`` and
``LinearizedModel`` are not ported yet)."""

from __future__ import annotations

from .model import Model


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
