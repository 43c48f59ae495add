"""LQR controllers (port of ``autompc_tpu/control/lqr.py``).

The gain is computed once, when the controller is built, from the linear
model's (A, B) (``Model.to_linear``) and the task's quadratic cost
embedded into the model state (``ops/riccati.py``); each step is then
``u = clip(K (x - x_goal))`` on the model state updated with the new
observation. The controller state is ``[model_state, last_ctrl]``.

The Riccati design runs in float64 on the model's device whatever the
model's dtype, and the gain is cast to that dtype. It is a set-up
computation of a few hundred small products, but the infinite-horizon
iteration can run its full 10,000 steps: an ARX model's constant slot
(and any integrator it fits) has eigenvalue 1, so P grows in that
direction and never meets the stopping test, and float32 rounding
accumulates along it (on an H100, 1.7e-4 relative in the gain of
ARXFactory's default model on the cartpole data, against 9e-6 for the
11-step finite horizon; PERF.md §6). On the CPU (float64 models)
nothing changes.

``InfiniteHorizonLQR`` is the JAX package's working Riccati fixed-point
iteration (the reference's calls an undefined ``dare``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (
    CategoricalHyperparameter,
    ConfigurationSpace,
    InCondition,
    UniformIntegerHyperparameter,
)
from ..ops.riccati import finite_horizon_lqr, infinite_horizon_lqr
from ..sysid.model import model_device
from .controller import Controller, ControllerFactory


def _design(model):
    """The model's (A, B) in float64 on its device, for the Riccati
    design."""
    A, B = model.to_linear()
    return A.double(), B.double()


def _embed_cost_matrices(model, task, like):
    """The observation-space Q and F padded with zeros to the model
    state's dimension, and R, on ``like``'s device and dtype."""
    Q, R, F = task.get_cost().get_cost_matrices()
    ds = model.state_dim
    Qp = np.zeros((ds, ds))
    Qp[: Q.shape[0], : Q.shape[1]] = Q
    Fp = np.zeros((ds, ds))
    Fp[: F.shape[0], : F.shape[1]] = F
    return like.new_tensor(Qp), like.new_tensor(R), like.new_tensor(Fp)


def _embed_goal(model, task, like):
    goal = task.get_cost().get_goal()
    state0 = np.zeros(model.state_dim)
    state0[: goal.size] = goal
    return like.new_tensor(state0)


class _LQRBase(Controller):
    """The shared step: the controller state is ``cat([model_state,
    last_ctrl])``. Runs on the device of the model's (A, B)."""

    def __init__(self, system, task, model):
        super().__init__(system, task, model)
        self.K = None  # set by the subclass
        self.device = model_device(model)
        A, _ = model.to_linear()
        self._state0 = _embed_goal(model, task, A)
        bounds = task.get_ctrl_bounds()
        self._umin = A.new_tensor(bounds[:, 0])
        self._umax = A.new_tensor(bounds[:, 1])
        self._model_params = model.params

    @property
    def state_dim(self):
        return self.model.state_dim + self.system.ctrl_dim

    def traj_to_state(self, traj):
        return torch.cat([self.model.traj_to_state(traj), traj[-1].ctrl.to(self._state0)])

    def step(self, cstate, new_obs):
        m = self.system.ctrl_dim
        modelstate = self.model.update_state_core(
            self._model_params, cstate[:-m], cstate[-m:], new_obs
        )
        u = self.K @ (modelstate - self._state0)
        u = torch.minimum(torch.maximum(u, self._umin), self._umax)
        return u, torch.cat([modelstate, u])


class FiniteHorizonLQR(_LQRBase):
    def __init__(self, system, task, model, horizon):
        super().__init__(system, task, model)
        A, B = _design(model)
        Qp, R, Fp = _embed_cost_matrices(model, task, A)
        N = A.new_zeros((A.shape[0], B.shape[1]))
        self.horizon = int(horizon)
        K, self._P = finite_horizon_lqr(A, B, Qp, R, N, Fp, self.horizon)
        self.K = K.to(self._state0.dtype)
        self.Qp, self.Rp = Qp, R

    @staticmethod
    def is_compatible(system, task, model):
        return (
            model.is_linear
            and task.get_cost().is_quad
            and not task.are_obs_bounded()
            and not task.eq_cons_present()
            and not task.ineq_cons_present()
        )


class InfiniteHorizonLQR(_LQRBase):
    def __init__(self, system, task, model):
        super().__init__(system, task, model)
        A, B = _design(model)
        Qp, R, _ = _embed_cost_matrices(model, task, A)
        K, self._P = infinite_horizon_lqr(A, B, Qp, R)
        self.K = K.to(self._state0.dtype)
        self.Qp, self.Rp = Qp, R

    @staticmethod
    def is_compatible(system, task, model):
        return (
            model.is_linear
            and task.get_cost().is_quad
            and not task.are_obs_bounded()
            and not task.are_ctrl_bounded()
            and not task.eq_cons_present()
            and not task.ineq_cons_present()
        )


class LQR(Controller):
    """Finite or infinite horizon, by ``finite_horizon``."""

    def __init__(self, system, task, model, finite_horizon, horizon=None):
        super().__init__(system, task, model)
        if not isinstance(finite_horizon, bool):
            finite_horizon = finite_horizon == "true"
        if finite_horizon:
            self._controller = FiniteHorizonLQR(system, task, model, horizon)
        else:
            self._controller = InfiniteHorizonLQR(system, task, model)
        self.device = self._controller.device

    @property
    def state_dim(self):
        return self._controller.state_dim

    @staticmethod
    def is_compatible(system, task, model):
        return (
            model.is_linear
            and task.get_cost().is_quad
            and not task.are_obs_bounded()
            and not task.eq_cons_present()
            and not task.ineq_cons_present()
        )

    def traj_to_state(self, traj):
        return self._controller.traj_to_state(traj)

    def step(self, cstate, new_obs):
        return self._controller.step(cstate, new_obs)


class LQRFactory(ControllerFactory):
    """Hyperparameters:

    - *finite_horizon* (categorical ["true", "false"], default "true")
    - *horizon* (int, 1..1000, default 10; conditioned on
      finite_horizon == "true")
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Controller = LQR
        self.name = "LQR"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        finite_horizon = CategoricalHyperparameter(
            "finite_horizon", choices=["true", "false"], default_value="true"
        )
        horizon = UniformIntegerHyperparameter(
            "horizon", lower=1, upper=1000, default_value=10
        )
        cs.add_hyperparameters([horizon, finite_horizon])
        cs.add_condition(InCondition("horizon", "finite_horizon", ["true"]))
        return cs
