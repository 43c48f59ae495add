"""Quadratic-cost factory (port of
``autompc_tpu/costs/quad_cost_factory.py``): one log-scale diagonal gain
hyperparameter per observation dimension for Q and F, and per control
dimension for R."""

from __future__ import annotations

import numpy as np

from ..config import ConfigurationSpace, UniformFloatHyperparameter
from .cost_factory import CostFactory
from .quad_cost import QuadCost


class QuadCostFactory(CostFactory):
    r"""Factory producing :math:`x_N^T F x_N + \sum_t (x_t^T Q x_t
    + u_t^T R u_t)` with diagonal, log-scale-tuned gains in
    :math:`[10^{-3}, 10^4]`. A NaN entry of ``goal`` leaves that
    observation out of the space (its gains stay 0)."""

    def __init__(self, system, goal=None):
        super().__init__(system)
        self.goal = None if goal is None else np.array(goal, dtype=float)

    def _tuned(self, i):
        return self.goal is None or not np.isnan(self.goal[i])

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        for suffix in ("Q", "F"):
            for i, obsname in enumerate(self.system.observations):
                if self._tuned(i):
                    cs.add_hyperparameter(UniformFloatHyperparameter(
                        f"{obsname}_{suffix}", lower=1e-3, upper=1e4, default_value=1.0,
                        log=True))
        for ctrlname in self.system.controls:
            cs.add_hyperparameter(UniformFloatHyperparameter(
                f"{ctrlname}_R", lower=1e-3, upper=1e4, default_value=1.0, log=True))
        return cs

    def is_compatible(self, system, task, Model):
        return task.get_cost().has_goal

    def __call__(self, cfg, task, trajs):
        if self.goal is None and task.get_cost() is not None and task.get_cost().has_goal:
            goal = task.get_cost().get_goal()
        elif self.goal is not None:
            goal = self.goal
        else:
            raise ValueError("QuadCostFactory requires goal")

        n, m = self.system.obs_dim, self.system.ctrl_dim
        Q, F, R = np.zeros((n, n)), np.zeros((n, n)), np.zeros((m, m))
        for i, obsname in enumerate(self.system.observations):
            Q[i, i] = cfg[f"{obsname}_Q"] if f"{obsname}_Q" in cfg else 0.0
            F[i, i] = cfg[f"{obsname}_F"] if f"{obsname}_F" in cfg else 0.0
        for i, ctrlname in enumerate(self.system.controls):
            R[i, i] = cfg[f"{ctrlname}_R"] if f"{ctrlname}_R" in cfg else 0.0
        goal = np.nan_to_num(np.asarray(goal, dtype=float), nan=0.0)
        return QuadCost(self.system, Q, R, F, goal=goal)
