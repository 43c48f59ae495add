"""Threshold costs (port of ``autompc_tpu/costs/thresh_cost.py``:
``ThresholdCost`` and ``BoxThresholdCost``)."""

from __future__ import annotations

import numpy as np
import torch

from .cost import Cost


class ThresholdCost(Cost):
    r"""Returns 1 for every time step where
    :math:`\|x - x_\mathrm{goal}\|_\infty > \mathrm{threshold}`, checked
    only over observation dimensions ``obs_range[0]:obs_range[1]``."""

    def __init__(self, system, goal, obs_range, threshold):
        super().__init__(system)
        self._goal = torch.as_tensor(np.asarray(goal, dtype=np.float64))
        self._threshold = float(np.asarray(threshold))
        self._obs_range = (int(obs_range[0]), int(obs_range[1]))
        self._has_goal = True

    def eval_obs_cost(self, obs):
        lo, hi = self._obs_range
        goal = self._mat(self._goal, obs)
        err = (obs[..., lo:hi] - goal[lo:hi]).abs().amax(-1)
        return (err > self._threshold).to(obs.dtype)

    def eval_ctrl_cost(self, ctrl):
        return ctrl.new_zeros(ctrl.shape[:-1])

    def eval_term_obs_cost(self, obs):
        return obs.new_zeros(obs.shape[:-1])


class BoxThresholdCost(Cost):
    """Returns 1 for every time step where the observation falls outside
    per-dimension ``limits`` (shape (obs_dim, 2); +/-inf leaves a
    dimension unbounded)."""

    def __init__(self, system, limits, goal=None):
        super().__init__(system)
        self._limits = torch.as_tensor(np.asarray(limits, dtype=np.float64))
        if goal is not None:
            self._goal = torch.as_tensor(np.asarray(goal, dtype=np.float64))
            self._has_goal = True

    def eval_obs_cost(self, obs):
        lim = self._mat(self._limits, obs)
        out = ((obs < lim[:, 0]) | (obs > lim[:, 1])).any(-1)
        return out.to(obs.dtype)

    def eval_ctrl_cost(self, ctrl):
        return ctrl.new_zeros(ctrl.shape[:-1])

    def eval_term_obs_cost(self, obs):
        return obs.new_zeros(obs.shape[:-1])
