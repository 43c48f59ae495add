"""Task: bounds, goal/initial observation, termination, and cost holder
(port of ``autompc_tpu/core/task.py``; pure numpy, same API).

Bounds and initial observations are host numpy arrays; controllers pull
them once at construction.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np

from .system import System


class Task:
    """Defines a control task to be solved."""

    def __init__(self, system: System):
        self.system = system
        self._obs_bounds = np.tile(
            np.array([-np.inf, np.inf]), (system.obs_dim, 1)
        )
        self._ctrl_bounds = np.tile(
            np.array([-np.inf, np.inf]), (system.ctrl_dim, 1)
        )
        self._init_obs = None
        self._term_cond: Optional[Callable] = None
        self._num_steps: Optional[int] = None
        self.cost = None

    # -- step limits / termination (task.py:42-100) --------------------
    def set_num_steps(self, num_steps: int):
        self._term_cond = lambda traj: len(traj) >= num_steps
        self._num_steps = int(num_steps)

    def has_num_steps(self) -> bool:
        return self._num_steps is not None

    def get_num_steps(self) -> Optional[int]:
        return self._num_steps

    def term_cond(self, traj) -> bool:
        if self._term_cond is not None:
            return self._term_cond(traj)
        return False

    def set_term_cond(self, term_cond: Callable):
        self._term_cond = term_cond

    # -- cost (task.py:103-125) ----------------------------------------
    def set_cost(self, cost):
        self.cost = cost

    def get_cost(self):
        return self.cost

    # -- initial observation (task.py:127-147) -------------------------
    def set_init_obs(self, init_obs):
        self._init_obs = np.array(init_obs, dtype=float)

    def get_init_obs(self):
        if self._init_obs is not None:
            return self._init_obs.copy()
        return None

    # -- bounds (task.py:150-267) --------------------------------------
    def set_obs_bound(self, obs_label: str, lower: float, upper: float):
        idx = self.system.obs_index(obs_label)
        self._obs_bounds[idx, :] = [lower, upper]

    def set_obs_bounds(self, lowers, uppers):
        self._obs_bounds[:, 0] = lowers
        self._obs_bounds[:, 1] = uppers

    def set_ctrl_bound(self, ctrl_label: str, lower: float, upper: float):
        idx = self.system.ctrl_index(ctrl_label)
        self._ctrl_bounds[idx, :] = [lower, upper]

    def set_ctrl_bounds(self, lowers, uppers):
        self._ctrl_bounds[:, 0] = lowers
        self._ctrl_bounds[:, 1] = uppers

    def are_obs_bounded(self) -> bool:
        return bool(np.any(np.isfinite(self._obs_bounds)))

    def are_ctrl_bounded(self) -> bool:
        return bool(np.any(np.isfinite(self._ctrl_bounds)))

    def get_obs_bounds(self) -> np.ndarray:
        return self._obs_bounds.copy()

    def get_ctrl_bounds(self) -> np.ndarray:
        return self._ctrl_bounds.copy()

    # -- constraint presence flags -------------------------------------
    # The reference initializes (but never populates) constraint lists
    # (task.py:32-38); controllers only query presence (lqr.py:123-128).
    def eq_cons_present(self) -> bool:
        return False

    def ineq_cons_present(self) -> bool:
        return False

    def copy(self) -> "Task":
        return copy.deepcopy(self)
