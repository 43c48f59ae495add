"""Cost layer (port of ``autompc_tpu/costs/cost.py``).

Every ``eval_*`` method takes a tensor whose LAST axis is the
observation (or control) and evaluates all leading axes at once.
Quadratic costs keep their closed forms; the autodiff fallbacks and the
cost algebra of the JAX package are not ported yet (the main path needs
the quadratic forms only).

Divergence from the original AutoMPC, kept from the JAX package on
purpose (DESIGN.md §7): the terminal derivatives use ``obs - goal``
exactly like the stage costs (the Riccati kernel's terminal expansion
``vn = 2 F (x_H - g)`` is the same rule).
"""

from __future__ import annotations


def _quad(d, M):
    """``d' M d`` over the last axis of ``d``."""
    return ((d @ M) * d).sum(-1)


class Cost:
    """Base class for cost functions."""

    def __init__(self, system):
        self.system = system
        self._is_quad = False
        self._has_goal = False
        self._Q = None
        self._R = None
        self._F = None
        self._goal = None

    def _mat(self, M, like):
        return M.to(device=like.device, dtype=like.dtype)

    def eval_obs_cost(self, obs):
        if self.is_quad:
            return _quad(obs - self._mat(self._goal, obs), self._mat(self._Q, obs))
        raise NotImplementedError

    def eval_obs_cost_hess(self, obs):
        """(value, gradient, hessian) of the stage observation cost;
        the hessian is one (n, n) matrix for every leading axis."""
        if self.is_quad:
            d = obs - self._mat(self._goal, obs)
            Q = self._mat(self._Q, obs)
            return _quad(d, Q), d @ (Q + Q.T).T, Q + Q.T
        raise NotImplementedError

    def eval_ctrl_cost(self, ctrl):
        if self.is_quad:
            return _quad(ctrl, self._mat(self._R, ctrl))
        raise NotImplementedError

    def eval_ctrl_cost_hess(self, ctrl):
        """(value, gradient, hessian) of the stage control cost."""
        if self.is_quad:
            R = self._mat(self._R, ctrl)
            return _quad(ctrl, R), ctrl @ (R + R.T).T, R + R.T
        raise NotImplementedError

    def eval_term_obs_cost(self, obs):
        if self.is_quad:
            return _quad(obs - self._mat(self._goal, obs), self._mat(self._F, obs))
        raise NotImplementedError

    def eval_term_obs_cost_hess(self, obs):
        """(value, gradient, hessian) of the terminal cost, with the goal
        offset in the gradient."""
        if self.is_quad:
            d = obs - self._mat(self._goal, obs)
            F = self._mat(self._F, obs)
            return _quad(d, F), d @ (F + F.T).T, F + F.T
        raise NotImplementedError

    def get_goal(self):
        """The goal as a host array; raises when the cost has none."""
        if self.has_goal:
            return self._goal.detach().cpu().numpy().copy()
        raise ValueError("Cost does not have goal")

    @property
    def is_quad(self):
        return self._is_quad

    @property
    def has_goal(self):
        return self._has_goal
