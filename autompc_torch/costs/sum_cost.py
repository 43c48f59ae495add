"""Sum-of-costs algebra (port of ``autompc_tpu/costs/sum_cost.py``)."""

from __future__ import annotations

import numpy as np

from .cost import Cost


class SumCost(Cost):
    """A cost which is the sum of other cost terms; created by combining
    Cost objects with ``+``. Every ``eval_*`` sums its children's (the
    quadratic children's closed forms, no autodiff); the flags are the
    conjunction of the children's."""

    def __init__(self, system, costs):
        super().__init__(system)
        self._costs = list(costs)

    @property
    def costs(self):
        return self._costs[:]

    def get_cost_matrices(self):
        """(Q, R, F): the children's matrices summed; raises unless every
        child is quadratic with one goal."""
        if self.is_quad:
            n, m = self.system.obs_dim, self.system.ctrl_dim
            Q, R, F = np.zeros((n, n)), np.zeros((m, m)), np.zeros((n, n))
            for cost in self._costs:
                Q_, R_, F_ = cost.get_cost_matrices()
                Q += Q_
                R += R_
                F += F_
            return Q, R, F
        raise NotImplementedError

    def get_goal(self):
        """The first child's goal, where every child has that goal."""
        if self.has_goal:
            return self._costs[0].get_goal()
        raise ValueError("Cost does not have goal")

    def _sum(self, attr, arg):
        results = [getattr(c, attr)(arg) for c in self._costs]
        if isinstance(results[0], tuple):
            return tuple(sum(vals) for vals in zip(*results))
        return sum(results)

    def eval_obs_cost(self, obs):
        return self._sum("eval_obs_cost", obs)

    def eval_obs_cost_diff(self, obs):
        return self._sum("eval_obs_cost_diff", obs)

    def eval_obs_cost_hess(self, obs):
        return self._sum("eval_obs_cost_hess", obs)

    def eval_ctrl_cost(self, ctrl):
        return self._sum("eval_ctrl_cost", ctrl)

    def eval_ctrl_cost_diff(self, ctrl):
        return self._sum("eval_ctrl_cost_diff", ctrl)

    def eval_ctrl_cost_hess(self, ctrl):
        return self._sum("eval_ctrl_cost_hess", ctrl)

    def eval_term_obs_cost(self, obs):
        return self._sum("eval_term_obs_cost", obs)

    def eval_term_obs_cost_diff(self, obs):
        return self._sum("eval_term_obs_cost_diff", obs)

    def eval_term_obs_cost_hess(self, obs):
        return self._sum("eval_term_obs_cost_hess", obs)

    def _same_goal(self, flag):
        """Every child has ``flag`` and the first child's goal."""
        if not self._costs or not getattr(self._costs[0], flag):
            return False
        goal = self._costs[0].get_goal()
        return all(getattr(c, flag) and np.array_equal(goal, c.get_goal())
                   for c in self._costs[1:])

    @property
    def is_quad(self):
        return self._same_goal("is_quad")

    @property
    def is_convex(self):
        return all(c.is_convex for c in self._costs)

    @property
    def is_diff(self):
        return all(c.is_diff for c in self._costs)

    @property
    def is_twice_diff(self):
        return all(c.is_twice_diff for c in self._costs)

    @property
    def has_goal(self):
        return self._same_goal("has_goal")

    def __add__(self, other):
        if isinstance(other, SumCost):
            return SumCost(self.system, [*self._costs, *other.costs])
        return SumCost(self.system, [*self._costs, other])

    def __radd__(self, other):
        if isinstance(other, SumCost):
            return SumCost(self.system, [*other.costs, *self._costs])
        return SumCost(self.system, [other, *self._costs])
