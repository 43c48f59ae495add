"""Cost layer (port of ``autompc_tpu/costs/cost.py``).

Every ``eval_*`` method takes a tensor whose LAST axis is the
observation (or control) and evaluates all leading axes at once;
``__call__(traj)`` is the task metric of a whole trajectory. Quadratic
costs keep their closed forms; any other cost that sets ``is_diff`` /
``is_twice_diff`` gets its gradient and hessian by ``torch.func``
autodiff of its ``eval_*_cost``, point by point over the leading axes.
``a + b`` makes a ``SumCost`` (``costs/sum_cost.py``).

Divergence from the original AutoMPC, kept from the JAX package on
purpose (DESIGN.md §7): the terminal derivatives use ``obs - goal``
exactly like the stage costs (the Riccati kernel's terminal expansion
``vn = 2 F (x_H - g)`` is the same rule).
"""

from __future__ import annotations


def _quad(d, M):
    """``d' M d`` over the last axis of ``d``."""
    return ((d @ M) * d).sum(-1)


def _points(fn, transform, x):
    """``transform(fn)`` (``torch.func.grad`` or ``hessian`` of a
    one-point cost) at every point of ``x``'s leading axes."""
    from torch.func import vmap

    flat = x.reshape(-1, x.shape[-1])
    out = vmap(transform(fn))(flat)
    return out.reshape(x.shape[:-1] + out.shape[1:])


def _diff(fn, x):
    from torch.func import grad

    return fn(x), _points(fn, grad, x)


def _hess(fn, x):
    from torch.func import grad, hessian

    return fn(x), _points(fn, grad, x), _points(fn, hessian, x)


class Cost:
    """Base class for cost functions."""

    def __init__(self, system):
        self.system = system
        self._is_quad = False
        self._is_convex = False
        self._is_diff = False
        self._is_twice_diff = False
        self._has_goal = False
        self._Q = None
        self._R = None
        self._F = None
        self._goal = None
        self._on = {}

    def _mat(self, M, like):
        """``M`` on ``like``'s device and dtype, copied there once: a
        host-to-device copy each call would wait for the card's queue."""
        key = (id(M), like.device, like.dtype)
        if key not in self._on:
            self._on[key] = M.to(device=like.device, dtype=like.dtype)
        return self._on[key]

    def __getstate__(self):
        # A copy (Task.copy) starts with an empty device cache.
        return dict(self.__dict__, _on={})

    def __call__(self, traj):
        """The trajectory's cost: every step's observation and control
        cost plus the terminal cost at the last observation."""
        obs, ctrls = traj.obs, traj.ctrls
        return (self.eval_obs_cost(obs).sum() + self.eval_ctrl_cost(ctrls).sum()
                + self.eval_term_obs_cost(obs[-1]))

    def eval_obs_cost(self, obs):
        if self.is_quad:
            return _quad(obs - self._mat(self._goal, obs), self._mat(self._Q, obs))
        raise NotImplementedError

    def eval_obs_cost_diff(self, obs):
        """(value, gradient) of the stage observation cost."""
        if self.is_quad:
            d = obs - self._mat(self._goal, obs)
            Q = self._mat(self._Q, obs)
            return _quad(d, Q), d @ (Q + Q.T).T
        if self.is_diff:
            return _diff(self.eval_obs_cost, obs)
        raise NotImplementedError

    def eval_obs_cost_hess(self, obs):
        """(value, gradient, hessian) of the stage observation cost;
        the hessian of a quadratic cost is one (n, n) matrix for every
        leading axis, an autodiff one (..., n, n)."""
        if self.is_quad:
            d = obs - self._mat(self._goal, obs)
            Q = self._mat(self._Q, obs)
            return _quad(d, Q), d @ (Q + Q.T).T, Q + Q.T
        if self.is_twice_diff:
            return _hess(self.eval_obs_cost, obs)
        raise NotImplementedError

    def eval_ctrl_cost(self, ctrl):
        if self.is_quad:
            return _quad(ctrl, self._mat(self._R, ctrl))
        raise NotImplementedError

    def eval_ctrl_cost_diff(self, ctrl):
        """(value, gradient) of the stage control cost."""
        if self.is_quad:
            R = self._mat(self._R, ctrl)
            return _quad(ctrl, R), ctrl @ (R + R.T).T
        if self.is_diff:
            return _diff(self.eval_ctrl_cost, ctrl)
        raise NotImplementedError

    def eval_ctrl_cost_hess(self, ctrl):
        """(value, gradient, hessian) of the stage control cost."""
        if self.is_quad:
            R = self._mat(self._R, ctrl)
            return _quad(ctrl, R), ctrl @ (R + R.T).T, R + R.T
        if self.is_twice_diff:
            return _hess(self.eval_ctrl_cost, ctrl)
        raise NotImplementedError

    def eval_term_obs_cost(self, obs):
        if self.is_quad:
            return _quad(obs - self._mat(self._goal, obs), self._mat(self._F, obs))
        raise NotImplementedError

    def eval_term_obs_cost_diff(self, obs):
        """(value, gradient) of the terminal cost, with the goal offset in
        the gradient."""
        if self.is_quad:
            d = obs - self._mat(self._goal, obs)
            F = self._mat(self._F, obs)
            return _quad(d, F), d @ (F + F.T).T
        if self.is_diff:
            return _diff(self.eval_term_obs_cost, obs)
        raise NotImplementedError

    def eval_term_obs_cost_hess(self, obs):
        """(value, gradient, hessian) of the terminal cost, with the goal
        offset in the gradient."""
        if self.is_quad:
            d = obs - self._mat(self._goal, obs)
            F = self._mat(self._F, obs)
            return _quad(d, F), d @ (F + F.T).T, F + F.T
        if self.is_twice_diff:
            return _hess(self.eval_term_obs_cost, obs)
        raise NotImplementedError

    def get_cost_matrices(self):
        """(Q, R, F) as host arrays; raises when the cost is not
        quadratic."""
        if self.is_quad:
            return tuple(M.detach().cpu().numpy().copy() for M in (self._Q, self._R, self._F))
        raise ValueError("Cost is not quadratic.")

    def get_goal(self):
        """The goal as a host array; raises when the cost has none."""
        if self.has_goal:
            return self._goal.detach().cpu().numpy().copy()
        raise ValueError("Cost does not have goal")

    @property
    def is_quad(self):
        return self._is_quad

    @property
    def is_convex(self):
        return self._is_convex

    @property
    def is_diff(self):
        return self._is_diff

    @property
    def is_twice_diff(self):
        return self._is_twice_diff

    @property
    def has_goal(self):
        return self._has_goal

    def __add__(self, other):
        from .sum_cost import SumCost

        if isinstance(other, SumCost):
            return other.__radd__(self)
        return SumCost(self.system, [self, other])

    def stage_fns(self):
        """(obs_cost_fn, ctrl_cost_fn, term_cost_fn): the three stage
        evaluations as plain functions."""
        return self.eval_obs_cost, self.eval_ctrl_cost, self.eval_term_obs_cost
