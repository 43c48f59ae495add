"""Quadratic cost (port of ``autompc_tpu/costs/quad_cost.py``)."""

from __future__ import annotations

import numpy as np
import torch

from .cost import Cost


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(device="cpu", dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


class QuadCost(Cost):
    r"""Cost :math:`(x-g)^T Q (x-g) + u^T R u` per step plus terminal
    :math:`(x_N-g)^T F (x_N-g)`. The matrices are kept as float64 CPU
    tensors and moved to the evaluated tensor's device and dtype."""

    def __init__(self, system, Q, R, F=None, goal=None):
        super().__init__(system)
        Q, R = _f64(Q), _f64(R)
        n, m = system.obs_dim, system.ctrl_dim
        if Q.shape != (n, n):
            raise ValueError("Q is the wrong shape")
        if R.shape != (m, m):
            raise ValueError("R is the wrong shape")
        if F is None:
            F = torch.zeros((n, n), dtype=torch.float64)
        else:
            F = _f64(F)
            if F.shape != (n, n):
                raise ValueError("F is the wrong shape")
        goal = torch.zeros(n, dtype=torch.float64) if goal is None else _f64(goal)

        self._Q = Q
        self._R = R
        self._F = F
        self._goal = goal

        self._is_quad = True
        self._is_convex = True
        self._is_diff = True
        self._is_twice_diff = True
        self._has_goal = True
