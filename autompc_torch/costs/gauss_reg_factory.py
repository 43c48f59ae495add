r"""Gaussian-regularization cost factory (port of
``autompc_tpu/costs/gauss_reg_factory.py``): a quadratic cost with
:math:`Q = w \Sigma_x^{-1}` and goal :math:`\mu_x`, the statistics of the
training observations."""

from __future__ import annotations

import numpy as np

from ..config import ConfigurationSpace, UniformFloatHyperparameter
from ..core.trajectory import batch as traj_batch
from .cost_factory import CostFactory
from .quad_cost import QuadCost


def gauss_reg_stats(trajs):
    r"""(:math:`\Sigma_x^{-1}`, :math:`\mu_x`) as float64 host arrays: the
    inverse covariance and the mean of every valid observation of
    ``trajs``."""
    tb = traj_batch(trajs)
    X = tb.obs[tb.mask()].detach().cpu().numpy().astype(np.float64)
    cov = np.atleast_2d(np.cov(X, rowvar=False))
    return np.linalg.inv(cov), np.mean(X, axis=0)


class GaussRegFactory(CostFactory):
    """Encourages the controller to stay close to the training-data
    distribution; typically summed with another cost. One
    hyperparameter, ``reg_weight`` (log-uniform in [1e-3, 1e4], default
    1)."""

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        cs.add_hyperparameter(UniformFloatHyperparameter(
            "reg_weight", lower=1e-3, upper=1e4, default_value=1.0, log=True))
        return cs

    def is_compatible(self, system, task, Model):
        return True

    def __call__(self, cfg, task, trajs):
        S, mean = gauss_reg_stats(trajs)
        n, m = self.system.obs_dim, self.system.ctrl_dim
        return QuadCost(self.system, cfg["reg_weight"] * S, np.zeros((m, m)), np.zeros((n, n)),
                        goal=mean)
