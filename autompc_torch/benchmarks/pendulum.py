"""Pendulum swing-up benchmark (port of
``autompc_tpu/benchmarks/pendulum.py``: ``pendulum_dynamics`` and
``PendulumSwingupBenchmark``, the companion task of BASELINE.json
configs[2]).

Euler-discretized damped pendulum, theta = 0 upright, batched over every
leading axis of the state tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.system import System
from ..core.task import Task
from ..costs import ThresholdCost
from . import data_generation as dg
from .benchmark import Benchmark, check_data_gen_method


def pendulum_dynamics(y, u, dt=0.05, g=9.8, m=1.0, L=1.0, b=0.1):
    """One Euler step: ``y`` (..., 2) = (theta, omega), ``u`` (..., 1)
    (or (...), one torque a state)."""
    theta, omega = y[..., 0], y[..., 1]
    u0 = u[..., 0] if u.ndim == y.ndim else u
    omega_dot = g * torch.sin(theta) / L - b * omega / (m * L * L) + u0 / (m * L * L)
    return torch.stack([theta + dt * omega, omega + dt * omega_dot], dim=-1)


class PendulumSwingupBenchmark(Benchmark):
    """Swing the pendulum from down (theta = pi) to upright: a threshold
    metric (a step counts where theta or omega is more than 0.2 from 0),
    torque bounds +-2, 200 steps."""

    def __init__(self, data_gen_method="uniform_random"):
        check_data_gen_method(data_gen_method, self.data_gen_methods())
        system = System(["theta", "omega"], ["u"], dt=0.05)
        cost = ThresholdCost(system, goal=np.zeros(2), threshold=0.2, obs_range=(0, 2))
        task = Task(system)
        task.set_cost(cost)
        task.set_ctrl_bound("u", -2.0, 2.0)
        task.set_init_obs(np.array([np.pi, 0.0]))
        task.set_num_steps(200)
        super().__init__("pendulum_swingup", system, task, data_gen_method)

    def dynamics(self, x, u):
        return pendulum_dynamics(x, u, dt=self.system.dt)

    def _gen_trajs(self, n_trajs, traj_len, rng, draws=None):
        """The training set by the benchmark's data-generation method;
        ``draws`` replaces the generator's random draws (see
        ``data_generation``)."""
        common = dict(
            system=self.system, task=self.task, dynamics=self.dynamics, rng=rng,
            init_min=np.array([-np.pi, -1.0]), init_max=np.array([np.pi, 1.0]),
            traj_len=traj_len, n_trajs=n_trajs, draws=draws,
        )
        method = self._data_gen_method
        if method == "uniform_random":
            return dg.uniform_random_generate_batch(**common)
        if method == "multisine":
            return dg.multisine_generate_batch(n_freqs=20, **common)
        if method == "random_walk":
            return dg.random_walk_generate_batch(walk_rate=1.0, **common)
        raise ValueError(f"Unknown data_gen_method {method!r}")

    def gen_trajs_batch(self, seed, n_trajs, traj_len=200, device=None):
        """``n_trajs`` trajectories of ``traj_len`` steps on ``device``
        (None: the card), drawn from a ``torch.Generator`` seeded
        ``seed``."""
        rng = torch.Generator(device=resolve_device(device)).manual_seed(int(seed))
        return self._gen_trajs(n_trajs, traj_len, rng)

    @staticmethod
    def data_gen_methods():
        return ["uniform_random", "multisine", "random_walk"]
