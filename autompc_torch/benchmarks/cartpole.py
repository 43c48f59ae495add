"""Cartpole swing-up benchmarks (port of
``autompc_tpu/benchmarks/cartpole.py``: ``CartpoleSwingupBenchmark`` and
``CartpoleSwingupV2Benchmark``).

Euler-step dynamics with the benchmark-level ``b=1.0`` damping (and V2's
``g=0.8``), batched over every leading axis of the state tensor.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..core.system import System
from ..core.task import Task
from ..costs import BoxThresholdCost, ThresholdCost
from . import data_generation as dg
from .benchmark import Benchmark, check_data_gen_method


def cartpole_simp_dynamics(y, u, g=9.8, m=1.0, L=1.0, b=0.1):
    """Continuous-time simplified cartpole; ``y`` (..., 4), ``u`` (...)."""
    theta, omega, dx = y[..., 0], y[..., 1], y[..., 3]
    return torch.stack(
        [
            omega,
            g * torch.sin(theta) / L
            - b * omega / (m * L * L)
            + u * torch.cos(theta) / L,
            dx,
            u,
        ],
        dim=-1,
    )


def dt_cartpole_dynamics(y, u, dt, g=9.8, m=1.0, L=1.0, b=1.0):
    """Euler discretization; ``u`` (..., 1)."""
    return y + dt * cartpole_simp_dynamics(y, u[..., 0], g, m, L, b)


class CartpoleSwingupBenchmark(Benchmark):
    """Swing the pole from down to up; the task metric counts steps with
    angle, angular velocity or cart position more than 0.2 from the
    goal."""

    def __init__(self, data_gen_method="uniform_random"):
        check_data_gen_method(data_gen_method, self.data_gen_methods())
        system = System(["theta", "omega", "x", "dx"], ["u"], dt=0.05)
        cost = ThresholdCost(
            system, goal=np.zeros(4), threshold=0.2, obs_range=(0, 3)
        )
        task = Task(system)
        task.set_cost(cost)
        task.set_ctrl_bound("u", -20.0, 20.0)
        task.set_init_obs(np.array([3.1, 0.0, 0.0, 0.0]))
        task.set_num_steps(200)
        super().__init__("cartpole_swingup", system, task, data_gen_method)

    def dynamics(self, x, u):
        return dt_cartpole_dynamics(x, u, self.system.dt, g=9.8, m=1, L=1, b=1.0)

    def _gen_trajs(self, n_trajs, traj_len, rng, draws=None):
        """The training set by the benchmark's data-generation method;
        ``draws`` replaces the generator's random draws (see
        ``data_generation``)."""
        common = dict(
            system=self.system, task=self.task, dynamics=self.dynamics, rng=rng,
            init_min=np.array([-1.0, 0.0, 0.0, 0.0]), init_max=np.array([1.0, 0.0, 0.0, 0.0]),
            traj_len=traj_len, n_trajs=n_trajs, draws=draws,
        )
        method = self._data_gen_method
        if method == "uniform_random":
            return dg.uniform_random_generate_batch(**common)
        if method == "periodic_control":
            return dg.periodic_control_generate_batch(U_1=np.ones(1), **common)
        if method == "multisine":
            return dg.multisine_generate_batch(n_freqs=20, **common)
        if method == "random_walk":
            return dg.random_walk_generate_batch(walk_rate=1.0, **common)
        if method == "prbs":
            return dg.prbs_generate_batch(states=np.array([-20.0, 20.0]), Nswitch=10, **common)
        raise ValueError(f"Unknown data_gen_method {method!r}")

    def gen_trajs_batch(self, seed, n_trajs, traj_len=200, device=None):
        rng = torch.Generator(device=resolve_device(device)).manual_seed(int(seed))
        return self._gen_trajs(n_trajs, traj_len, rng)

    @staticmethod
    def data_gen_methods():
        return ["uniform_random", "periodic_control", "multisine", "random_walk", "prbs"]


class CartpoleSwingupV2Benchmark(CartpoleSwingupBenchmark):
    """The main demo's benchmark: a box-threshold metric (pole angle and
    rate within 0.2, the cart within [-10, 10]) and the reference's
    ``g=0.8`` dynamics."""

    def __init__(self, data_gen_method="uniform_random"):
        super().__init__(data_gen_method)
        system = self.system
        limits = np.array([[-0.2, 0.2], [-0.2, 0.2], [-10.0, 10.0], [-np.inf, np.inf]])
        task = Task(system)
        task.set_cost(BoxThresholdCost(system, limits, goal=np.zeros(4)))
        task.set_ctrl_bound("u", -20.0, 20.0)
        task.set_init_obs(np.array([3.1, 0.0, 0.0, 0.0]))
        task.set_num_steps(200)
        self.task = task

    def dynamics(self, x, u):
        return dt_cartpole_dynamics(x, u, self.system.dt, g=0.8, m=1, L=1, b=1.0)

    def get_cached_tune_result(self):
        """The tune result shipped in ``assets/cached_tunes/`` (a plain
        pickle: ``cfg_dicts``, ``costs``, ``inc_cfg``, ``inc_costs``,
        ``kind``)."""
        from ..utils.checkpoint import load_checkpoint

        return load_checkpoint(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "..", "..", "assets", "cached_tunes",
            "cartpole_tune_result.ckpt"))
