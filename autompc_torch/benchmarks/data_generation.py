"""Excitation-signal trajectory generators (port of
``autompc_tpu/benchmarks/data_generation.py``).

Only the uniform-random signal is ported so far; the PRBS, random-walk,
periodic and multisine signals are queued in ROADMAP.md. Randomness is a
``torch.Generator`` on the target device, so the numbers differ from the
JAX package's ``jax.random`` draws: parity tests feed both packages the
same arrays through :func:`rollout_batch`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_dtype
from ..core.trajectory import TrajectoryBatch


def rollout_batch(system, dynamics, y0s, Us) -> TrajectoryBatch:
    """Roll B trajectories of length T through ``dynamics``: y0s (B, n),
    Us (B, T, m). obs[:, t] is the state *before* applying ctrls[:, t]."""
    T = Us.shape[1]
    obs = y0s.new_empty((y0s.shape[0], T, y0s.shape[1]))
    y = y0s
    for t in range(T):
        obs[:, t] = y
        y = dynamics(y, Us[:, t])
    return TrajectoryBatch(system, obs, Us)


def _finite_ctrl_bounds(task):
    b = task.get_ctrl_bounds()
    umin = np.where(np.isfinite(b[:, 0]), b[:, 0], -1.0)
    umax = np.where(np.isfinite(b[:, 1]), b[:, 1], 1.0)
    return umin, umax


def uniform_random_generate_batch(
    system, task, dynamics, rng, init_min, init_max, traj_len, n_trajs
) -> TrajectoryBatch:
    """i.i.d. uniform controls within the task's control bounds, uniform
    initial states in [init_min, init_max]. ``rng`` is a
    ``torch.Generator``; the data lands on its device."""
    device = rng.device
    dtype = default_dtype(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    lo, hi = t(init_min), t(init_max)
    y0s = lo + torch.rand(
        (n_trajs, lo.shape[0]), generator=rng, device=device, dtype=dtype
    ) * (hi - lo)
    umin, umax = (t(b) for b in _finite_ctrl_bounds(task))
    u = torch.rand(
        (n_trajs, traj_len, system.ctrl_dim), generator=rng, device=device,
        dtype=dtype,
    )
    return rollout_batch(system, dynamics, y0s, umin + u * (umax - umin))
