"""Trajectory: (obs[T, n], ctrls[T, m]) tensors (port of
``autompc_tpu/core/trajectory.py``).

A :class:`TrajectoryBatch` holds a fixed-shape batch obs[B, T, n],
ctrls[B, T, m] with per-trajectory ``lengths``; the padded tail of a
shorter trajectory is masked, so every consumer works on whole tensors.
"""

from __future__ import annotations

from collections import namedtuple
from typing import List, Sequence

import numpy as np
import torch

from .system import System

TimeStep = namedtuple("TimeStep", "obs ctrl")


def _tensor(a, like=None):
    if isinstance(a, torch.Tensor):
        return a
    if like is not None:
        return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(a, dtype=float))


class Trajectory:
    """Discrete-time state/control trajectory backed by tensors."""

    def __init__(self, system: System, size: int, obs, ctrls):
        self._system = system
        self._size = int(size)
        obs = _tensor(obs)
        ctrls = _tensor(ctrls, like=obs)
        if obs.ndim != 2 or obs.shape[1] != system.obs_dim:
            raise ValueError("obs is wrong shape")
        if ctrls.ndim != 2 or ctrls.shape[1] != system.ctrl_dim:
            raise ValueError("ctrls is wrong shape")
        if obs.shape[0] != self._size or ctrls.shape[0] != self._size:
            raise ValueError("obs/ctrls length does not match size")
        self._obs = obs
        self._ctrls = ctrls

    @property
    def system(self) -> System:
        return self._system

    @property
    def size(self) -> int:
        return self._size

    def __len__(self):
        return self._size

    @property
    def obs(self):
        return self._obs

    @property
    def ctrls(self):
        return self._ctrls

    def __eq__(self, other):
        """Value equality: the same system and size, and equal
        observations and controls (compared on this trajectory's
        device). A class with ``__eq__`` and no ``__hash__`` is
        unhashable, as the JAX package's ``Trajectory`` is."""
        if not (isinstance(other, Trajectory) and self._system == other._system
                and self._size == other._size):
            return False
        dev = self._obs.device
        return (torch.equal(self._obs, other._obs.to(dev))
                and torch.equal(self._ctrls, other._ctrls.to(dev)))

    def __getitem__(self, idx):
        """``traj[i]`` -> TimeStep, ``traj[a:b]`` -> sub-Trajectory
        (label indexing is not ported yet)."""
        if isinstance(idx, slice):
            obs = self._obs[idx, :]
            return Trajectory(self._system, obs.shape[0], obs, self._ctrls[idx, :])
        if idx < -self._size or idx >= self._size:
            raise IndexError("Time index out of range.")
        return TimeStep(self._obs[idx, :], self._ctrls[idx, :])

    def set_obs(self, t, value) -> "Trajectory":
        """A copy with ``obs[t] = value``."""
        obs = self._obs.clone()
        obs[t] = _tensor(value, like=obs)
        return Trajectory(self._system, self._size, obs, self._ctrls)

    def __str__(self):
        return f"Trajectory, length={self._size}, system={self._system}"

    __repr__ = __str__


class TrajectoryBatch:
    """A fixed-shape batch of trajectories: obs[B, T, n], ctrls[B, T, m],
    lengths[B] (int32, on the same device)."""

    def __init__(self, system: System, obs, ctrls, lengths=None):
        self.system = system
        self.obs = _tensor(obs)
        self.ctrls = _tensor(ctrls, like=self.obs)
        if self.obs.ndim != 3 or self.ctrls.ndim != 3:
            raise ValueError("TrajectoryBatch arrays must be rank 3")
        if lengths is None:
            lengths = torch.full((self.obs.shape[0],), self.obs.shape[1])
        self.lengths = torch.as_tensor(
            lengths, dtype=torch.int32, device=self.obs.device
        )

    @property
    def num_trajs(self) -> int:
        return self.obs.shape[0]

    @property
    def max_len(self) -> int:
        return self.obs.shape[1]

    def mask(self):
        """(B, T) validity mask."""
        t = torch.arange(self.max_len, device=self.obs.device)[None, :]
        return t < self.lengths[:, None]

    def step_mask(self):
        """(B, T) mask of valid *transitions* (t -> t+1)."""
        t = torch.arange(self.max_len, device=self.obs.device)[None, :]
        return t < (self.lengths[:, None] - 1)

    def __getitem__(self, i) -> Trajectory:
        length = int(self.lengths[i])
        return Trajectory(
            self.system, length, self.obs[i, :length], self.ctrls[i, :length]
        )

    def to_list(self) -> List[Trajectory]:
        return [self[i] for i in range(self.num_trajs)]

    @staticmethod
    def from_trajs(trajs: Sequence[Trajectory], max_len=None) -> "TrajectoryBatch":
        if len(trajs) == 0:
            raise ValueError("Empty trajectory list")
        system = trajs[0].system
        lengths = [t.size for t in trajs]
        T = int(max_len) if max_len is not None else max(lengths)
        like = trajs[0].obs
        obs = like.new_zeros((len(trajs), T, system.obs_dim))
        ctrls = like.new_zeros((len(trajs), T, system.ctrl_dim))
        for i, tr in enumerate(trajs):
            L = min(tr.size, T)
            obs[i, :L] = tr.obs[:L]
            ctrls[i, :L] = tr.ctrls[:L]
            if L < T:
                # Pad with the last valid step so padded transitions are
                # fixed points — harmless under the mask, safe without it.
                obs[i, L:] = obs[i, L - 1]
                ctrls[i, L:] = ctrls[i, L - 1]
        return TrajectoryBatch(
            system, obs, ctrls, [min(n, T) for n in lengths]
        )


def zeros(system: System, size: int, dtype=None, device=None) -> Trajectory:
    """An all-zero trajectory of ``size`` steps, on the card unless
    ``device`` names one (``resolve_device``), in that device's
    ``default_dtype`` unless ``dtype`` names one."""
    from .. import default_dtype, resolve_device

    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    return Trajectory(
        system, size,
        torch.zeros((size, system.obs_dim), dtype=dtype, device=device),
        torch.zeros((size, system.ctrl_dim), dtype=dtype, device=device),
    )


def from_arrays(system: System, obs, ctrls) -> Trajectory:
    """A trajectory of obs (T, n) and ctrls (T, m); tensors keep their
    device and dtype, arrays become float64 CPU tensors (as
    ``Trajectory`` takes them)."""
    obs = _tensor(obs)
    return Trajectory(system, obs.shape[0], obs, ctrls)


def batch(trajs, max_len=None) -> TrajectoryBatch:
    """Stack a list of trajectories into a TrajectoryBatch (a batch
    passes through)."""
    if isinstance(trajs, TrajectoryBatch):
        return trajs
    return TrajectoryBatch.from_trajs(list(trajs), max_len=max_len)
