"""Benchmark ABC (port of ``autompc_tpu/benchmarks/benchmark.py``)."""

from __future__ import annotations

from abc import ABC, abstractmethod


class Benchmark(ABC):
    """Bundles a system, task, ground-truth dynamics, and data generation.

    ``dynamics(x, u)`` is a batched tensor function: the last axis of
    ``x`` is the state and of ``u`` the control, every leading axis is
    a batch axis."""

    def __init__(self, name, system, task, data_gen_method):
        self.name = name
        self.system = system
        self.task = task
        self._data_gen_method = data_gen_method

    @abstractmethod
    def dynamics(self, x, u):
        """Ground-truth dynamics: (obs, ctrl) -> next obs."""
        raise NotImplementedError

    def gen_trajs(self, seed, n_trajs, traj_len=None, device=None):
        """The training set of ``gen_trajs_batch`` as a list of
        trajectories."""
        kw = {} if traj_len is None else {"traj_len": traj_len}
        return self.gen_trajs_batch(seed, n_trajs, device=device, **kw).to_list()

    @abstractmethod
    def gen_trajs_batch(self, seed, n_trajs, traj_len=None, device=None):
        """Generate a training set as a TrajectoryBatch on ``device``
        (None: the card)."""
        raise NotImplementedError

    @staticmethod
    @abstractmethod
    def data_gen_methods():
        """The names of the data-generation methods the benchmark takes."""
        raise NotImplementedError


def check_data_gen_method(method, methods):
    """Raise ``ValueError`` by name for a method the benchmark does not
    take."""
    if method not in methods:
        raise ValueError(f"Unknown data_gen_method {method!r}; this benchmark takes {methods}")
