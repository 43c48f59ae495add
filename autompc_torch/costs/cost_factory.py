"""CostFactory ABC (port of ``autompc_tpu/costs/cost_factory.py``).

The cost-factory algebra (``+``, ``SumCostFactory``) is not ported
yet."""

from __future__ import annotations

from abc import ABC, abstractmethod


class CostFactory(ABC):
    """Constructs Cost objects from hyperparameter configurations."""

    def __init__(self, system):
        self.system = system

    @abstractmethod
    def get_configuration_space(self):
        raise NotImplementedError

    @abstractmethod
    def __call__(self, cfg, task, trajs):
        """Build a Cost from configuration ``cfg`` for ``task``; ``trajs``
        is the training set (used only by data-driven factories, may be
        None)."""
        raise NotImplementedError
