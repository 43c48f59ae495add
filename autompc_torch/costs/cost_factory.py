"""CostFactory ABC (port of ``autompc_tpu/costs/cost_factory.py``);
``a + b`` makes a ``SumCostFactory``."""

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

    def __add__(self, other):
        from .sum_cost_factory import SumCostFactory

        if isinstance(other, SumCostFactory):
            return other.__radd__(self)
        return SumCostFactory(self.system, [self, other])
