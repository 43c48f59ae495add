"""Sum of cost factories (port of
``autompc_tpu/costs/sum_cost_factory.py``): the factories' spaces side
by side under the prefixes ``_sum_i:``."""

from __future__ import annotations

from ..config import (
    ConfigurationSpace,
    add_configuration_space,
    set_subspace_configuration,
)
from .cost_factory import CostFactory
from .sum_cost import SumCost


class SumCostFactory(CostFactory):
    """A factory producing sums of other cost terms; created by combining
    cost factories with ``+``."""

    def __init__(self, system, factories):
        super().__init__(system)
        self._factories = list(factories)

    @property
    def factories(self):
        return self._factories[:]

    def get_configuration_space(self, *args, **kwargs):
        cs = ConfigurationSpace()
        for i, factory in enumerate(self._factories):
            add_configuration_space(cs, f"_sum_{i}",
                                    factory.get_configuration_space(*args, **kwargs))
        return cs

    def is_compatible(self, *args, **kwargs):
        return all(f.is_compatible(*args, **kwargs) for f in self._factories)

    def __call__(self, cfg, task, trajs):
        costs = []
        for i, factory in enumerate(self._factories):
            fact_cfg = factory.get_configuration_space().get_default_configuration()
            set_subspace_configuration(cfg, f"_sum_{i}", fact_cfg)
            costs.append(factory(fact_cfg, task, trajs))
        return sum(costs, SumCost(self.system, []))

    def __add__(self, other):
        if isinstance(other, SumCostFactory):
            return SumCostFactory(self.system, [*self._factories, *other.factories])
        return SumCostFactory(self.system, [*self._factories, other])

    def __radd__(self, other):
        if isinstance(other, SumCostFactory):
            return SumCostFactory(self.system, [*other.factories, *self._factories])
        return SumCostFactory(self.system, [other, *self._factories])
