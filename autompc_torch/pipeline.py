"""Pipeline: joint configuration over {model, cost, controller} (port of
``autompc_tpu/pipeline.py``).

Each component is passed instantiated (fixed) or as a factory, whose
hyperparameters join the pipeline's configuration space under the
prefixes ``_model:`` / ``_cost:`` / ``_ctrlr:``; instantiation order is
model -> cost -> controller.
"""

from __future__ import annotations

from .config import (
    ConfigurationSpace,
    add_configuration_space,
    set_subspace_configuration,
)
from .control.controller import Controller, ControllerFactory
from .costs.cost import Cost
from .costs.cost_factory import CostFactory
from .sysid.model import Model, ModelFactory


class Pipeline:
    """A collection of MPC components providing a joint configuration
    space and config-driven instantiation."""

    def __init__(self, system, *components):
        self.system = system
        self.model = None
        self.model_factory = None
        self.controller = None
        self.controller_factory = None
        self.cost = None
        self.cost_factory = None

        for component in components:
            if isinstance(component, Model):
                self._set_once("model", component)
            elif isinstance(component, ModelFactory):
                self._set_once("model_factory", component, other="model")
            elif isinstance(component, Controller):
                self._set_once("controller", component)
            elif isinstance(component, ControllerFactory):
                self._set_once("controller_factory", component, other="controller")
            elif isinstance(component, Cost):
                self._set_once("cost", component)
            elif isinstance(component, CostFactory):
                self._set_once("cost_factory", component, other="cost")
            else:
                raise ValueError(f"Unrecognized component {component!r}")

        if not (self.model or self.model_factory):
            raise ValueError("Pipeline must contain model or model factory")
        if not (self.controller or self.controller_factory):
            raise ValueError("Pipeline must contain controller or controller factory")
        if not (self.cost or self.cost_factory):
            raise ValueError("Pipeline must contain cost or cost factory")

    def _set_once(self, attr, component, other=None):
        base = other or attr.replace("_factory", "")
        if getattr(self, base, None) or getattr(self, base + "_factory", None):
            raise ValueError(
                f"Pipeline cannot contain multiple {base}s or {base} factories."
            )
        setattr(self, attr, component)

    def get_configuration_space(self) -> ConfigurationSpace:
        cs = ConfigurationSpace()
        for prefix, factory in (("_model", self.model_factory),
                                ("_ctrlr", self.controller_factory),
                                ("_cost", self.cost_factory)):
            if factory:
                add_configuration_space(cs, prefix, factory.get_configuration_space())
        return cs

    def __call__(self, cfg, task, trajs, model=None):
        """Instantiate (controller, task with the cost, model) from a joint
        configuration."""
        if not model:
            if self.model:
                model = self.model
            else:
                model_cfg = self.model_factory.get_configuration_space().get_default_configuration()
                set_subspace_configuration(cfg, "_model", model_cfg)
                model = self.model_factory(model_cfg, trajs)

        if self.cost:
            cost = self.cost
        else:
            cost_cfg = self.cost_factory.get_configuration_space().get_default_configuration()
            set_subspace_configuration(cfg, "_cost", cost_cfg)
            cost = self.cost_factory(cost_cfg, task, trajs)

        new_task = task.copy()
        new_task.set_cost(cost)

        if self.controller:
            controller = self.controller
        else:
            controller_cfg = (
                self.controller_factory.get_configuration_space().get_default_configuration())
            set_subspace_configuration(cfg, "_ctrlr", controller_cfg)
            controller = self.controller_factory(controller_cfg, new_task, model)

        return controller, new_task, model
