"""Model evaluators (port of ``autompc_tpu/evaluation/evaluator.py``):
a configuration's model is trained on one split and scored on another
by a prediction-accuracy metric."""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

from .model_metrics import get_model_rmse, get_model_rmsmens


class ModelEvaluator(ABC):
    """Evaluates model configurations by prediction accuracy.
    ``metric`` is "rmse", "rmsmens" or a callable ``(model, trajs) ->
    float``; ``metric_name`` and ``horizon`` tell the tuner's bucketed
    routes which named metric and horizon this evaluator scores with."""

    def __init__(self, system, trajs, metric, rng, horizon=1):
        self.system = system
        self.trajs = list(trajs) if not hasattr(trajs, "to_list") else trajs.to_list()
        self.rng = rng
        self.metric_name = metric if isinstance(metric, str) else None
        self.horizon = horizon
        if isinstance(metric, str):
            if metric == "rmse":
                self.metric = lambda model, trajs: get_model_rmse(model, trajs, horizon=horizon)
            elif metric == "rmsmens":
                self.metric = lambda model, trajs: get_model_rmsmens(
                    model, trajs, horizon=horizon)
            else:
                raise ValueError(f"Unknown metric {metric}")
        else:
            self.metric = metric

    @abstractmethod
    def __call__(self, model_factory, configuration):
        raise NotImplementedError


class HoldoutModelEvaluator(ModelEvaluator):
    """Train on a split, score on a held-out set: ``round(holdout_prop *
    n)`` trajectories drawn without replacement by the caller's numpy
    ``rng`` (so the JAX package holds out the same ones for the same
    seed), or the trajectories of ``holdout_set`` (matched by value)."""

    def __init__(self, *args, holdout_prop=0.1, holdout_set=None, verbose=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.verbose = verbose
        if holdout_set is None:
            holdout_size = round(holdout_prop * len(self.trajs))
            holdout_indices = self.rng.choice(
                np.arange(len(self.trajs)), holdout_size, replace=False)
            holdout_idx = set(int(i) for i in holdout_indices)
            self.holdout = [self.trajs[i] for i in sorted(holdout_idx)]
            self.training_set = [t for i, t in enumerate(self.trajs) if i not in holdout_idx]
        else:
            self.holdout = list(holdout_set)
            self.training_set = [t for t in self.trajs if t not in self.holdout]

    def __call__(self, model_factory, configuration):
        """The holdout score of the model ``model_factory`` trains for
        ``configuration``; a score that is not finite is ``inf``."""
        model = model_factory(configuration, self.training_set)
        value = self.metric(model, self.holdout)
        if not np.isfinite(value):
            return float("inf")
        return value
