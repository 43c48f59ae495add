"""Model tuner: select and tune system-ID models by prediction accuracy
(port of ``autompc_tpu/tuning/model_tuner.py``).

A categorical ``model`` selector with each factory's space conditioned
on it (prefix ``_<Name>:``), optimized by the batched BO core
(``tuning/bo.py``). Candidates of a factory with a bucket route
(ARX, MLP, SINDy, Koopman lasso) train and score together through
``tuning/bucketed.py``; the others one at a time through the evaluator.

Unlike the JAX package, which scores any exception inf and sends a
bucket that raises anything back to the per-candidate path, only the
errors of a bad candidate (``_CANDIDATE_ERRORS``: a singular or
non-finite solve, a refused value) count so. A ``NotPortedError``, a
CUDA build or launch failure, or any other error reaches the caller.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from .. import NotPortedError
from ..config import (
    CategoricalHyperparameter,
    ConfigurationSpace,
    add_configuration_space,
)
from .bo import BatchBayesOpt

ModelTuneResult = namedtuple(
    "ModelTuneResult", ["inc_cfg", "cfgs", "inc_cfgs", "costs", "inc_costs"]
)
"""Tuning history: the final incumbent, every evaluated configuration
and cost, and the incumbent configuration and cost after each one."""

# A candidate whose training or scoring fails this way scores inf (or,
# in a bucket, goes to the per-candidate path); a refusal by name
# (NotPortedError, a ValueError) reaches the caller.
_CANDIDATE_ERRORS = (np.linalg.LinAlgError, torch.linalg.LinAlgError, FloatingPointError,
                     ValueError)


class ModelTuner:
    """Tunes system-ID models based on prediction accuracy."""

    def __init__(self, system, evaluator, eval_batch: int = 4, use_bucketed: bool = True):
        """``evaluator`` scores (model_factory, cfg) pairs; ``eval_batch``
        is the number of configurations proposed per BO round.

        ``use_bucketed=True`` routes ARX, MLP, SINDy and Koopman-lasso
        candidates through the batch trainers (``tuning/bucketed.py``)
        when the evaluator is a ``HoldoutModelEvaluator`` with the
        "rmse" metric; other candidates take the per-candidate path. The
        tuner works where the evaluator's trajectories lie."""
        self.system = system
        self.evaluator = evaluator
        self.eval_batch = int(eval_batch)
        self.use_bucketed = bool(use_bucketed)
        self._arx_bucket = None
        self._mlp_buckets = {}
        self._sindy_buckets = {}
        self._koopman_buckets = {}
        self.model_factories = []

    def add_model_factory(self, model_factory, cs=None):
        if cs is None:
            cs = model_factory.get_configuration_space()
        self.model_factories.append((model_factory, cs))

    def _build_space(self) -> ConfigurationSpace:
        cs_combined = ConfigurationSpace()
        cs_combined.add_hyperparameter(CategoricalHyperparameter(
            "model", choices=[f.name for f, _ in self.model_factories]))
        for model_factory, cs in self.model_factories:
            add_configuration_space(
                cs_combined, "_" + model_factory.name, cs,
                parent_hyperparameter={"parent": "model", "value": model_factory.name},
            )
        return cs_combined

    def _get_model_cfg(self, cfg_combined):
        """The selected factory and its (unprefixed) sub-configuration."""
        for model_factory, cs in self.model_factories:
            if model_factory.name != cfg_combined["model"]:
                continue
            cfg = cs.get_default_configuration()
            prefix = "_" + model_factory.name + ":"
            for key, val in cfg_combined.get_dictionary().items():
                if key.startswith(prefix):
                    cfg[key[len(prefix):]] = val
            return model_factory, cfg
        raise ValueError(f"Unknown model {cfg_combined['model']}")

    def _evaluate(self, cfg_combined):
        """One candidate through the evaluator; a bad candidate (see
        ``_CANDIDATE_ERRORS``) or a score that is not finite is inf."""
        model_factory, cfg = self._get_model_cfg(cfg_combined)
        try:
            value = float(self.evaluator(model_factory, cfg))
        except NotPortedError:
            raise
        except _CANDIDATE_ERRORS:
            value = float("inf")
        if not np.isfinite(value):
            value = float("inf")
        return value

    # -- bucketed routes ----------------------------------------------------
    def _bucket_ready(self, name):
        """The bucket routes apply when the evaluator is a holdout RMSE
        evaluator and the named factory is registered."""
        from ..evaluation import HoldoutModelEvaluator

        return (
            self.use_bucketed
            and isinstance(self.evaluator, HoldoutModelEvaluator)
            and self.evaluator.metric_name == "rmse"
            and any(f.name == name for f, _ in self.model_factories)
        )

    def _factory_overrides(self, name):
        factory = next(f for f, _ in self.model_factories if f.name == name)
        return getattr(factory, "kwargs", {})

    def _value_getter(self, name):
        """``cv(cfg, hp, default)``: a hyperparameter of ``name``'s
        candidates as its model would get it (the factory's keyword
        arguments win over the configuration)."""
        over = self._factory_overrides(name)

        def cv(cfg, hp, default):
            return over[hp] if hp in over else cfg.get(f"_{name}:{hp}", default)

        return cv

    def _eval_arx_bucket(self, cfgs, idxs, costs):
        from .bucketed import ARXBucketEvaluator

        if self._arx_bucket is None:
            cs = next(cs for f, cs in self.model_factories if f.name == "ARX")
            self._arx_bucket = ARXBucketEvaluator(
                self.system, self.evaluator.training_set, self.evaluator.holdout,
                kmax=cs.get_hyperparameter("history").upper, horizon=self.evaluator.horizon,
            )
        cv = self._value_getter("ARX")
        vals = self._arx_bucket([int(cv(cfgs[i], "history", 4)) for i in idxs])
        for j, i in enumerate(idxs):
            costs[i] = vals[j]

    def _eval_mlp_bucket(self, cfgs, idxs, costs):
        """MLP candidates grouped by (n_hidden_layers, nonlintype), each
        group's (widths, lr) batch one masked max-width training."""
        from .bucketed import MLPBucketEvaluator

        over = self._factory_overrides("MLP")
        cv = self._value_getter("MLP")
        groups = {}
        for i in idxs:
            cfg = cfgs[i]
            L = int(cv(cfg, "n_hidden_layers", "2"))
            nlt = str(cv(cfg, "nonlintype", "relu"))
            base = int(cv(cfg, "hidden_size", 128))
            widths = [int(cv(cfg, f"hidden_size_{j + 1}", base)) for j in range(L)]
            groups.setdefault((L, nlt), []).append((i, widths, float(cv(cfg, "lr", 1e-3))))

        for (L, nlt), items in groups.items():
            bkey = ("MLP", L, nlt)
            if bkey not in self._mlp_buckets:
                self._mlp_buckets[bkey] = MLPBucketEvaluator(
                    self.system, self.evaluator.training_set, self.evaluator.holdout,
                    n_hidden_layers=L, nonlintype=nlt, horizon=self.evaluator.horizon,
                    n_train_iters=int(over.get("n_train_iters", 50)),
                    n_batch=int(over.get("n_batch", 64)), seed=int(over.get("seed", 100)),
                )
            vals = self._mlp_buckets[bkey]([w for _, w, _ in items],
                                           [lr for _, _, lr in items])
            for (i, _, _), v in zip(items, vals):
                costs[i] = v

    def _eval_sindy_bucket(self, cfgs, idxs, costs):
        """SINDy candidates grouped by their basis library; within a group
        only the STLSQ threshold or lasso alpha varies."""
        from .bucketed import SINDyBucketEvaluator

        cv = self._value_getter("SINDy")
        groups = {}
        for i in idxs:
            cfg = cfgs[i]
            bucket_cfg = dict(
                method=str(cv(cfg, "method", "lstsq")),
                time_mode=str(cv(cfg, "time_mode", "discrete")),
                poly_basis=cv(cfg, "poly_basis", "false"),
                poly_degree=int(cv(cfg, "poly_degree", 3)),
                poly_cross_terms=cv(cfg, "poly_cross_terms", "false"),
                trig_basis=cv(cfg, "trig_basis", "false"),
                trig_freq=int(cv(cfg, "trig_freq", 1)),
                trig_interaction=cv(cfg, "trig_interaction", "false"),
            )
            reg = (float(cv(cfg, "lasso_alpha", 1.0)) if bucket_cfg["method"] == "lasso"
                   else float(cv(cfg, "threshold", 1e-2)))
            key = tuple(sorted(bucket_cfg.items()))
            groups.setdefault(key, (bucket_cfg, []))[1].append((i, reg))

        for key, (bucket_cfg, items) in groups.items():
            bkey = ("SINDy", key)
            if bkey not in self._sindy_buckets:
                self._sindy_buckets[bkey] = SINDyBucketEvaluator(
                    self.system, self.evaluator.training_set, self.evaluator.holdout,
                    bucket_cfg, horizon=self.evaluator.horizon,
                )
            vals = self._sindy_buckets[bkey]([r for _, r in items])
            for (i, _), v in zip(items, vals):
                costs[i] = v

    def _eval_koopman_bucket(self, cfgs, idxs, costs):
        """Koopman lasso candidates sharing a lifting go through one
        bucket; lstsq and stable candidates are left (``costs`` None) for
        the per-candidate path."""
        from .bucketed import KoopmanLassoBucketEvaluator

        cv = self._value_getter("Koopman")
        groups = {}
        for i in idxs:
            cfg = cfgs[i]
            if str(cv(cfg, "method", "lstsq")) != "lasso":
                continue
            bucket_cfg = dict(
                poly_basis=cv(cfg, "poly_basis", "false"),
                poly_degree=int(cv(cfg, "poly_degree", 3)),
                trig_basis=cv(cfg, "trig_basis", "false"),
                trig_freq=int(cv(cfg, "trig_freq", 1)),
                product_terms=cv(cfg, "product_terms", "false"),
            )
            key = tuple(sorted(bucket_cfg.items()))
            groups.setdefault(key, (bucket_cfg, []))[1].append(
                (i, float(cv(cfg, "lasso_alpha", 1.0))))

        for key, (bucket_cfg, items) in groups.items():
            bkey = ("Koopman", key)
            if bkey not in self._koopman_buckets:
                self._koopman_buckets[bkey] = KoopmanLassoBucketEvaluator(
                    self.system, self.evaluator.training_set, self.evaluator.holdout,
                    bucket_cfg, horizon=self.evaluator.horizon,
                )
            vals = self._koopman_buckets[bkey]([a for _, a in items])
            for (i, _), v in zip(items, vals):
                costs[i] = v

    def _bucket_runners(self):
        return (("ARX", self._eval_arx_bucket), ("MLP", self._eval_mlp_bucket),
                ("SINDy", self._eval_sindy_bucket), ("Koopman", self._eval_koopman_bucket))

    def _evaluate_batch(self, cfgs):
        """Score a batch: ARX, MLP, SINDy and Koopman-lasso candidates
        through their buckets, the rest (and a bucket that failed as a
        bad candidate fails) through the per-candidate path."""
        costs = [None] * len(cfgs)
        for name, runner in self._bucket_runners():
            if not self._bucket_ready(name):
                continue
            idxs = [i for i, cfg in enumerate(cfgs) if cfg["model"] == name]
            if not idxs:
                continue
            try:
                runner(cfgs, idxs, costs)
            except NotPortedError:
                raise
            except _CANDIDATE_ERRORS:
                for i in idxs:
                    costs[i] = None
        for i, cfg in enumerate(cfgs):
            if costs[i] is None:
                costs[i] = self._evaluate(cfg)
        return costs

    def run(self, rng, n_iters=10):
        """Run tuning with the caller's numpy ``Generator`` (or a seed);
        returns (the incumbent's model trained on every trajectory,
        ModelTuneResult)."""
        np_rng = rng if hasattr(rng, "integers") else np.random.default_rng(int(rng))
        bo = BatchBayesOpt(self._build_space(), rng=np_rng, batch_size=self.eval_batch)

        evaluated_cfgs, evaluated_costs = [], []
        remaining = int(n_iters)
        while remaining > 0:
            batch = bo.ask(min(self.eval_batch, remaining))
            costs = self._evaluate_batch(batch)
            bo.tell(batch, costs)
            evaluated_cfgs.extend(batch)
            evaluated_costs.extend(costs)
            remaining -= len(batch)

        inc_cost, inc_cfg = float("inf"), None
        inc_cfgs, inc_costs = [], []
        for cfg, cost in zip(evaluated_cfgs, evaluated_costs):
            if cost < inc_cost:
                inc_cost, inc_cfg = cost, cfg
            inc_costs.append(inc_cost)
            inc_cfgs.append(inc_cfg)

        tune_result = ModelTuneResult(inc_cfg=inc_cfg, cfgs=evaluated_cfgs,
                                      costs=evaluated_costs, inc_costs=inc_costs,
                                      inc_cfgs=inc_cfgs)
        model_factory, final_cfg = self._get_model_cfg(inc_cfg)
        return model_factory(final_cfg, self.evaluator.trajs), tune_result
