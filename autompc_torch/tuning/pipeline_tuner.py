"""Pipeline tuner: joint AutoML over {model, cost, controller} (port of
``autompc_tpu/tuning/pipeline_tuner.py``).

Build (or take) a surrogate dynamics model, then optimize the pipeline's
joint configuration space with batched BO (``tuning/bo.py``): each
candidate is instantiated and simulated closed loop against the
surrogate, and the task cost of that trajectory is the objective. With
``truedyn`` the true-dynamics cost of each candidate is recorded too
(reporting only). Exceptions and non-finite rollouts score ``inf`` and
the tune goes on.

``use_fanout=True`` scores each ask batch through a fan-out instead of
one simulation per candidate, with a ``QuadCostFactory``, a
``GaussRegFactory`` or a ``SumCostFactory`` of at most one of each
(``_cost_fanout_spec``; the GaussReg term rides every fan-out as its
``reg_matrix``, each candidate's ``reg_weight`` as its lane's ``regw``)
and an ``IterativeLQRFactory``: for a fixed model (kind ``"ilqr"``) the batch
is bucketed by horizon and every bucket is one
``parallel/fanout.py::QuadCostFanout`` call; with an ``MPPIFactory`` (kind
``"mppi"``) by (horizon, num_path), every bucket one ``MPPIFanout`` call
whose lanes carry their ``sigma`` and ``lmda``; with a
``DirectTranscriptionControllerFactory`` (kind ``"dt"``) by knot count
(ceil(horizon / dt), the horizon in seconds), every bucket one
``DirectTranscriptionFanout`` call; for a ``SINDyFactory``
(kind ``"joint_sindy"``) it is bucketed by the SINDy basis (the
library, time mode and method: ``sindy_bucket``) and horizon, and every
bucket is one ``JointSINDyQuadCostFanout`` call, which trains a model
per candidate; for an ``MLPFactory``
(kind ``"joint_mlp"``) it is bucketed by (n_hidden_layers, nonlintype,
horizon) — with ``fanout_horizon_mask`` the horizon is the space's
upper bound and every lane solves at its own — and every bucket is one
``JointMLPQuadCostFanout`` call, which trains a net per candidate; for an
``ARXFactory`` (kind ``"joint_arx"``) by (history, horizon), one ARX
trained a bucket and every bucket one ``QuadCostFanout`` call on it; for
a ``KoopmanFactory`` (kind ``"joint_koopman"``) by (method, basis,
horizon), a Lasso bucket one ``JointKoopmanLassoQuadCostFanout`` call,
which trains (A, B) per candidate, an lstsq or stable bucket one Koopman
trained a bucket and one ``QuadCostFanout`` call on it; for an
``ApproximateGPModelFactory`` (kind ``"joint_gp"``) by horizon alone,
every bucket one ``JointGPQuadCostFanout`` call, which trains an SVGP a
distinct ``induce_count`` (all missing ones in one padded batched
training, kept across rounds) and gives every lane its bucket's
predictor. The true-dynamics scores take a second call with
``FunctionModel(system, truedyn)`` as its surrogate. ``mesh`` raises
``ValueError`` by name; a pipeline that has no fan-out at all (an
``LQRFactory``, or a surrogate with a lifted state, say) falls back to
the sequential objective with a warning, as in the JAX package. Every
tensor the tuner makes is on the pipeline model's device.

The surrogate modes "autotune" (``surrogate_factory`` tuned) and
"autoselect" (MLP, SINDy, ApproximateGP, ARX and Koopman factories
selected and tuned) run ``tuning/model_tuner.py::ModelTuner`` on the
surrogate split, scored by ``surrogate_evaluator`` or a holdout
evaluator, on the run's own ``rng``; the tune's history is the result's
``surr_tune_result``.
"""

from __future__ import annotations

import os
import warnings
from collections import namedtuple

import numpy as np

from .. import NotPortedError
from ..costs.gauss_reg_factory import GaussRegFactory
from ..costs.gauss_reg_factory import gauss_reg_stats as _gauss_reg_stats
from ..costs.quad_cost_factory import QuadCostFactory
from ..costs.sum_cost_factory import SumCostFactory
from ..evaluation import HoldoutModelEvaluator
from ..sysid.model import model_device
from ..utils.checkpoint import (
    bo_load_state,
    bo_state_dict,
    load_checkpoint,
    save_checkpoint,
)
from ..utils.simulation import simulate
from .bo import BatchBayesOpt
from .model_tuner import _CANDIDATE_ERRORS, ModelTuner

PipelineTuneResult = namedtuple(
    "PipelineTuneResult",
    [
        "inc_cfg", "cfgs", "inc_cfgs", "costs", "inc_costs",
        "truedyn_costs", "inc_truedyn_costs", "surr_trajs",
        "truedyn_trajs", "surr_tune_result",
    ],
)
"""Tuning history."""

# Fan-out kinds of the JAX package by the class name of the pipeline's
# model factory (with an IterativeLQRFactory) or, for a fixed model, of
# its controller factory. Every kind is ported.
_JOINT_KINDS = {
    "SINDyFactory": "joint_sindy", "ARXFactory": "joint_arx", "MLPFactory": "joint_mlp",
    "KoopmanFactory": "joint_koopman", "ApproximateGPModelFactory": "joint_gp",
}
_FIXED_KINDS = {
    "IterativeLQRFactory": "ilqr", "MPPIFactory": "mppi",
    "DirectTranscriptionControllerFactory": "dt",
}
_PORTED_KINDS = (None, "ilqr", "mppi", "dt", "joint_mlp", "joint_sindy", "joint_arx",
                 "joint_koopman", "joint_gp")


def _cost_fanout_spec(cost_factory):
    """Which cost-factory layouts the per-lane-cost solver covers, and
    where their hyperparameters live in the joint configuration: None
    (not covered) or a dict with ``quad_prefix`` (the QuadCostFactory
    subspace's prefix under ``_cost:``: "" for a bare factory,
    ``"_sum_i:"`` inside a SumCostFactory, None without one, the
    diagonals then zero), ``quad_factory`` (that factory, for its goal,
    or None) and ``reg_prefix`` (the GaussRegFactory subspace's prefix,
    or None). Covered: a QuadCostFactory, a GaussRegFactory, and a
    SumCostFactory of at most one of each."""
    if isinstance(cost_factory, QuadCostFactory):
        return {"quad_prefix": "", "quad_factory": cost_factory, "reg_prefix": None}
    if isinstance(cost_factory, GaussRegFactory):
        return {"quad_prefix": None, "quad_factory": None, "reg_prefix": ""}
    if isinstance(cost_factory, SumCostFactory):
        quad = reg = None
        for i, f in enumerate(cost_factory.factories):
            if isinstance(f, QuadCostFactory) and quad is None:
                quad = (i, f)
            elif isinstance(f, GaussRegFactory) and reg is None:
                reg = i
            else:
                return None
        return {
            "quad_prefix": f"_sum_{quad[0]}:" if quad else None,
            "quad_factory": quad[1] if quad else None,
            "reg_prefix": f"_sum_{reg}:" if reg is not None else None,
        }
    return None


def _autoselect_factories():
    """The factories "autoselect" chooses among, in the JAX package's
    order (it fixes the ``model`` categorical's encoding, and so the BO's
    proposals)."""
    from ..sysid import (
        ApproximateGPModelFactory,
        ARXFactory,
        KoopmanFactory,
        MLPFactory,
        SINDyFactory,
    )

    return [MLPFactory, SINDyFactory, ApproximateGPModelFactory, ARXFactory, KoopmanFactory]


class PipelineTuner:
    """Tunes SysID+MPC pipelines."""

    def __init__(
        self,
        surrogate_mode="defaultcfg",
        surrogate_factory=None,
        surrogate_split=None,
        surrogate_cfg=None,
        surrogate_evaluator=None,
        surrogate_tune_holdout=0.25,
        surrogate_tune_metric="rmse",
        eval_batch: int = 4,
        use_fanout: bool = False,
        mesh=None,
        fanout_compact=None,
        fanout_warm_start: bool = False,
        fanout_backward: str = "scan",
        fanout_feature_kernels: bool = False,
        fanout_horizon_mask: bool = True,
    ):
        """``surrogate_mode``: "defaultcfg" or "fixedcfg" train the
        surrogate from the surrogate split with ``surrogate_factory``;
        "pretrain" takes a trained one from ``run(surrogate=...)``;
        "autotune" tunes ``surrogate_factory``'s configuration and
        "autoselect" also selects the model among five factories
        (``_autoselect_factories``), both by ``ModelTuner`` on the
        surrogate split with ``surrogate_evaluator`` or a
        ``HoldoutModelEvaluator(metric=surrogate_tune_metric,
        holdout_prop=surrogate_tune_holdout)``, ``eval_batch``
        configurations a round; "autoselect"'s factories run on the
        device of the trajectories.

        ``use_fanout``, ``fanout_compact`` (a compaction schedule for
        the fan-out's per-step solves), ``fanout_warm_start``,
        ``fanout_backward`` and ``fanout_feature_kernels`` (the
        feature-model kernels for a model with a ``library``) are the
        JAX package's options of the fan-out path: see the module's
        docstring. ``fanout_horizon_mask`` (joint-MLP fan-out only):
        one program a (n_hidden_layers, nonlintype) bucket at the
        controller space's largest horizon, every lane at its own
        horizon (``make_batched_ilqr_solver``'s ``horizon_mask``), the
        lanes padded to at least ``eval_batch``; a horizon pinned by
        the controller factory turns it off."""
        if mesh is not None:
            raise ValueError(
                "mesh (candidates sharded over several cards) is not ported to "
                "autompc_torch yet; pass mesh=None"
            )
        self.surrogate_mode = surrogate_mode
        self.surrogate_factory = surrogate_factory
        self.surrogate_split = surrogate_split
        self.surrogate_cfg = surrogate_cfg
        self.surrogate_evaluator = surrogate_evaluator
        self.surrogate_tune_holdout = surrogate_tune_holdout
        self.surrogate_tune_metric = surrogate_tune_metric
        self.eval_batch = int(eval_batch)
        self.use_fanout = bool(use_fanout)
        self.mesh = mesh
        self.fanout_compact = fanout_compact
        self.fanout_warm_start = bool(fanout_warm_start)
        self.fanout_backward = str(fanout_backward)
        self.fanout_feature_kernels = bool(fanout_feature_kernels)
        self.fanout_horizon_mask = bool(fanout_horizon_mask)
        self._reg_stats = None

    def _fanout_kind(self, pipeline, surrogate):
        """``(kind, reason)``: the JAX package's fan-out kind for this
        pipeline ("ilqr", "mppi", "dt" for a fixed model; "joint_*" for
        a model factory), or None and why there is none."""
        if not self.use_fanout:
            return None, "use_fanout=False"
        if _cost_fanout_spec(pipeline.cost_factory) is None:
            return None, (
                f"cost factory is {type(pipeline.cost_factory).__name__}; the per-lane "
                "solver covers QuadCostFactory / GaussRegFactory / their SumCostFactory "
                "combination only"
            )
        if surrogate.state_dim != pipeline.system.obs_dim:
            return None, (
                f"surrogate has lifted state (state_dim={surrogate.state_dim} != obs_dim="
                f"{pipeline.system.obs_dim}); the fan-out closed loop advances "
                "observation-state surrogates only"
            )
        cf = type(pipeline.controller_factory).__name__
        if pipeline.model is not None:
            if cf in _FIXED_KINDS:
                return _FIXED_KINDS[cf], ""
            return None, f"controller factory {cf} has no fan-out implementation"
        mf = type(pipeline.model_factory).__name__
        if mf not in _JOINT_KINDS:
            return None, (
                "joint fan-out covers SINDy/ARX/MLP/Koopman/ApproximateGP model "
                f"factories; got {mf}"
            )
        if cf != "IterativeLQRFactory":
            return None, f"joint {mf} fan-out supports IterativeLQRFactory; got {cf}"
        return _JOINT_KINDS[mf], ""

    def _eval_batch_fanout(self, pipeline, task, surrogate, cfgs, fanouts, kind,
                           sysid_trajs=None):
        """Score ``cfgs`` through one fan-out call per bucket, each
        fan-out built once and kept in ``fanouts``: ``QuadCostFanout``
        by horizon (kind "ilqr"), ``MPPIFanout`` by (horizon, num_path)
        (kind "mppi"), ``DirectTranscriptionFanout`` by knot count (kind
        "dt"), ``JointSINDyQuadCostFanout`` by
        (sorted ``sindy_bucket`` items, horizon) (kind "joint_sindy"),
        ``JointMLPQuadCostFanout`` by (n_hidden_layers, nonlintype,
        horizon) (kind "joint_mlp"), ``QuadCostFanout`` on one ARX a
        (history, horizon) bucket (kind "joint_arx"),
        ``JointKoopmanLassoQuadCostFanout`` or ``QuadCostFanout`` on one
        Koopman a (method, sorted basis items, horizon) bucket (kind
        "joint_koopman"), ``JointGPQuadCostFanout`` by horizon (kind
        "joint_gp"). Returns costs aligned with ``cfgs``."""
        from ..control.nmpc import knot_count
        from ..parallel.fanout import (
            DirectTranscriptionFanout,
            JointGPQuadCostFanout,
            JointKoopmanLassoQuadCostFanout,
            JointMLPQuadCostFanout,
            JointSINDyQuadCostFanout,
            MPPIFanout,
            QuadCostFanout,
        )
        from ..sysid.arx import ARX
        from ..sysid.koopman import Koopman

        system = pipeline.system
        n_steps = (task.get_num_steps() or 200) - 1
        spec = _cost_fanout_spec(pipeline.cost_factory)
        qp, rp = spec["quad_prefix"], spec["reg_prefix"]
        # The goal resolves as in QuadCostFactory.__call__: the factory's
        # goal wins over the task's.
        factory_goal = getattr(spec["quad_factory"], "goal", None)
        if factory_goal is not None:
            goal = np.nan_to_num(np.asarray(factory_goal, dtype=float))
        elif task.get_cost() is not None and task.get_cost().has_goal:
            goal = np.nan_to_num(np.asarray(task.get_cost().get_goal(), dtype=float))
        else:
            goal = np.zeros(system.obs_dim)
        reg_kw = {}
        if rp is not None:
            # The GaussReg statistics over the sysid split, once a run
            # (GaussRegFactory.__call__'s).
            if self._reg_stats is None:
                self._reg_stats = _gauss_reg_stats(sysid_trajs)
            reg_kw = dict(zip(("reg_matrix", "reg_goal"), self._reg_stats))
        # Factory keyword arguments override configuration values, as in
        # ControllerFactory.__call__.
        overrides = getattr(pipeline.controller_factory, "kwargs", {})

        def ck(cfg, name, default):
            return overrides[name] if name in overrides else cfg.get(f"_ctrlr:{name}", default)

        def horizon(cfg):
            return int(ck(cfg, "horizon", 20))

        # Model-factory hyperparameters resolve the same way
        # (ModelFactory.__call__: the factory's keyword arguments win).
        m_over = getattr(pipeline.model_factory, "kwargs", None) or {}

        def mk(cfg, name, default):
            return m_over[name] if name in m_over else cfg.get(f"_model:{name}", default)

        def sindy_bucket(cfg):
            """A SINDy candidate's bucket: its basis library, time mode and
            fit method (the regularizer goes per lane)."""
            return dict(
                method=str(mk(cfg, "method", "lstsq")),
                time_mode=str(mk(cfg, "time_mode", "discrete")),
                poly_basis=mk(cfg, "poly_basis", "false"),
                poly_degree=int(mk(cfg, "poly_degree", 3)),
                poly_cross_terms=mk(cfg, "poly_cross_terms", "false"),
                trig_basis=mk(cfg, "trig_basis", "false"),
                trig_freq=int(mk(cfg, "trig_freq", 1)),
                trig_interaction=mk(cfg, "trig_interaction", "false"),
            )

        # Horizon-masked joint-MLP buckets: one program at the controller
        # space's largest horizon serves every candidate horizon.
        hmask_on = self.fanout_horizon_mask and kind == "joint_mlp" \
            and "horizon" not in overrides
        if hmask_on:
            space = pipeline.controller_factory.get_configuration_space()
            hmask_on = "horizon" in space.get_hyperparameter_names()
            h_upper = int(space.get_hyperparameter("horizon").upper) if hmask_on else None

        buckets = {}
        for idx, cfg in enumerate(cfgs):
            if kind == "joint_mlp":
                key = (int(mk(cfg, "n_hidden_layers", "2")), str(mk(cfg, "nonlintype", "relu")),
                       h_upper if hmask_on else horizon(cfg))
            elif kind == "joint_sindy":
                key = (tuple(sorted(sindy_bucket(cfg).items())), horizon(cfg))
            elif kind == "mppi":
                key = (horizon(cfg), int(ck(cfg, "num_path", 200)))
            elif kind == "dt":
                # The factory's horizon is in seconds.
                key = knot_count(ck(cfg, "horizon", 20), system.dt)
            elif kind == "joint_koopman":
                basis = dict(
                    poly_basis=mk(cfg, "poly_basis", "false"),
                    poly_degree=int(mk(cfg, "poly_degree", 3)),
                    trig_basis=mk(cfg, "trig_basis", "false"),
                    trig_freq=int(mk(cfg, "trig_freq", 1)),
                    product_terms=mk(cfg, "product_terms", "false"),
                )
                key = (str(mk(cfg, "method", "lstsq")), tuple(sorted(basis.items())),
                       horizon(cfg))
            elif kind == "joint_arx":
                key = (int(mk(cfg, "history", 4)), horizon(cfg))
            else:
                key = horizon(cfg)
            buckets.setdefault(key, []).append(idx)

        if kind.startswith("joint_"):
            device = m_over.get("device")
        else:
            device = model_device(pipeline.model)
        fs = None
        if self.fanout_feature_kernels and hasattr(pipeline.model, "library"):
            fs = (pipeline.model.library, "coeffs")
        costs = [None] * len(cfgs)
        for key, idxs in buckets.items():
            if key not in fanouts and kind == "joint_mlp":
                fanouts[key] = JointMLPQuadCostFanout(
                    system, task, dict(n_hidden_layers=key[0], nonlintype=key[1]),
                    sysid_trajs, surrogate, horizon=key[2], n_steps=n_steps, goal=goal,
                    horizon_mask=hmask_on,
                    # With horizon-masked buckets the lane count is pinned
                    # too: one batch size a bucket.
                    pad_to=self.eval_batch if hmask_on else None,
                    compact_schedule=self.fanout_compact, warm_start=self.fanout_warm_start,
                    backward=self.fanout_backward,
                    n_train_iters=int(m_over.get("n_train_iters", 50)),
                    n_batch=int(m_over.get("n_batch", 64)), seed=int(m_over.get("seed", 100)),
                    device=device, **reg_kw,
                )
            elif key not in fanouts and kind == "joint_sindy":
                fanouts[key] = JointSINDyQuadCostFanout(
                    system, task, dict(key[0]), sysid_trajs, surrogate, horizon=key[1],
                    n_steps=n_steps, goal=goal, compact_schedule=self.fanout_compact,
                    warm_start=self.fanout_warm_start, backward=self.fanout_backward,
                    use_feature_kernels=self.fanout_feature_kernels, device=device, **reg_kw,
                )
            elif key not in fanouts and kind == "joint_koopman" and key[0] == "lasso":
                fanouts[key] = JointKoopmanLassoQuadCostFanout(
                    system, task, dict(key[1]), sysid_trajs, surrogate, horizon=key[2],
                    n_steps=n_steps, goal=goal, compact_schedule=self.fanout_compact,
                    warm_start=self.fanout_warm_start, backward=self.fanout_backward,
                    device=device, **reg_kw,
                )
            elif key not in fanouts and kind in ("joint_koopman", "joint_arx"):
                # The lstsq and stable Koopman fits and ARX have no per-lane
                # hyperparameter: one model a bucket, the fixed-model fan-out.
                if kind == "joint_arx":
                    model = ARX(system, history=key[0], device=device)
                else:
                    model = Koopman(system, method=key[0], device=device, **dict(key[1]))
                model.train(sysid_trajs)
                fanouts[key] = QuadCostFanout(
                    system, task, model, surrogate, horizon=key[-1], n_steps=n_steps,
                    goal=goal, compact_schedule=self.fanout_compact,
                    warm_start=self.fanout_warm_start, backward=self.fanout_backward,
                    device=device, **reg_kw,
                )
            elif key not in fanouts and kind == "joint_gp":
                # induce_count does not bucket: every distinct value trains
                # in one padded batched program, the lanes carry their
                # bucket's predictor.
                fanouts[key] = JointGPQuadCostFanout(
                    system, task,
                    dict(niter=int(m_over.get("niter", 5)), lr=float(m_over.get("lr", 0.1)),
                         batch_size=int(m_over.get("batch_size", 1024)),
                         seed=int(m_over.get("seed", 100))),
                    sysid_trajs, surrogate, horizon=key, n_steps=n_steps, goal=goal,
                    compact_schedule=self.fanout_compact, warm_start=self.fanout_warm_start,
                    backward=self.fanout_backward, device=device, **reg_kw,
                )
            elif key not in fanouts and kind == "mppi":
                fanouts[key] = MPPIFanout(
                    system, task, pipeline.model, surrogate, horizon=key[0], num_path=key[1],
                    n_steps=n_steps, goal=goal, device=device, **reg_kw,
                )
            elif key not in fanouts and kind == "dt":
                fanouts[key] = DirectTranscriptionFanout(
                    system, task, pipeline.model, surrogate, horizon_knots=key,
                    n_steps=n_steps, goal=goal, device=device, **reg_kw,
                )
            elif key not in fanouts:
                fanouts[key] = QuadCostFanout(
                    system, task, pipeline.model, surrogate, horizon=key, n_steps=n_steps,
                    goal=goal, compact_schedule=self.fanout_compact,
                    warm_start=self.fanout_warm_start, backward=self.fanout_backward,
                    feature_spec=fs, device=device, **reg_kw,
                )

            def diag(suffix, names):
                # Zeros where the space has no quad term (a bare
                # GaussRegFactory).
                if qp is None:
                    return np.zeros((len(idxs), len(names)))
                return np.array([[cfgs[i].get(f"_cost:{qp}{o}_{suffix}", 0.0) for o in names]
                                 for i in idxs], dtype=float)

            batch = {
                "Qdiag": diag("Q", system.observations),
                "Fdiag": diag("F", system.observations),
                "Rdiag": diag("R", system.controls),
            }
            if rp is not None:
                batch["regw"] = np.array([float(cfgs[i].get(f"_cost:{rp}reg_weight", 1.0))
                                          for i in idxs])
            if kind == "joint_mlp":
                batch["widths"] = tuple(
                    tuple(int(mk(cfgs[i], f"hidden_size_{j + 1}",
                                 mk(cfgs[i], "hidden_size", 128))) for j in range(key[0]))
                    for i in idxs)
                batch["lr"] = np.array([float(mk(cfgs[i], "lr", 1e-3)) for i in idxs])
                if hmask_on:
                    batch["horizons"] = np.array([horizon(cfgs[i]) for i in idxs])
            elif kind == "mppi":
                for name in ("sigma", "lmda"):
                    batch[name] = np.array([float(ck(cfgs[i], name, 1.0)) for i in idxs])
            elif kind == "joint_sindy":
                lasso = dict(key[0])["method"] == "lasso"
                batch["reg"] = np.array([
                    float(mk(cfgs[i], "lasso_alpha", 1.0) if lasso
                          else mk(cfgs[i], "threshold", 1e-2)) for i in idxs])
            elif kind == "joint_koopman" and key[0] == "lasso":
                batch["reg"] = np.array([float(mk(cfgs[i], "lasso_alpha", 1.0)) for i in idxs])
            elif kind == "joint_gp":
                batch["induce_count"] = np.array([int(mk(cfgs[i], "induce_count", 100))
                                                  for i in idxs])
            vals = fanouts[key](batch).cpu().numpy()
            for j, i in enumerate(idxs):
                costs[i] = float(vals[j])
        return costs

    def _get_surrogate(self, pipeline, trajs, rng, surrogate_tune_iters):
        """(the surrogate, the model tune's result or None)."""
        if self.surrogate_mode == "defaultcfg":
            cs = self.surrogate_factory.get_configuration_space()
            return self.surrogate_factory(cs.get_default_configuration(), trajs), None
        if self.surrogate_mode == "fixedcfg":
            return self.surrogate_factory(self.surrogate_cfg, trajs), None
        if self.surrogate_mode in ("autotune", "autoselect"):
            evaluator = self.surrogate_evaluator
            if evaluator is None:
                evaluator = HoldoutModelEvaluator(
                    system=pipeline.system, trajs=trajs, metric=self.surrogate_tune_metric,
                    rng=rng, holdout_prop=self.surrogate_tune_holdout,
                )
            model_tuner = ModelTuner(pipeline.system, evaluator, eval_batch=self.eval_batch)
            if self.surrogate_mode == "autotune":
                model_tuner.add_model_factory(self.surrogate_factory)
            else:
                device = evaluator.trajs[0].obs.device
                for factory_cls in _autoselect_factories():
                    model_tuner.add_model_factory(factory_cls(pipeline.system, device=device))
            return model_tuner.run(rng, n_iters=surrogate_tune_iters)
        if self.surrogate_mode == "pretrain":
            raise ValueError(
                'surrogate_mode="pretrain" requires passing a trained '
                "surrogate model via run(surrogate=...)"
            )
        raise ValueError(f"Unknown surrogate_mode {self.surrogate_mode}")

    def run(
        self,
        pipeline,
        task,
        trajs,
        n_iters,
        rng,
        surrogate=None,
        truedyn=None,
        surrogate_tune_iters=100,
        eval_cfg_hook=None,
        checkpoint_path=None,
    ):
        """Run tuning; returns (final controller, PipelineTuneResult).

        With ``checkpoint_path`` the tuner saves its state after every
        evaluated batch and resumes from an existing checkpoint."""
        trajs = list(trajs) if not hasattr(trajs, "to_list") else trajs.to_list()
        self._reg_stats = None  # the GaussReg statistics of this run
        if surrogate is None:
            surr_size = int(self.surrogate_split * len(trajs))
            shuffled = trajs[:]
            rng.shuffle(shuffled)
            sysid_trajs = shuffled[surr_size:]
            surrogate, surr_tune_result = self._get_surrogate(
                pipeline, shuffled[:surr_size], rng, surrogate_tune_iters
            )
        else:
            sysid_trajs = trajs
            surr_tune_result = None

        def rollout_cost(cfg, model=None, **sim):
            controller, _, model = pipeline(cfg, task, sysid_trajs, model=model)
            controller.reset()
            max_steps = {"max_steps": task.get_num_steps()} if task.has_num_steps() else {}
            traj = simulate(controller, task.get_init_obs(), task.term_cond, **sim,
                            **max_steps)
            return float(task.get_cost()(traj)), traj, model

        def eval_cfg(cfg):
            info = {}
            try:
                surr_cost, info["surr_traj"], model = rollout_cost(cfg, sim_model=surrogate)
                if not np.isfinite(surr_cost):
                    surr_cost = float("inf")
            except NotPortedError:
                raise
            except _CANDIDATE_ERRORS:
                surr_cost, info["surr_traj"], model = float("inf"), None, None
            info["surr_cost"] = surr_cost
            if truedyn is not None and model is not None:
                try:
                    info["truedyn_cost"], info["truedyn_traj"], _ = rollout_cost(
                        cfg, model=model, dynamics=truedyn)
                except NotPortedError:
                    raise
                except _CANDIDATE_ERRORS:
                    info["truedyn_cost"], info["truedyn_traj"] = float("inf"), None
            if eval_cfg_hook is not None:
                eval_cfg_hook(cfg, info)
            return surr_cost, info

        space = pipeline.get_configuration_space()
        bo = BatchBayesOpt(space, rng=rng, batch_size=self.eval_batch)

        cfgs, costs, infos = [], [], []
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            snap = load_checkpoint(checkpoint_path)
            bo_load_state(bo, snap["bo"])
            cfgs = [space.configuration_from_dict(d) for d in snap["cfg_dicts"]]
            costs = list(snap["costs"])
            infos = [{"surr_cost": c, "surr_traj": None} for c in costs]

        fanout_kind, fanout_reason = self._fanout_kind(pipeline, surrogate)
        if fanout_kind not in _PORTED_KINDS:
            raise ValueError(
                f"the {fanout_kind!r} fan-out of the JAX package is not ported to "
                "autompc_torch yet; pass use_fanout=False for the sequential objective"
            )
        if self.use_fanout and fanout_kind is None:
            warnings.warn(
                "use_fanout=True but this pipeline has no fan-out fast "
                f"path ({fanout_reason}); falling back to the "
                "sequential per-candidate objective",
                stacklevel=2,
            )
        fanouts, fanouts_true = {}, {}
        oracle = None
        if fanout_kind is not None and truedyn is not None:
            # True-dynamics reporting rides a second fan-out with the true
            # dynamics as its surrogate.
            from ..sysid.dummy import FunctionModel

            oracle = FunctionModel(pipeline.system, truedyn)
        remaining = int(n_iters) - len(costs)
        while remaining > 0:
            batch = bo.ask(min(self.eval_batch, remaining))
            if fanout_kind is not None:
                batch_costs = self._eval_batch_fanout(
                    pipeline, task, surrogate, batch, fanouts, fanout_kind,
                    sysid_trajs=sysid_trajs,
                )
                true_costs = (
                    self._eval_batch_fanout(pipeline, task, oracle, batch, fanouts_true,
                                            fanout_kind, sysid_trajs=sysid_trajs)
                    if oracle is not None else None
                )
                for j, c in enumerate(batch_costs):
                    info = {"surr_cost": c, "surr_traj": None}
                    if true_costs is not None:
                        info.update(truedyn_cost=true_costs[j], truedyn_traj=None)
                    infos.append(info)
            else:
                batch_costs = []
                for cfg in batch:
                    c, info = eval_cfg(cfg)
                    batch_costs.append(c)
                    infos.append(info)
            bo.tell(batch, batch_costs)
            cfgs.extend(batch)
            costs.extend(batch_costs)
            remaining -= len(batch)
            if checkpoint_path is not None:
                save_checkpoint(checkpoint_path, {
                    "kind": "pipeline_tune",
                    "bo": bo_state_dict(bo),
                    "cfg_dicts": [c.get_dictionary() for c in cfgs],
                    "costs": list(costs),
                })

        # The incumbent history.
        inc_cost, inc_cfg, inc_truedyn_cost = float("inf"), None, float("inf")
        inc_cfgs, inc_costs = [], []
        truedyn_costs, inc_truedyn_costs = [], []
        surr_trajs, truedyn_trajs = [], []
        for cfg, cost, info in zip(cfgs, costs, infos):
            if cost < inc_cost:
                inc_cost, inc_cfg = cost, cfg
                if "truedyn_cost" in info:
                    inc_truedyn_cost = info["truedyn_cost"]
            inc_costs.append(inc_cost)
            inc_cfgs.append(inc_cfg)
            surr_trajs.append(info.get("surr_traj"))
            if "truedyn_cost" in info:
                truedyn_costs.append(info["truedyn_cost"])
                inc_truedyn_costs.append(inc_truedyn_cost)
                truedyn_trajs.append(info.get("truedyn_traj"))

        tune_result = PipelineTuneResult(
            inc_cfg=inc_cfg, cfgs=cfgs, inc_cfgs=inc_cfgs, costs=costs, inc_costs=inc_costs,
            truedyn_costs=truedyn_costs, inc_truedyn_costs=inc_truedyn_costs,
            surr_trajs=surr_trajs, truedyn_trajs=truedyn_trajs,
            surr_tune_result=surr_tune_result,
        )
        controller, _, _ = pipeline(inc_cfg, task, sysid_trajs)
        return controller, tune_result
