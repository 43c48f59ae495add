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
one simulation per candidate, with a ``QuadCostFactory`` and an
``IterativeLQRFactory``: for a fixed model (kind ``"ilqr"``) the batch
is bucketed by horizon and every bucket is one
``parallel/fanout.py::QuadCostFanout`` call; for an ``MLPFactory``
(kind ``"joint_mlp"``) it is bucketed by (n_hidden_layers, nonlintype,
horizon) — with ``fanout_horizon_mask`` the horizon is the space's
upper bound and every lane solves at its own — and every bucket is one
``JointMLPQuadCostFanout`` call, which trains a net per candidate. The
true-dynamics scores take a second call with ``FunctionModel(system,
truedyn)`` as its surrogate. Every other fan-out kind of the JAX
package (the joint SINDy, ARX, Koopman and GP fan-outs, MPPI, direct
transcription), the ``"autotune"``/``"autoselect"`` surrogate modes and
``mesh`` raise ``ValueError`` by name; a pipeline
that has no fan-out at all falls back to the sequential objective with a
warning, as in the JAX package. Every tensor the tuner makes is on the
pipeline model's device.
"""

from __future__ import annotations

import os
import warnings
from collections import namedtuple

import numpy as np
import torch

from ..costs.quad_cost_factory import QuadCostFactory
from ..sysid.model import model_device
from ..utils.checkpoint import (
    bo_load_state,
    bo_state_dict,
    load_checkpoint,
    save_checkpoint,
)
from ..utils.simulation import simulate
from .bo import BatchBayesOpt

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
# its controller factory. "ilqr" and "joint_mlp" are ported.
_JOINT_KINDS = {
    "SINDyFactory": "joint_sindy", "ARXFactory": "joint_arx", "MLPFactory": "joint_mlp",
    "KoopmanFactory": "joint_koopman", "ApproximateGPModelFactory": "joint_gp",
}
_FIXED_KINDS = {
    "IterativeLQRFactory": "ilqr", "MPPIFactory": "mppi",
    "DirectTranscriptionControllerFactory": "dt",
}
# A candidate whose controller or rollout fails this way scores inf.
_PORTED_KINDS = (None, "ilqr", "joint_mlp")
_CANDIDATE_ERRORS = (np.linalg.LinAlgError, torch.linalg.LinAlgError, FloatingPointError,
                     ValueError)


def _cost_fanout_spec(cost_factory):
    """Where the per-lane diagonal costs live in the joint configuration:
    a dict with ``quad_prefix`` (the QuadCostFactory subspace's prefix
    under ``_cost:``) and ``quad_factory`` (that factory, for its goal),
    or None when the cost factory is not a ``QuadCostFactory``. The
    GaussReg and SumCost factories of the JAX package are not ported
    yet."""
    if isinstance(cost_factory, QuadCostFactory):
        return {"quad_prefix": "", "quad_factory": cost_factory}
    return None


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
        "pretrain" takes a trained one from ``run(surrogate=...)``
        ("autotune" and "autoselect" are not ported yet).

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

    def _fanout_kind(self, pipeline, surrogate):
        """``(kind, reason)``: the JAX package's fan-out kind for this
        pipeline ("ilqr", "mppi", "dt" for a fixed model; "joint_*" for
        a model factory), or None and why there is none."""
        if not self.use_fanout:
            return None, "use_fanout=False"
        if _cost_fanout_spec(pipeline.cost_factory) is None:
            return None, (
                f"cost factory is {type(pipeline.cost_factory).__name__}; the per-lane "
                "solver covers QuadCostFactory only"
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
        by horizon (kind "ilqr"), ``JointMLPQuadCostFanout`` by
        (n_hidden_layers, nonlintype, horizon) (kind "joint_mlp").
        Returns costs aligned with ``cfgs``."""
        from ..parallel.fanout import JointMLPQuadCostFanout, QuadCostFanout

        system = pipeline.system
        n_steps = (task.get_num_steps() or 200) - 1
        spec = _cost_fanout_spec(pipeline.cost_factory)
        qp = spec["quad_prefix"]
        # The goal resolves as in QuadCostFactory.__call__: the factory's
        # goal wins over the task's.
        factory_goal = spec["quad_factory"].goal
        if factory_goal is not None:
            goal = np.nan_to_num(np.asarray(factory_goal, dtype=float))
        elif task.get_cost() is not None and task.get_cost().has_goal:
            goal = np.nan_to_num(np.asarray(task.get_cost().get_goal(), dtype=float))
        else:
            goal = np.zeros(system.obs_dim)
        # Factory keyword arguments override configuration values, as in
        # ControllerFactory.__call__.
        overrides = getattr(pipeline.controller_factory, "kwargs", {})

        def horizon(cfg):
            if "horizon" in overrides:
                return int(overrides["horizon"])
            return int(cfg.get("_ctrlr:horizon", 20))

        # Model-factory hyperparameters resolve the same way
        # (ModelFactory.__call__: the factory's keyword arguments win).
        m_over = getattr(pipeline.model_factory, "kwargs", None) or {}

        def mk(cfg, name, default):
            return m_over[name] if name in m_over else cfg.get(f"_model:{name}", default)

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
            else:
                key = horizon(cfg)
            buckets.setdefault(key, []).append(idx)

        if kind == "joint_mlp":
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
                    device=device,
                )
            elif key not in fanouts:
                fanouts[key] = QuadCostFanout(
                    system, task, pipeline.model, surrogate, horizon=key, n_steps=n_steps,
                    goal=goal, compact_schedule=self.fanout_compact,
                    warm_start=self.fanout_warm_start, backward=self.fanout_backward,
                    feature_spec=fs, device=device,
                )

            def diag(suffix, names):
                return np.array([[cfgs[i].get(f"_cost:{qp}{o}_{suffix}", 0.0) for o in names]
                                 for i in idxs], dtype=float)

            batch = {
                "Qdiag": diag("Q", system.observations),
                "Fdiag": diag("F", system.observations),
                "Rdiag": diag("R", system.controls),
            }
            if kind == "joint_mlp":
                batch["widths"] = tuple(
                    tuple(int(mk(cfgs[i], f"hidden_size_{j + 1}",
                                 mk(cfgs[i], "hidden_size", 128))) for j in range(key[0]))
                    for i in idxs)
                batch["lr"] = np.array([float(mk(cfgs[i], "lr", 1e-3)) for i in idxs])
                if hmask_on:
                    batch["horizons"] = np.array([horizon(cfgs[i]) for i in idxs])
            vals = fanouts[key](batch).cpu().numpy()
            for j, i in enumerate(idxs):
                costs[i] = float(vals[j])
        return costs

    def _get_surrogate(self, pipeline, trajs, rng, surrogate_tune_iters):
        if self.surrogate_mode == "defaultcfg":
            cs = self.surrogate_factory.get_configuration_space()
            return self.surrogate_factory(cs.get_default_configuration(), trajs), None
        if self.surrogate_mode == "fixedcfg":
            return self.surrogate_factory(self.surrogate_cfg, trajs), None
        if self.surrogate_mode in ("autotune", "autoselect"):
            raise ValueError(
                f'surrogate_mode="{self.surrogate_mode}" (the surrogate tuned by '
                "ModelTuner) is not ported to autompc_torch yet"
            )
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
            except _CANDIDATE_ERRORS:
                surr_cost, info["surr_traj"], model = float("inf"), None, None
            info["surr_cost"] = surr_cost
            if truedyn is not None and model is not None:
                try:
                    info["truedyn_cost"], info["truedyn_traj"], _ = rollout_cost(
                        cfg, model=model, dynamics=truedyn)
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
