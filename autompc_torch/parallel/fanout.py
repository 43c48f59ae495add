"""Tuning fan-out: score a batch of candidate configurations in one
batched program (port of ``autompc_tpu/parallel/fanout.py``:
``QuadCostFanout``, ``JointSINDyQuadCostFanout``,
``JointKoopmanLassoQuadCostFanout``, ``JointGPQuadCostFanout``,
``JointMLPQuadCostFanout``, ``MPPIFanout`` and
``DirectTranscriptionFanout``).

For configuration families whose hyperparameters do not change tensor
shapes (cost gains), the whole candidate evaluation — controller
synthesis (an iLQR solve per closed-loop step), the closed-loop rollout
on the surrogate and the task metric — runs over the candidate batch at
once: every solve sees (B, ...) tensors and the solver's kernels. This
is what a tune spends its time in. ``JointSINDyQuadCostFanout`` also
trains a fresh SINDy model per candidate (one STLSQ threshold or Lasso
alpha a lane, on data staged once), ``JointKoopmanLassoQuadCostFanout``
a fresh Koopman (A, B) (one Lasso alpha a lane, on lifted data staged
once), ``JointGPQuadCostFanout`` an SVGP a distinct ``induce_count``
(every missing one in one padded batched training, the lanes then
carrying their bucket's cached-mean predictor), and
``JointMLPQuadCostFanout`` a fresh MLP, every lane its own masked
max-width net, before its closed loop.

Each of the five takes the JAX package's ``reg_matrix``/``reg_goal``:
the GaussRegFactory term of a SumCost candidate batch, ``regw_b (x -
mu)' S (x - mu)`` on every stage with S and mu shared and a lane's
weight ``regw`` (B,) in every batch (``_validate_regw``), solved by the
batch-major body (``make_batched_ilqr_solver``'s ``reg_matrix``).

``MPPIFanout`` and ``DirectTranscriptionFanout`` score MPPI and
direct-transcription candidates (a temperature, a noise scale and cost
gains; cost gains at one knot count) the same way, every MPC step one
batched controller update of all B lanes.

``QuadCostFanout(impl="vmap")`` scores each candidate with its own
single-lane solver instead. The device mesh of the JAX package is not
ported yet (ROADMAP.md §A). (The JAX package has no
joint ARX fan-out: its tuner trains one ARX a history bucket and rides
``QuadCostFanout``, as this one does.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import NotPortedError, default_dtype, resolve_device
from ..control.ilqr import (
    make_batched_ilqr_solver,
    make_scheduled_ilqr_solver,
    parse_schedule,
)
from ..core.trajectory import batch as traj_batch
from ..core.trajectory import zeros as traj_zeros
from ..ops.lstsq import fista_lasso, gram_stage, stlsq_gram
from ..sysid.arx import linear_pred, linear_pred_diff
from ..sysid.basis import finite_difference
from ..sysid.gp import gp_pred_core_cached, train_svgp_buckets
from ..sysid.koopman import Koopman
from ..sysid.mlp import epoch_perms, net_apply, net_apply_jac, zscore_pairs
from ..sysid.sindy import SINDy
from ..utils.simulation import rollout_scan
from .mesh import pad_to_multiple

# Candidates are padded to a multiple of this, so that ragged batch
# occupancy reuses a few batch sizes (the JAX package's pad quantum on
# one device).
PAD_QUANTUM = 8
# A candidate's cost in a staged batch: the diagonals, and the GaussReg
# weight where the batch has one.
_COST_KEYS = ("Qdiag", "Rdiag", "Fdiag", "regw")


def _lane_costs(full):
    """The solver's ``cost_params`` of a staged batch."""
    return {k: full[k] for k in _COST_KEYS if k in full}


def _validate_regw(batch, has_reg, cls_name):
    """A fan-out built with ``reg_matrix`` needs a ``regw`` (B,) lane
    array in every batch: raise by name where it is missing or of
    another shape (the JAX package's check)."""
    if not has_reg:
        return
    if "regw" not in batch:
        raise ValueError(
            f"{cls_name} was constructed with reg_matrix (GaussReg term); each eval batch "
            "must carry a 'regw' array of per-lane regularization weights, shape (B,)"
        )
    shape = tuple(np.shape(batch["regw"]))
    ref = next((v for k, v in batch.items() if k != "regw" and hasattr(v, "shape")), None)
    if len(shape) != 1:
        raise ValueError(f"{cls_name}: 'regw' must be a 1-D per-lane array of shape (B,); "
                         f"got {shape}")
    if ref is not None and shape[0] != ref.shape[0]:
        raise ValueError(f"{cls_name}: 'regw' must have shape (B,) = ({ref.shape[0]},); "
                         f"got {shape}")


def _reg_kw(reg_matrix, reg_goal):
    """The solver's keywords of the GaussReg term ({} without one)."""
    if reg_matrix is None:
        return {}
    return dict(reg_matrix=np.asarray(reg_matrix, dtype=float),
                reg_goal=None if reg_goal is None else np.asarray(reg_goal, dtype=float))


def _closed_loop_cost(task_cost, obs_seq, ctrl_seq, last_obs):
    """The task cost of closed-loop trajectories (observations before each
    step, the controls, the last observation), a non-finite total scored
    ``inf``."""
    stage = (task_cost.eval_obs_cost(torch.stack(obs_seq)).sum(0)
             + task_cost.eval_obs_cost(last_obs))
    ctrlc = task_cost.eval_ctrl_cost(torch.stack(ctrl_seq)).sum(0)
    total = stage + ctrlc + task_cost.eval_term_obs_cost(last_obs)
    return torch.where(torch.isfinite(total), total, torch.full_like(total, float("inf")))


class QuadCostFanout:
    """Evaluate a batch of diagonal quadratic-cost candidates for a fixed
    model/surrogate pair, with an iLQR controller synthesized per
    candidate.

    ``__call__(params_batch)`` takes a dict of arrays (numpy or tensors)
    with a leading batch axis, ``Qdiag (B, n)``, ``Fdiag (B, n)``,
    ``Rdiag (B, m)`` (and ``regw (B,)`` with ``reg_matrix``), and returns
    the per-candidate task cost of the closed-loop surrogate trajectory
    as a (B,) tensor; a candidate whose rollout is not finite scores
    ``inf``.

    Per closed-loop step the whole batch goes through one per-lane-cost
    iLQR solve (``make_batched_ilqr_solver(quad_cost_batch=True)``, under
    ``make_scheduled_ilqr_solver`` when ``compact_schedule`` — a
    ``"cut:frac,..."`` string or a tuple of pairs — is given).
    ``backward``, ``feature_spec``, ``fuse_ls`` and ``lanes_last`` are
    the solver's options; with a ``feature_spec`` the features whose
    coefficient columns are all zero are masked out of the kernels (the
    model is fixed for the life of the instance). ``warm_start`` shifts
    the previous step's controls into the next solve's guess.

    ``impl="vmap"`` is the JAX package's reference-shaped form: each
    candidate gets a ``QuadCost`` of its diagonals and the single-lane
    solver ``make_ilqr_solver`` (the plain Riccati recursion, the
    model's ``pred_diff_core`` or ``jacfwd``), closed-loop on the
    surrogate from the same start, the solves from a zero guess. The
    JAX package ``vmap``s that over the candidates; here it is a loop
    over them, because the solver reads its convergence on the host
    every iteration, which ``torch.func.vmap`` cannot trace. The
    solver options (``compact_schedule``, ``backward``, ``feature_spec``,
    ``warm_start``, ``fuse_ls``, ``lanes_last``) are the batched
    body's and do not apply; ``reg_matrix`` raises.

    Runs on the card unless ``device`` names another device.
    """

    def __init__(
        self,
        system,
        task,
        model,
        surrogate,
        horizon: int = 20,
        n_steps: Optional[int] = None,
        mesh=None,
        goal=None,
        impl: str = "batched",
        compact_schedule=None,
        backward: str = "scan",
        feature_spec=None,
        warm_start: bool = False,
        reg_matrix=None,
        reg_goal=None,
        fuse_ls: bool = False,
        lanes_last: bool = False,
        device=None,
    ):
        if impl not in ("batched", "vmap"):
            raise ValueError(f"impl must be 'batched' or 'vmap', got {impl!r}")
        if reg_matrix is not None and impl != "batched":
            raise ValueError("reg_matrix requires impl='batched'")
        if mesh is not None:
            raise ValueError(
                "mesh (candidates sharded over several cards) is not ported "
                "to autompc_torch yet; pass mesh=None"
            )
        self.system = system
        self.task = task
        self._has_reg = reg_matrix is not None
        self.device = resolve_device(device)
        dtype = default_dtype(self.device)
        on = dict(dtype=dtype, device=self.device)
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        task_cost = task.get_cost()
        if goal is None:
            goal = task_cost.get_goal() if task_cost is not None else np.zeros(system.obs_dim)
        bounds = task.get_ctrl_bounds()
        ds, dc, n = model.state_dim, system.ctrl_dim, system.obs_dim

        def on_device(params):
            return {k: (v.to(**on) if isinstance(v, torch.Tensor) else v)
                    for k, v in params.items()}

        model_params, surr_params = on_device(model.params), on_device(surrogate.params)
        init_obs = torch.as_tensor(np.asarray(task.get_init_obs()), **on)
        # The controller model's state at the seed observation.
        seed_traj = traj_zeros(system, 1, **on).set_obs(0, init_obs)
        mstate0 = model.traj_to_state(seed_traj)
        if impl == "vmap":
            self._eval = self._per_candidate(model, surrogate, model_params, surr_params,
                                             init_obs, mstate0, horizon, n_steps, goal, on)
            return

        solver_kw = dict(
            H=horizon, ds=ds, dc=dc, obsdim=n, dt=system.dt,
            ubounds=(bounds[:, 0], bounds[:, 1]), backward=backward,
            feature_spec=feature_spec,
            pred_diff=getattr(model, "pred_diff_core", None),
            quad_cost_batch=True, quad_goal=np.asarray(goal, dtype=float),
            fuse_ls=bool(fuse_ls and feature_spec is not None),
            lanes_last=bool(lanes_last), **_reg_kw(reg_matrix, reg_goal),
        )
        if feature_spec is not None:
            # The model is fixed, so static feature masking is sound:
            # skip the library terms whose coefficient columns the fit's
            # threshold zeroed.
            cnp = model_params[feature_spec[1]].detach().cpu().numpy()
            live = np.flatnonzero(np.any(np.abs(cnp) > 0, axis=0))
            if 0 < live.size < cnp.shape[1]:
                solver_kw["feature_mask"] = tuple(int(k) for k in live)
        if compact_schedule is not None:
            if isinstance(compact_schedule, str):
                compact_schedule = parse_schedule(compact_schedule)
            solve = make_scheduled_ilqr_solver(
                model.pred_core, None, schedule=tuple(compact_schedule), **solver_kw
            )
        else:
            solve = make_batched_ilqr_solver(model.pred_core, None, **solver_kw)
        self.solver_kw = solver_kw

        def eval_batch(cost_params):
            B = cost_params["Qdiag"].shape[0]
            obs = init_obs.expand(B, n).contiguous()
            mstate = mstate0.expand((B,) + tuple(mstate0.shape)).contiguous()
            last_u = obs.new_zeros((B, dc))
            us_prev = obs.new_zeros((B, horizon, dc))
            obs_seq, ctrl_seq = [], []
            for _ in range(n_steps):
                state = model.update_state_core(model_params, mstate, last_u, obs)
                if warm_start:
                    # Receding-horizon warm start: the previous step's
                    # solution shifted one knot.
                    uguess = torch.cat([us_prev[:, 1:], us_prev[:, -1:]], dim=1)
                else:
                    uguess = obs.new_zeros((B, horizon, dc))
                _, xs, us, Ks, _ = solve(model_params, state, uguess, cost_params)
                u = us[:, 0] + torch.einsum("bij,bj->bi", Ks[:, 0], state - xs[:, 0])
                obs_seq.append(obs)
                ctrl_seq.append(u)
                obs = surrogate.pred_core(surr_params, obs, u)[..., :n]
                mstate, last_u = state, u
                if warm_start:
                    us_prev = us
            # A non-finite rollout scores +inf: a bad configuration, and
            # the tune goes on.
            return _closed_loop_cost(task_cost, obs_seq, ctrl_seq, obs)

        def eval_padded(params_batch):
            cost_params = {
                k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                   **on)
                for k, v in params_batch.items()
            }
            padded, n_real = pad_to_multiple(cost_params, PAD_QUANTUM)
            return eval_batch(padded)[:n_real]

        self._eval = eval_padded

    def _per_candidate(self, model, surrogate, model_params, surr_params, init_obs, mstate0,
                       horizon, n_steps, goal, on):
        """``impl="vmap"``'s evaluation: a (B,) tensor of task costs, one
        single-lane closed loop a candidate."""
        from ..control.ilqr import make_ilqr_solver
        from ..costs import QuadCost

        system, task_cost = self.system, self.task.get_cost()
        n, dc, ds = system.obs_dim, system.ctrl_dim, model.state_dim
        bounds = self.task.get_ctrl_bounds()

        def eval_one(qdiag, rdiag, fdiag):
            cost = QuadCost(system, torch.diag(qdiag), torch.diag(rdiag), torch.diag(fdiag),
                            goal=goal)
            solve = make_ilqr_solver(
                model.pred_core, cost, H=horizon, ds=ds, dc=dc, obsdim=n, dt=system.dt,
                ubounds=(bounds[:, 0], bounds[:, 1]),
                pred_diff=getattr(model, "pred_diff_core", None))

            def ctrl_step(cstate, obs):
                mstate, last_u = cstate
                state = model.update_state_core(model_params, mstate, last_u, obs)
                _, xs, us, Ks, _ = solve(model_params, state, obs.new_zeros((horizon, dc)))
                u = us[0] + Ks[0] @ (state - xs[0])
                return u, (state, u)

            def advance(obs, u):
                return surrogate.pred_core(surr_params, obs, u)[:n]

            all_obs, ctrls, _ = rollout_scan(ctrl_step, advance,
                                             (mstate0, init_obs.new_zeros(dc)), init_obs,
                                             n_steps)
            total = (task_cost.eval_obs_cost(all_obs).sum()
                     + task_cost.eval_ctrl_cost(ctrls).sum()
                     + task_cost.eval_term_obs_cost(all_obs[-1]))
            return torch.where(torch.isfinite(total), total, torch.full_like(total, float("inf")))

        def eval_batch(params_batch):
            cp = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                     **on) for k, v in params_batch.items()}
            return torch.stack([eval_one(cp["Qdiag"][b], cp["Rdiag"][b], cp["Fdiag"][b])
                                for b in range(cp["Qdiag"].shape[0])])

        return eval_batch

    def __call__(self, params_batch):
        _validate_regw(params_batch, self._has_reg, type(self).__name__)
        return self._eval(params_batch)


class JointSINDyQuadCostFanout:
    """Joint tuning fan-out for SINDy-model pipelines: candidates that share
    a SINDy basis bucket (the library, the time mode and the fit method)
    and an iLQR horizon, and differ in their regularization (the STLSQ
    threshold, or the Lasso alpha for ``method="lasso"``) and diagonal
    cost gains. Each lane trains its own model on the sysid data, staged
    once as ``SINDy.train`` stages it (``ops/lstsq.py``: one Gram pair and
    a batched ``stlsq_gram``, or a batched ``fista_lasso``), and is then
    scored by the per-lane-model, per-lane-cost iLQR closed loop on the
    surrogate (``make_batched_ilqr_solver(batch_params=True,
    quad_cost_batch=True)``).

    ``__call__(batch)`` takes ``{"reg": (B,), "Qdiag": (B, n), "Rdiag":
    (B, m), "Fdiag": (B, n)}`` (and ``"regw": (B,)`` with ``reg_matrix``)
    and returns the task costs (B,); a candidate whose rollout is not
    finite scores ``inf``. Lanes are padded
    with copies of the last candidate to a multiple of 8.

    ``use_feature_kernels`` (discrete time only: the kernels compute x' =
    coeffs @ theta) gives the solver the library as its ``feature_spec``,
    so the per-lane-coefficient instances of the feature kernels run
    (batch-major: K1's batch-major entry and K7; ``lanes_last`` with
    ``fuse_ls``: K1 and K3); a continuous-time bucket, or none, takes the
    autodiff relinearization and the plain rollouts. The whole library
    rides the kernels, since every lane has its own sparsity.
    ``mesh`` raises. Runs on the card unless ``device`` names another
    device.
    """

    def __init__(
        self,
        system,
        task,
        sindy_cfg: dict,
        sysid_trajs,
        surrogate,
        horizon: int = 20,
        n_steps: Optional[int] = None,
        mesh=None,
        goal=None,
        compact_schedule=None,
        warm_start: bool = False,
        backward: str = "scan",
        use_feature_kernels: bool = False,
        fuse_ls: bool = False,
        reg_matrix=None,
        reg_goal=None,
        lanes_last: bool = False,
        device=None,
    ):
        if mesh is not None:
            raise ValueError(
                "mesh (candidates sharded over several cards) is not ported "
                "to autompc_torch yet; pass mesh=None"
            )
        self._has_reg = reg_matrix is not None
        self.system, self.surrogate = system, surrogate
        self.device = resolve_device(device)
        on = dict(dtype=default_dtype(self.device), device=self.device)
        n, dc, dt = system.obs_dim, system.ctrl_dim, system.dt
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        task_cost = task.get_cost()
        if goal is None:
            goal = task_cost.get_goal() if task_cost is not None else np.zeros(n)
        bounds = task.get_ctrl_bounds()
        init_obs = torch.as_tensor(np.asarray(task.get_init_obs()), **on)

        skeleton = SINDy(system, device=self.device, **sindy_cfg)
        library = skeleton.library
        self.library, self.time_mode, self.method = library, skeleton.time_mode, skeleton.method
        self.n_features = library.n_features

        # The training matrices, staged once as SINDy.train stages them:
        # features over the sysid data, next-observation targets
        # (discrete) or finite-difference derivatives (continuous).
        tb = traj_batch(sysid_trajs)
        obs, ctrls = tb.obs.to(**on), tb.ctrls.to(**on)
        feats = library(torch.cat([obs, ctrls], dim=-1))
        if self.time_mode == "continuous":
            targets = finite_difference(obs.transpose(0, 1), dt).transpose(0, 1)
            mask = tb.mask()
        else:
            targets = torch.roll(obs, -1, dims=1)
            mask = tb.step_mask()
        self._A = feats.reshape(-1, library.n_features)
        self._y = targets.reshape(-1, n)
        self._rmask = mask.reshape(-1).to(self.device)
        if self.method != "lasso":
            self._G, self._b = gram_stage(self._A, self._y, mask=self._rmask)

        continuous = self.time_mode == "continuous"

        def pred_core(params, state, ctrl):
            theta = library(torch.cat([state, ctrl], dim=-1))
            C = params["coeffs"]
            if C.ndim == 2:      # one lane's model (the autodiff relinearization)
                out = theta @ C.T
            else:                # (B, n, F): lane b's rows through lane b's model
                out = torch.einsum("b...f,bnf->b...n", theta, C)
            return state + dt * out if continuous else out

        feature_spec = (
            (library, "coeffs") if use_feature_kernels and not continuous else None
        )
        solver_kw = dict(
            H=horizon, ds=n, dc=dc, obsdim=n, dt=dt,
            ubounds=(bounds[:, 0], bounds[:, 1]), backward=backward,
            feature_spec=feature_spec, batch_params=True, quad_cost_batch=True,
            quad_goal=np.asarray(goal, dtype=float),
            fuse_ls=bool(fuse_ls and feature_spec is not None),
            lanes_last=bool(lanes_last), **_reg_kw(reg_matrix, reg_goal),
        )
        if compact_schedule is not None:
            if isinstance(compact_schedule, str):
                compact_schedule = parse_schedule(compact_schedule)
            solve = make_scheduled_ilqr_solver(
                pred_core, None, schedule=tuple(compact_schedule), **solver_kw)
        else:
            solve = make_batched_ilqr_solver(pred_core, None, **solver_kw)
        self.solver_kw = solver_kw
        self._pred_core = pred_core
        surr_params = {k: (v.to(**on) if isinstance(v, torch.Tensor) else v)
                       for k, v in surrogate.params.items()}

        def closed_loop(coeffs, cost_params):
            B = coeffs.shape[0]
            params = {"coeffs": coeffs}
            obs = init_obs.expand(B, n).contiguous()
            us_prev = obs.new_zeros((B, horizon, dc))
            obs_seq, ctrl_seq = [], []
            for _ in range(n_steps):
                if warm_start:
                    uguess = torch.cat([us_prev[:, 1:], us_prev[:, -1:]], dim=1)
                else:
                    uguess = obs.new_zeros((B, horizon, dc))
                _, xs, us, Ks, _ = solve(params, obs, uguess, cost_params)
                u = us[:, 0] + torch.einsum("bij,bj->bi", Ks[:, 0], obs - xs[:, 0])
                obs_seq.append(obs)
                ctrl_seq.append(u)
                obs = surrogate.pred_core(surr_params, obs, u)[..., :n]
                if warm_start:
                    us_prev = us
            return _closed_loop_cost(task_cost, obs_seq, ctrl_seq, obs)

        self._closed_loop = closed_loop
        self._on = on

    def _stage(self, batch):
        """The candidate batch as tensors on the device, padded (copies of
        the last candidate) to a multiple of ``PAD_QUANTUM``; returns
        (padded, number of candidates)."""
        staged = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                     **self._on)
                  for k, v in batch.items() if k in ("reg", *_COST_KEYS)}
        return pad_to_multiple(staged, PAD_QUANTUM)

    def train_lanes(self, reg):
        """Every lane's model: coefficients (B, n, F) fitted with the
        lane's regularizer ``reg`` (B,) (the STLSQ threshold, or the
        Lasso alpha)."""
        if self.method == "lasso":
            coefs = fista_lasso(self._A, self._y, reg, mask=self._rmask)
        else:
            coefs = stlsq_gram(self._G, self._b, reg)
        return coefs.mT.contiguous()

    def closed_loop(self, coeffs, cost_params):
        """The task costs (B,) of the lanes' closed loops on the surrogate,
        lane b solving with model ``coeffs[b]`` (n, F) under its cost
        diagonals ``cost_params`` (Qdiag, Rdiag, Fdiag; regw with the
        GaussReg term)."""
        return self._closed_loop(coeffs, cost_params)

    def __call__(self, batch):
        _validate_regw(batch, self._has_reg, type(self).__name__)
        full, B = self._stage(batch)
        coeffs = self.train_lanes(full["reg"])
        return self.closed_loop(coeffs, _lane_costs(full))[:B]


class JointKoopmanLassoQuadCostFanout:
    """Joint tuning fan-out for Koopman(method="lasso") pipelines:
    candidates that share a basis bucket and an iLQR horizon, and differ
    in their Lasso alpha and diagonal cost gains. The lifted transitions
    of the sysid data are staged once (``Koopman.train``'s X, U, Y), every
    lane trains its own (A, B) through one batched ``fista_lasso`` (an
    alpha a lane), and the lanes' closed loops then run the per-lane-model,
    per-lane-cost iLQR in the lifted state (ds = the lifted dimension,
    ``batch_params=True``, the closed-form Jacobian (A, B)), the state
    lifted again from the surrogate's observation at every MPC step. The
    cost, its goal and the GaussReg term (``reg_matrix``) act on the first
    n lifted dimensions, the observation (``obsdim = n``). (The lstsq and
    stable fits have no per-lane hyperparameter: the tuner trains one
    model a bucket and rides ``QuadCostFanout`` instead.)

    ``__call__(batch)`` takes ``{"reg": (B,) alphas, "Qdiag": (B, n),
    "Rdiag": (B, m), "Fdiag": (B, n)}`` (and ``"regw": (B,)`` with
    ``reg_matrix``) and returns the task costs (B,); a candidate whose
    rollout is not finite scores ``inf``. Lanes are padded with copies of
    the last candidate to a multiple of 8. ``backward="pallas"`` takes K6
    (``ops/cuda_riccati.py::backward_quad``; prebuilt at ds = 4 and 12,
    another lift to ds = 23 built at first use, a wider one up to
    ``_build.BQBM_BIG_MAX_DS`` the wide instance) on the card, the general
    kernel with ``reg_matrix`` (past ds = 23 its wide instance, up to
    ``_build.RG_BIG_MAX_DS``); every lift of the cartpole's and the
    pendulum's Koopman spaces (up to 96) is taken, a wider one raises
    ``NotPortedError``. ``mesh`` raises. Runs on the card unless
    ``device`` names another device.
    """

    def __init__(
        self,
        system,
        task,
        koopman_cfg: dict,
        sysid_trajs,
        surrogate,
        horizon: int = 20,
        n_steps: Optional[int] = None,
        mesh=None,
        goal=None,
        compact_schedule=None,
        warm_start: bool = False,
        backward: str = "scan",
        reg_matrix=None,
        reg_goal=None,
        device=None,
    ):
        if mesh is not None:
            raise ValueError(
                "mesh (candidates sharded over several cards) is not ported "
                "to autompc_torch yet; pass mesh=None"
            )
        self._has_reg = reg_matrix is not None
        self.device = resolve_device(device)
        on = dict(dtype=default_dtype(self.device), device=self.device)
        n, dc = system.obs_dim, system.ctrl_dim
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        task_cost = task.get_cost()
        if goal is None:
            goal = task_cost.get_goal() if task_cost is not None else np.zeros(n)
        bounds = task.get_ctrl_bounds()
        init_obs = torch.as_tensor(np.asarray(task.get_init_obs()), **on)

        skeleton = Koopman(system, method="lasso", lasso_alpha=1.0, device=self.device,
                           **koopman_cfg)
        lift = skeleton._apply_basis
        N = self.state_dim = skeleton.state_dim
        X, Y, U = (t.to(**on) for t in skeleton.lifted_transitions(sysid_trajs))
        self._XU, self._Y = torch.cat([X, U], dim=1), Y        # (S, N+m), (S, N)

        solver_kw = dict(
            H=horizon, ds=N, dc=dc, obsdim=n, dt=system.dt,
            ubounds=(bounds[:, 0], bounds[:, 1]), backward=backward,
            batch_params=True, quad_cost_batch=True, quad_goal=np.asarray(goal, dtype=float),
            pred_diff=linear_pred_diff, **_reg_kw(reg_matrix, reg_goal),
        )
        if compact_schedule is not None:
            if isinstance(compact_schedule, str):
                compact_schedule = parse_schedule(compact_schedule)
            solve = make_scheduled_ilqr_solver(
                linear_pred, None, schedule=tuple(compact_schedule), **solver_kw)
        else:
            solve = make_batched_ilqr_solver(linear_pred, None, **solver_kw)
        self.solver_kw = solver_kw
        surr_params = {k: (v.to(**on) if isinstance(v, torch.Tensor) else v)
                       for k, v in surrogate.params.items()}

        def closed_loop(params, cost_params):
            B = params["A"].shape[0]
            obs = init_obs.expand(B, n).contiguous()
            us_prev = obs.new_zeros((B, horizon, dc))
            obs_seq, ctrl_seq = [], []
            for _ in range(n_steps):
                state = lift(obs)
                if warm_start:
                    uguess = torch.cat([us_prev[:, 1:], us_prev[:, -1:]], dim=1)
                else:
                    uguess = obs.new_zeros((B, horizon, dc))
                _, xs, us, Ks, _ = solve(params, state, uguess, cost_params)
                u = us[:, 0]
                obs_seq.append(obs)
                ctrl_seq.append(u)
                obs = surrogate.pred_core(surr_params, obs, u)[..., :n]
                if warm_start:
                    us_prev = us
            return _closed_loop_cost(task_cost, obs_seq, ctrl_seq, obs)

        self._closed_loop = closed_loop
        self._on = on

    def train_lanes(self, reg):
        """Every lane's (A (B, N, N), B (B, N, m)), fitted with the lane's
        Lasso alpha ``reg`` (B,)."""
        AB = fista_lasso(self._XU, self._Y, reg).mT            # (B, N, N+m)
        N = self.state_dim
        return {"A": AB[..., :N].contiguous(), "B": AB[..., N:].contiguous()}

    def closed_loop(self, params, cost_params):
        """The task costs (B,) of the lanes' closed loops on the surrogate,
        lane b solving with (params["A"][b], params["B"][b]) under its cost
        diagonals ``cost_params`` (regw with the GaussReg term)."""
        return self._closed_loop(params, cost_params)

    def __call__(self, batch):
        _validate_regw(batch, self._has_reg, type(self).__name__)
        staged = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                     **self._on)
                  for k, v in batch.items() if k in ("reg", *_COST_KEYS)}
        full, B = pad_to_multiple(staged, PAD_QUANTUM)
        return self.closed_loop(self.train_lanes(full["reg"]), _lane_costs(full))[:B]


class JointGPQuadCostFanout:
    """Joint tuning fan-out for ApproximateGP pipelines: candidates that
    share an iLQR horizon and differ in ``induce_count`` (the GP's only
    hyperparameter) and diagonal cost gains. Every distinct
    ``induce_count`` trains once, all missing ones in one
    ``train_svgp_buckets`` call at ``pad_to`` inducing points (exact
    no-op padding, so each bucket is the model ``ApproximateGPModel``
    trains alone with the same data and seed), and the trained buckets
    are kept across calls. The closed loop then gives every lane its
    bucket's cached-mean predictor (``gp_pred_core_cached`` with per-lane
    ``gp``, ``w`` and the shared z-scoring) in the per-lane-model,
    per-lane-cost iLQR (``batch_params=True``, ``quad_cost_batch=True``),
    linearized by ``torch.func.jacfwd`` of the predictor
    (``jacfwd_pred_diff``), so a batch that mixes any number of
    ``induce_count``s is one batched solve a closed-loop step.

    ``gp_cfg`` holds the GP's ``niter``, ``lr``, ``batch_size`` and
    ``seed``; ``pad_to`` (default 200, the space's largest count) is cut
    to the number of training pairs. ``__call__(batch)`` takes
    ``{"induce_count": (B,) ints, "Qdiag": (B, n), "Rdiag": (B, m),
    "Fdiag": (B, n)}`` (and ``"regw": (B,)`` with ``reg_matrix``) and
    returns the task costs (B,); a candidate whose rollout is not finite
    (a bucket whose float32 Cholesky failed, say) scores ``inf``. Lanes
    are padded with copies of the last candidate to a multiple of 8.
    ``backward="pallas"`` takes K6 on the card (ds = 4, dc = 1), the
    general kernel with ``reg_matrix``. ``block_b`` is a choice of the
    TPU kernels and is ignored; ``mesh`` raises. Runs on the card unless
    ``device`` names another device.
    """

    def __init__(
        self,
        system,
        task,
        gp_cfg: dict,
        sysid_trajs,
        surrogate,
        horizon: int = 20,
        n_steps: Optional[int] = None,
        mesh=None,
        goal=None,
        compact_schedule=None,
        warm_start: bool = False,
        backward: str = "scan",
        block_b: int = 128,
        reg_matrix=None,
        reg_goal=None,
        pad_to: Optional[int] = None,
        device=None,
    ):
        del block_b
        if mesh is not None:
            raise NotPortedError(
                "mesh (candidates sharded over several cards) is not ported "
                "to autompc_torch yet; pass mesh=None"
            )
        self._has_reg = reg_matrix is not None
        self.system = system
        self._gp_cfg = dict(gp_cfg)
        self._trajs = sysid_trajs
        self.device = resolve_device(device)
        on = dict(dtype=default_dtype(self.device), device=self.device)
        self._on = on
        n, dc = system.obs_dim, system.ctrl_dim
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        task_cost = task.get_cost()
        if goal is None:
            goal = task_cost.get_goal() if task_cost is not None else np.zeros(n)
        bounds = task.get_ctrl_bounds()
        init_obs = torch.as_tensor(np.asarray(task.get_init_obs()), **on)
        n_total = int(traj_batch(sysid_trajs).step_mask().sum())
        # One padded inducing count for every bucket (the space tops out
        # at 200).
        self.pad_to = int(min(pad_to or 200, n_total))
        self.buckets = {}  # induce_count -> {"gp", "w", and the z-scoring}

        solver_kw = dict(
            H=horizon, ds=n, dc=dc, obsdim=n, dt=system.dt,
            ubounds=(bounds[:, 0], bounds[:, 1]), backward=backward,
            batch_params=True, quad_cost_batch=True, quad_goal=np.asarray(goal, dtype=float),
            **_reg_kw(reg_matrix, reg_goal),
        )
        if compact_schedule is not None:
            if isinstance(compact_schedule, str):
                compact_schedule = parse_schedule(compact_schedule)
            solve = make_scheduled_ilqr_solver(
                gp_pred_core_cached, None, schedule=tuple(compact_schedule), **solver_kw)
        else:
            solve = make_batched_ilqr_solver(gp_pred_core_cached, None, **solver_kw)
        self.solver_kw = solver_kw
        surr_params = {k: (v.to(**on) if isinstance(v, torch.Tensor) else v)
                       for k, v in surrogate.params.items()}

        def closed_loop(params, cost_params):
            B = cost_params["Qdiag"].shape[0]
            obs = init_obs.expand(B, n).contiguous()
            us_prev = obs.new_zeros((B, horizon, dc))
            obs_seq, ctrl_seq = [], []
            for _ in range(n_steps):
                if warm_start:
                    uguess = torch.cat([us_prev[:, 1:], us_prev[:, -1:]], dim=1)
                else:
                    uguess = obs.new_zeros((B, horizon, dc))
                _, _, us, _, _ = solve(params, obs, uguess, cost_params)
                u = us[:, 0]
                obs_seq.append(obs)
                ctrl_seq.append(u)
                obs = surrogate.pred_core(surr_params, obs, u)[..., :n]
                if warm_start:
                    us_prev = us
            return _closed_loop_cost(task_cost, obs_seq, ctrl_seq, obs)

        self._closed_loop = closed_loop

    def ensure_buckets(self, counts):
        """Train every ``induce_count`` of ``counts`` not trained yet, in
        one ``train_svgp_buckets`` call."""
        missing = sorted({int(m) for m in counts} - set(self.buckets))
        if not missing:
            return
        cfg = self._gp_cfg
        params, w, norm = train_svgp_buckets(
            self.system, self._trajs, missing, niter=int(cfg.get("niter", 5)),
            lr=float(cfg.get("lr", 0.1)), batch_size=int(cfg.get("batch_size", 1024)),
            seed=int(cfg.get("seed", 100)), pad_to=self.pad_to, device=self.device)
        for k, M in enumerate(missing):
            self.buckets[M] = {"gp": {name: v[k] for name, v in params.items()}, "w": w[k],
                               **norm}

    def lane_params(self, counts):
        """The per-lane predictor params of lanes with these
        ``induce_count``s: every tensor of their buckets gathered to a
        leading lane axis."""
        self.ensure_buckets(counts)
        order = sorted({int(m) for m in counts})
        idx = torch.as_tensor([order.index(int(m)) for m in counts], device=self.device)

        def gather(get):
            return torch.stack([get(self.buckets[m]) for m in order])[idx]

        out = {"gp": {k: gather(lambda b, k=k: b["gp"][k]) for k in self.buckets[order[0]]["gp"]}}
        for k in ("w", "xu_means", "xu_std", "dy_means", "dy_std"):
            out[k] = gather(lambda b, k=k: b[k])
        return out

    def closed_loop(self, params, cost_params):
        """The task costs (B,) of the lanes' closed loops on the surrogate,
        lane b solving with the predictor ``params`` of its lane under its
        cost diagonals ``cost_params`` (regw with the GaussReg term)."""
        return self._closed_loop(params, cost_params)

    def __call__(self, batch):
        _validate_regw(batch, self._has_reg, type(self).__name__)
        staged = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                     **self._on)
                  for k, v in batch.items() if k in _COST_KEYS}
        staged["induce_count"] = torch.as_tensor(np.asarray(batch["induce_count"], dtype=np.int64))
        full, B = pad_to_multiple(staged, PAD_QUANTUM)
        params = self.lane_params(full["induce_count"].tolist())
        return self.closed_loop(params, _lane_costs(full))[:B]


def scale_by_adam(grad, mu, nu, count, b1=0.9, b2=0.999, eps=1e-8):
    """optax's ``scale_by_adam`` (eps_root 0) at step ``count`` (1 for
    the first): updates the moments ``mu``, ``nu`` in place and returns
    the bias-corrected ``mu_hat / (sqrt(nu_hat) + eps)``."""
    mu.mul_(b1).add_(grad, alpha=1.0 - b1)
    nu.mul_(b2).addcmul_(grad, grad, value=1.0 - b2)
    return (mu / (1.0 - b1 ** count)) / ((nu / (1.0 - b2 ** count)).sqrt_() + eps)


def train_lanes(net0, wmasks, bmasks, lr, XUt, dYt, perms, n_batch, nonlin):
    """Adam on the mean Huber loss (delta 1) for every lane's masked
    max-width net at once: ``net0``, ``wmasks``, ``bmasks`` are lists
    of per-layer (B, ...) tensors, ``lr`` (B,) the lanes' learning
    rates; each epoch takes the rows of its index tensor of ``perms``
    (shared by every lane) in consecutive batches of ``n_batch``. The
    masks multiply the weights inside the forward pass, so a masked
    entry's gradient is exactly zero and each lane trains as its
    unpadded net. Returns the trained nets as ``[{"W", "b"}, ...]``."""
    B = lr.shape[0]
    leaves = [t for layer in net0 for t in (layer["W"], layer["b"])]
    shapes = [tuple(t.shape[1:]) for t in leaves]
    sizes = [int(np.prod(sh)) for sh in shapes]
    # One flat (B, P) buffer a lane: the moments and the update are a few
    # operations a step whatever the depth.
    flat = torch.cat([t.reshape(B, -1) for t in leaves], 1).clone().requires_grad_(True)
    mask = torch.cat([m.reshape(B, -1) for wm, bm in zip(wmasks, bmasks) for m in (wm, bm)], 1)
    mu, nu = torch.zeros_like(flat), torch.zeros_like(flat)
    lr_col = lr[:, None]

    def layers(v):
        parts = [x.reshape((B,) + sh) for x, sh in zip(torch.split(v, sizes, 1), shapes)]
        return [{"W": W, "b": b} for W, b in zip(parts[0::2], parts[1::2])]

    count = 0
    for perm in perms:
        xb = XUt[perm].reshape(-1, n_batch, XUt.shape[1])
        yb = dYt[perm].reshape(-1, n_batch, dYt.shape[1])
        for x, y in zip(xb, yb):
            count += 1
            pred = net_apply(layers(flat * mask), x.expand(B, -1, -1), nonlin)
            loss = torch.nn.functional.huber_loss(
                pred, y.expand(B, -1, -1), reduction="none", delta=1.0).mean(dim=(1, 2))
            (grad,) = torch.autograd.grad(loss.sum(), flat)
            with torch.no_grad():
                flat.sub_(lr_col * scale_by_adam(grad, mu, nu, count))
    return [{k: v.detach() for k, v in layer.items()} for layer in layers(flat)]


class JointMLPQuadCostFanout:
    """Joint tuning fan-out for MLP-model pipelines: candidates that share
    an (n_hidden_layers, nonlintype, horizon) bucket and differ in hidden
    widths, learning rate and diagonal cost gains. Each lane trains its
    own MLP — the whole Adam run of ``MLP.train``, as a masked
    ``max_width`` net (``train_lanes``) — and is then scored by the
    per-lane-model, per-lane-cost iLQR closed loop on the surrogate
    (``make_batched_ilqr_solver(batch_params=True, quad_cost_batch=True)``
    with the nets' closed-form Jacobian).

    ``__call__(batch)`` takes ``{"widths": ((w1, ..), ...) hidden sizes
    a candidate, "lr": (B,), "Qdiag": (B, n), "Rdiag": (B, m), "Fdiag":
    (B, n)}`` (and ``"horizons"`` (B,) with ``horizon_mask``, ``"regw"``
    (B,) with ``reg_matrix``) and returns
    the task costs (B,); a candidate whose rollout is not finite scores
    ``inf``. With ``horizon_mask`` ``horizon`` is the largest horizon and
    every lane solves at its own (``make_batched_ilqr_solver``'s
    ``horizon_mask``). Lanes are padded, with copies of the last
    candidate, to a multiple of 8 and to at least ``pad_to``, so that a
    tuner's buckets reuse a few batch sizes.

    Every lane starts from the net ``MLP`` draws for ``seed`` at its true
    sizes (``tuning/bucketed.py::_mlp_padded_init``) and takes the
    epoch orders ``MLP.train`` takes for ``seed``
    (``sysid/mlp.py::epoch_perms``), so a lane trains as
    ``MLPFactory``'s model of its configuration; ``init_nets`` and
    ``perms`` of ``__call__`` replace them. ``block_b`` is a choice of
    the TPU kernels and is ignored; ``mesh`` raises. Runs on the card
    unless ``device`` names another device.
    """

    def __init__(
        self,
        system,
        task,
        mlp_bucket: dict,
        sysid_trajs,
        surrogate,
        horizon: int = 20,
        n_steps: Optional[int] = None,
        mesh=None,
        goal=None,
        compact_schedule=None,
        warm_start: bool = False,
        backward: str = "scan",
        block_b: int = 128,
        reg_matrix=None,
        reg_goal=None,
        max_width: int = 256,
        n_train_iters: int = 50,
        n_batch: int = 64,
        seed: int = 100,
        horizon_mask: bool = False,
        pad_to: Optional[int] = None,
        device=None,
    ):
        del block_b
        if mesh is not None:
            raise ValueError(
                "mesh (candidates sharded over several cards) is not ported "
                "to autompc_torch yet; pass mesh=None"
            )
        self._has_reg = reg_matrix is not None
        self.system = system
        self.device = resolve_device(device)
        dtype = default_dtype(self.device)
        on = dict(dtype=dtype, device=self.device)
        self._on = on
        n, dc = system.obs_dim, system.ctrl_dim
        self._nx, self._nxu = n, n + dc
        self._max_width = int(max_width)
        self._L = int(mlp_bucket["n_hidden_layers"])
        self._nonlin = str(mlp_bucket["nonlintype"])
        self._seed = int(seed)
        self._n_batch = int(n_batch)
        self._n_train_iters = int(n_train_iters)
        self._horizon_mask = bool(horizon_mask)
        self._pad_to = int(pad_to) if pad_to else None
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        task_cost = task.get_cost()
        if goal is None:
            goal = task_cost.get_goal() if task_cost is not None else np.zeros(n)
        bounds = task.get_ctrl_bounds()
        init_obs = torch.as_tensor(np.asarray(task.get_init_obs()), **on)

        # The training pairs, staged and z-scored as MLP.train does.
        XUt, dYt, norm = zscore_pairs(sysid_trajs)
        self._XUt, self._dYt = XUt.to(**on), dYt.to(**on)
        xu_means, xu_std, dy_means, dy_std = (v.to(**on) for v in norm)
        nonlin = self._nonlin

        def pred_core(params, state, ctrl):
            xut = (torch.cat([state, ctrl], dim=-1) - xu_means) / xu_std
            dyt = net_apply(params["net"], xut, nonlin)
            return state + (dyt * dy_std + dy_means)

        eye = torch.eye(n, **on)

        def pred_diff(params, state, ctrl):
            # The masks are folded into the weights (``params["net"]``),
            # so the per-lane closed-form chain is net_apply_jac's.
            xut = (torch.cat([state, ctrl], dim=-1) - xu_means) / xu_std
            dyt, Jt = net_apply_jac(params["net"], xut, nonlin)
            Jm = (dy_std[:, None] * Jt) / xu_std[None, :]
            pred = state + (dyt * dy_std + dy_means)
            return pred, eye + Jm[..., :n], Jm[..., n:]

        solver_kw = dict(
            H=horizon, ds=n, dc=dc, obsdim=n, dt=system.dt,
            ubounds=(bounds[:, 0], bounds[:, 1]), backward=backward,
            batch_params=True, quad_cost_batch=True,
            quad_goal=np.asarray(goal, dtype=float), pred_diff=pred_diff,
            horizon_mask=self._horizon_mask, **_reg_kw(reg_matrix, reg_goal),
        )
        if compact_schedule is not None:
            if isinstance(compact_schedule, str):
                compact_schedule = parse_schedule(compact_schedule)
            solve = make_scheduled_ilqr_solver(
                pred_core, None, schedule=tuple(compact_schedule), **solver_kw)
        else:
            solve = make_batched_ilqr_solver(pred_core, None, **solver_kw)
        self.solver_kw = solver_kw
        self._pred_core = pred_core
        surr_params = {k: (v.to(**on) if isinstance(v, torch.Tensor) else v)
                       for k, v in surrogate.params.items()}

        def eval_batch(full, nets):
            B = full["lr"].shape[0]
            params, cost_params = self._solver_inputs(full, nets)
            obs = init_obs.expand(B, n).contiguous()
            us_prev = obs.new_zeros((B, horizon, dc))
            obs_seq, ctrl_seq = [], []
            for _ in range(n_steps):
                if warm_start:
                    uguess = torch.cat([us_prev[:, 1:], us_prev[:, -1:]], dim=1)
                else:
                    uguess = obs.new_zeros((B, horizon, dc))
                _, _, us, _, _ = solve(params, obs, uguess, cost_params)
                u = us[:, 0]
                obs_seq.append(obs)
                ctrl_seq.append(u)
                obs = surrogate.pred_core(surr_params, obs, u)[..., :n]
                if warm_start:
                    us_prev = us
            return _closed_loop_cost(task_cost, obs_seq, ctrl_seq, obs)

        self._eval = eval_batch

    def _prepare(self, batch, init_nets=None):
        """Stage a candidate batch: the lanes padded (copies of the last
        candidate) to a multiple of ``PAD_QUANTUM`` and at least
        ``pad_to``, each lane's initial max-width net and masks from its
        widths. ``init_nets`` (a list of per-layer ``{"W", "b"}`` arrays
        of the B candidates' padded nets) replaces the initial nets.
        Returns (the staged dict, B)."""
        from ..tuning.bucketed import _mlp_lanes

        _validate_regw(batch, self._has_reg, type(self).__name__)
        on = self._on
        widths_list = [list(w) for w in batch["widths"]]
        B = len(widths_list)
        q = PAD_QUANTUM
        target = -(-B // q) * q
        if self._pad_to is not None:
            target = max(target, -(-self._pad_to // q) * q)

        def pad(a):
            a = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                                device=self.device)
            a = a.to(on["dtype"]) if a.is_floating_point() else a
            return torch.cat([a, a[-1:].expand((target - B,) + a.shape[1:])]) if target > B else a

        widths_list += [widths_list[-1]] * (target - B)
        if init_nets is not None:
            init_nets = [{k: pad(layer[k]) for k in ("W", "b")} for layer in init_nets]
        net0, wmasks, bmasks = _mlp_lanes(widths_list, self._nxu, self._nx, self._max_width,
                                          self._seed, on, init_nets)
        full = {
            "net0": net0, "wmasks": wmasks, "bmasks": bmasks,
            "lr": pad(batch["lr"]),
            "Qdiag": pad(batch["Qdiag"]), "Rdiag": pad(batch["Rdiag"]),
            "Fdiag": pad(batch["Fdiag"]),
        }
        if "regw" in batch:
            full["regw"] = pad(batch["regw"])
        if self._horizon_mask:
            full["horizons"] = pad(np.asarray(batch["horizons"], dtype=np.int64))
        return full, B

    def _solver_inputs(self, full, nets):
        """The closed loop's solver inputs for the staged batch ``full``
        and its trained ``nets``: the per-lane params (the masks folded
        into the weights) and cost params."""
        params = {"net": [{"W": la["W"] * wm, "b": la["b"] * bm} for la, wm, bm in
                          zip(nets, full["wmasks"], full["bmasks"])]}
        cost_params = _lane_costs(full)
        if self._horizon_mask:
            cost_params["heff"] = full["horizons"]
        return params, cost_params

    def _train(self, full, perms=None):
        if perms is None:
            perms = epoch_perms(self._XUt.shape[0], self._n_batch, self._n_train_iters,
                                self._seed, self.device)
        else:
            perms = [torch.as_tensor(np.asarray(p), device=self.device) for p in perms]
        return train_lanes(full["net0"], full["wmasks"], full["bmasks"], full["lr"],
                           self._XUt, self._dYt, perms, self._n_batch, self._nonlin)

    def __call__(self, batch, init_nets=None, perms=None):
        full, B = self._prepare(batch, init_nets)
        return self._eval(full, self._train(full, perms))[:B]

    def _train_only(self, batch, init_nets=None, perms=None):
        """Per-lane training alone (no closed loop): the trained nets of
        every padded lane."""
        full, _ = self._prepare(batch, init_nets)
        return self._train(full, perms)


def _fixed_model_setup(system, task, model, surrogate, device):
    """What a fixed-model fan-out closes its loop with: (device, dtype
    and device keywords, the model's and the surrogate's params there,
    the start observation, the model's state at it)."""
    dev = resolve_device(device)
    on = dict(dtype=default_dtype(dev), device=dev)

    def on_device(params):
        return {k: (v.to(**on) if isinstance(v, torch.Tensor) else v)
                for k, v in params.items()}

    init_obs = torch.as_tensor(np.asarray(task.get_init_obs()), **on)
    mstate0 = model.traj_to_state(traj_zeros(system, 1, **on).set_obs(0, init_obs))
    return dev, on, on_device(model.params), on_device(surrogate.params), init_obs, mstate0


def _episode_cost(task_cost, all_obs, ctrls):
    """The task cost of closed-loop episodes: obs (n+1, B, n_obs) (every
    observation, the last one too), ctrls (n, B, m); a non-finite total
    scored ``inf``."""
    total = (task_cost.eval_obs_cost(all_obs).sum(0) + task_cost.eval_ctrl_cost(ctrls).sum(0)
             + task_cost.eval_term_obs_cost(all_obs[-1]))
    return torch.where(torch.isfinite(total), total, torch.full_like(total, float("inf")))


def _stage_batch(params_batch, keys, on):
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v, **on)
            for k, v in params_batch.items() if k in keys}


class DirectTranscriptionFanout:
    """Evaluate a batch of diagonal quadratic-cost candidates, each with a
    direct-transcription (SQP) controller, for a fixed model/surrogate
    pair. ``horizon_knots`` is the knot count (the factory's horizon is
    in seconds: ``control/nmpc.py::knot_count``), one fan-out a knot
    count.

    ``__call__(batch)`` takes ``Qdiag`` (B, n), ``Rdiag`` (B, m),
    ``Fdiag`` (B, n) (and ``regw`` (B,) with ``reg_matrix``, the GaussReg
    term of a SumCost candidate) and returns the task costs (B,) of the
    closed loops on the surrogate; a non-finite one scores ``inf``. Every
    MPC step is one SQP solve of all B lanes (``make_sqp_solver`` with
    per-lane costs), with the task's observation bounds and the model
    differentiated by ``torch.func.jacfwd``, as in the JAX package; each
    solve starts from the previous step's solution. ``mesh`` raises.
    Runs on the card unless ``device`` names another device.
    """

    def __init__(self, system, task, model, surrogate, horizon_knots: int = 20,
                 n_steps: Optional[int] = None, mesh=None, goal=None, reg_matrix=None,
                 reg_goal=None, device=None):
        from ..control.nmpc import make_sqp_solver

        if mesh is not None:
            raise ValueError(
                "mesh (candidates sharded over several cards) is not ported to "
                "autompc_torch yet; pass mesh=None"
            )
        self._has_reg = reg_matrix is not None
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        task_cost = task.get_cost()
        if goal is None:
            goal = task_cost.get_goal() if task_cost is not None else np.zeros(system.obs_dim)
        bounds = task.get_ctrl_bounds()
        H, ds, dc, n = int(horizon_knots), model.state_dim, system.ctrl_dim, system.obs_dim
        self.device, on, model_params, surr_params, init_obs, mstate0 = _fixed_model_setup(
            system, task, model, surrogate, device)
        ob = task.get_obs_bounds()
        solve = make_sqp_solver(
            model.pred_core, None, H=H, ds=ds, dc=dc, obsdim=n, dt=system.dt,
            ubounds=(np.where(np.isfinite(bounds[:, 0]), bounds[:, 0], -1e9),
                     np.where(np.isfinite(bounds[:, 1]), bounds[:, 1], 1e9)),
            xbounds=(ob[:, 0], ob[:, 1]) if task.are_obs_bounded() else None,
            quad_cost_batch=True, quad_goal=np.asarray(goal, dtype=float),
            **_reg_kw(reg_matrix, reg_goal),
        )

        def eval_batch(cp):
            B = cp["Qdiag"].shape[0]

            def ctrl_step(cstate, obs):
                mstate, last_u, xs_g, us_g = cstate
                state = model.update_state_core(model_params, mstate, last_u, obs)
                xs, us = solve(model_params, state, xs_g, us_g, cp)
                # The next MPC step starts from this solution.
                return us[:, 0], (state, us[:, 0], xs, us)

            obs0 = init_obs.expand(B, n)
            cstate0 = (mstate0.expand((B,) + tuple(mstate0.shape)), obs0.new_zeros((B, dc)),
                       obs0.new_zeros((B, H + 1, ds)), obs0.new_zeros((B, H, dc)))
            all_obs, ctrls, _ = rollout_scan(
                ctrl_step, lambda o, u: surrogate.pred_core(surr_params, o, u)[..., :n],
                cstate0, obs0, n_steps)
            return _episode_cost(task_cost, all_obs, ctrls)

        self._eval = lambda batch: eval_batch(_stage_batch(batch, _COST_KEYS, on))

    def __call__(self, params_batch):
        _validate_regw(params_batch, self._has_reg, type(self).__name__)
        return self._eval(params_batch)


class MPPIFanout:
    """Evaluate a batch of MPPI candidates, each with its own ``sigma``,
    ``lmda`` (B,) and diagonal quadratic cost ``Qdiag`` (B, n), ``Rdiag``
    (B, m), ``Fdiag`` (B, n) (and ``regw`` (B,) with ``reg_matrix``), for
    a fixed model/surrogate pair at one (``horizon``, ``num_path``)
    bucket. Returns the task costs (B,) of the closed loops on the
    surrogate; a non-finite one scores ``inf``.

    Every MPC step is one batched MPPI update of all B lanes
    (``control/mppi.py::mppi_rollouts``: the B x num_path rollouts in one
    model call a horizon step). Every lane draws the same standard
    normals, each scaled by its own sqrt(sigma), as every lane of the JAX
    package's fan-out uses the same key: one (H, num_path, dc) draw a
    step, the sequential controller's (seed, n) chain, so a lane scores
    as ``MPPI(..., seed=seed)`` under ``simulate``. ``mesh`` raises. Runs
    on the card unless ``device`` names another device.
    """

    def __init__(self, system, task, model, surrogate, horizon: int = 20, num_path: int = 512,
                 n_steps: Optional[int] = None, mesh=None, seed: int = 0, goal=None,
                 reg_matrix=None, reg_goal=None, device=None):
        from ..control import mppi as mppi_module
        from ..control.mppi import ctrl_scaling, mppi_rollouts, mppi_update
        from ..costs.lane_costs import DiagQuadLanes

        if mesh is not None:
            raise ValueError(
                "mesh (candidates sharded over several cards) is not ported to "
                "autompc_torch yet; pass mesh=None"
            )
        self._has_reg = reg_matrix is not None
        n_steps = n_steps or (task.get_num_steps() or 200) - 1
        task_cost = task.get_cost()
        n, dc = system.obs_dim, system.ctrl_dim
        if goal is None:
            goal = (task_cost.get_goal() if task_cost is not None and task_cost.has_goal
                    else np.zeros(n))
        H, P = int(horizon), int(num_path)
        self.device, on, model_params, surr_params, init_obs, mstate0 = _fixed_model_setup(
            system, task, model, surrogate, device)
        umin_n, umax_n, scale = (init_obs.new_tensor(v)
                                 for v in ctrl_scaling(task.get_ctrl_bounds()))
        goal = init_obs.new_tensor(np.asarray(goal, dtype=float))
        reg = None
        if reg_matrix is not None:
            reg = tuple(init_obs.new_tensor(np.asarray(v, dtype=float)) for v in (
                reg_matrix, np.zeros(n) if reg_goal is None else reg_goal))

        def eval_batch(cp):
            B = cp["Qdiag"].shape[0]
            sigma, lmda = cp["sigma"], cp["lmda"]
            root = torch.sqrt(sigma)
            lane_cost = DiagQuadLanes(cp, goal, reg)

            def ctrl_step(cstate, obs):
                mstate, last_u, seq, k = cstate
                x0 = model.update_state_core(model_params, mstate, last_u, obs)
                seq = torch.cat([seq[:, 1:], seq[:, -1:]], dim=1)
                z = mppi_module.standard_normal((H, P, dc), (seed, k), obs)
                eps = root[:, None, None, None] * z
                costs, eps = mppi_rollouts(model.pred_core, model_params, x0, seq, eps,
                                           lane_cost, lmda, sigma, umin_n, umax_n, scale, n)
                seq = mppi_update(seq, costs, eps, lmda)
                u = seq[:, 0] * scale
                return u, (x0, u, seq, k + 1)

            obs0 = init_obs.expand(B, n)
            seq0 = root[:, None, None] * mppi_module.standard_normal((H, dc), (seed, 0), obs0)
            cstate0 = (mstate0.expand((B,) + tuple(mstate0.shape)), obs0.new_zeros((B, dc)),
                       seq0, 1)
            all_obs, ctrls, _ = rollout_scan(
                ctrl_step, lambda o, u: surrogate.pred_core(surr_params, o, u)[..., :n],
                cstate0, obs0, n_steps)
            return _episode_cost(task_cost, all_obs, ctrls)

        self._eval = lambda batch: eval_batch(
            _stage_batch(batch, _COST_KEYS + ("sigma", "lmda"), on))

    def __call__(self, params_batch):
        _validate_regw(params_batch, self._has_reg, type(self).__name__)
        return self._eval(params_batch)
