"""Tuning fan-out: score a batch of candidate configurations in one
batched program (port of ``autompc_tpu/parallel/fanout.py``:
``QuadCostFanout``).

For configuration families whose hyperparameters do not change tensor
shapes (cost gains), the whole candidate evaluation — controller
synthesis (an iLQR solve per closed-loop step), the closed-loop rollout
on the surrogate and the task metric — runs over the candidate batch at
once: every solve sees (B, ...) tensors and the solver's kernels. This
is what a tune spends its time in.

The joint model+cost fan-outs, the direct-transcription and MPPI
fan-outs, ``impl="vmap"``, the GaussReg term and the device mesh of the
JAX package are not ported yet (ROADMAP.md §A).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..control.ilqr import (
    make_batched_ilqr_solver,
    make_scheduled_ilqr_solver,
    parse_schedule,
)
from ..core.trajectory import zeros as traj_zeros
from .mesh import pad_to_multiple

# Candidates are padded to a multiple of this, so that ragged batch
# occupancy reuses a few batch sizes (the JAX package's pad quantum on
# one device).
PAD_QUANTUM = 8


class QuadCostFanout:
    """Evaluate a batch of diagonal quadratic-cost candidates for a fixed
    model/surrogate pair, with an iLQR controller synthesized per
    candidate.

    ``__call__(params_batch)`` takes a dict of arrays (numpy or tensors)
    with a leading batch axis, ``Qdiag (B, n)``, ``Fdiag (B, n)``,
    ``Rdiag (B, m)``, and returns the per-candidate task cost of the
    closed-loop surrogate trajectory as a (B,) tensor; a candidate whose
    rollout is not finite scores ``inf``.

    Per closed-loop step the whole batch goes through one per-lane-cost
    iLQR solve (``make_batched_ilqr_solver(quad_cost_batch=True)``, under
    ``make_scheduled_ilqr_solver`` when ``compact_schedule`` — a
    ``"cut:frac,..."`` string or a tuple of pairs — is given).
    ``backward``, ``feature_spec``, ``fuse_ls`` and ``lanes_last`` are
    the solver's options; with a ``feature_spec`` the features whose
    coefficient columns are all zero are masked out of the kernels (the
    model is fixed for the life of the instance). ``warm_start`` shifts
    the previous step's controls into the next solve's guess.

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
        fuse_ls: bool = False,
        lanes_last: bool = False,
        device=None,
    ):
        if impl not in ("batched", "vmap"):
            raise ValueError(f"impl must be 'batched' or 'vmap', got {impl!r}")
        if impl == "vmap":
            raise ValueError(
                "impl='vmap' (the per-candidate single-lane solver) is not "
                "ported to autompc_torch yet; use impl='batched'"
            )
        if mesh is not None:
            raise ValueError(
                "mesh (candidates sharded over several cards) is not ported "
                "to autompc_torch yet; pass mesh=None"
            )
        if reg_matrix is not None:
            raise ValueError(
                "reg_matrix (the GaussReg term) is not ported to "
                "autompc_torch yet"
            )
        self.system = system
        self.task = task
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

        solver_kw = dict(
            H=horizon, ds=ds, dc=dc, obsdim=n, dt=system.dt,
            ubounds=(bounds[:, 0], bounds[:, 1]), backward=backward,
            feature_spec=feature_spec,
            pred_diff=getattr(model, "pred_diff_core", None),
            quad_cost_batch=True, quad_goal=np.asarray(goal, dtype=float),
            fuse_ls=bool(fuse_ls and feature_spec is not None),
            lanes_last=bool(lanes_last),
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
            stage = (task_cost.eval_obs_cost(torch.stack(obs_seq)).sum(0)
                     + task_cost.eval_obs_cost(obs))
            ctrlc = task_cost.eval_ctrl_cost(torch.stack(ctrl_seq)).sum(0)
            total = stage + ctrlc + task_cost.eval_term_obs_cost(obs)
            # A non-finite rollout scores +inf: a bad configuration, and
            # the tune goes on.
            return torch.where(torch.isfinite(total), total,
                               torch.full_like(total, float("inf")))

        def eval_padded(params_batch):
            cost_params = {
                k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                   **on)
                for k, v in params_batch.items()
            }
            padded, n_real = pad_to_multiple(cost_params, PAD_QUANTUM)
            return eval_batch(padded)[:n_real]

        self._eval = eval_padded

    def __call__(self, params_batch):
        return self._eval(params_batch)
