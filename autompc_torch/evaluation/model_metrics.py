"""Model accuracy metrics (port of ``autompc_tpu/evaluation/model_metrics.py``):
k-step open-loop RMSE and RMSMENS (root mean squared model error,
normalized step-wise).

The k-step rollout moves every start point of a trajectory at once: one
batched ``pred_core`` call a step over all start points, on the device of
the trajectory. The host reductions are numpy's, in float64, in the JAX
package's order. ``get_model_rmsmens`` scores the final-step deltas as
the JAX package does (the reference calls a ``pred_parallel`` that does
not exist).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.trajectory import Trajectory
from ..core.trajectory import batch as traj_batch


def _host(t):
    return t.detach().cpu().numpy()


def _model_states(model, traj):
    """A trajectory's model states, one a step: ``traj_to_states`` where
    the model has it (ARX, Koopman), else the observations."""
    if hasattr(model, "traj_to_states"):
        return model.traj_to_states(traj)
    return traj.obs


def _rollout(model, params, states, ctrls, horizon):
    """``horizon`` open-loop steps from ``states`` (..., S, ds), step k
    taking the controls ``ctrls[..., k : k + S, :]``. Returns (the final
    states, the states a step before them)."""
    S = states.shape[-2]
    final = prev = states
    for k in range(horizon):
        prev, final = final, model.pred_core(params, final, ctrls[..., k : k + S, :])
    return final, prev


def _kstep_rollout(model, traj, horizon):
    """Roll every start point of a trajectory ``horizon`` steps
    open-loop. Returns (pred_final, pred_prev) model states, each
    (T - horizon, state_dim)."""
    states = _model_states(model, traj[: traj.size - horizon])
    return _rollout(model, model.params, states, traj.ctrls, horizon)


def get_model_rmse(model, trajs, horizon=1):
    """Unnormalized k-step RMSE, with the reference's ``obs_dim``
    scaling of the mean."""
    n = model.system.obs_dim
    sqerrs = np.concatenate([
        _host((_kstep_rollout(model, traj, horizon)[0][:, :n] - traj.obs[horizon:]) ** 2)
        for traj in trajs
    ])
    return float(np.sqrt(np.mean(sqerrs) * n))


def get_model_rmsmens(model, trajs, horizon=1):
    """RMSMENS: the error between predicted and actual final-step
    deltas, normalized by the element-wise std of the one-step deltas
    over the data (a std at or below 1e-12 counts as 1)."""
    obs = [_host(traj.obs) for traj in trajs]
    dY = np.concatenate([o[1:] - o[:-1] for o in obs])
    dy_means = dY.mean(axis=0)
    dy_std = dY.std(axis=0)
    dy_std = np.where(dy_std > 1e-12, dy_std, 1.0)

    n = model.system.obs_dim
    sqerrss = []
    for traj, o in zip(trajs, obs):
        final, prev = _kstep_rollout(model, traj, horizon)
        pred_deltas = _host(final[:, :n] - prev[:, :n])
        act_deltas = o[horizon:] - o[horizon - 1 : traj.size - 1]
        norm_pred = (pred_deltas - dy_means) / dy_std
        norm_act = (act_deltas - dy_means) / dy_std
        sqerrss.append((norm_pred - norm_act) ** 2)
    return float(np.sqrt(np.mean(np.concatenate(sqerrss))))


def kstep_rmse(step, states0, obs, ctrls, lengths, horizon):
    """The masked k-step RMSE of a batch of trajectories (obs, ctrls
    (Bh, T, .), lengths (Bh,)) from their start states ``states0``
    (..., Bh, T - horizon, ds); ``step(state, u (Bh, T - horizon, m))``
    advances the states one step. Leading axes of ``states0`` (the
    tuner's candidates) stay in the result."""
    n, S = obs.shape[-1], obs.shape[1] - horizon
    state = states0
    for k in range(horizon):
        state = step(state, ctrls[:, k : k + S])
    errs = (state[..., :n] - obs[:, horizon:]) ** 2
    t = torch.arange(S, device=obs.device) + horizon
    valid = (t[None, :] < lengths[:, None]).to(errs.dtype)             # (Bh, S)
    sums = (errs * valid[..., None]).sum(dim=(-2, -1))                 # (..., Bh)
    return torch.sqrt(sums.sum(-1) / (valid.sum() * n) * n)


def get_model_rmse_batch(model, tb, horizon=1):
    """The k-step RMSE of a ``TrajectoryBatch`` (or a list) in one
    batched rollout over every trajectory, the padded steps masked out.
    Returns a 0-d tensor on the batch's device."""
    tb = traj_batch(tb)
    T = tb.max_len
    if hasattr(model, "traj_to_states"):
        states = torch.stack([
            model.traj_to_states(Trajectory(model.system, T, o, c))
            for o, c in zip(tb.obs, tb.ctrls)
        ])[:, : T - horizon]
    else:
        states = tb.obs[:, : T - horizon]
    params = model.params
    return kstep_rmse(lambda state, u: model.pred_core(params, state, u), states, tb.obs,
                      tb.ctrls, tb.lengths, horizon)
