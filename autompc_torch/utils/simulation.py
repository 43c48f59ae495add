"""Closed-loop simulation (port of
``autompc_tpu/utils/simulation.py::simulate``).

A host loop of ``controller.step``: each step's control advances either
the true dynamics or a surrogate model. The trajectory's layout is the
reference's: obs has one more valid row than there are controller
steps, and the last control row is zero. ``term_cond`` is checked on
the trajectory after every step, as the reference's host loop does;
``term_cond=None`` runs ``max_steps`` steps.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..core.trajectory import Trajectory


def rollout_scan(step_fn, advance_fn, cstate0, init_obs, n_steps):
    """A closed loop of ``n_steps`` steps: ``step_fn(cstate, obs) -> (u,
    cstate)``, ``advance_fn(obs, u) -> next obs``. Returns (obs
    (n_steps+1, ...), ctrls (n_steps, ...), the last controller state):
    the observation before every step and the last one. Batched lanes
    ride the trailing axes."""
    cstate, obs = cstate0, init_obs
    obs_seq, ctrl_seq = [], []
    for _ in range(n_steps):
        u, cstate = step_fn(cstate, obs)
        obs_seq.append(obs)
        ctrl_seq.append(u)
        obs = advance_fn(obs, u)
    obs_seq.append(obs)
    return torch.stack(obs_seq), torch.stack(ctrl_seq), cstate


def simulate(
    controller,
    init_obs,
    term_cond: Optional[Callable] = None,
    dynamics: Optional[Callable] = None,
    sim_model=None,
    max_steps: int = 10000,
    silent: bool = True,
) -> Trajectory:
    """Simulate ``controller`` from ``init_obs`` against ``dynamics``
    (``(obs, ctrl) -> next_obs``, tensors) or, when it is None, against
    ``sim_model`` (its ``pred_core`` on its own state), for at most
    ``max_steps`` steps, on the controller's device (the card unless the
    controller says otherwise)."""
    del silent
    if dynamics is None and sim_model is None:
        raise ValueError("Must specify dynamics function or simulation model")
    system = controller.system
    device = resolve_device(getattr(controller, "device", None))
    obs = torch.as_tensor(np.asarray(init_obs, dtype=float), dtype=default_dtype(device),
                          device=device)
    zeros_u = obs.new_zeros(system.ctrl_dim)

    def traj_of(obs_rows, ctrl_rows):
        return Trajectory(system, len(obs_rows), torch.stack(obs_rows),
                          torch.stack(ctrl_rows + [zeros_u]))

    seed = traj_of([obs], [])
    cstate = controller.traj_to_state(seed)
    if dynamics is None:
        sim_params = sim_model.params
        simstate = sim_model.traj_to_state(seed)

    obs_rows, ctrl_rows = [obs], []
    for _ in range(max_steps):
        u, cstate = controller.step(cstate, obs)
        if dynamics is None:
            simstate = sim_model.pred_core(sim_params, simstate, u)
            obs = simstate[: system.obs_dim]
        else:
            obs = dynamics(obs, u)
        obs_rows.append(obs)
        ctrl_rows.append(u)
        if term_cond is not None and term_cond(traj_of(obs_rows, ctrl_rows)):
            break
    return traj_of(obs_rows, ctrl_rows)
