"""Excitation-signal trajectory generators (port of
``autompc_tpu/benchmarks/data_generation.py``): uniform-random, PRBS,
random-walk, periodic and multisine controls.

Every generator is split in two: its random draws, made from a
``torch.Generator`` on the generator's device (so the data lands there),
and a deterministic function of those draws (``*_signal``) that gives
the control tensor. The draws are named and shaped as the JAX package's
``jax.random`` calls return them (``inits``: unit uniforms of the
initial states; the signal's own, below), so a test can pass the JAX
package's draws through ``draws=`` and compare the two packages' data.
The numbers of a ``torch.Generator`` differ from ``jax.random``'s.

Controls never depend on the state: they are computed as one tensor,
then every trajectory rolls through ``dynamics`` at once
(:func:`rollout_batch`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import default_dtype
from ..core.trajectory import TrajectoryBatch


def rollout_batch(system, dynamics, y0s, Us) -> TrajectoryBatch:
    """Roll B trajectories of length T through ``dynamics``: y0s (B, n),
    Us (B, T, m). obs[:, t] is the state *before* applying ctrls[:, t]."""
    T = Us.shape[1]
    obs = y0s.new_empty((y0s.shape[0], T, y0s.shape[1]))
    y = y0s
    for t in range(T):
        obs[:, t] = y
        y = dynamics(y, Us[:, t])
    return TrajectoryBatch(system, obs, Us)


def _finite_ctrl_bounds(task):
    b = task.get_ctrl_bounds()
    umin = np.where(np.isfinite(b[:, 0]), b[:, 0], -1.0)
    umax = np.where(np.isfinite(b[:, 1]), b[:, 1], 1.0)
    return umin, umax


def _on(rng, draws):
    """Where the data goes: the generator's device, or that of the
    injected draws."""
    device = rng.device if draws is None else draws["inits"].device
    return dict(dtype=default_dtype(device), device=device)


def _t(a, on):
    return torch.as_tensor(np.asarray(a, dtype=np.float64), **on)


def _unit(rng, shape, on):
    return torch.rand(shape, generator=rng, **on)


def _init_states(inits, init_min, init_max, on):
    lo, hi = _t(init_min, on), _t(init_max, on)
    return lo + inits * (hi - lo)


def _bounds(task, on):
    return tuple(_t(b, on) for b in _finite_ctrl_bounds(task))


def uniform_random_signal(u, umin, umax):
    """i.i.d. uniform controls: unit draws ``u`` (B, T, m) scaled into
    [umin, umax]."""
    return umin + u * (umax - umin)


def uniform_random_generate_batch(
    system, task, dynamics, rng, init_min, init_max, traj_len, n_trajs, draws=None
) -> TrajectoryBatch:
    """i.i.d. uniform controls within the task's control bounds, uniform
    initial states in [init_min, init_max]. Draws ``inits`` (B, n),
    ``u`` (B, T, m)."""
    on = _on(rng, draws)
    n = len(np.atleast_1d(init_min))
    if draws is None:
        draws = {
            "inits": _unit(rng, (n_trajs, n), on),
            "u": _unit(rng, (n_trajs, traj_len, system.ctrl_dim), on),
        }
    umin, umax = _bounds(task, on)
    return rollout_batch(system, dynamics, _init_states(draws["inits"], init_min, init_max, on),
                         uniform_random_signal(draws["u"], umin, umax))


def prbs_signal(switches, levels, traj_len, ctrl_dim):
    """Pseudo-random multi-level sequences: trajectory b holds
    ``levels[b, k]`` from its k-th sorted switch time on (``switches``
    (B, Nswitch) step indices, ``levels`` (B, Nswitch + 1)); (B, T, m)."""
    sw = torch.sort(switches, dim=1).values.contiguous()
    t = torch.arange(traj_len, device=sw.device, dtype=sw.dtype)
    seg = torch.searchsorted(sw, t.expand(sw.shape[0], traj_len).contiguous(), right=True)
    Us = torch.gather(levels, 1, seg)[..., None]
    return Us.expand(-1, -1, ctrl_dim).contiguous() if ctrl_dim != 1 else Us


def prbs_generate_batch(
    system, task, dynamics, rng, init_min, init_max, traj_len, n_trajs, states, Nswitch,
    draws=None,
) -> TrajectoryBatch:
    """Hold a level drawn from ``states`` between ``Nswitch`` random
    switch times. Draws ``inits`` (B, n), ``switches`` (B, Nswitch)
    integers in [0, T), ``levels`` (B, Nswitch + 1) values of
    ``states``."""
    on = _on(rng, draws)
    n = len(np.atleast_1d(init_min))
    if draws is None:
        st = _t(states, on)
        idx = torch.randint(0, st.shape[0], (n_trajs, Nswitch + 1), generator=rng,
                            device=on["device"])
        draws = {
            "inits": _unit(rng, (n_trajs, n), on),
            "switches": torch.randint(0, traj_len, (n_trajs, Nswitch), generator=rng,
                                      device=on["device"]),
            "levels": st[idx],
        }
    Us = prbs_signal(draws["switches"], draws["levels"].to(on["dtype"]), traj_len,
                     system.ctrl_dim)
    return rollout_batch(system, dynamics, _init_states(draws["inits"], init_min, init_max, on),
                         Us)


def random_walk_signal(u0, w, umin, umax, walk_rate, dt):
    """A bounded random walk from ``u0`` (B, m): each step adds
    ``uamp * walk_rate * dt * w[:, t]`` (``w`` (B, T, m) in [-1, 1),
    ``uamp`` the least bound entry) and clips to [umin, umax] — a loop
    over time, as the clip is not prefix-summable."""
    uamp = torch.min(torch.stack([umin, umax]))
    dw = uamp * (walk_rate * dt) * w
    u = umin + u0 * (umax - umin)
    us = []
    for t in range(w.shape[1]):
        u = torch.clamp(u + dw[:, t], umin, umax)
        us.append(u)
    return torch.stack(us, dim=1)


def random_walk_generate_batch(
    system, task, dynamics, rng, init_min, init_max, walk_rate, traj_len, n_trajs,
    draws=None,
) -> TrajectoryBatch:
    """Controls follow a bounded random walk with step scale ``walk_rate
    * dt``. Draws ``inits`` (B, n), ``u0`` (B, m) unit uniforms, ``w``
    (B, T, m) uniform in [-1, 1)."""
    on = _on(rng, draws)
    n, m = len(np.atleast_1d(init_min)), system.ctrl_dim
    if draws is None:
        draws = {
            "inits": _unit(rng, (n_trajs, n), on),
            "u0": _unit(rng, (n_trajs, m), on),
            "w": 2.0 * _unit(rng, (n_trajs, traj_len, m), on) - 1.0,
        }
    umin, umax = _bounds(task, on)
    Us = random_walk_signal(draws["u0"], draws["w"], umin, umax, walk_rate, system.dt)
    return rollout_batch(system, dynamics, _init_states(draws["inits"], init_min, init_max, on),
                         Us)


def periodic_periods(traj_len, n_trajs):
    """The cosine periods, one a trajectory: an even grid of
    ``range(1, T, max(1, T // n_trajs))`` (so the batch has this many
    trajectories, not ``n_trajs``)."""
    return np.array(list(range(1, traj_len, max([1, traj_len // n_trajs]))))


def periodic_signal(periods, U_1, umin, umax, traj_len):
    """Cosine controls ``uamp U_1 cos(2 pi t / period)``, one period a
    trajectory (``uamp`` the least bound entry); (len(periods), T, m)."""
    uamp = torch.min(torch.stack([umin, umax]))
    t = torch.arange(traj_len, dtype=umin.dtype, device=umin.device)
    p = torch.as_tensor(periods, dtype=t.dtype, device=t.device)
    return (uamp * U_1[None, None, :]) * torch.cos(
        2 * math.pi * t[None, :, None] / p[:, None, None])


def periodic_control_generate_batch(
    system, task, dynamics, rng, init_min, init_max, U_1, traj_len, n_trajs, draws=None
) -> TrajectoryBatch:
    """Cosine controls, one period per trajectory drawn from an even grid
    (``periodic_periods``). Draws ``inits`` (len(periods), n)."""
    on = _on(rng, draws)
    periods = periodic_periods(traj_len, n_trajs)
    n = len(np.atleast_1d(init_min))
    if draws is None:
        draws = {"inits": _unit(rng, (len(periods), n), on)}
    umin, umax = _bounds(task, on)
    Us = periodic_signal(periods, _t(U_1, on), umin, umax, traj_len)
    return rollout_batch(system, dynamics, _init_states(draws["inits"], init_min, init_max, on),
                         Us)


def multisine_signal(vals, phases, umin, umax, n_freqs, traj_len):
    """Sums of cosines at the periods ``range(1, T, n_freqs)`` (P of
    them) with random phases ``phases`` (B, P) and weights that are the
    spacings of the sorted unit draws ``vals`` (B, m, P - 1) (they sum
    to 1), scaled into [umin, umax]; (B, T, m)."""
    uamp = (umax - umin) / 2
    umed = (umax + umin) / 2
    periods = torch.as_tensor(np.array(list(range(1, traj_len, n_freqs))), dtype=vals.dtype,
                              device=vals.device)
    v = torch.sort(vals, dim=-1).values
    edge = v.shape[:-1] + (1,)
    v = torch.cat([v.new_zeros(edge), v, v.new_ones(edge)], dim=-1)
    weights = v[..., 1:] - v[..., :-1]                                   # (B, m, P)
    t = torch.arange(traj_len, dtype=vals.dtype, device=vals.device)
    angles = 2 * math.pi * t[None, :, None] / periods[None, None, :] + phases[:, None, :]
    U = torch.einsum("btp,bmp->btm", torch.cos(angles), weights)
    return uamp[None, None, :] * U + umed[None, None, :]


def multisine_generate_batch(
    system, task, dynamics, rng, init_min, init_max, n_freqs, traj_len, n_trajs, draws=None
) -> TrajectoryBatch:
    """Sum-of-cosines controls with Dirichlet-like random weights and
    random phases. Draws ``inits`` (B, n), ``vals`` (B, m, P - 1) unit
    uniforms, ``phases`` (B, P) uniform in [0, 2 pi)."""
    on = _on(rng, draws)
    n, m = len(np.atleast_1d(init_min)), system.ctrl_dim
    P = len(range(1, traj_len, n_freqs))
    if draws is None:
        draws = {
            "inits": _unit(rng, (n_trajs, n), on),
            "vals": _unit(rng, (n_trajs, m, P - 1), on),
            "phases": 2 * math.pi * _unit(rng, (n_trajs, P), on),
        }
    umin, umax = _bounds(task, on)
    Us = multisine_signal(draws["vals"], draws["phases"], umin, umax, n_freqs, traj_len)
    return rollout_batch(system, dynamics, _init_states(draws["inits"], init_min, init_max, on),
                         Us)


def _listify(fn):
    def wrapper(*args, **kwargs):
        return fn(*args, **kwargs).to_list()

    wrapper.__name__ = fn.__name__.replace("_batch", "")
    wrapper.__doc__ = fn.__doc__
    return wrapper


uniform_random_generate = _listify(uniform_random_generate_batch)
prbs_generate = _listify(prbs_generate_batch)
random_walk_generate = _listify(random_walk_generate_batch)
periodic_control_generate = _listify(periodic_control_generate_batch)
multisine_generate = _listify(multisine_generate_batch)
