"""Receding-horizon MPC loops (port of ``autompc_tpu/control/receding.py``:
``make_receding_ilqr_loop``, ``make_receding_mppi_loop`` and
``make_receding_sqp_loop``).

Per plant step: solve from the current state (warm-started by the
previous solution shifted one step), apply ``us[0]``, advance the true
plant, count the steps whose solve converged. The JAX package vmaps a
single-lane solver over the lanes; here the inner solve is the batched
solver over all lanes at once, so every step runs the CUDA kernels on
the card (tests/test_batched_ilqr.py pins the batched solver lane for
lane to the vmapped single-lane one in the JAX package). The MPPI and
SQP loops are B lanes of their controllers' batched code in the same
way, and read nothing back to the host: an episode is a stream of
launches.
"""

from __future__ import annotations

import math

import torch

from . import mppi as mppi_module
from .ilqr import make_batched_ilqr_solver
from .mppi import MPPI, mppi_rollouts, mppi_update
from .nmpc import make_sqp_solver


def make_receding_ilqr_loop(
    pred_core,
    cost,
    plant_step,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    n_steps: int,
    ubounds=None,
    warm_start: bool = True,
    max_iter: int = 50,
    **solver_kw,
):
    """Build ``run(params, x0s (B, ds)) -> (xs (B, n_steps+1, ds),
    us (B, n_steps, dc), n_converged (B,))``.

    ``pred_core`` is the controller's model, ``plant_step(x, u)`` the
    batched true dynamics. ``solver_kw`` go to
    ``make_batched_ilqr_solver``: with the model's ``feature_spec`` (and
    maybe ``feature_mask``) the lanes-last fused kernel path is selected
    here, and its options (``ls_wide``, ``jac_dtype``) pass through; with
    ``pred_diff`` (any ds, dc; maybe ``mlp_ls``) the batch-major body
    runs.
    """
    kw = dict(backward="pallas")
    if solver_kw.get("feature_spec") is not None:
        kw.update(lanes_last=True, fuse_ls=True)
    kw.update(solver_kw)
    solve = make_batched_ilqr_solver(
        pred_core, cost, H=H, ds=ds, dc=dc, obsdim=obsdim, dt=dt,
        ubounds=ubounds, max_iter=max_iter, **kw,
    )

    def run(params, x0s):
        B = x0s.shape[0]
        x = x0s
        guess = x0s.new_zeros((B, H, dc))
        xs, us = [x0s], []
        n_conv = torch.zeros(B, dtype=torch.int32, device=x0s.device)
        for _ in range(n_steps):
            converged, _, u_sol, _, _ = solve(params, x, guess)
            u = u_sol[:, 0]
            x = plant_step(x, u)
            xs.append(x)
            us.append(u)
            n_conv += converged.to(torch.int32)
            guess = (
                torch.cat([u_sol[:, 1:], u_sol.new_zeros((B, 1, dc))], dim=1)
                if warm_start else x0s.new_zeros((B, H, dc))
            )
        return torch.stack(xs, dim=1), torch.stack(us, dim=1), n_conv

    return run


def make_receding_mppi_loop(system, task, model, plant_step, n_steps: int, seed: int = 0,
                            **mppi_kwargs):
    """Build ``run(params, x0s (B, ds)) -> (xs (B, n_steps+1, ds), us
    (B, n_steps, dc))``: per plant step exactly ``MPPI.step`` (shift the
    nominal sequence, draw, roll out, reweight; ``niter`` times), apply
    the first control and advance the true plant. Lane b draws its own
    chain (the JAX package's ``fold_in(PRNGKey(seed), b)``), so lanes are
    independent episodes. The state is the plant's: the model's state
    update is not applied."""
    mppi = MPPI(system, task, model, **mppi_kwargs)
    H, P, dc = mppi.H, mppi.num_path, mppi.dim_ctrl
    root = math.sqrt(mppi.sigma)

    def run(params, x0s):
        B = x0s.shape[0]
        umin_n, umax_n, scale = mppi._scaling(x0s)
        seq = root * mppi_module.standard_normal((H, dc), (seed, 0), x0s, lanes=B)
        n, x = 1, x0s
        xs, us = [x0s], []
        for _ in range(n_steps):
            for _ in range(mppi.niter):
                seq = torch.cat([seq[:, 1:], seq[:, -1:]], dim=1)
                eps = root * mppi_module.standard_normal((H, P, dc), (seed, n), x0s, lanes=B)
                n += 1
                costs, eps = mppi_rollouts(model.pred_core, params, x, seq, eps, mppi._cost,
                                           mppi.lmda, mppi.sigma, umin_n, umax_n, scale,
                                           system.obs_dim)
                seq = mppi_update(seq, costs, eps, mppi.lmda)
            u = seq[:, 0] * scale
            x = plant_step(x, u)
            xs.append(x)
            us.append(u)
        return torch.stack(xs, dim=1), torch.stack(us, dim=1)

    return run


def make_receding_sqp_loop(pred_core, cost, plant_step, H: int, ds: int, dc: int, obsdim: int,
                           dt: float, n_steps: int, ubounds=None, warm_start: bool = True,
                           **solver_kw):
    """Build ``run(params, x0s (B, ds)) -> (xs (B, n_steps+1, ds), us
    (B, n_steps, dc))``: per plant step a full SQP solve
    (``make_sqp_solver``, all lanes at once) from the current state, the
    first control applied to the true plant; the next solve starts from
    this solution shifted one knot (the last knot repeated), or from
    zeros when ``warm_start`` is False."""
    solve = make_sqp_solver(pred_core, cost, H=H, ds=ds, dc=dc, obsdim=obsdim, dt=dt,
                            ubounds=ubounds, **solver_kw)

    def run(params, x0s):
        B = x0s.shape[0]
        x = x0s
        xs_g, us_g = x0s.new_zeros((B, H + 1, ds)), x0s.new_zeros((B, H, dc))
        xs, us = [x0s], []
        for _ in range(n_steps):
            sx, su = solve(params, x, xs_g, us_g)
            u = su[:, 0]
            x = plant_step(x, u)
            xs.append(x)
            us.append(u)
            if warm_start:
                xs_g = torch.cat([sx[:, 1:], sx[:, -1:]], dim=1)
                us_g = torch.cat([su[:, 1:], su[:, -1:]], dim=1)
            else:
                xs_g, us_g = torch.zeros_like(xs_g), torch.zeros_like(us_g)
        return torch.stack(xs, dim=1), torch.stack(us, dim=1)

    return run
