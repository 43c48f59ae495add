"""Receding-horizon MPC loop (port of ``autompc_tpu/control/receding.py``:
``make_receding_ilqr_loop``).

Per plant step: solve from the current state (warm-started by the
previous solution shifted one step), apply ``us[0]``, advance the true
plant, count the steps whose solve converged. The JAX package vmaps a
single-lane solver over the lanes; here the inner solve is the batched
solver over all lanes at once, so every step runs the CUDA kernels on
the card (tests/test_batched_ilqr.py pins the batched solver lane for
lane to the vmapped single-lane one in the JAX package).
"""

from __future__ import annotations

import torch

from .ilqr import make_batched_ilqr_solver


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
