"""Direct-transcription MPC by sequential quadratic programming (port of
``autompc_tpu/control/nmpc.py``: ``make_sqp_solver``,
``DirectTranscriptionController`` and its factory).

The knot-point NLP over states x_0..x_H and controls u_0..u_{H-1}:
objective ``dt * sum_{i<=H} obs_cost(x_i) + dt * sum_{i<H}
ctrl_cost(u_i) + term_cost(x_H)``, defects ``f(x_i, u_i) - x_{i+1}``.
Each SQP iterate linearizes the dynamics, solves the trajectory QP
through its Riccati factorization (``ops/trajqp.py``) and takes the
first of ``ls_max_iter`` step sizes 0.5**k whose L1 merit (objective +
merit_mu * sum |defects|) improves, or keeps the iterate when none
does. Controls are clipped to their bounds. Observation bounds enter as
an augmented Lagrangian on every knot but the first.

Batch-first: the solver takes B lanes at once, each with its own start,
guess and (``quad_cost_batch``) cost; the controller is B = 1, and the
fan-out and the receding loop are B lanes of the same code. The step
sizes are one batch axis too, and no iteration reads a value back to
the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ConfigurationSpace, UniformIntegerHyperparameter
from ..costs.lane_costs import DiagQuadLanes, SharedCost
from ..ops.trajqp import qp_backward, qp_backward_assoc, qp_forward
from ..sysid.model import model_device
from .controller import Controller, ControllerFactory
from .ilqr import jacfwd_pred_diff


class DirectTranscriptionControllerFactory(ControllerFactory):
    """Hyperparameters:

    - *horizon* (int, 1..30, default 10): the control horizon in
      seconds; the knot count is ceil(horizon / dt).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Controller = DirectTranscriptionController
        self.name = "DirectTranscription"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        cs.add_hyperparameter(
            UniformIntegerHyperparameter("horizon", lower=1, upper=30, default_value=10))
        return cs


def knot_count(horizon, dt):
    """Knots of a horizon given in seconds: ceil(horizon / dt)."""
    return int(np.ceil(horizon / dt))


def make_sqp_solver(
    pred_core,
    cost,
    H: int,
    ds: int,
    dc: int,
    obsdim: int,
    dt: float,
    ubounds,
    sqp_iters: int = 10,
    ls_max_iter: int = 8,
    merit_mu: float = 100.0,
    reg: float = 1e-7,
    backward: str = "scan",
    pred_diff=None,
    xbounds=None,
    xbound_mu: float = 100.0,
    xbound_lam_every: int = 4,
    quad_cost_batch: bool = False,
    quad_goal=None,
    reg_matrix=None,
    reg_goal=None,
):
    """Build ``solve(params, x0 (B, ds), xs_guess (B, H+1, ds), us_guess
    (B, H, dc)[, cost_params], steps=False) -> (xs, us)`` on the device
    of ``x0``; with ``steps=True`` also the index of the step size each
    lane accepted at each iteration (B, sqp_iters), -1 where none
    improved the merit.

    ``cost`` is one Cost for every lane; ``quad_cost_batch=True`` takes
    a diagonal quadratic cost a lane instead, ``cost_params`` =
    {``Qdiag`` (B, obsdim), ``Rdiag`` (B, dc), ``Fdiag`` (B, obsdim)}
    with the shared goal ``quad_goal``, and with ``reg_matrix``/
    ``reg_goal`` (S, mu) the GaussReg term ``regw_b (x-mu)' S (x-mu)``
    on every stage, ``regw`` (B,) in ``cost_params``.

    ``pred_diff(params, x, u) -> (pred, Jx, Ju)`` is the model's
    closed-form Jacobian, batched over every leading axis; without one
    the model is differentiated by ``torch.func.jacfwd``. ``xbounds`` =
    (lo, hi) of shape (obsdim,): an augmented-Lagrangian box on every
    knot state but the first (its weight is 0), infinite entries
    inactive (replaced by -+1e9); the multipliers update every
    ``xbound_lam_every``-th iteration. ``ubounds`` None clips nothing.
    ``backward``: "scan" (the sequential factorization) or "assoc"
    (``qp_backward_assoc``, O(log H) depth: the long-horizon option).
    """
    if backward not in ("scan", "assoc"):
        raise ValueError(f"backward must be 'scan' or 'assoc', got {backward!r}")
    if reg_matrix is not None and not quad_cost_batch:
        raise ValueError("reg_matrix requires quad_cost_batch=True")
    pdiff = pred_diff or jacfwd_pred_diff(pred_core, ds)
    host = {"alphas": 0.5 ** np.arange(ls_max_iter, dtype=np.float64)}
    if ubounds is not None:
        host["umin"] = np.asarray(ubounds[0], dtype=float).reshape(-1)
        host["umax"] = np.asarray(ubounds[1], dtype=float).reshape(-1)
    has_xb = xbounds is not None
    if has_xb:
        lo, hi = (np.asarray(b, dtype=float).reshape(-1) for b in xbounds)
        host["xlo"] = np.where(np.isfinite(lo), lo, -1e9)
        host["xhi"] = np.where(np.isfinite(hi), hi, 1e9)
        # Knot 0 is the measured state: its bound is no decision.
        host["knot_w"] = np.concatenate([[0.0], np.ones(H)])[:, None]
    if quad_cost_batch:
        host["goal"] = np.zeros(obsdim) if quad_goal is None else np.asarray(quad_goal, float)
    if reg_matrix is not None:
        host["reg_S"] = np.asarray(reg_matrix, dtype=float)
        host["reg_mu"] = np.zeros(obsdim) if reg_goal is None else np.asarray(reg_goal, float)
    on = {}

    def consts(like):
        """The host constants as tensors like ``like``, made once."""
        key = (like.device, like.dtype)
        if key not in on:
            on[key] = {k: like.new_tensor(v) for k, v in host.items()}
        return on[key]

    def lane_cost(cost_params, like, c):
        if not quad_cost_batch:
            return SharedCost(cost)
        if cost_params is None:
            raise ValueError("quad_cost_batch solve needs cost_params")
        keys = ("Qdiag", "Rdiag", "Fdiag") + (("regw",) if reg_matrix is not None else ())
        cp = {k: torch.as_tensor(cost_params[k], dtype=like.dtype, device=like.device)
              for k in keys}
        reg = (c["reg_S"], c["reg_mu"]) if reg_matrix is not None else None
        return DiagQuadLanes(cp, c["goal"], reg)

    def objective(lc, xs, us):
        oc = lc.obs(xs[..., :obsdim]).sum(-1)
        cc = lc.ctrl(us).sum(-1)
        return dt * (oc + cc) + lc.term(xs[..., H, :obsdim])

    def defects(params, xs, us):
        return pred_core(params, xs[..., :H, :], us) - xs[..., 1:, :]

    def al_terms(xo, lam_lo, lam_hi, c):
        """Penalty (..., H+1), gradient and diagonal hessian (..., H+1,
        obsdim) of the augmented Lagrangian of lo <= x <= hi at each
        knot: P = (max(0, lam + mu g)^2 - lam^2) / (2 mu) a side."""
        w = c["knot_w"]
        t_hi = torch.clamp_min(lam_hi + xbound_mu * (xo - c["xhi"]), 0.0) * w
        t_lo = torch.clamp_min(lam_lo + xbound_mu * (c["xlo"] - xo), 0.0) * w
        pen = ((t_hi ** 2 - (lam_hi * w) ** 2).sum(-1)
               + (t_lo ** 2 - (lam_lo * w) ** 2).sum(-1)) / (2.0 * xbound_mu)
        hdiag = xbound_mu * ((t_hi > 0).to(xo.dtype) + (t_lo > 0).to(xo.dtype))
        return pen, t_hi - t_lo, hdiag

    def merit(params, lc, xs, us, lam, c, d=None):
        """The L1 merit; ``d``: the defects of (xs, us) where known."""
        d = defects(params, xs, us) if d is None else d
        m = objective(lc, xs, us) + merit_mu * d.abs().sum((-2, -1))
        if has_xb:
            m = m + al_terms(xs[..., :obsdim], lam[0], lam[1], c)[0].sum(-1)
        return m

    def clip_u(us, c):
        if ubounds is None:
            return us
        return torch.clamp(us, c["umin"], c["umax"])

    def expansions(lc, xs, us, lam, c):
        """Dynamics-free QP data: dt-scaled stage expansions (B, H, ...)
        and the terminal expansion with the last knot's own stage cost,
        plus the augmented Lagrangian's gradient and diagonal hessian
        (not dt-scaled)."""
        B = xs.shape[0]
        _, qx, Qh = lc.obs_hess(xs[:, :H, :obsdim])
        _, ru, Rh = lc.ctrl_hess(us)
        Cxx = xs.new_zeros((B, H, ds, ds))
        Cxx[..., :obsdim, :obsdim] = Qh * dt
        cx = xs.new_zeros((B, H, ds))
        cx[..., :obsdim] = qx * dt
        _, tg, th = lc.term_hess(xs[:, H, :obsdim])
        _, sg, sh = lc.obs_hess(xs[:, H, :obsdim])
        Vf = xs.new_zeros((B, ds, ds))
        Vf[:, :obsdim, :obsdim] = th + sh * dt
        vf = xs.new_zeros((B, ds))
        vf[:, :obsdim] = tg + sg * dt
        if has_xb:
            _, g_all, h_all = al_terms(xs[..., :obsdim], lam[0], lam[1], c)
            idx = torch.arange(obsdim, device=xs.device)
            Cxx[:, :, idx, idx] += h_all[:, :H]
            cx[..., :obsdim] += g_all[:, :H]
            Vf[:, idx, idx] += h_all[:, H]
            vf[:, :obsdim] += g_all[:, H]
        return Cxx, Rh * dt, cx, ru * dt, Vf, vf

    def sqp_iteration(params, lc, xs, us, lam, it, c):
        _, A_seq, B_seq = pdiff(params, xs[:, :H], us)
        d_seq = defects(params, xs, us)
        Cxx, Cuu, cx, cu, Vf, vf = expansions(lc, xs, us, lam, c)
        Cux = xs.new_zeros(us.shape[:2] + (dc, ds))
        factor = qp_backward_assoc if backward == "assoc" else qp_backward
        Ks, ks, _, _ = factor(A_seq, B_seq, Cxx, Cuu, Cux, cx, cu, d_seq, Vf, vf, reg)
        merit0 = merit(params, lc, xs, us, lam, c, d_seq)
        # Every step size at once: candidates (B, L, ...).
        dxs, dus = qp_forward(A_seq, B_seq, d_seq, Ks, ks, alpha=c["alphas"])
        xs_c = xs[:, None] + dxs
        us_c = clip_u(us[:, None] + dus, c)
        lam_c = None if lam is None else (lam[0][:, None], lam[1][:, None])
        improved = merit(params, lc, xs_c, us_c, lam_c, c) < merit0[:, None]
        # The first improving step size; none: keep the iterate.
        idx = torch.argmax(improved.to(xs.dtype), dim=1)
        any_imp = improved.any(1)
        lanes = torch.arange(xs.shape[0], device=xs.device)
        xs = torch.where(any_imp[:, None, None], xs_c[lanes, idx], xs)
        us = torch.where(any_imp[:, None, None], us_c[lanes, idx], us)
        if has_xb and it % xbound_lam_every == xbound_lam_every - 1:
            # The multipliers' first-order update on the accepted iterate.
            xo = xs[..., :obsdim]
            lam = (torch.clamp_min(lam[0] + xbound_mu * (c["xlo"] - xo), 0.0) * c["knot_w"],
                   torch.clamp_min(lam[1] + xbound_mu * (xo - c["xhi"]), 0.0) * c["knot_w"])
        return xs, us, lam, torch.where(any_imp, idx, torch.full_like(idx, -1))

    def solve(params, x0, xs_guess, us_guess, cost_params=None, steps=False):
        c = consts(x0)
        lc = lane_cost(cost_params, x0, c)
        xs = xs_guess.to(dtype=x0.dtype, device=x0.device).clone()
        xs[:, 0] = x0
        us = us_guess.to(dtype=x0.dtype, device=x0.device)
        lam = None
        if has_xb:
            z = x0.new_zeros((x0.shape[0], H + 1, obsdim))
            lam = (z, z)
        accepted = []
        for it in range(sqp_iters):
            xs, us, lam, idx = sqp_iteration(params, lc, xs, us, lam, it, c)
            accepted.append(idx)
        if steps:
            return xs, us, torch.stack(accepted, dim=1)
        return xs, us

    return solve


class DirectTranscriptionController(Controller):
    """Direct-transcription MPC on ``model``: ``horizon`` in seconds
    (ceil(horizon / dt) knots), the task's control bounds (infinite ones
    as -+1e9) and, where the task has them, its observation bounds on
    every knot. Each step solves from the previous step's solution
    (unshifted). Runs on the device of the model's parameters."""

    def __init__(self, system, task, model, horizon):
        super().__init__(system, task, model)
        self.horizon = knot_count(horizon, system.dt)
        bounds = task.get_ctrl_bounds()
        finite_lo = np.where(np.isfinite(bounds[:, 0]), bounds[:, 0], -1e9)
        finite_hi = np.where(np.isfinite(bounds[:, 1]), bounds[:, 1], 1e9)
        xbounds = None
        if task.are_obs_bounded():
            ob = task.get_obs_bounds()
            xbounds = (ob[:, 0], ob[:, 1])
        self._model_params = model.params
        self.device = model_device(model)
        self._solve = make_sqp_solver(
            model.pred_core, task.get_cost(), H=self.horizon, ds=model.state_dim,
            dc=system.ctrl_dim, obsdim=system.obs_dim, dt=system.dt,
            ubounds=(finite_lo, finite_hi),
            pred_diff=getattr(model, "pred_diff_core", None), xbounds=xbounds,
        )

    @property
    def state_dim(self):
        return self.model.state_dim + self.system.ctrl_dim

    @staticmethod
    def is_compatible(system, task, model):
        return True

    def traj_to_state(self, traj):
        H, ds, dc = self.horizon, self.model.state_dim, self.system.ctrl_dim
        z = traj.obs.new_zeros
        return dict(
            model_state=self.model.traj_to_state(traj),
            last_u=traj[-1].ctrl,
            xs_guess=z((H + 1, ds)),
            us_guess=z((H, dc)),
        )

    def set_guess(self, cstate, us_guess, xs_guess=None):
        """A controller state whose next solve starts from the given knots:
        ``us_guess`` (H, ctrl_dim) and ``xs_guess`` (H+1, state_dim), or,
        without it, the model rolled forward from the current model state
        under ``us_guess``. The guesses take the model state's dtype and
        device (the JAX package rounds them to float32)."""
        H, ds, dc = self.horizon, self.model.state_dim, self.system.ctrl_dim
        x0 = cstate["model_state"]
        us_guess = torch.as_tensor(us_guess).to(x0).reshape(H, dc)
        if xs_guess is None:
            xs = [x0]
            for t in range(H):
                xs.append(self.model.pred_core(self._model_params, xs[-1], us_guess[t]))
            xs_guess = torch.stack(xs)
        xs_guess = torch.as_tensor(xs_guess).to(x0).reshape(H + 1, ds)
        return dict(cstate, xs_guess=xs_guess, us_guess=us_guess)

    def step(self, cstate, new_obs):
        params = self._model_params
        x = self.model.update_state_core(
            params, cstate["model_state"], cstate["last_u"], new_obs)
        xs, us = self._solve(params, x[None], cstate["xs_guess"][None],
                             cstate["us_guess"][None])
        xs, us = xs[0], us[0]
        # The next step starts from this solution.
        return us[0], dict(model_state=x, last_u=us[0], xs_guess=xs, us_guess=us)
