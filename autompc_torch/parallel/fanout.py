"""Tuning fan-out: score a batch of candidate configurations in one
batched program (port of ``autompc_tpu/parallel/fanout.py``:
``QuadCostFanout`` and ``JointMLPQuadCostFanout``).

For configuration families whose hyperparameters do not change tensor
shapes (cost gains), the whole candidate evaluation — controller
synthesis (an iLQR solve per closed-loop step), the closed-loop rollout
on the surrogate and the task metric — runs over the candidate batch at
once: every solve sees (B, ...) tensors and the solver's kernels. This
is what a tune spends its time in. ``JointMLPQuadCostFanout`` also
trains a fresh MLP per candidate, every lane its own masked max-width
net, before its closed loop.

The joint SINDy, ARX, Koopman and GP fan-outs, the direct-transcription
and MPPI fan-outs, ``impl="vmap"``, the GaussReg term and the device
mesh of the JAX package are not ported yet (ROADMAP.md §A).
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
from ..sysid.mlp import epoch_perms, net_apply, net_apply_jac, zscore_pairs
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
    (B, n)}`` (and ``"horizons"`` (B,) with ``horizon_mask``) and returns
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
    the TPU kernels and is ignored; ``mesh`` and ``reg_matrix`` raise.
    Runs on the card unless ``device`` names another device.
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
        del block_b, reg_goal
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
            horizon_mask=self._horizon_mask,
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
            stage = (task_cost.eval_obs_cost(torch.stack(obs_seq)).sum(0)
                     + task_cost.eval_obs_cost(obs))
            ctrlc = task_cost.eval_ctrl_cost(torch.stack(ctrl_seq)).sum(0)
            total = stage + ctrlc + task_cost.eval_term_obs_cost(obs)
            return torch.where(torch.isfinite(total), total,
                               torch.full_like(total, float("inf")))

        self._eval = eval_batch

    def _prepare(self, batch, init_nets=None):
        """Stage a candidate batch: the lanes padded (copies of the last
        candidate) to a multiple of ``PAD_QUANTUM`` and at least
        ``pad_to``, each lane's initial max-width net and masks from its
        widths. ``init_nets`` (a list of per-layer ``{"W", "b"}`` arrays
        of the B candidates' padded nets) replaces the initial nets.
        Returns (the staged dict, B)."""
        from ..tuning.bucketed import _mlp_masks, _mlp_padded_init

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
        wmasks, bmasks = zip(*(_mlp_masks(self._nxu, self._nx, w, self._max_width)
                               for w in widths_list))

        def stack(per_lane):
            return [torch.as_tensor(np.stack(layer), **on) for layer in zip(*per_lane)]

        if init_nets is None:
            nets = [_mlp_padded_init(self._seed, self._nxu, self._nx, w, self._max_width,
                                     on["dtype"], self.device) for w in widths_list]
            net0 = [{k: torch.stack([n[i][k] for n in nets]) for k in ("W", "b")}
                    for i in range(self._L + 1)]
        else:
            net0 = [{k: pad(layer[k]) for k in ("W", "b")} for layer in init_nets]
        full = {
            "net0": net0, "wmasks": stack(wmasks), "bmasks": stack(bmasks),
            "lr": pad(batch["lr"]),
            "Qdiag": pad(batch["Qdiag"]), "Rdiag": pad(batch["Rdiag"]),
            "Fdiag": pad(batch["Fdiag"]),
        }
        if self._horizon_mask:
            full["horizons"] = pad(np.asarray(batch["horizons"], dtype=np.int64))
        return full, B

    def _solver_inputs(self, full, nets):
        """The closed loop's solver inputs for the staged batch ``full``
        and its trained ``nets``: the per-lane params (the masks folded
        into the weights) and cost params."""
        params = {"net": [{"W": la["W"] * wm, "b": la["b"] * bm} for la, wm, bm in
                          zip(nets, full["wmasks"], full["bmasks"])]}
        cost_params = {k: full[k] for k in ("Qdiag", "Rdiag", "Fdiag")}
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
