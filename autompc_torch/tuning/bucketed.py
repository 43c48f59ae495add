"""Bucketed batch training of model candidates (port of
``autompc_tpu/tuning/bucketed.py``).

A model tuner trains one model per candidate. Candidates that share a
bucket here train and score together: every candidate is one slot of a
leading candidate axis of each tensor, where the JAX package has a
``vmap``, so a bucket is one batched training and one batched k-step
holdout RMSE whatever its size.

- ARX: every history value 1..kmax is ARX(kmax) with a column mask on
  the shared feature matrix (``_arx_feature_col_mask``); one masked
  least-squares solve over the (C, N, f) stack. Zeroed columns add
  nothing to the residual and the SVD minimum-norm solution gives them
  coefficient 0 (``ops/lstsq.py::lstsq``'s cutoff), so a candidate
  predicts as the unpadded ARX(history=k).
- SINDy: candidates sharing a basis library (method, time mode, basis
  flags) differ in the STLSQ threshold or the lasso alpha: one
  Gram-staged ``stlsq_gram`` or one ``fista_lasso`` with a regularizer a
  lane.
- Koopman (method lasso): candidates sharing a lifting differ in the
  alpha: one ``fista_lasso`` on the lifted data, the RMSE in the lifted
  space.
- MLP: candidates sharing (n_hidden_layers, nonlintype) train as masked
  ``max_width`` nets (``_mlp_masks``), all lanes through one Adam run
  (``parallel/fanout.py::train_lanes``), every lane from the net ``MLP``
  draws for the seed at its true sizes (``_mlp_padded_init``) and the
  epoch orders ``MLP.train`` takes for it (``sysid/mlp.py::epoch_perms``).

Every evaluator works on the device of the trajectories it is given and
returns Python floats, a score that is not finite as ``inf``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.trajectory import batch as traj_batch
from ..evaluation.model_metrics import kstep_rmse
from ..ops.lstsq import fista_lasso, gram_stage, masked_lstsq, stlsq_gram
from ..parallel.fanout import train_lanes
from ..sysid.basis import finite_difference
from ..sysid.mlp import epoch_perms, net_apply, net_init, zscore_pairs


def _floats(rmses):
    """(C,) scores -> a list of floats, a score that is not finite as inf."""
    return [float(v) if np.isfinite(v) else float("inf") for v in rmses.detach().cpu().numpy()]


def _lanes(u, state):
    """Controls (Bh, S, m) spread over the candidate axis of ``state``."""
    return u.expand(state.shape[:-1] + u.shape[-1:])


def _arx_feature_col_mask(n, m, kmax, k):
    """0/1 mask over the padded ARX feature vector
    ``[obs, (obs, ctrl) x (kmax-1), 1, ctrl]`` keeping exactly the
    columns an ARX(history=k) model uses (sysid/arx.py state layout)."""
    f = 1 + kmax * (n + m)
    mask = np.zeros(f)
    mask[:n] = 1.0
    blk = n + m
    for i in range(1, k):
        mask[n + (i - 1) * blk : n + i * blk] = 1.0
    mask[-(1 + m):] = 1.0
    return mask


def make_arx_bucket_program(system, kmax: int, horizon: int = 1, device=None):
    """``evaluate(train_obs, train_ctrls, train_mask, hold_obs,
    hold_ctrls, hold_lengths, col_masks) -> (rmses (C,), As (C, ds, ds),
    Bs (C, ds, m))``: trains every column-masked ARX candidate and scores
    its k-step holdout RMSE in one batched computation.

    All candidates share the padded state layout of ARX(history=kmax),
    ``ds = n + (kmax-1)(n+m) + 1``; their companion matrices differ only
    in the coefficient rows. The tensors live on ``device`` (the card
    unless named)."""
    from ..sysid.arx import ARX

    n, m = system.obs_dim, system.ctrl_dim
    device = resolve_device(device)
    arx = ARX(system, kmax, device=device)
    ds = arx.state_dim
    f = arx._fvec_size()
    blk = n + m

    # The companion structure (sysid/arx.py::_assemble_companion) with
    # the coefficient rows left zero; filled per candidate.
    A_base = np.zeros((ds, ds))
    B_base = np.zeros((ds, m))
    A_base[-1, -1] = 1.0
    if kmax > 1:
        A_base[n : 2 * n, 0:n] = np.eye(n)
    for i in range(kmax - 2):
        A_base[(i + 1) * blk + n : (i + 2) * blk + n, i * blk + n : (i + 1) * blk + n] = \
            np.eye(blk)
    if 2 * n + m <= ds:
        B_base[2 * n : 2 * n + m, :] = np.eye(m)

    def evaluate(train_obs, train_ctrls, train_mask, hold_obs, hold_ctrls, hold_lengths,
                 col_masks):
        """train_obs (Bt, T, n), train_ctrls (Bt, T, m), train_mask (Bt,
        T) the valid-transition mask; hold_* the holdout batch;
        col_masks (C, f)."""
        on = dict(dtype=train_obs.dtype, device=train_obs.device)
        feats = arx._all_features(train_obs, train_ctrls)
        targets = torch.roll(train_obs, -1, dims=1)
        A_mat = feats.reshape(-1, f)
        y = targets.reshape(-1, n)
        cm = col_masks.to(**on)
        coeffs = masked_lstsq(A_mat[None] * cm[:, None, :], y, train_mask.reshape(-1)).mT
        C = cm.shape[0]
        As = torch.as_tensor(A_base, **on).repeat(C, 1, 1)
        Bs = torch.as_tensor(B_base, **on).repeat(C, 1, 1)
        As[:, 0:n, :] = coeffs[:, :, :-m]
        Bs[:, 0:n, :] = coeffs[:, :, -m:]

        T = hold_obs.shape[1]
        hold_states = arx._all_features(hold_obs, hold_ctrls)[:, : T - horizon, : f - m]

        def step(state, u):
            return (torch.einsum("cij,cbtj->cbti", As, state)
                    + torch.einsum("cij,btj->cbti", Bs, u))

        rmses = kstep_rmse(step, hold_states.expand((C,) + hold_states.shape), hold_obs,
                            hold_ctrls, hold_lengths, horizon)
        return rmses, As, Bs

    return evaluate


class ARXBucketEvaluator:
    """The ARX bucket program with its train and holdout arrays and the
    kmax column masks staged once, on the trajectories' device; maps a
    list of history values to holdout RMSEs in one call."""

    def __init__(self, system, training_set, holdout, kmax: int = 10, horizon: int = 1):
        self.system = system
        self.kmax = int(kmax)
        self.horizon = int(horizon)
        tb_train = traj_batch(training_set)
        tb_hold = traj_batch(holdout)
        self._program = make_arx_bucket_program(system, self.kmax, horizon=self.horizon,
                                                device=tb_train.obs.device)
        self._train_args = (tb_train.obs, tb_train.ctrls, tb_train.step_mask())
        self._hold_args = (tb_hold.obs, tb_hold.ctrls, tb_hold.lengths)
        n, m = system.obs_dim, system.ctrl_dim
        self._masks = torch.as_tensor(
            np.stack([_arx_feature_col_mask(n, m, self.kmax, k)
                      for k in range(1, self.kmax + 1)]),
            dtype=tb_train.obs.dtype, device=tb_train.obs.device)

    def __call__(self, ks):
        """ks: history values (1..kmax). Returns float RMSEs aligned
        with ks."""
        col_masks = self._masks[[int(k) - 1 for k in ks]]
        rmses, _, _ = self._program(*self._train_args, *self._hold_args, col_masks)
        return _floats(rmses)


class SINDyBucketEvaluator:
    """SINDy bucket: candidates sharing the basis-library configuration
    (method, time mode, poly/trig settings) differ only in the STLSQ
    threshold or the lasso alpha, so the whole batch trains through one
    solve with a regularizer a lane on the shared feature matrix
    (``stlsq_gram`` on the Gram matrices staged once, or ``fista_lasso``)
    and scores through one k-step RMSE. As in the JAX package, a lane
    whose Gram solve is not finite scores inf (no SVD fallback)."""

    def __init__(self, system, training_set, holdout, bucket_cfg: dict, horizon: int = 1):
        from ..sysid.sindy import SINDy

        self.system = system
        self.horizon = int(horizon)
        self.method = bucket_cfg.get("method", "lstsq")
        tb = traj_batch(training_set)
        skeleton = SINDy(system, device=tb.obs.device, **bucket_cfg)
        self._library = library = skeleton.library
        self._continuous = skeleton.time_mode == "continuous"
        n = system.obs_dim

        feats = library(torch.cat([tb.obs, tb.ctrls], dim=-1))
        if self._continuous:
            targets = finite_difference(tb.obs.transpose(0, 1), system.dt).transpose(0, 1)
            mask = tb.mask()
        else:
            targets = torch.roll(tb.obs, -1, dims=1)
            mask = tb.step_mask()
        self._A = feats.reshape(-1, library.n_features)
        self._y = targets.reshape(-1, n)
        self._rmask = mask.reshape(-1)
        if self.method != "lasso":
            # Every candidate trains against the same matrix, so each
            # lane's STLSQ is (F, F) solves.
            self._G, self._b = gram_stage(self._A, self._y, mask=self._rmask)
        tb_h = traj_batch(holdout)
        self._hold = (tb_h.obs, tb_h.ctrls, tb_h.lengths)

    def __call__(self, regs):
        """regs: STLSQ thresholds (method lstsq) or lasso alphas (method
        lasso). Returns float RMSEs aligned with regs."""
        reg = torch.as_tensor([float(r) for r in regs], dtype=self._A.dtype,
                              device=self._A.device)
        if self.method == "lasso":
            coefs = fista_lasso(self._A, self._y, reg, mask=self._rmask)
        else:
            coefs = stlsq_gram(self._G, self._b, reg)
        coeffs = coefs.mT                                      # (C, n, F)
        library, dt, continuous = self._library, self.system.dt, self._continuous

        def step(state, u):
            theta = library(torch.cat([state, _lanes(u, state)], dim=-1))
            out = torch.einsum("cbtf,cnf->cbtn", theta, coeffs)
            return state + dt * out if continuous else out

        hobs, hctrls, hlens = self._hold
        S = hobs.shape[1] - self.horizon
        states0 = hobs[:, :S].expand((coeffs.shape[0],) + hobs[:, :S].shape)
        return _floats(kstep_rmse(step, states0, hobs, hctrls, hlens, self.horizon))


class KoopmanLassoBucketEvaluator:
    """Koopman (method lasso) bucket: candidates sharing a lifting
    configuration differ only in the lasso alpha, so the lifted data are
    staged once and the batch trains through one ``fista_lasso`` with an
    alpha a lane and one k-step RMSE in the lifted space. (Method lstsq
    has no per-candidate value and method stable runs the FGM loop: they
    stay per candidate.)"""

    def __init__(self, system, training_set, holdout, bucket_cfg: dict, horizon: int = 1):
        from ..sysid.koopman import Koopman

        self.system = system
        self.horizon = int(horizon)
        tb = traj_batch(training_set)
        skeleton = Koopman(system, method="lasso", lasso_alpha=1.0, device=tb.obs.device,
                           **bucket_cfg)
        lift = skeleton._apply_basis
        self._N = N = skeleton.state_dim
        lifted = lift(tb.obs)                                  # (B, T, N)
        X = lifted.reshape(-1, N)
        Y = torch.roll(lifted, -1, dims=1).reshape(-1, N)
        U = tb.ctrls.reshape(-1, system.ctrl_dim)
        self._XU = torch.cat([X, U], dim=1)
        self._Y = Y
        self._rmask = tb.step_mask().reshape(-1)
        tb_h = traj_batch(holdout)
        self._hlift = lift(tb_h.obs)                           # (Bh, T, N)
        self._hold = (tb_h.obs, tb_h.ctrls, tb_h.lengths)

    def __call__(self, alphas):
        """alphas: lasso alphas. Returns float RMSEs aligned with them."""
        a = torch.as_tensor([float(x) for x in alphas], dtype=self._XU.dtype,
                            device=self._XU.device)
        AB = fista_lasso(self._XU, self._Y, a, mask=self._rmask).mT   # (C, N, N+m)
        N = self._N
        A, Bm = AB[:, :, :N], AB[:, :, N:]

        def step(state, u):
            return (torch.einsum("cij,cbtj->cbti", A, state)
                    + torch.einsum("cij,btj->cbti", Bm, u))

        hobs, hctrls, hlens = self._hold
        S = hobs.shape[1] - self.horizon
        states0 = self._hlift[:, :S].expand((AB.shape[0],) + self._hlift[:, :S].shape)
        return _floats(kstep_rmse(step, states0, hobs, hctrls, hlens, self.horizon))


def _mlp_masks(nxu, nx, widths, max_width):
    """Per-layer weight and bias masks (numpy 0/1 arrays) embedding an
    MLP with hidden widths ``widths`` inside the max-width net. The masks
    multiply the weights inside the forward pass, so a masked entry's
    gradient is exactly zero and the lane trains as the unpadded net
    (Adam moments included)."""
    L = len(widths)
    wmasks, bmasks = [], []
    col = np.zeros(max_width)
    col[: widths[0]] = 1.0
    wmasks.append(np.broadcast_to(col, (nxu, max_width)).copy())
    bmasks.append(col.copy())
    for i in range(1, L):
        row = np.zeros(max_width)
        row[: widths[i - 1]] = 1.0
        col = np.zeros(max_width)
        col[: widths[i]] = 1.0
        wmasks.append(np.outer(row, col))
        bmasks.append(col.copy())
    row = np.zeros(max_width)
    row[: widths[-1]] = 1.0
    wmasks.append(np.broadcast_to(row[:, None], (max_width, nx)).copy())
    bmasks.append(np.ones(nx))
    return wmasks, bmasks


def _mlp_padded_init(seed, nxu, nx, widths, max_width, dtype, device):
    """The initial weights ``MLP`` draws for ``seed`` at the candidate's
    true sizes (``sysid/mlp.py::net_init``), embedded in the max-width
    layout with zeros elsewhere: a list of ``{"W", "b"}`` tensors."""
    sizes = [nxu] + [int(w) for w in widths] + [nx]
    L = len(widths)
    shapes = [(nxu, max_width)] + [(max_width, max_width)] * (L - 1) + [(max_width, nx)]
    padded = []
    for layer, shape in zip(net_init(sizes, seed, dtype, device), shapes):
        W = torch.zeros(shape, dtype=dtype, device=device)
        W[: layer["W"].shape[0], : layer["W"].shape[1]] = layer["W"]
        b = torch.zeros(shape[1], dtype=dtype, device=device)
        b[: layer["b"].shape[0]] = layer["b"]
        padded.append({"W": W, "b": b})
    return padded


def _mlp_lanes(width_lists, nxu, nx, max_width, seed, on, init_nets=None):
    """Every lane's initial max-width net and masks, each a list of
    per-layer (B, ...) tensors (``on``: their dtype and device): the net
    ``MLP`` draws for ``seed`` at the lane's widths, or the lanes' rows
    of ``init_nets`` (per-layer ``{"W", "b"}`` arrays). Returns (net0,
    wmasks, bmasks)."""
    masks = [_mlp_masks(nxu, nx, w, max_width) for w in width_lists]
    wmasks = [torch.as_tensor(np.stack(la), **on) for la in zip(*(w for w, _ in masks))]
    bmasks = [torch.as_tensor(np.stack(la), **on) for la in zip(*(b for _, b in masks))]
    if init_nets is None:
        nets = [_mlp_padded_init(seed, nxu, nx, w, max_width, on["dtype"], on["device"])
                for w in width_lists]
        net0 = [{k: torch.stack([net[i][k] for net in nets]) for k in ("W", "b")}
                for i in range(len(wmasks))]
    else:
        net0 = [{k: torch.as_tensor(np.asarray(la[k]) if not isinstance(la[k], torch.Tensor)
                                    else la[k], **on) for k in ("W", "b")}
                for la in init_nets]
    return net0, wmasks, bmasks


class MLPBucketEvaluator:
    """Masked max-width MLP bucket: every (widths, lr) candidate with the
    same (n_hidden_layers, nonlintype) trains through one per-lane Adam
    run (``train_lanes``: ``MLP.train``'s epochs, batches and Huber loss,
    a learning rate a lane) and scores through one k-step holdout RMSE.
    Width padding is exact (``_mlp_masks``): a lane trains as the
    per-configuration ``MLP`` of its widths and seed, up to the
    reassociation of its sums."""

    def __init__(self, system, training_set, holdout, n_hidden_layers, nonlintype,
                 horizon: int = 1, max_width: int = 256, n_train_iters: int = 50,
                 n_batch: int = 64, seed: int = 100):
        self.system = system
        self.L = int(n_hidden_layers)
        self.nonlintype = str(nonlintype)
        self.max_width = int(max_width)
        self.horizon = int(horizon)
        self.seed = int(seed)
        self.n_train_iters = int(n_train_iters)
        self.n_batch = int(n_batch)
        self._nx = system.obs_dim
        self._nxu = system.obs_dim + system.ctrl_dim
        # The training pairs, staged and z-scored as MLP.train does.
        self._XUt, self._dYt, self._norm = zscore_pairs(training_set)
        tb_h = traj_batch(holdout)
        self._hold = (tb_h.obs, tb_h.ctrls, tb_h.lengths)

    def __call__(self, width_lists, lrs, init_nets=None, perms=None):
        """width_lists: length-L hidden widths a candidate; lrs: learning
        rates. ``init_nets`` (a list of per-layer ``{"W", "b"}`` arrays of
        the candidates' padded nets) and ``perms`` (the epochs' row
        orders) replace the nets and orders drawn for ``seed``. Returns
        float RMSEs aligned with the candidates."""
        on = dict(dtype=self._XUt.dtype, device=self._XUt.device)
        net0, wmasks, bmasks = _mlp_lanes(width_lists, self._nxu, self._nx, self.max_width,
                                          self.seed, on, init_nets)
        if perms is None:
            perms = epoch_perms(self._XUt.shape[0], self.n_batch, self.n_train_iters,
                                self.seed, on["device"])
        else:
            perms = [torch.as_tensor(np.array(p), device=on["device"]) for p in perms]
        lr = torch.as_tensor([float(x) for x in lrs], **on)
        trained = train_lanes(net0, wmasks, bmasks, lr, self._XUt, self._dYt, perms,
                              self.n_batch, self.nonlintype)
        net = [{"W": la["W"] * wm, "b": la["b"] * bm}
               for la, wm, bm in zip(trained, wmasks, bmasks)]
        xu_means, xu_std, dy_means, dy_std = self._norm
        nonlin = self.nonlintype

        def step(state, u):
            xut = (torch.cat([state, _lanes(u, state)], dim=-1) - xu_means) / xu_std
            return state + (net_apply(net, xut, nonlin) * dy_std + dy_means)

        hobs, hctrls, hlens = self._hold
        S = hobs.shape[1] - self.horizon
        with torch.no_grad():
            states0 = hobs[:, :S].expand((len(width_lists),) + hobs[:, :S].shape)
            return _floats(kstep_rmse(step, states0, hobs, hctrls, hlens, self.horizon))
