"""ARX: linear autoregression with exogenous inputs (port of
``autompc_tpu/sysid/arx.py``).

History-window feature vectors, one least-squares fit and the
companion-form (A, B). The feature matrices of a whole TrajectoryBatch
are built by shifts that clamp to the first step and fitted with one
masked least-squares solve, on the device of the data.

State layout:
``[obs_t, (obs_{t-1}, ctrl_{t-1}), ..., (obs_{t-k+1}, ctrl_{t-k+1}), 1]``
so ``state_dim = n + (k-1)(n+m) + 1``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..config import ConfigurationSpace, UniformIntegerHyperparameter
from ..core.trajectory import batch as traj_batch
from ..ops.lstsq import masked_lstsq
from .model import Model, ModelFactory


class ARXFactory(ModelFactory):
    r"""ARX learns :math:`x_{t+1} = [x_t, \ldots, x_{t-k+1}, u_t, \ldots,
    u_{t-k+1}, 1]\,\theta` by least squares.

    Hyperparameters:

    - *history* (int, 1..10, default 4): history window size.

    The models run on the card unless the factory is given ``device``.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Model = ARX
        self.name = "ARX"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        cs.add_hyperparameter(
            UniformIntegerHyperparameter("history", lower=1, upper=10, default_value=4)
        )
        return cs


def linear_pred(params, state, ctrl):
    """``A x + B u`` over every leading axis. With one model a lane
    (``A`` (B, ds, ds), ``B`` (B, ds, dc)), lane b's points (the leading
    axis of ``state`` and ``ctrl``) go through lane b's model."""
    A, B = params["A"], params["B"]
    if A.ndim == 2:
        return state @ A.mT + ctrl @ B.mT
    return (torch.einsum("bij,b...j->b...i", A, state)
            + torch.einsum("bij,b...j->b...i", B, ctrl))


def linear_pred_diff(params, state, ctrl):
    """``pred_diff`` of a linear model: (pred, Jx, Ju) with (A, B)
    copied to every point of the leading axes of ``state`` (contiguous,
    as the kernels take them); one model or one a lane as in
    ``linear_pred``."""
    A, B = params["A"], params["B"]
    lead = state.shape[:-1]

    def spread(M):
        if M.ndim == 3:    # lane b's matrix at lane b's points
            M = M.reshape((M.shape[0],) + (1,) * (len(lead) - 1) + M.shape[1:])
        return M.expand(lead + M.shape[-2:]).contiguous()

    return linear_pred(params, state, ctrl), spread(A), spread(B)


class ARX(Model):
    def __init__(self, system, history, device=None):
        super().__init__(system)
        self.k = int(history)
        self.device = resolve_device(device)
        self.A = None
        self.B = None
        self.coeffs = None

    # -- dimensions ----------------------------------------------------
    def _fvec_size(self) -> int:
        n, m, k = self.system.obs_dim, self.system.ctrl_dim, self.k
        return 1 + k * (n + m)

    @property
    def state_dim(self) -> int:
        return self._fvec_size() - self.system.ctrl_dim

    # -- feature construction -------------------------------------------
    def _all_features(self, obs, ctrls):
        """(..., T, n), (..., T, m) -> (..., T, fvec_size). Row r is the
        feature vector whose prediction target is obs[r+1]: [obs_r,
        obs_{r-1}, ctrl_{r-1}, ..., obs_{r-k+1}, ctrl_{r-k+1}, 1, ctrl_r],
        the history before t=0 clamped to the first step."""
        T = obs.shape[-2]

        def shift(x, i):
            # Clamped, so a trajectory shorter than the window still
            # gives T rows (everything saturates at the first step).
            pad = min(i, T)
            first = x[..., :1, :].expand(x.shape[:-2] + (pad, x.shape[-1]))
            return torch.cat([first, x[..., : max(T - i, 0), :]], dim=-2)

        parts = [obs]
        for i in range(1, self.k):
            parts.append(shift(obs, i))
            parts.append(shift(ctrls, i))
        parts.append(obs.new_ones(obs.shape[:-1] + (1,)))
        parts.append(ctrls)
        return torch.cat(parts, dim=-1)

    # -- state handling --------------------------------------------------
    def traj_to_state(self, traj):
        return self._all_features(traj.obs, traj.ctrls)[-1, : -self.system.ctrl_dim]

    def traj_to_states(self, traj):
        return self._all_features(traj.obs, traj.ctrls)[:, : -self.system.ctrl_dim]

    def update_state_core(self, params, state, new_ctrl, new_obs):
        """Advance the companion system, then overwrite the predicted
        observation with the measured one; batched over every leading
        axis."""
        newstate = linear_pred(params, state, new_ctrl)
        n = self.system.obs_dim
        return torch.cat([new_obs.to(newstate.dtype), newstate[..., n:]], dim=-1)

    # -- training --------------------------------------------------------
    def train(self, trajs, silent=False):
        tb = traj_batch(trajs)
        self.device = tb.obs.device
        feats = self._all_features(tb.obs, tb.ctrls)               # (B, T, f)
        targets = torch.roll(tb.obs, -1, dims=1)                   # row r -> obs[r+1]
        mask = tb.step_mask()                                      # valid transitions
        f = self._fvec_size()
        coeffs = masked_lstsq(feats.reshape(-1, f), targets.reshape(-1, self.system.obs_dim),
                              mask.reshape(-1)).T                   # (n, f)
        self.coeffs = coeffs.contiguous()
        self._assemble_companion(coeffs.detach().cpu().numpy())

    def _assemble_companion(self, coeffs: np.ndarray):
        """Companion-form (A, B) from the regression coefficients."""
        n, m, k = self.system.obs_dim, self.system.ctrl_dim, self.k
        ds = self.state_dim
        A = np.zeros((ds, ds))
        B = np.zeros((ds, m))
        blk = n + m
        # The constant term carries through.
        A[-1, -1] = 1.0
        # The current observation shifts into the first history slot.
        if k > 1:
            A[n : 2 * n, 0:n] = np.eye(n)
        # Older history pairs shift down.
        for i in range(k - 2):
            A[(i + 1) * blk + n : (i + 2) * blk + n, i * blk + n : (i + 1) * blk + n] = (
                np.eye(blk)
            )
        # The new observation from [obs, history, 1].
        A[0:n, :] = coeffs[:, :-m]
        # The new control: its share of the prediction, and into the history.
        B[0:n, :] = coeffs[:, -m:]
        if 2 * n + m <= ds:
            B[2 * n : 2 * n + m, :] = np.eye(m)
        on = dict(dtype=default_dtype(self.device), device=self.device)
        self.A = torch.as_tensor(A, **on)
        self.B = torch.as_tensor(B, **on)

    # -- prediction ------------------------------------------------------
    def pred_core(self, params, state, ctrl):
        return linear_pred(params, state, ctrl)

    def pred_diff_core(self, params, state, ctrl):
        # A linear model: the Jacobians are (A, B) exactly.
        return linear_pred_diff(params, state, ctrl)

    def to_linear(self):
        return self.A, self.B

    # -- parameters ------------------------------------------------------
    @property
    def params(self):
        return {"A": self.A, "B": self.B}

    def get_parameters(self):
        return {
            "coeffs": self.coeffs.detach().cpu().numpy().copy(),
            "A": self.A.detach().cpu().numpy().copy(),
            "B": self.B.detach().cpu().numpy().copy(),
        }

    def set_parameters(self, params):
        """Load ``{"coeffs", "A", "B"}`` arrays, e.g. the JAX package's
        ``ARX.get_parameters()`` output."""
        on = dict(dtype=default_dtype(self.device), device=self.device)
        self.coeffs = torch.as_tensor(np.asarray(params["coeffs"], dtype=float), **on)
        self.A = torch.as_tensor(np.asarray(params["A"], dtype=float), **on)
        self.B = torch.as_tensor(np.asarray(params["B"], dtype=float), **on)
