"""Koopman lifted-linear model (port of ``autompc_tpu/sysid/koopman.py``).

Observations are lifted through a basis (identity, optional powers
2..poly_degree, optional sin/cos at frequencies 1..trig_freq), then
``Psi(x)' = A Psi(x) + B u`` is fitted by the pseudo-inverse
(``"lstsq"``), the FISTA Lasso (``"lasso"``) or the stable-Koopman
projected-gradient solve (``"stable"``), on the device of the data. The
basis keeps the JAX package's deliberate fix of the reference's quirks:
the trig frequencies span 1..trig_freq.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..config import (
    CategoricalHyperparameter,
    ConfigurationSpace,
    InCondition,
    UniformFloatHyperparameter,
    UniformIntegerHyperparameter,
)
from ..core.trajectory import batch as traj_batch
from ..ops.lstsq import fista_lasso, pinv
from .arx import linear_pred, linear_pred_diff
from .model import Model, ModelFactory
from .stable_koopman import stabilize_discrete


class KoopmanFactory(ModelFactory):
    r"""Identifies :math:`\Psi(x)' = A\Psi(x) + Bu` over state-only basis
    functions (control-affine lifting, amenable to LQR).

    Hyperparameters:

    - *method* (categorical ["lstsq", "lasso", "stable"])
    - *lasso_alpha* (float, 1e-10..1e2, log; conditioned on method=lasso)
    - *poly_basis* ("true"/"false"), *poly_degree* (2..8, cond)
    - *trig_basis* ("true"/"false"), *trig_freq* (1..8, cond)
    - *product_terms* (categorical ["false"]: declared but disabled, as
      in the reference's space)

    The models run on the card unless the factory is given ``device``.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Model = Koopman
        self.name = "Koopman"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        method = CategoricalHyperparameter("method", choices=["lstsq", "lasso", "stable"])
        lasso_alpha = UniformFloatHyperparameter(
            "lasso_alpha", lower=1e-10, upper=1e2, default_value=1.0, log=True
        )
        poly_basis = CategoricalHyperparameter(
            "poly_basis", choices=["true", "false"], default_value="false"
        )
        poly_degree = UniformIntegerHyperparameter("poly_degree", lower=2, upper=8,
                                                   default_value=3)
        trig_basis = CategoricalHyperparameter(
            "trig_basis", choices=["true", "false"], default_value="false"
        )
        trig_freq = UniformIntegerHyperparameter("trig_freq", lower=1, upper=8, default_value=1)
        product_terms = CategoricalHyperparameter(
            "product_terms", choices=["false"], default_value="false"
        )
        cs.add_hyperparameters(
            [method, poly_basis, poly_degree, trig_basis, trig_freq, product_terms, lasso_alpha]
        )
        cs.add_conditions([
            InCondition("poly_degree", "poly_basis", ["true"]),
            InCondition("trig_freq", "trig_basis", ["true"]),
            InCondition("lasso_alpha", "method", ["lasso"]),
        ])
        return cs


def _as_bool(v):
    return v == "true" if isinstance(v, str) else bool(v)


class Koopman(Model):
    def __init__(
        self,
        system,
        method,
        lasso_alpha=None,
        poly_basis=False,
        poly_degree=1,
        trig_basis=False,
        trig_freq=1,
        product_terms=False,
        use_cuda=None,
        device=None,
    ):
        """``use_cuda`` is the reference's keyword and is ignored: the
        model runs on the card unless ``device`` names another device."""
        super().__init__(system)
        del use_cuda
        if method not in ("lstsq", "lasso", "stable"):
            raise ValueError(f"Unknown method {method}")
        self.method = method
        if method == "lasso" and lasso_alpha is None:
            # A factory's method override can leave the conditional
            # lasso_alpha inactive: the space's default.
            lasso_alpha = 1.0
        self.lasso_alpha = lasso_alpha
        self.poly_basis = _as_bool(poly_basis)
        self.poly_degree = int(poly_degree)
        self.trig_basis = _as_bool(trig_basis)
        self.trig_freq = int(trig_freq)
        self.product_terms = _as_bool(product_terms)
        self.device = resolve_device(device)

        # Per-function blocks over all observation dimensions:
        # [b(x) for b in funcs for x in obs].
        fns = [lambda x: x]
        if self.poly_basis:
            for i in range(2, 1 + self.poly_degree):
                fns.append(lambda x, i=i: x**i)
        if self.trig_basis:
            for i in range(1, 1 + self.trig_freq):
                fns.append(lambda x, i=i: torch.sin(i * x))
                fns.append(lambda x, i=i: torch.cos(i * x))
        self._basis_fns = fns
        self.A = None
        self.B = None

    def _apply_basis(self, obs):
        """(..., obs_dim) -> (..., state_dim) lifted states."""
        lifted = torch.cat([fn(obs) for fn in self._basis_fns], dim=-1)
        if self.product_terms:
            N = lifted.shape[-1]
            iu = torch.triu_indices(N, N, offset=1, device=lifted.device)
            outer = lifted[..., :, None] * lifted[..., None, :]
            lifted = torch.cat([lifted, outer[..., iu[0], iu[1]]], dim=-1)
        return lifted

    @property
    def state_dim(self):
        base = len(self._basis_fns) * self.system.obs_dim
        if self.product_terms:
            base += base * (base - 1) // 2
        return base

    # -- state handling ----------------------------------------------------
    def traj_to_state(self, traj):
        return self._apply_basis(traj[-1].obs)

    def traj_to_states(self, traj):
        return self._apply_basis(traj.obs)

    def update_state_core(self, params, state, new_ctrl, new_obs):
        """The new observation lifted (batched over every leading axis)."""
        return self._apply_basis(new_obs)

    # -- training ------------------------------------------------------------
    def lifted_transitions(self, trajs):
        """The valid transitions of ``trajs`` lifted: X, Y (S, N) and
        U (S, m), one row a transition (t -> t+1), in the order of the
        JAX package's host gather."""
        tb = traj_batch(trajs)
        lifted = self._apply_basis(tb.obs)                  # (B, T, N)
        idx_b, idx_t = torch.nonzero(tb.step_mask(), as_tuple=True)
        return lifted[idx_b, idx_t], lifted[idx_b, idx_t + 1], tb.ctrls[idx_b, idx_t]

    def train(self, trajs, silent=False):
        X, Y, U = self.lifted_transitions(trajs)
        self.device = X.device
        X, Y, U = X.T, Y.T, U.T                              # (N, S), (N, S), (m, S)
        n = X.shape[0]
        XU = torch.cat([X, U], dim=0)
        if self.method == "lstsq":
            AB = Y @ pinv(XU)
            A, B = AB[:, :n], AB[:, n:]
        elif self.method == "lasso":
            AB = fista_lasso(XU.T, Y.T, self.lasso_alpha).T
            A, B = AB[:, :n], AB[:, n:]
        else:
            A, _, _, _, B, _ = stabilize_discrete(X, U, Y)
        self.A, self.B = A.contiguous(), B.contiguous()

    # -- prediction ------------------------------------------------------------
    @property
    def params(self):
        return {"A": self.A, "B": self.B}

    def pred_core(self, params, state, ctrl):
        return linear_pred(params, state, ctrl)

    def pred_diff_core(self, params, state, ctrl):
        # A linear model in the lifted state: the Jacobians are (A, B).
        return linear_pred_diff(params, state, ctrl)

    def to_linear(self):
        return self.A, self.B

    def get_parameters(self):
        return {"A": self.A.detach().cpu().numpy().copy(),
                "B": self.B.detach().cpu().numpy().copy()}

    def set_parameters(self, params):
        """Load ``{"A", "B"}`` arrays, e.g. the JAX package's
        ``Koopman.get_parameters()`` output."""
        on = dict(dtype=default_dtype(self.device), device=self.device)
        self.A = torch.as_tensor(np.asarray(params["A"], dtype=float), **on)
        self.B = torch.as_tensor(np.asarray(params["B"], dtype=float), **on)
