"""SINDy: sparse identification of nonlinear dynamics (port of
``autompc_tpu/sysid/sindy.py``).

Discrete-time (fit x_{t+1}) and continuous-time (fit the finite-
difference x_dot, integrate with Euler) modes. Training is the
Gram-staged STLSQ with the SVD-STLSQ fallback when the normal
equations give non-finite coefficients, or the FISTA Lasso
(``method="lasso"``). ``SINDyFactory`` builds and trains one from a
configuration of its space.
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
from ..ops.lstsq import fista_lasso, gram_stage, stlsq, stlsq_gram
from .basis import FeatureLibrary, finite_difference
from .model import Model, ModelFactory


class SINDyFactory(ModelFactory):
    r"""SINDy fits :math:`\dot{x} = K\,\Theta(x, u)` (or the discrete
    analog) over a basis library.

    Hyperparameters:

    - *time_mode* (categorical ["discrete", "continuous"])
    - *method* (categorical ["lstsq", "lasso"])
    - *threshold* (float, 1e-5..1e1, log, default 1e-2): STLSQ cut
    - *lasso_alpha* (float, 1e-5..1e2, log; conditioned on method=lasso)
    - *poly_basis* ("true"/"false"), *poly_degree* (2..8, cond),
      *poly_cross_terms* ("true"/"false")
    - *trig_basis* ("true"/"false"), *trig_freq* (1..8, cond),
      *trig_interaction* (cond on trig_basis)

    The models run on the card unless the factory is given ``device``.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.Model = SINDy
        self.name = "SINDy"

    def get_configuration_space(self):
        cs = ConfigurationSpace()
        true_false = dict(choices=["true", "false"], default_value="false")
        cs.add_hyperparameters([
            CategoricalHyperparameter("method", choices=["lstsq", "lasso"]),
            UniformFloatHyperparameter("lasso_alpha", lower=1e-5, upper=1e2,
                                       default_value=1.0, log=True),
            UniformFloatHyperparameter("threshold", lower=1e-5, upper=1e1,
                                       default_value=1e-2, log=True),
            CategoricalHyperparameter("poly_basis", **true_false),
            UniformIntegerHyperparameter("poly_degree", lower=2, upper=8, default_value=3),
            CategoricalHyperparameter("trig_basis", **true_false),
            UniformIntegerHyperparameter("trig_freq", lower=1, upper=8, default_value=1),
            CategoricalHyperparameter("trig_interaction", **true_false),
            CategoricalHyperparameter("poly_cross_terms", **true_false),
            CategoricalHyperparameter("time_mode", choices=["discrete", "continuous"]),
        ])
        cs.add_conditions([
            InCondition("lasso_alpha", "method", ["lasso"]),
            InCondition("poly_degree", "poly_basis", ["true"]),
            InCondition("trig_freq", "trig_basis", ["true"]),
            InCondition("trig_interaction", "trig_basis", ["true"]),
        ])
        return cs


def _as_bool(v):
    return v == "true" if isinstance(v, str) else bool(v)


class SINDy(Model):
    def __init__(
        self,
        system,
        method,
        lasso_alpha=None,
        threshold=1e-2,
        poly_basis=False,
        poly_degree=1,
        poly_cross_terms=False,
        trig_basis=False,
        trig_freq=1,
        trig_interaction=False,
        time_mode="discrete",
        device=None,
    ):
        super().__init__(system)
        if method not in ("lstsq", "lasso"):
            raise ValueError(f"unknown SINDy method {method!r}")
        if method == "lasso" and lasso_alpha is None:
            # lasso_alpha is inactive when a factory keyword sets the
            # method: the space's default.
            lasso_alpha = 1.0
        if time_mode not in ("discrete", "continuous"):
            raise ValueError(f"unknown time_mode {time_mode!r}")
        self.method = method
        self.lasso_alpha = lasso_alpha
        self.threshold = threshold
        self.time_mode = time_mode
        self.device = resolve_device(device)
        self.poly_basis = _as_bool(poly_basis)
        self.poly_degree = int(poly_degree)
        self.poly_cross_terms = _as_bool(poly_cross_terms)
        self.trig_basis = _as_bool(trig_basis)
        self.trig_freq = int(trig_freq)
        self.trig_interaction = _as_bool(trig_interaction)

        self.library = FeatureLibrary.from_config(
            system.obs_dim + system.ctrl_dim,
            poly_basis=self.poly_basis,
            poly_degree=self.poly_degree,
            poly_cross_terms=self.poly_cross_terms,
            trig_basis=self.trig_basis,
            trig_freq=self.trig_freq,
            trig_interaction=self.trig_interaction,
        )
        self.coeffs = None  # (obs_dim, n_features) on self.device

    def traj_to_state(self, traj):
        return traj[-1].obs

    @property
    def state_dim(self):
        return self.system.obs_dim

    def train(self, trajs, xdot=None, silent=False):
        tb = traj_batch(trajs)
        n = self.system.obs_dim
        dt = self.system.dt
        self.device = tb.obs.device

        feats = self.library(torch.cat([tb.obs, tb.ctrls], dim=-1))  # (B, T, F)
        if self.time_mode == "continuous":
            if xdot is None:
                targets = finite_difference(tb.obs.transpose(0, 1), dt).transpose(0, 1)
            else:
                targets = torch.as_tensor(xdot, dtype=tb.obs.dtype, device=self.device)
            mask = tb.mask()
        else:
            targets = torch.roll(tb.obs, -1, dims=1)
            mask = tb.step_mask()

        A = feats.reshape(-1, self.library.n_features)
        y = targets.reshape(-1, n)
        rmask = mask.reshape(-1)

        if self.method == "lasso":
            self.coeffs = fista_lasso(A, y, self.lasso_alpha, mask=rmask).T.contiguous()
            return
        G, bvec = gram_stage(A, y, mask=rmask)
        coefs = stlsq_gram(G, bvec, self.threshold)
        # A masked Gram that loses positive definiteness (likelier in
        # f32) gives NaN; fall back to the SVD-based STLSQ (min-norm).
        if not bool(torch.isfinite(coefs).all()):
            if not silent:
                print(
                    "SINDy: Gram-staged STLSQ produced non-finite "
                    "coefficients (ill-conditioned normal equations); "
                    "falling back to the SVD least-squares path"
                )
            coefs = stlsq(A, y, self.threshold, mask=rmask)
        self.coeffs = coefs.T.contiguous()  # (n, F)

    @property
    def params(self):
        return {"coeffs": self.coeffs}

    def pred_core(self, params, state, ctrl):
        theta = self.library(torch.cat([state, ctrl], dim=-1))
        out = theta @ params["coeffs"].T
        if self.time_mode == "continuous":
            return state + self.system.dt * out
        return out

    def get_parameters(self):
        return {
            "coeffs": self.coeffs.cpu().numpy().copy(),
            "feature_names": self.get_feature_names(),
        }

    def set_parameters(self, params):
        """Load ``{"coeffs": (obs_dim, n_features) array}`` — e.g. the
        JAX package's ``SINDy.get_parameters()`` output. When
        ``params`` names the features the coefficients were fitted on
        (``"feature_names"``), they must equal this library's names."""
        coeffs = np.asarray(params["coeffs"], dtype=np.float64)
        expect = (self.system.obs_dim, self.library.n_features)
        if coeffs.shape != expect:
            raise ValueError(
                f"coeffs shape {coeffs.shape} does not match the library "
                f"(obs_dim, n_features) = {expect}"
            )
        names = params.get("feature_names")
        if names is not None and list(names) != self.get_feature_names():
            raise ValueError(
                "coefficients were fitted on another feature library: "
                f"{list(names)} != {self.get_feature_names()}"
            )
        self.coeffs = torch.as_tensor(
            coeffs, dtype=default_dtype(self.device), device=self.device
        )

    def get_feature_names(self):
        return list(self.library.names)
