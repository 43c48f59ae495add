"""SINDy: sparse identification of nonlinear dynamics (port of
``autompc_tpu/sysid/sindy.py``).

Discrete-time (fit x_{t+1}) and continuous-time (fit the finite-
difference x_dot, integrate with Euler) modes. Training is the
Gram-staged STLSQ with the SVD-STLSQ fallback when the normal
equations give non-finite coefficients. The Lasso method and the
``SINDyFactory`` (it needs the configuration space) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_dtype, resolve_device
from ..core.trajectory import batch as traj_batch
from ..ops.lstsq import gram_stage, stlsq, stlsq_gram
from .basis import FeatureLibrary, finite_difference
from .model import Model


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
        if method != "lstsq":
            raise ValueError(
                f"SINDy method {method!r} is not ported yet; use 'lstsq'"
            )
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
