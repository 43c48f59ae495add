"""Stage costs of B lanes at once, for the sampling and the
direct-transcription controllers and their fan-outs.

The JAX package builds one cost object a candidate inside a vmap: a
``QuadCost`` of the candidate's diagonals and, with the GaussReg term, a
``SumCost`` with ``QuadCost(regw * S, 0, 0, goal=mu)``. Here a batch of
candidates is one ``DiagQuadLanes``: tensors of per-lane diagonals and
weights, the shared S and mu. ``SharedCost`` gives one ``Cost`` object
the same interface, so a controller's code is the same for one cost
and for B.

Every method takes a tensor whose first axis is the lanes' and whose
last is the observation (control): x (B, ..., n) -> (B, ...). The
``*_hess`` methods return (value, gradient (B, ..., n), hessian
(B, ..., n, n)).
"""

from __future__ import annotations

import torch


def _lanes(v, x):
    """A per-lane (B, k) tensor shaped (B, 1, ..., 1, k) against ``x``."""
    return v.reshape(v.shape[:1] + (1,) * (x.ndim - 2) + v.shape[1:])


class SharedCost:
    """One ``Cost`` for every lane (its ``eval_*`` methods are batched over
    every leading axis)."""

    def __init__(self, cost):
        self.cost = cost

    @staticmethod
    def _full(out, x):
        v, g, h = out
        return v, g, h.expand(x.shape + x.shape[-1:])

    def obs(self, x):
        return self.cost.eval_obs_cost(x)

    def ctrl(self, u):
        return self.cost.eval_ctrl_cost(u)

    def term(self, x):
        return self.cost.eval_term_obs_cost(x)

    def obs_hess(self, x):
        return self._full(self.cost.eval_obs_cost_hess(x), x)

    def ctrl_hess(self, u):
        return self._full(self.cost.eval_ctrl_cost_hess(u), u)

    def term_hess(self, x):
        return self._full(self.cost.eval_term_obs_cost_hess(x), x)


class DiagQuadLanes:
    """A diagonal quadratic cost a lane, ``(x-g)' diag(Q_b) (x-g) +
    u' diag(R_b) u`` a stage and ``(x-g)' diag(F_b) (x-g)`` at the end,
    with the shared goal g; with ``reg`` = (S, mu) also the GaussReg term
    ``regw_b (x-mu)' S (x-mu)`` on every stage. ``cp`` holds ``Qdiag``
    (B, n), ``Rdiag`` (B, m), ``Fdiag`` (B, n) and, with ``reg``,
    ``regw`` (B,), all tensors on one device. ``goal`` and ``reg`` may
    be host arrays, or tensors on that device (no copy then: a copy from
    the host would wait for the device's queue)."""

    def __init__(self, cp, goal, reg=None):
        like = cp["Qdiag"]

        def on(v):
            return torch.as_tensor(v, dtype=like.dtype, device=like.device)

        self.Q, self.R, self.F = cp["Qdiag"], cp["Rdiag"], cp["Fdiag"]
        self.goal = on(goal)
        self.reg = None
        if reg is not None:
            S = on(reg[0])
            self.reg = (S, on(reg[1]), cp["regw"][:, None], S + S.T)

    def _gauss(self, x):
        S, mu, w, _ = self.reg
        d = x - mu
        return _lanes(w, x)[..., 0] * (d * (d @ S)).sum(-1)

    def obs(self, x):
        d = x - self.goal
        v = (d * d * _lanes(self.Q, x)).sum(-1)
        return v if self.reg is None else v + self._gauss(x)

    def ctrl(self, u):
        return (u * u * _lanes(self.R, u)).sum(-1)

    def term(self, x):
        d = x - self.goal
        return (d * d * _lanes(self.F, x)).sum(-1)

    @staticmethod
    def _diag_hess(w, d):
        """(value, gradient, hessian) of d' diag(w) d."""
        w = _lanes(w, d)
        h = torch.diag_embed(2.0 * w).expand(d.shape + d.shape[-1:])
        return (d * d * w).sum(-1), 2.0 * w * d, h

    def obs_hess(self, x):
        v, g, h = self._diag_hess(self.Q, x - self.goal)
        if self.reg is None:
            return v, g, h
        _, mu, w, SS = self.reg
        wl = _lanes(w, x)
        return (v + self._gauss(x), g + wl * ((x - mu) @ SS.T),
                h + wl[..., None] * SS)

    def ctrl_hess(self, u):
        return self._diag_hess(self.R, u)

    def term_hess(self, x):
        return self._diag_hess(self.F, x - self.goal)
