"""Batched Bayesian optimization (port of ``autompc_tpu/tuning/bo.py``,
a numpy-only module kept here as the port's own copy and ported as it
is: the same forest, expected improvement and fantasized batch ask, so
one ``numpy.random.Generator`` seed asks the same configurations in both
packages).

Batched Bayesian optimization over conditional configuration spaces.

This is the tuner core that replaces SMAC4HPO + its pyrfr C++ random
forest (reference usage: autompc/tuning/pipeline_tuner.py:260-271,
model_tuner.py:158-169). Differences by design:

* **Batched ask/tell**: ``ask()`` proposes a *batch* of configurations
  scored by expected improvement, so candidate evaluations can fan out
  in parallel across a device mesh (SMAC is strictly sequential).
* The surrogate is a random-forest regressor over the space's
  fixed-width unit-hypercube encoding (config/space.py:encode), which
  natively handles conditional/categorical structure via the ``-1``
  inactive marker — the same reason SMAC uses a forest.
* Failed configurations (inf cost) are clamped to a penalty value so the
  forest keeps steering away from them without poisoning the fit
  (reference contract: bad config => inf cost, tuning continues,
  pipeline_tuner.py:236-239).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..config import Configuration, ConfigurationSpace


# ---------------------------------------------------------------------------
# Random-forest surrogate (host-side; data is tiny)
# ---------------------------------------------------------------------------


class _Tree:
    __slots__ = ("feature", "threshold", "left", "right", "value")

    def __init__(self, value=None):
        self.feature = -1
        self.threshold = 0.0
        self.left = None
        self.right = None
        self.value = value


def _build_tree(X, y, rng, depth, min_leaf, n_feat_try):
    node = _Tree()
    if depth == 0 or len(y) <= 2 * min_leaf or np.ptp(y) < 1e-12:
        node.value = float(np.mean(y))
        return node
    d = X.shape[1]
    best = None
    feats = rng.choice(d, size=min(n_feat_try, d), replace=False)
    for f in feats:
        vals = X[:, f]
        lo, hi = vals.min(), vals.max()
        if hi - lo < 1e-12:
            continue
        for thr in rng.uniform(lo, hi, 4):
            mask = vals <= thr
            nl = int(mask.sum())
            if nl < min_leaf or len(y) - nl < min_leaf:
                continue
            yl, yr = y[mask], y[~mask]
            score = nl * yl.var() + (len(y) - nl) * yr.var()
            if best is None or score < best[0]:
                best = (score, f, thr, mask)
    if best is None:
        node.value = float(np.mean(y))
        return node
    _, f, thr, mask = best
    node.feature = int(f)
    node.threshold = float(thr)
    node.left = _build_tree(X[mask], y[mask], rng, depth - 1, min_leaf, n_feat_try)
    node.right = _build_tree(X[~mask], y[~mask], rng, depth - 1, min_leaf, n_feat_try)
    return node


def _tree_predict(node, x):
    while node.value is None:
        node = node.left if x[node.feature] <= node.threshold else node.right
    return node.value


class RandomForestSurrogate:
    """Small CART forest with bootstrap rows and random feature/threshold
    splits; predictive uncertainty from cross-tree variance."""

    def __init__(self, n_trees=24, max_depth=10, min_leaf=2, rng=None):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.rng = rng or np.random.default_rng()
        self._trees: List[_Tree] = []

    def fit(self, X: np.ndarray, y: np.ndarray):
        n, d = X.shape
        n_feat_try = max(1, int(np.ceil(d * 0.7)))
        self._trees = []
        for _ in range(self.n_trees):
            idx = self.rng.integers(n, size=n)
            self._trees.append(
                _build_tree(
                    X[idx], y[idx], self.rng, self.max_depth,
                    self.min_leaf, n_feat_try,
                )
            )
        return self

    def predict(self, X: np.ndarray):
        preds = np.array(
            [[_tree_predict(t, x) for t in self._trees] for x in X]
        )
        return preds.mean(axis=1), preds.std(axis=1)


# ---------------------------------------------------------------------------
# Batched BO loop
# ---------------------------------------------------------------------------


def _expected_improvement(mu, sigma, best):
    sigma = np.maximum(sigma, 1e-9)
    z = (best - mu) / sigma
    # EI for minimization under a Gaussian belief.
    from math import erf, sqrt

    cdf = 0.5 * (1.0 + np.array([erf(v / sqrt(2.0)) for v in z]))
    pdf = np.exp(-0.5 * z**2) / np.sqrt(2 * np.pi)
    return (best - mu) * cdf + sigma * pdf


class BatchBayesOpt:
    """Ask/tell optimizer proposing batches of configurations.

    Parameters
    ----------
    space : ConfigurationSpace
    rng : numpy Generator
    batch_size : configs per ask() (the parallel-evaluation width)
    n_candidates : random candidates scored per ask
    n_initial : random configs before the surrogate activates
    """

    def __init__(
        self,
        space: ConfigurationSpace,
        rng: Optional[np.random.Generator] = None,
        batch_size: int = 8,
        n_candidates: int = 1000,
        n_initial: Optional[int] = None,
    ):
        self.space = space
        self.rng = rng or np.random.default_rng()
        self.batch_size = batch_size
        self.n_candidates = n_candidates
        self.n_initial = (
            n_initial if n_initial is not None else max(2 * batch_size, 8)
        )
        self._X: List[np.ndarray] = []
        self._y: List[float] = []
        self._cfgs: List[Configuration] = []
        self._default_proposed = False

    # -- history ------------------------------------------------------
    @property
    def history(self):
        return list(zip(self._cfgs, self._y))

    @property
    def incumbent(self):
        if not self._y:
            return None, float("inf")
        i = int(np.argmin(self._y))
        return self._cfgs[i], self._y[i]

    # -- ask/tell -----------------------------------------------------
    def ask(self, batch_size: Optional[int] = None) -> List[Configuration]:
        B = batch_size or self.batch_size
        out: List[Configuration] = []
        if not self._default_proposed:
            out.append(self.space.get_default_configuration())
            self._default_proposed = True
        while len(out) < B and len(self._y) + len(out) < self.n_initial:
            out.append(self.space.sample_configuration(self.rng))
        if len(out) >= B:
            return out[:B]

        # Surrogate-guided proposals.
        X = np.stack(self._X)
        y = np.array(self._y, dtype=float)
        finite = np.isfinite(y)
        if finite.any():
            penalty = y[finite].max() + 3 * (y[finite].std() + 1.0)
            y = np.where(finite, y, penalty)
        else:
            y = np.zeros_like(y)

        def _fit(Xf, yf):
            # Prefer the compiled (C++) forest; identical algorithm,
            # much faster refit (native/rf.cpp).
            try:
                from ..native import make_forest

                return make_forest(rng=self.rng).fit(Xf, yf)
            except Exception:
                return RandomForestSurrogate(rng=self.rng).fit(Xf, yf)

        cands = self.space.sample_configuration(self.rng, size=self.n_candidates)
        # Local perturbations around the best observed configs sharpen
        # exploitation. Multi-scale noise matters because the space's
        # unit-cube encoding spans log-scale hyperparameters (quad-cost
        # weights 1e-3..1e4): sigma 0.03 is a fine-tune of a weight,
        # sigma 0.3 a decade-scale move.
        n_top = min(3, len(self._y))
        if n_top:
            top_idx = np.argsort(y)[:n_top]
            per_scale = max(1, self.n_candidates // (10 * n_top * 3))
            for ti in top_idx:
                base = self._X[int(ti)].copy()
                for s in (0.03, 0.1, 0.3):
                    for _ in range(per_scale):
                        v = base.copy()
                        active = v >= 0
                        noise = self.rng.normal(0, s, size=v.shape)
                        v[active] = np.clip(v[active] + noise[active], 0, 1)
                        cands.append(self.space.decode(v))
        Xc = self.space.encode_batch(cands)
        seen = {tuple(np.round(self.space.encode(c), 6)) for c in out}
        avail = np.ones(len(cands), dtype=bool)

        # Fantasized ("kriging believer") batch selection: each pick is
        # scored by a surrogate that believes its own mean prediction at
        # every earlier pick in the batch, so all B proposals are
        # model-informed and mutually aware — without this, top-B-by-EI
        # clusters the whole batch around one optimum and a batched tune
        # makes only n_iters/B adaptive decisions (the round-5 AutoML
        # quality finding; SMAC makes one per evaluation).
        Xfant = [x for x in self._X]
        yfant = list(y)
        forest = _fit(X, np.asarray(yfant))
        mu, sigma = forest.predict(Xc)
        best = float(np.min(yfant))
        while len(out) < B:
            ei = _expected_improvement(mu, sigma, best)
            ei = np.where(avail, ei, -np.inf)
            i = int(np.argmax(ei))
            if not np.isfinite(ei[i]):
                break
            avail[i] = False
            key = tuple(np.round(Xc[i], 6))
            if key in seen:
                continue
            seen.add(key)
            out.append(cands[i])
            if len(out) >= B:
                break
            # Believe the surrogate's own mean at the pick and refit, so
            # the next pick's EI accounts for it.
            Xfant.append(Xc[i])
            yfant.append(float(mu[i]))
            forest = _fit(np.stack(Xfant), np.asarray(yfant))
            mu, sigma = forest.predict(Xc)
            best = float(np.min(yfant))
        while len(out) < B:
            out.append(self.space.sample_configuration(self.rng))
        return out[:B]

    def tell(self, cfgs: Sequence[Configuration], costs: Sequence[float]):
        for cfg, cost in zip(cfgs, costs):
            self._cfgs.append(cfg)
            self._X.append(self.space.encode(cfg))
            self._y.append(float(cost))
