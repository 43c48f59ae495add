"""Basis-function library for SINDy feature maps (port of
``autompc_tpu/sysid/basis.py``).

The JAX library holds each term as a Python lambda over ``jnp.sin``; a
CUDA kernel cannot call those. Here every term is a small numeric
**descriptor** instead:

    term(z) = prod_i z_i ** exps[i]  *  trig(freq * z[trig_comp])

with ``trig`` one of "" (none), "sin", "cos". That covers the identity,
power, cross, trig and trig-interaction terms. The same descriptors
drive

* the vectorized feature map ``FeatureLibrary.__call__`` (training and
  ``pred_core``),
* the per-term value / sparse partial-derivative functions the kernels'
  plain PyTorch twins use (``term_value``, ``term_partial``), the
  library's sparse ``grad_terms`` and its closed-form feature Jacobian
  ``FeatureLibrary.jacobian`` (the solver's ``analytic_jac``), and
* the kernels themselves: ``ops/_build.py`` packs the active
  descriptors into the table the CUDA code reads
  (``csrc/features.cuh``).

Term names and order are identical to the JAX library's, so
coefficient matrices carry over between the packages unchanged.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

TRIG_KINDS = ("", "sin", "cos")


@dataclass(frozen=True)
class TermDesc:
    """``prod_i z_i**exps[i] * trig(freq * z[trig_comp])``."""

    name: str
    exps: Tuple[int, ...]
    trig: str = ""
    trig_comp: int = -1
    freq: float = 1.0


def _unit(n, i, e=1):
    return tuple(e if c == i else 0 for c in range(n))


def identity_terms(n: int) -> List[TermDesc]:
    return [TermDesc(f"z{i}", _unit(n, i)) for i in range(n)]


def poly_terms(n: int, degree: int) -> List[TermDesc]:
    return [TermDesc(f"z{i}^{degree}", _unit(n, i, degree)) for i in range(n)]


def compositions(total, parts):
    """Every ordered tuple of ``parts`` positive integers summing to
    ``total``, first part slowest: the exponent patterns of the cross
    terms (the JAX library's enumeration)."""
    if parts == 1:
        yield (total,)
        return
    for first in range(1, total - parts + 2):
        for rest in compositions(total - first, parts - 1):
            yield (first,) + rest


def cross_terms(n: int, degree: int) -> List[TermDesc]:
    """Products of powers over >= 2 distinct variables with total degree
    ``degree`` — the JAX library's enumeration order."""
    exps_list, seen = [], set()
    for k in range(1, degree + 1):
        for exp in compositions(degree, k):
            if exp not in seen:
                seen.add(exp)
                exps_list.append(exp)
    out = []
    for exp in exps_list:
        if len(exp) == 1:
            continue
        for combo in itertools.combinations(range(n), len(exp)):
            e = [0] * n
            for i, ei in zip(combo, exp):
                e[i] = ei
            name = " ".join(f"z{i}^{ei}" for i, ei in zip(combo, exp))
            out.append(TermDesc(name, tuple(e)))
    return out


def trig_terms(n: int, freq: int) -> List[TermDesc]:
    out = []
    for i in range(n):
        zero = (0,) * n
        out.append(TermDesc(f"sin({freq} z{i})", zero, "sin", i, float(freq)))
        out.append(TermDesc(f"cos({freq} z{i})", zero, "cos", i, float(freq)))
    return out


def trig_interaction_terms(n: int, freq: int) -> List[TermDesc]:
    """z_i sin(f z_j), z_j sin(f z_i), z_i cos(f z_j), z_j cos(f z_i) for
    each pair i < j."""
    f = float(freq)
    out = []
    for i, j in itertools.combinations(range(n), 2):
        out.append(TermDesc(f"z{i} sin({freq} z{j})", _unit(n, i), "sin", j, f))
        out.append(TermDesc(f"z{j} sin({freq} z{i})", _unit(n, j), "sin", i, f))
        out.append(TermDesc(f"z{i} cos({freq} z{j})", _unit(n, i), "cos", j, f))
        out.append(TermDesc(f"z{j} cos({freq} z{i})", _unit(n, j), "cos", i, f))
    return out


# ---------------------------------------------------------------------------
# Per-term math over a list of component tensors (the kernels' plain twins)
# ---------------------------------------------------------------------------


def _ipow(x, e: int):
    """x**e by binary exponentiation (the multiplication order of
    ``lax.integer_pow`` and of the CUDA kernels)."""
    acc = None
    while e > 0:
        if e & 1:
            acc = x if acc is None else acc * x
        e >>= 1
        if e:
            x = x * x
    return acc


def _trig(t: TermDesc, z):
    a = t.freq * z[t.trig_comp]
    return a, (torch.sin(a) if t.trig == "sin" else torch.cos(a))


def _monomial(t: TermDesc, z, skip: int = -1):
    val = None
    for c, e in enumerate(t.exps):
        if e and c != skip:
            p = _ipow(z[c], e)
            val = p if val is None else val * p
    return val


def term_value(t: TermDesc, z):
    """The term at ``z`` (a list of equally shaped tensors, one per
    input component)."""
    val = _monomial(t, z)
    if t.trig:
        tv = _trig(t, z)[1]
        val = tv if val is None else val * tv
    return val


def term_partial(t: TermDesc, c: int, z):
    """d(term)/d(z_c) by the product rule, or None where it is
    structurally zero. A constant partial (identity term) is the Python
    float 1.0, like the JAX library's ``grad_terms``."""
    out = None
    e = t.exps[c]
    if e:
        dm = float(e) if e == 1 else e * _ipow(z[c], e - 1)
        for c2, e2 in enumerate(t.exps):
            if c2 != c and e2:
                dm = dm * _ipow(z[c2], e2)
        out = dm
    if t.trig:
        a, tv = _trig(t, z)
        if out is not None:
            out = out * tv
        if t.trig_comp == c:
            dtv = (
                t.freq * torch.cos(a) if t.trig == "sin"
                else (-t.freq) * torch.sin(a)
            )
            mono = _monomial(t, z)
            d2 = dtv if mono is None else mono * dtv
            out = d2 if out is None else out + d2
    return out


def tree_sum(vals):
    """Balanced pairwise summation — the order of the JAX kernels'
    ``_tree_sum`` (ops/pallas_linesearch.py) and of the CUDA kernels'
    ``TreeAcc`` (csrc/features.cuh)."""
    while len(vals) > 1:
        nxt = [vals[i] + vals[i + 1] for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def feature_dynamics(terms, coeffs, z, ds):
    """``x'_i = sum_k coeffs[i, k] * term_k(z)`` for i < ds, balanced
    over the (active) terms."""
    theta = [term_value(t, z) for t in terms]
    return [
        tree_sum([coeffs[i, k] * theta[k] for k in range(len(terms))])
        for i in range(ds)
    ]


def feature_jacobian_rows(terms, coeffs, z, ds):
    """Packed dynamics Jacobian rows at ``z``: entry ``i*d + dd`` is
    ``d x'_i / d z_dd`` (d = len(z)), summed only over the terms with a
    nonzero partial (the JAX kernels' sparse ``grad_terms`` path), 0
    where no term touches ``z_dd``."""
    d = len(z)
    shape, like = z[0].shape, z[0]
    rows = [None] * (ds * d)
    for dd in range(d):
        slabs = [
            (k, g) for k, t in enumerate(terms)
            if (g := term_partial(t, dd, z)) is not None
        ]
        for i in range(ds):
            vals = [coeffs[i, k] * g for k, g in slabs]
            total = tree_sum(vals) if vals else like.new_zeros(())
            rows[i * d + dd] = torch.broadcast_to(
                torch.as_tensor(total, dtype=like.dtype, device=like.device),
                shape,
            )
    return rows


class FeatureLibrary:
    """A static list of term descriptors over a combined input z = [x, u].

    ``__call__`` evaluates every term at once over the last axis:
    z (..., n_inputs) -> (..., n_features)."""

    def __init__(self, terms: Sequence[TermDesc]):
        self.terms = tuple(terms)
        self.names = [t.name for t in self.terms]
        self.n_inputs = len(self.terms[0].exps) if self.terms else 0
        E = np.array([t.exps for t in self.terms], dtype=np.int64)
        self._E = E.reshape(len(self.terms), self.n_inputs)
        self._kind = np.array([TRIG_KINDS.index(t.trig) for t in self.terms])
        self._comp = np.array([max(t.trig_comp, 0) for t in self.terms])
        self._freq = np.array([t.freq for t in self.terms])
        self._on = {}

    def _consts(self, dev, dt):
        """(E, cols, comp, freq, kind) on ``dev``, copied there once: a
        host-to-device copy each call would wait for the card's queue."""
        key = (dev, dt)
        if key not in self._on:
            self._on[key] = (
                torch.as_tensor(self._E, device=dev),
                torch.arange(self.n_inputs, device=dev),
                torch.as_tensor(self._comp, device=dev),
                torch.as_tensor(self._freq, dtype=dt, device=dev),
                torch.as_tensor(self._kind, device=dev),
            )
        return self._on[key]

    @property
    def n_features(self) -> int:
        return len(self.terms)

    @property
    def grad_terms(self):
        """Sparse per-term analytic gradients, as the JAX library's:
        ``grad_terms[k]`` is a tuple of ``(comp_idx, grad_fn)`` pairs,
        one for each input component whose partial of term k is not
        structurally zero (in the JAX library's order), ``grad_fn(z)``
        that partial at ``z`` (indexed by component: a vector, or a
        sequence of equally shaped tensors); a constant partial is the
        Python float 1.0."""
        def comps(t):
            # The JAX library's order: the monomial's components, then
            # the trig factor's.
            cs = [c for c, e in enumerate(t.exps) if e]
            return cs + ([t.trig_comp] if t.trig and t.trig_comp not in cs else [])

        return tuple(
            tuple((c, (lambda z, t=t, c=c: term_partial(t, c, z))) for c in comps(t))
            for t in self.terms
        )

    def jacobian(self, z):
        """Closed-form feature Jacobian: z (..., n_inputs) -> (...,
        n_features, n_inputs), each entry ``term_partial`` (0 where
        structurally zero): one evaluation of the partials, where
        ``jacfwd`` pushes a tangent through the library per input."""
        comps = [z[..., c] for c in range(self.n_inputs)]
        zero = z.new_zeros(z.shape[:-1])
        rows = []
        for t in self.terms:
            row = []
            for c in range(self.n_inputs):
                g = term_partial(t, c, comps)
                row.append(zero if g is None else torch.broadcast_to(
                    torch.as_tensor(g, dtype=z.dtype, device=z.device), zero.shape))
            rows.append(torch.stack(row, dim=-1))
        return torch.stack(rows, dim=-2)

    def __call__(self, z):
        dev, dt = z.device, z.dtype
        P = int(self._E.max()) if self._E.size else 0
        # powers[..., c, p] = z_c ** p, p = 0..P, built by exact products.
        pw = [torch.ones_like(z)]
        for p in range(1, P + 1):
            pw.append(_ipow(z, p))
        powers = torch.stack(pw, dim=-1)
        E, cols, comp, freq, kind = self._consts(dev, dt)
        mono = powers[..., cols[None, :], E].prod(-1)          # (..., F)
        arg = z[..., comp] * freq
        trig = torch.where(
            kind == 1, torch.sin(arg),
            torch.where(kind == 2, torch.cos(arg), torch.ones_like(arg)),
        )
        return mono * trig

    @staticmethod
    def from_config(
        n_inputs: int,
        poly_basis: bool = False,
        poly_degree: int = 3,
        poly_cross_terms: bool = False,
        trig_basis: bool = False,
        trig_freq: int = 1,
        trig_interaction: bool = False,
    ) -> "FeatureLibrary":
        """Identity always; trig (+ interactions) per frequency
        1..trig_freq; polynomial powers 2..poly_degree (+ cross terms) —
        the JAX library's order."""
        terms = identity_terms(n_inputs)
        if trig_basis:
            for freq in range(1, trig_freq + 1):
                terms += trig_terms(n_inputs, freq)
                if trig_interaction:
                    terms += trig_interaction_terms(n_inputs, freq)
        if poly_basis:
            for deg in range(2, poly_degree + 1):
                terms += poly_terms(n_inputs, deg)
            if poly_cross_terms:
                for deg in range(2, poly_degree + 1):
                    terms += cross_terms(n_inputs, deg)
        return FeatureLibrary(terms)


def finite_difference(x, dt: float):
    """Second-order finite-difference time derivative along axis 0:
    centered in the interior, one-sided at the boundaries."""
    interior = (x[2:] - x[:-2]) / (2 * dt)
    first = (-3 * x[0] + 4 * x[1] - x[2])[None] / (2 * dt)
    last = (3 * x[-1] - 4 * x[-2] + x[-3])[None] / (2 * dt)
    return torch.cat([first, interior, last], dim=0)
