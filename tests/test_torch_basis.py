"""Port's descriptor-built feature library vs the JAX FeatureLibrary:
names and order, term values, sparse partial derivatives (float64,
rtol 1e-12), and the CUDA kernels' tree-summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.sysid import basis as tb
from autompc_tpu.ops.pallas_linesearch import _tree_sum
from autompc_tpu.sysid.basis import FeatureLibrary as JaxLibrary

# The tensors here are small: one intra-op thread (six test workers with a
# thread pool each oversubscribe the cores).
torch.set_num_threads(1)

CONFIGS = {
    "trig_interaction": dict(trig_basis=True, trig_freq=1, trig_interaction=True),
    "trig_freq2": dict(trig_basis=True, trig_freq=2, trig_interaction=True),
    "poly_cross": dict(poly_basis=True, poly_degree=3, poly_cross_terms=True),
    "poly_trig": dict(poly_basis=True, poly_degree=4, trig_basis=True),
}


def _libs(cfg, n=5):
    return JaxLibrary.from_config(n, **CONFIGS[cfg]), tb.FeatureLibrary.from_config(
        n, **CONFIGS[cfg]
    )


def test_cartpole_library_has_55_terms():
    jl, tl = _libs("trig_interaction")
    assert tl.n_features == jl.n_features == 55


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_names_and_order_match(cfg):
    jl, tl = _libs(cfg)
    assert tl.names == jl.names


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_feature_values_match(cfg):
    jl, tl = _libs(cfg)
    z = np.random.default_rng(0).uniform(-2, 2, (7, 3, 5))
    ref = np.asarray(jl(jnp.asarray(z)))
    got = tl(torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    # The per-term descriptor evaluation (the kernels' twins) agrees too.
    comps = [torch.as_tensor(z[..., c]) for c in range(5)]
    for k, t in enumerate(tl.terms):
        np.testing.assert_allclose(
            tb.term_value(t, comps).numpy(), np.asarray(jl._fns[k](jnp.asarray(z).T)).T,
            rtol=1e-12, atol=1e-12, err_msg=t.name,
        )


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_sparse_partials_match_grad_terms(cfg):
    jl, tl = _libs(cfg)
    z = np.random.default_rng(1).uniform(-2, 2, (5, 11))
    zj = jnp.asarray(z)
    comps = [torch.as_tensor(z[c]) for c in range(5)]
    for k, (t, entries) in enumerate(zip(tl.terms, jl.grad_terms)):
        ref = {c: np.broadcast_to(np.asarray(g(zj)), (11,)) for c, g in entries}
        for c in range(5):
            got = tb.term_partial(t, c, comps)
            if c not in ref:
                assert got is None, (t.name, c)
                continue
            assert got is not None, (t.name, c)
            got = np.broadcast_to(np.asarray(got), (11,))
            np.testing.assert_allclose(got, ref[c], rtol=1e-12, atol=1e-12,
                                       err_msg=f"{t.name} d/dz{c}")


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_jacobian_column_lists_are_the_nonzero_partials(cfg):
    """The per-column term lists of the kernels' table (ops/_build.py:
    jacobian_columns, FeatTable.col_n / col_terms) hold, in term order,
    exactly the terms whose partial is not structurally zero."""
    from autompc_torch.ops import _build

    _, tl = _libs(cfg)
    terms = tl.terms[:_build.MAX_F]
    comps = [torch.as_tensor(v) for v in np.random.default_rng(4).uniform(-2, 2, (5, 3))]
    tab = _build.feat_table(tuple(terms))
    for c, ks in enumerate(_build.jacobian_columns(terms)):
        want = [k for k, t in enumerate(terms) if tb.term_partial(t, c, comps) is not None]
        assert ks == want, (cfg, c)
        assert tab.col_n[c] == len(ks) and list(tab.col_terms[c])[:len(ks)] == ks


def test_tree_sum_matches_jax_order():
    vals = [torch.tensor(v) for v in np.random.default_rng(2).normal(size=13) * 1e8]
    assert float(tb.tree_sum(vals)) == float(_tree_sum([jnp.asarray(v.item()) for v in vals]))


def _counter_tree(n, slots=7):
    """Python mirror of csrc/features.cuh TreeAcc (TreeAccT<slots>):
    push(k) merges the blocks named by the trailing one-bits of k,
    total(n) folds the blocks of n's one-bits from the lowest."""
    slot = [None] * slots
    for k in range(n):
        carry = f"a{k}"
        for lvl in range(slots):
            if (k >> lvl) & 1:
                carry = f"({slot[lvl]}+{carry})"
            else:
                slot[lvl] = carry
                break
    r = None
    for lvl in range(slots):
        if (n >> lvl) & 1:
            r = slot[lvl] if r is None else f"({slot[lvl]}+{r})"
    return r


class _Sym(str):
    """A summand that records the parenthesization of its sums."""

    def __add__(self, other):
        return _Sym(f"({self}+{other})")


@pytest.mark.parametrize("n", list(range(1, 65)))
def test_kernel_tree_accumulator_reproduces_tree_sum(n):
    syms = [_Sym(f"a{k}") for k in range(n)]
    assert _counter_tree(n) == _tree_sum(syms) == tb.tree_sum(syms)


# The per-lane instances' trees (features.cuh: AMPC_TREE_SLOTS_BIG) over
# the whole library, up to _build.MAX_F_LANE terms: the largest SINDy
# library of the space on cartpole has 1,686.
BIG_TREE_SLOTS = 12


@pytest.mark.parametrize("n", [65, 127, 128, 129, 1000, 1686, 2047, 2048])
def test_large_counter_tree_reproduces_tree_sum(n):
    from autompc_torch.ops import _build

    assert 2 ** BIG_TREE_SLOTS > _build.MAX_F_LANE >= n
    syms = [_Sym(f"a{k}") for k in range(n)]
    assert _counter_tree(n, BIG_TREE_SLOTS) == _tree_sum(syms) == tb.tree_sum(syms)
    # The shared instances' seven slots hold fewer than 128 terms.
    assert (_counter_tree(n) == _tree_sum(syms)) == (n < 128)


class _Blk:
    """A partial sum of consecutive terms: its text records the pairing,
    and an addition puts the earlier block on the left (a float32
    addition gives the same bits in either operand order)."""

    def __init__(self, start, text):
        self.start, self.text = start, text

    def __add__(self, other):
        a, b = sorted((self, other), key=lambda s: s.start)
        return _Blk(a.start, f"({a.text}+{b.text})")


def _butterfly_rounds(n, G, slots=7):
    """Python mirror of csrc/sindy_linesearch.cu's feature sum: rounds of
    G consecutive terms; in each, lane g holds term r G + g and log2 G
    levels of xor shuffles add a partner block where both blocks hold a
    term; complete rounds' sums go into a counter over rounds (push k =
    r), and the last, partial round's sum opens the final fold. Returns
    every lane's sum."""
    full, part = divmod(n, G)
    slot, lanes = [None] * slots, None
    for r in range(-(-n // G)):
        cnt = G if r < full else part
        lanes = [_Blk(r * G + g, f"a{r * G + g}") if g < cnt else None for g in range(G)]
        lvl = 1
        while lvl < G:
            nxt = []
            for g in range(G):
                own = g & ~(lvl - 1)
                has_own, has_other = own < cnt, (own ^ lvl) < cnt
                o = lanes[g ^ lvl]
                nxt.append(lanes[g] + o if has_own and has_other else
                           (lanes[g] if has_own else o))
            lanes, lvl = nxt, lvl * 2
        if r < full:
            carry = lanes[0]
            for lv in range(slots):
                if (r >> lv) & 1:
                    carry = slot[lv] + carry
                else:
                    slot[lv] = carry
                    break
    out = []
    for g in range(G):
        acc = lanes[g] if part else None
        for lv in range(slots):
            if (full >> lv) & 1:
                acc = slot[lv] if acc is None else slot[lv] + acc
        out.append(acc.text)
    return out


@pytest.mark.parametrize("G", [4, 8])
def test_kernel_butterfly_reproduces_tree_sum(G):
    """K7 sums each output's terms across a group of G threads: every
    thread ends with the same sum, paired as tree_sum pairs the terms,
    for 1 to 64 terms."""
    for n in range(1, 65):
        got = _butterfly_rounds(n, G)
        want = _tree_sum([_Sym(f"a{k}") for k in range(n)])
        assert set(got) == {want}, (G, n)


@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("n", [65, 129, 1686, 2048])
def test_kernel_butterfly_with_large_trees_reproduces_tree_sum(G, n):
    """K7's per-lane instances: the same butterfly over a library past
    64 terms, its rounds' counter tree of AMPC_TREE_SLOTS_BIG slots."""
    got = _butterfly_rounds(n, G, BIG_TREE_SLOTS)
    assert set(got) == {_tree_sum([_Sym(f"a{k}") for k in range(n)])}, (G, n)


def test_large_table_lists_columns_in_16_bits():
    """The per-lane instances' table (FeatTableBig): a library past 127
    terms (poly degree 8 with cross terms, 1,286) keeps its full column
    lists, with term indices past a byte's range."""
    import ctypes

    from autompc_torch.ops import _build

    lib = tb.FeatureLibrary.from_config(5, poly_basis=True, poly_degree=8,
                                        poly_cross_terms=True)
    assert lib.n_features == 1286
    tab = _build.feat_table_big(lib.terms)
    assert (tab.n, tab.d) == (1286, 5)
    cols = _build.jacobian_columns(lib.terms)
    assert max(max(ks) for ks in cols) > 127
    for c, ks in enumerate(cols):
        assert tab.col_n[c] == len(ks) and list(tab.col_terms[c])[:len(ks)] == ks
    for k in (0, 700, 1285):
        assert list(tab.exps[k])[:5] == list(lib.terms[k].exps)
    # features.cuh's FeatTableT<2048, short>: the C layout, byte for byte.
    F, D = _build.MAX_F_LANE, _build.MAX_D
    assert ctypes.sizeof(_build.FeatTableBig) == 8 + F * D + 2 * F + 4 * F + 2 * D + 2 * D * F
    with pytest.raises(ValueError, match=f"per-lane coefficients take 1..{F} terms"):
        _build.feat_table_big(tuple(lib.terms) * 2)


def test_finite_difference_matches():
    from autompc_tpu.sysid.basis import finite_difference as jfd

    x = np.random.default_rng(3).normal(size=(9, 4))
    np.testing.assert_allclose(
        tb.finite_difference(torch.as_tensor(x), 0.05).numpy(),
        np.asarray(jfd(jnp.asarray(x), 0.05)), rtol=1e-12,
    )
