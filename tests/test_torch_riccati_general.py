"""K4 plain version (ops/cuda_riccati_general.py) and the port's
tvlqr_backward_scan (ops/riccati.py) vs the JAX package, float64,
1e-9 relative: the Pallas kernels pallas_tvlqr_backward_general and
pallas_tvlqr_backward in interpret mode at small shapes, and
jax.vmap(tvlqr_backward_scan) at every shape.

The halfcheetah shape (18, 6) is held against the JAX scan only: in
interpret mode the general Pallas kernel's unrolled cell body takes
tens of minutes there (tests/test_pallas_riccati.py says the same)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.ops import _build
from autompc_torch.ops.cuda_riccati_general import (
    chol_solve,
    riccati_general,
    riccati_general_plain,
)
from autompc_torch.ops.riccati import solve_small, tvlqr_backward_scan
from autompc_tpu.ops import riccati as jriccati
from autompc_tpu.ops.pallas_riccati import (
    pallas_tvlqr_backward,
    pallas_tvlqr_backward_general,
)

# The tensors here are tiny: one intra-op thread. Six test workers with
# a thread pool each oversubscribe the cores and slow these loops of
# small ops a hundredfold.
torch.set_num_threads(1)

NAMES = ("Ks", "ks", "lin_red", "quad_red")


def _problem(B, H, ds, dc, seed):
    rng = np.random.default_rng(seed)

    def spd(n, lead):
        A = rng.normal(size=lead + (n, n))
        return A @ np.swapaxes(A, -1, -2) / n + 0.5 * np.eye(n)

    return (
        np.eye(ds) + rng.normal(0, 0.2, (B, H, ds, ds)),   # Jx
        rng.normal(0, 0.5, (B, H, ds, dc)),                # Ju
        spd(ds, (B, H)), spd(dc, (B, H)),                  # Cxx, Cuu
        rng.normal(size=(B, H, ds)), rng.normal(size=(B, H, dc)),
        spd(ds, (B,)), rng.normal(size=(B, ds)),           # Vn, vn
    )


def _check(got, ref, rtol=1e-9):
    for name, g, r in zip(NAMES, got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol,
                                   atol=rtol * np.abs(r).max(), err_msg=name)


def _torch(args):
    return tuple(torch.as_tensor(a) for a in args)


def _jnp(args):
    return tuple(jnp.asarray(a) for a in args)


@pytest.mark.parametrize("ds,dc,H,B", [(18, 6, 12, 4), (5, 2, 10, 8), (4, 1, 12, 8),
                                       (3, 3, 6, 2)])
def test_plain_and_scan_match_jax_scan(ds, dc, H, B):
    args = _problem(B, H, ds, dc, seed=ds + dc)
    ref = jax.vmap(jriccati.tvlqr_backward_scan)(*_jnp(args))
    _check(riccati_general_plain(*_torch(args)), ref)
    _check(tvlqr_backward_scan(*_torch(args)), ref)
    # A CPU tensor gets the plain version from the wrapper.
    _check(riccati_general(*_torch(args)), ref)


@pytest.mark.parametrize("ds,dc,H,B", [(5, 2, 10, 8), (5, 3, 6, 4)])
def test_plain_matches_pallas_general_interpret(ds, dc, H, B):
    args = _problem(B, H, ds, dc, seed=10 + dc)
    ref = pallas_tvlqr_backward_general(*_jnp(args), block_b=B, interpret=True)
    _check(riccati_general_plain(*_torch(args)), ref)


def test_plain_at_dc1_matches_pallas_backward_interpret():
    """The (4, 1) instance is the port of pallas_tvlqr_backward: the
    same recursion with a scalar Quu."""
    args = _problem(8, 12, 4, 1, seed=3)
    ref = pallas_tvlqr_backward(*_jnp(args), block_b=8, interpret=True)
    _check(riccati_general_plain(*_torch(args)), ref)


@pytest.mark.parametrize("n", [1, 2, 3, 6])
def test_small_solves_match_linalg(n):
    rng = np.random.default_rng(n)
    A = rng.normal(size=(5, n, n))
    A = A @ np.swapaxes(A, -1, -2) + np.eye(n)
    b = rng.normal(size=(5, n, 4))
    ref = np.linalg.solve(A, b)
    for solve in (chol_solve, solve_small):
        got = solve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    jref = jax.vmap(jriccati.solve_small)(jnp.asarray(A), jnp.asarray(b))
    np.testing.assert_allclose(
        solve_small(torch.as_tensor(A), torch.as_tensor(b)).numpy(),
        np.asarray(jref), rtol=1e-10, atol=1e-12)


def test_non_positive_definite_quu_gives_nan_lane():
    """No guard, no regularization: the lane's gains are NaN, the other
    lanes are untouched."""
    args = list(_problem(3, 4, 4, 2, seed=7))
    args[3] = args[3].copy()
    args[3][1] = -np.eye(2)            # lane 1: Cuu negative definite
    args[1] = args[1].copy()
    args[1][1] = 0.0                   # ... and no Ju'VJu to rescue it
    Ks, ks, lin, quad = riccati_general_plain(*_torch(args))
    assert torch.isnan(ks[1]).all() and torch.isnan(lin[1])
    assert torch.isfinite(Ks[[0, 2]]).all() and torch.isfinite(lin[[0, 2]]).all()


def test_scalar_quu_is_divided_not_factorized():
    """At dc = 1 a negative Quu gives finite gains equal to the JAX
    dc = 1 kernel's and scan's (they divide by the scalar); only the
    dc > 1 Cholesky turns an indefinite Quu into NaN."""
    args = list(_problem(3, 4, 4, 1, seed=8))
    args[3] = args[3].copy()
    args[3][1] = -50.0
    ref = jax.vmap(jriccati.tvlqr_backward_scan)(*_jnp(args))
    got = riccati_general_plain(*_torch(args))
    assert torch.isfinite(got[0]).all()
    _check(got, ref)
    _check(got, pallas_tvlqr_backward(*_jnp(args), block_b=3, interpret=True))


def test_wrapper_rejects_bad_shapes_and_devices():
    args = _torch(_problem(2, 3, 4, 1, seed=1))
    with pytest.raises(ValueError, match="Cuu"):
        riccati_general(*args[:3], args[3][:, :, :, :0], *args[4:])
    with pytest.raises(ValueError, match="Ju"):
        riccati_general(args[0], args[1][0], *args[2:])
    with pytest.raises(ValueError, match="meta"):
        riccati_general(*(a.to("meta") for a in args))
    assert (18, 6) in _build.KERNEL_SHAPES["riccati_general"]
    assert (4, 1) in _build.KERNEL_SHAPES["riccati_general"]
