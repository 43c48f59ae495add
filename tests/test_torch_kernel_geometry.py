"""The launch geometry that the wrappers of K3 (fused line search) and
K5 (MLP line search) choose in Python: every (lane, step size) falls to
exactly one thread (K3) or block slot (K5) under the kernels' own index
arithmetic, the blocks stay within the card's limits, and the wrappers
refuse, by name and without a card, the shapes the kernels do not take."""

import numpy as np
import pytest
import torch

from autompc_torch.ops import _build
from autompc_torch.ops import cuda_linesearch as K3
from autompc_torch.ops import cuda_mlp_linesearch as K5

BATCHES = (1, 7, 1024, 4096, 16384)
STEPS = tuple(range(1, _build.MAX_L + 1))
# The widths the CPU tests and the chip's paths give K5:
# (widths, ds, dc).
MLP_WIDTHS = (
    ([7, 8, 8, 5], 5, 2),            # tests/test_torch_mlp_linesearch.py
    ([7, 8, 5], 5, 2),
    ([24, 64, 64, 18], 18, 6),      # the cheetah MLP
    ([5, 64, 64, 4], 4, 1),         # the dense-cost cartpole MLP
    ([5, 8, 8, 4], 4, 1),           # tests/test_torch_ilqr_batchmajor.py
)


def _covered_once(lanes, steps, B, L):
    valid = lanes < B
    flat = lanes[valid] * L + steps[valid]
    counts = np.bincount(flat, minlength=B * L)
    return counts.size == B * L and bool((counts == 1).all())


@pytest.mark.parametrize("B", BATCHES)
def test_fused_geometry_covers_every_lane_and_step_size_once(B):
    for L in STEPS:
        g = K3.fused_geometry(B, L)
        nl, threads = g["lanes_per_block"], g["threads"]
        assert threads == nl * L <= _build.LS_MAX_THREADS
        assert g["blocks"] == -(-B // nl)
        # linesearch_fused.cu: NL = blockDim.x / L, l = threadIdx.x / NL,
        # j = threadIdx.x - l * NL, b = blockIdx.x * NL + j.
        blk, tid = np.divmod(np.arange(g["blocks"] * threads), threads)
        step = tid // (threads // L)
        lane = blk * (threads // L) + tid - step * (threads // L)
        assert _covered_once(lane, step, B, L), (B, L)


def test_fused_geometry_keeps_the_sms_busy():
    """The main path's batches fill all 132 SMs; the fan-out's (1,024
    lanes) as many as 8-lane blocks allow."""
    assert K3.fused_geometry(4096, 10)["blocks"] >= _build.H100_SMS
    assert K3.fused_geometry(16384, 10)["blocks"] >= _build.H100_SMS
    assert K3.fused_geometry(1024, 10)["blocks"] == 128
    assert K3.fused_geometry(16384, 8)["lanes_per_block"] == 16


@pytest.mark.parametrize("B", BATCHES)
def test_mlp_geometry_covers_every_rollout_once(B):
    for widths, ds, dc in MLP_WIDTHS:
        for L in STEPS:
            g = K5.mlp_geometry(widths, ds, dc, L, B)
            nl, R = g["lanes_per_block"], g["rollouts"]
            assert R == nl * L and g["blocks"] == -(-B // nl)
            assert g["smem"] <= _build.MAX_SMEM_BYTES
            assert 64 <= g["threads"] <= _build.MLP_MAX_THREADS
            assert g["threads"] % 32 == 0
            # mlp_linesearch.cu: block k's rollout r is output rollout
            # g = k R + r, lane k nl + r / L, step size r % L.
            blk, r = np.divmod(np.arange(g["blocks"] * R), R)
            lane, step = blk * nl + r // L, r % L
            assert np.array_equal(lane * L + step, blk * R + r)
            assert _covered_once(lane, step, B, L), (widths, B, L)


def test_mlp_geometry_fills_the_card_at_the_cheetah_batch():
    """B=1024, L=10: the grid fits on the card at once, so a block takes
    2 lanes (20 rollouts) and 160 threads (one 2 x 4 tile of a 64-wide
    layer each), 512 blocks, ~4 an SM; the dense-cost path's B=4096 takes
    4 lanes and one 4 x 4 tile a thread."""
    g = K5.mlp_geometry([24, 64, 64, 18], 18, 6, 10, 1024)
    assert (g["lanes_per_block"], g["blocks"], g["threads"]) == (2, 512, 160)
    g = K5.mlp_geometry([5, 64, 64, 4], 4, 1, 10, 4096)
    assert (g["lanes_per_block"], g["blocks"], g["threads"]) == (4, 1024, 160)


def _ls_args(B=8, H=3, L=11):
    rng = np.random.default_rng(0)
    t = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float64)
    from autompc_torch.sysid.basis import TermDesc

    terms = (TermDesc("x0", (1, 0, 0, 0, 0)), TermDesc("u", (0, 0, 0, 0, 1)))
    return (terms, t(4, B), t(H + 1, 4, B), t(H, B), t(H, 4, B), t(H, B), t(4, 2),
            tuple(0.5 ** k for k in range(L)), -1.0, 1.0, (1.0,) * 4, (0.1,), (1.0,) * 4,
            (0.0,) * 4, 0.05, t(B), t(B), t(B), torch.zeros(B, dtype=torch.bool),
            torch.ones(B, dtype=torch.bool), t(H, 20, B))


def test_fused_line_search_refuses_more_than_ten_step_sizes_by_name():
    with pytest.raises(ValueError, match="fused_line_search: 1..10 step sizes"):
        K3.fused_line_search(*_ls_args(L=_build.MAX_L + 1))
    with pytest.raises(ValueError, match="fused_line_search: 1..10 step sizes"):
        K3.fused_geometry(4096, _build.MAX_L + 1)


@pytest.mark.parametrize("widths, ds, dc", [
    ([7, 129, 5], 5, 2),
    ([7] + [8] * 5 + [5], 5, 2),
])
def test_mlp_line_search_refuses_kernel_limits_by_name(widths, ds, dc):
    """Widths over 128 and more than 5 layers raise on the CPU too,
    before the plain version runs."""
    rng = np.random.default_rng(1)
    B, H = 3, 4
    layers = tuple((torch.as_tensor(rng.normal(size=(a, b))), torch.zeros(b, dtype=torch.float64))
                   for a, b in zip(widths[:-1], widths[1:]))
    t = lambda *s: torch.as_tensor(rng.normal(size=s))
    with pytest.raises(ValueError, match="mlp_line_search: the kernel takes"):
        K5.mlp_line_search(layers, "relu", t(B, ds), t(B, H + 1, ds), t(B, H, dc),
                           t(B, H, dc, ds), t(B, H, dc), (1.0, 0.5), -1.0, 1.0)
    with pytest.raises(ValueError, match="mlp_line_search: 1..10 step sizes"):
        K5.mlp_geometry([7, 8, 5], 5, 2, _build.MAX_L + 1, 16)
