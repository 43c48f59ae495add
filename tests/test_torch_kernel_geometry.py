"""The launch geometry that the wrappers of K2 (lanes-last backward), K3
(fused line search), K4 (general backward), K5 (MLP line search) and K8
(the split line search's objective sweep) choose in Python, and K9's
(its read-back), set in C: every lane, (lane, step size) or product output falls
to exactly one thread, block slot or tile under the kernels' own index
arithmetic, the blocks stay within the card's limits, and the wrappers
refuse, by name and without a card, the shapes the kernels do not take."""

import numpy as np
import pytest
import torch

from autompc_torch.ops import _build
from autompc_torch.ops import cuda_linesearch as K3
from autompc_torch.ops import cuda_mlp_linesearch as K5
from autompc_torch.ops import cuda_riccati as K2
from autompc_torch.ops import cuda_riccati_general as K4

torch.set_num_threads(1)

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


# The split line search takes B % 1024 == 0 (the TPU's wide tile).
WIDE_BATCHES = (1024, 4096, 16384)


@pytest.mark.parametrize("B", WIDE_BATCHES)
def test_wide_objectives_launch_covers_every_candidate_once(B):
    """K8 takes K3's launch: ls_obj_wide.cu's NL = blockDim.x / L,
    l = threadIdx.x / NL, j = threadIdx.x - l * NL, b = blockIdx.x * NL + j
    writes objective, du2 and stash column l * B + b: each once."""
    for L in STEPS:
        g = K3.fused_geometry(B, L)
        nl, threads = g["lanes_per_block"], g["threads"]
        blk, tid = np.divmod(np.arange(g["blocks"] * threads), threads)
        step = tid // nl
        lane = blk * nl + tid - step * nl
        col = (step * B + lane)[lane < B]
        assert np.array_equal(np.sort(col), np.arange(L * B)), (B, L)


def test_wide_objectives_refuses_more_than_ten_step_sizes_by_name():
    args = _ls_args(B=1024, L=_build.MAX_L + 1)
    with pytest.raises(ValueError, match="wide_objectives: 1..10 step sizes"):
        K3.wide_objectives(*args[:15])


@pytest.mark.parametrize("H", (1, 10, 200))
@pytest.mark.parametrize("B", WIDE_BATCHES)
def test_reroll_geometry_covers_every_step_and_lane_once(B, H):
    """K9's launch, set in C: ls_reroll_wide.cu's grid of
    (ceil(B / AMPC_RR_THREADS), H) blocks of AMPC_RR_THREADS threads,
    t = blockIdx.y, b = blockIdx.x * blockDim.x + threadIdx.x."""
    import re

    src = (_build.CSRC_DIR / "ls_reroll_wide.cu").read_text()
    nl = int(re.search(r"#define AMPC_RR_THREADS (\d+)", src)[1])
    assert nl % 32 == 0 and nl <= 1024
    assert "grid((unsigned)((B + AMPC_RR_THREADS - 1) / AMPC_RR_THREADS),\n" \
           "                  (unsigned)H)" in src
    assert "<<<grid, AMPC_RR_THREADS, 0, s>>>" in src
    assert "const int t = blockIdx.y;" in src
    assert "const int b = blockIdx.x * blockDim.x + threadIdx.x;" in src
    nx = -(-B // nl)
    blk, tid = np.divmod(np.arange(nx * nl), nl)
    lanes = np.tile(blk * nl + tid, H)
    steps = np.repeat(np.arange(H), nx * nl)
    assert _covered_once(lanes, steps, B, H), (B, H)


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


# K2 (lanes-last backward) and K4 (general backward): the batches their
# paths give them and the edges of their pickers.
BACKWARD_BATCHES = (1, 7, 32, 256, 1024, 4096, 16384)


@pytest.mark.parametrize("B", BACKWARD_BATCHES)
def test_bq_geometry_covers_every_lane_once(B):
    g = K2.bq_geometry(B, 4)
    nl = g["lanes_per_block"]
    assert 32 <= nl <= _build.BQ_MAX_LANES and nl % 32 == 0
    assert g["blocks"] == -(-B // nl)
    assert g["smem"] <= _build.MAX_SMEM_BYTES
    # riccati_quad.cu: b = blockIdx.x * blockDim.x + threadIdx.x.
    blk, tid = np.divmod(np.arange(g["blocks"] * nl), nl)
    b = blk * nl + tid
    assert _covered_once(b, np.zeros_like(b), B, 1), B


def test_bq_geometry_spreads_the_gate_and_the_main_path():
    """One warp a block up to ~4 blocks an SM: the gate's 256 lanes reach
    8 SMs and the main path's 4096 reach 128 (64-thread blocks reached 4
    and 64); past that the blocks grow."""
    assert K2.bq_geometry(256)["blocks"] == 8
    assert K2.bq_geometry(4096)["blocks"] == 128
    assert K2.bq_geometry(16384)["lanes_per_block"] == 32
    assert K2.bq_geometry(65536)["lanes_per_block"] == 128


@pytest.mark.parametrize("B", BACKWARD_BATCHES)
def test_bq_bf16_ring_words_hold_each_lane_once(B):
    """bfloat16 Jacobian rows in K2's ring (riccati_quad.cu): at an even
    B, thread b (lane bl = min(b, B - 1)) copies the 4-byte word of the
    row that starts at lane jl = bl & ~1 into a word of its own and reads
    half jh = bl & 1 of it, so the word lies in the batch and each lane
    is read by its own thread from its own place. At an odd B the last
    lane's word would run past the batch: the rows are read at the step."""
    g = K2.bq_geometry(B)
    b = np.arange(g["blocks"] * g["lanes_per_block"])
    bl = np.minimum(b, B - 1)
    jl, jh = bl & ~1, bl & 1
    if B % 2:
        assert jl.max() + 1 == B
        return
    assert jl.max() + 1 < B and (jl + jh == bl).all()
    assert _covered_once((jl + jh)[b < B], np.zeros(B, dtype=int), B, 1)


K4_INSTANCES = [(ds, dc, sh["threads_per_lane"]) for (ds, dc), sh in K4.GENERAL_SHAPES.items()]


@pytest.mark.parametrize("B", BACKWARD_BATCHES)
@pytest.mark.parametrize("ds, dc, tpl", K4_INSTANCES)
def test_general_geometry_covers_every_lane_once(ds, dc, tpl, B):
    g = K4.general_geometry(ds, dc, B)
    nl = g["lanes_per_block"]
    assert g["threads_per_lane"] == tpl
    assert g["threads"] == tpl * nl <= 1024 and g["threads"] % 32 == 0
    assert nl <= K4.GENERAL_SHAPES[(ds, dc)]["max_lanes"]
    assert g["smem"] <= _build.MAX_SMEM_BYTES
    # riccati_general.cu: lt = threadIdx.x % TPL, lane = blockIdx.x * lanes
    # + threadIdx.x / TPL: each lane gets TPL threads, one of each lt.
    blk, tid = np.divmod(np.arange(g["blocks"] * g["threads"]), g["threads"])
    lane, lt = blk * nl + tid // tpl, tid % tpl
    assert _covered_once(lane, lt, B, tpl), (ds, dc, B)


@pytest.mark.parametrize("ds, dc, tpl", K4_INSTANCES)
def test_general_tiles_cover_each_product_once(ds, dc, tpl):
    """Under the kernel's tile arithmetic (tile = first, first + step,
    ...; row group tile / column groups, column group tile % column
    groups) every output of the products the recursion needs falls to
    exactly one thread of the lane: [Jx|Ju]'[V|v] (NJ x (ds+1)) on all
    threads; Qxx and Qux (NJ x ds) on all threads, or with 64 or more
    threads a lane on all warps but the last; Quu (dc x dc) on the last
    warp, or else counted down from the last thread; the next V (ds x
    ds) on all threads; the next v one element each of threads 0..ds-1."""
    sh = K4.GENERAL_SHAPES[(ds, dc)]
    nj, nv = ds + dc, ds + 1
    split = tpl >= 64
    qt = tpl - 32 if split else tpl

    def cover(tile, rows, cols, starts, step, need=lambda r, c: True):
        (tr, tc), seen = tile, {}
        groups = -(-cols // tc)
        for first in starts:
            for t in range(first, (rows // tr) * groups, step):
                r0, c0 = (t // groups) * tr, (t % groups) * tc
                for r in range(r0, r0 + tr):
                    for c in range(c0, c0 + tc):
                        if need(r, c):
                            seen[(r, c)] = seen.get((r, c), 0) + 1
        return seen

    p1 = cover(sh["p1"], nj, nv, range(tpl), tpl, lambda c, j: j < nv)
    p2 = cover(sh["p2"], nj, ds, range(qt), qt)
    pu = cover(sh["pu"], dc, dc, range(32) if split else [tpl - 1 - lt for lt in range(tpl)],
               32 if split else tpl)
    p5 = cover(sh["p5"], ds, ds, range(tpl), tpl, lambda i, j: j < ds)
    assert len(p1) == nj * nv and set(p1.values()) == {1}
    assert len(p2) == nj * ds and set(p2.values()) == {1}
    assert len(pu) == dc * dc and set(pu.values()) == {1}
    assert len(p5) == ds * ds and set(p5.values()) == {1}
    assert ds < qt


def test_general_geometry_fills_the_card_at_the_cheetah_batch():
    """B=1024: two warps a lane, 4 lanes a block, 256 blocks; the closed
    loop's B=32: a lane a block on 32 SMs; the dense path's B=4096 at
    (4, 1): 16 lanes of 8 threads a block, 256 blocks."""
    g = K4.general_geometry(18, 6, 1024)
    assert (g["threads_per_lane"], g["lanes_per_block"], g["blocks"]) == (64, 4, 256)
    g = K4.general_geometry(18, 6, 32)
    assert (g["threads_per_lane"], g["lanes_per_block"], g["blocks"]) == (64, 1, 32)
    g = K4.general_geometry(4, 1, 4096)
    assert (g["lanes_per_block"], g["threads"], g["blocks"]) == (16, 128, 256)


def test_general_geometry_packs_lanes_on_a_small_card():
    """The closed loop's 32 lanes take a block each on an H100 and four a
    block (8 blocks) on a card of 8 SMs."""
    g = K4.general_geometry(18, 6, 32, 8)
    assert (g["lanes_per_block"], g["blocks"]) == (4, 8)
    g = K4.general_geometry(18, 6, 32, 132)
    assert (g["lanes_per_block"], g["blocks"]) == (1, 32)


@pytest.mark.parametrize("which", ["K2", "K4"])
def test_backward_kernels_refuse_unbuilt_shapes_by_name(which, monkeypatch):
    """The pickers and the wrappers of tensors that are not on the CPU
    raise at a shape with no instance, before any launch (device_kind and
    the SM count are patched, meta tensors stand in for the card's)."""
    monkeypatch.setattr(_build, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(_build, "sm_count", lambda device: _build.H100_SMS)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device="meta")
    if which == "K2":
        with pytest.raises(ValueError, match="backward kernel is built for"):
            K2.bq_geometry(64, ds=5)
        carry = (torch.zeros(3, dtype=torch.bool, device="meta"), z(2, 5, 3), z(2, 3))
        with pytest.raises(ValueError, match="backward kernel is built for"):
            K2.backward_quad_ll(z(2, 30, 3), z(3, 5, 3), z(2, 3), (1.0,) * 5, (0.1,),
                                (1.0,) * 5, (0.0,) * 5, 0.05, 5, carry)
        return
    with pytest.raises(ValueError, match="general backward kernel is built for"):
        K4.general_geometry(5, 2, 64)
    B, H, ds, dc = 3, 2, 5, 2
    with pytest.raises(ValueError, match="general backward kernel is built for"):
        K4.riccati_general(z(B, H, ds, ds), z(B, H, ds, dc), z(B, H, ds, ds), z(B, H, dc, dc),
                           z(B, H, ds), z(B, H, dc), z(B, ds, ds), z(B, ds))


def test_backward_geometry_mirrors_the_sources():
    """The pickers' constants are the ones the CUDA sources compile in:
    K2's ring depth and largest block, K4's threads a lane, lanes a
    block, tiles and ring depth per instance."""
    import re

    quad = (_build.CSRC_DIR / "riccati_quad.cu").read_text()
    assert int(re.search(r"#define AMPC_BQ_RING (\d+)", quad)[1]) == _build.BQ_RING
    assert int(re.search(r"#define AMPC_BQ_MAX_LANES (\d+)", quad)[1]) == _build.BQ_MAX_LANES
    gen = (_build.CSRC_DIR / "riccati_general.cu").read_text()
    instances = {(int(a), int(b), int(c)) for a, b, c in
                 re.findall(r"rg_launch<(\d+), (\d+), (\d+)>\(", gen)}
    assert instances == set(K4_INSTANCES)
    for ds, dc, tpl in K4_INSTANCES:
        sh = K4.GENERAL_SHAPES[(ds, dc)]
        body = re.search(r"struct RgShape<%d, %d, %d> \{(.*?)\};" % (ds, dc, tpl), gen,
                         re.S)[1]
        v = {k: int(n) for k, n in re.findall(r"(\w+) = (\d+)", body)}
        assert (v["P1R"], v["P1C"]) == sh["p1"] and (v["P2R"], v["P2C"]) == sh["p2"]
        assert (v["PUR"], v["PUC"]) == sh["pu"] and (v["P5R"], v["P5C"]) == sh["p5"]
        assert (v["RING"], v["MAX_LANES"]) == (sh["ring"], sh["max_lanes"])
