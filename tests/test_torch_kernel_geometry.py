"""The launch geometry that the wrappers of K1 (relinearization), K2
(lanes-last backward), K3 (fused line search), K4 (general backward), K5
(MLP line search), K7 (batch-major rollout line search) and K8 (the split
line search's objective sweep) choose in Python, and K9's (its
read-back), set in C: every lane, (lane, step size), (step, lane,
column) or product output falls to exactly one thread, block slot or tile
under the kernels' own index arithmetic, the blocks stay within the
card's limits, and the wrappers refuse, by name and without a card, the
shapes the kernels do not take."""

import numpy as np
import pytest
import torch

from autompc_torch.ops import _build
from autompc_torch.ops import cuda_linesearch as K3
from autompc_torch.ops import cuda_mlp_linesearch as K5
from autompc_torch.ops import cuda_relin as K1
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


@pytest.mark.parametrize("which", ["K2", "K4", "K6"])
def test_backward_kernels_refuse_unbuilt_shapes_by_name(which, monkeypatch):
    """The pickers and the wrappers of tensors that are not on the CPU
    raise past the kernels' stated limits (ds + 1 <= MAX_D, K2's ds <=
    BQ_MAX_DS, obsdim <= MAX_OBS for K2 and K6; K4's ds + dc <= MAX_D; K6
    and K4 at dc = 1 past MAX_D up to the wide instance's width, past
    which NotPortedError), before any build or launch
    (device_kind and the SM count are patched, meta tensors stand in for
    the card's)."""
    monkeypatch.setattr(_build, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(_build, "sm_count", lambda device: _build.H100_SMS)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device="meta")
    if which == "K6":        # its wrapper: tests/test_torch_import.py
        from autompc_torch import NotPortedError

        assert K2.bq_bm_geometry(64, 10, ds=_build.MAX_D)["big"]
        with pytest.raises(NotPortedError, match=r"riccati_quad_bm: .*MAX_D = 24"):
            K2.bq_bm_geometry(64, 10, ds=_build.BQBM_BIG_MAX_DS + 1)
        return
    if which == "K2":
        with pytest.raises(ValueError, match=r"riccati_quad: .*MAX_D = 24"):
            K2.bq_geometry(64, ds=_build.MAX_D)
        n = _build.MAX_OBS + 1
        carry = (torch.zeros(3, dtype=torch.bool, device="meta"), z(2, n, 3), z(2, 3))
        with pytest.raises(ValueError, match="obsdim <= MAX_OBS = 8"):
            K2.backward_quad_ll(z(2, n * (n + 1), 3), z(3, n, 3), z(2, 3), (1.0,) * n,
                                (0.1,), (1.0,) * n, (0.0,) * n, 0.05, n, carry)
        return
    with pytest.raises(ValueError, match=r"riccati_general: .*MAX_D = 24"):
        K4.general_geometry(20, 5, 64)
    B, H, ds, dc = 3, 2, 20, 5
    with pytest.raises(ValueError, match=r"riccati_general: .*MAX_D = 24"):
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


# K7 (batch-major rollout line search): the batches of the cost fan-out's
# batch-major configuration (1,024 and its compaction stages) and beyond.
SINDY_BATCHES = (1, 7, 128, 256, 512, 1024, 4096)


def _sindy_source():
    return (_build.CSRC_DIR / "sindy_linesearch.cu").read_text()


@pytest.mark.parametrize("B", SINDY_BATCHES)
def test_sindy_geometry_covers_every_candidate_once(B, monkeypatch):
    """Under sindy_linesearch.cu's index arithmetic (g = tid % G,
    c = (bx * threads + tid) / G, lane c / L, step size c % L) every
    (lane, step size) falls to exactly one group of G threads, one of
    each g, inside one warp (its shuffles stay there), whose thread 0
    stores it, for the group the wrapper picks and for each group (the
    threshold moved to force it)."""
    import math

    for g4_from in (None, 0, 1 << 40):
        if g4_from is not None:
            monkeypatch.setattr(K3, "SINDY_G4_FROM", g4_from)
        for L in (1, 3, 10):
            g = K3.sindy_geometry(B, L)
            G, threads = g["group"], g["threads"]
            assert G in K3.SINDY_GROUPS and threads % 32 == 0
            assert threads == K3.SINDY_THREADS
            assert g["blocks"] == math.ceil(B * L * G / threads)
            blk, tid = np.divmod(np.arange(g["blocks"] * threads), threads)
            gi, c = tid % G, (blk * threads + tid) // G
            warp = (blk * threads + tid) // 32
            valid = c < B * L
            seen = np.bincount((c * G + gi)[valid], minlength=B * L * G)
            assert seen.size == B * L * G and (seen == 1).all()
            # The group's first and last threads share a warp.
            first = np.flatnonzero(gi == 0)
            assert (warp[first] == warp[first + G - 1]).all()
            assert (c[first] == c[first + G - 1]).all()
            stores = np.bincount(c[valid & (gi == 0)], minlength=B * L)
            assert stores.size == B * L and (stores == 1).all(), (B, L, g4_from)


def test_sindy_geometry_picks_groups_by_batch():
    """Eight threads a candidate below SINDY_G4_FROM lanes, four from
    it, in blocks of SINDY_THREADS threads."""
    assert K3.sindy_geometry(1024, 10)["group"] == 8
    assert K3.sindy_geometry(128, 10)["group"] == 8
    assert K3.sindy_geometry(K3.SINDY_G4_FROM, 10)["group"] == 4
    assert K3.sindy_geometry(4096, 10)["group"] == 4
    g = K3.sindy_geometry(128, 10)            # 10,240 threads: 80 blocks of 128
    assert (g["threads"], g["blocks"]) == (128, 80)
    g = K3.sindy_geometry(4096, 10)           # 163,840 threads: 1,280 blocks
    assert (g["threads"], g["blocks"]) == (128, 1280)
    with pytest.raises(ValueError, match="sindy_line_search: 1..10 step sizes"):
        K3.sindy_geometry(1024, _build.MAX_L + 1)


def test_sindy_geometry_mirrors_the_source():
    """The groups, the largest block and the launch arithmetic that
    sindy_geometry mirrors are the source's."""
    import re

    src = _sindy_source()
    assert K3.SINDY_THREADS <= int(re.search(r"#define AMPC_SLS_MAX_THREADS (\d+)", src)[1])
    groups = tuple(int(g) for g in re.findall(r"case (\d+):\n\s+sls_launch<DS, DC, \1>", src))
    assert groups == K3.SINDY_GROUPS
    for line in ("const int g = (int)(threadIdx.x % G);",
                 "const long long cr = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;",
                 "const int b = (int)(c / P.L);",
                 "const float alpha = P.alphas[c - (long long)b * P.L];",
                 "const bool store = valid && g == 0;",
                 "float* oxf = out_xs + c * (H + 1) * DS;",
                 "float4* oxs = reinterpret_cast<float4*>(oxf);",
                 "const long long n = (long long)B * P->L * G;",
                 "const unsigned blocks = (unsigned)((n + threads - 1) / threads);",
                 "threads > AMPC_SLS_MAX_THREADS || threads % 32)"):
        assert line in src, line


# K1 (relinearization): one kernel in two layouts and two geometries, a
# thread per (step, lane, Jacobian column) or per (step, lane).
RELIN_SHAPES = ((1, 1), (7, 3), (128, 10), (256, 20), (1024, 10), (33, 200))


def _relin_source():
    return (_build.CSRC_DIR / "relin.cu").read_text()


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("B, H", RELIN_SHAPES)
def test_relin_geometry_covers_every_step_lane_and_column_once(B, H, split, monkeypatch):
    """relin.cu: blocks of (NL, CT) threads, thread (x, y) taking columns
    y, y + CT, ... of its point (CT = 5, one column a warp, or CT = 1,
    all five). Lanes-last: a grid of (ceil(B / NL), H), t = blockIdx.y,
    b = blockIdx.x NL + x. Batch-major: a grid of ceil(B H / NL), point
    p = blockIdx.x NL + x, b = p / H, t = p % H, and the block's staged
    rows written back as two runs, each output word once, at
    (p ds + i) ds + dd of Jx and p ds + i of Ju."""
    monkeypatch.setattr(K1, "SM_THREADS", 1 << 40 if split else 0)
    g = K1.relin_geometry(B, H)
    NL, CT, ds, D = g["lanes"], g["threads"] // g["lanes"], 4, 5
    assert CT == (D if split else 1)

    def columns(y):
        return np.arange(y, D, CT)

    # Lanes-last.
    seen = np.zeros((H, B, D), int)
    for bx in range(-(-B // NL)):
        for x in range(NL):
            b = bx * NL + x
            if b < B:
                for y in range(CT):
                    seen[:, b, columns(y)] += 1
    assert (seen == 1).all()
    # Batch-major.
    n = B * H
    seen = np.zeros((n, D), int)
    jx, ju = np.zeros(n * ds * ds, int), np.zeros(n * ds, int)
    for bx in range(-(-n // NL)):
        p0 = bx * NL
        npts = min(NL, n - p0)
        s_jx, s_ju = {}, {}
        for x in range(npts):
            p = p0 + x
            b, t = p // H, p % H
            for y in range(CT):
                for dd in columns(y):
                    seen[b * H + t, dd] += 1
                    for i in range(ds):
                        if dd < ds:
                            s_jx[(x, i * ds + dd)] = (p * ds + i) * ds + dd
                        else:
                            s_ju[(x, i)] = p * ds + i
        for o in range(npts * ds * ds):
            jx[p0 * ds * ds + o] += 1
            assert s_jx[(o // (ds * ds), o % (ds * ds))] == p0 * ds * ds + o
        for o in range(npts * ds):
            ju[p0 * ds + o] += 1
            assert s_ju[(o // ds, o % ds)] == p0 * ds + o
    assert (seen == 1).all() and (jx == 1).all() and (ju == 1).all()


def test_relin_geometry_splits_where_the_points_cannot_fill_the_card():
    """The gate's and the fan-outs' shapes take a thread per column, the
    main path's a thread per point."""
    for B, H in ((256, 20), (1024, 10), (128, 10)):
        assert K1.relin_geometry(B, H)["split"]
    for B, H in ((4096, 200), (16384, 200)):
        assert not K1.relin_geometry(B, H)["split"]
    assert not K1.relin_geometry(256, 20, n_sm=2)["split"]   # a card of 2 SMs
    assert K1.relin_geometry(1024, 10)["threads"] == 160


def test_relin_geometry_mirrors_the_source():
    import re

    src = _relin_source()
    assert int(re.search(r"#define AMPC_RELIN_SPLIT_LANES (\d+)", src)[1]) == \
        K1.RELIN_SPLIT_LANES
    assert int(re.search(r"#define AMPC_RELIN_WHOLE_LANES (\d+)", src)[1]) == \
        K1.RELIN_WHOLE_LANES
    for line in ("relin_launch<DS, DC, BM, DS + DC, relin_split_lanes(DS, DC, BM)>(",
                 "relin_launch<DS, DC, BM, 1, AMPC_RELIN_WHOLE_LANES>(",
                 "if constexpr (relin_whole_fits(DS, DC, BM)) {",
                 "#define AMPC_RELIN_STATIC_SMEM (48 * 1024)",
                 "return 4 * (DS * AMPC_MAX_F + (BM ? NL : 1) * (DS * DS + 1) + "
                 "(BM ? NL : 1) * (DS * DC + 1));",
                 "const dim3 block(NL, CT);",
                 "const int dd0 = CT == 1 ? 0 : (int)threadIdx.y;  // first column",
                 "for (int dd = dd0; dd < D; dd += CT) {",
                 "t = blockIdx.y;",
                 "b = blockIdx.x * NL + threadIdx.x;",
                 "p0 = (long long)blockIdx.x * NL;",
                 "b = (int)(q / H);",
                 "t = (int)(q - (long long)b * H);",
                 "s_jx[threadIdx.x][i * DS + dd] = col[i];",
                 "s_ju[threadIdx.x][i * DC + dd - DS] = col[i];",
                 "jx_out[o] = s_jx[o / (DS * DS)][o % (DS * DS)];",
                 "for (int o = tid; o < np * DS * DC; o += NL * CT)",
                 "ju_out[o] = s_ju[o / (DS * DC)][o % (DS * DC)];",
                 "const dim3 grid((unsigned)((B + NL - 1) / NL), (unsigned)H);",
                 "const unsigned grid = (unsigned)((n + NL - 1) / NL);"):
        assert line in src, line


# K6 (batch-major diagonal-cost backward): the batches of the cost
# fan-out's batch-major configuration (1,024 and its compaction stages),
# the A/B shapes and odd batches, at H=10 (the whole horizon in the ring)
# and H=200 (the ring wraps).
BQBM_BATCHES = (1, 7, 128, 256, 512, 1023, 1024, 4096, 16384)


def _bqbm_flush(B, H, NL, G, blocks):
    """Under riccati_quad_bm.cu's flush arithmetic, how often each (lane,
    step) of Ks and ks is written: every RING steps and at t = 0 (slot
    s), thread g of lane b's group writes steps t + g, t + g + G, ...
    <= t + s, for b < B."""
    RING = _build.BQBM_RING
    counts = np.zeros((B, H), int)
    lanes = np.arange(blocks * NL)
    lanes = lanes[lanes < B]
    for t in range(H - 1, -1, -1):
        s = (H - 1 - t) % RING
        if s != RING - 1 and t != 0:
            continue
        for g in range(G):
            for d in range(g, s + 1, G):
                np.add.at(counts, (lanes, np.full_like(lanes, t + d)), 1)
    return counts


@pytest.mark.parametrize("H", (10, 200))
@pytest.mark.parametrize("B", BQBM_BATCHES)
def test_bq_bm_geometry_covers_every_lane_and_row_once(B, H):
    """riccati_quad_bm.cu: thread tid of block bx is thread g = tid % G of
    lane bx NL + tid / G (G = ds = 4) and owns row g of the value matrix:
    every (lane, row) falls to one thread, a lane's group to one warp;
    every (lane, step) of the gains is written once by the groups'
    flushes; the block fits the card's shared memory."""
    g = K2.bq_bm_geometry(B, H)
    G, NL, threads = g["group"], g["lanes_per_block"], g["threads"]
    assert G == 4 and threads == NL * G and threads % 32 == 0
    assert threads <= _build.BQBM_MAX_THREADS
    assert g["blocks"] == -(-B // NL)
    assert g["ring"] == min(H, _build.BQBM_RING)
    assert g["smem"] <= _build.MAX_SMEM_BYTES
    blk, tid = np.divmod(np.arange(g["blocks"] * threads), threads)
    lane, row = blk * NL + tid // G, tid % G
    ok = lane < B
    seen = np.zeros((B, 4), int)
    np.add.at(seen, (lane[ok], row[ok]), 1)
    assert (seen == 1).all(), (B, H)
    warp = (blk * threads + tid) // 32
    first = np.flatnonzero(row == 0)
    assert (warp[first] == warp[first + G - 1]).all()
    assert (_bqbm_flush(B, H, NL, G, g["blocks"]) == 1).all(), (B, H)


def test_bq_bm_geometry_spreads_the_fan_out():
    """A group of four a lane; one warp a block up to ~4 blocks an SM:
    the fan-out's 1,024 lanes take 128 warps on 128 SMs, its 128 lanes
    16; the whole horizon of H=10 in the ring."""
    g = K2.bq_bm_geometry(1024, 10)
    assert (g["group"], g["lanes_per_block"], g["blocks"], g["ring"]) == (4, 8, 128, 10)
    assert K2.bq_bm_geometry(128, 10)["blocks"] == 16
    g = K2.bq_bm_geometry(4096, 200)
    assert (g["group"], g["threads"], g["blocks"], g["ring"]) == (4, 32, 512, _build.BQBM_RING)
    assert K2.bq_bm_geometry(16384, 200)["threads"] == _build.BQBM_MAX_THREADS


def test_bq_bm_ring_reads_each_step_from_the_slot_it_was_fetched_into():
    """riccati_quad_bm.cu's ring: the prologue fetches step H-1-s into
    slot s (s < RING-1); the step t (slot s_t = (H-1-t) % RING) fetches
    step t-(RING-1) into the slot step t+1 read. Every step is fetched
    once, into the slot it is read from, at most RING-1 steps ahead; the
    slots used fit the ring the wrapper sizes."""
    RING = _build.BQBM_RING
    for H in (1, 2, 10, RING - 1, RING, RING + 1, 25, 200):
        where, when = {}, {}
        for s in range(RING - 1):
            if H - 1 - s >= 0:
                where[H - 1 - s], when[H - 1 - s] = s, H
        s = 0
        for t in range(H - 1, -1, -1):
            assert where[t] == s == (H - 1 - t) % RING and when[t] - t <= RING - 1
            assert s < K2.bq_bm_geometry(64, H)["ring"]
            if t - (RING - 1) >= 0:
                tf = t - (RING - 1)
                assert tf not in where
                where[tf], when[tf] = (RING - 1 if s == 0 else s - 1), t
                # The slot's previous step (t + 1) has been read.
                assert where[tf] == (H - 1 - (t + 1)) % RING
            s = 0 if s == RING - 1 else s + 1
        assert sorted(where) == list(range(H))


def test_bq_bm_geometry_mirrors_the_source():
    """The ring depth, the largest block, the group, the shared memory a
    lane and the index arithmetic that bq_bm_geometry and the tests
    above mirror are riccati_quad_bm.cu's."""
    import re

    src = (_build.CSRC_DIR / "riccati_quad_bm.cu").read_text()
    assert int(re.search(r"#define AMPC_BQBM_RING (\d+)", src)[1]) == _build.BQBM_RING
    assert int(re.search(r"#define AMPC_BQBM_MAX_THREADS (\d+)", src)[1]) == \
        _build.BQBM_MAX_THREADS
    for line in ("constexpr int RING = AMPC_BQBM_RING, G = DS;",
                 "constexpr int G = 4;",
                 "return S * 30 + 40;",
                 "const int NL = blockDim.x / G;    // lanes a block",
                 "const int S = H < RING ? H : RING;",
                 "const int tid = threadIdx.x, g = tid % G, l = tid / G;",
                 "const long long b = (long long)blockIdx.x * NL + l;",
                 "const int i = g;",
                 "for (int q0 = 0; q0 < DS + 3; q0 += G) {",
                 "if (H - 1 - s >= 0) fetch(H - 1 - s, s);",
                 "ampc_cp_async_wait<RING - 2>();",
                 "if (t - (RING - 1) >= 0) fetch(t - (RING - 1), s == 0 ? RING - 1 : s - 1);",
                 "sK[(s * NL + l) * DS + i] = K_i;",
                 "if (s == RING - 1 || t == 0) {",
                 "for (int d = g; d <= s; d += G) {",
                 "const long long o = b * H + t + d;",
                 "const int sd = s - d;  // the slot of step t + d",
                 "s = s == RING - 1 ? 0 : s + 1;",
                 "const unsigned blocks = (unsigned)((B + lanes - 1) / lanes);",
                 "kernel<<<blocks, lanes * G, smem, (cudaStream_t)stream>>>(",
                 "lanes < 1 || lanes * G > AMPC_BQBM_MAX_THREADS || (lanes * G) % 32 != 0)"):
        assert line in src, line


@pytest.mark.parametrize("B", BQBM_BATCHES)
def test_bq_bm_wide_geometry_covers_every_lane_and_row_once(B):
    """K6 at ds = 12 (riccati_quad_bm.cu: backward_quad_bm_wide_kernel):
    groups of G = 16 threads, thread g < 12 owning row g, two groups a
    warp; every (lane, row) falls to one thread, a group to one warp,
    every (lane, step) of the gains to one flush; the block fits the
    card's shared memory."""
    ds = 12
    for H in (10, 200):
        g = K2.bq_bm_geometry(B, H, ds=ds)
        G, NL, threads = g["group"], g["lanes_per_block"], g["threads"]
        assert G == 16 and threads == NL * G and threads % 32 == 0
        assert threads <= _build.BQBM_MAX_THREADS and g["blocks"] == -(-B // NL)
        ring = min(H, _build.BQBM_RING)
        assert g["ring"] == ring
        assert g["smem"] == NL * 4 * (ring * (ds * ds + 3 * ds + 2) + 2 * (ds * ds + ds))
        assert g["smem"] <= _build.MAX_SMEM_BYTES
        blk, tid = np.divmod(np.arange(g["blocks"] * threads), threads)
        lane, row = blk * NL + tid // G, tid % G
        ok = (lane < B) & (row < ds)
        seen = np.zeros((B, ds), int)
        np.add.at(seen, (lane[ok], row[ok]), 1)
        assert (seen == 1).all(), (B, H)
        warp = (blk * threads + tid) // 32
        first = np.flatnonzero(row == 0)
        assert (warp[first] == warp[first + G - 1]).all()
        assert (_bqbm_flush(B, H, NL, G, g["blocks"]) == 1).all(), (B, H)


def test_bq_bm_wide_copies_cover_each_step_once():
    """The wide instance's fetch: copy q of a step (thread q % G) moves 16
    bytes of the Jx rows (q < 36), of Ju, of x_t, or u_t (the last);
    together they fill a ring slot's Jx, Ju, x_t and u_t once each, from
    the step's rows once each, every 16-byte copy aligned at both ends."""
    ds, G = 12, 16
    R4, NQ = ds // 4, (ds + 2) * (ds // 4) + 1
    slot = np.zeros(ds * ds + ds, int)      # J: the Jx rows, then Ju
    sx, su = np.zeros(ds, int), 0
    src = {"Jx": np.zeros(ds * ds, int), "Ju": np.zeros(ds, int), "x": np.zeros(ds, int)}
    owners = set()
    for q0 in range(0, NQ, G):
        for g in range(G):
            q = q0 + g
            if q >= NQ:
                continue
            owners.add(g)
            if q < ds * R4:
                slot[q * 4:q * 4 + 4] += 1
                src["Jx"][q * 4:q * 4 + 4] += 1
            elif q < (ds + 1) * R4:
                c = q - ds * R4
                slot[ds * ds + c * 4:ds * ds + c * 4 + 4] += 1
                src["Ju"][c * 4:c * 4 + 4] += 1
            elif q < (ds + 2) * R4:
                c = q - (ds + 1) * R4
                sx[c * 4:c * 4 + 4] += 1
                src["x"][c * 4:c * 4 + 4] += 1
            else:
                su += 1
    assert (slot == 1).all() and (sx == 1).all() and su == 1
    assert all((v == 1).all() for v in src.values())
    assert owners == set(range(G))
    # 16-byte alignment: a slot (JW floats), a row of x (ds) and a step of
    # Jx (ds^2), Ju and x (ds) are multiples of 4 floats.
    assert (ds * ds + ds) % 4 == 0 and ds % 4 == 0


def test_bq_bm_wide_mirrors_the_source():
    """The wide instance's group, copies, shared memory a lane and the
    entry's dispatch that bq_bm_geometry and the tests above mirror are
    riccati_quad_bm.cu's."""
    src = (_build.CSRC_DIR / "riccati_quad_bm.cu").read_text()
    for line in ("return S * (DS * DS + 3 * DS + 2) + 2 * (DS * DS + DS);",
                 "constexpr int CW = DS % 4 == 0 ? 4 : 1; // floats a copy: 16 or 4 bytes",
                 "constexpr int R4 = DS / CW;             // copies a row",
                 "constexpr int NQ = (DS + 2) * R4 + 1;",
                 "const bool row = g < DS;",
                 "const int i = row ? g : 0;",
                 "for (int q0 = 0; q0 < NQ; q0 += G) {",
                 "if (row) sK[(s * NL + l) * DS + i] = K_i;",
                 "if (ds == 12)",
                 "return bqbm_wide_launch<12, 16>(",
                 "lanes * G > AMPC_BQBM_MAX_THREADS || (lanes * G) % 32 != 0)"):
        assert line in src, line
    assert K2.bq_bm_geometry(64, 10, ds=12)["group"] == 16


# A numpy float32 model of K6's step: the one-thread recursion
# (riccati_quad_step.cuh: ampc_bq_step, the kernel before its redesign)
# against the kernel's group of G threads a lane, each thread's entries
# computed from what its group exchanged to it, with its copies through
# the ring, its gain stage and its warp's flushes. Products and sums are
# rounded separately (numpy has no float32 FMA), the same in both, so
# the two agree bit for bit exactly when every thread computes each of
# its entries from the same operands in the same order.
_f = np.float32


def _fold(a, b):
    s = a[0] * b[0]
    for k in range(1, len(a)):
        s = s + a[k] * b[k]
    return s


def _bqbm_one_thread(Jx, Ju, xs, us, Qd, Rd, Fd, goal, two_dt, obsdim):
    """ampc_bq_step's order on (B, D) lanes x draws: Ks (B, H, 4, D), ks
    (B, H, D), lin, quad (B, D)."""
    B, H = Jx.shape[:2]
    ds = 4
    qd = [Qd[:, i] * two_dt if i < obsdim else np.zeros_like(Rd[:, 0]) for i in range(ds)]
    rd2 = Rd[:, 0] * two_dt
    fd2 = [Fd[:, i] * _f(2) if i < obsdim else np.zeros_like(Rd[:, 0]) for i in range(ds)]
    V = [[fd2[i] if i == j else np.zeros_like(rd2) for j in range(ds)] for i in range(ds)]
    v = [fd2[i] * (xs[:, H, i] - goal[i]) if i < obsdim else np.zeros_like(rd2)
         for i in range(ds)]
    lin, quad = np.zeros_like(rd2), np.zeros_like(rd2)
    Ks, ks = np.zeros((B, H, ds) + rd2.shape[1:], _f), np.zeros((B, H) + rd2.shape[1:], _f)
    for t in range(H - 1, -1, -1):
        jx = [[Jx[:, t, k, j] for j in range(ds)] for k in range(ds)]
        ju = [Ju[:, t, k, 0] for k in range(ds)]
        cx = [qd[i] * (xs[:, t, i] - goal[i]) if i < obsdim else np.zeros_like(rd2)
              for i in range(ds)]
        cu = rd2 * us[:, t, 0]
        JuV = [_fold(ju, [V[k][j] for k in range(ds)]) for j in range(ds)]
        Quu = rd2 + _fold(JuV, ju)
        inv = _f(1) / Quu
        Qux = [_fold(JuV, [jx[k][j] for k in range(ds)]) for j in range(ds)]
        qu = cu + _fold(ju, v)
        K = [-Qux[j] * inv for j in range(ds)]
        kff = -qu * inv
        lin = lin + qu * kff
        quad = quad + kff * Quu * kff
        JxV = [[_fold([jx[k][i] for k in range(ds)], [V[k][j] for k in range(ds)])
                for j in range(ds)] for i in range(ds)]
        qx = [cx[i] + _fold([jx[k][i] for k in range(ds)], v) for i in range(ds)]
        V = [[_fold(JxV[i], [jx[k][j] for k in range(ds)]) + (qd[i] if i == j else _f(0))
              + Qux[i] * K[j] + K[i] * Qux[j] + K[i] * K[j] * Quu
              for j in range(ds)] for i in range(ds)]
        resid = qu + Quu * kff
        v = [qx[i] + Qux[i] * kff + K[i] * resid for i in range(ds)]
        Ks[:, t] = np.stack(K, axis=1)
        ks[:, t] = kff
    return Ks, ks, lin, quad


def _bqbm_group(Jx, Ju, xs, us, Qd, Rd, Fd, goal, two_dt, obsdim):
    """riccati_quad_bm.cu for one warp (8 lanes of G = 4 threads, the last
    one past the batch of B = 7): every thread's work and its accesses to
    the ring, the exchange buffers and the gain stage, run thread by
    thread, vectorized over the draws. Shared memory starts as NaN, so a
    value read before it was written shows in the outputs."""
    B, H = Jx.shape[:2]
    ds, RING, G = 4, _build.BQBM_RING, 4
    NL = 32 // G
    D = Jx.shape[-1]
    nan = lambda *s: np.full(s + (D,), np.nan, _f)
    sJ, sX, sU = nan(RING, NL, 20), nan(RING, NL, ds), nan(RING, NL)
    sK, sk, sV = nan(RING, NL, ds), nan(RING, NL), nan(2, NL, 20)
    Ks, ks = np.full((B, H, ds, D), np.nan, _f), np.full((B, H, D), np.nan, _f)
    lin_out, quad_out = np.full((B, D), np.nan, _f), np.full((B, D), np.nan, _f)
    threads = [(l, g) for l in range(NL) for g in range(G)]
    bl = {l: min(l, B - 1) for l in range(NL)}
    zero = lambda b: _f(0) * Rd[b, 0]
    st = {}
    for l, i in threads:                          # thread g owns row i = g
        b = bl[l]
        qd = Qd[b, i] * two_dt if i < obsdim else zero(b)
        gl = goal[i] if i < obsdim else _f(0)
        fd2 = Fd[b, i] * _f(2) if i < obsdim else zero(b)
        Vr = [fd2 if i == j else zero(b) for j in range(ds)]
        vr = fd2 * (xs[b, H, i] - gl) if i < obsdim else zero(b)
        st[l, i] = dict(qd=qd, gl=gl, Vr=Vr, vr=vr, rd2=Rd[b, 0] * two_dt,
                        lin=zero(b), quad=zero(b))

    def fetch(l, g, t, s):
        b = bl[l]
        for q in range(g, 7, G):
            if q < ds:
                sJ[s, l, 4 * q:4 * q + 4] = Jx[b, t, q]
            elif q == 4:
                sJ[s, l, 16:20] = Ju[b, t, :, 0]
            elif q == 5:
                sX[s, l] = xs[b, t]
            else:
                sU[s, l] = us[b, t, 0]

    for l, g in threads:
        for s in range(RING - 1):
            if H - 1 - s >= 0:
                fetch(l, g, H - 1 - s, s)
    s = 0
    for t in range(H - 1, -1, -1):
        xv = sV[t & 1]
        for l, i in threads:
            xv[l, 4 * i:4 * i + 4] = st[l, i]["Vr"]
            xv[l, 16 + i] = st[l, i]["vr"]
        full = {(l, g): ([[xv[l, 4 * i + j] for j in range(ds)] for i in range(ds)],
                         [xv[l, 16 + i] for i in range(ds)])
                for l, g in threads}              # after __syncwarp
        for l, g in threads:
            if t - (RING - 1) >= 0:
                fetch(l, g, t - (RING - 1), RING - 1 if s == 0 else s - 1)
        for l, g in threads:
            c = st[l, g]
            V, v = full[l, g]
            J = sJ[s, l]
            jx = [[J[4 * k + j] for j in range(ds)] for k in range(ds)]
            ju = [J[16 + k] for k in range(ds)]
            JuV = [_fold(ju, [V[k][j] for k in range(ds)]) for j in range(ds)]
            Quu = c["rd2"] + _fold(JuV, ju)
            inv = _f(1) / Quu
            Qux = [_fold(JuV, [jx[k][j] for k in range(ds)]) for j in range(ds)]
            qu = c["rd2"] * sU[s, l] + _fold(ju, v)
            K = [-Qux[j] * inv for j in range(ds)]
            kff = -qu * inv
            c["lin"] = c["lin"] + qu * kff
            quu_k = Quu * kff
            c["quad"] = c["quad"] + quu_k * kff
            resid = qu + quu_k
            i = g
            Jc = [J[4 * k + i] for k in range(ds)]
            qux_i = _fold(JuV, Jc)
            K_i = -qux_i * inv
            JxV = [_fold(Jc, [V[k][j] for k in range(ds)]) for j in range(ds)]
            cx = (sX[s, l, i] - c["gl"]) * c["qd"] if i < obsdim else _f(0)
            qx = _fold(Jc, v) + cx
            c["Vr"] = [_fold(JxV, [jx[k][j] for k in range(ds)])
                       + (c["qd"] if i == j else _f(0)) + qux_i * K[j]
                       + K_i * Qux[j] + K_i * K[j] * Quu for j in range(ds)]
            c["vr"] = qx + qux_i * kff + K_i * resid
            sK[s, l, i] = K_i
            if g == 0:
                sk[s, l] = kff
        if s == RING - 1 or t == 0:               # __syncwarp, the flush
            for l, g in threads:
                if l < B:
                    for d in range(g, s + 1, G):
                        Ks[l, t + d] = sK[s - d, l]
                        ks[l, t + d] = sk[s - d, l]
        s = 0 if s == RING - 1 else s + 1
    for l, g in threads:
        if l < B and g == 0:
            lin_out[l], quad_out[l] = st[l, g]["lin"], st[l, g]["quad"]
    return Ks, ks, lin_out, quad_out


@pytest.mark.parametrize("H", (5, _build.BQBM_RING + 3))
def test_bq_bm_group_step_equals_the_one_thread_step(H):
    """Over seeded random steps (16 draws a lane; the fan-out's shape of
    step, Jx near the identity, positive cost diagonals), the group of
    four threads gives the one-thread recursion's Ks, ks, lin and quad bit
    for bit, with the whole horizon in the ring (H=5) and with the ring
    wrapping and a partial last flush (H=15); and the one-thread model is
    the plain PyTorch version run in float32 (the same roundings)."""
    rng = np.random.default_rng(15 + H)
    B, D, ds, obsdim = 7, 16, 4, 3
    r = lambda *s: rng.standard_normal(s + (D,)).astype(_f)
    Jx = (np.eye(ds, dtype=_f)[None, None, :, :, None] + _f(0.1) * r(B, H, ds, ds)).astype(_f)
    Ju = (_f(0.2) * r(B, H, ds, 1)).astype(_f)
    xs, us = r(B, H + 1, ds), r(B, H, 1)
    Qd = (10 ** rng.uniform(-1, 1.5, (B, obsdim, D))).astype(_f)
    Rd = (10 ** rng.uniform(-3, 0, (B, 1, D))).astype(_f)
    Fd = (10 ** rng.uniform(-1, 1.5, (B, obsdim, D))).astype(_f)
    goal, dt = (0.5, -0.25, 0.125), 0.05
    two_dt = _f(2.0 * dt)
    args = (Jx, Ju, xs, us, Qd, Rd, Fd, [_f(x) for x in goal], two_dt, obsdim)
    one = _bqbm_one_thread(*args)
    grp = _bqbm_group(*args)
    for a, b_, name in zip(one, grp, ("Ks", "ks", "lin", "quad")):
        assert np.isfinite(a).all(), name
        assert np.array_equal(a.view(np.uint32), b_.view(np.uint32)), name
    # The plain version in float32, one draw at a time.
    for d in (0, D - 1):
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a[..., d]))
        Ks, ks, lin, quad = K2.backward_quad_plain(t(Jx), t(Ju), t(xs), t(us), t(Qd), t(Rd),
                                                   t(Fd), goal, dt, obsdim)
        for got, want in ((Ks[:, :, 0], one[0][..., d]), (ks[..., 0], one[1][..., d]),
                          (lin, one[2][..., d]), (quad, one[3][..., d])):
            assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_per_lane_limits_mirror_the_sources():
    """The per-lane instances' table size and tree slots are the ones
    features.cuh compiles in, and the trees hold every term the table
    does."""
    import re

    feat = (_build.CSRC_DIR / "features.cuh").read_text()
    big = int(re.search(r"#define AMPC_MAX_F_BIG (\d+)", feat)[1])
    slots = int(re.search(r"#define AMPC_TREE_SLOTS_BIG (\d+)", feat)[1])
    small = int(re.search(r"#define AMPC_TREE_SLOTS (\d+)", feat)[1])
    assert big == _build.MAX_F_LANE >= 2048 and 2 ** slots > big
    assert int(re.search(r"#define AMPC_MAX_F (\d+)", feat)[1]) == _build.MAX_F < 2 ** small


@pytest.mark.parametrize("which", ["K1", "K1 batch-major", "K7", "K3"])
def test_per_lane_wrappers_refuse_libraries_above_the_limit_by_name(which, monkeypatch):
    """A per-lane plane over more terms than the per-lane instances take
    raises by name before any launch (meta tensors stand in for the
    card's), and the shared instances keep their 64-term limit."""
    from autompc_torch.sysid.basis import TermDesc

    monkeypatch.setattr(_build, "device_kind", lambda t: "cuda")
    monkeypatch.setattr(_build, "sm_count", lambda dev: _build.H100_SMS)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device="meta")
    B, H, F = 4, 3, _build.MAX_F_LANE + 1
    terms = tuple(TermDesc(f"t{k}", (1, 0, 0, 0, 0)) for k in range(F))
    match = f"per-lane coefficients take 1..{_build.MAX_F_LANE} terms"
    with pytest.raises(ValueError, match=match):
        if which == "K1":
            K1.relin_jacobians(terms, z(H + 1, 4, B), z(H, B), z(4, F, B))
        elif which == "K1 batch-major":
            K1.relin_jacobians_bm(terms, z(B, H + 1, 4), z(B, H, 1), z(4, F, B))
        elif which == "K7":
            K3.sindy_line_search(terms, z(B, 4), z(B, H + 1, 4), z(B, H, 1), z(B, H, 1, 4),
                                 z(B, H, 1), z(4, F, B), (1.0, 0.2), -1.0, 1.0)
        else:
            b8 = torch.zeros(B, dtype=torch.bool, device="meta")
            K3.fused_line_search(terms, z(4, B), z(H + 1, 4, B), z(H, B), z(H, 4, B), z(H, B),
                                 z(4, F, B), (1.0, 0.2), -1.0, 1.0, z(4, B), z(1, B), z(4, B),
                                 (0.0,) * 4, 0.05, z(B), z(B), z(B), b8, b8, z(H, 20, B))
    with pytest.raises(ValueError, match="shared coefficients take 1..64 terms"):
        K1.relin_jacobians(terms[:65], z(H + 1, 4, B), z(H, B), z(4, 65))
