"""The kernels of the port at every (ds, dc) the TPU kernels take, against
the JAX package, float64 on the CPU, at small sizes:

(a) K4 (``riccati_general``): its plain version at (2, 1) against
    ``pallas_tvlqr_backward`` and at (2, 8) against
    ``pallas_tvlqr_backward_general``, both in interpret mode (1e-9), and
    at (12, 1) against ``jax.vmap(tvlqr_backward_scan)``, the recursion
    the Pallas kernels are pinned to (tracing either kernel in interpret
    mode at ds = 12 takes ~50 s; tests/test_torch_joint_koopman.py holds
    the GaussReg joint-Koopman fan-out through K4's plain version at
    (12, 1) against the JAX package's); the
    rule that sets the tiling of a shape with no hand-set instance
    (``general_shape``) against the constants the CUDA source compiles
    (the source's constexpr helpers built with the host compiler), its
    tiles covering every product once, every shape's largest block
    within the shared memory of a block, and the limits raised by name;
(b) the per-lane-coefficient twins of K1 (both entries), K7 and K3 at
    the pendulum's (2, 1) against the Pallas kernels in interpret mode
    (1e-12; K3's flags exactly), as tests/test_torch_joint_sindy.py holds
    them at (4, 1);
(c) the split line search's K8 and K9 plain versions at (2, 1) against
    ``pallas_fused_line_search_wide`` in interpret mode, B = 1,024 (1e-12,
    the flags exactly);
(d) the pendulum's joint fan-outs against the JAX package's:
    ``JointSINDyQuadCostFanout`` through the feature kernels' twins and
    ``JointMLPQuadCostFanout`` with the horizon mask (JAX's initial nets
    and epoch orders handed over), and one round of the tuner's kinds
    "joint_sindy" and "joint_mlp" (1e-6, the same configurations);
(e) the pendulum's recovery task: the port's receding loop against JAX's
    from starts about upright (1e-8), some lanes ending in the task's box
    and some not.

Both packages see JAX's data draw and the same surrogate coefficients.
"""

import functools
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import PendulumSwingupBenchmark as TPendulum
from autompc_torch.benchmarks.pendulum import RECOVERY_INIT, RECOVERY_SPREAD
from autompc_torch.control import IterativeLQRFactory as TILQRFactory
from autompc_torch.control import make_receding_ilqr_loop as t_loop
from autompc_torch.core.trajectory import TrajectoryBatch as TTB
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.costs import QuadCostFactory as TQuadFactory
from autompc_torch.ops import _build
from autompc_torch.ops import cuda_linesearch as TK3
from autompc_torch.ops import cuda_relin as TK1
from autompc_torch.ops import cuda_riccati_general as TK4
from autompc_torch.parallel import JointMLPQuadCostFanout as TJointMLP
from autompc_torch.parallel import JointSINDyQuadCostFanout as TJointSINDy
from autompc_torch.parallel import fanout as tfanout
from autompc_torch.pipeline import Pipeline as TPipeline
from autompc_torch.sysid import MLPFactory as TMLPFactory
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.sysid import SINDyFactory as TSINDyFactory
from autompc_torch.sysid.basis import FeatureLibrary as TLib
from autompc_torch.tuning import PipelineTuner as TTuner
from autompc_torch.tuning import bucketed as tbk
from autompc_tpu.benchmarks import PendulumSwingupBenchmark
from autompc_tpu.control import IterativeLQRFactory
from autompc_tpu.control.receding import make_receding_ilqr_loop as j_loop
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.costs import QuadCostFactory
from autompc_tpu.ops.pallas_linesearch import (
    pallas_fused_line_search,
    pallas_fused_line_search_wide,
    pallas_sindy_line_search,
)
from autompc_tpu.ops.pallas_relin import pallas_feature_jacobians
from autompc_tpu.ops.pallas_riccati import pallas_tvlqr_backward, pallas_tvlqr_backward_general
from autompc_tpu.ops.riccati import tvlqr_backward_scan
from autompc_tpu.parallel.fanout import JointMLPQuadCostFanout as JJointMLP
from autompc_tpu.parallel.fanout import JointSINDyQuadCostFanout as JJointSINDy
from autompc_tpu.pipeline import Pipeline
from autompc_tpu.sysid import MLPFactory, SINDy, SINDyFactory
from autompc_tpu.sysid.basis import FeatureLibrary as JLib
from autompc_tpu.tuning import PipelineTuner
from autompc_tpu.tuning.bucketed import _mlp_padded_init as j_padded_init

torch.set_num_threads(1)

SURR = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
            trig_interaction=True)
LIB21 = dict(trig_basis=True, trig_freq=1, trig_interaction=True)
ALPHAS = tuple(0.2 ** k for k in range(10))
ALPHAS_K = tuple(0.2 ** k for k in range(4))


# ---- (a) K4 ------------------------------------------------------------------------


def _k4_inputs(ds, dc, B=8, H=3, seed=0):
    """Dense expansions with a positive definite Quu at every step."""
    rng = np.random.default_rng(seed + 10 * ds + dc)
    Jx = 0.98 * np.eye(ds) + rng.normal(0, 0.05, (B, H, ds, ds))
    Ju = rng.normal(0, 0.3, (B, H, ds, dc))
    M = rng.normal(size=(B, H, ds, ds))
    N = rng.normal(size=(B, H, dc, dc))
    P = rng.normal(size=(B, ds, ds))
    return (Jx, Ju, M @ M.swapaxes(-1, -2) / ds,
            N @ N.swapaxes(-1, -2) / dc + 0.1 * np.eye(dc), rng.normal(0, 0.3, (B, H, ds)),
            rng.normal(0, 0.3, (B, H, dc)), P @ P.swapaxes(-1, -2) / ds,
            rng.normal(size=(B, ds)))


@pytest.mark.parametrize("ds, dc, ref", [(2, 1, "pallas"), (2, 8, "pallas"), (12, 1, "scan")])
def test_k4_plain_matches_jax(ds, dc, ref):
    d = _k4_inputs(ds, dc)
    if ref == "scan":
        fn = jax.vmap(tvlqr_backward_scan)
    elif dc == 1:
        fn = functools.partial(pallas_tvlqr_backward, block_b=8, interpret=True)
    else:
        fn = functools.partial(pallas_tvlqr_backward_general, block_b=8, interpret=True)
    ref = fn(*(jnp.asarray(a) for a in d))
    got = TK4.riccati_general(*(torch.as_tensor(a) for a in d))
    assert tuple(got[0].shape) == (8, 3, dc, ds)
    for name, g, r in zip(("Ks", "ks", "lin", "quad"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-12,
                                   err_msg=name)


# The shapes whose rule instance the tests look at: the pendulum, the two
# Koopman lifts phase 19 runs, the limits' largest ones, the rule at the
# hand-set (18, 6) and (4, 1), and a few between.
RULE_SHAPES = [(2, 1), (12, 1), (8, 1), (23, 1), (1, 23), (18, 6), (4, 1), (3, 2), (16, 8),
               (6, 3)]


def _source_rule():
    """The CUDA source's rule (rg_* helpers, the primary RgShape and
    RgLayout) compiled by the host compiler: per (ds, dc), threads a
    lane and the instance's constants."""
    gen = (_build.CSRC_DIR / "riccati_general.cu").read_text()
    head = gen[gen.index("__host__ __device__ constexpr int rg_up4"):
               gen.index("#ifndef AMPC_DS\ntemplate <>")]
    layout = gen[gen.index("template <int DS, int DC, int TPL>\nstruct RgLayout"):
                 gen.index("// N floats from shared memory")]
    rows = "\n".join(
        f'  {{ constexpr int T = rg_tpl({ds}, {dc}); using S = RgShape<{ds}, {dc}, T>; '
        f'printf("{ds} {dc} %d %d %d %d %d %d %d %d %d %d %d %d\\n", T, S::P1R, S::P1C, S::P2R, '
        f'S::P2C, S::PUR, S::PUC, S::P5R, S::P5C, S::RING, S::MAX_LANES, '
        f'RgLayout<{ds}, {dc}, T>::LANE); }}' for ds, dc in RULE_SHAPES)
    prog = ("#include <cstdio>\n#define __host__\n#define __device__\n" + head + layout
            + "int main() {\n" + rows + "\n}\n")
    return prog


def test_rule_mirrors_the_source(tmp_path):
    """``general_shape(..., rule=True)`` and ``general_lane_bytes`` give
    the constants the source's primary RgShape and RgLayout compile to."""
    gxx = shutil.which("g++")
    assert gxx, "the host C++ compiler builds the source's rule"
    src = tmp_path / "rule.cpp"
    src.write_text(_source_rule())
    exe = tmp_path / "rule"
    subprocess.run([gxx, "-std=c++17", "-o", str(exe), str(src)], check=True,
                   capture_output=True, timeout=120)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    for line in out.strip().splitlines():
        ds, dc, tpl, p1r, p1c, p2r, p2c, pur, puc, p5r, p5c, ring, lanes, lane = map(
            int, line.split())
        sh = TK4.general_shape(ds, dc, rule=True)
        assert TK4.rule_threads(ds, dc) == tpl == sh["threads_per_lane"], (ds, dc)
        assert (sh["p1"], sh["p2"], sh["pu"], sh["p5"]) == (
            (p1r, p1c), (p2r, p2c), (pur, puc), (p5r, p5c)), (ds, dc)
        assert (sh["ring"], sh["max_lanes"]) == (ring, lanes), (ds, dc)
        assert TK4.general_lane_bytes(ds, dc, rule=True) == 4 * lane, (ds, dc)


@pytest.mark.parametrize("ds, dc", RULE_SHAPES)
def test_rule_tiles_cover_each_product_once(ds, dc):
    """Under the kernel's tile arithmetic every output of the recursion's
    products falls to one thread of the lane (as
    tests/test_torch_kernel_geometry.py checks the hand-set tilings):
    [Jx|Ju]'[V|v] on all threads; Qxx and Qux on all threads, or with two
    warps and dc > 1 on all but the last warp; Quu on the last warp, or
    counted down from the last thread; the next V on all threads."""
    sh = TK4.general_shape(ds, dc, rule=True)
    tpl, nj, nv = sh["threads_per_lane"], ds + dc, ds + 1
    split = tpl >= 64 and dc > 1
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

    assert nj % sh["p1"][0] == 0 and ds % sh["p2"][1] == 0 and dc % sh["p2"][0] == 0
    p1 = cover(sh["p1"], nj, nv, range(tpl), tpl, lambda c, j: j < nv)
    p2 = cover(sh["p2"], nj, ds, range(qt), qt)
    pu = cover(sh["pu"], dc, dc, range(32) if split else [tpl - 1 - lt for lt in range(tpl)],
               32 if split else tpl)
    p5 = cover(sh["p5"], ds, ds, range(tpl), tpl, lambda i, j: j < ds)
    for seen, n in ((p1, nj * nv), (p2, nj * ds), (pu, dc * dc), (p5, ds * ds)):
        assert len(seen) == n and set(seen.values()) == {1}
    assert ds + dc <= tpl and (tpl <= 32 and 32 % tpl == 0 or tpl % 32 == 0)


def test_every_shape_within_the_limits_fits_a_block():
    """At every (ds, dc) with ds + dc <= MAX_D the rule's largest block
    fits the shared memory of a block, and the geometry covers a batch
    with whole warps."""
    for ds in range(1, _build.MAX_D):
        for dc in range(1, _build.MAX_D - ds + 1):
            TK4.check_general_shape(ds, dc)
            sh = TK4.general_shape(ds, dc)
            assert sh["max_lanes"] * TK4.general_lane_bytes(ds, dc) <= _build.MAX_SMEM_BYTES
            for B in (1, 8, 1024, 16384):
                g = TK4.general_geometry(ds, dc, B)
                assert g["threads"] % 32 == 0 and g["lanes_per_block"] <= sh["max_lanes"]
                assert g["blocks"] * g["lanes_per_block"] >= B


@pytest.mark.parametrize("source, ds, dc, match", [
    ("riccati_general", 20, 5, "MAX_D = 24"),
    ("riccati_general", 0, 3, "MAX_D = 24"),
    ("ls_obj_wide", 2, 2, "dc = 1"),
    ("ls_obj_wide", 24, 1, "MAX_D = 24"),
    ("ls_reroll_wide", 3, 2, "dc = 1"),
    ("linesearch_fused", 2, 3, "dc = 1"),
])
def test_new_limits_raise_by_name(source, ds, dc, match):
    with pytest.raises(ValueError, match=f"{source}: .*{match}"):
        _build.check_shape(source, ds, dc)
    with pytest.raises(ValueError, match=match):
        _build.kernel_library(source, ds, dc)


def test_k4_refuses_a_block_past_the_shared_memory_by_name(monkeypatch):
    monkeypatch.setattr(_build, "MAX_SMEM_BYTES", 4096)
    TK4.general_geometry.cache_clear()
    try:
        with pytest.raises(ValueError, match=r"riccati_general: .*bytes of shared memory"):
            TK4.general_geometry(12, 1, 64)
    finally:
        TK4.general_geometry.cache_clear()


def test_every_shape_routes_to_a_library(monkeypatch):
    """Per-lane coefficients and K4, K8, K9 at a shape the main library
    lacks go to that shape's own library, built at first use; the main
    library's shapes stay there."""
    built = []
    monkeypatch.setattr(_build, "library", lambda: "main")
    monkeypatch.setattr(_build, "shape_library", lambda *a: built.append(a) or "shape")
    for source, ds, dc, want in (("riccati_general", 12, 1, "shape"),
                                 ("riccati_general", 4, 1, "main"),
                                 ("riccati_general", 1, 23, "shape"),
                                 ("ls_obj_wide", 2, 1, "shape"), ("ls_obj_wide", 4, 1, "main"),
                                 ("ls_reroll_wide", 23, 1, "shape"),
                                 ("sindy_linesearch", 18, 6, "shape")):
        assert _build.kernel_library(source, ds, dc) == want
    assert built == [("riccati_general", 12, 1), ("riccati_general", 1, 23),
                     ("ls_obj_wide", 2, 1), ("ls_reroll_wide", 23, 1),
                     ("sindy_linesearch", 18, 6)]


# ---- (b) the per-lane twins at (2, 1) -------------------------------------------------


def _lane_inputs(F, B=8, H=4, seed=0):
    rng = np.random.default_rng(seed + F)
    return dict(
        C=rng.normal(size=(B, 2, F)) * 0.1 + np.eye(2, F)[None],
        x0=rng.uniform(-1, 1, (B, 2)), xs=rng.uniform(-2, 2, (B, H + 1, 2)),
        us=rng.uniform(-2, 2, (B, H, 1)), Ks=rng.normal(size=(B, H, 1, 2)) * 0.3,
        ks=rng.normal(size=(B, H, 1)),
    )


def _plane(C):
    """JAX's per-lane (B, ds, F) -> the port's lanes-last (ds, F, B)."""
    return torch.as_tensor(np.ascontiguousarray(np.transpose(C, (1, 2, 0))))


def _libs():
    return JLib.from_config(3, **LIB21), TLib.from_config(3, **LIB21)


def test_per_lane_relin_twins_match_pallas_at_2x1():
    jl, tl = _libs()
    d = _lane_inputs(21)
    Jx, Ju = pallas_feature_jacobians(
        tuple(jl._fns), jnp.asarray(d["xs"]), jnp.asarray(d["us"]), jnp.asarray(d["C"]),
        grad_terms=tuple(jl.grad_terms), block_b=8, interpret=True)
    T = torch.as_tensor
    got = TK1.relin_jacobians_bm(tl.terms, T(d["xs"]), T(d["us"]), _plane(d["C"]))
    for g, r in zip(got, (Jx, Ju)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12)
    ll = TK1.relin_jacobians(tl.terms, T(d["xs"]).permute(1, 2, 0).contiguous(),
                             T(d["us"][:, :, 0].T.copy()), _plane(d["C"]))
    ll = ll.reshape(4, 2, 3, 8).permute(3, 0, 1, 2)
    assert torch.equal(ll[..., :2], got[0]) and torch.equal(ll[..., 2:], got[1])


def test_per_lane_sindy_line_search_twin_matches_pallas_at_2x1():
    jl, tl = _libs()
    d = _lane_inputs(21, seed=1)
    keys = ("x0", "xs", "us", "Ks", "ks")
    rx, ru = pallas_sindy_line_search(
        tuple(jl._fns), *(jnp.asarray(d[k]) for k in keys), jnp.asarray(d["C"]),
        jnp.asarray(ALPHAS_K), -2.0, 2.0, block_b=8, block_l=4, interpret=True)
    gx, gu = TK3.sindy_line_search(tl.terms, *(torch.as_tensor(d[k]) for k in keys),
                                   _plane(d["C"]), ALPHAS_K, -2.0, 2.0)
    np.testing.assert_allclose(gx.numpy(), np.asarray(rx), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(gu.numpy(), np.asarray(ru), rtol=1e-12, atol=1e-12)


def test_per_lane_fused_line_search_twin_matches_pallas_at_2x1():
    jl, tl = _libs()
    rng = np.random.default_rng(3)
    B, H = 8, 4
    obj0 = rng.uniform(2.0, 30.0, B)
    d = dict(x0=rng.uniform(-1, 1, (2, B)), xs=rng.uniform(-1, 1, (H + 1, 2, B)),
             us=rng.uniform(-2, 2, (H, B)), Ks=rng.normal(size=(H, 2, B)) * 0.3,
             ks=rng.normal(size=(H, B)), obj0=obj0, lin=-rng.uniform(0.1, 5.0, B) * obj0 / 10,
             quad=-rng.uniform(0.1, 5.0, B), ks_small=rng.uniform(size=B) < 0.15,
             act=rng.uniform(size=B) > 0.25, old_jac=rng.normal(size=(H, 6, B)),
             qd=10 ** rng.uniform(-1, 1.5, (2, B)), rd=10 ** rng.uniform(-3, 0, (1, B)),
             fd=10 ** rng.uniform(-1, 1.5, (2, B)),
             C=rng.normal(size=(B, 2, 21)) * 0.05 + np.eye(2, 21)[None])
    ref = pallas_fused_line_search(
        tuple(jl._fns), *(jnp.asarray(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")),
        jnp.asarray(np.transpose(d["C"], (1, 2, 0))), jnp.asarray(ALPHAS_K), -20.0, 20.0,
        *(jnp.asarray(d[k]) for k in ("qd", "rd", "fd")), jnp.zeros(2), 0.05,
        *(jnp.asarray(d[k]) for k in ("obj0", "lin", "quad", "ks_small")),
        grad_terms=tuple(jl.grad_terms), block_b=8, interpret=True, ll_io=True,
        per_lane_diag_cost=True, carry=(jnp.asarray(d["act"]), jnp.asarray(d["old_jac"])))
    T = torch.as_tensor
    got = TK3.fused_line_search(
        tl.terms, *(T(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")), _plane(d["C"]),
        ALPHAS_K, -20.0, 20.0, T(d["qd"]), T(d["rd"]), T(d["fd"]), (0.0, 0.0), 0.05,
        *(T(d[k]) for k in ("obj0", "lin", "quad", "ks_small", "act", "old_jac")))
    for name, g, r in zip(("xs", "us", "obj", "succ", "fail", "jac", "du2"), got, ref):
        if name in ("succ", "fail"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12,
                                       err_msg=name)
    assert got[3].numpy().any()


# ---- (c) K8 and K9 at (2, 1) ------------------------------------------------------------


@pytest.fixture(scope="module")
def pendulum():
    b, tb = PendulumSwingupBenchmark(), TPendulum()
    jtr = b.gen_trajs_batch(seed=42, n_trajs=20, traj_len=50)
    m = SINDy(b.system, **SURR)
    m.train(jtr)
    t = TSINDy(tb.system, device="cpu", **SURR)
    t.set_parameters({**m.get_parameters(), "feature_names": m.get_feature_names()})
    ttr = TTB(tb.system, torch.as_tensor(np.array(jtr.obs)), torch.as_tensor(np.array(jtr.ctrls)))
    active = tuple(int(k) for k in np.flatnonzero(np.any(np.asarray(m.coeffs) != 0, axis=0)))
    return dict(b=b, tb=tb, m=m, t=t, jtr=jtr, ttr=ttr, active=active)


def test_split_line_search_plain_matches_pallas_at_2x1(pendulum, monkeypatch):
    """K8 + acceptance + K9's plain versions against the TPU's split
    search at B = 1,024 (its smallest batch), H = 4, a fixed cost."""
    monkeypatch.setenv("AMPC_LS_WIDE_TA", "1")
    monkeypatch.setenv("AMPC_LS_WIDE_TB", "1")
    m, t, active = pendulum["m"], pendulum["t"], pendulum["active"]
    B, H = 1024, 4
    rng = np.random.default_rng(8)
    obj0 = rng.uniform(2.0, 30.0, B)
    d = dict(x0=rng.uniform(-1, 1, (2, B)), xs=rng.uniform(-1, 1, (H + 1, 2, B)),
             us=rng.uniform(-2, 2, (H, B)), Ks=rng.normal(size=(H, 2, B)) * 0.3,
             ks=rng.normal(size=(H, B)), obj0=obj0, lin=-rng.uniform(0.1, 5.0, B) * obj0 / 10,
             quad=-rng.uniform(0.1, 5.0, B), ks_small=rng.uniform(size=B) < 0.15,
             act=rng.uniform(size=B) > 0.25, old_jac=rng.normal(size=(H, 6, B)))
    Q, R = np.diag([10.0, 0.1]), 0.001 * np.eye(1)
    keys = ("x0", "xs", "us", "Ks", "ks")
    ref = pallas_fused_line_search_wide(
        tuple(m.library._fns[k] for k in active), *(jnp.asarray(d[k]) for k in keys),
        m.coeffs[:, jnp.asarray(active)], jnp.asarray(ALPHAS), jnp.array([-2.0]),
        jnp.array([2.0]), jnp.asarray(Q), jnp.asarray(R), jnp.asarray(Q), jnp.zeros(2), 0.05,
        *(jnp.asarray(d[k]) for k in ("obj0", "lin", "quad", "ks_small", "act")),
        jnp.asarray(d["old_jac"]), grad_terms=tuple(m.library.grad_terms[k] for k in active),
        interpret=True)
    T = torch.as_tensor
    got = TK3.fused_line_search_wide(
        tuple(t.library.terms[k] for k in active), *(T(d[k]) for k in keys),
        t.coeffs[:, list(active)], ALPHAS, -2.0, 2.0, (10.0, 0.1), (0.001,), (10.0, 0.1),
        (0.0, 0.0), 0.05, *(T(d[k]) for k in ("obj0", "lin", "quad", "ks_small", "act")),
        T(d["old_jac"]))
    for name, g, r in zip(("xs", "us", "obj", "succ", "fail", "jac", "du2"), got, ref):
        if name in ("succ", "fail"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12,
                                       err_msg=name)
    assert got[3].numpy().any() and (~got[3].numpy()).any()


# ---- (d) the pendulum's joint fan-outs and tunes ---------------------------------------

H_FAN, STEPS_FAN = 5, 3
MAXW, NB, EPOCHS, SEED = 16, 32, 2, 100


def _tasks(s, cost=True):
    out = []
    for bench, quad in ((s["b"], JQuad), (s["tb"], TQuad)):
        task = bench.task.copy()
        task.set_init_obs(np.array(RECOVERY_INIT))
        task.set_num_steps(STEPS_FAN + 1)
        if cost:
            task.set_cost(quad(bench.system, np.eye(2), 0.01 * np.eye(1), np.eye(2),
                               goal=np.zeros(2)))
        out.append(task)
    return out


def test_pendulum_joint_sindy_fanout_matches_jax(pendulum):
    s = pendulum
    jtask, ttask = _tasks(s)
    rng = np.random.default_rng(2)
    batch = {"reg": 10.0 ** rng.uniform(-4, -1, 6), "Qdiag": rng.uniform(0.01, 10, (6, 2)),
             "Rdiag": rng.uniform(1e-3, 1, (6, 1)), "Fdiag": rng.uniform(0.01, 10, (6, 2))}
    cfg = dict(LIB21, method="lstsq", time_mode="discrete")
    jfan = JJointSINDy(s["b"].system, jtask, cfg, s["jtr"].to_list(), s["m"], horizon=H_FAN,
                       n_steps=STEPS_FAN, backward="scan", use_feature_kernels=False)
    ref = np.asarray(jfan({k: jnp.asarray(v) for k, v in batch.items()}))
    for kw in (dict(backward="pallas", use_feature_kernels=True),
               dict(backward="pallas", use_feature_kernels=True, fuse_ls=True,
                    lanes_last=True)):
        fan = TJointSINDy(s["tb"].system, ttask, cfg, s["ttr"], s["t"], horizon=H_FAN,
                          n_steps=STEPS_FAN, device="cpu", **kw)
        assert fan.solver_kw["ds"] == 2 and fan.n_features == 21
        np.testing.assert_allclose(fan(batch).numpy(), ref, rtol=1e-8)
    assert np.isfinite(ref).all() and len(set(np.round(ref, 6))) > 1


def _jax_mlp_draws(seed, nxu, nx, widths, max_width, dtype, device):
    """The port's padded initial net with JAX's key schedule (the fan-out's
    ``_, k_init = split(PRNGKey(seed))``)."""
    _, k_init = jax.random.split(jax.random.PRNGKey(int(seed)))
    return [{k: torch.as_tensor(np.array(v), dtype=dtype, device=device) for k, v in la.items()}
            for la in j_padded_init(k_init, nxu, nx, widths, max_width)]


def _jax_epoch_perms(n, n_batch, n_epochs, seed, device):
    key, _ = jax.random.split(jax.random.PRNGKey(int(seed)))
    n_used = max(n // n_batch, 1) * n_batch
    out = []
    for _ in range(n_epochs):
        key, kp = jax.random.split(key)
        out.append(torch.as_tensor(np.array(jax.random.permutation(kp, n)[:n_used]),
                                   device=device))
    return out


@pytest.fixture
def jax_mlp_draws(monkeypatch):
    monkeypatch.setattr(tbk, "_mlp_padded_init", _jax_mlp_draws)
    monkeypatch.setattr(tfanout, "epoch_perms", _jax_epoch_perms)


def test_pendulum_joint_mlp_fanout_matches_jax(pendulum, jax_mlp_draws):
    """The horizon-masked joint-MLP fan-out on the pendulum (K4 at (2, 1)
    on the masked per-lane expansions, through its plain version)."""
    s = pendulum
    jtask, ttask = _tasks(s)
    batch = dict(widths=((8, 16), (16, 4), (12, 12)), lr=np.array([1e-2, 3e-3, 3e-2]),
                 Qdiag=np.array([[1.0, 0.1], [5.0, 0.5], [2.0, 1.0]]),
                 Rdiag=np.array([[0.01], [0.05], [0.002]]),
                 Fdiag=np.array([[1.0, 0.1], [5.0, 0.5], [2.0, 1.0]]),
                 horizons=np.array([4, 6, 5]))
    common = dict(horizon=6, max_width=MAXW, n_train_iters=EPOCHS, n_batch=NB, seed=SEED,
                  horizon_mask=True, n_steps=STEPS_FAN)
    bucket = dict(n_hidden_layers=2, nonlintype="tanh")
    ref = np.asarray(JJointMLP(s["b"].system, jtask, bucket, s["jtr"].to_list(), s["m"],
                               **common)(batch))
    fan = TJointMLP(s["tb"].system, ttask, bucket, s["ttr"], s["t"], device="cpu",
                    backward="pallas", **common)
    assert fan.solver_kw["ds"] == 2 and fan.solver_kw["horizon_mask"]
    got = fan(batch).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-8)
    assert np.isfinite(ref).all() and len(set(np.round(ref, 6))) > 1


def _tune(s, kind, port):
    jtask, ttask = _tasks(s)
    system = (s["tb"] if port else s["b"]).system
    if kind == "joint_sindy":
        pin = dict(poly_basis="false", trig_basis="true", trig_freq=1, trig_interaction="true")
        model = (TSINDyFactory(system, device="cpu", **pin) if port
                 else SINDyFactory(system, **pin))
    else:
        pin = dict(n_hidden_layers="1", nonlintype="tanh", n_train_iters=EPOCHS, n_batch=NB)
        model = TMLPFactory(system, device="cpu", **pin) if port else MLPFactory(system, **pin)
    if port:
        pipe = TPipeline(system, model, TQuadFactory(system, goal=np.zeros(2)),
                         TILQRFactory(system, horizon=4))
        tuner = TTuner(surrogate_mode="pretrain", eval_batch=3, use_fanout=True,
                       fanout_backward="pallas", fanout_feature_kernels=True)
        return tuner.run(pipe, ttask, s["ttr"].to_list(), n_iters=3,
                         rng=np.random.default_rng(7), surrogate=s["t"])[1]
    pipe = Pipeline(system, model, QuadCostFactory(system, goal=np.zeros(2)),
                    IterativeLQRFactory(system, horizon=4))
    tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=3, use_fanout=True,
                          fanout_backward="scan", fanout_feature_kernels=False)
    return tuner.run(pipe, jtask, s["jtr"].to_list(), n_iters=3,
                     rng=np.random.default_rng(7), surrogate=s["m"])[1]


@pytest.mark.parametrize("kind", ["joint_sindy", "joint_mlp"])
def test_pendulum_joint_tune_matches_jax(pendulum, jax_mlp_draws, kind):
    """One round of the tuner's kind on the pendulum's recovery task:
    the same configurations, costs to 1e-6."""
    ref, got = _tune(pendulum, kind, port=False), _tune(pendulum, kind, port=True)
    assert [c.get_dictionary() for c in got.cfgs] == [c.get_dictionary() for c in ref.cfgs]
    np.testing.assert_allclose(got.costs, ref.costs, rtol=1e-6)
    assert np.isfinite(ref.costs).all()


# ---- (e) the recovery task -------------------------------------------------------------


def test_recovery_task_discriminates_and_matches_jax(pendulum):
    """From starts about upright the torque bound brings some lanes into
    the task's 0.2 box and not others, in the port's receding loop and
    JAX's alike (states and controls to 1e-8)."""
    s = pendulum
    tb = s["tb"]
    task = tb.recovery_task(num_steps=40)
    assert np.allclose(task.get_init_obs(), RECOVERY_INIT) and task.get_num_steps() == 40
    assert np.allclose(tb.task.get_init_obs(), (np.pi, 0.0))       # the original untouched
    bounds = s["b"].task.get_ctrl_bounds()
    common = dict(H=20, ds=2, dc=1, obsdim=2, dt=s["b"].system.dt, n_steps=40,
                  ubounds=(bounds[:, 0], bounds[:, 1]))
    Q = np.diag([10.0, 0.1])
    jrun = jax.jit(j_loop(s["m"].pred_core, JQuad(s["b"].system, jnp.asarray(Q),
                                                  0.001 * jnp.eye(1), jnp.asarray(Q),
                                                  goal=jnp.zeros(2)),
                          s["b"].dynamics, **common))
    trun = t_loop(s["t"].pred_core, TQuad(tb.system, Q, 0.001 * np.eye(1), Q, goal=np.zeros(2)),
                  tb.dynamics, feature_spec=(s["t"].library, "coeffs"),
                  feature_mask=s["active"], **common)
    x0 = np.array([[0.05, 0.0], [RECOVERY_SPREAD, RECOVERY_SPREAD],
                   [-RECOVERY_SPREAD, 0.1], list(RECOVERY_INIT)])
    xs_j, us_j, _ = jrun(s["m"].params, jnp.asarray(x0))
    xs_t, us_t, _ = trun(s["t"].params, torch.as_tensor(x0))
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=1e-8, atol=1e-8)
    fx = xs_t[:, -1]
    box = ((fx[:, 0].abs() < 0.2) & (fx[:, 1].abs() < 0.2)).numpy()
    assert box.any() and not box.all(), box
