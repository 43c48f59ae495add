"""Koopman lifts past ds + dc = 24 through K6 and K4 (the wide instance
of ``csrc/riccati_big.cuh``), against the JAX package, float64 on the
CPU (a CPU tensor takes the kernels' plain versions):

- ``JointKoopmanLassoQuadCostFanout`` at trig frequency 3 (N = 28 lifted
  states on the cartpole) with ``backward="pallas"`` (K6's plain version,
  and with the GaussReg term K4's) against the JAX fan-out with
  ``backward="scan"``, at 1e-8, with and without ``reg_matrix``;
- ``PipelineTuner(fanout_backward="pallas")`` with Koopman's trig
  frequency pinned to 3 against the JAX tune (1e-6), no candidate
  refused;
- the float32 Lasso fits of the lifted transitions (the card's dtype) on
  the smoke's data (50 x 100 trajectories, seed 42) at 28, 56, 72 and 96
  states against the JAX package's float32 ``fista_lasso``: the same
  lanes finite (none at polynomial degree 8, 56 and 96 states, in either
  package), the finite ones within 1e-3; the JAX fan-out and the port's
  score every such NaN model ``inf``;
- the wide instance's geometry at N = 24, 28, 48 and 96 (shared memory
  within 227 KB), every lift of the cartpole's and the pendulum's Koopman
  spaces taken by K6 and K4, ``NotPortedError`` by name past the wide
  instance's width, and the feature kernels' own limit (ds + dc <= 24)
  unchanged.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch import NotPortedError
from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.control import IterativeLQRFactory as TILQRFactory
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.costs import QuadCostFactory as TQuadFactory
from autompc_torch.ops import _build
from autompc_torch.ops import cuda_riccati as K6
from autompc_torch.ops import cuda_riccati_general as K4
from autompc_torch.parallel import JointKoopmanLassoQuadCostFanout as TJoint
from autompc_torch.pipeline import Pipeline as TPipeline
from autompc_torch.sysid import KoopmanFactory as TKF
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.tuning import PipelineTuner as TTuner
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.control import IterativeLQRFactory
from autompc_tpu.core.trajectory import TrajectoryBatch as JTB
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.costs import QuadCostFactory
from autompc_tpu.parallel.fanout import JointKoopmanLassoQuadCostFanout as JJoint
from autompc_tpu.pipeline import Pipeline
from autompc_tpu.sysid import KoopmanFactory, SINDy
from autompc_tpu.tuning import PipelineTuner

torch.set_num_threads(1)

SURR = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
            trig_interaction=True)
# Trig frequency 3: 4 (1 + 2 * 3) = 28 lifted states, past the per-shape
# kernels' ds + 1 <= 24.
BASIS = dict(trig_basis=True, trig_freq=3)
N_LIFT = 28
H_FAN, STEPS_FAN, B_FAN = 5, 3, 8
INIT = np.array([0.5, 0.0, 0.0, 0.0])


@pytest.fixture(scope="module")
def setup():
    """Both benchmarks, one sysid data set, one surrogate and a
    near-upright task with a quadratic task cost in each package."""
    b, tb = JBench(), TBench()
    ttr = tb.gen_trajs_batch(seed=42, n_trajs=20, traj_len=30, device="cpu")
    jtr = JTB(b.system, ttr.obs.numpy(), ttr.ctrls.numpy(), ttr.lengths.numpy())
    tsurr = TSINDy(tb.system, device="cpu", **SURR)
    tsurr.train(ttr)
    surr = SINDy(b.system, **SURR)
    surr.set_parameters({"coeffs": tsurr.coeffs.numpy()})
    task, ttask = b.task.copy(), tb.task.copy()
    for tk in (task, ttask):
        tk.set_num_steps(STEPS_FAN + 1)
        tk.set_init_obs(INIT)
    task.set_cost(JQuad(b.system, jnp.eye(4), 0.01 * jnp.eye(1), jnp.eye(4), goal=jnp.zeros(4)))
    ttask.set_cost(TQuad(tb.system, np.eye(4), 0.01 * np.eye(1), np.eye(4), goal=np.zeros(4)))
    rng = np.random.default_rng(3)
    batch = {"reg": 10.0 ** rng.uniform(-6, 0, B_FAN),
             "Qdiag": 10 ** rng.uniform(-1, 1.5, (B_FAN, 4)),
             "Fdiag": 10 ** rng.uniform(-1, 1.5, (B_FAN, 4)),
             "Rdiag": 10 ** rng.uniform(-3, 0, (B_FAN, 1)),
             "regw": 10 ** rng.uniform(-3, 1, B_FAN)}
    S = np.diag([2.0, 0.5, 1.0, 0.25])
    mu = np.array([0.1, 0.0, -0.05, 0.0])
    return dict(b=b, tb=tb, jtr=jtr, ttr=ttr, surr=surr, tsurr=tsurr, task=task, ttask=ttask,
                batch=batch, S=S, mu=mu)


def _reg(s, reg):
    return dict(reg_matrix=s["S"], reg_goal=s["mu"]) if reg else {}


@pytest.mark.parametrize("reg", [False, True])
def test_lifted_fanout_through_the_wide_kernels_matches_jax(setup, reg, monkeypatch):
    """At N = 28 the port's backward="pallas" (K6's plain version; with
    the GaussReg term K4's) against JAX's backward="scan": the costs at
    1e-8, and the kernels' wrappers reached at the lift."""
    s = setup
    batch = {k: v for k, v in s["batch"].items() if reg or k != "regw"}
    jfan = JJoint(s["b"].system, s["task"], BASIS, s["jtr"].to_list(), s["surr"],
                  horizon=H_FAN, n_steps=STEPS_FAN, backward="scan", **_reg(s, reg))
    ref = np.asarray(jfan({k: jnp.asarray(v) for k, v in batch.items()}))
    from autompc_torch.control import ilqr as tilqr

    seen = []
    name = "riccati_general" if reg else "backward_quad"
    real = getattr(tilqr, name)
    monkeypatch.setattr(tilqr, name, lambda *a, **k: (seen.append(a[0].shape[2]), real(*a, **k))[1])
    fan = TJoint(s["tb"].system, s["ttask"], BASIS, s["ttr"], s["tsurr"], horizon=H_FAN,
                 n_steps=STEPS_FAN, backward="pallas", device="cpu", **_reg(s, reg))
    assert fan.state_dim == N_LIFT and N_LIFT + 1 > _build.MAX_D
    got = fan(batch).numpy()
    assert seen and set(seen) == {N_LIFT}
    assert got.shape == (B_FAN,) and np.all(np.isfinite(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-8)
    assert len(set(np.round(ref, 6))) > 1      # the candidates discriminate


KOOP_PIN = dict(poly_basis="false", trig_basis="true", trig_freq=3)


def _tune(s, port, n_iters=6):
    if port:
        system = s["tb"].system
        pipe = TPipeline(system, TKF(system, device="cpu", **KOOP_PIN),
                         TQuadFactory(system, goal=np.zeros(4)), TILQRFactory(system, horizon=4))
        tuner = TTuner(surrogate_mode="pretrain", eval_batch=n_iters, use_fanout=True,
                       fanout_backward="pallas")
        assert tuner._fanout_kind(pipe, s["tsurr"]) == ("joint_koopman", "")
        return tuner.run(pipe, s["ttask"], s["ttr"].to_list(), n_iters=n_iters,
                         rng=np.random.default_rng(7), surrogate=s["tsurr"])[1]
    system = s["b"].system
    pipe = Pipeline(system, KoopmanFactory(system, **KOOP_PIN),
                    QuadCostFactory(system, goal=np.zeros(4)),
                    IterativeLQRFactory(system, horizon=4))
    tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=n_iters, use_fanout=True,
                          fanout_backward="scan")
    return tuner.run(pipe, s["task"], s["jtr"].to_list(), n_iters=n_iters,
                     rng=np.random.default_rng(7), surrogate=s["surr"])[1]


def test_lifted_tune_with_the_pallas_backward_matches_jax(setup):
    """A "joint_koopman" tune over lifts of 28 states with
    fanout_backward="pallas": the same configurations, costs within 1e-6
    of JAX's and the same incumbent; every candidate scored finite."""
    res, ref = _tune(setup, port=True), _tune(setup, port=False)
    assert [c.get_dictionary() for c in res.cfgs] == [c.get_dictionary() for c in ref.cfgs]
    assert np.all(np.isfinite(ref.costs)) and np.all(np.isfinite(res.costs))
    np.testing.assert_allclose(res.costs, ref.costs, rtol=1e-6)
    assert res.inc_cfg.get_dictionary() == ref.inc_cfg.get_dictionary()


# ---- float32 Lasso fits at each lift against the JAX package's ----------------------

# chip_smoke.py's LIFTS_21: trig 3; polynomial degree 8 with trig 3; degree
# 2 with trig 8; degree 8 with trig 8.
LIFTS_F32 = {28: dict(trig_basis=True, trig_freq=3),
             56: dict(poly_basis=True, poly_degree=8, trig_basis=True, trig_freq=3),
             72: dict(poly_basis=True, poly_degree=2, trig_basis=True, trig_freq=8),
             96: dict(poly_basis=True, poly_degree=8, trig_basis=True, trig_freq=8)}
ALPHAS_F32 = (10.0 ** np.random.default_rng(21).uniform(-6, 0, 8)).astype(np.float32)


@pytest.fixture(scope="module")
def smoke_data():
    """The smoke's cartpole data (50 x 100 trajectories, seed 42) in both
    packages, float32 as on the card."""
    b, tb = JBench(), TBench()
    ttr = tb.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100, device="cpu")
    f32 = np.float32
    jtr = JTB(b.system, ttr.obs.numpy().astype(f32), ttr.ctrls.numpy().astype(f32),
              ttr.lengths.numpy())
    return dict(b=b, tb=tb, ttr=ttr, jtr=jtr)


def _jax_lifted_f32(d, basis):
    import jax

    from autompc_tpu.sysid.koopman import Koopman as JK

    lift = JK(d["b"].system, method="lasso", lasso_alpha=1.0, **basis)._apply_basis
    jtr = d["jtr"]
    lifted = np.asarray(jax.vmap(jax.vmap(lift))(jnp.asarray(jtr.obs)))
    ib, it = np.nonzero(np.asarray(jtr.step_mask()))
    XU = np.concatenate([lifted[ib, it], np.asarray(jtr.ctrls)[ib, it]], axis=1)
    return XU, lifted[ib, it + 1]


@pytest.mark.parametrize("N", sorted(LIFTS_F32))
def test_float32_lasso_fits_follow_jax(smoke_data, N):
    """The joint-Koopman fan-out's per-lane fits in float32: the port's
    ``fista_lasso`` and the JAX package's on the same lifted data give
    NaN on the same lanes (every lane at polynomial degree 8, whose
    lifted values reach ~4e12, none at 28 and 72 states), the finite
    ones within 1e-3 of each other (normwise a lane)."""
    from autompc_torch.ops.lstsq import fista_lasso as tfista
    from autompc_torch.sysid import Koopman as TK
    from autompc_tpu.ops.lstsq import fista_lasso as jfista

    import jax

    basis = LIFTS_F32[N]
    tk = TK(smoke_data["tb"].system, method="lasso", lasso_alpha=1.0, device="cpu", **basis)
    assert tk.state_dim == N
    X, Y, U = tk.lifted_transitions(smoke_data["ttr"])
    got = tfista(torch.cat([X, U], 1).float(), Y.float(),
                 torch.as_tensor(ALPHAS_F32)).double().numpy()
    XU, Yj = _jax_lifted_f32(smoke_data, basis)
    assert XU.dtype == np.float32
    ref = np.asarray(jax.vmap(lambda a: jfista(jnp.asarray(XU), jnp.asarray(Yj), a))(
        jnp.asarray(ALPHAS_F32)))
    assert ref.dtype == np.float32
    fin_t = np.isfinite(got).reshape(len(ALPHAS_F32), -1).all(1)
    fin_j = np.isfinite(ref).reshape(len(ALPHAS_F32), -1).all(1)
    np.testing.assert_array_equal(fin_t, fin_j)
    assert fin_j.all() if N in (28, 72) else not fin_j.any()
    if fin_j.any():
        r = ref.astype(np.float64)
        err = np.abs(got - r).max(axis=(1, 2)) / np.abs(r).max(axis=(1, 2))
        assert err.max() < 1e-3


def test_float32_nan_models_score_inf_in_both_fanouts(smoke_data):
    """At 56 lifted states the JAX fan-out on float32 data (its lanes'
    fits NaN) scores every candidate inf under a quadratic task cost, and
    so does the port's fan-out given its float32 fits."""
    s = smoke_data
    basis, B = LIFTS_F32[56], 8
    rng = np.random.default_rng(3)
    batch = {"reg": ALPHAS_F32[:B],
             "Qdiag": (10 ** rng.uniform(-1, 1.5, (B, 4))).astype(np.float32),
             "Rdiag": (10 ** rng.uniform(-3, 0, (B, 1))).astype(np.float32),
             "Fdiag": (10 ** rng.uniform(-1, 1.5, (B, 4))).astype(np.float32)}
    surr = SINDy(s["b"].system, **SURR)
    tsurr = TSINDy(s["tb"].system, device="cpu", **SURR)
    tsurr.train(s["ttr"])
    surr.set_parameters({"coeffs": tsurr.coeffs.numpy()})
    task, ttask = s["b"].task.copy(), s["tb"].task.copy()
    for tk in (task, ttask):
        tk.set_num_steps(2)
    task.set_cost(JQuad(s["b"].system, jnp.eye(4), 0.01 * jnp.eye(1), jnp.eye(4),
                        goal=jnp.zeros(4)))
    ttask.set_cost(TQuad(s["tb"].system, np.eye(4), 0.01 * np.eye(1), np.eye(4),
                         goal=np.zeros(4)))
    jfan = JJoint(s["b"].system, task, basis, s["jtr"], surr, horizon=5, n_steps=1)
    ref = np.asarray(jfan({k: jnp.asarray(v) for k, v in batch.items()}))
    assert np.all(np.isinf(ref))
    fan = TJoint(s["tb"].system, ttask, basis, s["ttr"], tsurr, horizon=5, n_steps=1,
                 backward="pallas", device="cpu")
    fan._XU, fan._Y = fan._XU.float(), fan._Y.float()
    params = fan.train_lanes(torch.as_tensor(batch["reg"]))
    assert not torch.isfinite(params["A"]).any()
    costs = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in batch.items() if k != "reg"}
    got = fan.closed_loop({k: v.double() for k, v in params.items()}, costs).numpy()
    assert np.all(np.isinf(got))


# ---- the wide instance's geometry and limits ---------------------------------------


@pytest.mark.parametrize("N", [24, 28, 48, 96])
def test_wide_geometry_fits_a_block(N):
    """K6 and K4 at (N, 1): one lane a block of RB_G threads a row, the N
    rows rounded up to a warp, B blocks, the block's shared memory within
    227 KB."""
    rows = -(-N // 32) * 32
    for B in (1, 128, 1024):
        g = K6.bq_bm_geometry(B, 10, ds=N)
        assert g["big"] and g["lanes_per_block"] == 1 and g["blocks"] == B
        assert g["threads"] == _build.RB_G * rows <= _build.RB_MAX_THREADS
        assert g["smem"] == _build.big_smem(N, False) <= _build.MAX_SMEM_BYTES
        g = K4.general_geometry(N, 1, B)
        assert g["big"] and g["lanes_per_block"] == 1 and g["blocks"] == B
        assert g["threads"] == _build.RB_G * rows
        assert g["smem"] == _build.big_smem(N, True) <= _build.MAX_SMEM_BYTES
    # The per-shape instances keep their shapes and geometry below the limit.
    assert not K6.bq_bm_geometry(64, 10, ds=23)["big"]
    assert not K4.general_geometry(23, 1, 64)["big"]


def _lift(obs, poly, degree, trig, freq):
    return obs * (1 + (degree - 1) * poly + 2 * freq * trig)


def test_every_cartpole_and_pendulum_lift_is_taken():
    """No lift of the Koopman space (poly_degree 2..8, trig_freq 1..8,
    each basis on or off) on the cartpole (4 observations) or the
    pendulum (2) is refused by K6 or K4 (with the GaussReg term, dc = 1);
    the largest is 96."""
    lifts = {_lift(obs, p, d, t, f) for obs in (4, 2)
             for p, t in itertools.product((0, 1), repeat=2)
             for d in range(2, 9) for f in range(1, 9)}
    assert max(lifts) == 96 and min(lifts) == 2
    for N in sorted(lifts):
        K6.bq_bm_geometry(1024, 10, ds=N)
        K4.general_geometry(N, 1, 1024)
    assert _build.BQBM_BIG_MAX_DS >= 96 and _build.RG_BIG_MAX_DS >= 96


def test_past_the_wide_instance_raises_not_ported_by_name():
    """Past the wide instance's width, and K4 at dc > 1 past ds + dc = 24
    (the halfcheetah's lifts, up to (432, 6)), the refusal is
    NotPortedError by name, raised before any build or launch."""
    with pytest.raises(NotPortedError, match=r"riccati_quad_bm: .*not ported"):
        K6.bq_bm_geometry(64, 10, ds=_build.BQBM_BIG_MAX_DS + 1)
    with pytest.raises(NotPortedError, match=r"riccati_general: .*not ported"):
        K4.general_geometry(_build.RG_BIG_MAX_DS + 1, 1, 64)
    for ds, dc in ((432, 6), (36, 6), (20, 5)):
        with pytest.raises(NotPortedError, match=r"riccati_general: .*\(ds, dc\) = "):
            K4.check_general_shape(ds, dc)


@pytest.mark.parametrize("source, ds, dc", [
    ("relin", 24, 1), ("sindy_linesearch", 20, 5), ("linesearch_fused", 24, 1),
    ("riccati_quad_bm", 24, 1), ("linesearch_fused_mc", 19, 6),
])
def test_feature_kernels_keep_their_limit(source, ds, dc):
    """The per-shape libraries (the feature kernels' term tables are sized
    by AMPC_MAX_D) still refuse ds + dc > 24 by name; the wide Riccati
    instance lives in the main library and needs no shape library."""
    with pytest.raises(ValueError, match="MAX_D = 24"):
        _build.kernel_library(source, ds, dc)


def test_wide_layout_mirrors_the_source(tmp_path):
    """``_build.big_smem``, ``big_threads``, ``RB_RING``, ``RB_G`` and
    ``RB_MAX_THREADS`` are the constants riccati_big.cuh compiles to (its
    constexpr layout, built with the host compiler)."""
    import re
    import shutil
    import subprocess

    src = (_build.CSRC_DIR / "riccati_big.cuh").read_text()
    defs = dict(re.findall(r"#define (RB_\w+) (\d+)", src))
    assert int(defs["RB_RING"]) == _build.RB_RING
    assert int(defs["RB_MAX_THREADS"]) == _build.RB_MAX_THREADS
    assert int(defs["RB_G"]) == _build.RB_G
    head = src[src.index("#define RB_RING"):src.index("// The inputs of one lane's pass.")]
    sizes = (24, 28, 48, 56, 96, 97, 119)
    rows = "\n".join(f'  printf("{n} %d %d %d\\n", 4 * rb_floats({n}, false), '
                     f'4 * rb_floats({n}, true), rb_threads({n}));' for n in sizes)
    prog = ("#include <cstdio>\n#define __host__\n#define __device__\n" + head
            + "int main() {\n" + rows + "\n}\n")
    gxx = shutil.which("g++")
    assert gxx, "the host C++ compiler builds the source's layout"
    (tmp_path / "rb.cpp").write_text(prog)
    exe = tmp_path / "rb"
    subprocess.run([gxx, "-std=c++17", "-o", str(exe), str(tmp_path / "rb.cpp")], check=True,
                   capture_output=True, timeout=120)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    for line in out.strip().splitlines():
        n, quad, dense, threads = map(int, line.split())
        assert (quad, dense) == (_build.big_smem(n, False), _build.big_smem(n, True)), n
        assert threads == _build.big_threads(n) <= _build.RB_MAX_THREADS, n
    assert _build.big_smem(_build.BQBM_BIG_MAX_DS + 1, False) > _build.MAX_SMEM_BYTES
    assert _build.big_smem(_build.RG_BIG_MAX_DS + 1, True) > _build.MAX_SMEM_BYTES


def test_wide_plain_version_is_the_elementwise_recursion(monkeypatch):
    """K6's plain version past ds + 1 = 24 (batched matrices, the wide
    instance's) gives the elementwise recursion of the per-shape
    instances (taken by raising MAX_D for the call) at N = 26, float64,
    to 1e-12."""
    rng = np.random.default_rng(9)
    B, H, N, o = 3, 4, 26, 4
    T = torch.as_tensor
    args = (T(np.eye(N) * 0.97 + rng.normal(0, 0.03, (B, H, N, N))),
            T(rng.normal(0, 0.1, (B, H, N, 1))), T(rng.normal(0, 1, (B, H + 1, N))),
            T(rng.normal(0, 1, (B, H, 1))), T(10 ** rng.uniform(-1, 1, (B, o))),
            T(10 ** rng.uniform(-3, 0, (B, 1))), T(10 ** rng.uniform(-1, 1, (B, o))),
            tuple(rng.normal(0, 0.1, o)), 0.05, o)
    wide = K6.backward_quad_plain(*args)
    monkeypatch.setattr(_build, "MAX_D", 64)
    elementwise = K6.backward_quad_plain(*args)
    for a, b in zip(wide, elementwise):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)
