"""The main path's wide options in the port's scheduled lanes-last iLQR
solver against the JAX solver with the same options, float64, B=1024
(the smallest batch the wide kernels take), H=10, at most 5 iterations:
``ls_wide=True`` (the split line search), ``jac_dtype="bf16"`` (the
bfloat16 Jacobian carry) and ``AMPC_BQ_WIDE_IO=reshape`` (the reshape-IO
backward). The schedule halves the batch after three iterations, so the
second stage (512 lanes) takes the fused kernels in both packages.
Converged flags equal, xs/us/Ks/ks to 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.control import ilqr as tilqr
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.sysid import SINDy as TSINDy
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.control import ilqr as jilqr
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.sysid import SINDy

torch.set_num_threads(1)

QD = np.diag([10.0, 0.1, 0.01, 0.01])
B, H = 1024, 10


@pytest.fixture(scope="module")
def setup():
    b = CartpoleSwingupBenchmark()
    kw = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
              trig_interaction=True)
    m = SINDy(b.system, **kw)
    m.train(b.gen_trajs_batch(seed=42, n_trajs=60, traj_len=80))
    t = TSINDy(b.system, device="cpu", **kw)
    t.set_parameters({**m.get_parameters(), "feature_names": m.get_feature_names()})
    jcost = JQuad(b.system, jnp.asarray(QD), 0.001 * jnp.eye(1), jnp.asarray(QD),
                  goal=jnp.zeros(4))
    tcost = TQuad(b.system, QD, 0.001 * np.eye(1), QD, goal=np.zeros(4))
    bounds = b.task.get_ctrl_bounds()
    active = tuple(int(k) for k in np.flatnonzero(np.any(np.asarray(m.coeffs) != 0, axis=0)))
    common = dict(H=H, ds=4, dc=1, obsdim=4, dt=b.system.dt,
                  ubounds=(bounds[:, 0], bounds[:, 1]), max_iter=5,
                  backward="pallas", fuse_ls=True, lanes_last=True,
                  feature_mask=active, schedule=((3, 0.5),))
    x0 = np.random.default_rng(8).uniform(-1, 1, (B, 4)) * np.array([3.1, 1.0, 1.0, 1.0])
    return m, t, jcost, tcost, common, x0


@pytest.fixture
def one_step_tiles(monkeypatch):
    """The JAX wide kernels unroll T time steps per grid cell; T = 1 (a
    tile knob that does not change the math) keeps their interpret-mode
    compile to seconds."""
    for knob in ("AMPC_LS_WIDE_TA", "AMPC_LS_WIDE_TB", "AMPC_BQ_WIDE_T"):
        monkeypatch.setenv(knob, "1")
    return monkeypatch


@pytest.mark.parametrize("variant", ["llw", "llb", "ll"])
def test_wide_options_match_jax(setup, one_step_tiles, variant):
    m, t, jcost, tcost, common, x0 = setup
    kw = {"llw": dict(ls_wide=True), "llb": dict(jac_dtype="bf16"), "ll": {}}[variant]
    if variant == "ll":
        one_step_tiles.setenv("AMPC_BQ_WIDE_IO", "reshape")
    jsolve = jax.jit(jilqr.make_scheduled_ilqr_solver(
        m.pred_core, jcost, feature_spec=(m.library, "coeffs"), pallas_interpret=True,
        **common, **kw))
    tsolve = tilqr.make_scheduled_ilqr_solver(
        t.pred_core, tcost, feature_spec=(t.library, "coeffs"), **common, **kw)
    out_j = jsolve(m.params, jnp.asarray(x0), jnp.zeros((B, H, 1)))
    out_t = tsolve(t.params, torch.as_tensor(x0), torch.zeros((B, H, 1), dtype=torch.float64))
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    for i, name in zip((1, 2, 3, 4), ("xs", "us", "Ks", "ks")):
        np.testing.assert_allclose(out_t[i].numpy(), np.asarray(out_j[i]),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    assert 0.2 < float(out_t[0].double().mean()) < 1.0


def test_split_search_runs_at_wide_stages_only(setup, monkeypatch):
    """``ls_wide`` decides per call: the 1024-lane stage takes the split
    search, the 512-lane stage the fused one (counted through the plain
    versions, which the CPU runs)."""
    _, t, _, tcost, common, x0 = setup
    calls = {"wide": [], "fused": []}
    for name, key in (("fused_line_search_wide", "wide"), ("fused_line_search", "fused")):
        fn = getattr(tilqr, name)
        monkeypatch.setattr(tilqr, name, lambda *a, _f=fn, _k=key, **k: (
            calls[_k].append(a[1].shape[1]), _f(*a, **k))[1])
    solve = tilqr.make_scheduled_ilqr_solver(
        t.pred_core, tcost, feature_spec=(t.library, "coeffs"), ls_wide=True,
        **dict(common, max_iter=4))
    solve(t.params, torch.as_tensor(x0), torch.zeros((B, H, 1), dtype=torch.float64))
    assert calls["wide"] == [B] * 3 and calls["fused"] == [B // 2]


def test_bf16_carry_is_bfloat16_through_the_solve(setup):
    _, t, _, tcost, common, x0 = setup
    kw = dict(common)
    kw.pop("schedule")
    _, make_carry0, _, make_body = tilqr.make_batched_ilqr_solver(
        t.pred_core, tcost, feature_spec=(t.library, "coeffs"), jac_dtype="bf16",
        return_pieces=True, **kw)
    c = make_carry0(t.params, torch.as_tensor(x0[:64]),
                    torch.zeros((64, H, 1), dtype=torch.float64))
    assert c["jac"].dtype == torch.bfloat16 and c["xs"].dtype == torch.float64
    c = make_body(t.params)(c)
    assert c["jac"].dtype == torch.bfloat16 and c["Ks"].dtype == torch.float64
