"""The split ("wide") line search of ops/cuda_linesearch.py: the plain
versions of K8 (objective sweep), the acceptance rule and K9 (re-roll +
relinearization + carry select) against the JAX package's
pallas_fused_line_search_wide in interpret mode, float64, B=1024 (the
smallest batch it takes), H=10: both cost forms, a float32 and a
bfloat16 Jacobian carry, every output to 1e-12 and the flags exactly;
and the port's split search against its own fused plain version to 1e-9,
as tests/test_lanes_last.py holds the two JAX kernels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.ops import cuda_linesearch as K3
from autompc_torch.sysid import SINDy as TSINDy
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark
from autompc_tpu.ops.pallas_linesearch import pallas_fused_line_search_wide
from autompc_tpu.sysid import SINDy

torch.set_num_threads(1)

Q = np.diag([10.0, 0.1, 0.01, 0.01])
R = 0.001 * np.eye(1)
F = np.diag([3.0, 0.5, 0.2, 0.1])
ALPHAS = tuple(0.2 ** k for k in range(10))
B, H = 1024, 10
NAMES = ("xs", "us", "obj", "succ", "fail", "jac", "du2")


@pytest.fixture(scope="module")
def model():
    b = CartpoleSwingupBenchmark()
    m = SINDy(b.system, method="lstsq", threshold=1e-3, trig_basis=True,
              trig_freq=1, trig_interaction=True)
    m.train(b.gen_trajs_batch(seed=42, n_trajs=40, traj_len=60))
    t = TSINDy(b.system, device="cpu", method="lstsq", trig_basis=True, trig_freq=1,
               trig_interaction=True)
    t.set_parameters({**m.get_parameters(), "feature_names": m.get_feature_names()})
    active = tuple(int(k) for k in np.flatnonzero(np.any(np.asarray(m.coeffs) != 0, axis=0)))
    return m, t, active


@pytest.fixture(autouse=True)
def one_step_tiles(monkeypatch):
    """T = 1 time step per grid cell of the JAX wide kernels (a tile knob
    that does not change the math) keeps their interpret-mode compile to
    seconds."""
    monkeypatch.setenv("AMPC_LS_WIDE_TA", "1")
    monkeypatch.setenv("AMPC_LS_WIDE_TB", "1")


def _inputs(seed, nan_lanes=0):
    rng = np.random.default_rng(seed)
    obj0 = rng.uniform(2.0, 30.0, B)
    d = dict(
        x0=rng.uniform(-1, 1, (4, B)),
        xs=rng.uniform(-1, 1, (H + 1, 4, B)),
        us=rng.uniform(-2, 2, (H, B)),
        Ks=rng.normal(size=(H, 4, B)) * 0.3,
        ks=rng.normal(size=(H, B)),
        obj0=obj0,
        lin=-rng.uniform(0.1, 5.0, B) * obj0 / 10,
        quad=-rng.uniform(0.1, 5.0, B),
        ks_small=rng.uniform(size=B) < 0.15,
        act=rng.uniform(size=B) > 0.25,
        old_jac=rng.normal(size=(H, 20, B)),
        qd=10 ** rng.uniform(-1, 1.5, (4, B)),
        rd=10 ** rng.uniform(-3, 0, (1, B)),
        fd=10 ** rng.uniform(-1, 1.5, (4, B)),
        goal=np.array([0.1, 0.0, -0.2, 0.0]),
    )
    # NaN gains on a few lanes: their controls, objectives and trajectory
    # are NaN, and the argmin/argmax of the acceptance rule must treat
    # NaN as the JAX package does.
    d["Ks"][3:, :, :nan_lanes] = np.nan
    return d


def _port_args(model, d, form, jac_dtype):
    _, t, active = model
    T = torch.as_tensor
    cost = ((tuple(np.diag(Q)), tuple(np.diag(R)), tuple(np.diag(F))) if form == "fixed"
            else (T(d["qd"]), T(d["rd"]), T(d["fd"])))
    return (tuple(t.library.terms[k] for k in active),
            *(T(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")), t.coeffs[:, list(active)],
            ALPHAS, -20.0, 20.0, *cost, tuple(d["goal"]), 0.05,
            *(T(d[k]) for k in ("obj0", "lin", "quad", "ks_small", "act")),
            T(d["old_jac"]).to(jac_dtype))


def _jax_ref(model, d, form, jac_dtype):
    m, _, active = model
    cost = ((Q, R, F) if form == "fixed" else (d["qd"], d["rd"], d["fd"]))
    old_jac = jnp.asarray(d["old_jac"]).astype(
        jnp.bfloat16 if jac_dtype == torch.bfloat16 else jnp.float64)
    gts = m.library.grad_terms
    return pallas_fused_line_search_wide(
        tuple(m.library._fns[k] for k in active),
        *(jnp.asarray(d[k]) for k in ("x0", "xs", "us", "Ks", "ks")),
        m.coeffs[:, jnp.asarray(active)], jnp.asarray(ALPHAS), jnp.array([-20.0]),
        jnp.array([20.0]), *(jnp.asarray(c) for c in cost), jnp.asarray(d["goal"]), 0.05,
        *(jnp.asarray(d[k]) for k in ("obj0", "lin", "quad", "ks_small", "act")), old_jac,
        grad_terms=tuple(gts[k] for k in active), interpret=True,
        per_lane_diag_cost=form == "per_lane",
    )


@pytest.mark.parametrize("jac_dtype", [torch.float64, torch.bfloat16],
                         ids=["f64_jac", "bf16_jac"])
@pytest.mark.parametrize("form", ["fixed", "per_lane"])
def test_wide_plain_matches_pallas(model, form, jac_dtype):
    d = _inputs(40 + (form == "per_lane"), nan_lanes=2)
    args = _port_args(model, d, form, jac_dtype)
    got = K3.fused_line_search_wide_plain(*args)
    ref = _jax_ref(model, d, form, jac_dtype)
    for name, g, r in zip(NAMES, got, ref):
        r = np.asarray(r.astype(jnp.float64) if r.dtype == jnp.bfloat16 else r)
        if name in ("succ", "fail") or g.dtype == torch.bfloat16:
            # bfloat16 rows: the same float64 -> float32 -> bfloat16 rounding
            # in both packages, so equal; NaN lanes equal as NaN.
            np.testing.assert_array_equal(g.double().numpy(), r, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-12, atol=1e-12, err_msg=name)
    assert got[5].dtype == jac_dtype
    succ, fail = got[3].numpy(), got[4].numpy()
    assert succ.any() and (~succ).any() and fail.any()
    assert np.isnan(got[2].numpy()[:2]).any()     # an active lane of NaN gains


@pytest.mark.parametrize("form", ["fixed", "per_lane"])
def test_wide_equals_fused_in_port(model, form):
    """The split search returns what the fused plain version returns:
    the same objectives, acceptance and re-roll, 1e-9."""
    d = _inputs(42)
    args = _port_args(model, d, form, torch.float64)
    wide = K3.fused_line_search_wide_plain(*args)
    fused = K3.fused_line_search_plain(*args)
    for name, w, f in zip(NAMES, wide, fused):
        if name in ("succ", "fail"):
            np.testing.assert_array_equal(w.numpy(), f.numpy(), err_msg=name)
        else:
            np.testing.assert_allclose(w.numpy(), f.numpy(), rtol=1e-9, atol=1e-9,
                                       err_msg=name)


def test_wide_wrappers_on_cpu_take_the_plain_versions(model):
    """K8's and K9's wrappers on CPU tensors are the plain versions, and
    the entry is objectives + acceptance + re-roll."""
    d = _inputs(43)
    args = _port_args(model, d, "per_lane", torch.bfloat16)
    objs = K3.wide_objectives(*args[:15])
    assert tuple(objs.shape) == (len(ALPHAS), B)
    torch.testing.assert_close(objs, K3.line_search_objectives(*args[:15]), rtol=0, atol=0)
    a_sel, tmask, jmask, new_obj, succ, fail = K3.wide_accept(
        objs, ALPHAS, *args[15:20])
    out = K3.wide_reroll(*args[:7], a_sel, -20.0, 20.0, tmask, jmask, args[20])
    ref = K3.fused_line_search_wide(*args)
    for a, b in zip((out[0], out[1], new_obj, succ, fail, out[2], out[3]), ref):
        assert torch.equal(a, b)


def test_wide_wrapper_validates(model):
    d = _inputs(44)
    args = list(_port_args(model, d, "fixed", torch.float64))
    half = [a[..., :B // 2].contiguous() if isinstance(a, torch.Tensor) and a.shape[-1] == B
            else a for a in args]
    with pytest.raises(ValueError, match="B % 1024"):
        K3.fused_line_search_wide(*half)
    lane_coeffs = list(args)
    lane_coeffs[6] = args[6][:, :, None].expand(-1, -1, B)
    with pytest.raises(ValueError, match="per-lane coefficients"):
        K3.wide_objectives(*lane_coeffs[:15])
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="meta"):
        K3.fused_line_search_wide(*meta)
