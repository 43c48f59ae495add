"""The halfcheetah harness row in float32 at its full horizon (ds=18,
dc=6, H=200), both packages on the same weights, on the CPU.

The JAX package generates the harness data (24 x 40, seed 0) and trains
its MLP 24-64-64-18 at the default seed; ``MLP.set_parameters`` carries
the weights over; both packages then run the batch-major iLQR solve in
float32 from the harness's initial states (uniform +-0.1, zero control
guess) with the LU backward pass and the plain line-search rollouts.

What this pins, and what it cannot. The 10-epoch fit is rough and the
problem is ill-conditioned in float32 (R dt = 5e-4 beside a value
matrix that grows along an unstable model): a lane whose backward pass
overflows or loses positive definiteness turns NaN, and it does so in
the JAX package as in the port. Which lane does is chaotic (last-digit
differences in summation order decide it), so lanes are not compared
one by one. Pinned are: the entry rollout and its Jacobians agree to
float32 accuracy; both packages lose lanes at the default seed and the
counts of finite and of converged lanes agree within 2 of 8; on lanes
converged in both, the objectives agree to 5%; and the port's float64
solve on the same weights keeps every lane finite, so the lost lanes
are float32's, not the port's.

Run as a script, ``python tests/test_torch_cheetah_f32.py [N]`` prints,
for training seeds 100 and 0..N-1 (default 8) at B=16, each package's
converged and finite lane counts: the JAX solve on JAX-trained weights,
the port on the same weights, and the port on its own training of the
same data (LU and Cholesky backward).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import HalfcheetahBenchmark as TBench
from autompc_torch.control.ilqr import make_batched_ilqr_solver as t_solver
from autompc_torch.core.trajectory import TrajectoryBatch
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.sysid.mlp import MLP as TMLP
from autompc_tpu.benchmarks import HalfcheetahBenchmark as JBench
from autompc_tpu.control.ilqr import make_batched_ilqr_solver as j_solver
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.sysid.mlp import MLP as JMLP

torch.set_num_threads(1)

H = 200
MLP_KW = dict(n_hidden_layers=2, hidden_size=64, n_train_iters=10, n_batch=64)


def _x0(B):
    return np.random.default_rng(0).uniform(-0.1, 0.1, (1024, 18))[:B].astype(np.float32)


def _solver_kw(bench, backward="scan"):
    bounds = np.asarray(bench.task.get_ctrl_bounds())
    return dict(H=H, ds=18, dc=6, obsdim=18, dt=bench.system.dt,
                ubounds=(bounds[:, 0], bounds[:, 1]), backward=backward, max_iter=50)


def jax_side(seed, B, jb=None, trajs=None):
    """Train the JAX MLP at ``seed`` and solve in float32. Returns the
    weights, the (converged, xs, us) arrays and the entry rollout with
    its Jacobians."""
    with jax.enable_x64(False):
        jb = jb or JBench()
        trajs = trajs if trajs is not None else jb.gen_trajs_batch(seed=0, n_trajs=24, traj_len=40)
        jm = JMLP(jb.system, seed=seed, **MLP_KW)
        jm.train(trajs)
        cost = JQuad(jb.system, jnp.eye(18), jnp.eye(6) * 0.01, jnp.eye(18), goal=jnp.zeros(18))
        _, make_carry0, _, _ = j_solver(jm.pred_core, cost, pred_diff=jm.pred_diff_core,
                                        return_pieces=True, **_solver_kw(jb))
        solve = jax.jit(j_solver(jm.pred_core, cost, pred_diff=jm.pred_diff_core,
                                 **_solver_kw(jb)))
        x0, ug = jnp.asarray(_x0(B)), jnp.zeros((B, H, 6), jnp.float32)
        out = solve(jm.params, x0, ug)
        c0 = jax.jit(make_carry0)(jm.params, x0, ug)
        assert out[1].dtype == jnp.float32
        return (jm.get_parameters(), tuple(np.asarray(a) for a in out[:3]),
                {k: np.asarray(c0[k]) for k in ("xs", "Jx", "Ju")},
                (np.asarray(trajs.obs), np.asarray(trajs.ctrls)))


def _as(params, dtype):
    return {"net": [{k: v.to(dtype) for k, v in la.items()} for la in params["net"]],
            **{k: params[k].to(dtype) for k in ("xu_means", "xu_std", "dy_means", "dy_std")}}


def torch_side(tm, B, dtype=torch.float32, backward="scan", pieces=False):
    tb = TBench()
    cost = TQuad(tb.system, np.eye(18), 0.01 * np.eye(6), np.eye(18), goal=np.zeros(18))
    params = _as(tm.params, dtype)
    made = t_solver(tm.pred_core, cost, pred_diff=tm.pred_diff_core, return_pieces=pieces,
                    **_solver_kw(tb, backward))
    x0, ug = torch.as_tensor(_x0(B)).to(dtype), torch.zeros((B, H, 6), dtype=dtype)
    if pieces:
        return made[1](params, x0, ug)
    out = made(params, x0, ug)
    assert out[1].dtype == dtype
    return tuple(a.numpy() for a in out[:3])


def _counts(out):
    return int(out[0].sum()), int(np.isfinite(out[1]).all(axis=(1, 2)).sum())


@pytest.fixture(scope="module")
def row():
    weights, jout, jc0, _ = jax_side(seed=100, B=8)
    tm = TMLP(TBench().system, device="cpu", **MLP_KW)
    tm.set_parameters(weights)
    return dict(tm=tm, jout=jout, jc0=jc0)


def test_entry_rollout_and_jacobians_agree_in_float32(row):
    c0 = torch_side(row["tm"], 8, pieces=True)
    for k, tol in (("xs", 1e-3), ("Jx", 1e-4), ("Ju", 1e-4)):
        got, ref = c0[k].numpy(), row["jc0"][k]
        assert got.dtype == np.float32 and np.isfinite(ref).all()
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), k


def test_both_packages_lose_lanes_alike_at_the_default_seed(row):
    jout, tout = row["jout"], torch_side(row["tm"], 8)
    (jc, jf), (tc, tf) = _counts(jout), _counts(tout)
    assert jf < 8 and jc < 8, "the JAX float32 solve lost no lane: the premise is gone"
    assert abs(jc - tc) <= 2 and abs(jf - tf) <= 2, ((jc, jf), (tc, tf))
    # A NaN lane is neither converged nor wrongly reported as such.
    assert not (tout[0] & ~np.isfinite(tout[1]).all(axis=(1, 2))).any()
    both = jout[0] & tout[0]
    assert both.sum() >= 2

    def obj(xs, us):
        return 0.05 * ((xs[:, :H] ** 2).sum((1, 2)) + 0.01 * (us ** 2).sum((1, 2))) \
            + (xs[:, H] ** 2).sum(1)

    np.testing.assert_allclose(obj(tout[1], tout[2])[both], obj(jout[1], jout[2])[both],
                               rtol=0.05)


def test_float64_keeps_every_lane_finite(row):
    out = torch_side(row["tm"], 8, dtype=torch.float64)
    assert _counts(out)[1] == 8 and _counts(out)[0] >= 4


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    B = 16
    with jax.enable_x64(False):
        jb = JBench()
        trajs = jb.gen_trajs_batch(seed=0, n_trajs=24, traj_len=40)
    for seed in (100, *range(n)):
        weights, jout, _, (obs, ctrls) = jax_side(seed, B, jb, trajs)
        carried = TMLP(TBench().system, seed=seed, device="cpu", **MLP_KW)
        carried.set_parameters(weights)
        own = TMLP(TBench().system, seed=seed, device="cpu", **MLP_KW)
        own.train(TrajectoryBatch(own.system, torch.as_tensor(obs, dtype=torch.float64),
                                  torch.as_tensor(ctrls, dtype=torch.float64)))
        print(f"seed {seed}: (converged, finite) of {B} lanes: JAX {_counts(jout)}; "
              f"port on the JAX weights {_counts(torch_side(carried, B))}; port on its own "
              f"fit, LU {_counts(torch_side(own, B))}, Cholesky "
              f"{_counts(torch_side(own, B, backward='pallas'))}", flush=True)
