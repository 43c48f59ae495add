"""The GP fan-outs and the tuner's kind "joint_gp" of the port against the
JAX package, float64 on the CPU, at a tiny size (4 cartpole trajectories
of 20 steps, ``niter=2``, batches of 32, B = 8, H = 4, 2 closed-loop
steps):

- ``JointGPQuadCostFanout`` (mixed ``induce_count``s, padded to 16)
  against the JAX fan-out at 1e-8, with and without the GaussReg term,
  and with ``backward="pallas"`` (on the CPU: K6's plain version); the
  port trains its own buckets, given the JAX package's epoch orders
  (``svgp_epoch_perms`` replaced by JAX's key chain), and they match the
  JAX fan-out's at 1e-9;
- the fixed-model fan-out of ``bench_scaling.py``'s ``SCALE_MODE=gp``
  (``QuadCostFanout`` on an ``ApproximateGPModel``: one of the JAX
  fan-out's buckets) against JAX's at 1e-8, with and without the term
  (each JAX fan-out is built once, with the term: a zero weight in every
  lane is the score without it);
- the bucket cache: a lane's predictor is its bucket's, a new count
  trains alone, a batch of 5 pads to 8 lanes, ``mesh`` and a missing
  ``regw`` raise by name;
- the tuner: one round of the kind "joint_gp" against the JAX tuner (the
  same configurations, costs at 1e-6, the same incumbent).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autompc_torch import NotPortedError
from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.control import IterativeLQRFactory as TILQRFactory
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.costs import QuadCostFactory as TQuadFactory
from autompc_torch.parallel import JointGPQuadCostFanout as TJoint
from autompc_torch.parallel import QuadCostFanout as TFan
from autompc_torch.pipeline import Pipeline as TPipeline
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.sysid import gp as tgp
from autompc_torch.tuning import PipelineTuner as TTuner
from autompc_torch.tuning import pipeline_tuner
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.control import IterativeLQRFactory
from autompc_tpu.core.trajectory import TrajectoryBatch as JTB
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.costs import QuadCostFactory
from autompc_tpu.parallel.fanout import JointGPQuadCostFanout as JJoint
from autompc_tpu.parallel.fanout import QuadCostFanout as JFan
from autompc_tpu.pipeline import Pipeline
from autompc_tpu.sysid import SINDy
from autompc_tpu.sysid.gp import ApproximateGPModel, ApproximateGPModelFactory
from autompc_tpu.tuning import PipelineTuner

torch.set_num_threads(1)

SURR = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
            trig_interaction=True)
GP_CFG = dict(niter=2, lr=0.1, batch_size=32, seed=3)
H_FAN, STEPS_FAN, B_FAN, PAD = 4, 2, 8, 16
INIT = np.array([0.5, 0.0, 0.0, 0.0])


def jax_epoch_perms(n_total, n_used, n_epochs, seed, device):
    """``svgp_epoch_perms`` with the JAX package's key chain."""
    key, out = jax.random.PRNGKey(int(seed)), []
    for _ in range(n_epochs):
        key, kp = jax.random.split(key)
        out.append(torch.as_tensor(np.array(jax.random.permutation(kp, n_total)[:n_used]),
                                   device=device))
    return out


@pytest.fixture
def jax_orders(monkeypatch):
    monkeypatch.setattr(tgp, "svgp_epoch_perms", jax_epoch_perms)


@pytest.fixture(scope="module")
def setup():
    """Both benchmarks, one sysid data set, one surrogate, a near-upright
    task with a quadratic task cost in each package, a candidate batch."""
    b, tb = JBench(), TBench()
    ttr = tb.gen_trajs_batch(seed=1, n_trajs=4, traj_len=20, device="cpu")
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
    rng = np.random.default_rng(0)
    batch = {"induce_count": rng.choice([6, 10, 16], B_FAN),
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


def _batch(s, reg, keys=None):
    return {k: v for k, v in s["batch"].items()
            if (reg or k != "regw") and (keys is None or k in keys)}


@pytest.fixture(scope="module")
def jax_costs(setup):
    """The JAX fan-outs' scores: the joint one and the fixed-model one,
    with and without the GaussReg term. Each JAX fan-out is built once,
    with the term; a zero weight on every lane is the score without it
    (the term adds exact zeros), and saves a compilation."""
    s, out = setup, {}
    joint = JJoint(s["b"].system, s["task"], GP_CFG, s["jtr"].to_list(), s["surr"],
                   horizon=H_FAN, n_steps=STEPS_FAN, backward="scan", pad_to=PAD,
                   **_reg(s, True))
    batches = {}
    for reg in (False, True):
        batches[reg] = {k: jnp.asarray(v) for k, v in s["batch"].items() if k != "induce_count"}
        if not reg:
            batches[reg]["regw"] = jnp.zeros(B_FAN)
        out["joint", reg] = np.asarray(joint(dict(batches[reg],
                                                  induce_count=s["batch"]["induce_count"])))
    # The fixed model: the joint fan-out's 10-point bucket (padded to 16),
    # through JAX's QuadCostFanout.
    bucket = joint._bucket_cache[10]
    jm = ApproximateGPModel(s["b"].system)
    jm.set_parameters({"gp_params": bucket["gp"],
                       **{k: bucket[k] for k in ("xu_means", "xu_std", "dy_means", "dy_std")}})
    fixed = JFan(s["b"].system, s["task"], jm, s["surr"], horizon=H_FAN,
                 n_steps=STEPS_FAN, goal=np.zeros(4), backward="scan", **_reg(s, True))
    for reg in (False, True):
        out["gp", reg] = np.asarray(fixed(batches[reg]))
    out["joint"], out["jm"] = joint, jm
    return out


@pytest.mark.parametrize("reg, backward", [(False, "scan"), (True, "scan"),
                                           (False, "pallas")])
def test_joint_gp_fanout_matches_jax(setup, jax_costs, jax_orders, reg, backward):
    s = setup
    fan = TJoint(s["tb"].system, s["ttask"], GP_CFG, s["ttr"], s["tsurr"], horizon=H_FAN,
                 n_steps=STEPS_FAN, backward=backward, pad_to=PAD, device="cpu", **_reg(s, reg))
    got = fan(_batch(s, reg)).numpy()
    ref = jax_costs["joint", reg]
    assert got.shape == (B_FAN,) and np.all(np.isfinite(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-8)
    assert sorted(fan.buckets) == [6, 10, 16]
    assert len(set(np.round(ref, 6))) > 1          # the candidates discriminate


@pytest.mark.parametrize("reg", [False, True])
def test_fixed_gp_fanout_matches_jax(setup, jax_costs, reg):
    """``SCALE_MODE=gp``: ``QuadCostFanout`` with the GP as the model (no
    closed-form Jacobian: the solver takes jacfwd of the cached-mean
    predictor)."""
    s = setup
    gp = tgp.ApproximateGPModel(s["tb"].system, device="cpu")
    gp.set_parameters(jax_costs["jm"].get_parameters())
    fan = TFan(s["tb"].system, s["ttask"], gp, s["tsurr"], horizon=H_FAN, n_steps=STEPS_FAN,
               goal=np.zeros(4), backward="scan", device="cpu", **_reg(s, reg))
    got = fan(_batch(s, reg, ("Qdiag", "Rdiag", "Fdiag", "regw"))).numpy()
    np.testing.assert_allclose(got, jax_costs["gp", reg], rtol=1e-8)


def test_train_svgp_buckets_matches_jax(setup, jax_costs):
    """The port's padded bucket training given the JAX package's epoch
    orders against the buckets the JAX fan-out trained (1e-9)."""
    s = setup
    ref = jax_costs["joint"]._bucket_cache
    counts = sorted(ref)
    n_total = 4 * 19
    p, w, norm = tgp.train_svgp_buckets(
        s["tb"].system, s["ttr"], counts, pad_to=PAD, device="cpu",
        perms=jax_epoch_perms(n_total, 64, GP_CFG["niter"], GP_CFG["seed"], "cpu"), **GP_CFG)
    for b, M in enumerate(counts):
        for k, v in ref[M]["gp"].items():
            np.testing.assert_allclose(p[k][b].numpy(), np.asarray(v), rtol=1e-9, atol=1e-9,
                                       err_msg=f"{M} {k}")
        np.testing.assert_allclose(w[b].numpy(), np.asarray(ref[M]["w"]), rtol=1e-9, atol=1e-9)
        assert torch.equal(w[b, :, M:], torch.zeros_like(w[b, :, M:]))
    for k, v in norm.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref[counts[0]][k]), rtol=1e-12)


def test_bucket_cache_and_lane_params(setup):
    """A lane's predictor is its bucket's; the buckets train once, a new
    count alone; a batch of 5 pads to 8 lanes and returns 5 scores; the
    refusals by name."""
    s = setup
    args = (s["tb"].system, s["ttask"], GP_CFG, s["ttr"], s["tsurr"])
    fan = TJoint(*args, horizon=H_FAN, n_steps=STEPS_FAN, pad_to=PAD, device="cpu")
    lanes = fan.lane_params([10, 6, 10])
    p, w, _ = tgp.train_svgp_buckets(s["tb"].system, s["ttr"], [6, 10], pad_to=PAD,
                                     device="cpu", **GP_CFG)
    for lane, b in ((0, 1), (1, 0), (2, 1)):
        for k in p:
            assert torch.equal(lanes["gp"][k][lane], p[k][b]), k
        assert torch.equal(lanes["w"][lane], w[b])
    before = fan.buckets[6]["w"]
    fan.lane_params([6, 12])
    assert sorted(fan.buckets) == [6, 10, 12] and fan.buckets[6]["w"] is before
    five = {k: v[:5] for k, v in _batch(s, False).items()}
    assert fan(five).shape == (5,)
    assert fan.pad_to == PAD
    with pytest.raises(NotPortedError, match="mesh"):
        TJoint(*args, mesh=object(), device="cpu")
    fan_r = TJoint(*args, horizon=H_FAN, n_steps=STEPS_FAN, pad_to=PAD, device="cpu",
                   **_reg(s, True))
    with pytest.raises(ValueError, match="regw"):
        fan_r(_batch(s, False))


def _tune(s, port, n_iters=6):
    system = (s["tb"] if port else s["b"]).system
    if port:
        mf = tgp.ApproximateGPModelFactory(system, device="cpu", **GP_CFG)
        pipe = TPipeline(system, mf, TQuadFactory(system, goal=np.zeros(4)),
                         TILQRFactory(system, horizon=H_FAN))
        tuner = TTuner(surrogate_mode="pretrain", eval_batch=n_iters, use_fanout=True)
        assert tuner._fanout_kind(pipe, s["tsurr"]) == ("joint_gp", "")
        return tuner.run(pipe, s["ttask"], s["ttr"].to_list(), n_iters=n_iters,
                         rng=np.random.default_rng(7), surrogate=s["tsurr"])[1]
    pipe = Pipeline(system, ApproximateGPModelFactory(system, **GP_CFG),
                    QuadCostFactory(system, goal=np.zeros(4)),
                    IterativeLQRFactory(system, horizon=H_FAN))
    tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=n_iters, use_fanout=True,
                          fanout_backward="scan")
    return tuner.run(pipe, s["task"], s["jtr"].to_list(), n_iters=n_iters,
                     rng=np.random.default_rng(7), surrogate=s["surr"])[1]


def test_tuner_joint_gp_matches_jax(setup, jax_orders):
    assert "joint_gp" in pipeline_tuner._PORTED_KINDS
    res, ref = _tune(setup, port=True), _tune(setup, port=False)
    assert [c.get_dictionary() for c in res.cfgs] == [c.get_dictionary() for c in ref.cfgs]
    assert len({c["_model:induce_count"] for c in res.cfgs}) > 1
    assert np.isfinite(ref.costs).any()
    np.testing.assert_allclose(res.costs, ref.costs, rtol=1e-6)
    assert res.inc_cfg.get_dictionary() == ref.inc_cfg.get_dictionary()
