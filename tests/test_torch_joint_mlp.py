"""The joint-MLP tune of the port against the JAX package, float64 on the
CPU: the main demo's path at a small size.

(a) BoxThresholdCost and the V2 cartpole dynamics (1e-12);
(b) MLPFactory's configuration space: names, bounds, defaults,
    conditions and samples equal;
(c) the width masks of a padded net equal;
(d) the port's Adam against optax's scale_by_adam over a few steps
    (1e-12);
(e) per-lane masked training against JointMLPQuadCostFanout._train_only
    (1e-9), JAX's initial nets and epoch orders carried across; a lane of
    width w inside max_width trains as the port's own MLP.run_epochs on
    the unpadded net (1e-9);
(f) the solver with batch_params + horizon_mask + compaction against
    JAX's (1e-8); heff = H equals the unmasked solve and mixed heff equal
    dedicated solves at H = heff (as tests/test_horizon_mask.py pins);
(g) JointMLPQuadCostFanout.__call__ against JAX's scores (1e-6 rel);
(h) PipelineTuner selects kind "joint_mlp", and its horizon-masked run
    gives the per-horizon run's costs (1e-6).

The JAX package draws its initial nets and epoch orders from jax.random,
which the port cannot reproduce: this file reproduces JAX's key schedule
(``fanout.py`` ``_prepare`` and ``train_batch``) and hands the arrays to
the port (``init_nets``, ``perms``). The JAX solver runs its plain form
(backward "scan"), the port's its plain Riccati recursion too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupV2Benchmark as TBench
from autompc_torch.control import IterativeLQRFactory as TILQRFactory
from autompc_torch.control import ilqr as tilqr
from autompc_torch.core.trajectory import TrajectoryBatch as TTB
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.costs import QuadCostFactory as TQuadFactory
from autompc_torch.parallel import JointMLPQuadCostFanout as TJoint
from autompc_torch.parallel.fanout import scale_by_adam
from autompc_torch.pipeline import Pipeline as TPipeline
from autompc_torch.sysid import MLP as TMLP
from autompc_torch.sysid import MLPFactory as TMLPFactory
from autompc_torch.sysid.mlp import net_apply as t_net_apply
from autompc_torch.sysid.mlp import net_apply_jac as t_net_apply_jac
from autompc_torch.tuning import PipelineTuner as TTuner
from autompc_torch.tuning.bucketed import _mlp_masks as t_masks
from autompc_torch.tuning.bucketed import _mlp_padded_init as t_padded_init
from autompc_tpu.benchmarks import CartpoleSwingupV2Benchmark
from autompc_tpu.control import ilqr as jilqr
from autompc_tpu.costs import QuadCost as JQuad
from autompc_tpu.parallel.fanout import JointMLPQuadCostFanout
from autompc_tpu.sysid import MLP, MLPFactory
from autompc_tpu.sysid.mlp import net_apply, net_apply_jac
from autompc_tpu.tuning.bucketed import _mlp_masks, _mlp_padded_init

torch.set_num_threads(1)

MAXW, NB, EPOCHS, SEED = 32, 32, 3, 100
QUAD = dict(Q=np.diag([5.0, 0.5, 0.1, 0.05]), R=0.01 * np.eye(1),
            F=np.diag([5.0, 0.5, 0.1, 0.05]))
BUCKET = dict(n_hidden_layers=2, nonlintype="tanh")
WIDTHS = ((8, 16), (16, 4), (12, 12))


@pytest.fixture(scope="module")
def setup():
    """Both packages' V2 benchmark, one training set (JAX's draw), a
    surrogate MLP with one set of weights, and a near-upright task with
    a quadratic task cost (a continuous score)."""
    jb, tb = CartpoleSwingupV2Benchmark(), TBench()
    jtrajs = jb.gen_trajs_batch(seed=5, n_trajs=4, traj_len=25)
    ttrajs = TTB(tb.system, torch.as_tensor(np.array(jtrajs.obs)),
                 torch.as_tensor(np.array(jtrajs.ctrls))).to_list()
    jtrajs = jtrajs.to_list()
    jsur = MLP(jb.system, n_hidden_layers=1, hidden_size=16, nonlintype="tanh",
               n_train_iters=2, n_batch=NB)
    jsur.train(jtrajs)
    tsur = TMLP(tb.system, n_hidden_layers=1, hidden_size=16, nonlintype="tanh",
                device="cpu")
    tsur.set_parameters(jsur.get_parameters())
    tasks = []
    for b, cost_cls in ((jb, JQuad), (tb, TQuad)):
        task = b.task.copy()
        task.set_cost(cost_cls(b.system, goal=np.zeros(4), **QUAD))
        task.set_init_obs(np.array([0.4, 0.0, 0.0, 0.0]))
        task.set_num_steps(8)
        tasks.append(task)
    rng = np.random.default_rng(11)
    batch = dict(
        widths=WIDTHS, lr=np.array([1e-2, 3e-3, 3e-2]),
        Qdiag=rng.uniform(0.5, 5.0, (3, 4)), Rdiag=rng.uniform(1e-3, 0.05, (3, 1)),
        Fdiag=rng.uniform(0.5, 5.0, (3, 4)), horizons=np.array([4, 6, 5]),
    )
    return dict(jb=jb, tb=tb, jtrajs=jtrajs, ttrajs=ttrajs, jsur=jsur, tsur=tsur,
                jtask=tasks[0], ttask=tasks[1], batch=batch)


def _jax_draws(n_rows, target_widths, nxu=5, nx=4):
    """JAX's initial nets (one per lane) and epoch orders, by the key
    schedule of its fan-out."""
    _, k_init = jax.random.split(jax.random.PRNGKey(SEED))
    nets = [_mlp_padded_init(k_init, nxu, nx, w, MAXW) for w in target_widths]
    init = [{k: np.stack([np.asarray(n[i][k]) for n in nets]) for k in ("W", "b")}
            for i in range(len(nets[0]))]
    key, _ = jax.random.split(jax.random.PRNGKey(SEED))
    n_used = (n_rows // NB) * NB
    perms = []
    for _ in range(EPOCHS):
        key, kp = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(kp, n_rows)[:n_used]))
    return init, perms


def _fanouts(s, horizon=6, **kw):
    common = dict(horizon=horizon, max_width=MAXW, n_train_iters=EPOCHS, n_batch=NB,
                  seed=SEED, horizon_mask=True, **kw)
    return (JointMLPQuadCostFanout(s["jb"].system, s["jtask"], BUCKET, s["jtrajs"],
                                   s["jsur"], **common),
            TJoint(s["tb"].system, s["ttask"], BUCKET, s["ttrajs"], s["tsur"],
                   device="cpu", **common))


@pytest.fixture(scope="module")
def fanouts(setup):
    jf, tf = _fanouts(setup)
    n_rows = tf._XUt.shape[0]
    init, perms = _jax_draws(n_rows, list(WIDTHS) + [WIDTHS[-1]] * 5)
    return dict(jf=jf, tf=tf, init=[{k: v[:3] for k, v in la.items()} for la in init],
                perms=perms)


# ---- (a) cost and dynamics ------------------------------------------------


def test_box_cost_and_v2_dynamics_match_jax(setup):
    jb, tb = setup["jb"], setup["tb"]
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.4, 0.4, (64, 4)) * np.array([1, 1, 40, 1])
    x[:4, 3] = [np.inf, -np.inf, 1e30, 0.0]
    u = rng.uniform(-20, 20, (64, 1))
    jc, tc = jb.task.get_cost(), tb.task.get_cost()
    got = tc.eval_obs_cost(torch.as_tensor(x)).numpy()
    ref = np.array([float(jc.eval_obs_cost(jnp.asarray(r))) for r in x])
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < len(got)
    assert tc.eval_ctrl_cost(torch.as_tensor(u)).shape == (64,)
    assert float(tc.eval_term_obs_cost(torch.as_tensor(x)).abs().sum()) == 0.0
    xs = x[4:]
    np.testing.assert_allclose(
        tb.dynamics(torch.as_tensor(xs), torch.as_tensor(u[4:])).numpy(),
        np.asarray(jax.vmap(jb.dynamics)(jnp.asarray(xs), jnp.asarray(u[4:]))),
        rtol=1e-12, atol=1e-12)
    assert tb.get_cached_tune_result()["inc_cfg"].keys() == \
        jb.get_cached_tune_result()["inc_cfg"].keys()


# ---- (b) configuration space ----------------------------------------------


def test_mlp_factory_space_equals_jax(setup):
    js = MLPFactory(setup["jb"].system).get_configuration_space()
    ts = TMLPFactory(setup["tb"].system).get_configuration_space()
    assert str(ts) == str(js)
    assert ts.get_default_configuration().get_dictionary() == \
        js.get_default_configuration().get_dictionary()
    assert [str(c) for c in ts.get_conditions()] == [str(c) for c in js.get_conditions()]
    jc = js.sample_configuration(np.random.default_rng(3), size=30)
    tc = ts.sample_configuration(np.random.default_rng(3), size=30)
    assert [c.get_dictionary() for c in tc] == [c.get_dictionary() for c in jc]
    # Factory keyword arguments override configuration values.
    m = TMLPFactory(setup["tb"].system, n_hidden_layers="1", hidden_size_1=24,
                    n_train_iters=1, device="cpu")(ts.get_default_configuration(),
                                                    setup["ttrajs"])
    assert m.hidden_sizes == [24] and m.n_train_iters == 1


# ---- (c) masks -----------------------------------------------------------


@pytest.mark.parametrize("widths", [(7,), (8, 16), (16, 4, 32), (1, 2, 3, 32)])
def test_masks_equal_jax_and_embed_the_net(widths):
    for got, ref in zip(t_masks(5, 4, widths, MAXW), _mlp_masks(5, 4, widths, MAXW)):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    init = t_padded_init(SEED, 5, 4, widths, MAXW, torch.float64, "cpu")
    wm, bm = t_masks(5, 4, widths, MAXW)
    for layer, w, b in zip(init, wm, bm):
        assert float((layer["W"] * torch.as_tensor(1 - w)).abs().sum()) == 0.0
        assert float((layer["b"] * torch.as_tensor(1 - b)).abs().sum()) == 0.0


# ---- (d) Adam --------------------------------------------------------------


def test_adam_matches_optax_scale_by_adam():
    rng = np.random.default_rng(2)
    grads = [rng.normal(size=(3, 7)) * 10.0 ** rng.uniform(-4, 1) for _ in range(5)]
    tx = optax.scale_by_adam()
    state = tx.init(jnp.zeros((3, 7)))
    mu, nu = torch.zeros(3, 7, dtype=torch.float64), torch.zeros(3, 7, dtype=torch.float64)
    for count, g in enumerate(grads, start=1):
        ref, state = tx.update(jnp.asarray(g), state)
        got = scale_by_adam(torch.as_tensor(g), mu, nu, count)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=0)
    np.testing.assert_allclose(mu.numpy(), np.asarray(state.mu), rtol=1e-12)
    np.testing.assert_allclose(nu.numpy(), np.asarray(state.nu), rtol=1e-12)


# ---- (e) per-lane training -------------------------------------------------


def test_per_lane_training_matches_jax(setup, fanouts):
    f = fanouts
    ref = f["jf"]._train_only(setup["batch"])
    got = f["tf"]._train_only(setup["batch"], init_nets=f["init"], perms=f["perms"])
    assert len(got) == len(ref) == 3
    for i, (g, r) in enumerate(zip(got, ref)):
        for k in ("W", "b"):
            assert g[k].shape == r[k].shape == (8,) + r[k].shape[1:]
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]), rtol=1e-9, atol=1e-9,
                                       err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("widths, nonlin", [((5,), "sigmoid"), ((9, 3), "relu")])
def test_a_padded_lane_trains_as_the_unpadded_net(setup, widths, nonlin):
    """A lane of width w inside max_width against MLP.run_epochs on the
    MLP of width w, the same initial net and epoch orders."""
    tb, trajs = setup["tb"], setup["ttrajs"]
    kw = {f"hidden_size_{i + 1}": w for i, w in enumerate(widths)}
    m = TMLP(tb.system, n_hidden_layers=len(widths), nonlintype=nonlin, n_train_iters=EPOCHS,
             n_batch=NB, lr=1e-2, device="cpu", **kw)
    m.train(trajs)
    fan = TJoint(tb.system, setup["ttask"], dict(n_hidden_layers=len(widths), nonlintype=nonlin),
                 trajs, setup["tsur"], max_width=MAXW, n_train_iters=EPOCHS, n_batch=NB,
                 seed=SEED, device="cpu")
    nets = fan._train_only(dict(widths=(widths,), lr=np.array([1e-2]), Qdiag=np.ones((1, 4)),
                                Rdiag=np.ones((1, 1)), Fdiag=np.ones((1, 4))))
    for layer, ref in zip(nets, m.params["net"]):
        W = layer["W"][0, : ref["W"].shape[0], : ref["W"].shape[1]]
        np.testing.assert_allclose(W.numpy(), ref["W"].numpy(), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(layer["b"][0, : ref["b"].shape[0]].numpy(),
                                   ref["b"].numpy(), rtol=1e-9, atol=1e-9)
        assert float(layer["W"][0].abs().sum() - W.abs().sum()) == 0.0


# ---- (f) the solver's per-lane and horizon-mask modes ------------------------


@pytest.fixture(scope="module")
def lane_models(setup):
    """Three per-lane masked nets (random weights, non-trivial z-scoring)
    as both solvers take them: JAX's {net, wmasks, bmasks} and the port's
    masked nets, with each package's pred_core and pred_diff."""
    rng = np.random.default_rng(7)
    nets, wms, bms = [], [], []
    for w in WIDTHS:
        wm, bm = _mlp_masks(5, 4, w, MAXW)
        sizes = [5, MAXW, MAXW, 4]
        nets.append([{"W": rng.normal(0, 1 / np.sqrt(a), (a, b)), "b": rng.normal(0, 0.2, b)}
                     for a, b in zip(sizes[:-1], sizes[1:])])
        wms.append(wm)
        bms.append(bm)
    stack = lambda per: [np.stack(x) for x in zip(*per)]  # noqa: E731
    jnet = [{k: jnp.asarray(np.stack([n[i][k] for n in nets])) for k in ("W", "b")}
            for i in range(3)]
    jp = {"net": jnet, "wmasks": [jnp.asarray(m) for m in stack(wms)],
          "bmasks": [jnp.asarray(m) for m in stack(bms)]}
    tp = {"net": [{"W": torch.as_tensor(np.asarray(la["W"]) * wm),
                   "b": torch.as_tensor(np.asarray(la["b"]) * bm)}
                  for la, wm, bm in zip(jnet, stack(wms), stack(bms))]}
    xm, xs = rng.normal(0, 0.3, 5), rng.uniform(0.5, 2.0, 5)
    ym, ys = rng.normal(0, 0.01, 4), rng.uniform(0.02, 0.1, 4)

    def j_masked(p):
        return [{"W": la["W"] * wm, "b": la["b"] * bm}
                for la, wm, bm in zip(p["net"], p["wmasks"], p["bmasks"])]

    def j_pred(p, x, u):
        xut = (jnp.concatenate([x, u]) - xm) / xs
        return x + net_apply(j_masked(p), xut, "tanh") * ys + ym

    def j_diff(p, x, u):
        xut = (jnp.concatenate([x, u]) - xm) / xs
        y, J = net_apply_jac(j_masked(p), xut, "tanh")
        J = ys[:, None] * J / xs[None, :]
        return x + y * ys + ym, jnp.eye(4) + J[:, :4], J[:, 4:]

    txm, txs, tym, tys = (torch.as_tensor(v) for v in (xm, xs, ym, ys))

    def t_pred(p, x, u):
        xut = (torch.cat([x, u], -1) - txm) / txs
        return x + t_net_apply(p["net"], xut, "tanh") * tys + tym

    def t_diff(p, x, u):
        xut = (torch.cat([x, u], -1) - txm) / txs
        y, J = t_net_apply_jac(p["net"], xut, "tanh")
        J = tys[:, None] * J / txs[None, :]
        return x + y * tys + tym, torch.eye(4, dtype=J.dtype) + J[..., :4], J[..., 4:]

    b = setup["batch"]
    x0 = rng.uniform(-0.3, 0.3, (3, 4)) + np.array([0.3, 0.0, 0.0, 0.0])
    cost = {k: b[k] for k in ("Qdiag", "Rdiag", "Fdiag")}
    kw = dict(ds=4, dc=1, obsdim=4, dt=0.05, ubounds=(np.array([-20.0]), np.array([20.0])),
              max_iter=8, quad_cost_batch=True, quad_goal=np.zeros(4), backward="scan",
              batch_params=True)
    return dict(jp=jp, tp=tp, j_pred=j_pred, j_diff=j_diff, t_pred=t_pred, t_diff=t_diff,
                x0=x0, cost=cost, kw=kw)


def _t_solve(lm, H, heff=None, schedule=None, lanes=slice(None)):
    kw = dict(lm["kw"], H=H, horizon_mask=heff is not None, pred_diff=lm["t_diff"])
    if schedule is None:
        solve = tilqr.make_batched_ilqr_solver(lm["t_pred"], None, **kw)
    else:
        solve = tilqr.make_scheduled_ilqr_solver(lm["t_pred"], None, schedule=schedule, **kw)
    cp = {k: torch.as_tensor(v[lanes]) for k, v in lm["cost"].items()}
    if heff is not None:
        cp["heff"] = torch.as_tensor(heff)
    params = {"net": [{k: v[lanes] for k, v in la.items()} for la in lm["tp"]["net"]]}
    x0 = torch.as_tensor(lm["x0"][lanes])
    return [o.numpy() for o in solve(params, x0, x0.new_zeros((x0.shape[0], H, 1)), cp)]


def test_per_lane_masked_scheduled_solver_matches_jax(lane_models):
    lm = lane_models
    H, heff, sched = 7, np.array([4, 7, 5]), ((2, 0.5),)
    kw = dict(lm["kw"], H=H, horizon_mask=True, pred_diff=lm["j_diff"])
    kw.pop("max_iter")
    solve = jilqr.make_scheduled_ilqr_solver(lm["j_pred"], None, max_iter=8, schedule=sched,
                                             **kw)
    cp = {k: jnp.asarray(v) for k, v in lm["cost"].items()}
    cp["heff"] = jnp.asarray(heff, jnp.int32)
    ref = jax.jit(solve)(lm["jp"], jnp.asarray(lm["x0"]), jnp.zeros((3, H, 1)), cp)
    got = _t_solve(lm, H, heff=heff, schedule=sched)
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    for i in (1, 2, 3, 4):
        np.testing.assert_allclose(got[i], np.asarray(ref[i]), rtol=1e-8, atol=1e-8,
                                   err_msg=str(i))


def test_full_heff_equals_the_unmasked_solve(lane_models):
    H = 6
    ref = _t_solve(lane_models, H)
    got = _t_solve(lane_models, H, heff=np.array([H] * 3))
    np.testing.assert_array_equal(got[0], ref[0])
    for i in (1, 2, 3, 4):
        np.testing.assert_allclose(got[i], ref[i], rtol=1e-9, atol=1e-10, err_msg=str(i))


def test_mixed_heff_equals_dedicated_solves(lane_models):
    H, heff = 7, np.array([3, 7, 5])
    msk = _t_solve(lane_models, H, heff=heff, schedule=((2, 0.5),))
    for lane, h in enumerate(heff):
        ded = _t_solve(lane_models, int(h), lanes=slice(lane, lane + 1))
        assert bool(msk[0][lane]) == bool(ded[0][0]), lane
        np.testing.assert_allclose(msk[1][lane, : h + 1], ded[1][0], rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(msk[2][lane, :h], ded[2][0], rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(msk[3][lane, :h], ded[3][0], rtol=1e-6, atol=1e-8)
        # The inert tail: frozen states, the (zero) guess's controls, no gains.
        np.testing.assert_array_equal(msk[1][lane, h + 1:],
                                      np.broadcast_to(msk[1][lane, h], msk[1][lane, h + 1:].shape))
        np.testing.assert_array_equal(msk[2][lane, h:], 0.0)
        np.testing.assert_array_equal(msk[3][lane, h:], 0.0)


# ---- (g) the whole fan-out ---------------------------------------------------


def test_fanout_scores_match_jax(setup, fanouts):
    f = fanouts
    ref = np.asarray(f["jf"](setup["batch"]))
    got = f["tf"](setup["batch"], init_nets=f["init"], perms=f["perms"]).numpy()
    assert got.shape == (3,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_fanout_pads_to_pad_to_and_refuses_mesh_and_reg_matrix(setup):
    s = setup
    fan = TJoint(s["tb"].system, s["ttask"], BUCKET, s["ttrajs"], s["tsur"], max_width=MAXW,
                 n_train_iters=1, n_batch=NB, pad_to=11, horizon_mask=True, device="cpu")
    full, B = fan._prepare(s["batch"])
    assert B == 3 and full["lr"].shape == (16,) and full["net0"][0]["W"].shape == (16, 5, MAXW)
    assert full["horizons"].tolist() == [4, 6, 5] + [5] * 13
    with pytest.raises(ValueError, match="mesh"):
        TJoint(s["tb"].system, s["ttask"], BUCKET, s["ttrajs"], s["tsur"], device="cpu",
               mesh=object())
    # Built with the GaussReg term, it refuses a batch without the weights.
    fan = TJoint(s["tb"].system, s["ttask"], BUCKET, s["ttrajs"], s["tsur"], device="cpu",
                 reg_matrix=np.eye(4))
    with pytest.raises(ValueError, match="regw"):
        fan._prepare(s["batch"])


# ---- (h) the tuner's kind "joint_mlp" -----------------------------------------


def test_tuner_joint_mlp_masked_equals_per_horizon(setup):
    """tests/test_tuning.py's horizon-mask case in the port: the same BO
    asks scored through one horizon-masked program a bucket and through
    one program a horizon give the same costs."""
    s = setup
    system = s["tb"].system

    def pipeline():
        return TPipeline(
            system,
            TMLPFactory(system, n_hidden_layers="1", nonlintype="tanh", n_train_iters=2,
                        n_batch=NB, device="cpu"),
            TQuadFactory(system, goal=np.zeros(4)), TILQRFactory(system))

    task = s["ttask"]
    runs = []
    for hmask in (False, True):
        tuner = TTuner(surrogate_mode="pretrain", eval_batch=3, use_fanout=True,
                       fanout_horizon_mask=hmask)
        assert tuner._fanout_kind(pipeline(), s["tsur"]) == ("joint_mlp", "")
        runs.append(tuner.run(pipeline(), task, s["ttrajs"], n_iters=3,
                              rng=np.random.default_rng(9), surrogate=s["tsur"])[1])
    assert [c.get_dictionary() for c in runs[0].cfgs] == \
        [c.get_dictionary() for c in runs[1].cfgs]
    assert len({c["_ctrlr:horizon"] for c in runs[0].cfgs}) > 1
    np.testing.assert_allclose(runs[1].costs, runs[0].costs, rtol=1e-6)
    assert np.isfinite(runs[0].costs).all()
