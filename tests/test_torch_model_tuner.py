"""The port's ModelTuner and the tuner's surrogate modes "autotune" and
"autoselect" against the JAX package's, float64 on the CPU.

(a) ModelTuner with ARX, SINDy and Koopman factories (the seed pinned so
    that ARX, SINDy lstsq and lasso and Koopman lasso candidates are
    proposed): the port with its buckets on and off against the JAX
    package's bucketed run, the same configurations, costs within rel
    1e-6 and the same incumbent;
(b) the union space's structure;
(c) PipelineTuner.run with surrogate_mode "autotune" (SINDyFactory) and
    "autoselect" (the five factories) against the JAX package: the same
    surrogate tune (configurations, costs within 1e-6, incumbent) and the
    same pipeline tune costs within 1e-6. "autoselect" proposes MLP
    candidates (the default configuration comes first) and its winner is
    an MLP: JAX draws the nets and epoch orders from jax.random, which the
    port cannot reproduce, so the test hands JAX's draws to the port's
    draw functions (``tuning/bucketed.py``'s ``_mlp_padded_init`` and
    ``epoch_perms``, ``sysid/mlp.py``'s ``epoch_perms`` and
    ``MLP._new_net``); its seed proposes no GP and no stable Koopman;
(d) no hidden fallback: a bucket that raises RuntimeError or
    NotPortedError, or a candidate that does, reaches the caller; a
    bucket that raises LinAlgError sends its candidates to the
    per-candidate path (the per-candidate run's costs), and a candidate
    that raises ValueError scores inf.
"""

import jax
import numpy as np
import pytest
import torch

import autompc_torch.sysid as tsysid
from autompc_torch import NotPortedError
from autompc_torch import from_arrays as t_from_arrays
from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.control import IterativeLQRFactory as TILQRFactory
from autompc_torch.costs import QuadCost as TQuad
from autompc_torch.costs import QuadCostFactory as TQuadFactory
from autompc_torch.evaluation import HoldoutModelEvaluator as THoldout
from autompc_torch.pipeline import Pipeline as TPipeline
from autompc_torch.sysid import mlp as tmlp
from autompc_torch.tuning import ModelTuner as TModelTuner
from autompc_torch.tuning import PipelineTuner as TTuner
from autompc_torch.tuning import bucketed as tbk
from autompc_tpu import from_arrays as j_from_arrays
from autompc_tpu import sysid as jsysid
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.control import IterativeLQRFactory
from autompc_tpu.costs import QuadCost, QuadCostFactory
from autompc_tpu.evaluation import HoldoutModelEvaluator
from autompc_tpu.pipeline import Pipeline
from autompc_tpu.sysid.mlp import net_init as j_net_init
from autompc_tpu.tuning import ModelTuner, PipelineTuner
from autompc_tpu.tuning import bucketed as jbk

torch.set_num_threads(1)

TOL = 1e-6
FACTORIES = ("ARXFactory", "SINDyFactory", "KoopmanFactory")
SINDY_KW = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
                trig_interaction=True)


@pytest.fixture(scope="module")
def data():
    jb, tb = JBench(), TBench()
    tl = tb.gen_trajs_batch(seed=3, n_trajs=16, traj_len=30, device="cpu").to_list()
    jl = [j_from_arrays(jb.system, t.obs.numpy(), t.ctrls.numpy()) for t in tl]
    return dict(jb=jb, tb=tb, js=jb.system, ts=tb.system, jl=jl, tl=tl)


def _dicts(cfgs):
    return [c.get_dictionary() for c in cfgs]


def _same_tune(got, ref):
    assert _dicts(got.cfgs) == _dicts(ref.cfgs)
    np.testing.assert_allclose(got.costs, ref.costs, rtol=TOL)
    assert got.inc_cfg.get_dictionary() == ref.inc_cfg.get_dictionary()


def _port_tuner(d, seed, use_bucketed=True, factories=FACTORIES, trajs=None):
    rng = np.random.default_rng(seed)
    ev = THoldout(system=d["ts"], trajs=trajs or d["tl"][:12], metric="rmse", rng=rng,
                  holdout_prop=0.25)
    tuner = TModelTuner(d["ts"], ev, eval_batch=4, use_bucketed=use_bucketed)
    for name in factories:
        tuner.add_model_factory(getattr(tsysid, name)(d["ts"], device="cpu"))
    return tuner, rng


# ---- (a) ModelTuner ------------------------------------------------------------

MT_SEED, MT_ITERS = 7, 8


@pytest.fixture(scope="module")
def jax_model_tune(data):
    rng = np.random.default_rng(MT_SEED)
    ev = HoldoutModelEvaluator(system=data["js"], trajs=data["jl"][:12], metric="rmse",
                               rng=rng, holdout_prop=0.25)
    tuner = ModelTuner(data["js"], ev, eval_batch=4)
    for name in FACTORIES:
        tuner.add_model_factory(getattr(jsysid, name)(data["js"]))
    return tuner.run(rng, n_iters=MT_ITERS)


@pytest.mark.parametrize("use_bucketed", [True, False])
def test_model_tuner_matches_jax(data, jax_model_tune, use_bucketed):
    jmodel, ref = jax_model_tune
    tuner, rng = _port_tuner(data, MT_SEED, use_bucketed)
    model, got = tuner.run(rng, n_iters=MT_ITERS)
    _same_tune(got, ref)
    kinds = {c["model"] + ":" + str(c.get(f"_{c['model']}:method", "")) for c in got.cfgs}
    assert {"ARX:", "SINDy:lstsq", "SINDy:lasso", "Koopman:lasso"} <= kinds, kinds
    assert got.inc_costs == sorted(got.inc_costs, reverse=True) and \
        got.inc_costs[-1] == min(got.costs)
    # The incumbent's model, trained on every trajectory.
    assert type(model).__name__ == type(jmodel).__name__
    x, u = np.array([[0.3, 0.1, -0.2, 0.05]]), np.array([[0.4]])
    ref_pred = jmodel.pred_batch(jmodel.traj_to_state(j_from_arrays(data["js"], x, u))[None],
                                 u)
    got_pred = model.pred_batch(model.traj_to_state(t_from_arrays(data["ts"], x, u))[None],
                                torch.as_tensor(u))
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(ref_pred), rtol=1e-8, atol=1e-10)


def test_union_space_structure(data):
    tuner = TModelTuner(data["ts"], None)
    for name in ("ARXFactory", "SINDyFactory"):
        tuner.add_model_factory(getattr(tsysid, name)(data["ts"], device="cpu"))
    space = tuner._build_space()
    cfg = space.get_default_configuration()
    assert cfg["model"] == "ARX" and "_ARX:history" in cfg and "_SINDy:method" not in cfg
    cfg["model"] = "SINDy"
    assert "_SINDy:method" in cfg and "_ARX:history" not in cfg
    factory, sub = tuner._get_model_cfg(cfg)
    assert factory.name == "SINDy" and "method" in sub.get_dictionary()


# ---- (c) the tuner's surrogate modes ---------------------------------------------

MODE_SEEDS = {"autotune": 0, "autoselect": 37}


def jax_mlp_seams(monkeypatch):
    """The port's MLP draws replaced by JAX's key schedule (MLP.train and
    the MLP bucket: ``key, k_init = split(PRNGKey(seed))``, the initial net
    from ``k_init``, one ``split`` of ``key`` an epoch)."""
    orig_new_net = tmlp.MLP._new_net

    def perms(n, n_batch, n_epochs, seed, device):
        key, _ = jax.random.split(jax.random.PRNGKey(int(seed)))
        n_used = max(n // n_batch, 1) * n_batch
        out = []
        for _ in range(n_epochs):
            key, kp = jax.random.split(key)
            out.append(torch.as_tensor(np.array(jax.random.permutation(kp, n)[:n_used]),
                                       device=device))
        return out

    def padded_init(seed, nxu, nx, widths, max_width, dtype, device):
        _, k_init = jax.random.split(jax.random.PRNGKey(int(seed)))
        return [{k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
                 for k, v in la.items()}
                for la in jbk._mlp_padded_init(k_init, nxu, nx, widths, max_width)]

    def new_net(self, seed):
        net = orig_new_net(self, seed)
        _, k_init = jax.random.split(jax.random.PRNGKey(int(seed)))
        with torch.no_grad():
            for W, b, la in zip(net.Ws, net.bs, j_net_init(k_init, self._sizes)):
                W.copy_(torch.as_tensor(np.array(la["W"])))
                b.copy_(torch.as_tensor(np.array(la["b"])))
        return net

    monkeypatch.setattr(tbk, "epoch_perms", perms)
    monkeypatch.setattr(tmlp, "epoch_perms", perms)
    monkeypatch.setattr(tbk, "_mlp_padded_init", padded_init)
    monkeypatch.setattr(tmlp.MLP, "_new_net", new_net)


def _task(bench, cost_cls):
    task = bench.task.copy()
    task.set_cost(cost_cls(bench.system, Q=np.eye(4), R=0.01 * np.eye(1), F=np.eye(4),
                           goal=np.zeros(4)))
    task.set_init_obs(np.array([0.5, 0.0, 0.0, 0.0]))
    task.set_num_steps(8)
    return task


@pytest.mark.parametrize("mode", ["autotune", "autoselect"])
def test_surrogate_modes_match_jax(data, mode, monkeypatch):
    """A fixed SINDy pipeline model (the port's fit carried to JAX), the
    fan-out on the tuned surrogate, one round of 4 surrogate candidates
    and one of 4 pipeline candidates on the same rng."""
    d = data
    jax_mlp_seams(monkeypatch)
    t = tsysid.SINDy(d["ts"], device="cpu", **SINDY_KW)
    t.train(d["tl"])
    j = jsysid.SINDy(d["js"], **SINDY_KW)
    j.set_parameters(t.get_parameters())
    runs = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            pipe = Pipeline(d["js"], j, QuadCostFactory(d["js"], goal=np.zeros(4)),
                            IterativeLQRFactory(d["js"], horizon=5))
            tuner = PipelineTuner(surrogate_mode=mode, surrogate_split=0.5, eval_batch=4,
                                  surrogate_factory=jsysid.SINDyFactory(d["js"]),
                                  use_fanout=True)
            args = (pipe, _task(d["jb"], QuadCost), d["jl"])
        else:
            pipe = TPipeline(d["ts"], t, TQuadFactory(d["ts"], goal=np.zeros(4)),
                             TILQRFactory(d["ts"], horizon=5))
            tuner = TTuner(surrogate_mode=mode, surrogate_split=0.5, eval_batch=4,
                           surrogate_factory=tsysid.SINDyFactory(d["ts"], device="cpu"),
                           use_fanout=True, fanout_feature_kernels=True)
            args = (pipe, _task(d["tb"], TQuad), d["tl"])
        runs[pkg] = tuner.run(*args, n_iters=4, rng=np.random.default_rng(MODE_SEEDS[mode]),
                              surrogate_tune_iters=4)[1]
    ref, got = runs["jax"], runs["port"]
    _same_tune(got.surr_tune_result, ref.surr_tune_result)
    models = [c["model"] for c in got.surr_tune_result.cfgs]
    if mode == "autoselect":
        assert "MLP" in models and "ApproximateGP" not in models and len(set(models)) >= 3
    else:
        assert set(models) == {"SINDy"}
    assert _dicts(got.cfgs) == _dicts(ref.cfgs)
    np.testing.assert_allclose(got.costs, ref.costs, rtol=TOL)
    assert len(set(got.costs)) > 1


# ---- (d) no hidden fallback --------------------------------------------------------


@pytest.mark.parametrize("error", [RuntimeError, NotPortedError])
def test_a_bucket_error_reaches_the_caller(data, error, monkeypatch):
    def fail(self, cfgs, idxs, costs):
        raise error("a bucket that fails")

    monkeypatch.setattr(TModelTuner, "_eval_arx_bucket", fail)
    tuner, rng = _port_tuner(data, MT_SEED, factories=("ARXFactory",))
    with pytest.raises(error, match="a bucket that fails"):
        tuner.run(rng, n_iters=4)


def test_a_singular_bucket_takes_the_per_candidate_path(data, monkeypatch):
    """As in the JAX package: the candidates of a bucket that fails on a
    bad candidate (a singular solve) are scored one at a time."""
    tuner, rng = _port_tuner(data, MT_SEED, use_bucketed=False, factories=("ARXFactory",))
    _, ref = tuner.run(rng, n_iters=4)
    calls = []

    def singular(self, cfgs, idxs, costs):
        calls.append(len(idxs))
        raise np.linalg.LinAlgError("singular")

    monkeypatch.setattr(TModelTuner, "_eval_arx_bucket", singular)
    tuner, rng = _port_tuner(data, MT_SEED, factories=("ARXFactory",))
    _, got = tuner.run(rng, n_iters=4)
    assert calls == [4]
    assert _dicts(got.cfgs) == _dicts(ref.cfgs) and got.costs == ref.costs


@pytest.mark.parametrize("error, scored_inf", [(ValueError, True), (FloatingPointError, True),
                                               (RuntimeError, False),
                                               (NotPortedError, False)])
def test_a_candidate_error_is_inf_only_for_a_bad_candidate(data, error, scored_inf):
    class Failing(tsysid.ARXFactory):
        def __call__(self, cfg, trajs, **kw):
            raise error("a candidate that fails")

    rng = np.random.default_rng(0)
    ev = THoldout(system=data["ts"], trajs=data["tl"][:8], metric="rmse", rng=rng)
    tuner = TModelTuner(data["ts"], ev, use_bucketed=False)
    tuner.add_model_factory(Failing(data["ts"], device="cpu"))
    cfg = tuner._build_space().get_default_configuration()
    if scored_inf:
        assert tuner._evaluate(cfg) == float("inf")
    else:
        with pytest.raises(error, match="a candidate that fails"):
            tuner._evaluate(cfg)
