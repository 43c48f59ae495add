"""The port's model metrics and evaluators against the JAX package's,
float64 on the CPU.

(a) get_model_rmse, get_model_rmsmens and get_model_rmse_batch at
    horizons 1 and 5 for SINDy, ARX (history 3, through
    ``traj_to_states``), Koopman (a lifted state) and a small MLP, the
    weights carried across by ``set_parameters``, one trajectory shorter
    than the others (the batch's masked steps): rel 1e-10;
(b) HoldoutModelEvaluator: the same held-out trajectories for the same
    numpy seed, the same score for a SINDy configuration, ``holdout_set``
    matched by value (``Trajectory.__eq__``), a score that is not finite
    as inf, an unknown metric raising;
(c) Trajectory.__eq__ against the JAX package's on equal and unequal
    pairs.

The data are made once by the port (CPU) and handed to both packages.
"""

import numpy as np
import pytest
import torch

from autompc_torch import from_arrays as t_from_arrays
from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.core.system import System as TSystem
from autompc_torch.evaluation import HoldoutModelEvaluator as THoldout
from autompc_torch.evaluation import get_model_rmse as t_rmse
from autompc_torch.evaluation import get_model_rmse_batch as t_rmse_batch
from autompc_torch.evaluation import get_model_rmsmens as t_rmsmens
from autompc_torch.sysid import ARX as TARX
from autompc_torch.sysid import MLP as TMLP
from autompc_torch.sysid import SINDy as TSINDy
from autompc_torch.sysid import Koopman as TKoopman
from autompc_torch.sysid import SINDyFactory as TSINDyFactory
from autompc_tpu import from_arrays as j_from_arrays
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.core.system import System as JSystem
from autompc_tpu.evaluation import HoldoutModelEvaluator as JHoldout
from autompc_tpu.evaluation import get_model_rmse as j_rmse
from autompc_tpu.evaluation import get_model_rmse_batch as j_rmse_batch
from autompc_tpu.evaluation import get_model_rmsmens as j_rmsmens
from autompc_tpu.sysid import ARX as JARX
from autompc_tpu.sysid import MLP as JMLP
from autompc_tpu.sysid import SINDy as JSINDy
from autompc_tpu.sysid import Koopman as JKoopman
from autompc_tpu.sysid import SINDyFactory as JSINDyFactory

torch.set_num_threads(1)

TOL = 1e-10
SINDY_KW = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
                trig_interaction=True)


def _pair_lists(jb, tb, tt):
    """The same trajectories in both packages, the last one cut to 22
    steps."""
    tl = tt.to_list()
    tl[-1] = tl[-1][:22]
    jl = [j_from_arrays(jb.system, t.obs.numpy(), t.ctrls.numpy()) for t in tl]
    return jl, tl


@pytest.fixture(scope="module")
def data():
    jb, tb = JBench(), TBench()
    tt = tb.gen_trajs_batch(seed=6, n_trajs=4, traj_len=30, device="cpu")
    jl, tl = _pair_lists(jb, tb, tt)
    return dict(jb=jb, tb=tb, jl=jl, tl=tl)


_MODELS = {}


def _models(d, name):
    """A model of each package with one set of parameters (the port's
    fit), made once a module."""
    if name in _MODELS:
        return _MODELS[name]
    js, ts = d["jb"].system, d["tb"].system
    if name == "sindy":
        j, t = JSINDy(js, **SINDY_KW), TSINDy(ts, device="cpu", **SINDY_KW)
    elif name == "arx":
        j, t = JARX(js, 3), TARX(ts, 3, device="cpu")
    elif name == "koopman":
        kw = dict(method="lstsq", trig_basis=True, trig_freq=1)
        j, t = JKoopman(js, **kw), TKoopman(ts, device="cpu", **kw)
    else:
        kw = dict(n_hidden_layers=2, hidden_size=8, nonlintype="tanh", n_train_iters=2,
                  n_batch=32)
        j, t = JMLP(js, **kw), TMLP(ts, device="cpu", **kw)
    t.train(d["tl"])
    j.set_parameters(t.get_parameters())
    _MODELS[name] = j, t
    return j, t


# ---- (a) the metrics -------------------------------------------------------


@pytest.mark.parametrize("horizon", [1, 5])
@pytest.mark.parametrize("name", ["sindy", "arx", "koopman", "mlp"])
def test_metrics_match_jax(data, name, horizon):
    j, t = _models(data, name)
    jl, tl = data["jl"], data["tl"]
    for jf, tf in ((j_rmse, t_rmse), (j_rmsmens, t_rmsmens)):
        ref, got = jf(j, jl, horizon=horizon), tf(t, tl, horizon=horizon)
        assert isinstance(got, float) and np.isfinite(ref)
        assert got == pytest.approx(ref, rel=TOL), jf.__name__
    ref, got = j_rmse_batch(j, jl, horizon=horizon), t_rmse_batch(t, tl, horizon=horizon)
    assert isinstance(got, torch.Tensor) and got.ndim == 0 and got.device.type == "cpu"
    assert float(got) == pytest.approx(float(ref), rel=TOL)
    # The batch masks the cut trajectory's padded steps: its score is the
    # list's (the reference's obs_dim scaling of the mean in both).
    assert float(got) == pytest.approx(t_rmse(t, tl, horizon=horizon), rel=1e-12)


# ---- (b) the holdout evaluator --------------------------------------------


def _evaluators(d, seed, **kw):
    return (JHoldout(system=d["jb"].system, trajs=d["jl"], metric="rmse",
                     rng=np.random.default_rng(seed), **kw),
            THoldout(system=d["tb"].system, trajs=d["tl"], metric="rmse",
                     rng=np.random.default_rng(seed), **kw))


def _same(jtrajs, ttrajs):
    assert len(jtrajs) == len(ttrajs)
    for j, t in zip(jtrajs, ttrajs):
        np.testing.assert_array_equal(t.obs.numpy(), np.asarray(j.obs))


@pytest.mark.parametrize("seed, prop", [(0, 0.25), (5, 0.5)])
def test_holdout_split_matches_jax(data, seed, prop):
    je, te = _evaluators(data, seed, holdout_prop=prop)
    assert len(te.holdout) == round(prop * len(data["tl"])) and te.metric_name == "rmse"
    _same(je.holdout, te.holdout)
    _same(je.training_set, te.training_set)


def test_holdout_score_matches_jax(data):
    je, te = _evaluators(data, 3, holdout_prop=0.25)
    jf, tf = JSINDyFactory(data["jb"].system), TSINDyFactory(data["tb"].system, device="cpu")
    jc, tc = (f.get_configuration_space().get_default_configuration() for f in (jf, tf))
    for k, v in dict(threshold=0.1, trig_basis="true", trig_interaction="true").items():
        jc[k], tc[k] = v, v
    assert te(tf, tc) == pytest.approx(je(jf, jc), rel=1e-8)


def test_holdout_set_is_matched_by_value(data):
    """Copies of trajectories 1 and 2 (new objects, equal values) hold
    those two out, as the JAX package's value equality does."""
    copies_t = [t_from_arrays(data["tb"].system, data["tl"][i].obs.clone(),
                              data["tl"][i].ctrls.clone()) for i in (1, 2)]
    copies_j = [j_from_arrays(data["jb"].system, np.asarray(data["jl"][i].obs),
                              np.asarray(data["jl"][i].ctrls)) for i in (1, 2)]
    je = JHoldout(system=data["jb"].system, trajs=data["jl"], metric="rmse",
                  rng=np.random.default_rng(0), holdout_set=copies_j)
    te = THoldout(system=data["tb"].system, trajs=data["tl"], metric="rmse",
                  rng=np.random.default_rng(0), holdout_set=copies_t)
    assert len(te.training_set) == len(data["tl"]) - 2
    _same(je.training_set, te.training_set)
    _same(je.holdout, te.holdout)


def test_a_score_that_is_not_finite_is_inf(data):
    tf = TSINDyFactory(data["tb"].system, device="cpu")
    cfg = tf.get_configuration_space().get_default_configuration()
    for value in (float("nan"), float("inf")):
        te = THoldout(system=data["tb"].system, trajs=data["tl"],
                      metric=lambda model, trajs, v=value: v, rng=np.random.default_rng(0))
        assert te(tf, cfg) == float("inf") and te.metric_name is None


def test_an_unknown_metric_raises(data):
    with pytest.raises(ValueError, match="Unknown metric"):
        THoldout(system=data["tb"].system, trajs=data["tl"], metric="mae",
                 rng=np.random.default_rng(0))


# ---- (c) Trajectory.__eq__ -------------------------------------------------


def test_trajectory_equality_matches_jax(data):
    tl, jl = data["tl"], data["jl"]
    other = (["a", "b", "c", "d"], ["f"])
    pairs = [
        (0, 0), (0, "copy"), (0, 1), (0, "cut"), (0, "changed"), (0, "system"),
        (0, None),
    ]

    def variants(pkg, i):
        trajs, sys_cls, fa = ((jl, JSystem, j_from_arrays) if pkg == "j"
                              else (tl, TSystem, t_from_arrays))
        t = trajs[0]
        obs, ctrls = np.array(t.obs), np.array(t.ctrls)
        changed = obs.copy()
        changed[3, 2] += 1e-9
        return {
            0: t, 1: trajs[1], "copy": fa(t.system, obs, ctrls), "cut": t[:10],
            "changed": fa(t.system, changed, ctrls),
            "system": fa(sys_cls(*other, dt=t.system.dt), obs, ctrls), None: "not a trajectory",
        }[i]

    for a, b in pairs:
        ref = variants("j", a) == variants("j", b)
        assert (variants("t", a) == variants("t", b)) is ref, (a, b)
    assert [p[1] for p in pairs if variants("t", p[0]) == variants("t", p[1])] == [0, "copy"]
    with pytest.raises(TypeError):
        hash(tl[0])
