"""The port's bucket evaluators (tuning/bucketed.py) against the JAX
package's and against the port's own per-configuration training, float64
on the CPU, on cartpole data of 12 x 30 (9 trajectories trained on, 3
held out).

(a) ARX (kmax 4, horizon 2, k = 1 through kmax): the holdout RMSEs and
    the program's companion matrices against JAX's (rel 1e-8), and each
    candidate against ARX(history=k) trained alone and scored by
    get_model_rmse (1e-8);
(b) SINDy, lstsq and lasso (discrete) and lstsq in continuous time, on a
    15-term library: against JAX's bucket and against SINDy trained
    alone (1e-8);
(c) Koopman lasso: against JAX's bucket and against Koopman trained alone
    (1e-8);
(d) MLP (2 x tanh, max_width 16, 2 epochs): against JAX's bucket given
    JAX's initial nets and epoch orders through the ``init_nets``/
    ``perms`` seams (JAX draws them from jax.random, which the port cannot
    reproduce; this file rebuilds JAX's key schedule), and against MLP
    trained alone with the same seed (1e-8); a sigmoid net, whose masked
    units are 0.5 and not 0, equals its unpadded net too.
"""

import jax
import numpy as np
import pytest
import torch

from autompc_torch.benchmarks import CartpoleSwingupBenchmark as TBench
from autompc_torch.evaluation import get_model_rmse
from autompc_torch.sysid import ARX, MLP, SINDy, Koopman
from autompc_torch.tuning import bucketed as tbk
from autompc_tpu import from_arrays as j_from_arrays
from autompc_tpu.benchmarks import CartpoleSwingupBenchmark as JBench
from autompc_tpu.tuning import bucketed as jbk

torch.set_num_threads(1)

TOL = 1e-8
SINDY_CFG = dict(method="lstsq", time_mode="discrete", trig_basis="true", trig_freq=1,
                 trig_interaction="false", poly_basis="false", poly_degree=3,
                 poly_cross_terms="false")
KOOPMAN_CFG = dict(poly_basis="false", poly_degree=3, trig_basis="true", trig_freq=1,
                   product_terms="false")


@pytest.fixture(scope="module")
def data():
    jb, tb = JBench(), TBench()
    tl = tb.gen_trajs_batch(seed=3, n_trajs=12, traj_len=30, device="cpu").to_list()
    jl = [j_from_arrays(jb.system, t.obs.numpy(), t.ctrls.numpy()) for t in tl]
    return dict(js=jb.system, ts=tb.system, jtr=jl[:9], jho=jl[9:], tr=tl[:9], ho=tl[9:])


def _close(got, ref, tol=TOL):
    assert len(got) == len(ref) and all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=0)


# ---- (a) ARX -----------------------------------------------------------------

KS = [1, 2, 3, 4]


def test_arx_bucket_matches_jax(data):
    d = data
    got = tbk.ARXBucketEvaluator(d["ts"], d["tr"], d["ho"], kmax=4, horizon=2)(KS)
    _close(got, jbk.ARXBucketEvaluator(d["js"], d["jtr"], d["jho"], kmax=4, horizon=2)(KS))
    # The program's (A, B) of every candidate.
    from autompc_torch.core.trajectory import batch as t_batch
    from autompc_tpu.core.trajectory import batch as j_batch

    masks = np.stack([tbk._arx_feature_col_mask(4, 1, 4, k) for k in KS])
    np.testing.assert_array_equal(masks, np.stack([jbk._arx_feature_col_mask(4, 1, 4, k)
                                                   for k in KS]))
    jt, jh, tt, th = (j_batch(d["jtr"]), j_batch(d["jho"]), t_batch(d["tr"]), t_batch(d["ho"]))
    ref = jbk.make_arx_bucket_program(d["js"], 4, horizon=2)(
        jt.obs, jt.ctrls, jt.step_mask(), jh.obs, jh.ctrls, jh.lengths, masks)
    out = tbk.make_arx_bucket_program(d["ts"], 4, horizon=2, device="cpu")(
        tt.obs, tt.ctrls, tt.step_mask(), th.obs, th.ctrls, th.lengths, torch.as_tensor(masks))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)


def test_arx_bucket_matches_per_config_training(data):
    d = data
    got = tbk.ARXBucketEvaluator(d["ts"], d["tr"], d["ho"], kmax=4, horizon=2)(KS)
    for k, rmse in zip(KS, got):
        model = ARX(d["ts"], history=k, device="cpu")
        model.train(d["tr"])
        assert rmse == pytest.approx(get_model_rmse(model, d["ho"], horizon=2), rel=TOL), k


# ---- (b) SINDy and (c) Koopman lasso ----------------------------------------

SINDY_CASES = [("lstsq", "discrete", [1e-3, 1e-1]), ("lasso", "discrete", [1e-4, 1e-2]),
               ("lstsq", "continuous", [1e-3, 1e-1])]


@pytest.mark.parametrize("method, time_mode, regs", SINDY_CASES)
def test_sindy_bucket_matches_jax(data, method, time_mode, regs):
    d, cfg = data, dict(SINDY_CFG, method=method, time_mode=time_mode)
    got = tbk.SINDyBucketEvaluator(d["ts"], d["tr"], d["ho"], cfg, horizon=2)(regs)
    _close(got, jbk.SINDyBucketEvaluator(d["js"], d["jtr"], d["jho"], cfg, horizon=2)(regs))


@pytest.mark.parametrize("method, time_mode, regs", SINDY_CASES)
def test_sindy_bucket_matches_per_config_training(data, method, time_mode, regs):
    d, cfg = data, dict(SINDY_CFG, method=method, time_mode=time_mode)
    got = tbk.SINDyBucketEvaluator(d["ts"], d["tr"], d["ho"], cfg, horizon=2)(regs)
    for reg, rmse in zip(regs, got):
        model = SINDy(d["ts"], device="cpu",
                      **dict(cfg, **{"lasso_alpha" if method == "lasso" else "threshold": reg}))
        model.train(d["tr"])
        assert rmse == pytest.approx(get_model_rmse(model, d["ho"], horizon=2), rel=TOL), reg


ALPHAS = [1e-6, 1e-3]


def test_koopman_lasso_bucket_matches_jax(data):
    d = data
    got = tbk.KoopmanLassoBucketEvaluator(d["ts"], d["tr"], d["ho"], KOOPMAN_CFG,
                                          horizon=2)(ALPHAS)
    _close(got, jbk.KoopmanLassoBucketEvaluator(d["js"], d["jtr"], d["jho"], KOOPMAN_CFG,
                                                horizon=2)(ALPHAS))


def test_koopman_lasso_bucket_matches_per_config_training(data):
    d = data
    got = tbk.KoopmanLassoBucketEvaluator(d["ts"], d["tr"], d["ho"], KOOPMAN_CFG,
                                          horizon=2)(ALPHAS)
    for alpha, rmse in zip(ALPHAS, got):
        model = Koopman(d["ts"], method="lasso", lasso_alpha=alpha, device="cpu", **KOOPMAN_CFG)
        model.train(d["tr"])
        assert rmse == pytest.approx(get_model_rmse(model, d["ho"], horizon=2), rel=TOL), alpha


# ---- (d) MLP -----------------------------------------------------------------

MAXW, NB, EPOCHS, SEED = 16, 32, 2, 100
WIDTHS, LRS = [[8, 16], [16, 4], [16, 16]], [1e-2, 3e-3, 3e-2]


def jax_mlp_draws(seed, n_rows, n_batch, n_epochs, nxu, nx, width_lists, max_width):
    """JAX's initial nets (padded, one a candidate) and epoch orders for
    ``seed``, by the key schedule of its MLP bucket (and of MLP.train):
    ``key, k_init = split(PRNGKey(seed))``, then one ``split`` of ``key``
    an epoch."""
    key, k_init = jax.random.split(jax.random.PRNGKey(seed))
    nets = [jbk._mlp_padded_init(k_init, nxu, nx, w, max_width) for w in width_lists]
    init = [{k: np.stack([np.asarray(net[i][k]) for net in nets]) for k in ("W", "b")}
            for i in range(len(nets[0]))]
    n_used = max(n_rows // n_batch, 1) * n_batch
    perms = []
    for _ in range(n_epochs):
        key, kp = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(kp, n_rows)[:n_used]))
    return init, perms


def _mlp_buckets(d, L=2, nonlin="tanh"):
    kw = dict(horizon=1, max_width=MAXW, n_train_iters=EPOCHS, n_batch=NB, seed=SEED)
    return (jbk.MLPBucketEvaluator(d["js"], d["jtr"], d["jho"], L, nonlin, **kw),
            tbk.MLPBucketEvaluator(d["ts"], d["tr"], d["ho"], L, nonlin, **kw))


def test_mlp_bucket_matches_jax(data):
    jbucket, tbucket = _mlp_buckets(data)
    init, perms = jax_mlp_draws(SEED, tbucket._XUt.shape[0], NB, EPOCHS, 5, 4, WIDTHS, MAXW)
    got = tbucket(WIDTHS, LRS, init_nets=init, perms=perms)
    _close(got, jbucket(WIDTHS, LRS))


def _per_config_mlp(d, widths, lr, nonlin):
    model = MLP(d["ts"], n_hidden_layers=len(widths), nonlintype=nonlin, lr=lr,
                n_train_iters=EPOCHS, n_batch=NB, seed=SEED, device="cpu",
                **{f"hidden_size_{i + 1}": w for i, w in enumerate(widths)})
    model.train(d["tr"])
    return get_model_rmse(model, d["ho"], horizon=1)


def test_mlp_bucket_matches_per_config_training(data):
    """Each lane starts from the net MLP draws for the seed and takes
    MLP.train's epoch orders: the bucket is the per-config run."""
    _, tbucket = _mlp_buckets(data)
    for widths, lr, rmse in zip(WIDTHS, LRS, tbucket(WIDTHS, LRS)):
        assert rmse == pytest.approx(_per_config_mlp(data, widths, lr, "tanh"), rel=TOL)


def test_mlp_sigmoid_masking_is_exact(data):
    """sigmoid(0) = 0.5 on a masked unit: the in-forward weight masks
    must still make the padded net the small one."""
    _, tbucket = _mlp_buckets(data, L=1, nonlin="sigmoid")
    got = tbucket([[11]], [1e-2])
    assert got[0] == pytest.approx(_per_config_mlp(data, [11], 1e-2, "sigmoid"), rel=TOL)
