"""The cartpole tune's incumbent through both closed loops of the port.

``chip_smoke.py`` phase 10 scores every candidate of its tune with the
fan-out (``QuadCostFanout`` through ``PipelineTuner._eval_batch_fanout``,
the true dynamics as a ``FunctionModel`` surrogate) and returns the
incumbent as a single-lane ``IterativeLQR``, which ``simulate`` runs on
the true dynamics. This tool scores one configuration both ways from the
canonical start, with the task metric (steps outside the 0.2 box), and
says whether the two closed loops agree and where they part. ``--batch
N ...`` scores the incumbent as the first lane of a fan-out batch of N,
the other N - 1 lanes configurations drawn from the pipeline's space
(``default_rng(0)``), as a tune's round puts it among others; it also
says whether the model's step and the true dynamics give a state the
same bits alone and in a batch of N.

On the CPU it runs in float64 (the kernels' plain versions), on the card
in float32 (the kernels). The model is the SINDy fit that
``chip_smoke.py`` wrote to ``chiprun_out/tune_incumbent.json`` (its
coefficients, the incumbent's configuration and its scores on the card),
so the CPU replays the card's model and configuration.

``--carry-ab`` also times ``simulate`` with the single-lane solver's two
first carries (the Jacobians of every point in one autodiff call after
the rollout, ``jacfwd_pred_diff``'s default, against one call a point
during the rollout), in the order A B B A, and checks that both give the
same trajectory.

Run:
    python3 tools/torch_incumbent_check.py --device cpu [--dump FILE] [--batch 1 128]
    python3 tools/torch_incumbent_check.py --device cuda --batch 1 128 --carry-ab
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from autompc_torch import default_dtype  # noqa: E402
from autompc_torch.benchmarks import CartpoleSwingupBenchmark  # noqa: E402
from autompc_torch.control import IterativeLQRFactory  # noqa: E402
from autompc_torch.control import ilqr  # noqa: E402
from autompc_torch.costs import QuadCostFactory  # noqa: E402
from autompc_torch.pipeline import Pipeline  # noqa: E402
from autompc_torch.sysid import SINDy, FunctionModel  # noqa: E402
from autompc_torch.tuning import PipelineTuner  # noqa: E402
from autompc_torch.utils import simulate  # noqa: E402

DEFAULT_DUMP = os.path.join("chiprun_out", "tune_incumbent.json")


def load(dump, device):
    """(benchmark, model, pipeline, incumbent configuration, the dump)."""
    with open(dump) as f:
        rec = json.load(f)
    bench = CartpoleSwingupBenchmark()
    # The task's length as the tune ran it (older dumps: the task's own).
    bench.task.set_num_steps(rec.get("num_steps", bench.task.get_num_steps()))
    model = SINDy(bench.system, device=device, **rec["sindy"])
    model.set_parameters({"coeffs": np.asarray(rec["coeffs"]),
                          "feature_names": rec["feature_names"]})
    pipeline = Pipeline(bench.system, model, QuadCostFactory(bench.system, goal=np.zeros(4)),
                        IterativeLQRFactory(bench.system, **rec["factory"]))
    cfg = pipeline.get_configuration_space().configuration_from_dict(rec["cfg"])
    return bench, model, pipeline, cfg, rec


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_simulate(bench, pipeline, cfg, device):
    """The incumbent as the tuner returns it, run by simulate:
    (task cost, trajectory, seconds)."""
    task = bench.task
    controller = pipeline(cfg, task, None)[0]
    sync(device)
    t0 = time.perf_counter()
    traj = simulate(controller, task.get_init_obs(), term_cond=task.term_cond,
                    dynamics=bench.dynamics, max_steps=task.get_num_steps())
    sync(device)
    return float(task.get_cost()(traj)), traj, time.perf_counter() - t0


def run_fanout(bench, model, pipeline, cfg, rec, device, batch=1):
    """The tuner's own true-dynamics fan-out on this candidate, the first
    of ``batch``: (its task cost, seconds)."""
    tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=1, use_fanout=True,
                          fanout_backward="pallas", fanout_feature_kernels=True,
                          fanout_compact=tuple(tuple(s) for s in rec["compact"]))
    oracle = FunctionModel(bench.system, bench.dynamics)
    others = pipeline.get_configuration_space().sample_configuration(
        np.random.default_rng(0), size=batch - 1) if batch > 1 else []
    sync(device)
    t0 = time.perf_counter()
    cost = tuner._eval_batch_fanout(pipeline, bench.task, oracle, [cfg] + list(others), {},
                                    "ilqr")[0]
    sync(device)
    return float(cost), time.perf_counter() - t0


def batch_bits(bench, model, device, n):
    """Whether one step of the model and of the true dynamics gives each
    of n states the same bits alone as in one batched call."""
    rng = np.random.default_rng(0)
    like = dict(dtype=default_dtype(device), device=device)
    X = torch.as_tensor(rng.normal(size=(n, 4)), **like)
    U = torch.as_tensor(rng.normal(size=(n, 1)), **like)
    steps = (("SINDy pred_core", lambda x, u: model.pred_core(model.params, x, u)),
             ("true dynamics", bench.dynamics))
    for name, f in steps:
        together = f(X, U)
        alone = torch.cat([f(X[i:i + 1], U[i:i + 1]) for i in range(n)])
        print(f"{name}: {n} states alone and in one batch equal bit for bit "
              f"{torch.equal(alone, together)}; largest difference "
              f"{float((alone - together).abs().max()):.3e}", flush=True)


def first_parting(a, b):
    """The first step whose observations differ, and by how much."""
    d = (a.obs - b.obs).abs().amax(dim=1)
    idx = torch.nonzero(d > 0)
    return (None, 0.0) if idx.numel() == 0 else (int(idx[0]), float(d.max()))


def carry_ab(bench, pipeline, cfg, device):
    """simulate with the all-points first carry (A) and the per-point
    one (B), in the order A B B A."""
    real = ilqr.jacfwd_pred_diff

    def per_point(pred_core, ds):
        f = real(pred_core, ds)
        f.all_points = False
        return f

    out = []
    try:
        for mode in "ABBA":
            ilqr.jacfwd_pred_diff = real if mode == "A" else per_point
            cost, traj, secs = run_simulate(bench, pipeline, cfg, device)
            out.append((mode, cost, traj, secs))
    finally:
        ilqr.jacfwd_pred_diff = real
    for mode, cost, traj, secs in out:
        print(f"carry {mode}: simulate {len(traj) - 1} steps {secs:.3f} s, task cost {cost}",
              flush=True)
    step, gap = first_parting(out[0][2], out[1][2])
    same = all(torch.equal(o[2].obs, out[0][2].obs) for o in out)
    print(f"carry A vs B: trajectories equal {same}; first differing step {step}, "
          f"largest difference {gap:.3e}", flush=True)
    return {"A_s": [o[3] for o in out if o[0] == "A"], "B_s": [o[3] for o in out if o[0] == "B"],
            "equal": same}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dump", default=DEFAULT_DUMP)
    ap.add_argument("--carry-ab", action="store_true")
    ap.add_argument("--batch", type=int, nargs="+", default=[1])
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(), flush=True)
    bench, model, pipeline, cfg, rec = load(args.dump, device)
    print(f"{device} {default_dtype(device)}; configuration {rec['cfg']} with "
          f"{rec['factory']}; on the card: simulate {rec['card']['simulate']}, fan-out "
          f"{rec['card']['fanout_truedyn']} (surrogate {rec['card']['fanout_surrogate']})",
          flush=True)
    sim_cost, traj, sim_s = run_simulate(bench, pipeline, cfg, device)
    print(f"simulate: task cost {sim_cost} ({sim_s:.2f} s); final state "
          f"{[round(float(v), 4) for v in traj.obs[-1]]}", flush=True)
    result = {"device": str(device), "dtype": str(default_dtype(device)),
              "simulate": sim_cost, "fanout_truedyn": {}}
    for n in args.batch:
        fan_cost, fan_s = run_fanout(bench, model, pipeline, cfg, rec, device, batch=n)
        print(f"fan-out, the incumbent the first of {n}: task cost {fan_cost} ({fan_s:.2f} s)",
              flush=True)
        result["fanout_truedyn"][n] = fan_cost
        if n > 1:
            batch_bits(bench, model, device, n)
    if args.carry_ab:
        result["carry_ab"] = carry_ab(bench, pipeline, cfg, device)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
