"""The "joint_koopman" tune's sequential objective against its fan-out
(``chip_smoke.py`` phase 15 (d)'s check) on the CPU, in float64 and in
float32, to tell a fault from float32 at a knife edge.

Phase 15 (d) scores SEQ_ITERS candidates of the KoopmanFactory space
(trig basis, the lift (12, 1)) both ways on a 25-step near-upright task
with a quadratic task cost; on the card one candidate of four came out
1.3e-2 apart (2.6e-2 in a second run) where the others agreed within
1.7e-7. This script repeats the check with the cartpole's data drawn on
the CPU (50 x 100, seed 42: the card draws other numbers from the same
seed, so the candidates' models differ from the card's) and the same
candidates (the tuner's asks from seed 3):

- float64: the sequential objective and the fan-out at the tune's batch;
- float32 (the port's CUDA dtype, forced on the CPU): the sequential
  objective, the fan-out at batch 1 (each candidate alone) and at the
  tune's batch.

Prints each candidate's scores, the relative gaps, and per route its
distance from float64.

Run (on the CPU):
    python3 tools/torch_koopman_seq_check.py [--iters N] [--steps N]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--steps", type=int, default=25)
    args = ap.parse_args(argv)

    import autompc_torch
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark
    from autompc_torch.control import IterativeLQRFactory
    from autompc_torch.core.trajectory import TrajectoryBatch
    from autompc_torch.costs import QuadCost, QuadCostFactory
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.sysid import KoopmanFactory, SINDy
    from autompc_torch.tuning import PipelineTuner

    kw = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
              trig_interaction=True, time_mode="discrete")
    bench = CartpoleSwingupBenchmark()
    trajs = bench.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100, device="cpu")
    system, goal = bench.system, np.zeros(4)

    def scores(dtype, **fkw):
        """The candidates' scores with every tensor of the port in
        ``dtype`` on the CPU (the models, the fits, the solves)."""
        real = autompc_torch.default_dtype.__code__
        autompc_torch.default_dtype.__code__ = (
            (lambda device: torch.float32).__code__ if dtype == torch.float32 else real)
        try:
            data = TrajectoryBatch(system, trajs.obs.to(dtype), trajs.ctrls.to(dtype),
                                   trajs.lengths)
            model = SINDy(system, device="cpu", **kw)
            model.train(data)
            task = bench.task.copy()
            task.set_cost(QuadCost(system, Q=np.eye(4), R=0.01 * np.eye(1), F=np.eye(4),
                                   goal=goal))
            task.set_init_obs(np.array([0.5, 0.0, 0.0, 0.0]))
            task.set_num_steps(args.steps)
            pipe = Pipeline(system, KoopmanFactory(system, poly_basis="false", trig_basis="true",
                                                   trig_freq=1, device="cpu"),
                            QuadCostFactory(system, goal=goal),
                            IterativeLQRFactory(system, horizon=10))
            batch = fkw.pop("batch", args.iters)
            res = PipelineTuner(surrogate_mode="pretrain", eval_batch=batch, **fkw).run(
                pipe, task, data, n_iters=args.iters, rng=np.random.default_rng(3),
                surrogate=model)[1]
            return res.cfgs, np.array(res.costs, dtype=np.float64)
        finally:
            autompc_torch.default_dtype.__code__ = real

    fan = dict(use_fanout=True, fanout_backward="pallas")
    runs = {
        "float64 sequential": scores(torch.float64),
        "float64 fan-out": scores(torch.float64, **fan),
        "float32 sequential": scores(torch.float32),
        "float32 fan-out, batch 1": scores(torch.float32, batch=1, **fan),
        f"float32 fan-out, batch {args.iters}": scores(torch.float32, **fan),
    }
    cfgs = runs["float64 sequential"][0]
    ref = runs["float64 sequential"][1]
    for i, c in enumerate(cfgs):
        d = c.get_dictionary()
        print(f"candidate {i}: method {d.get('_model:method')}, "
              + ", ".join(f"{k} {float(v[1][i])!r}" for k, v in runs.items()), flush=True)
    for name, (cs_, sc) in runs.items():
        same = [c.get_dictionary() for c in cs_] == [c.get_dictionary() for c in cfgs]
        gap = np.abs(sc - ref) / np.maximum(np.abs(ref), 1e-30)
        print(f"{name}: same configurations {same}; relative distance from float64 "
              f"sequential per candidate {np.array2string(gap, precision=3)}", flush=True)
    a, b = runs["float64 sequential"][1], runs["float64 fan-out"][1]
    print(f"float64 sequential vs fan-out, largest relative gap "
          f"{float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))):.3e}", flush=True)


if __name__ == "__main__":
    main()
