"""Where the pendulum's recovery task should start, on the CPU: from
which starts the outcome of a closed loop depends on the controller's
cost, so that a tune's candidates and a loop's lanes score differently.

The torque bound (+-2) holds the pole at rest within asin(2 / 9.8) =
0.21 rad of upright. For each start of ``--starts`` this script runs one
round of the "ilqr" tune (16 candidates, H=20, ``--steps`` - 1 steps, the
fan-out through the kernels' plain versions, the pendulum's SINDy as the
surrogate and the true dynamics scored beside it) and prints each
candidate's score (steps outside the task's 0.2 box); then the receding
loop (Q = F = diag(10, 0.1), R = 0.001, H=20, 100 steps) from theta in
[-1.5, 1.5] at rest, and whether each lane ends in the box. The data are
the pendulum's 50 x 100 trajectories, seed 42, drawn on the CPU, float64.

Run (on the CPU, ~1 min):
    python3 tools/torch_pendulum_recovery_probe.py [--starts 0.15,0;0.2,0;0.25,0]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--starts", default="0.15,0;0.2,0;0.25,0;0.2,0.3;0.1,0.5")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from autompc_torch.benchmarks import PendulumSwingupBenchmark
    from autompc_torch.control import IterativeLQRFactory, make_receding_ilqr_loop
    from autompc_torch.costs import QuadCost, QuadCostFactory
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.sysid import SINDy
    from autompc_torch.tuning import PipelineTuner

    pb = PendulumSwingupBenchmark()
    trajs = pb.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100, device="cpu")
    model = SINDy(pb.system, device="cpu", **cs.SINDY_KW)
    model.train(trajs)
    for start in args.starts.split(";"):
        x0 = tuple(float(v) for v in start.split(","))
        pipe = Pipeline(pb.system, model, QuadCostFactory(pb.system, goal=np.zeros(2)),
                        IterativeLQRFactory(pb.system, horizon=20))
        _, res = PipelineTuner(surrogate_mode="pretrain", eval_batch=16, use_fanout=True,
                               fanout_backward="pallas", fanout_feature_kernels=True,
                               fanout_compact=cs.TUNE_COMPACT).run(
            pipe, pb.recovery_task(init_obs=x0, num_steps=args.steps), trajs, n_iters=16,
            rng=np.random.default_rng(100), surrogate=model, truedyn=pb.dynamics)
        print(f"tune from {x0}: surrogate scores {np.round(res.costs, 1).tolist()}, true "
              f"dynamics {np.round(res.truedyn_costs, 1).tolist()}", flush=True)

    coeffs = model.coeffs.numpy()
    active = tuple(int(k) for k in np.flatnonzero(np.any(coeffs != 0, axis=0)))
    qd = np.diag(cs.PD_Q)
    bounds = pb.task.get_ctrl_bounds()
    run = make_receding_ilqr_loop(
        model.pred_core, QuadCost(pb.system, qd, cs.PD_R * np.eye(1), qd, goal=np.zeros(2)),
        pb.dynamics, H=20, n_steps=100, ds=2, dc=1, obsdim=2, dt=pb.system.dt,
        ubounds=(bounds[:, 0], bounds[:, 1]), backward="pallas",
        feature_spec=(model.library, "coeffs"), fuse_ls=True, lanes_last=True,
        feature_mask=active)
    theta = np.linspace(-1.5, 1.5, 31)
    xs = run(model.params, torch.tensor(np.stack([theta, np.zeros_like(theta)], 1)))[0]
    fx = xs[:, -1]
    box = ((fx[:, 0].abs() < 0.2) & (fx[:, 1].abs() < 0.2)).tolist()
    print("receding loop from theta at rest, ending in the box: "
          + ", ".join(f"{t:+.1f} {'in' if b else 'out'}" for t, b in zip(theta, box)), flush=True)


if __name__ == "__main__":
    main()
