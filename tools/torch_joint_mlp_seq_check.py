"""The "joint_mlp" tune's sequential objective against its fan-out on the
pendulum's recovery task (``chip_smoke.py`` phase 19 (b)'s check), on
the CPU, in float64 and in float32, at several training lengths.

The fan-out trains each candidate's net in a lane of masked max-width
weights (``JointMLPQuadCostFanout``); the sequential objective trains
each candidate's ``MLP`` unpadded (``MLPFactory``). They are one function:
in float64 the two scores agree to ~1e-12. In float32 their roundings
differ, and each training epoch carries the difference further; a closed
loop then amplifies a small difference in the net into a different
score. This script prints, for each dtype and number of epochs, each of
the four candidates' two scores (the tuner's asks from seed 3, the
recovery task at ``DS_SEQ_STEPS`` steps with a quadratic task cost, the
pendulum's data drawn on the CPU, 50 x 100, seed 42) and how many agree
within ``SEQ_TOL``.

Run (on the CPU, ~1 min a row):
    python3 tools/torch_joint_mlp_seq_check.py [--epochs 1,3,20] [--dtypes float64,float32]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", default="1,3,20")
    ap.add_argument("--dtypes", default="float64,float32")
    args = ap.parse_args(argv)

    import autompc_torch
    import chip_smoke as cs
    from autompc_torch.benchmarks import PendulumSwingupBenchmark
    from autompc_torch.control import IterativeLQRFactory
    from autompc_torch.costs import QuadCost, QuadCostFactory
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.sysid import MLPFactory, SINDy

    real_device, real_dtype = (autompc_torch.resolve_device.__code__,
                               autompc_torch.default_dtype.__code__)

    def on_cpu(device=None):
        return torch.device("cpu") if device is None else torch.device(device)

    autompc_torch.resolve_device.__code__ = on_cpu.__code__
    try:
        for name in args.dtypes.split(","):
            if name == "float32":
                autompc_torch.default_dtype.__code__ = (lambda device: torch.float32).__code__
            else:
                autompc_torch.default_dtype.__code__ = real_dtype
            pb = PendulumSwingupBenchmark()
            trajs = pb.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
            surrogate = SINDy(pb.system, **cs.SINDY_KW)
            surrogate.train(trajs)
            system = pb.system
            task = pb.recovery_task(num_steps=cs.DS_SEQ_STEPS)
            task.set_cost(QuadCost(system, Q=np.eye(2), R=0.01 * np.eye(1), F=np.eye(2),
                                   goal=np.zeros(2)))
            for epochs in (int(e) for e in args.epochs.split(",")):
                pipe = Pipeline(system, MLPFactory(system, n_train_iters=epochs, **cs.JM_PIN),
                                QuadCostFactory(system, goal=np.zeros(2)),
                                IterativeLQRFactory(system))
                agree, same = cs.seq_against_fanout(f"{name}, {epochs} epochs", pipe, task,
                                                    trajs, cs.DS_TUNE_ITERS, surrogate=surrogate)
                print(f"{name}, {epochs} training epochs: {agree} of {cs.DS_TUNE_ITERS} within "
                      f"{cs.SEQ_TOL}; same configurations {same}", flush=True)
    finally:
        autompc_torch.resolve_device.__code__ = real_device
        autompc_torch.default_dtype.__code__ = real_dtype


if __name__ == "__main__":
    main()
