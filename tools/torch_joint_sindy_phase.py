"""``chip_smoke.py``'s phase 12 (the joint-SINDy fan-out and tune) alone,
on the card.

Builds the kernels, fits phase 2's model (the main path's data, 50 x 100,
seed 42, the 55-term library), then runs ``chip_smoke.py::
joint_sindy_phase`` ((a) and (b) at bench_scaling.py's joint cell, the
105-term library through both) and ``joint_sindy_tune`` ((c)) with the
tune's depth set from the command line. The kernel checks of phase 12
run only in ``chip_smoke.py`` (its phase [3]). The quick way to iterate
on phase 12's drivers and timings without the rest of the script.

Run (on the card):
    python3 tools/torch_joint_sindy_phase.py [--iters 32] [--batch 16] [--steps 30] [--seed 4] [--profile]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import chip_smoke as cs
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark
    from autompc_torch.ops import _build
    from autompc_torch.ops import cuda_linesearch as K3
    from autompc_torch.ops import cuda_relin as K1
    from autompc_torch.ops import cuda_riccati as K2
    from autompc_torch.sysid import SINDy

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=cs.JS_TUNE_ITERS)
    ap.add_argument("--batch", type=int, default=cs.JS_TUNE_BATCH)
    ap.add_argument("--steps", type=int, default=cs.JS_TUNE_STEPS)
    ap.add_argument("--seed", type=int, default=cs.JS_TUNE_SEED)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    cs.JS_TUNE_ITERS, cs.JS_TUNE_BATCH = args.iters, args.batch
    cs.JS_TUNE_STEPS, cs.JS_TUNE_SEED = args.steps, args.seed

    dev = cs.check_device()
    card = cs.card_line()
    t0 = time.perf_counter()
    _build.library()
    print(f"{card}; kernels built or loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    bench = CartpoleSwingupBenchmark()
    trajs = bench.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(bench.system, **cs.SINDY_KW)
    model.train(trajs)
    wrappers = cs.joint_counters(K1, K2, K3)
    t0 = time.perf_counter()
    cs.joint_sindy_phase(bench, model, trajs, dev, card, wrappers, profile=args.profile)
    cs.joint_sindy_tune(bench, model, trajs, dev, card, wrappers["b"])
    print(f"[12] phase wall {time.perf_counter() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    main()
