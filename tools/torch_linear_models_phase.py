"""``chip_smoke.py``'s phase 15 (the linear models: ARX + LQR, Koopman +
direct transcription, the joint-Koopman fan-out, the tuner's kinds
"joint_arx" and "joint_koopman") alone, on the card, with phase [3]'s
check of K6 at (ds, dc) = (12, 1) on (c2)'s carry.

Builds the kernels, fits phase 2's model (the main path's data, 50 x 100,
seed 42, the 55-term library: the fan-outs' surrogate), then runs
``chip_smoke.py::linear_models_phase`` ((a)-(c)), ``linear_tunes`` ((d))
and ``check_k6_wide``, and prints K6's report row as JSON. The quick way
to iterate on phase 15 without the rest of the script.

Run (on the card):
    python3 tools/torch_linear_models_phase.py [--no-tune]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import chip_smoke as cs
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark
    from autompc_torch.ops import _build
    from autompc_torch.ops import cuda_riccati as K6
    from autompc_torch.sysid import SINDy

    ap = argparse.ArgumentParser()
    ap.add_argument("--no-tune", action="store_true")
    args = ap.parse_args()
    dev = cs.check_device()
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"[1] build/load kernels: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, regs, spill in cs.ptxas_report(_build.build_log()):
        if name.startswith("backward_quad_bm"):
            print(f"    ptxas: {name}: {regs} registers, {spill} bytes spilled", flush=True)
    bench = CartpoleSwingupBenchmark()
    trajs = bench.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(bench.system, **cs.SINDY_KW)
    model.train(trajs)
    t0 = time.perf_counter()
    lm = cs.linear_models_phase(bench, model, trajs, dev, card, K6)
    tune_by_B = {} if args.no_tune else cs.linear_tunes(bench, model, trajs, card, K6)
    print(f"[15] phase wall {time.perf_counter() - t0:.2f} s", flush=True)
    row, failures = cs.check_k6_wide(lm, K6, bench.system.dt, tune_by_B)
    print(json.dumps(row))
    if failures:
        raise RuntimeError("; ".join(failures))


if __name__ == "__main__":
    main()
