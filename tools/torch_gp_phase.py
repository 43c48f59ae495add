"""``chip_smoke.py``'s phase 16 (the approximate GP: the SVGP model, the
fixed-GP and joint-GP fan-outs, the tuner's kind "joint_gp"; the pendulum
with its data-generation signals and BASELINE.json configs[2]) alone, on
the card, with phase [3]'s checks of K6 and K4 at (ds, dc) = (4, 1) on the
GP path.

Builds the kernels, fits phase 2's model (the main path's data, 50 x 100,
seed 42, the 55-term library: the fan-outs' surrogate), then runs
``chip_smoke.py::gp_phase`` ((a)-(c')), ``gp_tune`` ((d)),
``pendulum_phase`` ((e)) and ``check_gp_kernels``, and prints the two
report rows as JSON. The quick way to iterate on phase 16 without the
rest of the script.

Run (on the card):
    python3 tools/torch_gp_phase.py [--no-tune] [--no-pendulum]
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
    from autompc_torch.ops import cuda_riccati_general as K4
    from autompc_torch.sysid import SINDy

    ap = argparse.ArgumentParser()
    ap.add_argument("--no-tune", action="store_true")
    ap.add_argument("--no-pendulum", action="store_true")
    args = ap.parse_args()
    dev = cs.check_device()
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"[1] build/load kernels: {time.perf_counter() - t0:.2f} s", flush=True)
    bench = CartpoleSwingupBenchmark()
    trajs = bench.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(bench.system, **cs.SINDY_KW)
    model.train(trajs)
    t0 = time.perf_counter()
    gpd = cs.gp_phase(bench, model, trajs, dev, card, K6, K4)
    gpd["tune_by_B"] = {} if args.no_tune else cs.gp_tune(bench, model, trajs, card, K6)
    gpd["init"] = bench.task.get_init_obs()
    if not args.no_pendulum:
        cs.pendulum_phase(dev, card)
    print(f"[16] phase wall {time.perf_counter() - t0:.2f} s", flush=True)
    rows, failures = cs.check_gp_kernels(gpd, K6, K4, bench.system.dt)
    for row in rows:
        print(json.dumps(row))
    if failures:
        raise RuntimeError("; ".join(failures))


if __name__ == "__main__":
    main()
