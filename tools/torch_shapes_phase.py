"""``chip_smoke.py``'s phase 18 (the feature kernels off the cartpole's
shape: the pendulum's main path, closed loop, cost fan-out and "ilqr"
tune at (ds, dc) = (2, 1), the halfcheetah's SINDy through the
batch-major solve at (18, 6)) alone, on the card, uncut, with phase
[3]'s checks of the new instances.

Builds the kernels (the main library and phase 18's shapes at first use),
makes phase 6's cheetah data (24 x 40, seed 0), runs
``chip_smoke.py::shapes_phase`` with the fan-out at ``--fan-steps``
closed-loop steps (50, phase 8's, uncut; ``chip_smoke.py`` runs
``PD_FAN_STEPS``) and the closed loop at ``--loop-steps`` (200), then
``check_shape_kernels``, and prints each kernel's row as JSON. The quick
way to iterate on phase 18 without the rest of the script.

Run (on the card):
    python3 tools/torch_shapes_phase.py [--fan-steps N] [--loop-steps N] [--no-checks]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fan-steps", type=int, default=50)
    ap.add_argument("--loop-steps", type=int, default=200)
    ap.add_argument("--no-checks", action="store_true")
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from autompc_torch.benchmarks import HalfcheetahBenchmark
    from autompc_torch.ops import _build
    from autompc_torch.ops import cuda_linesearch as K3
    from autompc_torch.ops import cuda_relin as K1
    from autompc_torch.ops import cuda_riccati as K2
    from autompc_torch.ops import cuda_riccati_general as K4

    dev = cs.check_device()
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_shapes(cs.SHAPES_18, main=True)
    print(f"[1] build/load kernels and phase 18's shapes: {time.perf_counter() - t0:.2f} s",
          flush=True)
    for shape in cs.SHAPES_18:
        for name, regs, spill in cs.ptxas_report(_build.shape_build_log(*shape)):
            print(f"    ptxas {shape}: {name}: {regs} registers, {spill} bytes spilled")
    cs.PD_FAN_STEPS, cs.PD_CL_STEPS = args.fan_steps, args.loop_steps
    hc = HalfcheetahBenchmark()
    hc_trajs = hc.gen_trajs_batch(seed=0, n_trajs=24, traj_len=40)
    mods = (K1, K2, K3, K4)
    sp = cs.shapes_phase(dev, card, mods, hc, hc_trajs)
    if args.no_checks:
        return
    failures = []
    t0 = time.perf_counter()
    for row in cs.check_shape_kernels(sp, mods, failures):
        print(json.dumps(row))
    print(f"[3] phase 18's kernel checks: {time.perf_counter() - t0:.2f} s", flush=True)
    if failures:
        raise RuntimeError("; ".join(failures))


if __name__ == "__main__":
    main()
