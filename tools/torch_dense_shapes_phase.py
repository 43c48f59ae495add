"""``chip_smoke.py``'s phase 19 (K4 from dense expansions at (12, 1),
(8, 1) and (2, 1), the per-lane K1/K3/K7 instances and K8, K9 and K2's 4D
entry at (2, 1), each through the entry points a user calls) alone, on
the card, with phase [3]'s checks of those instances.

Builds the kernels (the main library and phase 18's and 19's shapes at
first use), fits phase 2's cartpole SINDy (data 50 x 100, seed 42) and
phase 18's pendulum SINDy, runs ``chip_smoke.py::dense_shapes_phase``
with the GaussReg joint-Koopman fan-out at ``--jk-steps`` closed-loop
steps (25, phase 15's, uncut; ``chip_smoke.py`` runs ``DS_JK_STEPS``),
then ``check_dense_kernels``, and prints each kernel's row as JSON. The
quick way to iterate on phase 19 without the rest of the script.

Run (on the card):
    python3 tools/torch_dense_shapes_phase.py [--jk-steps N] [--no-checks]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jk-steps", type=int, default=25)
    ap.add_argument("--no-checks", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np

    import chip_smoke as cs
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark
    from autompc_torch.ops import _build
    from autompc_torch.ops import cuda_linesearch as K3
    from autompc_torch.ops import cuda_relin as K1
    from autompc_torch.ops import cuda_riccati as K2
    from autompc_torch.ops import cuda_riccati_general as K4
    from autompc_torch.sysid import SINDy

    dev = cs.check_device()
    card = cs.card_line()
    print(card, flush=True)
    shapes = cs.SHAPES_18 + cs.SHAPES_19
    t0 = time.perf_counter()
    _build.build_shapes(shapes, main=True)
    print(f"[1] build/load kernels and phases 18's and 19's shapes: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for shape in shapes:
        for name, regs, spill in cs.ptxas_report(_build.shape_build_log(*shape)):
            print(f"    ptxas {shape}: {name}: {regs} registers, {spill} bytes spilled")
    bench = CartpoleSwingupBenchmark()
    trajs = bench.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(bench.system, **cs.SINDY_KW)
    model.train(trajs)
    if not np.isfinite(model.coeffs.cpu().numpy()).all():
        raise RuntimeError("SINDy fit produced non-finite coefficients")
    sp = cs.pendulum_setup()
    mods = (K1, K2, K3, K4)
    ds19 = cs.dense_shapes_phase(dev, card, mods, sp, bench, model, trajs,
                                 jk_steps=args.jk_steps)
    if args.no_checks:
        return
    failures = []
    t0 = time.perf_counter()
    for row in cs.check_dense_kernels(ds19, sp, mods, failures):
        print(json.dumps(row))
    print(f"[3] phase 19's kernel checks: {time.perf_counter() - t0:.2f} s", flush=True)
    if failures:
        raise RuntimeError("; ".join(failures))


if __name__ == "__main__":
    main()
