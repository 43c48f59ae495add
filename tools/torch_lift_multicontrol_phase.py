"""``chip_smoke.py``'s phase 21 (Koopman lifts past 24 states through K6's
and K4's wide instance; K3's batch-major entry at dc > 1 on the cheetah's
SINDy) alone, on the card, at full width (``LM_FULL``), with phase [3]'s
checks of those kernels.

Builds the kernels (the main library, which holds the wide K6 and K4, and
K3's multi-control instances at (18, 6) with phase 18's (18, 6) shapes),
fits phase 2's cartpole SINDy (data 50 x 100, seed 42) and phase 18 (d)'s
cheetah SINDy (phase 6's data, 24 x 40), runs
``chip_smoke.py::lift_multicontrol_phase``: (a) the joint-Koopman fan-out
on the cartpole at 28, 56, 72 and 96 lifted states, B=1,024, H=10, 5 steps,
with and without the GaussReg term, "pallas" against "scan" in the same
call (evals/s, first-step agreement); (b) a "joint_koopman" tune over
KoopmanFactory's whole space with fanout_backward="pallas", 8 candidates,
no lift refused; (c) the cheetah SINDy (18, 6) solve at B=1,024, H=200,
fused (K3) against unfused (K7) and the scan backward pass (converged
shares, agreement, solves/s); (d) QuadCostFanout(fuse_ls=True) and
JointSINDyQuadCostFanout(fuse_ls=True) on the cheetah. Then
``check_lift_multicontrol_kernels`` and each kernel's row as JSON.

Run (on the card):
    python3 tools/torch_lift_multicontrol_phase.py [--smoke] [--no-checks]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="chip_smoke.py's sizes (LM_SMOKE)")
    ap.add_argument("--no-checks", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np

    import chip_smoke as cs
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark, HalfcheetahBenchmark
    from autompc_torch.ops import _build
    from autompc_torch.ops import cuda_linesearch as K3
    from autompc_torch.ops import cuda_relin as K1
    from autompc_torch.ops import cuda_riccati as K2
    from autompc_torch.ops import cuda_riccati_general as K4
    from autompc_torch.sysid import SINDy

    dev = cs.check_device()
    card = cs.card_line()
    print(card, flush=True)
    shapes = cs.SHAPES_21 + (("relin", 18, 6), ("sindy_linesearch", 18, 6))
    t0 = time.perf_counter()
    _build.build_shapes(shapes, main=True)
    print(f"[1] build/load kernels: {time.perf_counter() - t0:.2f} s ({shapes} beside the main "
          f"library)", flush=True)
    logs = [_build.build_log()] + [_build.shape_build_log(*s) for s in cs.SHAPES_21]
    for log in logs:
        for name, regs, spill in cs.ptxas_report(log):
            if "riccati_big" in name or "fused_ls_mc" in name:
                print(f"    ptxas: {name}: {regs} registers, {spill} bytes spilled", flush=True)
    bench = CartpoleSwingupBenchmark()
    trajs = bench.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(bench.system, **cs.SINDY_KW)
    model.train(trajs)
    if not np.isfinite(model.coeffs.cpu().numpy()).all():
        raise RuntimeError("SINDy fit produced non-finite coefficients")
    hc = HalfcheetahBenchmark()
    hc_trajs = hc.gen_trajs_batch(seed=0, n_trajs=24, traj_len=40)
    sp = cs.cheetah_sindy(hc, hc_trajs)
    mods = (K1, K2, K3, K4)
    lm = cs.lift_multicontrol_phase(dev, card, mods, bench, model, trajs, sp, hc, hc_trajs,
                                    size=cs.LM_SMOKE if args.smoke else cs.LM_FULL)
    print(json.dumps({"rates": lm["rates"], "counts": {k: {n: (v if not isinstance(v, dict)
                                                              else {str(a): b for a, b in
                                                                    v.items()})
                                                          for n, v in c.items()}
                                                      for k, c in lm["counts"].items()}}),
          flush=True)
    if args.no_checks:
        return
    failures = []
    t0 = time.perf_counter()
    rows = cs.check_lift_multicontrol_kernels(lm, mods, failures)
    print(f"[3] phase 21's instances checked in {time.perf_counter() - t0:.2f} s", flush=True)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(card)
    if failures:
        raise RuntimeError("kernel check failed: " + "; ".join(failures))


if __name__ == "__main__":
    main()
