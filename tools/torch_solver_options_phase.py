"""``chip_smoke.py``'s phase 20 (the solver's remaining options: the
associative-scan Riccati in the batch-major body and the SQP, the staged
driver, relin="xla" and analytic_jac, a fixed dense cost on the fused
batch-major body (K3's DENSE form), the GaussReg joint-SINDy fan-out past
64 terms (K3's batch-major per-lane entry), K5's "default" and "bf16x3"
precisions) alone, on the card, at full width, with phase [3]'s checks of
those kernel modes.

Builds the kernels, fits phase 2's cartpole SINDy (data 50 x 100, seed
42), phase 6's cheetah MLP (data 24 x 40, its seed) and phase 7's cartpole
MLP, runs ``chip_smoke.py::solver_options_phase`` at ``SO_FULL`` (B=4096
for (a), (c), (d); B=16384 for (b); 10 joint fan-out steps; 5 receding SQP
steps; ``chip_smoke.py`` runs ``SO_SMOKE``), then
``check_solver_option_kernels``, and prints each kernel's row as JSON.

Run (on the card):
    python3 tools/torch_solver_options_phase.py [--smoke] [--no-checks]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="chip_smoke.py's sizes (SO_SMOKE)")
    ap.add_argument("--no-checks", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark, HalfcheetahBenchmark
    from autompc_torch.ops import _build
    from autompc_torch.ops import cuda_linesearch as K3
    from autompc_torch.ops import cuda_mlp_linesearch as K5
    from autompc_torch.ops import cuda_relin as K1
    from autompc_torch.ops import cuda_riccati as K2
    from autompc_torch.ops import cuda_riccati_general as K4
    from autompc_torch.sysid import SINDy

    dev = cs.check_device()
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_shapes((), main=True)
    print(f"[1] build/load kernels: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, regs, spill in cs.ptxas_report(_build.build_log()):
        if "fused_ls_kernel" in name or "mlp_ls_kernel" in name:
            print(f"    ptxas: {name}: {regs} registers, {spill} bytes spilled")
    bench = CartpoleSwingupBenchmark()
    trajs = bench.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(bench.system, **cs.SINDY_KW)
    model.train(trajs)
    if not np.isfinite(model.coeffs.cpu().numpy()).all():
        raise RuntimeError("SINDy fit produced non-finite coefficients")
    hc = HalfcheetahBenchmark()
    hc_trajs = hc.gen_trajs_batch(seed=0, n_trajs=24, traj_len=40)
    hc_model, hc_cost, hc_kw = cs.cheetah_problem(hc, hc_trajs, cs.HC_MODEL_SEED, dev)
    hc_x0 = cs.cheetah_x0(dev)
    hc_ug = torch.zeros((cs.B_HC, cs.H_HC, 6), dtype=torch.float32, device=dev)
    cp_model, cp_cost, cp_kw = cs.dense_cartpole_problem(bench, trajs)
    cp_x0 = cs.draw_x0(np.random.default_rng(2), cs.B_DENSE, dev)
    cp_ug = torch.zeros((cs.B_DENSE, cs.H, 1), dtype=torch.float32, device=dev)
    mods = (K1, K2, K3, K4, K5)
    so = cs.solver_options_phase(dev, card, mods, bench, model, trajs,
                                 (hc_model, hc_cost, hc_kw, hc_x0, hc_ug),
                                 (cp_model, cp_cost, cp_kw, cp_x0, cp_ug),
                                 size=cs.SO_SMOKE if args.smoke else cs.SO_FULL)
    print(json.dumps({"rates": so["rates"], "counts": so["counts"]}), flush=True)
    if args.no_checks:
        return
    failures = []
    t0 = time.perf_counter()
    for row in cs.check_solver_option_kernels(so, mods, failures):
        print(json.dumps(row))
    print(f"[3] phase 20's kernel checks: {time.perf_counter() - t0:.2f} s", flush=True)
    if failures:
        raise RuntimeError("; ".join(failures))


if __name__ == "__main__":
    main()
