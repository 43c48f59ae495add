"""``chip_smoke.py``'s phase 13 (the GaussReg / SumCost costs) alone, on
the card.

Builds the kernels (and prints the ptxas registers and spills of K3's
instances), fits phase 2's model (the main path's data, 50 x 100, seed
42, the 55-term library), then runs ``chip_smoke.py::gauss_reg_phase``
((a) the cost fan-out and (b) the joint-SINDy fan-out with the GaussReg
term through both bodies) and, unless ``--no-tune``, ``gauss_reg_tune``
((c), its depth from the command line), then phase [3]'s checks of
phase 13's kernels (``check_gauss_reg_kernels``) and the batch-major
entry against the lanes-last instance on phase 8 (a)'s carry
(``check_bm_identity``). The quick way to iterate on phase 13 without
the rest of the script; it exits non-zero where a check fails.

Run (on the card):
    python3 tools/torch_gauss_reg_phase.py [--iters 256] [--batch 128] [--no-tune]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import chip_smoke as cs
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark
    from autompc_torch.control import make_batched_ilqr_solver
    from autompc_torch.ops import _build
    from autompc_torch.ops import cuda_linesearch as K3
    from autompc_torch.ops import cuda_relin as K1
    from autompc_torch.ops import cuda_riccati_general as K4
    from autompc_torch.sysid import SINDy

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=cs.GR_TUNE_ITERS)
    ap.add_argument("--batch", type=int, default=cs.GR_TUNE_BATCH)
    ap.add_argument("--no-tune", action="store_true")
    args = ap.parse_args()
    cs.GR_TUNE_ITERS, cs.GR_TUNE_BATCH = args.iters, args.batch

    dev = cs.check_device()
    card = cs.card_line()
    t0 = time.perf_counter()
    _build.library()
    print(f"{card}; kernels built or loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, regs, spill in cs.ptxas_report(_build.build_log()):
        if name.startswith("fused_ls_kernel"):
            print(f"    ptxas: {name}: {regs} registers, {spill} bytes spilled", flush=True)
    bench = CartpoleSwingupBenchmark()
    trajs = bench.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(bench.system, **cs.SINDY_KW)
    model.train(trajs)
    wrappers = cs.gauss_reg_counters(K1, K3, K4)
    t0 = time.perf_counter()
    gr = cs.gauss_reg_phase(bench, model, trajs, dev, card, wrappers)
    if not args.no_tune:
        cs.gauss_reg_tune(bench, model, trajs, dev, card, wrappers["2"])
    print(f"[13] phase wall {time.perf_counter() - t0:.2f} s", flush=True)

    alphas = tuple(0.2 ** k for k in range(10))
    rows, k4_row, failures = cs.check_gauss_reg_kernels(gr, model, bench, dev, K1, K3, K4,
                                                        alphas)
    # The identity on phase 8 (a)'s lanes-last carry, three iterations in.
    batch = cs.fanout_candidates(dev, cs.FAN_B)
    active = tuple(int(k) for k in np.flatnonzero(np.any(model.coeffs.cpu().numpy() != 0, 0)))
    bounds = bench.task.get_ctrl_bounds()
    _, carry0, _, make_body = make_batched_ilqr_solver(
        model.pred_core, None, return_pieces=True, H=cs.FAN_H, ds=4, dc=1, obsdim=4,
        dt=bench.system.dt, ubounds=(bounds[:, 0], bounds[:, 1]), quad_cost_batch=True,
        quad_goal=np.zeros(4), feature_spec=(model.library, "coeffs"), feature_mask=active,
        **cs.FAN_CONFIGS["a"])
    x0 = batch["Qdiag"].new_tensor(np.tile(bench.task.get_init_obs(), (cs.FAN_B, 1)))
    c, body = carry0(model.params, x0, x0.new_zeros((cs.FAN_B, cs.FAN_H, 1)), batch), \
        make_body(model.params)
    for _ in range(3):
        c = body(c)
    cost = (*(c["cost"][k] for k in ("Qdiag", "Rdiag", "Fdiag")), (0.0,) * 4)
    failures += cs.check_bm_identity(
        "fan-out (a) carry", K3, tuple(model.library.terms[k] for k in active),
        model.coeffs[:, list(active)].contiguous(), c, cost, bench.system.dt, alphas,
        float(bounds[0, 1]))
    for r in rows + [k4_row]:
        print(f"    {r['name']}: kernel {r['ms']:.3f} ms (device {r.get('device_ms', 0.0):.4f}), "
              f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['launches']} launches" + (f", {r['registers']} registers"
                                             if "registers" in r else ""), flush=True)
        if "no_reg" in r:
            w = r["no_reg"]
            print(f"        no_reg: kernel {w['ms']:.3f} ms (device {w['device_ms']:.4f}), "
                  f"bound {w['bound_ms']:.4f} ms, {w['registers']} registers", flush=True)
    torch.cuda.synchronize()
    if failures:
        raise RuntimeError("kernel check failed: " + "; ".join(failures))
    print("phase 13 ok", flush=True)


if __name__ == "__main__":
    main()
