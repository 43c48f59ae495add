"""``chip_smoke.py``'s phase 17 (the model-tuning path: the ARX, SINDy,
Koopman-lasso and MLP buckets, "autoselect" and "autotune" through the
tuner, ``QuadCostFanout(impl="vmap")``) alone, on the card, with phase
[3]'s checks of K1's batch-major entry, K6 and K7 on (d)'s carry.

Builds the kernels, fits phase 2's model (the main path's data, 50 x 100,
seed 42, the 55-term library), runs ``chip_smoke.py::model_tuning_phase``
((a)-(e)) and ``check_tune_kernels`` at every batch size (d) launched the
three kernels with, and prints each kernel's row as JSON. The quick way
to iterate on phase 17 without the rest of the script.

Run (on the card):
    python3 tools/torch_model_tuning_phase.py
"""

import json
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
    wrappers = (K1.relin_jacobians_bm, K2.backward_quad, K3.sindy_line_search)
    t0 = time.perf_counter()
    mt = cs.model_tuning_phase(bench, model, trajs, dev, card, wrappers)
    print(f"[17] phase wall {time.perf_counter() - t0:.2f} s", flush=True)

    coeffs = model.coeffs.cpu().numpy()
    active = [int(k) for k in (abs(coeffs) > 0).any(axis=0).nonzero()[0]]
    terms = tuple(model.library.terms[k] for k in active)
    ca = model.coeffs[:, active].contiguous()
    alphas = tuple(0.2 ** k for k in range(10))
    bound = float(bench.task.get_ctrl_bounds()[0, 1])
    Bs = sorted({b for counts in mt["by_B"].values() for b in counts}, reverse=True)
    k67, failures = cs.check_tune_kernels(model, mt["kw"], mt["batch"], Bs,
                                          bench.task.get_init_obs(), (K1, K2, K3), terms, ca,
                                          bench.system.dt, alphas, bound)
    for k, w in enumerate(wrappers):
        name = w.__name__
        row = dict(name=f"{name}[phase 17 (d)]", launches_model_tuning=mt["launches"][name],
                   launches_model_tuning_by_B=mt["by_B"][name])
        for b in Bs:
            row[f"at_B{b}_H{cs.TUNE_H}_model_tuning"] = dict(
                k67[b][k], launches=mt["by_B"][name].get(b, 0))
        print(json.dumps(row))
    if failures:
        raise RuntimeError("; ".join(failures))


if __name__ == "__main__":
    main()
