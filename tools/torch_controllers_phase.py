"""``chip_smoke.py``'s phase 14 (the MPPI and direct-transcription
controllers, their receding loops, fan-outs and the tuner's kinds
"mppi" and "dt") alone, on the card.

Fits phase 2's model (the main path's data, 50 x 100, seed 42, the
55-term library) and phase 6's halfcheetah MLP with its default training
seed (data 24 x 40, seed 0), then runs ``chip_smoke.py::
controllers_phase`` ((a)-(c)) and ``controller_tunes`` ((d)). Phase 14
launches no hand-written kernel, so nothing is built. The quick way to
iterate on phase 14 without the rest of the script.

Run (on the card):
    python3 tools/torch_controllers_phase.py [--no-tune]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import chip_smoke as cs
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark, HalfcheetahBenchmark
    from autompc_torch.sysid import SINDy

    ap = argparse.ArgumentParser()
    ap.add_argument("--no-tune", action="store_true")
    args = ap.parse_args()
    dev = cs.check_device()
    card = cs.card_line()
    print(card, flush=True)
    bench = CartpoleSwingupBenchmark()
    trajs = bench.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(bench.system, **cs.SINDY_KW)
    model.train(trajs)
    hc = HalfcheetahBenchmark()
    hc_model = cs.cheetah_problem(hc, hc.gen_trajs_batch(seed=0, n_trajs=24, traj_len=40),
                                  cs.HC_DEFAULT_SEED, dev)[0]
    t0 = time.perf_counter()
    cs.controllers_phase(bench, model, trajs, hc, hc_model, dev, card)
    if not args.no_tune:
        cs.controller_tunes(bench, model, trajs, card)
    print(f"[14] phase wall {time.perf_counter() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    main()
