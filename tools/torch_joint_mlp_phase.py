"""``chip_smoke.py``'s phase 11 (the joint-MLP tune) alone, on the card.

Builds the kernels, runs ``chip_smoke.py::joint_mlp_phase`` with the
phase's depth set from the command line, then holds K4 at (4,1) against
its plain version on the inputs that path gives it (``check_k4``, with
its device time) and prints K4's report row. The quick way to iterate on
phase 11 without the rest of the script.

Run (on the card):
    python3 tools/torch_joint_mlp_phase.py [--iters 25] [--epochs 20] [--trajs 40] [--profile]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import chip_smoke as cs
    from autompc_torch.ops import _build
    from autompc_torch.ops import cuda_riccati_general as K4

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=cs.JM_ITERS)
    ap.add_argument("--epochs", type=int, default=cs.JM_EPOCHS)
    ap.add_argument("--trajs", type=int, default=cs.JM_TRAJS)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    cs.JM_ITERS, cs.JM_EPOCHS, cs.JM_TRAJS = args.iters, args.epochs, args.trajs

    dev = cs.check_device()
    card = cs.card_line()
    t0 = time.perf_counter()
    _build.library()
    print(f"{card}; kernels built or loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    _, by_B, k4_args = cs.joint_mlp_phase(dev, card, K4, profile=args.profile)
    row, failures, _, _ = cs.check_k4("joint-MLP tune", K4, k4_args,
                                      by_B.get(k4_args[0].shape[0], 0), device_time=True)
    print(json.dumps(row))
    if failures:
        raise RuntimeError("; ".join(failures))


if __name__ == "__main__":
    main()
