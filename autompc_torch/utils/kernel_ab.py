"""Time the MLP line-search kernel (K5) of one or more checkouts of this
repository on the card, at the shapes its paths give it (10 step sizes):
the cheetah MLP 24-64-64-18 at the open-loop solve's B=1024, H=200 and
the closed loop's B=32, H=20, and the dense-cost cartpole MLP 5-64-64-4
at B=4096, H=200. The inputs are made from a seed, so every checkout
times the same work.

    python3 autompc_torch/utils/kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout whose ``autompc_torch`` is imported in a process
of its own (two trees cannot share one), in the order given, so that
``A B B A`` compares two trees within one run. Prints one JSON line per
ROOT: at each shape the CUDA-event median in ms and a digest of the
outputs (ls_xs, ls_us); for a tree whose wrapper picks its block from
the card's SM count (``mlp_geometry``), the same for the block it picks
when the whole grid fits on the card at once (``one_wave``) and when it
does not (``many_waves``), whichever the shape is. Then one line that
says whether every ROOT and block gave the same outputs bit for bit."""

import hashlib
import json
import os
import subprocess
import sys

L = 10
# (tag, widths, ds, dc, B, H)
SHAPES = (
    ("cheetah_B1024_H200", (24, 64, 64, 18), 18, 6, 1024, 200),
    ("cheetah_B32_H20", (24, 64, 64, 18), 18, 6, 32, 20),
    ("dense_B4096_H200", (5, 64, 64, 4), 4, 1, 4096, 200),
)
# SM counts the wrapper is told, so that it takes each of its two blocks.
BLOCKS = (("one_wave", 10 ** 6), ("many_waves", 1))


def _inputs(widths, ds, dc, B, H, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    layers = []
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        scale = (0.1 if i == len(widths) - 2 else 1.0) / np.sqrt(a)
        layers.append((t(rng.normal(0, scale, (a, b))), t(rng.normal(0, 0.01, b))))
    x0 = rng.uniform(-0.1, 0.1, (B, ds))
    xs = x0[:, None] + rng.normal(0, 0.01, (B, H + 1, ds))
    return (tuple(layers), "relu", t(x0), t(xs), t(rng.normal(0, 0.1, (B, H, dc))),
            t(rng.normal(0, 0.1, (B, H, dc, ds))), t(rng.normal(0, 0.1, (B, H, dc))),
            tuple(0.2 ** k for k in range(L)), -1.0, 1.0)


def _time_ms(fn, reps=20):
    import numpy as np
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _digest(outputs):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in outputs)).hexdigest()


def time_one(root):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from autompc_torch.ops import cuda_mlp_linesearch as K5

    dev = torch.device("cuda", 0)
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    for tag, widths, ds, dc, B, H in SHAPES:
        args = _inputs(widths, ds, dc, B, H, dev)

        def run():
            return K5.mlp_line_search(*args)

        out[f"{tag}_sha256"] = _digest(run())
        out[tag] = _time_ms(run)
        if not hasattr(K5, "mlp_geometry"):
            continue
        sm_count = K5._build.sm_count
        for block, n_sm in BLOCKS:
            K5._build.sm_count = lambda device: n_sm
            try:
                g = K5.mlp_geometry(list(widths), ds, dc, L, B, n_sm)
                out[f"{tag}_{block}_block"] = f"{g['rollouts']} rollouts, {g['threads']} threads"
                out[f"{tag}_{block}_sha256"] = _digest(run())
                out[f"{tag}_{block}"] = _time_ms(run)
            finally:
                K5._build.sm_count = sm_count
    print(json.dumps(out), flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        time_one(argv[1])
        return 0
    if not argv:
        print(__doc__)
        return 2
    digests = {shape[0]: set() for shape in SHAPES}
    for root in argv:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             check=True, stdout=subprocess.PIPE, text=True)
        line = run.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        out = json.loads(line)
        for tag in digests:
            digests[tag] |= {v for k, v in out.items()
                             if k.startswith(tag + "_") and k.endswith("_sha256")}
    print(json.dumps({"same_outputs_bit_for_bit": all(len(d) == 1 for d in digests.values())}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
