"""How far the batch-major body's float32 backward passes part on the main
path's problem, on the card: ``backward`` "pallas" (K6), "assoc" and "scan"
(the feature kernels, fuse_ls) and a float64 solve ("scan", jacfwd, the
plain line search, no kernels) from the same draws, B=1024, H=200, up to 50
iterations, from swing-up starts (phase 20 (a)'s) and from near-upright
ones; for each pair, on the lanes converged in both, the share whose
accepted objectives agree within 1e-3 and 1e-2 (relative) and the share
where the first is lower. Measures what ``chip_smoke.py`` phase 20's
``SO_SHARE_SLACK`` floor stands on.

Run (on the card):
    python3 tools/torch_assoc_agreement_check.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark
    from autompc_torch.control import make_batched_ilqr_solver
    from autompc_torch.costs import QuadCost
    from autompc_torch.ops import _build
    from autompc_torch.sysid import SINDy

    dev = cs.check_device()
    print(cs.card_line(), flush=True)
    _build.build_shapes((), main=True)
    bench = CartpoleSwingupBenchmark()
    trajs = bench.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(bench.system, **cs.SINDY_KW)
    model.train(trajs)
    coeffs = model.coeffs.cpu().numpy()
    active = tuple(int(k) for k in np.flatnonzero(np.any(coeffs != 0, axis=0)))
    qd = np.diag([10.0, 0.1, 0.01, 0.01])
    cost = QuadCost(bench.system, qd, 0.001 * np.eye(1), qd, goal=np.zeros(4))
    bounds = bench.task.get_ctrl_bounds()
    H, B, dt = cs.H, 1024, bench.system.dt
    kw = dict(H=H, ds=4, dc=1, obsdim=4, dt=dt, ubounds=(bounds[:, 0], bounds[:, 1]),
              feature_spec=(model.library, "coeffs"), feature_mask=active, fuse_ls=True,
              lanes_last=False, max_iter=50)
    kw64 = {k: v for k, v in kw.items() if k not in ("feature_spec", "feature_mask", "fuse_ls")}
    p64 = {"coeffs": model.coeffs.double()}
    rng = lambda: np.random.default_rng(20)
    for label, x0np in (
            ("swing-up", rng().uniform(-1, 1, (B, 4)) * np.array([3.1, 1, 1, 1])),
            ("near upright", rng().uniform(-1, 1, (B, 4)) * 0.3)):
        x0 = torch.as_tensor(x0np, dtype=torch.float32, device=dev)
        ug = x0.new_zeros((B, H, 1))
        res = {}
        for name, solve, args in (
                *((bk, make_batched_ilqr_solver(model.pred_core, cost, backward=bk, **kw),
                   (model.params, x0, ug)) for bk in ("pallas", "assoc", "scan")),
                ("f64", make_batched_ilqr_solver(model.pred_core, cost, backward="scan", **kw64),
                 (p64, x0.double(), ug.double()))):
            t0 = time.perf_counter()
            out = solve(*args)
            torch.cuda.synchronize()
            res[name] = (out[0], cs.so_objective(cost, out[1], out[2], dt))
            print(f"{label} {name}: {time.perf_counter() - t0:.3f} s, converged "
                  f"{float(out[0].float().mean()):.4f}", flush=True)
        for a, c in (("assoc", "pallas"), ("scan", "pallas"), ("assoc", "scan"),
                     ("pallas", "f64"), ("scan", "f64"), ("assoc", "f64")):
            both = res[a][0] & res[c][0]
            rel = ((res[a][1] - res[c][1]).abs() / res[c][1].abs())[both]
            print(f"{label}: {a} vs {c}: both {int(both.sum())}, within 1e-3 "
                  f"{float((rel <= 1e-3).float().mean()):.4f}, within 1e-2 "
                  f"{float((rel <= 1e-2).float().mean()):.4f}; {a} lower objective on "
                  f"{float((res[a][1][both] < res[c][1][both]).float().mean()):.4f}", flush=True)


if __name__ == "__main__":
    main()
