"""Count the PyTorch operations of one iLQR iteration of the GP fan-outs
of ``chip_smoke.py`` phase 16, on the CPU, and of its relinearization
(``jacfwd`` of the cached-mean predictor under ``vmap`` over the lanes and
steps) apart.

Every operation that is not a view is one kernel launch (or more) on the
card: the count is the launch count an iteration makes. The shapes are
phase 16's (H = 10, the cartpole's ds = 4, dc = 1, per-lane predictors
padded to 200 inducing points), at a small batch: the count does not
depend on the batch size.

Run:
    python tools/torch_gp_ops.py
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import chip_smoke as cs
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark
    from autompc_torch.control import make_batched_ilqr_solver
    from autompc_torch.control.ilqr import jacfwd_pred_diff
    from autompc_torch.parallel import JointGPQuadCostFanout
    from autompc_torch.sysid import SINDy
    from autompc_torch.sysid.gp import gp_pred_core_cached
    from tools.torch_controller_ops import count

    torch.set_num_threads(4)
    bench = CartpoleSwingupBenchmark()
    trajs = bench.gen_trajs_batch(seed=42, n_trajs=8, traj_len=30, device="cpu")
    surr = SINDy(bench.system, device="cpu", **cs.SINDY_KW)
    surr.train(trajs)
    B = 16
    rng = np.random.default_rng(0)
    batch = {"Qdiag": torch.as_tensor(10 ** rng.uniform(-1, 1.5, (B, 4))),
             "Fdiag": torch.as_tensor(10 ** rng.uniform(-1, 1.5, (B, 4))),
             "Rdiag": torch.as_tensor(10 ** rng.uniform(-3, 0, (B, 1)))}
    counts = rng.choice(np.linspace(50, 200, 4).astype(int), B).tolist()
    for backward in ("scan", "pallas"):
        fan = JointGPQuadCostFanout(bench.system, bench.task, dict(niter=1), trajs, surr,
                                    horizon=cs.GP_H, n_steps=1, goal=np.zeros(4),
                                    backward=backward, device="cpu")
        params = fan.lane_params(counts)
        x0 = batch["Qdiag"].new_tensor(np.tile(bench.task.get_init_obs(), (B, 1)))
        ug = x0.new_zeros((B, cs.GP_H, 1))
        _, carry0, _, make_body = make_batched_ilqr_solver(
            gp_pred_core_cached, None, return_pieces=True, **fan.solver_kw)
        c = carry0(params, x0, ug, batch)
        body = make_body(params)
        n_iter, ops = count(lambda: body(c))
        diff = jacfwd_pred_diff(gp_pred_core_cached, 4, batch_params=True)
        n_jac, jops = count(lambda: diff(params, c["xs"][:, :cs.GP_H], c["us"]))
        n_pred, _ = count(lambda: gp_pred_core_cached(params, x0, ug[:, 0]))
        print(f"backward={backward!r}: one iteration of the per-lane GP solve (H={cs.GP_H}) "
              f"dispatches {n_iter} operations; its relinearization (jacfwd under vmap, every "
              f"lane and step at once) {n_jac}; one predictor call {n_pred}")
        print("    most frequent in the iteration:", ops.most_common(8))
        print("    in the relinearization:", jops.most_common(8))


if __name__ == "__main__":
    main()
