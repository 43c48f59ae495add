"""How far float32 rounding alone moves the pendulum's line search: the
plain version of K3 in float32 and in float64 on the same inputs, on the
main path's carry at (B, H) = (4096, 200), for two draws of the starts.

``chip_smoke.py`` phase [3] holds K3 against its plain version (both
float32, two summation orders) normwise at ``TOL_K3``. This measures
whether any float32 order can meet that on a carry: the pendulum's SINDy
(phase 18 (a)'s fit), ``make_carry0`` from the starts, K2's plain backward
pass in float32, then K3's plain line search in float32 and, on the same
float32 inputs and gains cast up, in float64. It prints, for the lanes
whose success and failure flags agree, the normwise relative difference
of the states and of the objectives and the share of lanes within
``TOL_K3``, for

- "circle": theta in [-pi, pi], omega in [-1, 1] (the main path's solve);
- "rest": theta and omega within ``PD_KERNEL_SPREAD`` of (pi, 0) (the
  carry phase [3] holds K3 on).

Runs on the CPU (float64 model, plain versions) in seconds:
    python3 tools/torch_pendulum_conditioning.py [--B 4096]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=4096)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)

    import chip_smoke as cs
    from autompc_torch.benchmarks import PendulumSwingupBenchmark
    from autompc_torch.control import make_batched_ilqr_solver
    from autompc_torch.costs import QuadCost
    from autompc_torch.ops import cuda_linesearch as K3
    from autompc_torch.ops import cuda_riccati as K2
    from autompc_torch.sysid import SINDy

    pb = PendulumSwingupBenchmark()
    pm = SINDy(pb.system, device="cpu", **cs.SINDY_KW)
    pm.train(pb.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100, device="cpu"))
    active = tuple(int(k) for k in np.flatnonzero(np.any(pm.coeffs.numpy() != 0, axis=0)))
    qd = np.diag(cs.PD_Q)
    cost = QuadCost(pb.system, qd, cs.PD_R * np.eye(1), qd, goal=np.zeros(2))
    bound = float(pb.task.get_ctrl_bounds()[0, 1])
    dt = pb.system.dt
    _, carry0, _, _ = make_batched_ilqr_solver(
        pm.pred_core, cost, H=cs.H, return_pieces=True, ds=2, dc=1, obsdim=2, dt=dt,
        ubounds=(-bound, bound), backward="pallas", feature_spec=(pm.library, "coeffs"),
        fuse_ls=True, lanes_last=True, feature_mask=active)
    terms = tuple(pm.library.terms[k] for k in active)
    ca = pm.coeffs[:, list(active)].contiguous()
    alphas = tuple(0.2 ** k for k in range(10))
    diag = (cs.PD_Q, (cs.PD_R,), cs.PD_Q, (0.0, 0.0))
    B, s = args.B, cs.PD_KERNEL_SPREAD
    draws = {
        "circle": np.random.default_rng(1).uniform(-1, 1, (B, 2)) * np.array([np.pi, 1.0]),
        "rest": np.array([np.pi, 0.0]) + np.random.default_rng(1).uniform(-s, s, (B, 2)),
    }
    for name, x0 in draws.items():
        x0 = torch.as_tensor(x0, dtype=torch.float32).double()
        c = carry0(pm.params, x0, x0.new_zeros((B, cs.H, 1)))
        c32 = {k: v.float() if v.is_floating_point() else v
               for k, v in c.items() if isinstance(v, torch.Tensor)}
        act = ~c32["converged"] & ~c32["failed"]
        bk = K2.backward_quad_ll_plain(c32["jac"], c32["xs"], c32["us"], *diag, dt, 2,
                                       carry=(act, c32["Ks"], c32["ks"]))
        out = {}
        for dtype in (torch.float32, torch.float64):
            cv = {k: v.to(dtype) if v.is_floating_point() else v for k, v in c32.items()}
            KsT, ksT, lin, quad = (t.to(dtype) for t in bk)
            ks_small = torch.sqrt((ksT * ksT).sum(0)) < 1e-3
            out[dtype] = K3.fused_line_search_plain(
                terms, cv["x0s"], cv["xs"], cv["us"], KsT, ksT, ca.to(dtype), alphas,
                -bound, bound, *diag, dt, cv["obj"], lin, quad, ks_small, act, cv["jac"])
        a, b = out[torch.float32], out[torch.float64]
        same = act & (a[3] == b[3]) & (a[4] == b[4])
        xa, xb = a[0][:, :, same].double(), b[0][:, :, same]
        scale = xb.abs().amax(dim=(0, 1)).clamp_min(1e-30)
        per_lane = (xa - xb).abs().amax(dim=(0, 1)) / scale
        oa, ob = a[2][same].double(), b[2][same]
        print(f"{name}: B={B} H={cs.H}, active {int(act.sum())}, success and failure "
              f"flags equal on {int(same.sum())}; float32 against float64 on those lanes: xs normwise "
              f"{cs.rel_err(xa, xb):.3e}, objective normwise {cs.rel_err(oa, ob):.3e}; "
              f"lanes within {cs.TOL_K3}: {float((per_lane <= cs.TOL_K3).double().mean()):.4f}",
              flush=True)


if __name__ == "__main__":
    main()
