"""The main demo's AutoML tune through the PyTorch port on one NVIDIA GPU,
timed (the port's counterpart of ``bench_tune.py``).

    python3 bench_tune_torch.py

The workload is ``bench_tune.py``'s: CartpoleSwingupV2 data (500 x 200
trajectories, seed 100), ``Pipeline(MLPFactory, QuadCostFactory,
IterativeLQRFactory)``, a default-configuration MLP surrogate trained on
half the data, 100 candidate evaluations in BO rounds of 25 through the
joint-MLP fan-out (``fanout_backward="pallas"``, the compaction schedule
``((4, 0.5), (8, 0.25), (14, 0.125))``), each candidate also scored on
the true dynamics. It prints one JSON line:

    {"metric": "demo_tune_wall_s", "value": N, "unit": "s",
     "n_evals": 100, "final_true_cost": ..., "final_success_rate": ...,
     "quality_gate_pass": ..., "card": "<name>, <power limit>", ...}

Knobs (environment), as ``bench_tune.py``'s:
    BT_ITERS=100        candidate evaluations
    BT_EVAL_BATCH=25    candidates a BO round
    BT_TRUEDYN=1        score every candidate on the true dynamics too
    BT_TRAJS=500        trajectories generated (half train the surrogate)
    BT_QUALITY_B=256    random starts of the final swing-up gate
    BT_QUALITY_MIN=0.5  the gate's least success rate
    BT_QUALITY_SPREAD=0.3  the starts' spread around the canonical start

Quality gate: the tuned incumbent must reach a finite true-dynamics task
cost below the step count from the canonical start, and swing up at
least BT_QUALITY_MIN of BT_QUALITY_B starts closed loop on the true
dynamics (``control/receding.py::make_receding_ilqr_loop``).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def main():
    from autompc_torch import resolve_device
    from autompc_torch.benchmarks import CartpoleSwingupV2Benchmark
    from autompc_torch.control import IterativeLQRFactory, make_receding_ilqr_loop
    from autompc_torch.costs import QuadCostFactory
    from autompc_torch.ops import cuda_riccati_general
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.sysid import MLPFactory
    from autompc_torch.tuning import PipelineTuner
    from autompc_torch.utils import simulate

    dev = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t_start = time.perf_counter()

    benchmark = CartpoleSwingupV2Benchmark()
    system, task = benchmark.system, benchmark.task
    n_trajs = int(os.environ.get("BT_TRAJS", "500"))
    trajs = benchmark.gen_trajs(seed=100, n_trajs=n_trajs, traj_len=200, device=dev)
    pipeline = Pipeline(system, MLPFactory(system), QuadCostFactory(system),
                        IterativeLQRFactory(system))
    n_iters = int(os.environ.get("BT_ITERS", "100"))
    eval_batch = int(os.environ.get("BT_EVAL_BATCH", "25"))
    use_truedyn = os.environ.get("BT_TRUEDYN", "1") != "0"
    tuner = PipelineTuner(
        surrogate_mode="defaultcfg", surrogate_factory=MLPFactory(system),
        surrogate_split=0.5, eval_batch=eval_batch, use_fanout=True,
        fanout_backward="pallas", fanout_compact=((4, 0.5), (8, 0.25), (14, 0.125)),
    )
    torch.cuda.synchronize()
    t_data = time.perf_counter()
    print(f"[bench_tune_torch] data: {n_trajs} trajs x 200 in {t_data - t_start:.1f}s on "
          f"{card}", file=sys.stderr)

    k4 = cuda_riccati_general.riccati_general
    k4.launches, k4.launches_by_B = 0, {}
    controller, result = tuner.run(
        pipeline, task, trajs, n_iters=n_iters, rng=np.random.default_rng(100),
        truedyn=benchmark.dynamics if use_truedyn else None,
    )
    torch.cuda.synchronize()
    t_tune = time.perf_counter()
    tune_wall_s = t_tune - t_data
    print(f"[bench_tune_torch] tune: {n_iters} candidate evaluations in {tune_wall_s:.1f}s "
          f"({n_iters / tune_wall_s:.2f} evals/s); incumbent surrogate cost "
          f"{result.inc_costs[-1]:.1f}; K4 launches {k4.launches}, by B {k4.launches_by_B}",
          file=sys.stderr)

    # (a) The demo's own final cell: the incumbent from the canonical
    # start on the true dynamics, scored by the task metric (steps
    # outside the box).
    traj = simulate(controller, task.get_init_obs(), term_cond=task.term_cond,
                    dynamics=benchmark.dynamics, max_steps=task.get_num_steps())
    final_true_cost = float(task.get_cost()(traj))

    # (b) The batched receding-horizon closed loop from random starts
    # around the canonical one; success = final |theta|, |omega| < 0.2.
    inc_model = controller.model
    bounds = task.get_ctrl_bounds()
    n_steps = int(task.get_num_steps())
    run_cl = make_receding_ilqr_loop(
        inc_model.pred_core, controller.task.get_cost(), benchmark.dynamics,
        H=int(controller.horizon), ds=int(inc_model.state_dim), dc=system.ctrl_dim,
        obsdim=system.obs_dim, dt=system.dt, n_steps=n_steps,
        ubounds=(bounds[:, 0], bounds[:, 1]), pred_diff=inc_model.pred_diff_core,
    )
    Bq = int(os.environ.get("BT_QUALITY_B", "256"))
    spread = float(os.environ.get("BT_QUALITY_SPREAD", "0.3"))
    rng_q = np.random.default_rng(12345)
    x0q = torch.as_tensor(np.asarray(task.get_init_obs())[None, :]
                          + rng_q.uniform(-spread, spread, (Bq, 4)),
                          dtype=torch.float32, device=dev)
    xs_cl, _, _ = run_cl(inc_model.params, x0q)
    fx = xs_cl[:, -1].cpu().numpy()
    success_rate = float(((np.abs(fx[:, 0]) < 0.2) & (np.abs(fx[:, 1]) < 0.2)).mean())
    t_eval = time.perf_counter()

    gate_min = float(os.environ.get("BT_QUALITY_MIN", "0.5"))
    gate_pass = bool(np.isfinite(final_true_cost) and final_true_cost < n_steps
                     and success_rate >= gate_min)
    print(f"[bench_tune_torch] incumbent on true dynamics: task cost {final_true_cost:.1f}/"
          f"{n_steps} from the canonical start; {success_rate * 100:.1f}% swing-up over {Bq} "
          f"random starts ({t_eval - t_tune:.1f}s); gate {'PASS' if gate_pass else 'FAIL'}",
          file=sys.stderr)

    print(json.dumps({
        "metric": "demo_tune_wall_s",
        "value": round(tune_wall_s, 1),
        "unit": "s",
        "vs_baseline": round(tune_wall_s / (5 * 3600), 4),
        "n_evals": n_iters,
        "evals_per_s": round(n_iters / tune_wall_s, 3),
        "eval_batch": eval_batch,
        "truedyn_reporting": use_truedyn,
        "n_trajs": n_trajs,
        "inc_surr_cost": round(float(result.inc_costs[-1]), 2),
        "final_true_cost": round(final_true_cost, 2),
        "final_success_rate": round(success_rate, 4),
        "quality_gate_min_success": gate_min,
        "quality_gate_pass": gate_pass,
        "k4_launches": k4.launches,
        "total_wall_s": round(t_eval - t_start, 1),
        "backend": "cuda",
        "card": card,
    }))


if __name__ == "__main__":
    main()
