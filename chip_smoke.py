"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so the exit code is non-zero):

0. card and software: the card's name and power limit from nvidia-smi,
   the torch and CUDA versions; no CUDA device -> error, nothing runs on
   the CPU;
1. build: compile (or load) the CUDA kernels from ``autompc_torch/csrc``;
   print every kernel's registers and spills (the ptxas log) and, for K3,
   K5 and K8, the block shape and resident warps an SM at each shape
   their paths launch (the CUDA occupancy query), for K2, K4 and K7 the
   geometry their wrappers choose there;
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
8. the tuner's cost fan-out: ``QuadCostFanout`` on the phase-2 model at
   the scaling harness's shape (1,024 candidate cost weightings, H=10,
   50 closed-loop steps, compaction ``4:0.5,8:0.25,14:0.125``), once
   per solver configuration: (a) the lanes-last fused body with per-lane
   cost planes, (b) the batch-major body with the inline-expansion
   backward kernel, the rollout line-search kernel and the batch-major
   relinearization entry; one warm call and 3 timed calls each, evals/s
   and the launches by batch size printed; every score finite or inf; and
   the two configurations' first MPC-step solves agree on the accepted
   objective. 8q: the sensible and the absurd weighting of
   tests/test_parallel.py at H=20, 150 steps: the sensible one must
   score lower in both configurations;
9. the main path's wide options, phase 4's solve again in three
   variants, each with 2 warm and 3 timed runs on phase 4's draws:
   ``llw`` (``ls_wide=True``: the split line search, K8 + acceptance +
   K9, at every compaction stage), ``ll`` (``AMPC_BQ_WIDE_IO=reshape``:
   K2 through its 4D entry) and ``llb`` (``jac_dtype="bf16"``: K2 reads
   and K3 writes a bfloat16 Jacobian carry). ``ll`` must equal the
   default solve bit for bit, ``llw``'s accepted objectives must agree
   with the default's within 1e-3 on >= 0.95 of the lanes converged in
   both, and ``llb`` must pass phase 5's closed-loop gate;
10. the tuner: ``PipelineTuner.run`` on the phase-2 model with a
   QuadCostFactory and an IterativeLQRFactory pinned at H=20,
   ``surrogate_mode="pretrain"``, the fan-out path (K1's batch-major
   entry, K6, K7) with the true dynamics scored by a second fan-out:
   three BO rounds of 128 candidates x 199 closed-loop steps (two of the
   initial design, one forest-guided through the native forest, which
   must have built), each round's ask, fan-out seconds, evals/s and
   incumbent printed, no NaN score; the incumbent ``IterativeLQR``
   simulated on the true dynamics from the canonical start must reach a
   finite task cost below 200; then the sequential objective
   (``simulate`` of each candidate) against the fan-out on 4 candidates
   with the horizon unpinned: at least 3 of 4 agree within 1e-3;
11. the joint-MLP tune, ``bench_tune.py``'s workload at full width, cut
   in depth (``JM_*``): ``PipelineTuner.run`` with ``Pipeline(MLPFactory,
   QuadCostFactory, IterativeLQRFactory)`` on CartpoleSwingupV2 data (40
   trajectories instead of 500), a defaultcfg MLP surrogate on half of
   them, one BO round of 25 candidates (instead of four) padded to 32
   lanes, the bucket pinned to 2 x relu, 20 epochs (instead of 50), every
   lane its own 256-wide masked net, the horizon-masked per-lane solve
   (K4 at (4,1)) at H=25 for 199 closed-loop steps on the surrogate and
   on the true dynamics; the ask, per-lane training and closed-loop
   seconds, evals/s and K4's launches by B printed, no NaN score; the
   incumbent simulated on the true dynamics from the canonical start
   must reach a finite task cost;
3. kernels vs plain twins: each CUDA kernel against its plain PyTorch
   twin on the card, on inputs taken from every path that launches it,
   at that path's shape: the lanes-last kernels on the main path's carry
   after make_carry0 at B=4096, H=200 (fixed cost; random per-lane cost
   planes too), on the gate's first carry at B=256, H=20 (K2 with
   float32 and bfloat16 Jacobians, and at 255 lanes) and on fan-out
   configuration (a)'s carry after three
   iterations at B=1,024, H=10 with its own per-lane planes; the wide
   options' kernels (K2's 4D entry and bfloat16 instances, K3's
   bfloat16 instances, K8's objectives, stash and du2, K9's read-back
   and Jacobians on both carry types, with their device times under
   torch.profiler) on the main path's carry at B=4096, B=16384 and
   B=1024 (the llw solve's first compaction stage and SCHEDULE's last,
   which the measured solves do not reach), and
   the split search against K3 there and on fan-out (a)'s carry
   (decisions agree on >= 0.999 of lanes, 0.98 at the fan-out's shape,
   and then the same trajectory, Jacobians and du2 bit for bit); the batch-major kernels on the carries of phases 6, 7
   and 8(b) after three iterations, K4 and K5 also on the cheetah closed
   loop's (B=32, H=20); 8(b)'s three (K1's batch-major entry, which must
   also give its lanes-last entry's rows bit for bit, K6 and K7) at every
   batch size 8(b) launched them with (B=1,024 and its compaction
   stages), at every batch size the tune of phase 10 launched them with
   (B=128 and its stages, H=20), and, untied to a path, at B=4096, H=200
   on the main path's carry; K4 at (4,1) also on phase 11's carry (B=32,
   H=25, the per-lane expansions of a horizon-masked solve after three
   iterations, padded steps included). Within stated tolerances, timed with CUDA events (and where a
   call is shorter than its host work also as device time under
   torch.profiler), beside the least time the card could take
   (``bound_ms``).

Each path is driven with its kernels' launch counters set to 0 just
before and read just after: phases 2-5 for the lanes-last kernels,
phase 6 and phase 7 for the batch-major ones, each configuration of
phase 8 for its three and the tune of phase 10 for the same three
(``launches_tune`` in their rows), the tune of phase 11 for K4
(``launches_joint_mlp`` in its (4,1) row), each variant of phase 9 for the main
path's kernels (``launches_bf16`` counts a wrapper's bfloat16 instances,
``launches_by_B`` its launches by the batch size of the call). A
kernel that never ran on its path fails the run. Phase 3 runs after
those reads, so its launches do not count.

``--profile`` adds one more phase-6 solve, five closed-loop steps of
each fan-out configuration, one default and one ``llw`` main-path solve
and 20 closed-loop steps of the tune's fan-out, and the joint-MLP fan-out's training
and 20 closed-loop steps, under ``torch.profiler`` and prints the device time by kernel and
the device's busy share.

Output: progress lines, then a JSON line ``{"kernels": [...]}``, the
nvidia-smi name/power-limit line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# The kernels' device time a call under torch.profiler, as the A/B tool
# measures it.
from tools.ab_torch_kernels import device_ms

B_SOLVE = 16384
B_KERNEL = 4096
# SCHEDULE's last compaction stage (0.0625 of B_SOLVE): a shape SCHEDULE
# allows the llw solve to launch K8 and K9 at; the measured solves never
# compacted below B=4096, so its rows are not launches on the path.
B_WIDE_LAST = 1024
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
# Two objectives within K3_TIE (8 float32 ulp) of each other cannot be
# told apart: step sizes whose objectives tie count as the same choice
# (the smallest of the ten, 0.2**6 and below, nearly always tie at
# H=10), and a lane whose returned objective ties with the one it came
# in with is stalled: whether "chosen < old" holds is then a coin toss
# between two summation orders, and kernel and twin count as agreeing.
K3_TIE = 1e-6
# K3 at the shape the fan-out gives it (B=1,024, H=10, the lanes-last
# carry three iterations into the first MPC step, about a third of the
# lanes still active). Near convergence the acceptance ratio is a
# quotient of two small float32 differences, so the knife edge is
# commoner than on the main path's first iteration: the first run on an
# H100 had 2 of 364 active lanes on another step size than the twin
# (0.9945; 0.9935-0.9971 after 1, 2 and 5 iterations), so the floor
# leaves room for three times as many. A lane of equal decisions still
# has gains of ~1e3 that amplify last-digit differences over the
# horizon: per lane, relative to the lane's own largest state, the
# kernel's states were within TOL_K3 of the twin's on 0.9971 of the 341
# lanes of equal decisions, so they are gated as K5's and K7's rollouts
# are, by share. What does not depend on the twin's choice is gated at
# the same tolerances as on the main path: the float64 checks at the
# kernel's own states (controls, next states, the objective under the
# lane's own cost planes, Jacobians, du2) and the carry select.
K3_FAN_AGREE_MIN = 0.98
K3_FAN_WITHIN_MIN = 0.99
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
#     Where the finite lanes are too few for that share to leave room for
#     one lane (the cheetah closed loop's B=32, H=20: 24 finite lanes,
#     one well-conditioned, both float32 evaluations 2e-4 from float64 in
#     the median and up to 3e-2), every lane must be within TOL_K4 or 10
#     times the lane's float32 error: the farthest from the float64
#     evaluation that the plain version comes in float32, on the inputs
#     as they are and on K4_WITNESS_DRAWS draws (from a seed) of the
#     inputs with each element moved by up to one float32 ulp, each a
#     float32 evaluation with other roundings. A draw that makes the
#     lane NaN does not count.
TOL_K4 = 1e-4
K4_WITHIN_MIN = 0.99
K4_WITNESS_DRAWS = 16
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

# Phase 8: the scaling harness's fixed-model fan-out, nothing cut.
FAN_B, FAN_H, FAN_STEPS = 1024, 10, 50
FAN_SCHEDULE = "4:0.5,8:0.25,14:0.125"
FAN_CONFIGS = {
    "a": dict(backward="pallas", fuse_ls=True, lanes_last=True),
    "b": dict(backward="pallas", fuse_ls=False, lanes_last=False),
}
FANQ_H, FANQ_STEPS = 20, 150
# Phase 10: the tuner. PipelineTuner.run on the phase-2 model with a
# QuadCostFactory and an IterativeLQRFactory pinned at H=20: three BO
# rounds of TUNE_BATCH (two of the initial design, n_initial = 2 x batch,
# and one forest-guided), each round one fan-out bucket of TUNE_BATCH
# candidates x 199 closed-loop steps on the surrogate and the same again
# on the true dynamics; then the incumbent on the true dynamics from the
# canonical start (bench_tune.py:116-125), whose task cost must be finite
# and below TUNE_COST_MAX and whose last observation must lie in the box
# (it reaches the box and stays); then the sequential
# objective against the fan-out on SEQ_ITERS candidates with the horizon
# unpinned (several buckets) on tests/test_torch_tuning.py's near-upright
# start, scored for SEQ_STEPS steps by a quadratic task cost: both are
# float32 with different summation orders and the acceptance rule is
# knife-edge (ROADMAP hazard 1), so at least SEQ_AGREE_MIN of the
# candidates must agree within SEQ_TOL (relative; both inf counts as
# agreement). The model, the incumbent and its scores go to
# OUT_DIR/tune_incumbent.json for tools/torch_incumbent_check.py.
TUNE_BATCH, TUNE_ITERS = 128, 384
TUNE_COMPACT = ((4, 0.5), (8, 0.25), (14, 0.125))
TUNE_H = 20
TUNE_COST_MAX = 200.0
SEQ_ITERS, SEQ_STEPS, SEQ_TOL, SEQ_AGREE_MIN = 4, 40, 1e-3, 3
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
# Phase 11: the joint-MLP tune, bench_tune.py's workload (the main demo:
# CartpoleSwingupV2, Pipeline(MLPFactory, QuadCostFactory,
# IterativeLQRFactory), a defaultcfg MLP surrogate on half the data,
# eval_batch 25, the fan-out's compaction schedule, the true dynamics
# scored by a second fan-out) at full width: max-width 256 nets, widths,
# lr, cost gains and horizon (5..25) tuned, 25 candidates padded to 32
# lanes, 199 closed-loop steps. Cut in depth to fit the run's time limit:
# JM_TRAJS trajectories instead of 500, JM_EPOCHS epochs instead of 50
# (surrogate, candidates and incumbent), JM_ITERS candidates (one round,
# of the initial design) instead of 100, and the bucket pinned to
# JM_PIN (the MLPFactory defaults), so that a round is one fan-out call on
# the surrogate and one on the true dynamics.
JM_TRAJS, JM_EPOCHS, JM_ITERS, JM_BATCH = 40, 20, 25, 25
JM_PIN = dict(n_hidden_layers="2", nonlintype="relu")
JM_COMPACT = ((4, 0.5), (8, 0.25), (14, 0.125))
# Phase 2's SINDy: the 55-term trig + interaction library.
SINDY_KW = dict(method="lstsq", threshold=1e-3, trig_basis=True, trig_freq=1,
                trig_interaction=True, time_mode="discrete")
# First MPC step, configuration (a) against (b): both run the same
# algorithm in float32 with different summation orders (the fused
# kernel's in-register objective against a tensor reduction; the packed
# against the split Jacobian layout), and the acceptance rule is
# knife-edge (ROADMAP §C1): a lane whose step size flips on a last-digit
# difference ends at another local solution. So the accepted objectives
# of the lanes converged in both must agree within FAN_OBJ_TOL
# (relative) on at least FAN_AGREE_MIN of them. The first run on an H100
# had all 1,024 lanes converged in both, the difference at 7.6e-9 in the
# median and 1.8e-7 at the 90th percentile, and 25 lanes (0.024) beyond
# 1e-3, up to 8.9e-2: the tolerance sits between the two populations,
# the share leaves room for twice as many flipped lanes.
FAN_OBJ_TOL = 1e-3
FAN_AGREE_MIN = 0.95
# K6: as K2 (the same recursion), normwise.
TOL_K6 = 1e-3
# K7: float32 closed-loop rollouts through the feature model, held
#     against the plain version per rollout as K5 is: relative to the
#     rollout's own largest state, over the first K7_HEAD steps every
#     rollout within TOL_K7_HEAD, over the whole horizon K7_WITHIN_MIN of
#     them within TOL_K7 (gains of ~1e3 amplify last-digit differences
#     over 200 steps); each control and next state against a float64
#     evaluation at the kernel's OWN states to TOL_K7_SUM of the summed
#     magnitudes of their terms.
K7_HEAD = 10
TOL_K7_HEAD = 1e-5
TOL_K7 = 1e-4
K7_WITHIN_MIN = 0.99
TOL_K7_SUM = 1e-5

# Phase 9: the main path's wide options at its own shape (B_SOLVE, H,
# SCHEDULE: every compaction stage is a multiple of 1024, so the wide
# kernels run at every stage). ``env`` is AMPC_BQ_WIDE_IO for the solve.
WIDE_VARIANTS = {
    "llw": dict(kw=dict(ls_wide=True), env="cast"),
    "ll": dict(kw={}, env="reshape"),
    "llb": dict(kw=dict(jac_dtype="bf16"), env="cast"),
}
# The counters each variant must show above zero.
WIDE_REQUIRED = {
    "llw": ("wide_objectives", "wide_reroll"),
    "ll": ("backward_quad_ll_wide_4d",),
    "llb": ("backward_quad_ll[bf16]", "fused_line_search[bf16]"),
}
# K8's objectives, stashed trajectories and du2 against the plain
# version's, per (lane, step size), relative (each trajectory to its own
# largest state): the large step sizes' rollouts amplify last-digit
# state differences through gains of ~1e3 (as K7's do), so by share, as
# K7's rollouts are gated. K8 against K3 is exact: one shared candidate
# pass.
K8_WITHIN_MIN = 0.99
# K2 on the wide options' paths against its plain version, per lane: a
# 200-step float32 recursion leaves a few lanes ill-conditioned, more of
# them at B=16384 (normwise 8.7e-4 there against 1.4e-5 at B=4096, on
# an H100): lanes within TOL_K2 of the output's largest value on this
# share of the lanes; the bit-for-bit checks keep their tolerance.
K2_WITHIN_MIN = 0.999
# K9 reads the selected candidate back from K8's stash: given the same
# stash, its states, controls and du2 equal the plain version's bit for
# bit, and its Jacobians are held to TOL_K1 as K1's are. The stashed
# trajectory itself is K8's (above) and is held against float64 at its
# own states (TOL_K3_SUM, as K3's).


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


def ptxas_report(log):
    """(kernel, registers, spill-store bytes) of each kernel instance in
    the ``-Xptxas -v`` build log, the instance named by its function and
    template arguments (``fused_ls_kernel<4,1,bf16>``)."""
    import re

    rows, entry, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            n, rest = int(m[1]), m[2]
            args, tail = [], rest[n:]
            if tail.startswith("I"):
                for tok in re.finditer(r"Li(\d+)E|Lb([01])E|13__nv_bfloat16|f|(E)", tail[1:]):
                    if tok[3]:
                        break
                    args.append(tok[1] or tok[2] or ("bf16" if tok[0] != "f" else "f32"))
            entry, spill = rest[:n] + (f"<{','.join(args)}>" if args else ""), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            spill = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows.append((entry, int(m[1]), spill))
            entry = None
    return rows


def draw_x0(rng, n, dev):
    from autompc_torch import default_dtype

    x0 = rng.uniform(-1, 1, (n, 4)) * np.array([3.1, 1.0, 1.0, 1.0])
    return torch.as_tensor(x0, dtype=default_dtype(dev), device=dev)


def bound_keys(total_bytes, total_ops):
    """The report's ``bound_ms`` and ``bound_by``: the least time the
    card could take to move ``total_bytes`` (every input read once,
    every output written once) and to do ``total_ops`` float32
    operations, the larger of the two (each also given on its own). No
    single PyTorch call computes any of these kernels' functions, so
    ``library_ms`` is None for all of them."""
    t_bytes = total_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = total_ops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes_ms=t_bytes, bound_ops_ms=t_ops, library_ms=None)


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


def k3_bound(io_bytes, B, H, n_terms, L, ds=4):
    """K3's bound keys. Bytes: its inputs and outputs only. Operations:
    L rollout-steps a lane-step (the term values, the coefficient
    products, the feedback law, the stage cost and the du2 term) and one
    evaluation of the Jacobian. ``scratch_bytes_ms`` is beside the
    bound, not in it: the time the kernel's own scratch traffic takes at
    the memory rate (every candidate's states and controls written, L
    (ds + 1) floats a lane-step, and the selected candidate's read
    back), which the function itself does not need."""
    stash = 4 * (ds + 1) * H * B * (L + 1)
    ops = B * H * (L * (n_terms * 13 + 34) + feature_flops(n_terms, ds + 1, ds))
    return dict(bound_keys(io_bytes, ops), scratch_bytes_ms=stash / HBM_BYTES_PER_S * 1e3)


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


def check_k4(tag, K4, k4_args, launches, device_time=False):
    """K4 against its plain version on ``k4_args`` (Jx, Ju and the dense
    expansions a path gives it), both held against a float64 evaluation
    (see TOL_K4). Returns (its report row, failure strings, the kernel's
    outputs, the lanes finite in every evaluation); ``device_time`` adds
    the kernel's device time under torch.profiler."""
    B, H, ds, dc = k4_args[1].shape
    dev = k4_args[0].device
    failures = []
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
    few = int(ok.sum()) * (1 - K4_WITHIN_MIN) < 1
    lane_txt, lanes_within = "", False
    if few:
        # Each lane against its own float32 error (see TOL_K4).
        gen = torch.Generator(device=dev).manual_seed(0)
        e32 = ep.clone()
        for _ in range(K4_WITNESS_DRAWS):
            nudged = [(a.double() * (1 + 2.0 ** -23 * (2 * torch.rand(
                a.shape, generator=gen, dtype=torch.float64, device=a.device) - 1))).float()
                for a in k4_args]
            e32 = torch.maximum(e32, lane_err(K4.riccati_general_plain(*nudged))[ok]
                                .nan_to_num(0.0))
        lanes_within = bool((ek <= torch.clamp(10.0 * e32, min=TOL_K4)).all())
        # The lanes outside the share's rule, and the plain version in
        # float32 on the CPU (another summation order) there.
        outside = (ek > torch.clamp(10.0 * ep, min=TOL_K4)).nonzero().flatten()
        ids = ok.nonzero().flatten()
        e_cpu = lane_err(tuple(t.to(dev) for t in K4.riccati_general_plain(
            *(a.cpu() for a in k4_args))))[ok]
        lane_txt = (f"; {int(ok.sum())} finite lanes, too few for the share: every lane "
                    f"within max({TOL_K4}, 10 x its float32 error over {K4_WITNESS_DRAWS} "
                    f"draws): {lanes_within}; lanes outside max({TOL_K4}, 10 x plain's): "
                    + ", ".join(f"lane {int(ids[i])} kernel {float(ek[i]):.3e} plain "
                                f"{float(ep[i]):.3e} plain on the CPU {float(e_cpu[i]):.3e} "
                                f"float32 over the draws {float(e32[i]):.3e}" for i in outside))
    well = ok.clone()
    well[ok] = wc
    row = dict(
        name=f"riccati_general[{ds},{dc}]", route="cuda",
        source="autompc_torch/csrc/riccati_general.cu",
        replaces="autompc_tpu/ops/pallas_riccati.py:" + ("1260" if dc > 1 else "1338"),
        launches=launches,
        max_abs_err=max(abs_err(a[well], b[well]) for a, b in zip(gk, gp)),
        ms=time_ms(lambda: K4.riccati_general(*k4_args)),
        plain_ms=time_ms(lambda: K4.riccati_general_plain(*k4_args), reps=3),
        **bound_keys(n_bytes(*k4_args, *gk), B * H * riccati_flops(ds, dc)),
    )
    if device_time:
        row["device_ms"] = device_ms(lambda: K4.riccati_general(*k4_args))
    print(f"[3] K4 general backward {tag} ({ds},{dc}) B={B}: finite lanes {int(ok.sum())} "
          f"(kernel and plain agree on which: {same_finite:.4f}); per-lane error vs float64: "
          f"kernel median {float(ek.median()):.3e} max {float(ek.max()):.3e}, plain float32 "
          f"median {float(ep.median()):.3e} max {float(ep.max()):.3e}; {int(wc.sum())} "
          f"well-conditioned lanes (plain within {TOL_K4 / 10}): kernel's worst "
          f"{worst_well:.3e} (tol {TOL_K4}); kernel within max({TOL_K4}, 10 x plain's) on "
          f"{within:.4f} of all lanes (min {K4_WITHIN_MIN}); kernel's error over plain's: "
          f"median {float((ek / ep.clamp_min(1e-30)).median()):.2f}, 99% "
          f"{float((ek / ep.clamp_min(1e-30)).quantile(0.99)):.2f}"
          + lane_txt, flush=True)
    if worst_well > TOL_K4 or same_finite < K4_WITHIN_MIN or not (
            within >= K4_WITHIN_MIN or lanes_within):
        failures.append(f"K4 {tag}: worst well-conditioned lane {worst_well:.3e}, within "
                        f"tolerance on {within:.4f} of lanes, finite flags agree on "
                        f"{same_finite:.4f}")
    return row, failures, gk, ok


def check_batch_major_kernels(tag, model, cost, solver_kw, x0, K4, K5, launches,
                              n_iters=3, head_f64=False):
    """K4 and K5 against their plain versions on the carry of the
    batch-major solver after ``n_iters`` iterations. With ``head_f64``, a K5 rollout whose first
    K5_HEAD steps miss TOL_K5_HEAD against the plain version passes if
    it is no farther from the plain version run in float64 than the
    plain float32 version is. Returns (report rows, failure strings)."""
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
    row, failures, gk, ok = check_k4(tag, K4, k4_args, launches["K4"])
    rows.append(row)

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
    if not live.any():
        return rows, failures + [f"K5 {tag}: no lane with finite gains and carry to compare"]
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
    # The plain version's rollouts in float64: how far the kernel and the
    # plain float32 version each are from them over the first K5_HEAD
    # steps, per rollout, relative to its largest float64 state there.
    rx64, _ = K5.mlp_line_search_plain(
        tuple((W.double(), b.double()) for W, b in layers), nonlin,
        *(t.double() for t in k5_args[2:7]), *k5_args[7:])
    n_head = K5_HEAD + 1
    ref = rx64[:, :, :n_head].abs().amax(dim=(2, 3)).clamp_min(1e-30)
    e_k64, e_p64 = ((a[:, :, :n_head].double() - rx64[:, :, :n_head]).abs().amax(dim=(2, 3))
                    / ref for a in (kx, px))
    head_ok = rollout_err(n_head) <= TOL_K5_HEAD
    if head_f64:
        head_ok |= e_k64 <= e_p64
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
          f"magnitudes (tol {TOL_K5_SUM}); first {K5_HEAD} steps vs the float64 rollouts: "
          f"kernel worst {float(e_k64.max()):.3e}, plain float32 worst "
          f"{float(e_p64.max()):.3e}; rollouts over {TOL_K5_HEAD} against plain "
          f"{int((rollout_err(n_head) > TOL_K5_HEAD).sum())}"
          + (f", of them no farther from float64 than plain float32 "
             f"{int(((rollout_err(n_head) > TOL_K5_HEAD) & (e_k64 <= e_p64)).sum())}"
             if head_f64 else ""), flush=True)
    if not (bool(head_ok.all()) and full_within >= K5_WITHIN_MIN
            and e_u <= TOL_K5_SUM and e_x <= TOL_K5_SUM):
        failures.append(f"K5 {tag} head {e_head:.3e} full within {full_within:.4f} "
                        f"u {e_u:.3e} next x {e_x:.3e}")
    return rows, failures


def fanout_candidates(dev, n, seed=0):
    """The harness's candidate batch: Qdiag, Fdiag = 10**U(-1, 1.5),
    Rdiag = 10**U(-3, 0), as tensors on the card."""
    from autompc_torch import default_dtype

    rng = np.random.default_rng(seed)
    batch = {"Qdiag": 10 ** rng.uniform(-1, 1.5, (n, 4)),
             "Fdiag": 10 ** rng.uniform(-1, 1.5, (n, 4)),
             "Rdiag": 10 ** rng.uniform(-3, 0, (n, 1))}
    return {k: torch.as_tensor(v, dtype=default_dtype(dev), device=dev)
            for k, v in batch.items()}


def lane_objective(xs, us, cp, dt):
    """The per-lane-cost objective of batch-major trajectories, float64."""
    xs, us = xs.double(), us.double()
    H = us.shape[1]
    oc = (xs[:, :H] ** 2 * cp["Qdiag"].double()[:, None, :]).sum(dim=(1, 2))
    cc = (us ** 2 * cp["Rdiag"].double()[:, None, :]).sum(dim=(1, 2))
    return dt * (oc + cc) + (xs[:, H] ** 2 * cp["Fdiag"].double()).sum(1)


def bits_equal(a, b):
    """Bit-for-bit equality (NaN equal to the same NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                torch.float64: torch.int64}[a.dtype]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def split_agreement(split, fused, act):
    """The split search's outputs against K3's (both the
    ``fused_line_search`` tuple): the share of the active lanes on which
    the two make the same decision (flags and accepted objective), and
    whether xs, us, jac and du2 are equal bit for bit on every lane of
    the same decision."""
    agree = (split[3] == fused[3]) & (split[4] == fused[4]) & (split[2] == fused[2])
    bits = all(bits_equal(split[i][..., agree], fused[i][..., agree]) for i in (0, 1, 5, 6))
    return agree[act].float().mean().item(), bits


def lane_share(a, b, tol, own_scale=False):
    """Share of lanes (the last axis) whose largest difference between
    ``a`` and ``b`` is within ``tol`` of ``b``'s largest magnitude: over
    all lanes, or with ``own_scale`` over the lane's own."""
    a, b = a.double().reshape(-1, a.shape[-1]), b.double().reshape(-1, b.shape[-1])
    d = (a - b).abs().amax(0)
    scale = b.abs().amax(0) if own_scale else b.abs().max()
    return (d <= tol * scale.clamp_min(1e-30)).float().mean().item()


def wide_counters(K1, K2, K3):
    """Launch counters of the feature-model kernels, by name: (wrapper,
    attribute). ``launches_bf16`` counts a wrapper's bfloat16 instances
    (a share of its ``launches``), ``launches_by_B`` its launches by the
    batch size of the call. The batch-major ones (K1's batch-major entry,
    K6, K7) run on fan-out (b), not on the main path."""
    return {
        "relin_jacobians": (K1.relin_jacobians, "launches"),
        "relin_jacobians[by B]": (K1.relin_jacobians, "launches_by_B"),
        "relin_jacobians_bm": (K1.relin_jacobians_bm, "launches"),
        "relin_jacobians_bm[by B]": (K1.relin_jacobians_bm, "launches_by_B"),
        "backward_quad": (K2.backward_quad, "launches"),
        "backward_quad[by B]": (K2.backward_quad, "launches_by_B"),
        "sindy_line_search": (K3.sindy_line_search, "launches"),
        "sindy_line_search[by B]": (K3.sindy_line_search, "launches_by_B"),
        "backward_quad_ll": (K2.backward_quad_ll, "launches"),
        "backward_quad_ll[bf16]": (K2.backward_quad_ll, "launches_bf16"),
        "backward_quad_ll_wide_4d": (K2.backward_quad_ll_wide_4d, "launches"),
        "fused_line_search": (K3.fused_line_search, "launches"),
        "fused_line_search[bf16]": (K3.fused_line_search, "launches_bf16"),
        "wide_objectives": (K3.wide_objectives, "launches"),
        "wide_objectives[by B]": (K3.wide_objectives, "launches_by_B"),
        "wide_reroll": (K3.wide_reroll, "launches"),
        "wide_reroll[bf16]": (K3.wide_reroll, "launches_bf16"),
        "wide_reroll[by B]": (K3.wide_reroll, "launches_by_B"),
    }


def reset_counters(counters):
    """Every count to 0 (a count by batch size to {})."""
    for w, attr in counters.values():
        setattr(w, attr, type(getattr(w, attr))())


def read_counters(counters):
    return {name: (lambda v: dict(v) if isinstance(v, dict) else v)(getattr(w, attr))
            for name, (w, attr) in counters.items()}


class wide_io_env:
    """AMPC_BQ_WIDE_IO set for the ``with`` block (the solver reads it
    once per solve, as the JAX solver reads it once per trace)."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        import os

        self.old = os.environ.get("AMPC_BQ_WIDE_IO")
        os.environ["AMPC_BQ_WIDE_IO"] = self.value

    def __exit__(self, *exc):
        import os

        if self.old is None:
            os.environ.pop("AMPC_BQ_WIDE_IO", None)
        else:
            os.environ["AMPC_BQ_WIDE_IO"] = self.old


def fanout_phase(bench, model, dev, card, wrappers, profile=False):
    """Phase 8 and 8q. ``wrappers`` maps a configuration to the three
    kernel wrappers of its path. Returns ({config: launches}, {config:
    launches by batch size}, {config: the fan-out's solver keywords},
    the candidate batch)."""
    from autompc_torch.control import make_scheduled_ilqr_solver, parse_schedule
    from autompc_torch.costs import ThresholdCost
    from autompc_torch.parallel import QuadCostFanout

    batch = fanout_candidates(dev, FAN_B)
    spec = (model.library, "coeffs")

    def make(cfg, task, horizon, n_steps, schedule=FAN_SCHEDULE):
        return QuadCostFanout(bench.system, task, model, model, horizon=horizon,
                              n_steps=n_steps, goal=np.zeros(4), compact_schedule=schedule,
                              feature_spec=spec, **FAN_CONFIGS[cfg])

    counts, by_B, solver_kw = {}, {}, {}
    for cfg in FAN_CONFIGS:
        fanout = make(cfg, bench.task, FAN_H, FAN_STEPS)
        solver_kw[cfg] = fanout.solver_kw
        for w in wrappers[cfg]:
            w.launches = 0
            if hasattr(w, "launches_by_B"):
                w.launches_by_B = {}
        t0 = time.perf_counter()
        scores = fanout(batch)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(3):
            scores = fanout(batch)
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts[cfg] = {w.__name__: w.launches for w in wrappers[cfg]}
        by_B[cfg] = {w.__name__: dict(w.launches_by_B) for w in wrappers[cfg]
                     if hasattr(w, "launches_by_B")}
        if tuple(scores.shape) != (FAN_B,) or torch.isnan(scores).any():
            raise RuntimeError(f"fan-out ({cfg}): malformed or NaN scores")
        fin = torch.isfinite(scores)
        print(f"[8] fan-out ({cfg}) {FAN_CONFIGS[cfg]}: B={FAN_B} H={FAN_H} "
              f"{FAN_STEPS} steps: warm call {warm_s:.2f} s; 3 timed calls {elapsed:.3f} s -> "
              f"{3 * FAN_B / elapsed:.1f} evals/s on {card}; scores finite {int(fin.sum())}, "
              f"inf {int((~fin).sum())}, mean of finite {float(scores[fin].mean()):.2f}; "
              f"launches in 4 calls {counts[cfg]}, by B {by_B[cfg]}", flush=True)
        if min(counts[cfg].values()) == 0:
            raise RuntimeError(f"a kernel never ran on the fan-out path ({cfg}): {counts[cfg]}")
        if profile:
            short = make(cfg, bench.task, FAN_H, 5)
            profile_solve(short, (batch,), f"5 closed-loop steps of fan-out ({cfg})")

    # The first MPC step's solve, (a) against (b), same candidates and start.
    x0 = batch["Qdiag"].new_tensor(np.tile(bench.task.get_init_obs(), (FAN_B, 1)))
    ug = x0.new_zeros((FAN_B, FAN_H, 1))
    outs = {
        cfg: make_scheduled_ilqr_solver(
            model.pred_core, None, schedule=parse_schedule(FAN_SCHEDULE), **solver_kw[cfg]
        )(model.params, x0, ug, batch)
        for cfg in FAN_CONFIGS
    }
    dt = bench.system.dt
    obj = {cfg: lane_objective(o[1], o[2], batch, dt) for cfg, o in outs.items()}
    both = outs["a"][0] & outs["b"][0]
    rel = ((obj["a"] - obj["b"]).abs() / obj["b"].abs().clamp_min(1e-30))[both]
    share = float((rel <= FAN_OBJ_TOL).float().mean()) if both.any() else 0.0
    print(f"[8] first MPC step, (a) vs (b): converged (a) {int(outs['a'][0].sum())}, (b) "
          f"{int(outs['b'][0].sum())}, both {int(both.sum())} of {FAN_B}; accepted objective "
          f"relative difference on those: median {float(rel.median()):.3e}, 90% "
          f"{float(rel.quantile(0.9)):.3e}, 99% {float(rel.quantile(0.99)):.3e}, max "
          f"{float(rel.max()):.3e}; within {FAN_OBJ_TOL} on {share:.4f} (min {FAN_AGREE_MIN})",
          flush=True)
    if int(both.sum()) < FAN_B // 4 or share < FAN_AGREE_MIN:
        raise RuntimeError(f"fan-out first step: {int(both.sum())} lanes converged in both, "
                           f"objectives agree on {share:.4f}")

    # 8q: a shape that discriminates (the pole-only metric of
    # tests/test_parallel.py; the full metric saturates at this shape).
    task = bench.task.copy()
    task.set_cost(ThresholdCost(bench.system, goal=np.zeros(4), threshold=0.2,
                                obs_range=(0, 2)))
    pair = {"Qdiag": [[10.0, 0.1, 0.01, 0.01], [0.001, 0.001, 100.0, 100.0]],
            "Fdiag": [[10.0, 0.1, 0.01, 0.01], [0.001, 0.001, 100.0, 100.0]],
            "Rdiag": [[0.001], [10.0]]}
    pair = {k: np.asarray(v) for k, v in pair.items()}
    for cfg in FAN_CONFIGS:
        t0 = time.perf_counter()
        good, bad = make(cfg, task, FANQ_H, FANQ_STEPS, schedule=None)(pair).tolist()
        print(f"[8q] fan-out ({cfg}) H={FANQ_H}, {FANQ_STEPS} steps, pole-only metric: sensible "
              f"weighting {good:.1f}, absurd weighting {bad:.1f} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        if not good < bad:
            raise RuntimeError(f"fan-out ({cfg}): sensible weighting {good} does not beat "
                               f"the absurd one {bad}")
    return counts, by_B, solver_kw, batch


def tune_phase(bench, model, trajs, dev, card, fan_wrappers, profile=False):
    """Phase 10. Returns (the tune's launches of K1's batch-major entry, K6
    and K7, the same by batch size, the tune's fan-out solver keywords,
    the first round's candidate diagonals)."""
    from autompc_torch import native
    from autompc_torch.control import IterativeLQRFactory
    from autompc_torch.costs import QuadCost, QuadCostFactory
    from autompc_torch.parallel import QuadCostFanout
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.sysid import FunctionModel
    from autompc_torch.tuning import bo, pipeline_tuner
    from autompc_torch.tuning import PipelineTuner
    from autompc_torch.utils import simulate

    t_phase = time.perf_counter()
    if not native.NativeRandomForest.available():
        raise RuntimeError(f"the native random forest did not build: {native.build_error()}")
    print(f"[10] native forest: {native.library_path().name}", flush=True)
    system, task = bench.system, bench.task
    goal = np.zeros(4)
    spec = (model.library, "coeffs")

    # Timing hooks: each ask starts a round; each fan-out call is timed
    # to its result on the host. The Python forest is refused, so a
    # failed native fit cannot fall back to it unseen.
    rounds, fits = [], []

    class TimedBO(bo.BatchBayesOpt):
        def ask(self, batch_size=None):
            t0 = time.perf_counter()
            out = super().ask(batch_size)
            rounds.append({"ask_s": time.perf_counter() - t0, "n": len(out)})
            return out

    def refuse_python_forest(*a, **k):
        raise RuntimeError("the BO fell back to the Python forest")

    real_make_forest = native.make_forest

    def counting_make_forest(*a, **k):
        f = real_make_forest(*a, **k)
        fits.append(type(f).__name__)
        return f

    tuner = PipelineTuner(
        surrogate_mode="pretrain", eval_batch=TUNE_BATCH, use_fanout=True,
        fanout_backward="pallas", fanout_feature_kernels=True, fanout_compact=TUNE_COMPACT)
    real_eval = tuner._eval_batch_fanout

    def timed_eval(pipeline, task_, surrogate, cfgs, fanouts, kind, sysid_trajs=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_eval(pipeline, task_, surrogate, cfgs, fanouts, kind, sysid_trajs)
        key = "true_s" if isinstance(surrogate, FunctionModel) else "surr_s"
        rounds[-1][key] = time.perf_counter() - t0
        return out

    tuner._eval_batch_fanout = timed_eval
    pipeline = Pipeline(system, model, QuadCostFactory(system, goal=goal),
                        IterativeLQRFactory(system, horizon=TUNE_H))
    for w in fan_wrappers:
        w.launches, w.launches_by_B = 0, {}
    saved = (pipeline_tuner.BatchBayesOpt, bo.RandomForestSurrogate, native.make_forest)
    pipeline_tuner.BatchBayesOpt, bo.RandomForestSurrogate = TimedBO, refuse_python_forest
    native.make_forest = counting_make_forest
    try:
        t0 = time.perf_counter()
        controller, res = tuner.run(pipeline, task, trajs, n_iters=TUNE_ITERS,
                                    rng=np.random.default_rng(100), surrogate=model,
                                    truedyn=bench.dynamics)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
    finally:
        pipeline_tuner.BatchBayesOpt, bo.RandomForestSurrogate, native.make_forest = saved
    launches = {w.__name__: w.launches for w in fan_wrappers}
    by_B = {w.__name__: dict(w.launches_by_B) for w in fan_wrappers}

    costs, true_costs = np.array(res.costs), np.array(res.truedyn_costs)
    end = 0
    for r, rd in enumerate(rounds):
        end += rd["n"]
        fan_s = rd.get("surr_s", 0.0) + rd.get("true_s", 0.0)
        print(f"[10] round {r + 1} ({'forest-guided' if end > 2 * TUNE_BATCH else 'initial design'}"
              f", {rd['n']} candidates): ask {rd['ask_s']:.3f} s; surrogate fan-out "
              f"{rd.get('surr_s', 0.0):.2f} s, true-dynamics fan-out {rd.get('true_s', 0.0):.2f} s "
              f"-> {rd['n'] / rd['surr_s']:.1f} evals/s on the surrogate, "
              f"{rd['n'] / fan_s:.1f} with both fan-outs on {card}; incumbent surrogate cost "
              f"{res.inc_costs[end - 1]:.1f}, its true-dynamics cost "
              f"{res.inc_truedyn_costs[end - 1]:.1f}", flush=True)
    ask_s = sum(rd["ask_s"] for rd in rounds)
    surr_s = sum(rd.get("surr_s", 0.0) for rd in rounds)
    true_s = sum(rd.get("true_s", 0.0) for rd in rounds)
    print(f"[10] tune {TUNE_ITERS} candidates (H={TUNE_H}, {task.get_num_steps() - 1} MPC steps "
          f"each, both fan-outs): {tune_s:.2f} s; BO asks {ask_s:.2f} s ({len(fits)} native "
          f"forest fits), surrogate fan-outs {surr_s:.2f} s, true-dynamics fan-outs "
          f"{true_s:.2f} s, the rest {tune_s - ask_s - surr_s - true_s:.2f} s; scores finite "
          f"{int(np.isfinite(costs).sum())} / {costs.size} on the surrogate, "
          f"{int(np.isfinite(true_costs).sum())} / {true_costs.size} on the true dynamics; "
          f"launches {launches}, by B {by_B}", flush=True)
    if len(costs) != TUNE_ITERS or len(true_costs) != TUNE_ITERS \
            or np.isnan(costs).any() or np.isnan(true_costs).any():
        raise RuntimeError("tune: a score is missing or NaN")
    if min(launches.values()) == 0:
        raise RuntimeError(f"a kernel never ran in the tune: {launches}")
    if not fits or set(fits) != {"NativeRandomForest"}:
        raise RuntimeError(f"tune: the BO's forests were {fits}, not the native one")

    # The incumbent on the true dynamics from the canonical start.
    t0 = time.perf_counter()
    traj = simulate(controller, task.get_init_obs(), term_cond=task.term_cond,
                    dynamics=bench.dynamics, max_steps=task.get_num_steps())
    final_cost = float(task.get_cost()(traj))
    in_box = float(task.get_cost().eval_obs_cost(traj.obs[-1:]).sum()) == 0.0
    sim_s = time.perf_counter() - t0
    print(f"[10] incumbent {res.inc_cfg.get_dictionary()}: simulate {len(traj) - 1} steps on "
          f"the true dynamics in {sim_s:.2f} s; task cost {final_cost:.1f} (max "
          f"{TUNE_COST_MAX}; its fan-out scores: surrogate {res.inc_costs[-1]:.1f}, true "
          f"dynamics {res.inc_truedyn_costs[-1]:.1f}); final state "
          f"{[round(float(v), 4) for v in traj.obs[-1]]}, in the box {in_box}", flush=True)
    if not (np.isfinite(final_cost) and final_cost < TUNE_COST_MAX and in_box):
        raise RuntimeError(f"tune: the incumbent's true-dynamics task cost is {final_cost}, "
                           f"its last observation in the box {in_box}")

    # What tools/torch_incumbent_check.py replays: the model, the
    # incumbent and its scores here.
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "tune_incumbent.json"), "w") as f:
        json.dump({"sindy": SINDY_KW, "coeffs": model.coeffs.cpu().double().tolist(),
                   "feature_names": model.get_feature_names(), "factory": {"horizon": TUNE_H},
                   "compact": TUNE_COMPACT, "cfg": res.inc_cfg.get_dictionary(),
                   "card": {"simulate": final_cost, "fanout_surrogate": float(res.inc_costs[-1]),
                            "fanout_truedyn": float(res.inc_truedyn_costs[-1])}}, f)

    # Sequential objective against the fan-out, horizons unpinned, scored
    # by a quadratic task cost: a continuous score, so that each of the
    # four candidates tests the two closed loops (the 0.2-box count
    # saturates at its maximum for a candidate that never reaches it).
    seq_task = task.copy()
    seq_task.set_cost(QuadCost(system, Q=np.eye(4), R=0.01 * np.eye(1), F=np.eye(4), goal=goal))
    seq_task.set_init_obs(np.array([0.5, 0.0, 0.0, 0.0]))
    seq_task.set_num_steps(SEQ_STEPS)
    free = Pipeline(system, model, QuadCostFactory(system, goal=goal), IterativeLQRFactory(system))
    t0 = time.perf_counter()
    scores = [
        PipelineTuner(surrogate_mode="pretrain", eval_batch=SEQ_ITERS, **kw).run(
            free, seq_task, trajs, n_iters=SEQ_ITERS, rng=np.random.default_rng(3),
            surrogate=model)[1]
        for kw in ({}, dict(use_fanout=True, fanout_backward="pallas",
                            fanout_feature_kernels=True))
    ]
    seq_fan_s = time.perf_counter() - t0
    agree = 0
    for i, (cfg, a, b) in enumerate(zip(scores[0].cfgs, scores[0].costs, scores[1].costs)):
        ok = (a == b) or (np.isfinite(a) and np.isfinite(b)
                          and abs(a - b) <= SEQ_TOL * max(abs(b), 1e-30))
        agree += ok
        print(f"[10] candidate {i} (horizon {cfg['_ctrlr:horizon']}): sequential {a!r}, "
              f"fan-out {b!r}, relative difference {abs(a - b) / max(abs(b), 1e-30):.3e}"
              f"{'' if ok else ' DIFFER'}", flush=True)
    same_cfgs = [c.get_dictionary() for c in scores[0].cfgs] == \
        [c.get_dictionary() for c in scores[1].cfgs]
    print(f"[10] sequential vs fan-out ({SEQ_STEPS}-step near-upright task, quadratic task "
          f"cost): {agree} of "
          f"{SEQ_ITERS} agree within {SEQ_TOL} (min {SEQ_AGREE_MIN}); same configurations "
          f"{same_cfgs}; {seq_fan_s:.2f} s", flush=True)
    if agree < SEQ_AGREE_MIN or not same_cfgs:
        raise RuntimeError(f"tune: sequential and fan-out agree on {agree} of {SEQ_ITERS}")
    print(f"[10] phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)

    if profile:
        fan = QuadCostFanout(system, task, model, model, horizon=TUNE_H, n_steps=20, goal=goal,
                             compact_schedule=TUNE_COMPACT, backward="pallas", feature_spec=spec)
        profile_solve(fan, (tune_candidates(res.cfgs[:TUNE_BATCH], system, dev),),
                      f"20 closed-loop steps of the tune's fan-out (B={TUNE_BATCH})")
    kw = QuadCostFanout(system, task, model, model, horizon=TUNE_H, goal=goal,
                        compact_schedule=TUNE_COMPACT, backward="pallas",
                        feature_spec=spec).solver_kw
    return launches, by_B, kw, tune_candidates(res.cfgs[:TUNE_BATCH], system, dev)


def joint_mlp_phase(dev, card, K4, profile=False):
    """Phase 11. Returns (K4's launches in the tune, the same by batch
    size, the inputs K4 takes on the tune's first fan-out after three
    iterations of its first closed-loop step)."""
    from autompc_torch.benchmarks import CartpoleSwingupV2Benchmark
    from autompc_torch.control import IterativeLQRFactory, ilqr
    from autompc_torch.control import make_batched_ilqr_solver
    from autompc_torch.costs import QuadCostFactory
    from autompc_torch.parallel import JointMLPQuadCostFanout
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.sysid import FunctionModel, MLPFactory
    from autompc_torch.tuning import PipelineTuner, bo, pipeline_tuner
    from autompc_torch.utils import simulate

    t_phase = time.perf_counter()
    bench = CartpoleSwingupV2Benchmark()
    system, task = bench.system, bench.task
    trajs = bench.gen_trajs(seed=100, n_trajs=JM_TRAJS, traj_len=200)
    torch.cuda.synchronize()
    print(f"[11] CartpoleSwingupV2 data {JM_TRAJS} x 200: {time.perf_counter() - t_phase:.2f} s",
          flush=True)

    # Timing hooks: each ask opens a round; each fan-out call is timed to
    # its result on the host, its per-lane training apart.
    rounds, calls = [], []

    class TimedBO(bo.BatchBayesOpt):
        def ask(self, batch_size=None):
            t0 = time.perf_counter()
            out = super().ask(batch_size)
            rounds.append({"ask_s": time.perf_counter() - t0, "n": len(out), "calls": []})
            return out

    real_call, real_train = JointMLPQuadCostFanout.__call__, JointMLPQuadCostFanout._train

    def timed_train(self, full, perms=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_train(self, full, perms)
        torch.cuda.synchronize()
        calls[-1].update(train_s=time.perf_counter() - t0, lanes=full["lr"].shape[0])
        return out

    def timed_call(self, batch, init_nets=None, perms=None):
        torch.cuda.synchronize()
        calls.append({"fan": self, "batch": batch, "k4": K4.riccati_general.launches,
                      "k4_by_B": dict(K4.riccati_general.launches_by_B)})
        t0 = time.perf_counter()
        out = real_call(self, batch, init_nets, perms)
        torch.cuda.synchronize()
        calls[-1]["call_s"] = time.perf_counter() - t0
        return out

    tuner = PipelineTuner(
        surrogate_mode="defaultcfg", surrogate_factory=MLPFactory(system, n_train_iters=JM_EPOCHS),
        surrogate_split=0.5, eval_batch=JM_BATCH, use_fanout=True, fanout_backward="pallas",
        fanout_compact=JM_COMPACT)
    real_eval, real_surrogate = tuner._eval_batch_fanout, tuner._get_surrogate

    def timed_eval(pipeline, task_, surrogate, cfgs, fanouts, kind, sysid_trajs=None):
        out = real_eval(pipeline, task_, surrogate, cfgs, fanouts, kind, sysid_trajs)
        calls[-1].update(true=isinstance(surrogate, FunctionModel), surrogate=surrogate,
                         sysid=sysid_trajs)
        rounds[-1]["calls"].append(calls[-1])
        return out

    surr_s = []

    def timed_surrogate(*a, **k):
        t0 = time.perf_counter()
        out = real_surrogate(*a, **k)
        torch.cuda.synchronize()
        surr_s.append(time.perf_counter() - t0)
        return out

    tuner._eval_batch_fanout, tuner._get_surrogate = timed_eval, timed_surrogate
    pipeline = Pipeline(system, MLPFactory(system, n_train_iters=JM_EPOCHS, **JM_PIN),
                        QuadCostFactory(system), IterativeLQRFactory(system))
    K4.riccati_general.launches, K4.riccati_general.launches_by_B = 0, {}
    saved = pipeline_tuner.BatchBayesOpt
    pipeline_tuner.BatchBayesOpt = TimedBO
    JointMLPQuadCostFanout.__call__, JointMLPQuadCostFanout._train = timed_call, timed_train
    try:
        t0 = time.perf_counter()
        controller, res = tuner.run(pipeline, task, trajs, n_iters=JM_ITERS,
                                    rng=np.random.default_rng(100), truedyn=bench.dynamics)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
    finally:
        pipeline_tuner.BatchBayesOpt = saved
        JointMLPQuadCostFanout.__call__, JointMLPQuadCostFanout._train = real_call, real_train
    launches = K4.riccati_general.launches
    by_B = dict(K4.riccati_general.launches_by_B)

    costs, true_costs = np.array(res.costs), np.array(res.truedyn_costs)
    # Each call's K4 launches: the counts before the next call (or at the
    # end) less those before it.
    for c, after in zip(calls, [c["k4_by_B"] for c in calls[1:]] + [by_B]):
        c["k4_launches_by_B"] = {B: after.get(B, 0) - c["k4_by_B"].get(B, 0) for B in by_B}
    end = 0
    for r, rd in enumerate(rounds):
        end += rd["n"]
        txt = "; ".join(
            f"{'true dynamics' if c['true'] else 'surrogate'}: training {c['train_s']:.2f} s, "
            f"closed loop {c['call_s'] - c['train_s']:.2f} s, {rd['n'] / c['call_s']:.2f} "
            f"evals/s, K4 launches by B {c['k4_launches_by_B']}" for c in rd["calls"])
        print(f"[11] round {r + 1} ({rd['n']} candidates, {len(rd['calls'])} fan-out calls of "
              f"{rd['calls'][0]['lanes']} lanes): ask "
              f"{rd['ask_s']:.3f} s; {txt}; incumbent surrogate cost "
              f"{res.inc_costs[end - 1]:.1f}, its true-dynamics cost "
              f"{res.inc_truedyn_costs[end - 1]:.1f} on {card}", flush=True)
    train_s = sum(c["train_s"] for rd in rounds for c in rd["calls"])
    call_s = sum(c["call_s"] for rd in rounds for c in rd["calls"])
    print(f"[11] joint-MLP tune, {JM_ITERS} candidates ({task.get_num_steps() - 1} closed-loop "
          f"steps each, both fan-outs): {tune_s:.2f} s; surrogate fit (defaultcfg MLP) "
          f"{surr_s[0]:.2f} s, BO asks {sum(rd['ask_s'] for rd in rounds):.2f} s, per-lane "
          f"training {train_s:.2f} s, closed loops {call_s - train_s:.2f} s -> "
          f"{JM_ITERS / tune_s:.2f} evals/s with both fan-outs; scores finite "
          f"{int(np.isfinite(costs).sum())} / {costs.size} on the surrogate, "
          f"{int(np.isfinite(true_costs).sum())} / {true_costs.size} on the true dynamics; K4 "
          f"launches {launches}, by B {by_B}", flush=True)
    if len(costs) != JM_ITERS or len(true_costs) != JM_ITERS \
            or np.isnan(costs).any() or np.isnan(true_costs).any():
        raise RuntimeError("joint-MLP tune: a score is missing or NaN")
    if launches == 0:
        raise RuntimeError("K4 never ran in the joint-MLP tune")

    # The incumbent on the true dynamics from the canonical start.
    t0 = time.perf_counter()
    traj = simulate(controller, task.get_init_obs(), term_cond=task.term_cond,
                    dynamics=bench.dynamics, max_steps=task.get_num_steps())
    final_cost = float(task.get_cost()(traj))
    print(f"[11] incumbent {res.inc_cfg.get_dictionary()}: simulate {len(traj) - 1} steps on "
          f"the true dynamics in {time.perf_counter() - t0:.2f} s; task cost {final_cost:.1f} "
          f"(steps outside the box; its fan-out scores: surrogate {res.inc_costs[-1]:.1f}, "
          f"true dynamics {res.inc_truedyn_costs[-1]:.1f}); final state "
          f"{[round(float(v), 4) for v in traj.obs[-1]]}", flush=True)
    if not np.isfinite(final_cost):
        raise RuntimeError(f"joint-MLP tune: the incumbent's true-dynamics task cost is "
                           f"{final_cost}")
    print(f"[11] phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)

    # K4's inputs on this path: the first fan-out call's lanes (B=32,
    # mixed horizons), their nets trained again, the carry after three
    # iterations of the first closed-loop step; the fourth iteration's
    # backward pass is captured, not launched.
    first = rounds[0]["calls"][0]
    fan = first["fan"]
    full, _ = fan._prepare(first["batch"])
    params, cp = fan._solver_inputs(full, fan._train(full))
    _, carry0, _, make_body = make_batched_ilqr_solver(
        fan._pred_core, None, return_pieces=True, **fan.solver_kw)
    B, H = full["lr"].shape[0], fan.solver_kw["H"]
    x0 = full["lr"].new_tensor(np.tile(task.get_init_obs(), (B, 1)))
    carry, body = carry0(params, x0, x0.new_zeros((B, H, 1)), cp), make_body(params)
    for _ in range(3):
        carry = body(carry)
    captured = []

    def capture(*args):
        captured.append(tuple(a.contiguous() for a in args))
        return K4.riccati_general_plain(*args)

    real_k4 = ilqr.riccati_general
    ilqr.riccati_general = capture
    try:
        body(carry)
    finally:
        ilqr.riccati_general = real_k4
    heff = full["horizons"].tolist()
    print(f"[11] K4's inputs for phase 3: B={B}, H={H}, horizons {sorted(set(heff))} "
          f"({sum(H - h for h in heff)} inert lane-steps of {B * H})", flush=True)
    if profile:
        fan20 = JointMLPQuadCostFanout(
            system, task, dict(n_hidden_layers=int(JM_PIN["n_hidden_layers"]),
                               nonlintype=JM_PIN["nonlintype"]),
            first["sysid"], first["surrogate"], horizon=H, n_steps=20, horizon_mask=True,
            pad_to=JM_BATCH, compact_schedule=JM_COMPACT, backward="pallas",
            n_train_iters=JM_EPOCHS)
        profile_solve(fan20, (first["batch"],),
                      f"the joint-MLP fan-out's training and 20 closed-loop steps (B={B}, H={H})")
    return launches, by_B, captured[0]


def check_tune_kernels(model, solver_kw, batch, Bs_list, init_obs, kernels, terms, coeffs, dt,
                       alphas, bound):
    """K1's batch-major entry, K6 and K7 at every batch size the tune
    launched them with (TUNE_BATCH and its compaction stages, H=TUNE_H):
    the carry of the tune's own solver after three iterations, from the
    canonical start, with the first round's candidates. Returns ({B: the
    three kernels' measurements}, failure strings)."""
    from autompc_torch.control import make_batched_ilqr_solver

    _, carry0, _, make_body = make_batched_ilqr_solver(
        model.pred_core, None, return_pieces=True, **solver_kw)
    n = batch["Qdiag"].shape[0]
    H = solver_kw["H"]
    x0 = batch["Qdiag"].new_tensor(np.tile(init_obs, (n, 1)))
    carry, body = carry0(model.params, x0, x0.new_zeros((n, H, 1)), batch), \
        make_body(model.params)
    for _ in range(3):
        carry = body(carry)
    out, failures = {}, []
    for Bs in Bs_list:
        sub = {k: carry[k][:Bs].contiguous() for k in ("x0s", "xs", "us", "Jx", "Ju")}
        out[Bs], fails = check_fanout_kernels(
            "tune carry", *kernels, terms, coeffs, sub, {k: v[:Bs] for k, v in batch.items()},
            (0.0,) * 4, dt, alphas, bound)
        failures += fails
    return out, failures


def tune_candidates(cfgs, system, dev):
    """The per-lane diagonals of the tune's configurations, as the
    tuner builds them, on the card."""
    from autompc_torch import default_dtype

    def diag(suffix, names):
        return torch.tensor([[c.get(f"_cost:{o}_{suffix}", 0.0) for o in names] for c in cfgs],
                            dtype=default_dtype(dev), device=dev)

    return {"Qdiag": diag("Q", system.observations), "Fdiag": diag("F", system.observations),
            "Rdiag": diag("R", system.controls)}


def check_fanout_kernels(tag, K1, K6, K7, terms, coeffs, carry, cp, goal, dt, alphas,
                         bound):
    """K1's batch-major entry, K6 and K7 against their plain versions on
    a batch-major carry (x0s, xs, us, Jx, Ju) with per-lane costs ``cp``;
    K1's batch-major entry also against its lanes-last entry on the same
    points (bit for bit), K7 on K6's gains. Returns (the three kernels'
    measurements, failure strings)."""
    x0s, xs, us, Jx, Ju = (carry[k] for k in ("x0s", "xs", "us", "Jx", "Ju"))
    B, H = us.shape[:2]
    rows, failures = [], []
    k1_args = (terms, xs, us, coeffs)
    jk, jp = K1.relin_jacobians_bm(*k1_args), K1.relin_jacobians_bm_plain(*k1_args)
    e1 = max(rel_err(a, b) for a, b in zip(jk, jp))
    ll_args = (terms, xs.permute(1, 2, 0).contiguous(), us[:, :, 0].T.contiguous(), coeffs)
    jl = K1.relin_jacobians(*ll_args).reshape(H, 4, 5, B).permute(3, 0, 1, 2)
    same = bits_equal(jk[0], jl[..., :4].contiguous()) and bits_equal(jk[1], jl[..., 4:].contiguous())
    rows.append(dict(
        max_abs_err=max(abs_err(a, b) for a, b in zip(jk, jp)),
        ms=time_ms(lambda: K1.relin_jacobians_bm(*k1_args)),
        device_ms=device_ms(lambda: K1.relin_jacobians_bm(*k1_args)),
        plain_ms=time_ms(lambda: K1.relin_jacobians_bm_plain(*k1_args), reps=3),
        lanes_last_device_ms=device_ms(lambda: K1.relin_jacobians(*ll_args)),
        **bound_keys(n_bytes(xs, us, coeffs, *jk), B * H * feature_flops(len(terms), 5, 4)),
    ))
    print(f"[3] K1 relin, batch-major entry, {tag} B={B} H={H}: rel err Jx/Ju {e1:.3e} (tol "
          f"{TOL_K1}); bit for bit the lanes-last entry's rows on the same points: {same}",
          flush=True)
    if not (e1 <= TOL_K1 and same):
        failures.append(f"K1 batch-major {tag} rel err {e1:.3e}, equal to lanes-last {same}")
    k6_args = (Jx, Ju, xs, us, cp["Qdiag"], cp["Rdiag"], cp["Fdiag"], goal, dt, 4)
    gk, gp = K6.backward_quad(*k6_args), K6.backward_quad_plain(*k6_args)
    e6 = [rel_err(a, b) for a, b in zip(gk, gp)]
    rows.append(dict(
        max_abs_err=max(abs_err(a, b) for a, b in zip(gk, gp)),
        ms=time_ms(lambda: K6.backward_quad(*k6_args)),
        device_ms=device_ms(lambda: K6.backward_quad(*k6_args)),
        plain_ms=time_ms(lambda: K6.backward_quad_plain(*k6_args), reps=3),
        **bound_keys(n_bytes(*k6_args[:7], *gk), B * H * (riccati_flops(4, 1) + 16)),
    ))
    g6 = K6.bq_bm_geometry(B, H, sm_count=K6._build.sm_count(xs.device))
    print(f"[3] K6 batch-major backward {tag} B={B} H={H} ({g6['group']} threads a lane, "
          f"{g6['lanes_per_block']} lanes a block, {g6['blocks']} blocks, ring {g6['ring']}): "
          f"rel err K/k/lin/quad {[f'{e:.3e}' for e in e6]} (tol {TOL_K6})", flush=True)
    if not max(e6) <= TOL_K6:
        failures.append(f"K6 {tag} rel err {max(e6):.3e} > {TOL_K6}")

    Ks, ks = gk[0], gk[1]
    k7_args = (terms, x0s, xs, us, Ks, ks, coeffs, alphas, -bound, bound)
    (kx, ku), (px, pu) = K7.sindy_line_search(*k7_args), K7.sindy_line_search_plain(*k7_args)
    finite = torch.isfinite(kx).all(dim=(2, 3)) & torch.isfinite(px).all(dim=(2, 3))
    same_finite = (torch.isfinite(kx).all(dim=(2, 3))
                   == torch.isfinite(px).all(dim=(2, 3))).float().mean().item()

    def rollout_err(upto):
        d = (kx[:, :, :upto].double() - px[:, :, :upto].double()).abs().amax(dim=(2, 3))
        return (d / px[:, :, :upto].double().abs().amax(dim=(2, 3)).clamp_min(1e-30))[finite]

    head = min(K7_HEAD, H)
    e_head = float(rollout_err(head + 1).max())
    e_full = rollout_err(H + 1)
    full_within = (e_full <= TOL_K7).float().mean().item()
    # float64 evaluation at the kernel's own states.
    a64 = torch.tensor(alphas, dtype=torch.float64, device=xs.device)[None, :, None]
    fb = Ks[:, None, :, 0].double() * (kx[:, :, :-1].double() - xs[:, None, :-1].double())
    step, ubar = a64 * ks[:, None, :, 0].double(), us[:, None, :, 0].double()
    u64 = (step + ubar + fb.sum(-1)).clamp(-bound, bound)
    scale = step.abs() + ubar.abs() + fb.abs().sum(-1)
    e_u = float(((ku[..., 0].double() - u64).abs() / scale.clamp_min(1e-30))[finite].max())
    from autompc_torch.sysid.basis import term_value

    z = [kx[:, :, :-1, i].double() for i in range(4)] + [ku[..., 0].double()]
    theta = torch.stack([term_value(t, z) for t in terms], dim=-1)     # (B, L, H, F)
    c64 = coeffs.double()
    x64 = theta @ c64.T
    mag = theta.abs() @ c64.abs().T
    e_x = float(((kx[:, :, 1:].double() - x64).abs() / mag.clamp_min(1e-30))[finite].max())
    rows.append(dict(
        max_abs_err=max(abs_err(kx[finite], px[finite]), abs_err(ku[finite], pu[finite])),
        ms=time_ms(lambda: K7.sindy_line_search(*k7_args)),
        device_ms=device_ms(lambda: K7.sindy_line_search(*k7_args)),
        plain_ms=time_ms(lambda: K7.sindy_line_search_plain(*k7_args), reps=3),
        **bound_keys(n_bytes(x0s, xs, us, Ks, ks, coeffs, kx, ku),
                     B * len(alphas) * H * (len(terms) * 13 + 20)),
    ))
    print(f"[3] K7 rollout line search {tag} B={B} H={H} L={len(alphas)}: rollouts finite in "
          f"both {int(finite.sum())} of {finite.numel()} (flags agree {same_finite:.4f}); per "
          f"rollout vs plain: first {head} steps worst {e_head:.3e} (tol {TOL_K7_HEAD}); all "
          f"{H} steps median {float(e_full.median()):.3e}, 99% "
          f"{float(e_full.quantile(0.99)):.3e}, worst {float(e_full.max()):.3e}, within "
          f"{TOL_K7} on {full_within:.4f} (min {K7_WITHIN_MIN}); vs float64 at the kernel's "
          f"states: u {e_u:.3e}, next x {e_x:.3e} of term magnitudes (tol {TOL_K7_SUM})",
          flush=True)
    if not (e_head <= TOL_K7_HEAD and full_within >= K7_WITHIN_MIN and same_finite >= 0.999
            and e_u <= TOL_K7_SUM and e_x <= TOL_K7_SUM):
        failures.append(f"K7 {tag} head {e_head:.3e} full within {full_within:.4f} finite flags "
                        f"{same_finite:.4f} u {e_u:.3e} next x {e_x:.3e}")
    return rows, failures


def wide_phase(make_solve, params, warm, pool, ref, ref_rate, rows, dt, gate, counters,
               card, profile=False):
    """Phase 9: the main path's three wide options at its own shape, each
    through ``make_solve(**kw)`` (the scheduled solver with the main
    path's options and ``kw``) with 2 warm runs on ``warm`` and 3 timed
    runs on phase 4's draws ``pool``, against the default solve's outputs
    ``ref`` on the same draws (``ref_rate`` its solves/s). ``rows`` holds
    the fixed cost's diagonals for ``lane_objective``; ``gate(**kw)``
    runs phase 5's closed loop and returns its success. Each variant's
    counters are set to 0 before it and read after it. Returns
    ({variant: launches}, failure strings); ``llb_gate`` holds the
    launches of ``llb``'s closed loop alone."""
    ug = torch.zeros_like(ref[0][2])
    ref_conv = float(torch.stack([r[0].float().mean() for r in ref]).mean())
    ref_obj = [lane_objective(r[1], r[2], rows, dt) for r in ref]
    counts, failures = {}, []
    if profile:
        profile_solve(make_solve(), (params, pool[0], ug), "one default main-path solve")
    for name, v in WIDE_VARIANTS.items():
        solve = make_solve(**v["kw"])
        reset_counters(counters)
        with wide_io_env(v["env"]):
            for x in warm:
                solve(params, x, ug)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [solve(params, x, ug) for x in pool]
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            success, at_solve = None, read_counters(counters)
            if name == "llb":
                success = gate(**v["kw"])
                counts["llb_gate"] = {k: n - at_solve[k]
                                      for k, n in read_counters(counters).items()
                                      if not isinstance(n, dict)}
            if profile and name == "llw":
                profile_solve(solve, (params, pool[0], ug), "one main-path solve, llw")
        counts[name] = read_counters(counters)
        rate = B_SOLVE * len(pool) / elapsed
        conv = float(torch.stack([o[0].float().mean() for o in outs]).mean())
        finite = all(torch.isfinite(o[1]).all() for o in outs)
        rel, n_both = [], 0
        for o, r, ro in zip(outs, ref, ref_obj):
            both = o[0] & r[0]
            n_both += int(both.sum())
            obj = lane_objective(o[1], o[2], rows, dt)
            rel.append(((obj - ro).abs() / ro.abs().clamp_min(1e-30))[both])
        rel = torch.cat(rel)
        share = float((rel <= FAN_OBJ_TOL).float().mean()) if rel.numel() else 0.0
        same = all(bits_equal(a, b) for o, r in zip(outs, ref) for a, b in zip(o, r))
        gate_txt = "" if success is None else f"; closed-loop gate success {success:.4f} (min {GATE_MIN})"
        print(f"[9] {name} {v['kw'] or {}} AMPC_BQ_WIDE_IO={v['env']}: B={B_SOLVE} H={H}: 3 timed "
              f"runs {elapsed:.3f} s -> {rate:.1f} solves/s (default {ref_rate:.1f}) on {card}; "
              f"converged {conv:.4f} (default {ref_conv:.4f}); lanes converged in both "
              f"{n_both}, accepted objectives within {FAN_OBJ_TOL} on {share:.4f}, median "
              f"{float(rel.median()) if rel.numel() else float('nan'):.3e}, max "
              f"{float(rel.max()) if rel.numel() else float('nan'):.3e}; bit for bit equal to "
              f"the default: {same}{gate_txt}; launches {counts[name]}", flush=True)
        missing = [k for k in WIDE_REQUIRED[name] if counts[name][k] == 0]
        if missing:
            failures.append(f"{name}: {missing} never ran on its path")
        if not finite:
            failures.append(f"{name}: non-finite states")
        if name == "ll" and not same:
            failures.append("ll: not bit for bit the default solve")
        if name == "llw" and (share < FAN_AGREE_MIN or n_both < len(pool) * B_SOLVE // 4):
            failures.append(f"llw: objectives within {FAN_OBJ_TOL} on {share:.4f} of {n_both} lanes")
        if name == "llb" and success < GATE_MIN:
            failures.append(f"llb: closed-loop success {success:.4f} < {GATE_MIN}")
    return counts, failures


def profile_solve(solve, args, label="one phase-6 solve"):
    """One call under torch.profiler: device time by kernel and the
    device's busy share of the call's wall time."""
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
    print(f"[profile] {label}: wall {wall_ms:.1f} ms under the profiler, "
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
    from autompc_torch.ops import cuda_riccati as K2  # also K6, backward_quad
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
    # Registers a thread (ptxas) and resident warps an SM: K3 and K5 from
    # the CUDA occupancy query at each shape their paths launch; the other
    # kernels' 64-thread blocks bounded by registers alone.
    for name, regs, spill in ptxas_report(_build.build_log()):
        print(f"    ptxas: {name}: {regs} registers, {spill} bytes spilled, <= "
              f"{min(64, 65536 // (-(-regs // 8) * 8 * 32))} warps an SM by registers")
    for tag, B, lane, bf16 in (("main path", B_SOLVE, 0, 0), ("main path", B_KERNEL, 0, 0),
                               ("fan-out, per-lane cost", FAN_B, 1, 0),
                               ("llb, bf16 carry", B_SOLVE, 0, 1)):
        g = K3.fused_geometry(B, 10, _build.sm_count(dev))
        o = _build.occupancy("ampc_fused_line_search_occupancy", lane, bf16, g["threads"],
                             dev.index or 0)
        print(f"[1] K3 {tag} B={B}: {g['lanes_per_block']} lanes x 10 = {g['threads']} threads, "
              f"{g['blocks']} blocks; {o['registers']} registers, {o['local_bytes']} local "
              f"bytes; {o['blocks_per_sm']} blocks = "
              f"{o['blocks_per_sm'] * -(-g['threads'] // 32)} warps resident an SM", flush=True)
    # K8 (K3's geometry) at the shapes check_wide holds it at.
    for B in (B_SOLVE, B_KERNEL, B_WIDE_LAST):
        g = K3.fused_geometry(B, 10, _build.sm_count(dev))
        o = _build.occupancy("ampc_ls_obj_wide_occupancy", 0, g["threads"], dev.index or 0)
        print(f"[1] K8 llw B={B}: {g['lanes_per_block']} lanes x 10 = {g['threads']} threads, "
              f"{g['blocks']} blocks; {o['registers']} registers, {o['local_bytes']} local bytes; "
              f"{o['blocks_per_sm']} blocks = {o['blocks_per_sm'] * -(-g['threads'] // 32)} warps "
              f"resident an SM", flush=True)
    for tag, widths, ds, dc, B, H_ in (("cheetah", [24, 64, 64, 18], 18, 6, B_HC, H_HC),
                                       ("cheetah closed loop", [24, 64, 64, 18], 18, 6, B_HCQ,
                                        H_HCQ),
                                       ("dense cartpole", [5, 64, 64, 4], 4, 1, B_DENSE, H)):
        o = K5.mlp_line_search_occupancy(widths, "relu", ds, dc, 10, B, dev)
        print(f"[1] K5 {tag} {widths} B={B}, H={H_}: {o['rollouts']} rollouts, "
              f"{o['threads']} threads, "
              f"{o['smem']} bytes of shared memory a block, {o['blocks']} blocks; "
              f"{o['registers']} registers, {o['local_bytes']} local bytes; "
              f"{o['blocks_per_sm']} blocks = {o['blocks_per_sm'] * -(-o['threads'] // 32)} "
              f"warps resident an SM", flush=True)

    # K2's and K4's geometry (threads a lane, lanes a block), chosen in
    # Python, at each shape their paths launch them.
    sms = _build.sm_count(dev)
    for tag, B in (("main path", B_SOLVE), ("main path", B_KERNEL), ("gate", B_GATE),
                   ("fan-out", FAN_B)):
        g = K2.bq_geometry(B, sm_count=sms)
        print(f"[1] K2 {tag} B={B}: {g['lanes_per_block']} lanes a block, {g['blocks']} "
              f"blocks, {g['smem']} bytes of shared memory a block (either Jacobian type)",
              flush=True)
    # K7's threads a candidate and block, and K6's threads a lane, block
    # and ring, at the fan-out's batches (B and its compaction stages,
    # H=10) and at B=4096 (K6 at H=200).
    for B in [FAN_B] + [int(round(FAN_B * f)) for _, f in parse_schedule(FAN_SCHEDULE)] \
            + [B_KERNEL]:
        g = K3.sindy_geometry(B, 10)
        print(f"[1] K7 B={B}: {g['group']} threads a candidate, {g['threads']} threads a "
              f"block, {g['blocks']} blocks", flush=True)
        Hb = FAN_H if B != B_KERNEL else H
        g = K2.bq_bm_geometry(B, Hb, sm_count=sms)
        print(f"[1] K6 B={B} H={Hb}: {g['group']} threads a lane, {g['lanes_per_block']} "
              f"lanes a block, {g['blocks']} blocks, ring of {g['ring']} steps, {g['smem']} "
              f"bytes of shared memory a block", flush=True)
    for tag, ds, dc, B in (("cheetah", 18, 6, B_HC), ("cheetah closed loop", 18, 6, B_HCQ),
                           ("dense cartpole", 4, 1, B_DENSE)):
        g = K4.general_geometry(ds, dc, B, sms)
        print(f"[1] K4 {tag} ({ds},{dc}) B={B}: {g['threads_per_lane']} threads a lane, "
              f"{g['lanes_per_block']} lanes a block, {g['blocks']} blocks, {g['smem']} "
              f"bytes of shared memory a block", flush=True)

    wrappers = (K1.relin_jacobians, K2.backward_quad_ll, K3.fused_line_search)
    for w in wrappers:
        w.launches = 0

    # ---- [2] data + SINDy fit -------------------------------------------
    t0 = time.perf_counter()
    bench = CartpoleSwingupBenchmark()
    trajs = bench.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    model = SINDy(bench.system, **SINDY_KW)
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
    conv, fth, outs4 = [], [], []
    t0 = time.perf_counter()
    for x0r in pool:
        out = solve(model.params, x0r, ug)
        conv.append(out[0].float().mean())
        fth.append(out[1][:, -1, 0].abs())
        outs4.append(out)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    xs_f = out[1]
    if not torch.isfinite(xs_f).all() or tuple(xs_f.shape) != (B_SOLVE, H + 1, 4):
        raise RuntimeError(f"solver output malformed: {tuple(xs_f.shape)}")
    conv_frac = float(torch.stack(conv).mean())
    # Phases 2-5 launch the lanes-last kernels at two shapes: the solves'
    # (B=16384, H=200, and its compaction stages) and the gate's (B=256,
    # H=20); the counts are split here.
    solve_launches = {w.__name__: w.launches for w in wrappers}
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
    x0_gate = draw_x0(rng, B_GATE, dev)
    t0 = time.perf_counter()
    xs_cl, us_cl, nconv = run_cl(model.params, x0_gate)
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
    gate_launches = {k: launches[k] - solve_launches[k] for k in launches}
    print(f"    main-path kernel launches: {launches} (solves at B={B_SOLVE}, H={H} "
          f"{solve_launches}; gate at B={B_GATE}, H={H_GATE} {gate_launches})", flush=True)
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

    # ---- [8] the cost fan-out, both solver configurations ----------------
    fan_wrappers = {
        "a": (K1.relin_jacobians, K2.backward_quad_ll, K3.fused_line_search),
        "b": (K1.relin_jacobians_bm, K2.backward_quad, K3.sindy_line_search),
    }
    fan_launches, fan_by_B, fan_kw, fan_batch = fanout_phase(
        bench, model, dev, card, fan_wrappers, profile=profile)

    # ---- [9] the main path's wide options ----------------------------------
    def make_solve(**kw):
        return make_scheduled_ilqr_solver(
            model.pred_core, cost, H=H, schedule=parse_schedule(SCHEDULE), **common, **kw
        )

    def gate(**kw):
        run = make_receding_ilqr_loop(model.pred_core, cost, bench.dynamics, H=H_GATE,
                                      n_steps=STEPS_GATE, **common, **kw)
        fx = run(model.params, x0_gate)[0][:, -1]
        return ((fx[:, 0].abs() < 0.2) & (fx[:, 1].abs() < 0.2)).float().mean().item()

    fixed_rows = {k: x0.new_tensor(v).expand(B_SOLVE, len(v)) for k, v in (
        ("Qdiag", np.diag(qd)), ("Rdiag", (0.001,)), ("Fdiag", np.diag(qd)))}
    wide_launches, failures = wide_phase(
        make_solve, model.params, (x0, x0 - 0.01), pool, outs4, solves_per_s, fixed_rows,
        bench.system.dt, gate, wide_counters(K1, K2, K3), card, profile=profile,
    )

    # ---- [10] the tuner ------------------------------------------------------
    tune_launches, tune_by_B, tune_kw, tune_batch = tune_phase(
        bench, model, trajs, dev, card, fan_wrappers["b"], profile=profile)

    # ---- [11] the joint-MLP tune -----------------------------------------------
    jm_launches, jm_by_B, jm_k4_args = joint_mlp_phase(dev, card, K4, profile=profile)

    # ---- [3] kernels vs plain twins on path inputs -----------------------
    _, make_carry0, _, _ = make_batched_ilqr_solver(
        model.pred_core, cost, H=H, return_pieces=True, **common
    )
    x0k = draw_x0(np.random.default_rng(1), B_KERNEL, dev)
    c = make_carry0(model.params, x0k, ug[:B_KERNEL])
    terms = tuple(model.library.terms[k] for k in active)
    ca = model.coeffs[:, list(active)].contiguous()
    diag = (tuple(np.diag(qd)), (0.001,), tuple(np.diag(qd)), (0.0,) * 4)
    dt = bench.system.dt
    alphas = tuple(0.2 ** k for k in range(10))
    report = []

    def check_k1(tag, c, n_launches):
        """The relinearization kernel on the trajectory of the lanes-last
        carry ``c``: one report row."""
        Hc, Bc = c["us"].shape
        k1_args = (terms, c["xs"], c["us"], ca)
        jk, jp = K1.relin_jacobians(*k1_args), K1.relin_jacobians_plain(*k1_args)
        e1 = rel_err(jk, jp)
        print(f"[3] K1 relin, {tag}: rel err {e1:.3e} (tol {TOL_K1})", flush=True)
        if e1 > TOL_K1:
            failures.append(f"K1 ({tag}) rel err {e1:.3e} > {TOL_K1}")
        return dict(
            name=f"relin_jacobians[B={Bc},H={Hc}]", route="cuda",
            source="autompc_torch/csrc/relin.cu",
            replaces="autompc_tpu/ops/pallas_relin.py:192",
            launches=n_launches, max_abs_err=abs_err(jk, jp),
            ms=time_ms(lambda: K1.relin_jacobians(*k1_args)),
            plain_ms=time_ms(lambda: K1.relin_jacobians_plain(*k1_args)),
            **bound_keys(n_bytes(c["xs"], c["us"], ca, jk),
                         Bc * Hc * feature_flops(len(terms), 5, 4)),
        )

    def check_k2_k3(tag, c, cost, agree_min=K3_AGREE_MIN, within_min=None, split=False):
        """One backward pass and one line search on the lanes-last carry
        ``c`` under ``cost = (qd, rd, fd, goal)``; returns the kernels'
        outputs, the twin pairs and the timed closures, and appends to
        ``failures``. The twins' states are gated normwise, or, with
        ``within_min``, per lane on that share of the lanes. With
        ``split``, the split search (K8 + acceptance + K9) is held
        against K3 on the same inputs: decisions on ``agree_min`` of the
        active lanes, and bit for bit where they agree."""
        Hc, Bc = c["us"].shape
        act = ~c["converged"] & ~c["failed"]
        k2_kw = dict(carry=(act, c["Ks"], c["ks"]))
        k2_args = (c["jac"], c["xs"], c["us"], *cost, dt, 4)
        bk = K2.backward_quad_ll(*k2_args, **k2_kw)
        bp = K2.backward_quad_ll_plain(*k2_args, **k2_kw)
        print(f"[3] K2 backward, {tag}: rel err K/k/lin/quad "
              f"{[f'{rel_err(a, b):.3e}' for a, b in zip(bk, bp)]} (tol {TOL_K2})",
              flush=True)
        KsT, ksT, lin, quad = bk
        ks_small = torch.sqrt((ksT * ksT).sum(0)) < 1e-3
        lo, hi = float(bounds[0, 0]), float(bounds[0, 1])
        ls_common = (terms, c["x0s"], c["xs"], c["us"], KsT, ksT, ca, alphas, lo, hi,
                     *cost, dt)
        k3_args = ls_common + (c["obj"], lin, quad, ks_small, act, c["jac"])
        lk = K3.fused_line_search(*k3_args)
        lp = K3.fused_line_search_plain(*k3_args)
        objs = K3.line_search_objectives(*ls_common)

        def choice(obj_out):
            return (objs - obj_out[None]).abs().argmin(0)

        def pick(idx):
            return objs.gather(0, idx[None])[0]

        # Decisions against the twin, on the active lanes (see K3_TIE).
        ck, cp = choice(lk[2]), choice(lp[2])
        same_choice = (ck == cp) | ((pick(ck) - pick(cp)).abs() <= K3_TIE * pick(cp).abs())
        same_flags = (lk[3] == lp[3]) & (lk[4] == lp[4])
        obj0 = c["obj"]
        stalled = ((lk[2] - obj0).abs() <= K3_TIE * obj0.abs()) \
            & ((lp[2] - obj0).abs() <= K3_TIE * obj0.abs())
        moved = act & ~lk[4] & ~lp[4]
        agree = stalled | (same_flags & (~moved | same_choice))
        lanes = moved & same_flags & (ck == cp)
        twin = {
            "xs": (lk[0][:, :, lanes], lp[0][:, :, lanes]),
            "obj": (lk[2][lanes], lp[2][lanes]),
            "us": (lk[1][:, lanes], lp[1][:, lanes]),
            "jac": (lk[5][:, :, lanes], lp[5][:, :, lanes]),
            "du2": (lk[6][lanes], lp[6][lanes]),
        }
        dx = (twin["xs"][0].double() - twin["xs"][1].double()).abs().amax(dim=(0, 1))
        per_lane = dx / twin["xs"][1].double().abs().amax(dim=(0, 1)).clamp_min(1e-30)
        # The carry select: an inactive lane comes back bit for bit.
        held = all(torch.equal(new[..., ~act], old[..., ~act]) for new, old in (
            (lk[0], c["xs"]), (lk[1], c["us"]), (lk[2], obj0), (lk[5], c["jac"])))
        # float64 evaluation at the kernel's own states (see TOL_K3_SUM),
        # on every lane the kernel moved: the controls of a step size
        # whose objective is the one returned, the next states, the
        # objective of the returned trajectory under the lane's cost, du2
        # and, where the Jacobians were taken anew, the Jacobians.
        own = act & ~lk[4]
        a64 = torch.tensor(alphas, dtype=torch.float64, device=dev)[:, None, None]
        ubar = c["us"].double()
        fb = KsT.double() * (lk[0][:-1].double() - c["xs"][:-1].double())
        step = a64 * ksT.double()[None]                                     # (L, H, B)
        u64 = (step + ubar[None] + fb.sum(1)[None]).clamp(lo, hi)
        scale = step.abs() + ubar.abs()[None] + fb.abs().sum(1)[None]
        e_l = ((lk[1].double()[None] - u64).abs() / scale.clamp_min(1e-30)).amax(1)
        near = (objs - pick(ck)[None]).abs() <= K3_TIE * pick(ck).abs()[None]
        e_u = torch.where(near, e_l, torch.full_like(e_l, float("inf"))).amin(0)
        from autompc_torch.sysid.basis import term_value

        z = [lk[0][:-1, i].double() for i in range(4)] + [lk[1].double()]
        theta = torch.stack([term_value(t, z) for t in terms], dim=-1)      # (H, B, F)
        x64 = theta @ ca.double().T
        mag = theta.abs() @ ca.double().abs().T
        e_x = (lk[0][1:].permute(0, 2, 1).double() - x64).abs() / mag.clamp_min(1e-30)
        qd_, rd_, fd_ = cost[:3]
        if isinstance(qd_, torch.Tensor):
            rows = dict(Qdiag=qd_.T, Rdiag=rd_.T, Fdiag=fd_.T)
        else:
            rows = {k: obj0.new_tensor(v).expand(Bc, len(v))
                    for k, v in (("Qdiag", qd_), ("Rdiag", rd_), ("Fdiag", fd_))}
        obj64 = lane_objective(lk[0].permute(2, 0, 1), lk[1].T[:, :, None], rows, dt)
        du2_64 = ((lk[1].double() - ubar) ** 2).sum(0)
        jl = own & lk[3]
        jac64 = K1.relin_jacobians_plain(
            terms, lk[0][:, :, jl].double(), lk[1][:, jl].double(), ca.double()
        )
        err = dict(
            k2=max(rel_err(a, b) for a, b in zip(bk, bp)),
            frac=agree[act].float().mean().item(),
            xs=rel_err(*twin["xs"]), obj=rel_err(*twin["obj"]),
            within=(per_lane <= TOL_K3).float().mean().item(),
            u=float(e_u[own].max()), x=float(e_x[:, own].max()),
            obj64=float(((lk[2].double() - obj64).abs() / obj64.abs().clamp_min(1e-30))[own].max()),
            du2=rel_err(lk[6][own], du2_64[own]),
            jac=rel_err(lk[5][:, :, jl], jac64),
        )
        xs_gate = (f"normwise, gated at {TOL_K3}" if within_min is None else
                   f"per lane within {TOL_K3} on {err['within']:.4f}, min {within_min}")
        print(f"[3] K3 line search, {tag}: active lanes {int(act.sum())} of {Bc}, inactive "
              f"returned bit for bit: {held}; decisions agree with the twin on "
              f"{err['frac']:.5f} of the active lanes (min {agree_min}; flags differ on "
              f"{int((act & ~same_flags).sum())}, of which stalled {int((act & ~same_flags & stalled).sum())}; "
              f"step size differs on {int((moved & same_flags & ~same_choice).sum())}); vs twin on "
              f"the {int(lanes.sum())} lanes of equal decisions "
              f"{({k: f'{rel_err(a, b):.3e}' for k, (a, b) in twin.items()})} (obj gated at "
              f"{TOL_K3}; xs {xs_gate}); vs float64 at the kernel's states on the "
              f"{int(own.sum())} lanes it moved: u {err['u']:.3e}, next x {err['x']:.3e} of term "
              f"magnitudes (tol {TOL_K3_SUM}), objective of the returned trajectory "
              f"{err['obj64']:.3e} (tol {TOL_K3}), jac {err['jac']:.3e} (tol {TOL_K1}), du2 "
              f"{err['du2']:.3e} (tol {TOL_K3})", flush=True)
        if err["k2"] > TOL_K2:
            failures.append(f"K2 ({tag}) rel err {err['k2']:.3e} > {TOL_K2}")
        if not held:
            failures.append(f"K3 ({tag}) changed an inactive lane")
        if err["frac"] < agree_min:
            failures.append(f"K3 ({tag}) decisions agree on {err['frac']:.5f} < {agree_min}")
        if err["obj"] > TOL_K3 or (err["xs"] > TOL_K3 if within_min is None
                                   else err["within"] < within_min):
            failures.append(f"K3 ({tag}) vs twin: xs {err['xs']:.3e} (within on "
                            f"{err['within']:.4f}), obj {err['obj']:.3e}")
        if max(err["u"], err["x"]) > TOL_K3_SUM or err["jac"] > TOL_K1 \
                or max(err["du2"], err["obj64"]) > TOL_K3:
            failures.append(f"K3 ({tag}) float64 check u {err['u']:.3e} x {err['x']:.3e} obj "
                            f"{err['obj64']:.3e} jac {err['jac']:.3e} du2 {err['du2']:.3e}")
        if split:
            frac, bits = split_agreement(K3.fused_line_search_wide(*k3_args), lk, act)
            print(f"[3] split search vs K3, {tag}: decisions agree on {frac:.5f} of "
                  f"{int(act.sum())} active lanes (min {agree_min}), xs/us/jac/du2 bit for "
                  f"bit on those {bits}", flush=True)
            if frac < agree_min or not bits:
                failures.append(f"split vs K3 ({tag}): agree {frac:.5f}, bits {bits}")
        return dict(
            bk=bk, bp=bp, lk=lk, twin=twin, k3_args=k3_args, act=act,
            k2=lambda: K2.backward_quad_ll(*k2_args, **k2_kw),
            k2_plain=lambda: K2.backward_quad_ll_plain(*k2_args, **k2_kw),
            k3=lambda: K3.fused_line_search(*k3_args),
            k3_plain=lambda: K3.fused_line_search_plain(*k3_args),
        )

    def k2_k3_rows(res, c, form, n_launches, **extra):
        """The two report rows of one ``check_k2_k3`` result on carry
        ``c``; ``extra[kernel]`` adds keys to that kernel's row."""
        Hc, Bc = c["us"].shape
        bk, lk = res["bk"], res["lk"]
        tensors = [t for t in res["k3_args"] if isinstance(t, torch.Tensor)]
        return [
            dict(
                name=f"backward_quad_ll[B={Bc},H={Hc},{form}]", route="cuda",
                source="autompc_torch/csrc/riccati_quad.cu",
                # At B % 1024 == 0 the TPU entry takes its cast-IO wide
                # kernel (:865), else the loop kernel (:773); K2 is both.
                replaces="autompc_tpu/ops/pallas_riccati.py:773, :865",
                launches=n_launches["backward_quad_ll"],
                max_abs_err=max(abs_err(a, b) for a, b in zip(bk, res["bp"])),
                ms=time_ms(res["k2"]), plain_ms=time_ms(res["k2_plain"], reps=5),
                **extra.get("backward_quad_ll", {}),
                **bound_keys(n_bytes(c["jac"], c["xs"], c["us"], res["act"], c["Ks"],
                                     c["ks"], *c["cost"].values(), *bk),
                             Bc * Hc * (riccati_flops(4, 1) + 16)),
            ),
            dict(
                name=f"fused_line_search[B={Bc},H={Hc},{form}]", route="cuda",
                source="autompc_torch/csrc/linesearch_fused.cu",
                replaces="autompc_tpu/ops/pallas_linesearch.py:803",
                launches=n_launches["fused_line_search"],
                max_abs_err=max(abs_err(a, b) for a, b in res["twin"].values()),
                ms=time_ms(res["k3"]), plain_ms=time_ms(res["k3_plain"], reps=5),
                **extra.get("fused_line_search", {}),
                **k3_bound(n_bytes(*tensors, *lk), Bc, Hc, len(terms), len(alphas)),
            ),
        ]

    def check_wide(tag, c, cost, plain_reps=3):
        """K2's reshape-IO entry and bfloat16 instances, K3's bfloat16
        instances, K8 and K9 (both storage types) against their plain
        versions on the lanes-last carry ``c`` under ``cost``, and the
        split search (K8 + acceptance + K9) against K3. Appends to
        ``failures``; returns the timings: {row: dict}."""
        Hc, Bc = c["us"].shape
        act = ~c["converged"] & ~c["failed"]
        carry = dict(carry=(act, c["Ks"], c["ks"]))
        jb = c["jac"].to(torch.bfloat16)
        k2 = lambda jac: (jac, c["xs"], c["us"], *cost, dt, 4)
        bk = K2.backward_quad_ll(*k2(c["jac"]), **carry)
        b4 = K2.backward_quad_ll(*k2(c["jac"]), **carry, wide_io="reshape")
        bp = K2.backward_quad_ll_plain(*k2(c["jac"]), **carry)
        bkb = K2.backward_quad_ll(*k2(jb), **carry)
        b4b = K2.backward_quad_ll(*k2(jb), **carry, wide_io="reshape")
        bpb = K2.backward_quad_ll_plain(*k2(jb), **carry)
        # A few lanes of a 200-step float32 recursion run ill-conditioned
        # (normwise 1.4e-5 at B=4096, 8.7e-4 at B=16384 on an H100), so the
        # recursion is gated per lane, by share.
        err = dict(
            k2_4d=max(rel_err(a, b) for a, b in zip(b4, bp)),
            k2_bf16=max(rel_err(a, b) for a, b in zip(bkb, bpb)),
            k2_within=min(lane_share(a, b, TOL_K2) for a, b in (*zip(b4, bp), *zip(bkb, bpb))),
        )
        same4 = all(bits_equal(a, b) for a, b in zip(b4, bk)) and \
            all(bits_equal(a, b) for a, b in zip(b4b, bkb))
        KsT, ksT, lin, quad = bk
        ks_small = torch.sqrt((ksT * ksT).sum(0)) < 1e-3
        lo, hi = float(bounds[0, 0]), float(bounds[0, 1])
        ls = (terms, c["x0s"], c["xs"], c["us"], KsT, ksT, ca, alphas, lo, hi, *cost, dt)
        tail = (c["obj"], lin, quad, ks_small, act)
        lk = K3.fused_line_search(*ls, *tail, c["jac"])
        lkb = K3.fused_line_search(*ls, *tail, jb)
        lpb = K3.fused_line_search_plain(*ls, *tail, jb)
        twin_b = (lkb[3] == lpb[3]) & (lkb[4] == lpb[4]) \
            & ((lkb[2] - lpb[2]).abs() <= K3_TIE * lpb[2].abs())
        k3_bf16 = all(bits_equal(a, b) for a, b in zip(lkb[:5] + lkb[6:], lk[:5] + lk[6:])) \
            and bits_equal(lkb[5], lk[5].to(torch.bfloat16))
        # K8 against its plain version, per (step size, lane): objectives,
        # stashed trajectories (each to its own largest state) and du2; and
        # against K3: the objective K3 returned is one of K8's, to the bit.
        ok, sk, dk = K3.wide_objectives(*ls)
        op, sp, dp = K3.wide_objectives_plain(*ls)
        fin = torch.isfinite(ok) & torch.isfinite(op)
        e8 = ((ok.double() - op.double()).abs() / op.double().abs().clamp_min(1e-30))[fin]
        err["k8_within"] = (e8 <= TOL_K3).float().mean().item()
        # Each candidate's stashed states, a column (lane, step size), on
        # the candidates whose objective is finite in both.
        traj = lambda st: st[:, :4].permute(0, 1, 3, 2).reshape(-1, Bc * len(alphas))[
            :, fin.T.reshape(-1)]
        err["k8_stash_within"] = lane_share(traj(sk), traj(sp), TOL_K3, own_scale=True)
        ed = ((dk.double() - dp.double()).abs() / dp.double().abs().clamp_min(1e-30))[fin]
        err["k8_du2_within"] = (ed <= TOL_K3).float().mean().item()
        moved = act & ~lk[4]
        err["k8_k3"] = ((ok - lk[2][None]).abs().amin(0)[moved] == 0).float().mean().item()
        sel, tm, jm, new_obj, succ, fail = K3.wide_accept(ok, alphas, *tail)
        rr = (terms, c["x0s"], c["xs"], c["us"], ca, sk, dk, sel, tm, jm)
        rk = K3.wide_reroll(*rr, c["jac"])
        rp = K3.wide_reroll_plain(*rr, c["jac"])
        rkb = K3.wide_reroll(*rr, jb)
        rpb = K3.wide_reroll_plain(*rr, jb)
        k9_bf16 = all(bits_equal(rkb[i], rk[i]) for i in (0, 1, 3)) \
            and bits_equal(rkb[2], rk[2].to(torch.bfloat16))
        # K9 against its plain version on K8's stash: the read-back and du2
        # bit for bit, the float32 Jacobians as K1's (the bfloat16 ones are
        # the float32 ones rounded, above).
        k9_read = all(bits_equal(rk[i], rp[i]) and bits_equal(rkb[i], rpb[i]) for i in (0, 1, 3))
        err["k9_jac"] = rel_err(rk[2], rp[2])
        held = all(bits_equal(new[..., ~tm], old[..., ~tm]) for new, old in (
            (rk[0], c["xs"]), (rk[1], c["us"]))) and bits_equal(rk[2][..., ~jm], c["jac"][..., ~jm])
        # float64 at K9's own states (the selected candidate's, as K8
        # stashed them): controls at the lane's step size, next states,
        # Jacobians where taken anew, du2, and the objective of the
        # trajectory against K8's chosen one.
        a_sel = torch.tensor(alphas, dtype=torch.float64, device=dev)[sel]
        fb = (KsT.double() * (rk[0][:-1].double() - c["xs"][:-1].double())).sum(1)
        step = a_sel[None] * ksT.double()
        u64 = (step + c["us"].double() + fb).clamp(lo, hi)
        scale = step.abs() + c["us"].double().abs() + \
            (KsT.double() * (rk[0][:-1].double() - c["xs"][:-1].double())).abs().sum(1)
        err["u"] = float(((rk[1].double() - u64).abs() / scale.clamp_min(1e-30))[:, tm].max())
        from autompc_torch.sysid.basis import term_value

        z = [rk[0][:-1, i].double() for i in range(4)] + [rk[1].double()]
        theta = torch.stack([term_value(t, z) for t in terms], dim=-1)
        x64 = theta @ ca.double().T
        mag = theta.abs() @ ca.double().abs().T
        err["x"] = float(((rk[0][1:].permute(0, 2, 1).double() - x64).abs()
                          / mag.clamp_min(1e-30))[:, tm].max())
        err["jac"] = rel_err(rk[2][:, :, jm], K1.relin_jacobians_plain(
            terms, rk[0][:, :, jm].double(), rk[1][:, jm].double(), ca.double()))
        err["du2"] = rel_err(rk[3][tm], ((rk[1].double() - c["us"].double()) ** 2).sum(0)[tm])
        qd_, rd_, fd_ = cost[:3]
        if isinstance(qd_, torch.Tensor):
            rows = dict(Qdiag=qd_.T, Rdiag=rd_.T, Fdiag=fd_.T)
        else:
            rows = {k: c["obj"].new_tensor(v).expand(Bc, len(v))
                    for k, v in (("Qdiag", qd_), ("Rdiag", rd_), ("Fdiag", fd_))}
        obj64 = lane_objective(rk[0].permute(2, 0, 1), rk[1].T[:, :, None], rows, dt)
        err["obj64"] = float(((new_obj.double() - obj64).abs()
                              / obj64.abs().clamp_min(1e-30))[tm].max())
        # The split search against K3: the same decision on a lane, then
        # the same trajectory, Jacobians and du2, bit for bit.
        err["split_agree"], split_bits = split_agreement(
            (rk[0], rk[1], new_obj, succ, fail, rk[2], rk[3]), lk, act)
        print(f"[3] wide kernels, {tag}: K2 4D entry vs plain {err['k2_4d']:.3e}, bf16 Jacobians "
              f"vs plain {err['k2_bf16']:.3e}, lanes within {TOL_K2} {err['k2_within']:.5f} (min "
              f"{K2_WITHIN_MIN}); 4D entry bit for bit the 3D call: "
              f"{same4}; K3 with a bf16 carry = K3 f32 with its rows rounded: {k3_bf16}; K8 vs "
              f"plain within {TOL_K3} on {int(fin.sum())} candidates: objectives "
              f"{err['k8_within']:.4f} (median {float(e8.median()):.3e}, max "
              f"{float(e8.max()):.3e}), stashed trajectories {err['k8_stash_within']:.4f}, du2 "
              f"{err['k8_du2_within']:.4f} (min {K8_WITHIN_MIN}); K3's objective found bit for "
              f"bit among K8's on {err['k8_k3']:.5f} of the {int(moved.sum())} lanes it moved; K9 "
              f"vs plain on K8's stash: xs/us/du2 bit for bit {k9_read}, jac {err['k9_jac']:.3e} "
              f"(tol {TOL_K1}), carry select held {held}, bf16 = f32 rounded {k9_bf16}; vs float64 "
              f"at K9's states u {err['u']:.3e}, next x {err['x']:.3e} (tol {TOL_K3_SUM}), jac "
              f"{err['jac']:.3e} (tol {TOL_K1}), du2 {err['du2']:.3e}, objective of the trajectory "
              f"vs K8's {err['obj64']:.3e} (tol {TOL_K3}); split vs K3: decisions agree on "
              f"{err['split_agree']:.5f} of {int(act.sum())} active lanes (min {K3_AGREE_MIN}), "
              f"bit for bit on those {split_bits}", flush=True)
        if err["k2_within"] < K2_WITHIN_MIN or not same4:
            failures.append(f"K2 wide/bf16 ({tag}) within {err['k2_within']:.5f}, 4D == 3D {same4}")
        if not (k3_bf16 and k9_bf16 and k9_read and held and split_bits):
            failures.append(f"bf16/read-back/select/split bits ({tag}): K3 {k3_bf16} K9 {k9_bf16} "
                            f"read-back {k9_read} held {held} split {split_bits}")
        if min(err["k8_within"], err["k8_stash_within"], err["k8_du2_within"]) < K8_WITHIN_MIN \
                or err["k8_k3"] < K3_AGREE_MIN or err["split_agree"] < K3_AGREE_MIN:
            failures.append(f"K8/split ({tag}) within {err['k8_within']:.4f} stash "
                            f"{err['k8_stash_within']:.4f} du2 {err['k8_du2_within']:.4f} vs K3 "
                            f"{err['k8_k3']:.5f} agree {err['split_agree']:.5f}")
        if max(err["k9_jac"], err["jac"]) > TOL_K1 or max(err["u"], err["x"]) > TOL_K3_SUM \
                or max(err["du2"], err["obj64"]) > TOL_K3:
            failures.append(f"K9 ({tag}) jac vs plain {err['k9_jac']:.3e} u {err['u']:.3e} x "
                            f"{err['x']:.3e} jac {err['jac']:.3e} du2 {err['du2']:.3e} obj "
                            f"{err['obj64']:.3e}")
        k2_bytes = n_bytes(c["jac"], c["xs"], c["us"], act, c["Ks"], c["ks"], *bk)
        k2_ops = Bc * Hc * (riccati_flops(4, 1) + 16)
        ls_bytes = n_bytes(c["x0s"], c["xs"], c["us"], KsT, ksT, ca)
        step_ops = len(terms) * 13 + 20
        # K8's bound: the function it replaces (pallas_linesearch.py:1129)
        # reads the carry and returns the (L, B) objectives; the du2 of the
        # selected candidate only, 3 operations a lane-step. The stash and
        # the du2 plane are scratch for K9, beside the bound as in
        # k3_bound. K9's inputs: the old carry, the selected candidate's
        # rows of the stash and its du2 (H (ds + 1) + 1 floats a lane),
        # sel and the masks.
        k8_bound = dict(
            bound_keys(ls_bytes + n_bytes(ok),
                       Bc * len(alphas) * Hc * (step_ops + 12) + Bc * Hc * 3),
            scratch_bytes_ms=n_bytes(sk, dk) / HBM_BYTES_PER_S * 1e3)
        k9_in = n_bytes(c["x0s"], c["xs"], c["us"], ca, sel, tm, jm) + 4 * Bc * (Hc * 5 + 1)
        k9_ops = Bc * Hc * feature_flops(len(terms), 5, 4)
        plain = lambda fn: time_ms(fn, reps=plain_reps)
        split = lambda: K3.fused_line_search_wide(*ls, *tail, c["jac"])
        return {
            "k2_4d": dict(
                max_abs_err=max(abs_err(a, b) for a, b in zip(b4, bp)),
                ms=time_ms(lambda: K2.backward_quad_ll(*k2(c["jac"]), **carry, wide_io="reshape")),
                plain_ms=plain(lambda: K2.backward_quad_ll_plain(*k2(c["jac"]), **carry)),
                **bound_keys(k2_bytes, k2_ops)),
            "k2_bf16": dict(
                max_abs_err=max(abs_err(a, b) for a, b in zip(bkb, bpb)),
                ms=time_ms(lambda: K2.backward_quad_ll(*k2(jb), **carry)),
                plain_ms=plain(lambda: K2.backward_quad_ll_plain(*k2(jb), **carry)),
                **bound_keys(k2_bytes - n_bytes(c["jac"]) + n_bytes(jb), k2_ops)),
            "k3_bf16": dict(
                max_abs_err=abs_err(lkb[0][..., twin_b], lpb[0][..., twin_b]),
                ms=time_ms(lambda: K3.fused_line_search(*ls, *tail, jb)),
                plain_ms=plain(lambda: K3.fused_line_search_plain(*ls, *tail, jb)),
                **k3_bound(ls_bytes + n_bytes(*tail, jb, *lkb), Bc, Hc, len(terms),
                           len(alphas))),
            "k8": dict(
                max_abs_err=abs_err(ok[fin], op[fin]),
                # The whole split entry (K8 + acceptance + K9) and K3 on
                # the same carry, a call and the kernels' device time.
                split_entry_ms=time_ms(split), split_entry_device_ms=device_ms(split),
                fused_k3_ms=time_ms(lambda: K3.fused_line_search(*ls, *tail, c["jac"])),
                fused_k3_device_ms=device_ms(lambda: K3.fused_line_search(*ls, *tail, c["jac"])),
                ms=time_ms(lambda: K3.wide_objectives(*ls)),
                device_ms=device_ms(lambda: K3.wide_objectives(*ls)),
                plain_ms=plain(lambda: K3.wide_objectives_plain(*ls)),
                **k8_bound),
            "k9": dict(
                max_abs_err=abs_err(rk[2], rp[2]),
                ms=time_ms(lambda: K3.wide_reroll(*rr, c["jac"])),
                device_ms=device_ms(lambda: K3.wide_reroll(*rr, c["jac"])),
                plain_ms=plain(lambda: K3.wide_reroll_plain(*rr, c["jac"])),
                **bound_keys(k9_in + n_bytes(c["jac"], *rk), k9_ops)),
            "k9_bf16": dict(
                max_abs_err=abs_err(rkb[2], rpb[2]),
                ms=time_ms(lambda: K3.wide_reroll(*rr, jb)),
                device_ms=device_ms(lambda: K3.wide_reroll(*rr, jb)),
                plain_ms=plain(lambda: K3.wide_reroll_plain(*rr, jb)),
                **bound_keys(k9_in + n_bytes(jb, *rkb), k9_ops)),
        }

    # K1-K3 at the main path's shape: the carry after make_carry0 at
    # B=4096, H=200, K2 and K3 under the main path's fixed cost as host
    # constants. The same carry under random per-lane planes is checked
    # and timed too (no path gives that shape per-lane planes, so it
    # adds keys to the fixed-cost rows, not rows of its own).
    report.append(check_k1("main-path carry", c, launches["relin_jacobians"]))
    lane_cp = fanout_candidates(dev, B_KERNEL, seed=3)
    planes = tuple(lane_cp[k].T.contiguous() for k in ("Qdiag", "Rdiag", "Fdiag"))
    fixed = check_k2_k3("fixed cost, main-path carry", c, diag)
    lane = check_k2_k3("per-lane cost, main-path carry", c, (*planes, (0.0,) * 4))
    report += k2_k3_rows(
        fixed, c, "fixed cost", launches,
        backward_quad_ll=dict(lane_cost_ms=time_ms(lane["k2"])),
        fused_line_search=dict(lane_cost_ms=time_ms(lane["k3"])),
    )

    # K1-K3 at the gate's shape, where phase 5 makes most of their
    # launches: the first carry of the receding loop (B=256, H=20) under
    # the same fixed cost. Each main-path row's ``launches`` are split by
    # shape, the gate's measurements under ``at_B256_H20``.
    _, make_carry_g, _, _ = make_batched_ilqr_solver(
        model.pred_core, cost, H=H_GATE, return_pieces=True, **common
    )
    cg = make_carry_g(model.params, x0_gate, x0_gate.new_zeros((B_GATE, H_GATE, 1)))
    gate_rows = [check_k1("gate carry", cg, gate_launches["relin_jacobians"])]
    gate_rows += k2_k3_rows(check_k2_k3("fixed cost, gate carry", cg, diag), cg,
                            "fixed cost", gate_launches)
    for r, g in zip(report[-3:], gate_rows):
        r[f"launches_B{B_SOLVE}_H{H}"] = solve_launches[r["name"].split("[")[0]]
        r[f"at_B{B_GATE}_H{H_GATE}"] = {
            k: v for k, v in g.items() if k not in ("name", "route", "source", "replaces")}
    # K2's bfloat16 instance on the same carry, its Jacobians rounded: the
    # shape of `llb`'s closed loop (phase 9), held to TOL_K2 as the
    # float32 instance is.
    act_g = ~cg["converged"] & ~cg["failed"]
    k2_gate_bf16 = (cg["jac"].to(torch.bfloat16), cg["xs"], cg["us"], *diag, dt, 4)
    kw_g = dict(carry=(act_g, cg["Ks"], cg["ks"]))
    bkb = K2.backward_quad_ll(*k2_gate_bf16, **kw_g)
    bpb = K2.backward_quad_ll_plain(*k2_gate_bf16, **kw_g)
    e_gb = max(rel_err(a, b) for a, b in zip(bkb, bpb))
    print(f"[3] K2 backward, bf16 Jacobians, gate carry: rel err K/k/lin/quad "
          f"{[f'{rel_err(a, b):.3e}' for a, b in zip(bkb, bpb)]} (tol {TOL_K2})", flush=True)
    if e_gb > TOL_K2:
        failures.append(f"K2 (bf16 Jacobians, gate carry) rel err {e_gb:.3e} > {TOL_K2}")
    # At an odd B the bfloat16 rows are read at the step (the kernel's
    # other instance): the first B_GATE - 1 lanes must give the same bits.
    odd = lambda t: t[..., :B_GATE - 1].contiguous()
    bko = K2.backward_quad_ll(odd(k2_gate_bf16[0]), odd(cg["xs"]), odd(cg["us"]),
                              *k2_gate_bf16[3:], carry=tuple(odd(t) for t in kw_g["carry"]))
    same_odd = all(bits_equal(a, odd(b)) for a, b in zip(bko, bkb))
    print(f"[3] K2 backward, bf16 Jacobians, first {B_GATE - 1} lanes of the gate carry (rows "
          f"read at the step): bit for bit the {B_GATE}-lane call's: {same_odd}", flush=True)
    if not same_odd:
        failures.append(f"K2 (bf16 Jacobians, B={B_GATE - 1}) differs from B={B_GATE}")
    k2_bf16_gate = dict(
        launches=wide_launches["llb_gate"]["backward_quad_ll[bf16]"],
        max_abs_err=max(abs_err(a, b) for a, b in zip(bkb, bpb)),
        ms=time_ms(lambda: K2.backward_quad_ll(*k2_gate_bf16, **kw_g)),
        plain_ms=time_ms(lambda: K2.backward_quad_ll_plain(*k2_gate_bf16, **kw_g), reps=5),
        **bound_keys(n_bytes(k2_gate_bf16[0], cg["xs"], cg["us"], act_g, cg["Ks"], cg["ks"],
                             *cg["cost"].values(), *bkb),
                     B_GATE * H_GATE * (riccati_flops(4, 1) + 16)),
    )

    # The wide options' kernels on the main path's carry at B=4096, at
    # the main path's first compaction stage, B=16384, and at SCHEDULE's
    # last, B=1024 (a shape the measured llw solves do not reach).
    wide4 = check_wide("main-path carry", c, diag)
    c16 = make_carry0(model.params, draw_x0(np.random.default_rng(4), B_SOLVE, dev), ug)
    wide16 = check_wide(f"main-path carry B={B_SOLVE}", c16, diag, plain_reps=1)
    del c16
    c1 = make_carry0(model.params, draw_x0(np.random.default_rng(5), B_WIDE_LAST, dev),
                     ug[:B_WIDE_LAST])
    wide1 = check_wide(f"main-path carry B={B_WIDE_LAST}", c1, diag, plain_reps=1)
    del c1

    def wide_row(key, name, source, replaces, n_launches, form="fixed cost", **extra):
        at = {}
        for Bw, w in ((B_SOLVE, wide16), (B_WIDE_LAST, wide1)):
            at[f"at_B{Bw}_H{H}"] = dict(w[key])
            at[f"at_B{Bw}_H{H}"].pop("library_ms")
        return dict(name=f"{name}[B={B_KERNEL},H={H},{form}]", route="cuda", source=source,
                    replaces=replaces, launches=n_launches, **wide4[key], **at, **extra)

    k9_bf16 = dict(wide4["k9_bf16"])
    k9_bf16.pop("library_ms")
    report += [
        wide_row("k2_4d", "backward_quad_ll_wide_4d", "autompc_torch/csrc/riccati_quad.cu",
                 "autompc_tpu/ops/pallas_riccati.py:1012",
                 wide_launches["ll"]["backward_quad_ll_wide_4d"]),
        wide_row("k2_bf16", "backward_quad_ll", "autompc_torch/csrc/riccati_quad.cu",
                 "autompc_tpu/ops/pallas_riccati.py:773, :865",
                 wide_launches["llb"]["backward_quad_ll[bf16]"], "fixed cost,bf16 jac",
                 **{f"launches_B{B_SOLVE}_H{H}": wide_launches["llb"]["backward_quad_ll[bf16]"]
                    - k2_bf16_gate["launches"], f"at_B{B_GATE}_H{H_GATE}": k2_bf16_gate}),
        wide_row("k3_bf16", "fused_line_search", "autompc_torch/csrc/linesearch_fused.cu",
                 "autompc_tpu/ops/pallas_linesearch.py:803",
                 wide_launches["llb"]["fused_line_search[bf16]"], "fixed cost,bf16 jac"),
        # llw launches K8 and K9 at every compaction stage of the solve:
        # ``launches_by_B`` splits the count by the stage's batch size.
        wide_row("k8", "wide_objectives", "autompc_torch/csrc/ls_obj_wide.cu",
                 "autompc_tpu/ops/pallas_linesearch.py:1129",
                 wide_launches["llw"]["wide_objectives"],
                 launches_by_B=wide_launches["llw"]["wide_objectives[by B]"]),
        # No path runs K9 on a bfloat16 carry (llw's is float32): its
        # measurement is a key of the row, with no launch count.
        wide_row("k9", "wide_reroll", "autompc_torch/csrc/ls_reroll_wide.cu",
                 "autompc_tpu/ops/pallas_linesearch.py:1200",
                 wide_launches["llw"]["wide_reroll"], bf16_jac=k9_bf16,
                 launches_by_B=wide_launches["llw"]["wide_reroll[by B]"]),
    ]

    # K1-K3 at the shape the fan-out gives them: configuration (a)'s
    # lanes-last carry after three iterations (B=1,024, H=10), K2 and K3
    # reading the carry's own per-lane cost planes.
    x0f = fan_batch["Qdiag"].new_tensor(np.tile(bench.task.get_init_obs(), (FAN_B, 1)))
    ugf = x0f.new_zeros((FAN_B, FAN_H, 1))

    def fan_carry(cfg):
        _, carry0, _, make_body = make_batched_ilqr_solver(
            model.pred_core, None, return_pieces=True, **fan_kw[cfg]
        )
        carry, body = carry0(model.params, x0f, ugf, fan_batch), make_body(model.params)
        for _ in range(3):
            carry = body(carry)
        return carry

    cfa = fan_carry("a")
    report.append(check_k1("fan-out (a) carry", cfa, fan_launches["a"]["relin_jacobians"]))
    fan_cost = (*(cfa["cost"][k] for k in ("Qdiag", "Rdiag", "Fdiag")), (0.0,) * 4)
    report += k2_k3_rows(
        check_k2_k3("per-lane cost, fan-out (a) carry", cfa, fan_cost,
                    agree_min=K3_FAN_AGREE_MIN, within_min=K3_FAN_WITHIN_MIN, split=True),
        cfa, "per-lane cost", fan_launches["a"],
    )

    # K1's batch-major entry, K6 and K7 at every batch size configuration
    # (b) launched them with (B=1,024 and its compaction stages, H=10): the
    # first B lanes of its carry after three iterations (its own per-lane
    # costs); and, untied to a path, at B=4096, H=200 on the main path's
    # carry (unpacked to batch-major) with the random per-lane costs
    # above. Each row is the fan-out's whole batch; the other batches are
    # its ``at_B*`` keys, each with its launches.
    jac_bm = c["jac"].reshape(H, 4, 5, B_KERNEL).permute(3, 0, 1, 2)
    c_bm = dict(
        x0s=c["x0s"].T.contiguous(), xs=c["xs"].permute(2, 0, 1).contiguous(),
        us=c["us"].T[:, :, None].contiguous(), Jx=jac_bm[..., :4].contiguous(),
        Ju=jac_bm[..., 4:].contiguous(),
    )
    cfb = fan_carry("b")
    fan_Bs = sorted({Bs for counts in fan_by_B["b"].values() for Bs in counts}, reverse=True)
    if fan_Bs[0] != FAN_B:
        failures.append(f"fan-out (b) launched its kernels at {fan_Bs}, not at B={FAN_B} first")
    k67 = {}
    for Bs in fan_Bs:
        sub = {k: cfb[k][:Bs].contiguous() for k in ("x0s", "xs", "us", "Jx", "Ju")}
        k67[Bs], fails = check_fanout_kernels(
            "fan-out (b) carry", K1, K2, K3, terms, ca, sub,
            {k: v[:Bs] for k, v in fan_batch.items()}, (0.0,) * 4, dt, alphas,
            float(bounds[0, 1]))
        failures += fails
    tune_Bs = sorted({Bs for counts in tune_by_B.values() for Bs in counts}, reverse=True)
    k67_tune, fails = check_tune_kernels(model, tune_kw, tune_batch, tune_Bs,
                                         bench.task.get_init_obs(), (K1, K2, K3), terms, ca,
                                         dt, alphas, float(bounds[0, 1]))
    failures += fails
    k67["main"], fails = check_fanout_kernels(
        "main-path carry", K1, K2, K3, terms, ca, c_bm, lane_cp, (0.0,) * 4, dt, alphas,
        float(bounds[0, 1]))
    failures += fails
    del cfb
    for k, (name, source, replaces) in enumerate((
        ("relin_jacobians_bm", "autompc_torch/csrc/relin.cu",
         "autompc_tpu/ops/pallas_relin.py:192"),
        ("backward_quad", "autompc_torch/csrc/riccati_quad_bm.cu",
         "autompc_tpu/ops/pallas_riccati.py:456"),
        ("sindy_line_search", "autompc_torch/csrc/sindy_linesearch.cu",
         "autompc_tpu/ops/pallas_linesearch.py:191"),
    )):
        by_B = fan_by_B["b"][name]
        at = {f"at_B{Bs}_H{FAN_H}": dict(k67[Bs][k], launches=by_B.get(Bs, 0))
              for Bs in fan_Bs[1:]}
        at[f"at_B{B_KERNEL}_H{H}"] = dict(k67["main"][k])
        # The tune's launches (phase 10), by batch size, each shape's
        # measurements beside them.
        at.update({f"at_B{Bs}_H{TUNE_H}": dict(k67_tune[Bs][k],
                                               launches=tune_by_B[name].get(Bs, 0))
                   for Bs in tune_Bs})
        for w in at.values():
            w.pop("library_ms")
        report.append(dict(
            name=f"{name}[B={FAN_B},H={FAN_H}]", route="cuda", source=source,
            replaces=replaces, launches=fan_launches["b"][name], launches_by_B=by_B,
            launches_tune=tune_launches[name], launches_tune_by_B=tune_by_B[name],
            **k67[FAN_B][k], **at,
        ))
    for tag, mdl, cst, kw, x0s, counts in (
        ("cheetah", hc_model, hc_cost, dict(hc_kw, H=H_HC), hc_x0, hc_launches),
        ("cartpole", cp_model, cp_cost, cp_kw, cp_x0, cp_launches),
    ):
        rows, fails = check_batch_major_kernels(tag, mdl, cst, kw, x0s, K4, K5, counts)
        report += rows
        failures += fails
        if tag == "cheetah":
            # K5 at the closed loop's shape (B=32, H=20), where the
            # cheetah path makes most of its launches: its row's
            # ``launches`` are the path's, split by shape here.
            # K4 and K5 at the closed loop's shape (B=32, H=20), where the
            # cheetah path makes most of their launches: each row's
            # ``launches`` are the path's, split by shape here.
            cl_rows, fails = check_batch_major_kernels(
                "cheetah closed loop", mdl, cst, dict(kw, H=H_HCQ), x0q, K4, K5,
                loop_launches, head_f64=True)
            failures += fails
            for r, cl in zip(rows, cl_rows):
                key = "K4" if r["name"].startswith("riccati_general") else "K5"
                r[f"launches_B{B_HC}_H{H_HC}"] = open_launches[key]
                r[f"at_B{B_HCQ}_H{H_HCQ}"] = {
                    k: v for k, v in cl.items() if k not in ("name", "route", "source", "replaces")}
        else:
            # K4 at (4, 1) on the joint-MLP tune's horizon-masked carry
            # (phase 11): its launches there, by B, and the measurement.
            Bj, Hj = jm_k4_args[1].shape[:2]
            jm_row, fails, _, _ = check_k4(f"joint-MLP tune (B={Bj}, H={Hj}, mixed horizons)",
                                          K4, jm_k4_args, jm_by_B.get(Bj, 0), device_time=True)
            failures += fails
            rows[0].update({
                "launches_joint_mlp": jm_launches, "launches_joint_mlp_by_B": jm_by_B,
                f"at_B{Bj}_H{Hj}": {k: v for k, v in jm_row.items()
                                    if k not in ("name", "route", "source", "replaces",
                                                 "library_ms")}})
    def device_txt(w):
        return ((f" (device {w['device_ms']:.4f})" if "device_ms" in w else "")
                + (f" (its lanes-last entry on the same points: device "
                   f"{w['lanes_last_device_ms']:.4f})" if "lanes_last_device_ms" in w else ""))

    def split_txt(w):
        return (f"split entry (K8 + acceptance + K9) {w['split_entry_ms']:.3f} ms (device "
                f"{w['split_entry_device_ms']:.4f}), K3 on the same carry {w['fused_k3_ms']:.3f} "
                f"ms (device {w['fused_k3_device_ms']:.4f})")

    for r in report:
        print(f"    {r['name']}: kernel {r['ms']:.3f} ms{device_txt(r)}, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; bytes "
              f"{r['bound_bytes_ms']:.4f}, operations {r['bound_ops_ms']:.4f}"
              + (f"; its scratch {r['scratch_bytes_ms']:.4f} ms at the memory rate"
                 if "scratch_bytes_ms" in r else "")
              + f"), {r['launches']} launches on its path"
              + (f" {r['launches_by_B']} by B" if "launches_by_B" in r else "")
              + (f"; {r['launches_tune']} in the tune {r['launches_tune_by_B']} by B"
                 if "launches_tune" in r else "")
              + (f"; {r['launches_joint_mlp']} in the joint-MLP tune "
                 f"{r['launches_joint_mlp_by_B']} by B" if "launches_joint_mlp" in r else ""))
        if "lane_cost_ms" in r:
            print(f"        with per-lane cost planes at this shape: kernel "
                  f"{r['lane_cost_ms']:.3f} ms (no path launches it so)")
        if "split_entry_ms" in r:
            print(f"        {split_txt(r)}")
        for key, w in r.items():
            if key.startswith("at_B") or key == "bf16_jac":
                print(f"        {key}: kernel {w['ms']:.3f} ms{device_txt(w)}, plain "
                      f"{w['plain_ms']:.3f} ms, bound {w['bound_ms']:.4f} ms ({w['bound_by']})"
                      + (f", {w['launches']} launches" if "launches" in w else "")
                      + (f"; its scratch {w['scratch_bytes_ms']:.4f} ms"
                         if "scratch_bytes_ms" in w else "")
                      + (f"; {split_txt(w)}" if "split_entry_ms" in w else ""))

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
