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
   closed loop on the true plant: 32 starts, 25 MPC steps (200 in
   bench_extra.py), H=20,
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
   three BO rounds of 128 candidates x 99 closed-loop steps (199 uncut; two of the
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
   (K4 at (4,1)) at H=25 for 6 closed-loop steps (instead of 199) on
   the surrogate and on the true dynamics; the ask, per-lane training and closed-loop
   seconds, evals/s and K4's launches by B printed, no NaN score; the
   incumbent simulated on the true dynamics from the canonical start
   must reach a finite task cost;
12. the joint-SINDy fan-out and tune (``JointSINDyQuadCostFanout``, every
   lane a SINDy model trained for its own threshold, the feature kernels'
   per-lane-coefficient instances): (a) and (b), bench_scaling.py's joint
   cell uncut (the main path's data, phase 2's model as surrogate, its
   55-term bucket, 1,024 candidates, H=10, 50 closed-loop steps,
   compaction ``4:0.5,8:0.25,14:0.125``) through the lanes-last fused
   body (K1, K2, K3) and the batch-major body the tuner takes (K1's
   batch-major entry, K6, K7): evals/s, per-lane training seconds and
   per-lane launches by B printed, every score finite or inf, the first
   MPC-step solves of (a) and (b) agreeing as phase 8's; a 105-term
   library (past the shared instances' 64) and the tune's 1,336-term
   library through both at B=128, 10 steps; (c) ``PipelineTuner.run``
   over the whole SINDyFactory space (``JS_TUNE_*``: two rounds of 12, 4
   closed-loop steps, both fan-outs, the seed pinned so that discrete
   buckets of 65-128 and past 128 terms run), each bucket's F, time
   mode, method, training and closed-loop seconds and the tune's wall
   split (asks, training, closed loops) printed; a candidate scored inf
   through the kernels with a finite model is scored again through the
   kernels' plain twins, and the phase fails if they score it finite;
13. the GaussReg / SumCost costs (``QuadCostFactory + GaussRegFactory``:
   the stage term regw (x - mu)' S (x - mu), S and mu the inverse
   covariance and mean of the main path's data, regw a lane's weight,
   10**U(-3, 4)): (a) phase 8's cell (1,024 candidates, H=10, 50 steps)
   with the term through (a1) the fused batch-major body (K1's
   batch-major entry at the first carry, K4 at (4,1), K3's batch-major
   entry with its GaussReg term) and (a2) the tuner's body (K1's
   batch-major entry, K4 at (4,1), K7), one warm and 3 timed calls each;
   (b) phase 12's 55-term joint-SINDy bucket at B=1,024, H=10, 10 steps
   through the same two bodies with per-lane coefficients; each pair's
   first MPC-step solves agree as phase 8's; (c) ``PipelineTuner.run``
   over the SumCost space with the fan-out (two rounds of 128 candidates
   x 24 steps, cut from 199, H=20, the true dynamics scored by a second
   fan-out, no fallback warning), the incumbent on the true dynamics (a
   finite cost),
   and the sequential objective (the explicit SumCost) against the
   fan-out on 4 candidates at 50 steps (>= 3 within 1e-3);
14. the MPPI and direct-transcription controllers (no kernel: the JAX
   package computes both in plain XLA): (a) ``bench_extra.py``'s MPPI
   rows on the phase-2 model and its quadratic cost (H=20, 4,096 paths):
   the step latency of ``Controller.run`` and rollouts/s, the receding
   loop's per-step latency over 200 steps from the canonical start on the
   true dynamics, the halfcheetah row (phase 6's MLP with its default
   seed); every control finite and inside its bounds; the first step's
   per-path costs within 1e-4 of the float64 CPU step's on the card's
   draws and its first control within 1e-2 umax; (b) its DT rows (20
   knots): the step latency, the receding SQP loop's per-step latency
   (15 steps), the first solve from 256 starts against float64 on the
   lanes that took the same step sizes; (c) ``MPPIFanout`` and
   ``DirectTranscriptionFanout`` at 256 candidates with and without the
   GaussReg term, evals/s and finite scores; (d) ``PipelineTuner.run``
   with the fan-out for an ``MPPIFactory`` and a
   ``DirectTranscriptionControllerFactory`` (one round of 64, both
   fan-outs), then sequential against fan-out (>= 3 of 4 within 1e-3);
15. the linear models (a linear model has a closed-form Jacobian, so
   no feature kernel runs; K6 at (ds, dc) = (12, 1) is the phase's
   kernel): (a) BASELINE.json configs[0], ARX + QuadCost + LQR: (a1) the
   JAX slice test's cell (ARX history 2 on 300 x 8 near-upright
   trajectories, FiniteHorizonLQR H=80, 200 steps from (0.3, 0, 0, 0) on
   the true dynamics; final abs(theta), abs(omega) < 0.05 required);
   (a2) ARXFactory's default (history 4, ds=20) on the main path's data:
   its fit's seconds, FiniteHorizonLQR at H=10 and InfiniteHorizonLQR
   (gains within 1e-4 of float64 on the CPU from the same (A, B); the
   controllers design in float64, and the same designs in float32 are
   printed beside them), the LQR step latency of ``Controller.run``;
   (b) configs[3], Koopman + DirectTranscription: the trig-basis lstsq
   Koopman (ds=12) on the main path's data, the DT controller at 20
   knots: its step latency, its first solve from 256 starts against
   float64 on the lanes with the same step sizes (phase 14's 1e-3), the
   receding loop (simulate, 30 steps) from the canonical start; the
   Lasso and stable fits: their seconds, their distance from float64
   fits, the stable fit's spectral radius (< 1 required); (c)
   ``bench_scaling.py``'s ``SCALE_MODE=joint_koopman`` row:
   ``JointKoopmanLassoQuadCostFanout`` at B=1,024, H=10, 25 steps (50 uncut),
   compaction ``8:0.5,16:0.25,28:0.125,40:0.0625``, (c1)
   ``backward="scan"`` and (c2) ``"pallas"`` (K6 at (12, 1)), one warm
   and 3 timed calls each, evals/s, finite scores, their first-step
   solves agreeing as phase 8's; (d) ``PipelineTuner.run`` for
   ``Pipeline(ARXFactory, QuadCostFactory, IterativeLQRFactory)`` and
   ``Pipeline(KoopmanFactory, ...)`` (the latter through K6): one BO
   round of 64 candidates at 24 steps (199 uncut) with both fan-outs, then
   sequential against fan-out (>= 3 of 4 within 1e-3); and ARX + QuadCost
   + LQRFactory through the sequential objective (the fan-out falls back
   with a warning), a finite incumbent;
16. the approximate GP and the pendulum (no new kernel: the GP is plain
   PyTorch, linearized by ``torch.func.jacfwd``; K6 and K4 at (4, 1) run
   on its fan-outs): (a) ``bench_extra.py``'s SVGP row (train seconds,
   preds/s, the float32 predictions against float64 on the CPU at the
   same parameters); (b) ``bench_scaling.py``'s ``SCALE_MODE=gp``:
   ``QuadCostFanout`` on an ``ApproximateGPModel`` (100 inducing points),
   B=512, H=10, 5 steps (50 uncut; ``GP_*``), (b1) ``backward="scan"`` and (b2) ``"pallas"``
   (K6), their first-step agreement as phase 8's; (c) ``SCALE_MODE=
   joint_gp``: ``JointGPQuadCostFanout`` with 16 induce_counts mixed in the
   batch, the buckets' training timed apart, (c1)/(c2) as (b), one padded
   bucket against its standalone training (its dummy weights exactly 0),
   and (c') one call with the GaussReg term (K4 at (4, 1)); (d) the
   tuner's kind "joint_gp": one BO round with both fan-outs, sequential
   against fan-out (>= 3 of 4 within 1e-3), a finite incumbent; (e) the
   pendulum: each data-generation method on the card against float64 on
   the CPU from the same draws, and BASELINE.json configs[2] (an MLP on
   pendulum data + MPPI with 4,096 paths): the step latency, the first
   step against float64, a 200-step receding loop from (pi, 0) on the true
   dynamics (finite, bounded; its final abs(theta) printed);
17. the model-tuning path (no new kernel: the buckets and the metrics are
   plain PyTorch; the fan-out after the surrogate tune runs K1's
   batch-major entry, K6 and K7) on the main path's data, 40
   trajectories trained on and 10 held out: (a) ``bench_extra.py``'s
   ``arx_bucket_train_and_score_configs_per_s`` row (``ARXBucketEvaluator``,
   kmax 10, horizon 5, k = 1..10): configs/s, every RMSE finite and within
   ``MT_ARX_TOL`` of the same evaluator in float64 on the CPU; (b) the
   SINDy (phase 2's 55-term library, 8 thresholds), Koopman lasso (the
   KoopmanFactory default basis, 8 alphas) and MLP (2 x relu, max_width
   256, 50 epochs, 8 (widths, lr) candidates) buckets: wall and configs/s,
   two candidates of each against the per-candidate path
   (``HoldoutModelEvaluator`` on the same split) within ``MT_AGREE_TOL``;
   (c) "autoselect" through ``PipelineTuner._get_surrogate`` (the five
   factories, 16 candidates in rounds of 8): the candidates each route
   scored, the winner, its RMSE, the wall; a bucket route that scored
   none of its eligible candidates fails; (d) "autotune" end to end:
   ``PipelineTuner.run`` on phase 2's model (QuadCostFactory,
   IterativeLQRFactory at H=20) with the SINDy surrogate tuned over 8
   candidates, then one BO round of 128 candidates through phase 10's
   fan-out options at 49 closed-loop steps: the selected surrogate
   configuration, a finite incumbent, the three kernels' launches (each
   > 0); (e) ``QuadCostFanout(impl="vmap")`` against ``impl="batched"``
   on 8 of (d)'s candidates, 3 steps: at least 6 of 8 within 1e-3;
18. the feature kernels off the cartpole's shape (the port's kernels
   build at first use at a (ds, dc) the main library lacks; phase [1]
   builds phase 18's beside it): (a) the pendulum's main path (data 50 x
   100, seed 42, the main path's library at d = 3, lstsq 1e-3, Q = F =
   diag(10, 0.1), R = 0.001): the scheduled lanes-last solve at B=16384,
   H=200 (2 warm, 3 timed runs on distinct draws; K1, K2, K3 at (2, 1)),
   solves/s and converged fraction, then the receding loop (256 starts
   within 0.3 of upright in theta and omega, the recovery task's
   neighbourhood, H=20, 200 steps) on the true pendulum, the share ending
   in the task's 0.2 box reported, not gated; (b) ``QuadCostFanout`` on
   that model in phase 8's two configurations (B=1,024, H=10, 25 steps;
   50 uncut), evals/s and the first-step agreement (>= 0.95) from (pi -
   0.5, 0); (c) ``PipelineTuner`` kind "ilqr" with phase 10's fan-out
   options on the recovery task (from (0.15, 0)), one round of 64
   candidates at 49 steps, then sequential
   against fan-out (>= 3 of 4); (d) the halfcheetah's SINDy (phase 6's
   data, the 48-term quadratic library, lasso) through the batch-major
   solve with its feature_spec at B=1024, H=200 (K1's batch-major entry,
   K4 and K7 at (18, 6)): solves/s, converged and finite shares, not gated;
19. the remaining kernels at every (ds, dc) (the constants ``DS_*``);
20. the solver's remaining options at ``SO_SMOKE`` (``SO_*``; the
   constants' comment says what and why): (a) the main path's problem on
   the batch-major body under ``backward`` "assoc", "pallas" (K6) and
   "scan", solves/s, converged fractions, the agreement shares, assoc's
   gains on the first carry against K6's; the SQP under "assoc" against
   "scan" on phase 15's Koopman; (b) ``make_staged_ilqr_solver`` against
   the scheduled batch-major solve; (c) ``relin="xla"`` and
   ``analytic_jac``; (d) a fixed dense cost, fused (K3's dense form, K4)
   against unfused (K7); (e) the GaussReg joint-SINDy fan-out on the
   105-term library, fused (K3's per-lane batch-major entry past 64
   terms) against unfused; (f) the cheetah row at K5's precisions
   "highest", "default" and "bf16x3", and "default" on phase 7's MLP;
21. the Koopman lifts past 24 states and K3 at dc > 1 at ``LM_SMOKE``
   (``LIFTS_21``' comment says what; ``tools/torch_lift_multicontrol_phase.py``
   runs ``LM_FULL``): (a) the joint-Koopman fan-out at 28, 72 and 96
   lifted states, backward="pallas", with and without the GaussReg term (K6's and
   K4's wide instance); (c) phase 18 (d)'s cheetah SINDy solve with
   fuse_ls (K3's multi-control instances, K4 at (18, 6), K1's batch-major
   entry at solve entry); (d) ``QuadCostFanout(fuse_ls=True)`` on it;
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
   iterations, padded steps included); phase 12's per-lane instances (K1
   and K3 on (a)'s carry, K1's batch-major entry and K7 on (b)'s at every
   batch (b) launched them with, three iterations in, the 55-term and the
   105-term libraries with the lanes' trained models, the 1,336-term
   library with the model ``JS_HUGE`` describes, at K3's and K7's fan-out
   tolerances; a kernel output not finite where the twin's is fails), and
   each given 1,024 copies of phase 2's model against its shared
   instance, bit for bit; K3's batch-major entry, with and without the
   GaussReg term, shared (13 (a1)'s carry) and per-lane (13 (b1)'s)
   coefficients, at every batch size phase 13 launched it with, with a
   zero weight bit for bit the instance without the term, and given the
   transposes of fan-out (a)'s and phase 12 (a)'s lanes-last carries bit
   for bit the lanes-last instance; K4 at (4,1) on 13 (a1)'s dense
   expansions; K6 at (12, 1) on phase 15 (c2)'s carry at every batch
   size (c2) and the "joint_koopman" tune launched it with (a row of its
   own); K6 at (4, 1) on phase 16 (c2)'s carry at every batch size (b2),
   (c2) and the "joint_gp" tune launched it with, and K4 at (4, 1) on
   (c')'s dense expansions at every batch size (c') launched it with
   (rows of their own); K1's batch-major entry, K6 and K7 on phase 17
   (d)'s carry at every batch size (d) launched them with (their rows'
   ``at_B*_H20_model_tuning`` keys); phase 18's instances in rows of their
   own (``*[2x1,...]``, ``*[18x6,...]``): K1-K3 at (2, 1) on the pendulum's
   main-path carry (B=4096, H=200), its closed loop's first carry (B=256,
   H=20) and fan-out (a)'s after three iterations, K1's batch-major entry,
   K6 and K7 at (2, 1) on fan-out (b)'s and the tune's carries at every
   batch size they launched with, K1's batch-major entry and K7 at (18, 6)
   on the cheetah SINDy solve's carry after three iterations; phase 21's
   (rows ``*[...,wide,...]``, ``fused_line_search_bm[18x6,...]``): K6's and
   K4's wide instance at 28, 72 and 96 states on (a)'s first backward
   pass where its models are finite (not at 96, whose float32 Lasso fits
   are NaN, as JAX's) and on well-conditioned inputs at the same shape
   (``check_backward``: each lane against float64, at TOL_K6 / TOL_K4),
   K3's multi-control instances on (c)'s fused carry one iteration in
   (also against float64 at the kernel's own trajectories). Within stated tolerances, timed with CUDA events (and where a
   call is shorter than its host work also as device time under
   torch.profiler), beside the least time the card could take
   (``bound_ms``).

Each path is driven with its kernels' launch counters set to 0 just
before and read just after: phases 2-5 for the lanes-last kernels,
phase 6 and phase 7 for the batch-major ones, each configuration of
phase 8 for its three and the tune of phase 10 for the same three
(``launches_tune`` in their rows), the tune of phase 11 for K4
(``launches_joint_mlp`` in its (4,1) row), each configuration and the
tune of phase 13 for theirs (``launches_gauss_reg``), phase 15 (c2) and
its "joint_koopman" tune for K6 at (12, 1) (``launches_joint_koopman``,
``launches_tune``), phase 16 (b2), (c2) and its tune for K6 at (4, 1)
and (c') for K4 (``launches_gp``), phase 17 (d) for K1's batch-major
entry, K6 and K7 (``launches_model_tuning``), phase 18 (a) for K1, K2, K3 at (2, 1)
(solves and closed loop apart), each configuration of 18 (b) and 18 (c)
for theirs, 18 (d) for K1's batch-major entry, K4 and K7 at (18, 6),
each path of phase 20 for its own (the new modes' rows
count K3's dense form in (d), its per-lane entry past 64 terms in (e),
K5 by precision in (f)), each path of phase 21 for its own (the wide
instances' launches by lifted dimension in (a), K3's multi-control
instances in (c)), each variant of phase 9 for the main
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

import functools
import json
import os
import subprocess
import sys
import time
import types
import warnings

import numpy as np
import torch

# The kernels' device time a call under torch.profiler, as the A/B tool
# measures it.
from tools.ab_torch_kernels import device_ms, k4_inputs, k6_wide_inputs

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
# The cheetah closed loop runs STEPS_HCQ MPC steps (bench_extra.py: 200;
# 100 since phase 16 was added: with 200 and phase 16 the whole command
# was killed at 1,262.5 s of a 1,260 s limit on an NVIDIA H100 80GB HBM3,
# 700 W whose host ran every phase ~1.3x slower than an earlier run;
# the 200-step loop took 94.5 s there; 50 since phase 17 was added: with
# 100 the command took 896.6 s of its 1,200 on an NVIDIA H100 80GB HBM3,
# 700 W, the 100-step loop 35.9 s of it); 25 since phase 18 was added
# (the 50-step loop 18.6 s).
B_HCQ, H_HCQ, STEPS_HCQ, ITERS_HCQ = 32, 20, 25, 20
B_DENSE = 4096
# Phase 7's unscheduled 50-iteration swing-up solve converges on about a
# fifth of the lanes; the floor only catches a broken solve.
CP_CONV_MIN = 0.1
# Share of the cheetah closed loop's lanes that must stay finite to the
# end (23 of 32 do with the seed above).
HCQ_ALIVE_MIN = 0.5

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# rate, float32 rate outside the tensor cores and the dense bfloat16
# tensor-core rate. ``bound_ms`` is the larger of bytes / HBM_BYTES_PER_S
# and the operations over the rate of their type: float32 operations /
# F32_FLOPS plus products of bfloat16 operands / BF16_FLOPS.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

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
# K5 at precision "default" (one bfloat16 pass; K5's default rule): a
# bfloat16 rounding that one float32 ulp flips parts a rollout from the
# plain version's early, so a rollout that misses TOL_K5_HEAD counts as
# within if it is no farther from the float64 rollout of the same rounding
# than the plain float32 version is (ROADMAP hazard 9), and K5_WITHIN_MIN
# of the rollouts must be within (a flip is as likely in the kernel as in
# the plain version: on the first card run, 7 of 40,960 rollouts of phase
# 20's cartpole MLP missed TOL_K5_HEAD, 4 of them no farther from float64);
# the next-state check at the kernel's own states holds on K5_WITHIN_MIN
# of the (rollout, step) points: a hidden input that lies within a float32
# rounding of a bfloat16 boundary rounds one bfloat16 ulp apart in float32
# and in float64.
# K5 at "bf16x3": each product carries the split's relative error of
# ~2^-16 (lo's own rounding and the dropped lo.lo term), 2^8 times
# float32's, and a last-digit difference in an activation between kernel
# and plain version moves lo by a bfloat16 ulp on about 1 input in 256;
# so its rollouts are held to K5_BF16X3_SCALE times TOL_K5_HEAD and
# TOL_K5, under the rule of "highest" otherwise (the first card run, the
# cheetah row: the head's worst 3.7e-5, 99% of the rollouts within 1.3e-4
# over the horizon; kernel and plain version each at most 5.8e-5 from the
# float64 rollout of the same split).
K5_BF16X3_SCALE = 10
# The bf16x3 control: the median over rollouts of the bf16x3 kernel's
# head error against the plain bf16x3 version, over the median of the
# kernel at "highest" against the same plain version (1 for a kernel
# that ignored the switch).
K5_BF16X3_CONTROL = 0.25

# Phase 8: the scaling harness's fixed-model fan-out, nothing cut.
FAN_B, FAN_H, FAN_STEPS = 1024, 10, 50
# Timed calls of phase 8's (and phase 13 (a)'s, phase 18 (b)'s) fan-outs
# after the warm one: 1 since phase 18 was added [3].
FAN_CALLS = 1
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
# Cut in depth since phase 18 was added (the whole command took 1,155 s
# of its 1,200 on an NVIDIA H100 80GB HBM3, 700 W whose host ran phases
# 10-17 1.29x slower than before phase 18 was added): the tune's closed loops
# TUNE_STEPS - 1 steps [199].
TUNE_STEPS = 100
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
# the surrogate and one on the true dynamics; JM_STEPS - 1 closed-loop
# steps instead of 199 (the incumbent's simulation too): 99 since phase
# 14 took the uncut command to 1,093.3 s of its 1,200 on an NVIDIA H100
# 80GB HBM3, 700 W (the closed loops were 264.9 s of the phase's 319.9),
# 49 since phase 15 took it to 1,132.4 s (phase 11's closed loops 129.2 s
# of its 165.5), 24 since phase 16 was added (the command killed at
# 1,262.5 s of 1,260 on a slow host, phase 11 113.7 s of it), 12 since
# phase 17 was added (the command 891.0 s of its 1,200 with the other
# cuts of phase 17's first runs, phase 11's closed loops 34.5 s of it).
# JM_STEPS: 7 since phase 20 was added [13].
JM_TRAJS, JM_EPOCHS, JM_ITERS, JM_BATCH, JM_STEPS = 40, 20, 25, 25, 7
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

# Phase 12: the joint-SINDy fan-out and tune (JointSINDyQuadCostFanout,
# the tuner's kind "joint_sindy"; every lane trains its own model and
# solves with it, so the feature kernels take per-lane coefficients over
# the whole library). (a) and (b): bench_scaling.py's joint cell
# (SCALE_MODE=joint), nothing cut: the main path's data (50 x 100, seed
# 42), phase 2's model as the surrogate, its bucket (the 55-term library,
# discrete, lstsq), B=1,024 candidates (reg = 10^U(-4,-1), Q and F
# diagonals 10^U(-1,1.5), R 10^U(-3,0)), H=10, 50 closed-loop steps,
# compaction 4:0.5,8:0.25,14:0.125; (a) the lanes-last fused body (K1,
# K2, K3), (b) the batch-major body the tuner takes (K1's batch-major
# entry, K6, K7). One warm and JS_CALLS timed calls each; the two
# configurations' first MPC-step solves must agree as phase 8's do.
# JS_CALLS: 1 since phase 20 was added [2].
JS_B, JS_H, JS_STEPS, JS_CALLS = 1024, 10, 50, 1
JS_SCHEDULE = "4:0.5,8:0.25,14:0.125"
JS_CONFIGS = {
    "a": dict(backward="pallas", use_feature_kernels=True, fuse_ls=True, lanes_last=True),
    "b": dict(backward="pallas", use_feature_kernels=True),
}
JS_BUCKET = {k: v for k, v in SINDY_KW.items() if k != "threshold"}
# A library past the shared instances' 64 terms (trig to frequency 2 +
# interaction, 105 terms) through both configurations at JS_BIG_B lanes,
# JS_BIG_STEPS closed-loop steps: the large tables and trees on a path.
JS_BIG = dict(JS_BUCKET, trig_freq=2)
JS_BIG_B, JS_BIG_STEPS = 128, 10
# The tune's largest discrete bucket at JS_TUNE_SEED (polynomials to
# degree 8 with cross terms + trig to frequency 1 + interaction, 1,336
# terms) through both configurations the same way: trees that fill slots
# 7-10 and column lists past index 127. Its float32 STLSQ fit gives no
# lane a model (the Gram is not positive definite in float32, so every
# lane's support comes out empty, as under the JAX package's Cholesky),
# so phase [3] holds the kernels at this library on a model it builds:
# each lane's trained JS_BUCKET model at those terms' places, and every
# other coefficient JS_HUGE_EPS * N(0, 1) / (F * the term's largest
# magnitude on the sysid data), so that every block of every tree holds
# nonzero summands while the rollouts stay bounded.
JS_HUGE = dict(JS_BUCKET, poly_basis=True, poly_degree=8, poly_cross_terms=True)
JS_HUGE_EPS = 1e-2
# (c) the tune: PipelineTuner.run over the whole SINDyFactory space with
# a QuadCostFactory and an IterativeLQRFactory (horizon 5..25), the
# fan-out path with the feature kernels, the true dynamics scored by a
# second fan-out; phase 2's model the surrogate and the main path's data
# the sysid data. Cut in depth: JS_TUNE_ITERS candidates in rounds of
# JS_TUNE_BATCH (the initial design: nearly every candidate is a bucket
# of its own, one fan-out call of 8 padded lanes), JS_TUNE_STEPS - 1
# closed-loop steps instead of 199 (19 until phase 16 was added: the
# command was then killed at 1,262.5 s of 1,260 on a slow host, this tune
# 169.5 s of it; 9 until phase 17 was added: the command 891.0 s of its
# 1,200, this tune 61.4 s of it, its continuous buckets at the solver's
# 50-iteration cap). The seed's draw holds discrete
# buckets past 64 terms (the per-lane kernels' large instances); the
# phase fails if none ran.
# JS_TUNE_ITERS: one round of 12 since phase 18 was added [two]: the
# seed's first round holds discrete buckets of 65-128 terms (65, 105) and
# past 128 (255, 791).
JS_TUNE_BATCH, JS_TUNE_ITERS, JS_TUNE_STEPS, JS_TUNE_SEED = 12, 12, 5, 4

# Phase 13: the GaussReg / SumCost costs (QuadCostFactory +
# GaussRegFactory, the term w_b (x - mu)' S (x - mu) with S, mu the
# inverse covariance and mean of the main path's data and w_b a lane's
# reg_weight, 10**U(-3, 4) from the seed GR_SEED). (a) phase 8's cell
# (the fixed-model cost fan-out, B=1,024, H=10, 50 steps, its compaction)
# with the term, through (a1) the fused batch-major body (K1's
# batch-major entry at the first carry, K4 at (4,1), K3's batch-major
# entry with its GaussReg term) and (a2) the tuner's body (K1's
# batch-major entry, K4 at (4,1), K7): one warm and 3 timed calls each;
# (b) phase 12's 55-term joint-SINDy bucket at B=1,024, H=10,
# GR_JS_STEPS steps through both bodies with per-lane coefficients, one
# warm and one timed call; the first MPC-step solves of each pair agree
# as phase 8's. (c) PipelineTuner.run over the SumCost space with the
# cost fan-out, the true dynamics scored by a second fan-out: two rounds
# of GR_TUNE_BATCH candidates at H=TUNE_H, cut in depth to GR_TUNE_STEPS
# - 1 closed-loop steps (199) to keep the command inside its time limit
# (uncut it took 1,030 s of its 1,200 on an NVIDIA H100 80GB HBM3, 700 W;
# 99 steps until phase 16 was added, 49 since);
# the incumbent on the true dynamics from the
# canonical start, as long, must reach a finite cost; sequential against
# fan-out at GR_SEQ_STEPS steps on a quadratic task cost, as phase 10's.
GR_SEED = 13
GR_CONFIGS = {
    "1": dict(backward="pallas", fuse_ls=True, lanes_last=False),
    "2": dict(backward="pallas", fuse_ls=False, lanes_last=False),
}
GR_JS_STEPS = 10
# GR_TUNE_STEPS: 25 since phase 18 was added, 13 since phase 20 was added [50].
GR_TUNE_BATCH, GR_TUNE_ITERS, GR_TUNE_STEPS, GR_SEQ_STEPS = 128, 256, 13, 50

# Phase 14: the MPPI and direct-transcription controllers, their receding
# loops, their fan-outs and the tuner's kinds "mppi" and "dt" (no kernel:
# the JAX package computes both in plain XLA, so they run here as plain
# PyTorch). (a) bench_extra.py's MPPI rows at full width: phase 2's model
# with the quadratic cost of bench_extra.py:43-52, H=20, 4,096 paths,
# sigma 1.0, lmda 0.3; the step latency (one warm call, then CT_STEP_REPS
# Controller.run calls, each to its result), the receding loop's per-step
# latency (CT_LOOP_STEPS steps from the canonical start on the true
# dynamics, one warm run and CT_LOOP_REPS timed) and the halfcheetah row
# (phase 6's MLP with the model's default training seed, trained as
# bench_extra.py:238-270 trains it, H=20, 4,096 paths, sigma = lmda =
# 0.5). Every control finite and inside its bounds; the first step's
# per-path costs on the card, given the card's draws, within CT_COST_TOL
# (relative, each path) of the float64 CPU step's, and its first control
# within CT_DU0_TOL * umax of the CPU step's. (b) bench_extra.py's DT
# rows: the same model and cost, horizon 1 s (20 knots), the step latency
# (one warm call, DT_STEP_REPS timed), the receding SQP loop at 20 knots
# (DT_LOOP_STEPS steps from the canonical start, one warm and DT_LOOP_REPS
# timed runs); the controller's first solve from
# DT_CHECK_B starts (the canonical one and draws) on the card and in
# float64 on the CPU: where a lane accepted the same step size at every
# SQP iteration on both, its controls within DT_US_TOL of the CPU's
# (relative to the lane's largest control, at least 1). (c) MPPIFanout
# (H=20, 200 paths) and DirectTranscriptionFanout (10 knots), CF_B
# candidates (phase 8's cost draws with sigma, lmda ~ U(0.1, 2) and
# regw = 10**U(-3, 4), seed CF_SEED), CF_STEPS closed-loop steps
# (CF_DT_STEPS for DT), with and without the GaussReg term (phase 13's S
# and mu): one warm call and CF_CALLS timed each. (d) PipelineTuner.run,
# surrogate_mode="pretrain",
# the fan-out, phase 2's model and QuadCostFactory with
# MPPIFactory(num_path=200, horizon=20) and with
# DirectTranscriptionControllerFactory(horizon=0.5): one BO round of
# CT_TUNE_BATCH candidates at CT_TUNE_STEPS - 1 steps, on the surrogate
# (CT_DT_TUNE_STEPS - 1 for DT) and on the true dynamics, no fallback
# warning, no NaN; then the sequential objective against the fan-out on
# CT_SEQ_ITERS candidates a kind at CT_SEQ_STEPS steps (CT_DT_SEQ_STEPS for
# DT) on a quadratic task cost (>= SEQ_AGREE_MIN within SEQ_TOL). Cut in
# depth to keep the phase near its ~120 s: a DT step is ~6,300 launches
# at 20 knots, ~24 us each on the host (the first run's 292 ms a step), so
# the DT loop runs DT_LOOP_STEPS steps (bench_extra.py: 200), its fan-out
# CF_DT_STEPS (50), its tune CT_DT_TUNE_STEPS - 1 (99; 49 until phase 16
# was added) and its sequential check CT_DT_SEQ_STEPS (25).
CT_H, CT_PATHS, CT_SIGMA, CT_LMDA = 20, 4096, 1.0, 0.3
# CT_LOOP_REPS, DT_LOOP_REPS, CF_CALLS: 1 timed run each since phase 18
# was added [3, 2, 2].
CT_STEP_REPS, CT_LOOP_STEPS, CT_LOOP_REPS = 20, 200, 1
HC_MPPI_SIGMA = HC_MPPI_LMDA = 0.5
CT_COST_TOL, CT_DU0_TOL = 1e-4, 1e-2
DT_HORIZON_S, DT_STEP_REPS = 1.0, 10
# DT_LOOP_STEPS: 15 since phase 20 was added [30].
DT_LOOP_KNOTS, DT_LOOP_STEPS, DT_LOOP_REPS = 20, 15, 1
DT_CHECK_B, DT_US_TOL = 256, 1e-3
CF_B, CF_H, CF_PATHS, CF_KNOTS, CF_STEPS, CF_CALLS, CF_SEED = 256, 20, 200, 10, 50, 1, 14
CF_DT_STEPS = 20
# CT_TUNE_STEPS, CT_DT_TUNE_STEPS: 50 and 13 since phase 20 was added [100, 25].
CT_TUNE_BATCH, CT_TUNE_STEPS, CT_SEQ_ITERS, CT_SEQ_STEPS = 64, 50, 4, 25
CT_DT_TUNE_STEPS, CT_DT_SEQ_STEPS = 13, 15

# Phase 15: the linear models (ARX, Koopman with its lstsq, lasso and
# stable fits, LQR), BASELINE.json configs[0] and [3], bench_scaling.py's
# joint-Koopman row and the tuner's kinds "joint_arx" and "joint_koopman"
# (K6 at (ds, dc) = (12, 1) is the only kernel: a linear model has a
# closed-form Jacobian and the solves are batch-major). (a1) configs[0]
# as tests/test_slice_arx_lqr.py:198-243 builds it: ARX (history 2) on
# LM_LOCAL_TRAJS uniform-random LM_LOCAL_LEN-step trajectories near
# upright (init +-0.15, |u| <= 2, seed 42 by a generator on the card),
# FiniteHorizonLQR at H=LM_A1_H, Q = F = diag(100, 10, 1, 1), R = 0.01,
# LM_A1_STEPS steps of simulate from (0.3, 0, 0, 0) on the true dynamics:
# final |theta|, |omega| < LM_A1_GATE. (a2) at full width: ARXFactory's
# default (history 4, ds = 20) on the main path's data, FiniteHorizonLQR
# at LQRFactory's default horizon (10) and InfiniteHorizonLQR: the gains
# against float64 on the CPU from the same (A, B) (normwise, relative,
# within LM_GAIN_TOL; the controllers design in float64, and the same
# designs run in float32 on the card are printed beside them: the
# infinite-horizon iteration does not converge on this model and runs
# its 10,000 steps), the fit's seconds, and the step latency of
# Controller.run (one warm call, LM_STEP_REPS timed). (b) configs[3]:
# Koopman lstsq with the trig basis at frequency 1 (ds = 12) on the main
# path's data, DirectTranscriptionController at DT_HORIZON_S (20 knots):
# the step latency (one warm, DT_STEP_REPS timed), the first solve from
# DT_CHECK_B starts against float64 as phase 14's (its DT_US_TOL), and
# the receding loop (simulate on the true dynamics) from the canonical
# start, cut to DT_LOOP_STEPS steps as phase 14's SQP loop; the lasso
# (alpha LM_LASSO_ALPHA) and stable fits: their seconds, each card fit's
# normwise relative distance from a float64 CPU fit on the same data, and
# the stable fit's spectral radius (< 1). (c) bench_scaling.py's
# SCALE_MODE=joint_koopman row, cut to JK_STEPS steps (50 uncut; 25
# since phase 17 was added: with 50 the command took 896.6 s of its 1,200
# on an NVIDIA H100 80GB HBM3, 700 W, (c1) and (c2) 43.9 s of it):
# JointKoopmanLassoQuadCostFanout
# (trig basis at frequency 1), B=JK_B, H=JK_H, JK_STEPS steps, goal zeros,
# alphas 10^U(-6, 0) and Q/F 10^U(-1, 1.5), R 10^U(-3, 0) from JK_SEED,
# compaction JK_SCHEDULE, phase 2's model the surrogate; (c1)
# backward="scan", (c2) backward="pallas" (K6 at (12, 1)), one warm call
# and JK_CALLS timed each; the first MPC-step solves agree as phase 8's,
# every score finite or inf. (d) PipelineTuner.run, surrogate_mode=
# "pretrain", the fan-out, phase 2's model, QuadCostFactory and
# IterativeLQRFactory(horizon=LM_TUNE_H) with ARXFactory (backward "scan":
# ds = 20 has no K6 instance) and with KoopmanFactory (backward "pallas":
# K6 at (12, 1), its launches in K6's row as ``launches_tune``, and
# phase [3] checks it at the tune's batch on (c2)'s carry): one BO round
# of LM_TUNE_BATCH candidates at
# LM_TUNE_STEPS - 1 steps (cut from 199: at 99 the command took 1,132.4 s
# of its 1,200, the "joint_koopman" tune 45.8 s of it), on the surrogate
# and on the true
# dynamics, no fallback warning, no NaN; sequential against fan-out on
# SEQ_ITERS candidates at LM_SEQ_STEPS steps (>= SEQ_AGREE_MIN within
# SEQ_TOL; the fan-out with the tune's backward); then ARX + QuadCost +
# LQRFactory through the sequential
# objective (use_fanout=True warns and falls back), LM_LQR_ITERS
# candidates, a finite incumbent. Cut in depth: the buckets pinned
# (ARXFactory's history at 4, KoopmanFactory's basis at trig_freq 1 with
# its three methods free, the iLQR horizon at LM_TUNE_H), so that a round
# is one fan-out call a bucket.
LM_LOCAL_TRAJS, LM_LOCAL_LEN, LM_A1_H, LM_A1_STEPS, LM_A1_GATE = 300, 8, 80, 200, 0.05
LM_STEP_REPS, LM_GAIN_TOL = 20, 1e-4
LM_LASSO_ALPHA = 1e-3
# JK_CALLS: 1 since phase 18 was added [3].
JK_B, JK_H, JK_STEPS, JK_CALLS, JK_SEED = 1024, 10, 25, 1, 15
JK_SCHEDULE = "8:0.5,16:0.25,28:0.125,40:0.0625"
JK_BASIS = dict(trig_basis=True, trig_freq=1)
# LM_TUNE_STEPS: 25 since phase 18 was added, 13 since phase 20 was added [50].
LM_TUNE_BATCH, LM_TUNE_STEPS, LM_TUNE_H, LM_SEQ_STEPS, LM_LQR_ITERS = 64, 13, 10, 25, 2

# Phase 16: the approximate GP (SVGP) and the pendulum. (a)
# bench_extra.py's svgp_train_s_and_pred_throughput row uncut:
# ApproximateGPModel(**GP_A) trained on the main path's first GP_A_TRAJS
# trajectories, pred_batch on GP_A_POINTS points from default_rng(0), one
# warm call and GP_A_REPS timed; the float32 predictions against float64
# on the CPU at the same parameters (normwise, GP_PRED_TOL). (b)
# bench_scaling.py's SCALE_MODE=gp row uncut: ApproximateGPModel(
# induce_count=GP_M) on the main path's data through QuadCostFanout, B=GP_B,
# H=GP_H, GP_STEPS steps, compaction GP_SCHEDULE, the diagonals from
# default_rng(GP_SEED), phase 2's model the surrogate; (b1)
# backward="scan", (b2) "pallas" (K6 at (4, 1)), one warm call and
# GP_CALLS timed each, the first MPC-step solves agreeing as phase 8's.
# (c) SCALE_MODE=joint_gp uncut: JointGPQuadCostFanout (niter GP_ITERS)
# with GP_DISTINCT induce_counts linspace(50, 200) drawn per lane after the
# diagonals, the buckets trained once (timed apart), (c1)/(c2) as (b1)/(b2);
# one padded bucket against the model trained alone; (c') one call with
# the GaussReg term (phase 13's S, mu and regw) at GP_REG_STEPS steps:
# K4 at (4, 1). (d) PipelineTuner.run with ApproximateGPModelFactory
# (niter GP_ITERS), QuadCostFactory, IterativeLQRFactory(horizon=
# GP_TUNE_H), backward "pallas": one BO round of GP_TUNE_BATCH candidates
# at GP_TUNE_STEPS - 1 steps on the surrogate and on the true dynamics,
# then sequential against fan-out on SEQ_ITERS candidates at GP_SEQ_STEPS
# steps. (e) the pendulum: each data-generation method on the card against
# float64 on the CPU from the same draws (PEND_CHECK_N x PEND_LEN,
# PEND_DATA_TOL), and BASELINE.json configs[2]: an MLP (2 x PEND_WIDTH,
# relu, PEND_EPOCHS epochs, cut from 50) on PEND_TRAJS x PEND_TRAJ_LEN
# uniform-random trajectories, MPPI at phase 14's H and 4,096 paths
# under diag(10, 0.1) / 0.001: the step latency, the first step against
# float64 (phase 14's tolerances), the PEND_LOOP_STEPS-step receding loop
# from (pi, 0) on the true dynamics. Cut in depth: (b) and (c) run
# GP_STEPS closed-loop steps (bench_scaling.py: 50) with GP_CALLS timed
# call after the warm one (3), and the tune GP_TUNE_STEPS - 1 steps (49):
# uncut, the phase took 929.5 s on an NVIDIA H100 80GB HBM3, 700 W (each
# of (b1), (b2), (c1), (c2) 37-66 s a call, every MPC step at the
# solver's 50-iteration cap, ~600-800 launches an iteration; the tune
# 75 s); at 10 steps (b) and (c) 131.8 s in a command killed at its
# 1,260 s limit.
GP_A = dict(niter=5, induce_count=64, batch_size=256, seed=0)
GP_A_TRAJS, GP_A_POINTS, GP_A_REPS, GP_PRED_TOL = 40, 4096, 10, 1e-3
GP_B, GP_H, GP_STEPS, GP_CALLS, GP_SEED, GP_M = 512, 10, 5, 1, 0, 100
GP_SCHEDULE = "8:0.5,16:0.25,28:0.125,40:0.0625"
# GP_REG_STEPS: 5 since phase 20 was added [10].
GP_DISTINCT, GP_ITERS, GP_REG_STEPS = 16, 5, 5
# GP_TUNE_STEPS: 6 since phase 18 was added [11].
GP_TUNE_BATCH, GP_TUNE_STEPS, GP_TUNE_H, GP_SEQ_STEPS = 64, 6, 10, 25
PEND_SEED, PEND_CHECK_N, PEND_LEN, PEND_DATA_TOL = 0, 64, 100, 1e-3
PEND_TRAJS, PEND_TRAJ_LEN, PEND_WIDTH, PEND_EPOCHS, PEND_LOOP_STEPS = 100, 200, 64, 10, 200

# Phase 17: the model-tuning path, on the main path's data (50 x 100,
# seed 42): MT_TRAIN trajectories trained on, the rest held out
# (bench_extra.py's split). (a) bench_extra.py's
# arx_bucket_train_and_score_configs_per_s row at its own width
# (ARXBucketEvaluator, kmax MT_KMAX, horizon MT_ARX_H, k = 1..kmax, one
# warm and MT_ARX_REPS timed calls), each RMSE against the same evaluator
# in float64 on the CPU within MT_ARX_TOL (relative). (b) the other three
# buckets at full width, horizon 1 (the tuner's): SINDy on phase 2's
# 55-term library with MT_SINDY_REGS thresholds, Koopman lasso on the
# KoopmanFactory default basis with MT_KOOPMAN_ALPHAS, MLP (2 x relu,
# max_width 256, 50 epochs, n_batch 64) with MT_MLP candidates; two
# candidates of each against the per-candidate path on the card
# (HoldoutModelEvaluator on the same split) within MT_AGREE_TOL. (c)
# "autoselect" through PipelineTuner._get_surrogate (the five factories,
# eval_batch MT_SEL_BATCH, MT_SEL_ITERS candidates, seed MT_SEL_SEED): a
# bucket route that scored none of its eligible candidates fails. (d)
# "autotune" end to end: PipelineTuner.run on phase 2's model with a
# QuadCostFactory and an IterativeLQRFactory pinned at TUNE_H, the SINDy
# surrogate tuned over MT_TUNE_SURR_ITERS candidates, then one BO round of
# MT_TUNE_BATCH candidates through phase 10's fan-out options, cut to
# MT_TUNE_STEPS - 1 closed-loop steps (199 uncut). (e) QuadCostFanout
# impl="vmap" (a single-lane solver a candidate) against impl="batched"
# on MT_VMAP_N of (d)'s candidates and (d)'s surrogate, MT_VMAP_STEPS
# steps (5 in the command's first run with phase 17, which took 896.6 s
# of its 1,200, (e) 10.6 s of it) of phase 10's quadratic near-upright
# task: at least
# MT_VMAP_AGREE_MIN within SEQ_TOL (relative), as phase 10's sequential
# check.
MT_TRAIN, MT_KMAX, MT_ARX_H, MT_ARX_REPS, MT_ARX_TOL = 40, 10, 5, 10, 1e-2
MT_SINDY_REGS = tuple(float(v) for v in np.logspace(-4, 0, 8))
MT_KOOPMAN_ALPHAS = tuple(float(v) for v in np.logspace(-6, 0, 8))
MT_MLP = (((32, 32), 1e-3), ((64, 64), 1e-3), ((128, 128), 1e-3), ((256, 256), 1e-3),
          ((128, 64), 3e-3), ((64, 128), 3e-4), ((256, 128), 1e-2), ((16, 256), 1e-3))
MT_AGREE_TOL = {"SINDy": 1e-3, "Koopman": 1e-3, "MLP": 5e-2}
# The agreement is relative to the larger of the per-candidate RMSE and
# MT_RMSE_FLOOR: the 55-term library holds the cartpole's own step, so a
# small threshold's RMSE is ~1e-6 (in float64 too), the rounding of the
# data and the fit, where a relative gap measures noise.
MT_RMSE_FLOOR = 1e-3
# MT_SEL_ITERS: one round of 8 since phase 18 was added [16].
MT_SEL_SEED, MT_SEL_BATCH, MT_SEL_ITERS = 17, 8, 8
# MT_TUNE_STEPS: 25 since phase 20 was added [50].
MT_TUNE_SEED, MT_TUNE_BATCH, MT_TUNE_STEPS, MT_TUNE_SURR_ITERS = 100, 128, 25, 8
MT_VMAP_N, MT_VMAP_STEPS, MT_VMAP_AGREE_MIN = 8, 3, 6

# Phase 18: the feature kernels off the cartpole's shape. (a) the
# pendulum's main path (PendulumSwingupBenchmark, data 50 x 100, seed 42,
# phase 2's SINDy library at d = 3: 21 terms, lstsq at 1e-3; Q = F =
# diag(PD_Q), R = PD_R): the scheduled lanes-last solve at B_SOLVE, H,
# SCHEDULE (phase 4's shape: 2 warm runs, 3 timed on distinct draws of
# theta in [-pi, pi], omega in [-1, 1]), then the receding loop from
# PD_CL_B starts about upright (theta, omega each within the
# pendulum's RECOVERY_SPREAD: from (pi, 0) every lane ended outside the
# box, so the loop measured nothing), H=PD_CL_H, PD_CL_STEPS steps on the
# true pendulum, the share ending in the task's 0.2 box reported (not
# gated until two runs agree on it); K1, K2, K3 at (2, 1). (b) QuadCostFanout
# on (a)'s model at FAN_B, FAN_H, PD_FAN_STEPS steps (50 uncut), both of
# phase 8's configurations, one warm and FAN_CALLS timed calls, their first-step
# agreement as phase 8's. (c) PipelineTuner kind "ilqr" with phase 10's
# fan-out options: one round of PD_TUNE_BATCH candidates at
# PD_TUNE_STEPS - 1 closed-loop steps on the surrogate and the true
# pendulum, then sequential vs fan-out on SEQ_ITERS candidates (phase
# 10's rule) from near upright (PD_SEQ_X0: the torque bound holds the
# pole there). (d) the halfcheetah's SINDy (phase 6's data,
# ``poly_basis=True, poly_degree=2``: 48 terms) through the batch-major
# solve with its feature_spec at B_HC, H_HC, HC_SCHEDULE (one warm run, 4
# timed on distinct starts): K1's batch-major entry, K4 and K7 at (18, 6);
# its converged and finite shares reported, not gated (K4's Cholesky is
# unguarded: ROADMAP hazard 5).
PD_Q, PD_R = (10.0, 0.1), 0.001
PD_CL_B, PD_CL_H, PD_CL_STEPS = 256, 20, 200
# Phase [3]'s K1-K3 rows at (2, 1) on the main path's shape (B_KERNEL, H)
# start around (pi, 0), theta and omega each within PD_KERNEL_SPREAD.
PD_KERNEL_SPREAD = 0.25
PD_FAN_STEPS = 25
# The first-step comparison's start: off the task's (pi, 0), where the
# pendulum hangs at rest and a zero control guess has no gradient to a
# side, so that the two bodies' roundings pick the swing's direction.
PD_FAN_X0 = (np.pi - 0.5, 0.0)
PD_TUNE_BATCH, PD_TUNE_STEPS = 64, 50
PD_SEQ_X0 = (0.15, 0.0)
# Lasso: the lstsq fits at thresholds 1e-3 and 1e-2 diverge within 30
# steps from phase 6's starts with the controls at 0 (in float64 on the
# CPU too), so every lane of the solve was NaN (measured on one H100).
HC_SINDY = dict(method="lasso", lasso_alpha=1e-3, poly_basis=True, poly_degree=2)
# The shapes phase 18 builds at first use, before any timed window.
SHAPES_18 = (("relin", 2, 1), ("riccati_quad", 2, 1), ("linesearch_fused", 2, 1),
             ("riccati_quad_bm", 2, 1), ("sindy_linesearch", 2, 1), ("relin", 18, 6),
             ("sindy_linesearch", 18, 6))

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


def time_ms(fn, reps=12, warm=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    ``warm`` untimed warm-up runs first)."""
    for _ in range(warm):
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


def plain_once(fn, plain):
    """``fn()``'s result and, where ``plain`` asks for one timed run and no
    warm-up (a plain version that takes seconds a call), its time in ms:
    the check's own call timed (CUDA events), so that the plain version
    runs once; else None (``time_ms`` times it apart)."""
    if plain.get("reps") != 1 or plain.get("warm") != 0:
        return fn(), None
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


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


def bound_keys(total_bytes, total_ops, bf16_ops=0):
    """The report's ``bound_ms`` and ``bound_by``: the least time the
    card could take to move ``total_bytes`` (every input read once,
    every output written once) and to do ``total_ops`` float32
    operations and ``bf16_ops`` operations of products of bfloat16
    operands (at the tensor cores' rate), the larger of the two (each
    also given on its own). No single PyTorch call computes any of these
    kernels' functions, so ``library_ms`` is None for all of them."""
    t_bytes = total_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (total_ops / F32_FLOPS + bf16_ops / BF16_FLOPS) * 1e3
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


def term_ops(t):
    """Float32 operations that form one term's value: a power z^e takes
    e - 1 products and the powers' join one less than their number (sum
    of the exponents less one in all); a trig factor its frequency's
    product, the sine or cosine and, beside powers, the join."""
    e = sum(int(v) for v in t.exps if int(v) > 0)
    mono = max(e - 1, 0)
    return mono + ((3 if e else 2) if t.trig else 0)


def feature_value_flops(terms, ds):
    """Float32 operations of one step of a linear-in-features model at
    one point: each term's value and ds coefficient multiply-adds."""
    return sum(term_ops(t) + 2 * ds for t in terms)


def feature_jac_flops(terms, ds):
    """Float32 operations of the model's Jacobian at one point, as the
    kernels walk it: for each input component, only the terms whose
    partial in it is not structurally zero (``_build.jacobian_columns``),
    each partial at most its term's products and one more (the power's
    factor or the trig's derivative), and ds coefficient multiply-adds."""
    from autompc_torch.ops._build import jacobian_columns

    return sum(term_ops(terms[k]) + 1 + 2 * ds for ks in jacobian_columns(terms) for k in ks)


def k3_bound(io_bytes, B, H, terms, L, ds=4):
    """K3's bound keys. Bytes: its inputs and outputs only. Operations:
    L rollout-steps a lane-step (the term values, the coefficient
    products, the feedback law, the stage cost and the du2 term) and one
    evaluation of the Jacobian. ``scratch_bytes_ms`` is beside the
    bound, not in it: the time the kernel's own scratch traffic takes at
    the memory rate (every candidate's states and controls written, L
    (ds + 1) floats a lane-step, and the selected candidate's read
    back), which the function itself does not need."""
    stash = 4 * (ds + 1) * H * B * (L + 1)
    ops = B * H * (L * (feature_value_flops(terms, ds) + 34) + feature_jac_flops(terms, ds))
    return dict(bound_keys(io_bytes, ops), scratch_bytes_ms=stash / HBM_BYTES_PER_S * 1e3)


def mlp_rollout_ops(widths, ds, dc, precision="highest", r0=None):
    """(float32 operations, bfloat16-product operations) of one
    rollout-step of the MLP line search. Float32: the feedback law, the
    biases and activations, and at "highest" the layer products. At
    "default" a layer product is one bfloat16 product an input-unit pair
    (a multiply and an add; the first layer's inputs from ``r0`` on stay
    float32), at "bf16x3" three, with the two partial sums' adds in
    float32; roundings count nothing (a tensor core takes bfloat16
    operands as they come)."""
    pairs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    units = sum(widths[1:])
    f32 = 2 * dc * (ds + 2) + 2 * units
    if precision == "highest":
        return f32 + 2 * pairs, 0
    if precision == "default":
        kept = (widths[0] - (widths[0] if r0 is None else r0)) * widths[1]
        return f32 + 2 * kept, 2 * (pairs - kept)
    return f32 + 2 * units, 6 * pairs


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


def dense_cartpole_problem(bench, trajs):
    """Phase 7's model, cost and solver options: a cartpole MLP (5-64-64-4,
    10 epochs) on ``trajs``, a QuadCost whose Q couples theta and omega,
    the general Riccati kernel at (4, 1) and the MLP line search."""
    from autompc_torch.costs import QuadCost
    from autompc_torch.sysid import MLP

    model = MLP(bench.system, n_hidden_layers=2, hidden_size=64, n_train_iters=10, n_batch=64)
    model.train(trajs)
    Qc = np.diag([10.0, 0.1, 0.01, 0.01])
    Qc[0, 1] = Qc[1, 0] = 0.05          # couples theta and omega
    cost = QuadCost(bench.system, Qc, 0.001 * np.eye(1), Qc, goal=np.zeros(4))
    bounds = bench.task.get_ctrl_bounds()
    kw = dict(
        H=H, ds=4, dc=1, obsdim=4, dt=bench.system.dt,
        ubounds=(bounds[:, 0], bounds[:, 1]), backward="pallas",
        pred_diff=model.pred_diff_core,
        # "mxu" names the TPU's second entry to this line search; the port
        # has one kernel for every layout.
        mlp_ls=dict(nonlin=model.nonlintype, layout="mxu"),
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


def _f64(args):
    return tuple(a.double() if isinstance(a, torch.Tensor) else a for a in args)


def check_backward(tag, kernel, plain, args, tol, row, ops, n_in, device_time=False):
    """A backward pass (K4, or K6's and K4's wide instance) against its
    plain version on ``args`` (Jx, Ju and the expansions or trajectory a
    path gives it; the first ``n_in`` the tensors read), both held
    against a float64 evaluation (see TOL_K4) at the tolerance ``tol``.
    Fills ``row``: ``max_abs_err`` against the plain version on the lanes
    where the plain version is within tol / 10 of float64,
    ``lanes_checked`` (the lanes finite in every evaluation), the times
    and the bound from ``ops``; a check with no such lane fails. Returns
    (``row``, failure strings, the kernel's outputs, the lanes finite in
    every evaluation); ``device_time`` adds the kernel's device time
    under torch.profiler."""
    B = args[1].shape[0]
    dev = args[0].device
    failures = []
    gk, gp = kernel(*args), plain(*args)
    g64 = plain(*_f64(args))

    def finite(g):
        return torch.stack([torch.isfinite(t).reshape(B, -1).all(1) for t in g]).all(0)

    def lane_err(g):
        """Per lane, the largest normwise error of the outputs against
        the float64 evaluation."""
        errs = []
        for a, r in zip(g, g64):
            a, r = a.double().reshape(B, -1), r.reshape(B, -1)
            errs.append((a - r).abs().amax(1) / r.abs().amax(1).clamp_min(1e-30))
        return torch.stack(errs).amax(0)

    # A lane whose Quu loses positive definiteness is NaN in kernel and
    # plain version alike; the others are compared.
    ok = finite(gk) & finite(gp) & finite(g64)
    same_finite = (finite(gk) == finite(gp)).float().mean().item()
    row.update(ms=time_ms(lambda: kernel(*args)), plain_ms=time_ms(lambda: plain(*args), reps=3),
               **bound_keys(n_bytes(*args[:n_in], *gk), ops))
    if device_time:
        row["device_ms"] = device_ms(lambda: kernel(*args))
    if not ok.any():
        print(f"[3] {tag} B={B}: no lane finite in every evaluation (kernel "
              f"{int(finite(gk).sum())}, plain {int(finite(gp).sum())}, float64 "
              f"{int(finite(g64).sum())})", flush=True)
        failures.append(f"{tag}: no lane finite in every evaluation")
        return dict(row, max_abs_err=None, lanes_checked=0), failures, gk, ok
    ek, ep = lane_err(gk)[ok], lane_err(gp)[ok]
    wc = ep <= tol / 10
    worst_well = float(ek[wc].max()) if wc.any() else 0.0
    within = (ek <= torch.clamp(10.0 * ep, min=tol)).float().mean().item()
    few = int(ok.sum()) * (1 - K4_WITHIN_MIN) < 1
    lane_txt, lanes_within = "", False
    if few:
        # Each lane against its own float32 error (see TOL_K4).
        gen = torch.Generator(device=dev).manual_seed(0)
        e32 = ep.clone()
        for _ in range(K4_WITNESS_DRAWS):
            nudged = [(a.double() * (1 + 2.0 ** -23 * (2 * torch.rand(
                a.shape, generator=gen, dtype=torch.float64, device=a.device) - 1))).float()
                if isinstance(a, torch.Tensor) else a for a in args]
            e32 = torch.maximum(e32, lane_err(plain(*nudged))[ok].nan_to_num(0.0))
        lanes_within = bool((ek <= torch.clamp(10.0 * e32, min=tol)).all())
        # The lanes outside the share's rule, and the plain version in
        # float32 on the CPU (another summation order) there.
        outside = (ek > torch.clamp(10.0 * ep, min=tol)).nonzero().flatten()
        ids = ok.nonzero().flatten()
        e_cpu = lane_err(tuple(t.to(dev) for t in plain(
            *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))))[ok]
        lane_txt = (f"; {int(ok.sum())} finite lanes, too few for the share: every lane "
                    f"within max({tol}, 10 x its float32 error over {K4_WITNESS_DRAWS} "
                    f"draws): {lanes_within}; lanes outside max({tol}, 10 x plain's): "
                    + ", ".join(f"lane {int(ids[i])} kernel {float(ek[i]):.3e} plain "
                                f"{float(ep[i]):.3e} plain on the CPU {float(e_cpu[i]):.3e} "
                                f"float32 over the draws {float(e32[i]):.3e}" for i in outside))
    well = ok.clone()
    well[ok] = wc
    row.update(max_abs_err=(max(abs_err(a[well], b[well]) for a, b in zip(gk, gp))
                            if well.any() else None),
               lanes_checked=int(ok.sum()))
    print(f"[3] {tag} B={B}: finite lanes {int(ok.sum())} "
          f"(kernel and plain agree on which: {same_finite:.4f}); per-lane error vs float64: "
          f"kernel median {float(ek.median()):.3e} max {float(ek.max()):.3e}, plain float32 "
          f"median {float(ep.median()):.3e} max {float(ep.max()):.3e}; {int(wc.sum())} "
          f"well-conditioned lanes (plain within {tol / 10}): kernel's worst "
          f"{worst_well:.3e} (tol {tol}); kernel within max({tol}, 10 x plain's) on "
          f"{within:.4f} of all lanes (min {K4_WITHIN_MIN}); kernel's error over plain's: "
          f"median {float((ek / ep.clamp_min(1e-30)).median()):.2f}, 99% "
          f"{float((ek / ep.clamp_min(1e-30)).quantile(0.99)):.2f}"
          + lane_txt, flush=True)
    if worst_well > tol or same_finite < K4_WITHIN_MIN or not (
            within >= K4_WITHIN_MIN or lanes_within) or not well.any():
        failures.append(f"{tag}: worst well-conditioned lane {worst_well:.3e} "
                        f"({int(wc.sum())} such lanes), within tolerance on {within:.4f} of "
                        f"lanes, finite flags agree on {same_finite:.4f}")
    return row, failures, gk, ok


def check_k4(tag, K4, k4_args, launches, device_time=False):
    """K4 against its plain version on ``k4_args`` (Jx, Ju and the dense
    expansions a path gives it): ``check_backward`` at TOL_K4. Returns
    (its report row, failure strings, the kernel's outputs, the lanes
    finite in every evaluation)."""
    B, H, ds, dc = k4_args[1].shape
    row = dict(name=f"riccati_general[{ds},{dc}]", route="cuda",
               source="autompc_torch/csrc/riccati_general.cu",
               replaces="autompc_tpu/ops/pallas_riccati.py:" + ("1260" if dc > 1 else "1338"),
               launches=launches)
    return check_backward(f"K4 general backward {tag} ({ds},{dc})", K4.riccati_general,
                          K4.riccati_general_plain, k4_args, TOL_K4, row,
                          B * H * riccati_flops(ds, dc), len(k4_args), device_time)


def check_batch_major_kernels(tag, model, cost, solver_kw, x0, K4, K5, launches,
                              n_iters=3, head_f64=False, k4=True, device_time=False):
    """K4 and K5 against their plain versions on the carry of the
    batch-major solver after ``n_iters`` iterations, K5 at the precision
    of ``solver_kw["mlp_ls"]`` (with ``device_time`` its time under the
    profiler too). With ``head_f64``, a K5 rollout whose first
    K5_HEAD steps miss TOL_K5_HEAD against the plain version passes if
    it is no farther from the plain version run in float64 (the same
    rounding) than the plain float32 version is; "default" always takes
    that rule (K5's default rule, beside TOL_K5_SUM). ``k4=False``: K5
    alone (the gains from
    K4 unchecked). Returns (report rows, failure strings)."""
    from autompc_torch.control import make_batched_ilqr_solver

    H, dt = solver_kw["H"], solver_kw["dt"]
    precision = solver_kw["mlp_ls"].get("precision", "highest")
    layout = solver_kw["mlp_ls"].get("layout", "slab")
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
    if k4:
        row, failures, gk, ok = check_k4(tag, K4, k4_args, launches["K4"])
        rows.append(row)
    else:
        gk = K4.riccati_general(*k4_args)
        ok = torch.isfinite(gk[0]).all(dim=(1, 2, 3)) & torch.isfinite(gk[1]).all(dim=(1, 2))

    nonlin = model.nonlintype
    layers = K5.fold_mlp_params(model.params)
    # The lanes whose gains and carry are finite (a NaN lane is NaN in
    # kernel and plain version alike and says nothing).
    # They are compared; the whole batch, as the path has it, is timed.
    alphas = tuple(0.2 ** k for k in range(10))
    ub = solver_kw["ubounds"]
    k5_path_args = (layers, nonlin, c["x0s"], c["xs"], c["us"], gk[0], gk[1], alphas,
                    ub[0], ub[1])
    k5_kw = dict(layout=layout, precision=precision)
    live = ok & torch.isfinite(c["xs"]).all(dim=(1, 2))
    if not live.any():
        return rows, failures + [f"K5 {tag}: no lane with finite gains and carry to compare"]
    c = {k: c[k][live].contiguous() for k in ("x0s", "xs", "us")}
    Ks, ks = gk[0][live].contiguous(), gk[1][live].contiguous()
    k5_args = (layers, nonlin, c["x0s"], c["xs"], c["us"], Ks, ks, alphas, ub[0], ub[1])
    (kx, ku), (px, pu) = (K5.mlp_line_search(*k5_args, **k5_kw),
                          K5.mlp_line_search_plain(*k5_args, **k5_kw))
    scale = K5_BF16X3_SCALE if precision == "bf16x3" else 1
    tol_head, tol_full = TOL_K5_HEAD * scale, TOL_K5 * scale

    def rollout_err(upto):
        """Per rollout, max |kernel - plain| over its first ``upto``
        states, relative to the rollout's largest plain state there."""
        d = (kx[:, :, :upto].double() - px[:, :, :upto].double()).abs().amax(dim=(2, 3))
        return d / px[:, :, :upto].double().abs().amax(dim=(2, 3)).clamp_min(1e-30)

    e_head = float(rollout_err(K5_HEAD + 1).max())
    e_full = rollout_err(H + 1).reshape(-1)
    full_within = (e_full <= tol_full).float().mean().item()
    # The plain version's rollouts in float64: how far the kernel and the
    # plain float32 version each are from them over the first K5_HEAD
    # steps, per rollout, relative to its largest float64 state there.
    rx64, _ = K5.mlp_line_search_plain(
        tuple((W.double(), b.double()) for W, b in layers), nonlin,
        *(t.double() for t in k5_args[2:7]), *k5_args[7:], **k5_kw)
    n_head = K5_HEAD + 1
    ref = rx64[:, :, :n_head].abs().amax(dim=(2, 3)).clamp_min(1e-30)
    e_k64, e_p64 = ((a[:, :, :n_head].double() - rx64[:, :, :n_head]).abs().amax(dim=(2, 3))
                    / ref for a in (kx, px))
    head_ok = rollout_err(n_head) <= tol_head
    # "bf16x3": the control. The kernel at "highest" on the same inputs,
    # held against the plain bf16x3 version as the bf16x3 kernel is: a
    # kernel that ran "highest" under the bf16x3 switch would sit as far
    # from the plain version as this one does, so the bf16x3 kernel's
    # median head error must be at most K5_BF16X3_CONTROL of it.
    control = None
    if precision == "bf16x3":
        hx, _ = K5.mlp_line_search(*k5_args, layout=layout, precision="highest")
        d_ctl = ((hx[:, :, :n_head].double() - px[:, :, :n_head].double()).abs()
                 .amax(dim=(2, 3)) / px[:, :, :n_head].double().abs().amax(dim=(2, 3))
                 .clamp_min(1e-30))
        e_med, c_med = float(rollout_err(n_head).median()), float(d_ctl.median())
        control = dict(head_median=e_med, highest_head_median=c_med,
                       ratio=e_med / max(c_med, 1e-30))
        print(f"[3] K5 {tag} control: first {K5_HEAD} steps against the plain bf16x3 "
              f"version, median over rollouts: the bf16x3 kernel {e_med:.3e}, the kernel at "
              f"'highest' {c_med:.3e} (worst {float(d_ctl.max()):.3e}); ratio "
              f"{control['ratio']:.4f} (max {K5_BF16X3_CONTROL})", flush=True)
        if not control["ratio"] <= K5_BF16X3_CONTROL:
            failures.append(f"K5 {tag} (bf16x3): head error {e_med:.3e} is not below "
                            f"{K5_BF16X3_CONTROL} of the 'highest' kernel's {c_med:.3e}")
    if head_f64 or precision == "default":
        head_ok |= e_k64 <= e_p64
    # "default": a share of the rollouts (K5's default rule).
    head_pass = (float(head_ok.double().mean()) >= K5_WITHIN_MIN if precision == "default"
                 else bool(head_ok.all()))
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
    # The products at the kernel's precision: its roundings of the
    # weights, and of each layer's input (in float64 here).
    prec_k, r0 = K5.kernel_precision(precision, layout), K5.round0(layers, layout)
    wl = K5._weights(tuple((W.double(), b.double()) for W, b in layers), prec_k, r0)
    for i, (W, b) in enumerate(wl):
        Wa = sum(w.abs() for w in W) if prec_k == "bf16x3" else W.abs()
        mag = mag @ Wa + b.abs()
        h = K5._product(h, W, prec_k, r0 if i == 0 else None) + b
        if i < len(wl) - 1:
            h = getattr(torch, nonlin)(h)
            mag = mag if nonlin in ("relu", "selu") else torch.ones_like(mag)
    x64 = kx[:, :, :-1].double() + h
    e_pt = ((kx[:, :, 1:].double() - x64).abs()
            / (kx[:, :, :-1].double().abs() + mag).clamp_min(1e-30)).amax(-1)
    e_x = float(e_pt.max())
    # "default" rounds each hidden input to bfloat16: where the float64
    # evaluation's input lies across a rounding boundary from the
    # kernel's float32 one, the two round one bfloat16 ulp apart, so the
    # next-state check is a share (K5's default rule).
    x_within = float((e_pt <= TOL_K5_SUM).double().mean())
    widths = [ds + dc] + [int(b.shape[0]) for _, b in layers]
    weights = [t for pair in layers for t in pair]
    prec_tag = "" if precision == "highest" else f",{precision}"
    rows.append(dict(
        name="mlp_line_search[" + "-".join(str(w) for w in widths) + prec_tag + "]",
        route="cuda",
        source="autompc_torch/csrc/mlp_linesearch.cu",
        replaces="autompc_tpu/ops/pallas_mlp_linesearch.py:"
                 + ("599" if solver_kw["mlp_ls"].get("layout") == "mxu" else "515"),
        launches=launches["K5"],
        max_abs_err=max(abs_err(kx, px), abs_err(ku, pu)),
        ms=time_ms(lambda: K5.mlp_line_search(*k5_path_args, **k5_kw)),
        plain_ms=time_ms(lambda: K5.mlp_line_search_plain(*k5_path_args, **k5_kw), reps=3),
        **bound_keys(
            n_bytes(*weights, *k5_path_args[2:7]) + n_bytes(kx, ku) * B // int(live.sum()),
            *(B * len(alphas) * H * n
              for n in mlp_rollout_ops(widths, ds, dc, prec_k, r0)),
        ),
        **({} if precision == "highest" else dict(
            tol_head=tol_head, tol_full=tol_full,
            head_over_tol=int((rollout_err(n_head) > tol_head).sum()),
            head_over_tol_f64_ok=int(((rollout_err(n_head) > tol_head)
                                      & (e_k64 <= e_p64)).sum()),
            rollouts=int(rollout_err(n_head).numel()), next_x_within=x_within,
            **({} if control is None else dict(control=control)))),
        **(dict(device_ms=device_ms(lambda: K5.mlp_line_search(*k5_path_args, **k5_kw)))
           if device_time else {}),
    ))
    print(f"[3] K5 MLP line search {tag} widths {widths} B={B}, {int(live.sum())} live "
          f"lanes compared: per-rollout xs vs plain: first {K5_HEAD} steps worst "
          f"{e_head:.3e} (tol {tol_head:g}); all {H} steps median "
          f"{float(e_full.median()):.3e}, 99% {float(e_full.quantile(0.99)):.3e}, worst "
          f"{float(e_full.max()):.3e}, within {tol_full:g} on {full_within:.4f} (min "
          f"{K5_WITHIN_MIN}); normwise xs {rel_err(kx, px):.3e}, us {rel_err(ku, pu):.3e}; "
          f"vs float64 at the kernel's states: u {e_u:.3e}, next x {e_x:.3e} of term "
          f"magnitudes (tol {TOL_K5_SUM}; within it on {x_within:.6f} of the points); first "
          f"{K5_HEAD} steps vs the float64 rollouts: "
          f"kernel worst {float(e_k64.max()):.3e}, plain float32 worst "
          f"{float(e_p64.max()):.3e}; rollouts over {tol_head:g} against plain "
          f"{int((rollout_err(n_head) > tol_head).sum())}"
          + (f", of them no farther from float64 than plain float32 "
             f"{int(((rollout_err(n_head) > tol_head) & (e_k64 <= e_p64)).sum())}; within "
             f"on {float(head_ok.double().mean()):.6f} of the rollouts"
             if head_f64 or precision == "default" else ""), flush=True)
    x_ok = x_within >= K5_WITHIN_MIN if precision == "default" else e_x <= TOL_K5_SUM
    if not (head_pass and full_within >= K5_WITHIN_MIN
            and e_u <= TOL_K5_SUM and x_ok):
        failures.append(f"K5 {tag} ({precision}) head {e_head:.3e} full within "
                        f"{full_within:.4f} u {e_u:.3e} next x {e_x:.3e} (within {x_within:.6f})")
    return rows, failures


def fanout_candidates(dev, n, seed=0, obsdim=4):
    """The harness's candidate batch: Qdiag, Fdiag = 10**U(-1, 1.5),
    Rdiag = 10**U(-3, 0), as tensors on the card."""
    from autompc_torch import default_dtype

    rng = np.random.default_rng(seed)
    batch = {"Qdiag": 10 ** rng.uniform(-1, 1.5, (n, obsdim)),
             "Fdiag": 10 ** rng.uniform(-1, 1.5, (n, obsdim)),
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
        for _ in range(FAN_CALLS):
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
              f"{FAN_STEPS} steps: warm call {warm_s:.2f} s; {FAN_CALLS} timed calls "
              f"{elapsed:.3f} s -> {FAN_CALLS * FAN_B / elapsed:.1f} evals/s on {card}; scores "
              f"finite {int(fin.sum())}, inf {int((~fin).sum())}, mean of finite "
              f"{float(scores[fin].mean()):.2f}; launches in {FAN_CALLS + 1} calls {counts[cfg]}, "
              f"by B {by_B[cfg]}", flush=True)
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
    system, task = bench.system, bench.task.copy()
    task.set_num_steps(TUNE_STEPS)
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
                   "num_steps": TUNE_STEPS,
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
    from autompc_torch.control import IterativeLQRFactory
    from autompc_torch.costs import QuadCostFactory
    from autompc_torch.parallel import JointMLPQuadCostFanout
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.sysid import FunctionModel, MLPFactory
    from autompc_torch.tuning import PipelineTuner, bo, pipeline_tuner
    from autompc_torch.utils import simulate

    t_phase = time.perf_counter()
    bench = CartpoleSwingupV2Benchmark()
    system, task = bench.system, bench.task.copy()
    task.set_num_steps(JM_STEPS)
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
    B, H = full["lr"].shape[0], fan.solver_kw["H"]
    x0 = full["lr"].new_tensor(np.tile(task.get_init_obs(), (B, 1)))
    k4_args = capture_k4(K4, fan._pred_core, fan.solver_kw, params, x0, cp)
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
    return launches, by_B, k4_args


def joint_candidates(dev, n, seed=0):
    """bench_scaling.py's joint batch: the cost candidates of
    ``fanout_candidates`` and reg = 10**U(-4, -1) (the STLSQ
    thresholds)."""
    batch = fanout_candidates(dev, n, seed)
    reg = 10 ** np.random.default_rng(seed + 1).uniform(-4, -1, n)
    return dict(batch, reg=batch["Qdiag"].new_tensor(reg))


def joint_counters(K1, K2, K3):
    """The wrappers the joint fan-out's two configurations launch, by
    name: the per-lane-coefficient instances count in ``launches_lane``
    (K2 and K6 take no coefficients)."""
    return {"a": (K1.relin_jacobians, K2.backward_quad_ll, K3.fused_line_search),
            "b": (K1.relin_jacobians_bm, K2.backward_quad, K3.sindy_line_search)}


def reset_launches(wrappers):
    for w in wrappers:
        for attr in ("launches", "launches_by_B", "launches_lane", "launches_lane_by_B"):
            if hasattr(w, attr):
                setattr(w, attr, type(getattr(w, attr))())


def lane_launches(wrappers):
    """{wrapper: its launches of a per-lane-coefficient instance (every
    launch for K2 and K6), and those by batch size}."""
    return ({w.__name__: getattr(w, "launches_lane", w.launches) for w in wrappers},
            {w.__name__: dict(getattr(w, "launches_lane_by_B", getattr(w, "launches_by_B", {})))
             for w in wrappers})


def joint_fanout(bench, model, trajs, cfg, bucket, horizon, n_steps, schedule=JS_SCHEDULE):
    from autompc_torch.parallel import JointSINDyQuadCostFanout

    return JointSINDyQuadCostFanout(bench.system, bench.task, bucket, trajs, model,
                                    horizon=horizon, n_steps=n_steps, goal=np.zeros(4),
                                    compact_schedule=schedule, **JS_CONFIGS[cfg])


def joint_sindy_phase(bench, model, trajs, dev, card, wrappers, profile=False):
    """Phase 12 (a), (b) and the two large libraries. Returns {"main":
    {config: (launches, by B)}, "big": {...}, "huge": {...}, "fans":
    {config: the fan-out}, "big_fans": {...}, "huge_fans": {...},
    "batch": candidates, "big_batch": the large libraries' candidates}."""
    from autompc_torch.control import make_scheduled_ilqr_solver, parse_schedule

    out = {"main": {}, "fans": {}}
    batch = joint_candidates(dev, JS_B)
    for cfg in JS_CONFIGS:
        fan = joint_fanout(bench, model, trajs, cfg, JS_BUCKET, JS_H, JS_STEPS)
        out["fans"][cfg] = fan
        reset_launches(wrappers[cfg])
        t0 = time.perf_counter()
        scores = fan(batch)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(JS_CALLS):
            scores = fan(batch)
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        t0 = time.perf_counter()
        fan.train_lanes(batch["reg"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts, by_B = lane_launches(wrappers[cfg])
        out["main"][cfg] = (counts, by_B)
        if tuple(scores.shape) != (JS_B,) or torch.isnan(scores).any():
            raise RuntimeError(f"joint fan-out ({cfg}): malformed or NaN scores")
        fin = torch.isfinite(scores)
        print(f"[12] joint fan-out ({cfg}) {JS_CONFIGS[cfg]}: F={fan.n_features}, B={JS_B} "
              f"H={JS_H} {JS_STEPS} steps: warm call {warm_s:.2f} s; {JS_CALLS} timed calls "
              f"{elapsed:.3f} s -> {JS_CALLS * JS_B / elapsed:.1f} evals/s on {card} (per-lane "
              f"training {train_s:.3f} s a call); scores finite {int(fin.sum())}, inf "
              f"{int((~fin).sum())}, mean of finite {float(scores[fin].mean()):.2f}; per-lane "
              f"launches in {JS_CALLS + 1} calls {counts}, by B {by_B}", flush=True)
        if min(counts.values()) == 0:
            raise RuntimeError(f"a kernel never ran on the joint fan-out ({cfg}): {counts}")
        if profile:
            profile_solve(joint_fanout(bench, model, trajs, cfg, JS_BUCKET, JS_H, 5), (batch,),
                          f"5 closed-loop steps of the joint fan-out ({cfg})")

    # The first MPC step's solve, (a) against (b): the same trained lanes.
    coeffs = out["fans"]["a"].train_lanes(batch["reg"])
    x0 = batch["Qdiag"].new_tensor(np.tile(bench.task.get_init_obs(), (JS_B, 1)))
    ug = x0.new_zeros((JS_B, JS_H, 1))
    cp = {k: batch[k] for k in ("Qdiag", "Rdiag", "Fdiag")}
    res = {cfg: make_scheduled_ilqr_solver(fan._pred_core, None,
                                           schedule=parse_schedule(JS_SCHEDULE), **fan.solver_kw)(
        {"coeffs": coeffs}, x0, ug, cp) for cfg, fan in out["fans"].items()}
    obj = {cfg: lane_objective(o[1], o[2], cp, bench.system.dt) for cfg, o in res.items()}
    both = res["a"][0] & res["b"][0]
    rel = ((obj["a"] - obj["b"]).abs() / obj["b"].abs().clamp_min(1e-30))[both]
    share = float((rel <= FAN_OBJ_TOL).float().mean()) if both.any() else 0.0
    print(f"[12] first MPC step, (a) vs (b): converged (a) {int(res['a'][0].sum())}, (b) "
          f"{int(res['b'][0].sum())}, both {int(both.sum())} of {JS_B}; accepted objective "
          f"relative difference on those: median {float(rel.median()):.3e}, 90% "
          f"{float(rel.quantile(0.9)):.3e}, max {float(rel.max()):.3e}; within {FAN_OBJ_TOL} "
          f"on {share:.4f} (min {FAN_AGREE_MIN})", flush=True)
    if int(both.sum()) < JS_B // 4 or share < FAN_AGREE_MIN:
        raise RuntimeError(f"joint fan-out first step: {int(both.sum())} lanes converged in "
                           f"both, objectives agree on {share:.4f}")

    # The large libraries through both configurations.
    out["batch"], out["big_batch"] = batch, joint_candidates(dev, JS_BIG_B, seed=3)
    for size, bucket in (("big", JS_BIG), ("huge", JS_HUGE)):
        out[size], out[f"{size}_fans"] = {}, {}
        for cfg in JS_CONFIGS:
            fan = joint_fanout(bench, model, trajs, cfg, bucket, JS_H, JS_BIG_STEPS)
            out[f"{size}_fans"][cfg] = fan
            reset_launches(wrappers[cfg])
            t0 = time.perf_counter()
            scores = fan(out["big_batch"])
            torch.cuda.synchronize()
            counts, by_B = lane_launches(wrappers[cfg])
            out[size][cfg] = (counts, by_B)
            fin = torch.isfinite(scores)
            fitted = int((fan.train_lanes(out["big_batch"]["reg"]) != 0).flatten(1).any(1).sum())
            print(f"[12] joint fan-out ({cfg}), F={fan.n_features} (past 64 terms): "
                  f"B={JS_BIG_B} H={JS_H} {JS_BIG_STEPS} steps in {time.perf_counter() - t0:.2f} "
                  f"s; lanes with a nonzero model {fitted}; scores finite {int(fin.sum())}; "
                  f"per-lane launches {counts}, by B {by_B}", flush=True)
            if torch.isnan(scores).any() or min(counts.values()) == 0:
                raise RuntimeError(f"joint fan-out ({cfg}) F={fan.n_features}: NaN scores or a "
                                   f"kernel that never ran: {counts}")
    return out


def joint_sindy_tune(bench, model, trajs, dev, card, wrappers_b):
    """Phase 12 (c). Returns (the per-lane launches of the batch-major
    wrappers by library size: small (<= 64 terms), big (65-128) and huge
    (past 128), and the tune's wall split). A candidate that scores inf
    on a bucket the kernels ran, with a finite trained model, is scored
    again with the kernels' plain twins in their place; the phase fails
    if the twins score it finite."""
    from autompc_torch.control import IterativeLQRFactory
    from autompc_torch.control import ilqr as ilqr_mod
    from autompc_torch.costs import QuadCostFactory
    from autompc_torch.parallel import fanout as fanout_mod
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.sysid import FunctionModel, SINDyFactory
    from autompc_torch.tuning import PipelineTuner, bo, pipeline_tuner

    system = bench.system
    task = bench.task.copy()
    task.set_num_steps(JS_TUNE_STEPS)
    asks, calls = [], []

    class TimedBO(bo.BatchBayesOpt):
        def ask(self, batch_size=None):
            t0 = time.perf_counter()
            got = super().ask(batch_size)
            asks.append(time.perf_counter() - t0)
            return got

    Fan = fanout_mod.JointSINDyQuadCostFanout
    real_train, real_loop = Fan.train_lanes, Fan.closed_loop

    def timed(real, key):
        def run(self, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real(self, *a)
            torch.cuda.synchronize()
            calls[-1][key] = time.perf_counter() - t0
            return res
        return run

    real_call = Fan.__call__
    twins = {name: getattr(ilqr_mod, name) for name in (
        "relin_jacobians", "relin_jacobians_bm", "sindy_line_search", "fused_line_search")}

    def twin_scores(fan, batch, lanes):
        """The candidates ``lanes`` of ``batch`` through ``fan`` with the
        kernels' plain twins in the solver; the time goes to twin_s."""
        t0 = time.perf_counter()
        full, n = fan._stage({k: np.asarray(v)[lanes] for k, v in batch.items()})
        for name, w in twins.items():
            setattr(ilqr_mod, name, getattr(sys.modules[w.__module__], name + "_plain"))
        try:
            scores = real_loop(fan, real_train(fan, full["reg"]),
                               {k: full[k] for k in ("Qdiag", "Rdiag", "Fdiag")})[:n]
        finally:
            for name, w in twins.items():
                setattr(ilqr_mod, name, w)
        torch.cuda.synchronize()
        calls[-1]["twin_s"] = time.perf_counter() - t0
        return scores

    def call(self, batch):
        before = lane_launches(wrappers_b)[0]
        calls.append(dict(F=self.n_features, time_mode=self.time_mode, method=self.method,
                          H=self.solver_kw["H"], n=len(batch["reg"]),
                          true=isinstance(self.surrogate, FunctionModel)))
        res = real_call(self, batch)
        after = lane_launches(wrappers_b)[0]
        calls[-1]["launches"] = {k: after[k] - before[k] for k in after}
        if self.solver_kw["feature_spec"] is not None and not torch.isfinite(res).all():
            full, n = self._stage(batch)
            fitted = torch.isfinite(real_train(self, full["reg"])[:n]).flatten(1).all(1)
            redo = (~torch.isfinite(res) & fitted).cpu().numpy()
            if redo.any():
                tw = twin_scores(self, batch, redo)
                calls[-1]["inf_twin_finite"] = (int(redo.sum()), int(torch.isfinite(tw).sum()))
        return res

    pipeline = Pipeline(system, SINDyFactory(system), QuadCostFactory(system, goal=np.zeros(4)),
                        IterativeLQRFactory(system))
    tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=JS_TUNE_BATCH, use_fanout=True,
                          fanout_backward="pallas", fanout_feature_kernels=True)
    reset_launches(wrappers_b)
    saved = (pipeline_tuner.BatchBayesOpt, Fan.train_lanes, Fan.closed_loop, Fan.__call__)
    pipeline_tuner.BatchBayesOpt = TimedBO
    Fan.train_lanes, Fan.closed_loop = timed(real_train, "train_s"), timed(real_loop, "loop_s")
    Fan.__call__ = call
    try:
        t0 = time.perf_counter()
        _, res = tuner.run(pipeline, task, trajs, n_iters=JS_TUNE_ITERS,
                           rng=np.random.default_rng(JS_TUNE_SEED), surrogate=model,
                           truedyn=bench.dynamics)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
    finally:
        pipeline_tuner.BatchBayesOpt, Fan.train_lanes, Fan.closed_loop, Fan.__call__ = saved
    for c in calls:
        print(f"[12] tune bucket F={c['F']} {c['time_mode']} {c['method']} H={c['H']} "
              f"({'true dynamics' if c['true'] else 'surrogate'}): {c['n']} candidates, "
              f"training {c.get('train_s', 0.0):.3f} s, closed loop {c.get('loop_s', 0.0):.2f} s; "
              f"per-lane launches {c['launches']}"
              + (f"; inf with a finite model on {c['inf_twin_finite'][0]}, finite with the plain "
                 f"twins on {c['inf_twin_finite'][1]} ({c['twin_s']:.2f} s)"
                 if "inf_twin_finite" in c else ""), flush=True)
    costs, true_costs = np.array(res.costs), np.array(res.truedyn_costs)
    split = dict(asks_s=sum(asks), train_s=sum(c.get("train_s", 0.0) for c in calls),
                 loop_s=sum(c.get("loop_s", 0.0) for c in calls),
                 twin_s=sum(c.get("twin_s", 0.0) for c in calls))
    split["rest_s"] = tune_s - sum(split.values())
    by_size = {"small": {}, "big": {}, "huge": {}}
    for c in calls:
        size = by_size["huge" if c["F"] > 128 else "big" if c["F"] > 64 else "small"]
        for k, v in c["launches"].items():
            size[k] = size.get(k, 0) + v
    big_discrete = sorted({c["F"] for c in calls if c["F"] > 64 and c["time_mode"] == "discrete"})
    inf_twin = [(c["F"], *c["inf_twin_finite"]) for c in calls if "inf_twin_finite" in c]
    print(f"[12] tune {JS_TUNE_ITERS} candidates in rounds of {JS_TUNE_BATCH} "
          f"({JS_TUNE_STEPS - 1} MPC steps each, both fan-outs, {len(calls)} fan-out calls): "
          f"{tune_s:.2f} s -> {JS_TUNE_ITERS / tune_s:.2f} evals/s on {card}; BO asks "
          f"{split['asks_s']:.2f} s, per-lane training {split['train_s']:.2f} s, closed loops "
          f"{split['loop_s']:.2f} s, plain-twin reruns of inf scores {split['twin_s']:.2f} s, the "
          f"rest {split['rest_s']:.2f} s; scores finite "
          f"{int(np.isfinite(costs).sum())} / {costs.size} on the surrogate, "
          f"{int(np.isfinite(true_costs).sum())} / {true_costs.size} on the true dynamics; "
          f"incumbent {res.inc_cfg.get_dictionary() if res.inc_cfg is not None else None} "
          f"({res.inc_costs[-1]:.2f}); discrete buckets past 64 terms {big_discrete}; per-lane "
          f"launches by library size {by_size}", flush=True)
    if len(costs) != JS_TUNE_ITERS or np.isnan(costs).any() or np.isnan(true_costs).any():
        raise RuntimeError("joint tune: a score is missing or NaN")
    if min(by_size["big"].values(), default=0) == 0 \
            or min(by_size["huge"].values(), default=0) == 0:
        raise RuntimeError(f"joint tune: no discrete bucket of 65-128 or past 128 terms ran the "
                           f"per-lane kernels ({big_discrete}, {by_size})")
    if any(finite for _, _, finite in inf_twin):
        raise RuntimeError(f"joint tune: candidates scored inf through the kernels and finite "
                           f"through their plain twins (F, inf, twin finite): {inf_twin}")
    return by_size, split


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
                         bound, plain=None, gains=None):
    """K1's batch-major entry, K6 and K7 against their plain versions on
    a batch-major carry (x0s, xs, us, Jx, Ju) with per-lane costs ``cp``;
    at dc = 1 K1's batch-major entry also against its lanes-last entry on
    the same points (bit for bit), K7 on K6's gains. ``coeffs`` is one
    (ds, n) model or, per lane, a lanes-last (ds, n, B) plane (the
    per-lane instances). ``plain``: ``time_ms``'s arguments for the plain
    versions of K1 and K7 (3 runs by default). ``K6=None`` (dc > 1):
    no K6 row, and K7 takes ``gains = (Ks, ks)``. ``bound``: the control
    bound, a scalar or one a control. Returns (the kernels'
    measurements, failure strings)."""
    plain = plain or dict(reps=3)
    x0s, xs, us, Jx, Ju = (carry[k] for k in ("x0s", "xs", "us", "Jx", "Ju"))
    B, H, dc = us.shape
    ds = xs.shape[-1]
    rows, failures = [], []
    k1_args = (terms, xs, us, coeffs)
    jk = K1.relin_jacobians_bm(*k1_args)
    jp, jp_ms = plain_once(lambda: K1.relin_jacobians_bm_plain(*k1_args), plain)
    e1 = max(rel_err(a, b) for a, b in zip(jk, jp))
    same, ll = True, {}
    if dc == 1:
        ll_args = (terms, xs.permute(1, 2, 0).contiguous(), us[:, :, 0].T.contiguous(), coeffs)
        jl = K1.relin_jacobians(*ll_args).reshape(H, ds, ds + 1, B).permute(3, 0, 1, 2)
        same = bits_equal(jk[0], jl[..., :ds].contiguous()) and \
            bits_equal(jk[1], jl[..., ds:].contiguous())
        ll = dict(lanes_last_device_ms=device_ms(lambda: K1.relin_jacobians(*ll_args)))
    rows.append(dict(
        max_abs_err=max(abs_err(a, b) for a, b in zip(jk, jp)),
        ms=time_ms(lambda: K1.relin_jacobians_bm(*k1_args)),
        device_ms=device_ms(lambda: K1.relin_jacobians_bm(*k1_args)),
        plain_ms=jp_ms if jp_ms is not None else time_ms(
            lambda: K1.relin_jacobians_bm_plain(*k1_args), **plain), **ll,
        **bound_keys(n_bytes(xs, us, coeffs, *jk),
                     B * H * feature_jac_flops(terms, ds)),
    ))
    g1 = K1.relin_geometry(B, H, K1._build.sm_count(xs.device), ds, dc, bm=True)
    print(f"[3] K1 relin, batch-major entry, {tag} B={B} H={H} (ds, dc) = {(ds, dc)} "
          f"({g1['lanes']} points x {g1['threads'] // g1['lanes']} threads a block): rel err "
          f"Jx/Ju {e1:.3e} (tol {TOL_K1})"
          + (f"; bit for bit the lanes-last entry's rows on the same points: {same}"
             if dc == 1 else ""), flush=True)
    if not (e1 <= TOL_K1 and same):
        failures.append(f"K1 batch-major {tag} rel err {e1:.3e}, equal to lanes-last {same}")
    if K6 is not None:
        k6_args = (Jx, Ju, xs, us, cp["Qdiag"], cp["Rdiag"], cp["Fdiag"], goal, dt, len(goal))
        gk, gp = K6.backward_quad(*k6_args), K6.backward_quad_plain(*k6_args)
        e6 = [rel_err(a, b) for a, b in zip(gk, gp)]
        rows.append(dict(
            max_abs_err=max(abs_err(a, b) for a, b in zip(gk, gp)),
            ms=time_ms(lambda: K6.backward_quad(*k6_args)),
            device_ms=device_ms(lambda: K6.backward_quad(*k6_args)),
            plain_ms=time_ms(lambda: K6.backward_quad_plain(*k6_args), reps=3),
            **bound_keys(n_bytes(*k6_args[:7], *gk), B * H * (riccati_flops(ds, 1) + 16)),
        ))
        g6 = K6.bq_bm_geometry(B, H, ds, sm_count=K6._build.sm_count(xs.device))
        print(f"[3] K6 batch-major backward {tag} B={B} H={H} ({g6['group']} threads a lane, "
              f"{g6['lanes_per_block']} lanes a block, {g6['blocks']} blocks, ring {g6['ring']}): "
              f"rel err K/k/lin/quad {[f'{e:.3e}' for e in e6]} (tol {TOL_K6})", flush=True)
        if not max(e6) <= TOL_K6:
            failures.append(f"K6 {tag} rel err {max(e6):.3e} > {TOL_K6}")
        gains = gk[:2]

    Ks, ks = gains
    bnd = torch.as_tensor(np.broadcast_to(np.asarray(bound, dtype=np.float64), (dc,)).copy(),
                          dtype=torch.float64, device=xs.device)
    lo_hi = (-bnd.cpu().numpy(), bnd.cpu().numpy()) if dc > 1 else (-bound, bound)
    k7_args = (terms, x0s, xs, us, Ks, ks, coeffs, alphas, *lo_hi)
    kx, ku = K7.sindy_line_search(*k7_args)
    (px, pu), p7_ms = plain_once(lambda: K7.sindy_line_search_plain(*k7_args), plain)
    kfin = torch.isfinite(kx).all(dim=(2, 3)) & torch.isfinite(ku).all(dim=(2, 3))
    pfin = torch.isfinite(px).all(dim=(2, 3)) & torch.isfinite(pu).all(dim=(2, 3))
    finite = kfin & pfin
    same_finite = (kfin == pfin).float().mean().item()
    kernel_only = int((~kfin & pfin).sum())     # not finite where the twin is

    def rollout_err(upto):
        d = (kx[:, :, :upto].double() - px[:, :, :upto].double()).abs().amax(dim=(2, 3))
        return (d / px[:, :, :upto].double().abs().amax(dim=(2, 3)).clamp_min(1e-30))[finite]

    head = min(K7_HEAD, H)
    if not finite.any():
        failures.append(f"K7 {tag}: no rollout finite in both")
        return rows, failures
    e_head = float(rollout_err(head + 1).max())
    e_full = rollout_err(H + 1)
    full_within = (e_full <= TOL_K7).float().mean().item()
    # float64 evaluation at the kernel's own states.
    a64 = torch.tensor(alphas, dtype=torch.float64, device=xs.device)[None, :, None, None]
    fb = Ks[:, None].double() * (kx[:, :, :-1].double() - xs[:, None, :-1].double())[:, :, :, None]
    step, ubar = a64 * ks[:, None].double(), us[:, None].double()       # (B, L, H, dc)
    u64 = torch.minimum(torch.maximum(step + ubar + fb.sum(-1), -bnd), bnd)
    scale = step.abs() + ubar.abs() + fb.abs().sum(-1)
    e_u = float(((ku.double() - u64).abs() / scale.clamp_min(1e-30)).amax(-1)[finite].max())
    from autompc_torch.sysid.basis import term_value

    z = [kx[:, :, :-1, i].double() for i in range(ds)] + [ku[..., j].double() for j in range(dc)]
    theta = torch.stack([term_value(t, z) for t in terms], dim=-1)     # (B, L, H, F)
    c64 = coeffs.double()
    if c64.ndim == 3:      # lane b's rollouts through lane b's model
        x64 = torch.einsum("blhf,ifb->blhi", theta, c64)
        mag = torch.einsum("blhf,ifb->blhi", theta.abs(), c64.abs())
    else:
        x64 = theta @ c64.T
        mag = theta.abs() @ c64.abs().T
    e_x = float(((kx[:, :, 1:].double() - x64).abs() / mag.clamp_min(1e-30))[finite].max())
    rows.append(dict(
        max_abs_err=max(abs_err(kx[finite], px[finite]), abs_err(ku[finite], pu[finite])),
        ms=time_ms(lambda: K7.sindy_line_search(*k7_args)),
        device_ms=device_ms(lambda: K7.sindy_line_search(*k7_args)),
        plain_ms=p7_ms if p7_ms is not None else time_ms(
            lambda: K7.sindy_line_search_plain(*k7_args), **plain),
        **bound_keys(n_bytes(x0s, xs, us, Ks, ks, coeffs, kx, ku),
                     B * len(alphas) * H * (feature_value_flops(terms, ds) + 2 * ds * dc + 12)),
    ))
    print(f"[3] K7 rollout line search {tag} B={B} H={H} L={len(alphas)} (ds, dc) = {(ds, dc)}: "
          f"rollouts finite in "
          f"both {int(finite.sum())} of {finite.numel()} (flags agree {same_finite:.4f}; not "
          f"finite only in the kernel {kernel_only}); per "
          f"rollout vs plain: first {head} steps worst {e_head:.3e} (tol {TOL_K7_HEAD}); all "
          f"{H} steps median {float(e_full.median()):.3e}, 99% "
          f"{float(e_full.quantile(0.99)):.3e}, worst {float(e_full.max()):.3e}, within "
          f"{TOL_K7} on {full_within:.4f} (min {K7_WITHIN_MIN}); vs float64 at the kernel's "
          f"states: u {e_u:.3e}, next x {e_x:.3e} of term magnitudes (tol {TOL_K7_SUM})",
          flush=True)
    if not (e_head <= TOL_K7_HEAD and full_within >= K7_WITHIN_MIN and same_finite >= 0.999
            and kernel_only == 0 and e_u <= TOL_K7_SUM and e_x <= TOL_K7_SUM):
        failures.append(f"K7 {tag} head {e_head:.3e} full within {full_within:.4f} finite flags "
                        f"{same_finite:.4f} kernel-only non-finite {kernel_only} u {e_u:.3e} "
                        f"next x {e_x:.3e}")
    return rows, failures


class PhaseCtx(types.SimpleNamespace):
    """What phase [3]'s lanes-last checks read besides their arguments:
    the model's active terms and coefficients (``terms``, ``ca``), dt,
    the control bounds (``lo``, ``hi``), the step sizes, the device, the
    failure list they append to and the kernel modules (K1, K2, K3)."""


def check_k1_ll(ctx, tag, c, n_launches, tms=None, coef=None, name="relin_jacobians",
                plain=None):
    """The relinearization kernel on the trajectory of the lanes-last
    carry ``c``: one report row. ``tms``/``coef``: another library's
    terms and coefficients than the main path's (a per-lane plane
    (ds, n, B) for the per-lane instances); ``plain``: ``time_ms``'s
    arguments for the plain version (its defaults if None)."""
    terms, ca, failures, K1 = ctx.terms, ctx.ca, ctx.failures, ctx.K1
    tms, coef, plain = tms or terms, ca if coef is None else coef, plain or {}
    Hc, Bc = c["us"].shape
    ds = c["xs"].shape[1]
    k1_args = (tms, c["xs"], c["us"], coef)
    jk = K1.relin_jacobians(*k1_args)
    jp, jp_ms = plain_once(lambda: K1.relin_jacobians_plain(*k1_args), plain)
    e1 = rel_err(jk, jp)
    print(f"[3] K1 relin, {tag}: rel err {e1:.3e} (tol {TOL_K1})", flush=True)
    if e1 > TOL_K1:
        failures.append(f"K1 ({tag}) rel err {e1:.3e} > {TOL_K1}")
    return dict(
        name=f"{name}[B={Bc},H={Hc}]", route="cuda",
        source="autompc_torch/csrc/relin.cu",
        replaces="autompc_tpu/ops/pallas_relin.py:192",
        launches=n_launches, max_abs_err=abs_err(jk, jp),
        ms=time_ms(lambda: K1.relin_jacobians(*k1_args)),
        device_ms=device_ms(lambda: K1.relin_jacobians(*k1_args)),
        plain_ms=jp_ms if jp_ms is not None else time_ms(
            lambda: K1.relin_jacobians_plain(*k1_args), **plain),
        **bound_keys(n_bytes(c["xs"], c["us"], coef, jk),
                     Bc * Hc * feature_jac_flops(tms, ds)),
    )

def check_k2_k3_ll(ctx, tag, c, cost, agree_min=K3_AGREE_MIN, within_min=None, split=False,
                   tms=None, coef=None, plain=None):
    """One backward pass and one line search on the lanes-last carry
    ``c`` under ``cost = (qd, rd, fd, goal)``; returns the kernels'
    outputs, the twin pairs and the timed closures, and appends to
    ``failures``. The twins' states are gated normwise, or, with
    ``within_min``, per lane on that share of the lanes; their
    objectives normwise. With
    ``split``, the split search (K8 + acceptance + K9) is held
    against K3 on the same inputs: decisions on ``agree_min`` of the
    active lanes, and bit for bit where they agree. ``tms``/``coef``
    as in ``check_k1``; ``plain``: as ``k2_k3_rows``' (a one-shot timing
    times the check's own calls of the plain versions)."""
    terms, ca, failures, dt, alphas, dev = (ctx.terms, ctx.ca, ctx.failures, ctx.dt,
                                            ctx.alphas, ctx.dev)
    K1, K2, K3 = ctx.K1, ctx.K2, ctx.K3
    tms, coef = tms or terms, ca if coef is None else coef
    Hc, Bc = c["us"].shape
    ds = c["xs"].shape[1]
    act = ~c["converged"] & ~c["failed"]
    k2_kw = dict(carry=(act, c["Ks"], c["ks"]))
    k2_args = (c["jac"], c["xs"], c["us"], *cost, dt, len(cost[3]))
    plain = plain or {}
    bk = K2.backward_quad_ll(*k2_args, **k2_kw)
    bp, bp_ms = plain_once(lambda: K2.backward_quad_ll_plain(*k2_args, **k2_kw), plain)
    print(f"[3] K2 backward, {tag}: rel err K/k/lin/quad "
          f"{[f'{rel_err(a, b):.3e}' for a, b in zip(bk, bp)]} (tol {TOL_K2})",
          flush=True)
    KsT, ksT, lin, quad = bk
    ks_small = torch.sqrt((ksT * ksT).sum(0)) < 1e-3
    lo, hi = ctx.lo, ctx.hi
    ls_common = (tms, c["x0s"], c["xs"], c["us"], KsT, ksT, coef, alphas, lo, hi,
                 *cost, dt)
    k3_args = ls_common + (c["obj"], lin, quad, ks_small, act, c["jac"])
    lk = K3.fused_line_search(*k3_args)
    lp, lp_ms = plain_once(lambda: K3.fused_line_search_plain(*k3_args), plain)
    objs = K3.line_search_objectives(*ls_common)

    def choice(obj_out):
        return (objs - obj_out[None]).abs().argmin(0)

    def pick(idx):
        return objs.gather(0, idx[None])[0]

    # Decisions against the twin, on the active lanes (see K3_TIE).
    def lane_finite(out):
        return torch.stack([torch.isfinite(t.float()).reshape(-1, Bc).all(0)
                            for t in out]).all(0)

    kernel_only = int((~lane_finite(lk) & lane_finite(lp)).sum())
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

    z = [lk[0][:-1, i].double() for i in range(ds)] + [lk[1].double()]
    theta = torch.stack([term_value(t, z) for t in tms], dim=-1)        # (H, B, F)
    c64 = coef.double()
    if c64.ndim == 3:      # lane b through lane b's model
        x64 = torch.einsum("hbf,ifb->hbi", theta, c64)
        mag = torch.einsum("hbf,ifb->hbi", theta.abs(), c64.abs())
    else:
        x64 = theta @ c64.T
        mag = theta.abs() @ c64.abs().T
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
        tms, lk[0][:, :, jl].double(), lk[1][:, jl].double(),
        c64[:, :, jl].contiguous() if c64.ndim == 3 else c64
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
          f"returned bit for bit: {held}; lanes with an output not finite only in the "
          f"kernel {kernel_only}; decisions agree with the twin on "
          f"{err['frac']:.5f} of the active lanes (min {agree_min}; flags differ on "
          f"{int((act & ~same_flags).sum())}, of which stalled {int((act & ~same_flags & stalled).sum())}; "
          f"step size differs on {int((moved & same_flags & ~same_choice).sum())}); vs twin on "
          f"the {int(lanes.sum())} lanes of equal decisions "
          f"{({k: f'{rel_err(a, b):.3e}' for k, (a, b) in twin.items()})} (obj gated at {TOL_K3}; "
          f"xs {xs_gate}); vs float64 at the kernel's states on the "
          f"{int(own.sum())} lanes it moved: u {err['u']:.3e}, next x {err['x']:.3e} of term "
          f"magnitudes (tol {TOL_K3_SUM}), objective of the returned trajectory "
          f"{err['obj64']:.3e} (tol {TOL_K3}), jac {err['jac']:.3e} (tol {TOL_K1}), du2 "
          f"{err['du2']:.3e} (tol {TOL_K3})", flush=True)
    if err["k2"] > TOL_K2:
        failures.append(f"K2 ({tag}) rel err {err['k2']:.3e} > {TOL_K2}")
    if not held:
        failures.append(f"K3 ({tag}) changed an inactive lane")
    if kernel_only:
        failures.append(f"K3 ({tag}) an output not finite on {kernel_only} lanes where "
                        f"the twin's is finite")
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
        bk=bk, bp=bp, lk=lk, twin=twin, k3_args=k3_args, act=act, terms=tms,
        k2_plain_ms=bp_ms, k3_plain_ms=lp_ms,
        k2=lambda: K2.backward_quad_ll(*k2_args, **k2_kw),
        k2_plain=lambda: K2.backward_quad_ll_plain(*k2_args, **k2_kw),
        k3=lambda: K3.fused_line_search(*k3_args),
        k3_plain=lambda: K3.fused_line_search_plain(*k3_args),
    )

def k2_k3_rows_ll(ctx, res, c, form, n_launches, plain=None, **extra):
    """The two report rows of one ``check_k2_k3`` result on carry
    ``c``; ``extra[kernel]`` adds keys to that kernel's row;
    ``plain``: ``time_ms``'s arguments for the plain versions (5
    runs by default)."""
    plain = plain or dict(reps=5)
    Hc, Bc = c["us"].shape
    ds = c["xs"].shape[1]
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
            ms=time_ms(res["k2"]), plain_ms=res["k2_plain_ms"] if res["k2_plain_ms"]
            is not None else time_ms(res["k2_plain"], **plain),
            **extra.get("backward_quad_ll", {}),
            **bound_keys(n_bytes(c["jac"], c["xs"], c["us"], res["act"], c["Ks"],
                                 c["ks"], *c["cost"].values(), *bk),
                         Bc * Hc * (riccati_flops(ds, 1) + 16)),
        ),
        dict(
            name=f"fused_line_search[B={Bc},H={Hc},{form}]", route="cuda",
            source="autompc_torch/csrc/linesearch_fused.cu",
            replaces="autompc_tpu/ops/pallas_linesearch.py:803",
            launches=n_launches["fused_line_search"],
            max_abs_err=max(abs_err(a, b) for a, b in res["twin"].values()),
            ms=time_ms(res["k3"]), plain_ms=res["k3_plain_ms"] if res["k3_plain_ms"]
            is not None else time_ms(res["k3_plain"], **plain),
            **extra.get("fused_line_search", {}),
            **k3_bound(n_bytes(*tensors, *lk), Bc, Hc, res["terms"], len(ctx.alphas), ds),
        ),
    ]


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


# ---- Phase 13: the GaussReg / SumCost costs -------------------------------------


def gauss_reg_candidates(dev, n, seed=0, joint=False):
    """Phase 8's (``joint``: phase 12's) candidate batch and each lane's
    GaussReg weight regw = 10**U(-3, 4), the GaussRegFactory range."""
    batch = joint_candidates(dev, n, seed) if joint else fanout_candidates(dev, n, seed)
    regw = 10 ** np.random.default_rng(seed + GR_SEED).uniform(-3, 4, n)
    return dict(batch, regw=batch["Qdiag"].new_tensor(regw))


def reg_lane_objective(xs, us, cp, dt, S, mu):
    """The per-lane objective with the GaussReg term, float64:
    ``lane_objective`` + dt regw sum_t (x_t - mu)' S (x_t - mu)."""
    H = us.shape[1]
    d = xs[:, :H].double() - xs.new_tensor(mu).double()
    reg = ((d @ xs.new_tensor(S).double()) * d).sum(dim=(1, 2))
    return lane_objective(xs, us, cp, dt) + dt * cp["regw"].double() * reg


def gauss_reg_counters(K1, K3, K4):
    """The wrappers each phase-13 configuration launches: (a1)/(b1) the
    fused batch-major body, (a2)/(b2) the tuner's."""
    fused = (K1.relin_jacobians_bm, K4.riccati_general, K3.fused_line_search_bm)
    plain = (K1.relin_jacobians_bm, K4.riccati_general, K3.sindy_line_search)
    return {"1": fused, "2": plain}


def gauss_reg_launches(wrappers, lane=False):
    """(launches, by B) of each wrapper; with ``lane`` the per-lane
    instances' where the wrapper has them (K4 takes no coefficients)."""
    if lane:
        return lane_launches(wrappers)
    return ({w.__name__: w.launches for w in wrappers},
            {w.__name__: dict(w.launches_by_B) for w in wrappers})


def reset_gauss_reg(wrappers):
    reset_launches(wrappers)
    for w in wrappers:
        if hasattr(w, "launches_reg"):
            w.launches_reg = 0


def first_step_agreement(tag, solves, x0, ug, cp, dt, S, mu, params, label="[13]",
                         min_both=None):
    """The first MPC step's solves of the two configurations ``solves``
    (config -> solve) on the same candidates: accepted objectives (with
    the GaussReg term) within FAN_OBJ_TOL on FAN_AGREE_MIN of the lanes
    converged in both (at least ``min_both`` of them; None: a quarter of
    the batch), as phase 8's."""
    res = {cfg: solve(params, x0, ug, cp) for cfg, solve in solves.items()}
    (ka, ra), (kb, rb) = res.items()
    obj = {cfg: reg_lane_objective(o[1], o[2], cp, dt, S, mu) for cfg, o in res.items()}
    both = ra[0] & rb[0]
    rel = ((obj[ka] - obj[kb]).abs() / obj[kb].abs().clamp_min(1e-30))[both]
    share = float((rel <= FAN_OBJ_TOL).float().mean()) if both.any() else 0.0
    B = x0.shape[0]
    min_both = B // 4 if min_both is None else min_both
    print(f"{label} {tag} first MPC step, ({ka}) vs ({kb}): converged ({ka}) {int(ra[0].sum())}, "
          f"({kb}) {int(rb[0].sum())}, both {int(both.sum())} of {B}; accepted objective "
          f"relative difference on those: median {float(rel.median()):.3e}, 90% "
          f"{float(rel.quantile(0.9)):.3e}, max {float(rel.max()):.3e}; within {FAN_OBJ_TOL} "
          f"on {share:.4f} (min {FAN_AGREE_MIN})", flush=True)
    if int(both.sum()) < min_both or share < FAN_AGREE_MIN:
        raise RuntimeError(f"{tag} first step: {int(both.sum())} lanes converged in both, "
                           f"objectives agree on {share:.4f}")


def gauss_reg_phase(bench, model, trajs, dev, card, wrappers):
    """Phase 13 (a) and (b). Returns {"S", "mu", "fans": {config: the
    fan-out}, "batch", "joint_batch", "counts": {config: (launches, by
    B)}}: configurations a1, a2 (the fixed-model cost fan-out) and b1,
    b2 (the joint-SINDy fan-out)."""
    from autompc_torch.control import make_scheduled_ilqr_solver, parse_schedule
    from autompc_torch.parallel import JointSINDyQuadCostFanout, QuadCostFanout
    from autompc_torch.tuning.pipeline_tuner import _gauss_reg_stats

    S, mu = _gauss_reg_stats(trajs)
    reg = dict(reg_matrix=S, reg_goal=mu)
    out = {"S": S, "mu": mu, "fans": {}, "counts": {}}
    batch = gauss_reg_candidates(dev, FAN_B)
    jbatch = gauss_reg_candidates(dev, JS_B, joint=True)
    out["batch"], out["joint_batch"] = batch, jbatch
    spec = (model.library, "coeffs")
    runs = []
    for i in ("1", "2"):
        runs.append((f"a{i}", lambda i=i: QuadCostFanout(
            bench.system, bench.task, model, model, horizon=FAN_H, n_steps=FAN_STEPS,
            goal=np.zeros(4), compact_schedule=FAN_SCHEDULE, feature_spec=spec,
            **GR_CONFIGS[i], **reg), batch, FAN_B, FAN_STEPS, FAN_CALLS))
    for i in ("1", "2"):
        runs.append((f"b{i}", lambda i=i: JointSINDyQuadCostFanout(
            bench.system, bench.task, JS_BUCKET, trajs, model, horizon=JS_H,
            n_steps=GR_JS_STEPS, goal=np.zeros(4), compact_schedule=JS_SCHEDULE,
            use_feature_kernels=True, **GR_CONFIGS[i], **reg), jbatch, JS_B, GR_JS_STEPS, 1))
    for cfg, make, cand, B, steps, calls in runs:
        fan = make()
        out["fans"][cfg] = fan
        ws = wrappers[cfg[1]]
        reset_gauss_reg(ws)
        t0 = time.perf_counter()
        scores = fan(cand)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(calls):
            scores = fan(cand)
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts, by_B = gauss_reg_launches(ws, lane=cfg[0] == "b")
        if cfg[1] == "1":
            counts["fused_line_search_bm[reg]"] = ws[2].launches_reg
        out["counts"][cfg] = (counts, by_B)
        if tuple(scores.shape) != (B,) or torch.isnan(scores).any():
            raise RuntimeError(f"GaussReg fan-out ({cfg}): malformed or NaN scores")
        fin = torch.isfinite(scores)
        print(f"[13] GaussReg fan-out ({cfg}) {GR_CONFIGS[cfg[1]]}: "
              f"{'joint SINDy F=' + str(fan.n_features) if cfg[0] == 'b' else 'fixed model'}, "
              f"B={B} H={FAN_H} {steps} steps: warm call {warm_s:.2f} s; {calls} timed calls "
              f"{elapsed:.3f} s -> {calls * B / elapsed:.1f} evals/s on {card}; scores finite "
              f"{int(fin.sum())}, inf {int((~fin).sum())}, mean of finite "
              f"{float(scores[fin].mean()):.2f}; launches in {calls + 1} calls {counts}, by B "
              f"{by_B}", flush=True)
        if min(counts.values()) == 0:
            raise RuntimeError(f"a kernel never ran on the GaussReg fan-out ({cfg}): {counts}")

    dt = bench.system.dt
    sched = parse_schedule(FAN_SCHEDULE)
    x0 = batch["Qdiag"].new_tensor(np.tile(bench.task.get_init_obs(), (FAN_B, 1)))
    first_step_agreement(
        "fixed model", {c: make_scheduled_ilqr_solver(model.pred_core, None, schedule=sched,
                                                      **out["fans"][c].solver_kw)
                        for c in ("a1", "a2")},
        x0, x0.new_zeros((FAN_B, FAN_H, 1)), batch, dt, S, mu, model.params)
    coeffs = out["fans"]["b1"].train_lanes(jbatch["reg"])
    cpj = {k: jbatch[k] for k in ("Qdiag", "Rdiag", "Fdiag", "regw")}
    xj = jbatch["Qdiag"].new_tensor(np.tile(bench.task.get_init_obs(), (JS_B, 1)))
    first_step_agreement(
        "joint SINDy", {c: make_scheduled_ilqr_solver(out["fans"][c]._pred_core, None,
                                                      schedule=parse_schedule(JS_SCHEDULE),
                                                      **out["fans"][c].solver_kw)
                        for c in ("b1", "b2")},
        xj, xj.new_zeros((JS_B, JS_H, 1)), cpj, dt, S, mu, {"coeffs": coeffs})
    return out


def gauss_reg_tune(bench, model, trajs, dev, card, wrappers):
    """Phase 13 (c): PipelineTuner.run over QuadCostFactory +
    GaussRegFactory with the fan-out path, then the incumbent on the
    true dynamics and the sequential objective against the fan-out.
    Returns (launches, by B) of the tune's kernels."""
    from autompc_torch.control import IterativeLQRFactory
    from autompc_torch.costs import GaussRegFactory, QuadCost, QuadCostFactory
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.sysid import FunctionModel
    from autompc_torch.tuning import PipelineTuner
    from autompc_torch.utils import simulate

    system, task = bench.system, bench.task.copy()
    task.set_num_steps(GR_TUNE_STEPS)
    goal = np.zeros(4)
    calls = []
    tuner = PipelineTuner(
        surrogate_mode="pretrain", eval_batch=GR_TUNE_BATCH, use_fanout=True,
        fanout_backward="pallas", fanout_feature_kernels=True, fanout_compact=TUNE_COMPACT)
    real_eval = tuner._eval_batch_fanout

    def timed_eval(pipeline, task_, surrogate, cfgs, fanouts, kind, sysid_trajs=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_eval(pipeline, task_, surrogate, cfgs, fanouts, kind, sysid_trajs)
        calls.append((isinstance(surrogate, FunctionModel), len(cfgs),
                      time.perf_counter() - t0))
        return res

    tuner._eval_batch_fanout = timed_eval

    def pipeline(**kw):
        return Pipeline(system, model, QuadCostFactory(system, goal=goal) + GaussRegFactory(system),
                        IterativeLQRFactory(system, **kw))

    reset_gauss_reg(wrappers)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)    # a fallback warning fails the phase
        controller, res = tuner.run(pipeline(horizon=TUNE_H), task, trajs,
                                    n_iters=GR_TUNE_ITERS, rng=np.random.default_rng(101),
                                    surrogate=model, truedyn=bench.dynamics)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    counts, by_B = gauss_reg_launches(wrappers)
    costs, true_costs = np.array(res.costs), np.array(res.truedyn_costs)
    surr = [c for c in calls if not c[0]]
    true = [c for c in calls if c[0]]
    end = 0
    for r, ((_, n, s_s), (_, _, t_s)) in enumerate(zip(surr, true)):
        end += n
        print(f"[13] tune round {r + 1} ({n} candidates, H={TUNE_H}, "
              f"{task.get_num_steps() - 1} MPC steps): surrogate fan-out {s_s:.2f} s, "
              f"true-dynamics fan-out {t_s:.2f} s -> {n / s_s:.1f} evals/s on the surrogate, "
              f"{n / (s_s + t_s):.1f} with both on {card}; incumbent surrogate cost "
              f"{res.inc_costs[end - 1]:.1f}, its true-dynamics cost "
              f"{res.inc_truedyn_costs[end - 1]:.1f}", flush=True)
    print(f"[13] tune {GR_TUNE_ITERS} candidates: {tune_s:.2f} s; scores finite "
          f"{int(np.isfinite(costs).sum())} / {costs.size} on the surrogate, "
          f"{int(np.isfinite(true_costs).sum())} / {true_costs.size} on the true dynamics; "
          f"launches {counts}, by B {by_B}", flush=True)
    if len(costs) != GR_TUNE_ITERS or len(true_costs) != GR_TUNE_ITERS \
            or np.isnan(costs).any() or np.isnan(true_costs).any():
        raise RuntimeError("GaussReg tune: a score is missing or NaN")
    if min(counts.values()) == 0:
        raise RuntimeError(f"a kernel never ran in the GaussReg tune: {counts}")

    t0 = time.perf_counter()
    traj = simulate(controller, task.get_init_obs(), term_cond=task.term_cond,
                    dynamics=bench.dynamics, max_steps=task.get_num_steps())
    final_cost = float(task.get_cost()(traj))
    print(f"[13] incumbent {res.inc_cfg.get_dictionary()}: simulate {len(traj) - 1} steps on "
          f"the true dynamics in {time.perf_counter() - t0:.2f} s; task cost {final_cost:.1f} "
          f"(its fan-out scores: surrogate {res.inc_costs[-1]:.1f}, true dynamics "
          f"{res.inc_truedyn_costs[-1]:.1f})", flush=True)
    if not np.isfinite(final_cost):
        raise RuntimeError(f"GaussReg tune: the incumbent's true-dynamics cost is {final_cost}")

    # Sequential (the explicit SumCost through the generic cost-hessian
    # path) against the fan-out, horizons unpinned, on a quadratic task
    # cost, as phase 10's.
    seq_task = task.copy()
    seq_task.set_cost(QuadCost(system, Q=np.eye(4), R=0.01 * np.eye(1), F=np.eye(4), goal=goal))
    seq_task.set_init_obs(np.array([0.5, 0.0, 0.0, 0.0]))
    seq_task.set_num_steps(GR_SEQ_STEPS)
    t0 = time.perf_counter()
    scores = [
        PipelineTuner(surrogate_mode="pretrain", eval_batch=SEQ_ITERS, **kw).run(
            pipeline(), seq_task, trajs, n_iters=SEQ_ITERS, rng=np.random.default_rng(3),
            surrogate=model)[1]
        for kw in ({}, dict(use_fanout=True, fanout_backward="pallas",
                            fanout_feature_kernels=True))
    ]
    agree = 0
    for i, (cfg, a, b) in enumerate(zip(scores[0].cfgs, scores[0].costs, scores[1].costs)):
        ok = (a == b) or (np.isfinite(a) and np.isfinite(b)
                          and abs(a - b) <= SEQ_TOL * max(abs(b), 1e-30))
        agree += ok
        print(f"[13] candidate {i} (horizon {cfg['_ctrlr:horizon']}, reg_weight "
              f"{cfg['_cost:_sum_1:reg_weight']:.4g}): sequential {a!r}, fan-out {b!r}, "
              f"relative difference {abs(a - b) / max(abs(b), 1e-30):.3e}"
              f"{'' if ok else ' DIFFER'}", flush=True)
    same_cfgs = [c.get_dictionary() for c in scores[0].cfgs] == \
        [c.get_dictionary() for c in scores[1].cfgs]
    print(f"[13] sequential vs fan-out ({GR_SEQ_STEPS}-step near-upright task, quadratic task "
          f"cost): {agree} of {SEQ_ITERS} agree within {SEQ_TOL} (min {SEQ_AGREE_MIN}); same "
          f"configurations {same_cfgs}; {time.perf_counter() - t0:.2f} s", flush=True)
    if agree < SEQ_AGREE_MIN or not same_cfgs:
        raise RuntimeError(f"GaussReg tune: sequential and fan-out agree on {agree} of "
                           f"{SEQ_ITERS}")
    return counts, by_B


def gauss_reg_carry(pred_core, fan, batch, params, H, init_obs, n_iters=3):
    """The carry of ``fan``'s solver ``n_iters`` iterations into the
    first MPC step, from ``init_obs``, the candidates' costs (and GaussReg
    weights, where the batch has them)."""
    from autompc_torch.control import make_batched_ilqr_solver

    _, carry0, _, make_body = make_batched_ilqr_solver(pred_core, None, return_pieces=True,
                                                       **fan.solver_kw)
    n = batch["Qdiag"].shape[0]
    cp = {k: batch[k] for k in ("Qdiag", "Rdiag", "Fdiag", "regw") if k in batch}
    x0 = batch["Qdiag"].new_tensor(np.tile(init_obs, (n, 1)))
    carry, body = carry0(params, x0, x0.new_zeros((n, H, 1)), cp), make_body(params)
    for _ in range(n_iters):
        carry = body(carry)
    return carry


def sub_carry(c, n):
    """The first ``n`` lanes of a batch-major carry (its costs and
    per-lane params too)."""
    def cut(v):
        if isinstance(v, dict):
            return {k: cut(x) for k, x in v.items()}
        return v[:n].contiguous() if isinstance(v, torch.Tensor) and v.ndim else v

    return {k: cut(v) for k, v in c.items()}


def gauss_reg_expansions(c, S, mu, dt):
    """The dense expansions of the batch-major body under per-lane
    diagonals and the GaussReg term (obsdim = ds = 4, goal 0), as the
    solver hands them to K4."""
    cp, xs, us = c["cost"], c["xs"], c["us"]
    B, H = us.shape[:2]
    St, mut = xs.new_tensor(S), xs.new_tensor(mu)
    w2 = 2.0 * dt * cp["regw"]
    eye = torch.eye(4, dtype=xs.dtype, device=xs.device)
    Cxx = (2.0 * cp["Qdiag"] * dt)[:, None, :, None] * eye + w2[:, None, None, None] * St
    Cxx = Cxx.expand(B, H, 4, 4).contiguous()
    cx = 2.0 * xs[:, :H] * cp["Qdiag"][:, None, :] * dt + w2[:, None, None] * (
        (xs[:, :H] - mut) @ St)
    Cuu = (2.0 * cp["Rdiag"] * dt)[:, None, :, None].expand(B, H, 1, 1).contiguous()
    cu = (2.0 * us * cp["Rdiag"][:, None, :] * dt).contiguous()
    Vn = (2.0 * cp["Fdiag"])[:, :, None] * eye
    vn = 2.0 * cp["Fdiag"] * xs[:, H]
    return Cxx, Cuu, cx.contiguous(), cu, Vn.contiguous(), vn.contiguous()


def k3_bm_bound(io_bytes, B, H, terms, L, reg):
    """K3's bound keys (``k3_bound``) with the GaussReg term's operations
    a candidate-step (10 products of three factors and their sum, 4
    differences, the weight's product and add at obsdim 4)."""
    out = k3_bound(io_bytes, B, H, terms, L)
    if reg:
        out.update(bound_keys(io_bytes, out["bound_ops_ms"] * F32_FLOPS / 1e3
                              + B * H * L * 36), scratch_bytes_ms=out["scratch_bytes_ms"])
    return out


def check_k3_bm(tag, K1, K3, K4, terms, coeffs, c, S, mu, dt, alphas, bound, plain=None,
                device_time=None):
    """K3's batch-major entry, with and without the GaussReg term, against
    its plain twin on the batch-major carry ``c`` (after the solver's
    backward pass on it): decisions (flags, and the step size as the
    objective it returns) on K3_FAN_AGREE_MIN of the active lanes (a
    compaction stage's first lanes are the full batch's, and at B=128
    three iterations in ~20 are active, too few for the share to leave
    room for one lane: there one lane may differ, the knife edge of
    ROADMAP §C1 that the full batch's check counts too), the
    states of the lanes of equal decisions within TOL_K3 on
    K3_FAN_WITHIN_MIN of them, the objective normwise to TOL_K3; against
    float64 at the kernel's own trajectory: the objective under the
    lane's cost and term (TOL_K3), du2 (TOL_K3) and the Jacobians
    (TOL_K1); no output not finite where the twin's is; and a zero weight
    gives the instance without the term bit for bit. ``plain``:
    ``time_ms``'s arguments for the plain twin (None: 3 runs, and the
    kernel's device time is taken too, as with ``device_time``). Returns ({"reg":
    measurements, "no_reg": measurements}, failure strings)."""
    from autompc_torch.ops.cuda_linesearch import _sweep

    failures = []
    cp = c["cost"]
    B, H = c["us"].shape[:2]
    act = ~c["converged"] & ~c["failed"]
    Ks, ks, lin, quad = K4.riccati_general(c["Jx"], c["Ju"], *gauss_reg_expansions(c, S, mu, dt))
    ks_small = torch.sqrt((ks * ks).sum(dim=(1, 2))) < 1e-3
    planes = tuple(cp[k].T.contiguous() for k in ("Qdiag", "Rdiag", "Fdiag"))
    base = (terms, c["x0s"], c["xs"], c["us"], Ks, ks, coeffs, alphas, -bound, bound, *planes,
            (0.0,) * 4, dt, c["obj"], lin, quad, ks_small)
    out = {}
    for form, reg in (("reg", (S, mu, cp["regw"])), ("no_reg", None)):
        kk = K3.fused_line_search_bm(*base, reg=reg)
        kp = K3.fused_line_search_bm_plain(*base, reg=reg)
        x0T, xsT, usT, KsT, ksT = (c["x0s"].T, c["xs"].permute(1, 2, 0), c["us"][:, :, 0].T,
                                   Ks[:, :, 0].permute(1, 2, 0), ks[:, :, 0].T)
        objs = _sweep(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, -bound, bound, *planes,
                      (0.0,) * 4, dt, True, keep=False, reg=reg)[0]

        def lane_finite(o):
            return torch.stack([torch.isfinite(t.float()).reshape(B, -1).all(1) for t in o]).all(0)

        kernel_only = int((~lane_finite(kk) & lane_finite(kp)).sum())
        choice = lambda o: (objs - o[None]).abs().argmin(0)
        pick = lambda i: objs.gather(0, i[None])[0]
        ck, cq = choice(kk[2]), choice(kp[2])
        same_choice = (ck == cq) | ((pick(ck) - pick(cq)).abs() <= K3_TIE * pick(cq).abs())
        same_flags = (kk[3] == kp[3]) & (kk[4] == kp[4])
        stalled = ((kk[2] - c["obj"]).abs() <= K3_TIE * c["obj"].abs()) \
            & ((kp[2] - c["obj"]).abs() <= K3_TIE * c["obj"].abs())
        agree_lane = stalled | (same_flags & same_choice)
        agree = agree_lane[act].float().mean().item() if act.any() else 1.0
        n_differ = int((act & ~agree_lane).sum())
        lanes = same_flags & (ck == cq)
        dx = (kk[0][lanes].double() - kp[0][lanes].double()).abs().amax(dim=(1, 2))
        within = (dx <= TOL_K3 * kp[0][lanes].double().abs().amax(dim=(1, 2)).clamp_min(1e-30))
        within = within.float().mean().item() if lanes.any() else 1.0
        e_obj = rel_err(kk[2][lanes], kp[2][lanes]) if lanes.any() else 0.0
        fin = lane_finite(kk)
        obj64 = reg_lane_objective(kk[0], kk[1], cp, dt, S, mu) if reg is not None else \
            lane_objective(kk[0], kk[1], cp, dt)
        e_obj64 = float(((kk[2].double() - obj64).abs() / obj64.abs().clamp_min(1e-30))[fin].max())
        du2_64 = ((kk[1].double() - c["us"].double()) ** 2).sum(dim=(1, 2))
        e_du2 = rel_err(kk[7][fin], du2_64[fin])
        c64 = coeffs.double()
        j64 = K1.relin_jacobians_bm_plain(terms, kk[0][fin].double(), kk[1][fin].double(),
                                          c64[:, :, fin].contiguous() if c64.ndim == 3 else c64)
        e_jac = max(rel_err(kk[5][fin], j64[0]), rel_err(kk[6][fin], j64[1]))
        print(f"[3] K3 batch-major {form}, {tag} B={B} H={H}: active lanes {int(act.sum())}; "
              f"not finite only in the kernel {kernel_only}; decisions agree with the twin on "
              f"{agree:.5f} of the active lanes ({n_differ} differ; min {K3_FAN_AGREE_MIN}, or "
              f"one lane where the share leaves room for none); on the "
              f"{int(lanes.sum())} lanes of equal decisions: states within {TOL_K3} on "
              f"{within:.4f} (min {K3_FAN_WITHIN_MIN}), objective {e_obj:.3e}; vs float64 at "
              f"the kernel's trajectories: objective {e_obj64:.3e}, du2 {e_du2:.3e} (tol "
              f"{TOL_K3}), Jacobians {e_jac:.3e} (tol {TOL_K1})", flush=True)
        if kernel_only or n_differ > max(1, int((1 - K3_FAN_AGREE_MIN) * int(act.sum()))) \
                or within < K3_FAN_WITHIN_MIN \
                or e_obj > TOL_K3 or max(e_obj64, e_du2) > TOL_K3 or e_jac > TOL_K1:
            failures.append(f"K3 batch-major {form} ({tag}): kernel-only non-finite "
                            f"{kernel_only}, agree {agree:.5f}, within {within:.4f}, obj "
                            f"{e_obj:.3e}, obj64 {e_obj64:.3e}, du2 {e_du2:.3e}, jac {e_jac:.3e}")
        call = lambda reg=reg: K3.fused_line_search_bm(*base, reg=reg)
        timed = dict(ms=time_ms(call))
        if plain is None or device_time:    # the top batch: the kernel's own time too
            timed["device_ms"] = device_ms(call)
        tensors = [t for t in base if isinstance(t, torch.Tensor)]
        if reg is not None:
            tensors.append(cp["regw"])
        out[form] = dict(
            max_abs_err=abs_err(kk[0][lanes], kp[0][lanes]) if lanes.any() else 0.0, **timed,
            plain_ms=time_ms(lambda reg=reg: K3.fused_line_search_bm_plain(*base, reg=reg),
                             **(plain or dict(reps=3))),
            **k3_bm_bound(n_bytes(*tensors, *kk), B, H, terms, len(alphas),
                          reg is not None))
        if reg is not None:
            zero = K3.fused_line_search_bm(*base, reg=(S, mu, torch.zeros_like(cp["regw"])))
            none = K3.fused_line_search_bm(*base)
            same = all(bits_equal(a, b) for a, b in zip(zero, none))
            print(f"[3] K3 batch-major with the GaussReg term, {tag} B={B}: a zero weight "
                  f"gives the instance without the term bit for bit: {same}", flush=True)
            if not same:
                failures.append(f"K3 batch-major ({tag}): a zero weight differs from no term")
    return out, failures


def check_bm_identity(tag, K3, terms, coeffs, c, cost, dt, alphas, bound):
    """K3's batch-major entry given the transposes of the lanes-last
    carry ``c`` (every lane active) against the lanes-last instance: the
    same flags and du2 on every lane, the same trajectory and objective
    where the lane did not fail, the same Jacobians where it also
    succeeded, bit for bit. Returns failure strings."""
    from autompc_torch.ops import cuda_riccati as K2

    Hc, Bc = c["us"].shape
    act = torch.ones(Bc, dtype=torch.bool, device=c["us"].device)
    KsT, ksT, lin, quad = K2.backward_quad_ll(c["jac"], c["xs"], c["us"], *cost, dt, 4,
                                              carry=(act, c["Ks"], c["ks"]))
    ks_small = torch.sqrt((ksT * ksT).sum(0)) < 1e-3
    lo, hi = -bound, bound
    ll = K3.fused_line_search(terms, c["x0s"], c["xs"], c["us"], KsT, ksT, coeffs, alphas, lo,
                              hi, *cost, dt, c["obj"], lin, quad, ks_small, act, c["jac"])
    bm = K3.fused_line_search_bm(
        terms, c["x0s"].T.contiguous(), c["xs"].permute(2, 0, 1).contiguous(),
        c["us"].T[:, :, None].contiguous(), KsT.permute(2, 0, 1)[:, :, None, :].contiguous(),
        ksT.T[:, :, None].contiguous(), coeffs, alphas, lo, hi, *cost, dt, c["obj"], lin, quad,
        ks_small)
    moved, jl = ~ll[4], ~ll[4] & ll[3]
    jac = ll[5].reshape(Hc, 4, 5, Bc).permute(3, 0, 1, 2)
    same = {
        "flags": bits_equal(bm[3], ll[3]) and bits_equal(bm[4], ll[4]),
        "du2": bits_equal(bm[7], ll[6]),
        "xs": bits_equal(bm[0][moved], ll[0].permute(2, 0, 1)[moved]),
        "us": bits_equal(bm[1][moved], ll[1].T[:, :, None][moved]),
        "obj": bits_equal(bm[2][moved], ll[2][moved]),
        "Jx": bits_equal(bm[5][jl], jac[jl][..., :4].contiguous()),
        "Ju": bits_equal(bm[6][jl], jac[jl][..., 4:].contiguous()),
    }
    print(f"[3] K3 batch-major entry on the transposed lanes-last carry, {tag} B={Bc} H={Hc}: "
          f"bit for bit the lanes-last instance ({int(moved.sum())} lanes that did not fail, "
          f"{int(jl.sum())} that also succeeded): {same}", flush=True)
    return [] if all(same.values()) else [f"K3 batch-major vs lanes-last ({tag}): {same}"]


def check_gauss_reg_kernels(gr, model, bench, dev, K1, K3, K4, alphas):
    """Phase 3's checks on phase 13's paths: K3's batch-major entry with
    and without the GaussReg term on (a1)'s carry (shared coefficients)
    and (b1)'s (per-lane coefficients, the 55-term library) three
    iterations in, at every batch size (a1) and (b1) launched it with,
    and K4 at (4, 1) on (a1)'s dense expansions. Returns (the K3 report
    rows, K4's measurement, failure strings)."""
    from autompc_torch.ops import _build

    dt, bound = bench.system.dt, float(bench.task.get_ctrl_bounds()[0, 1])
    S, mu, init = gr["S"], gr["mu"], bench.task.get_init_obs()
    fa, fb = gr["fans"]["a1"], gr["fans"]["b1"]
    mask = fa.solver_kw.get("feature_mask") or tuple(range(model.library.n_features))
    ca = gauss_reg_carry(model.pred_core, fa, gr["batch"], model.params, FAN_H, init)
    lanes = fb.train_lanes(gr["joint_batch"]["reg"])
    cb = gauss_reg_carry(fb._pred_core, fb, gr["joint_batch"], {"coeffs": lanes}, JS_H, init)
    rows, failures = [], []
    for cfg, c, terms, coef, name, lane in (
        ("a1", ca, tuple(model.library.terms[k] for k in mask),
         lambda sub: model.coeffs[:, list(mask)].contiguous(), "fused_line_search_bm[", 0),
        ("b1", cb, tuple(fb.library.terms),
         lambda sub: sub["params"]["coeffs"].permute(1, 2, 0).contiguous(),
         f"fused_line_search_bm_lane[F={fb.n_features},", 1),
    ):
        counts, by_B = gr["counts"][cfg]
        Bs_list = sorted(by_B["fused_line_search_bm"], reverse=True)
        meas = {}
        for Bs in Bs_list:
            sub = sub_carry(c, Bs)
            # The plain twins (0.05-0.4 s a call) timed once below the
            # top batch.
            meas[Bs], fails = check_k3_bm(
                f"GaussReg fan-out ({cfg}) carry", K1, K3, K4, terms, coef(sub), sub, S, mu, dt,
                alphas, bound, plain=None if Bs == Bs_list[0] else dict(reps=1, warm=0))
            failures += fails
        g = K3.fused_geometry(Bs_list[0], len(alphas), _build.sm_count(dev))
        regs = {form: _build.occupancy("ampc_fused_line_search_bm_occupancy", lane, reg,
                                       g["threads"], dev.index or 0)["registers"]
                for form, reg in (("reg", 1), ("no_reg", 0))}
        top = meas[Bs_list[0]]
        at = {f"at_B{Bs}_H{FAN_H}": dict(meas[Bs]["reg"], launches=by_B["fused_line_search_bm"][Bs])
              for Bs in Bs_list[1:]}
        for w in at.values():
            w.pop("library_ms")
        no_reg = dict(top["no_reg"], registers=regs["no_reg"])
        no_reg.pop("library_ms")
        rows.append(dict(
            name=f"{name}reg,B={Bs_list[0]},H={FAN_H},per-lane cost]", route="cuda",
            source="autompc_torch/csrc/linesearch_fused.cu",
            replaces="autompc_tpu/ops/pallas_linesearch.py:803",
            launches=counts["fused_line_search_bm"],
            launches_by_B=by_B["fused_line_search_bm"], registers=regs["reg"],
            **top["reg"], no_reg=no_reg, **at))
    k4_args = (ca["Jx"], ca["Ju"], *gauss_reg_expansions(ca, S, mu, dt))
    k4_row, fails, _, _ = check_k4(f"GaussReg fan-out (a1) carry (B={FAN_B}, H={FAN_H})", K4,
                                   k4_args, gr["counts"]["a1"][1]["riccati_general"].get(FAN_B, 0),
                                   device_time=True)
    failures += fails
    return rows, k4_row, failures


def step_latency(controller, obs, reps, dev):
    """bench_extra.py's step latency: seconds a ``Controller.run`` call to
    its result (one warm call, then ``reps`` timed, each on ``obs``), and
    the controls of every call (reps + 1, m)."""
    from autompc_torch.core.trajectory import zeros as traj_zeros

    cstate = controller.traj_to_state(traj_zeros(controller.system, 1, device=dev))
    u, cstate = controller.run(cstate, obs)
    torch.cuda.synchronize()
    us = [u]
    t0 = time.perf_counter()
    for _ in range(reps):
        u, cstate = controller.run(cstate, obs)
        torch.cuda.synchronize()
        us.append(u)
    return (time.perf_counter() - t0) / reps, torch.stack(us)


def controls_ok(us, bounds):
    """Every control finite and inside the task's bounds."""
    lo, hi = us.new_tensor(bounds[:, 0]), us.new_tensor(bounds[:, 1])
    return bool(torch.isfinite(us).all() and (us >= lo).all() and (us <= hi).all())


def timed_runs(fn, reps):
    """(seconds of the warm run, seconds a timed run, the last output):
    one warm run of ``fn()``, then ``reps`` timed, each to its result."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
        torch.cuda.synchronize()
    return warm, (time.perf_counter() - t0) / reps, out


def cpu64_sindy(system, model):
    """Phase 2's model as a float64 model on the CPU."""
    from autompc_torch.sysid import SINDy

    m64 = SINDy(system, device="cpu", **SINDY_KW)
    m64.set_parameters({"coeffs": model.coeffs.double().cpu().numpy()})
    return m64


def controllers_phase(bench, model, trajs, hc, hc_model, dev, card):
    """Phase 14 (a)-(c). Returns the printed rows as a dict."""
    import math

    from autompc_torch import default_dtype
    from autompc_torch.control import (
        MPPI,
        DirectTranscriptionController,
        make_receding_mppi_loop,
        make_receding_sqp_loop,
    )
    from autompc_torch.control import mppi as mppi_module
    from autompc_torch.core.trajectory import zeros as traj_zeros
    from autompc_torch.costs import QuadCost
    from autompc_torch.parallel import DirectTranscriptionFanout, MPPIFanout
    from autompc_torch.tuning.pipeline_tuner import _gauss_reg_stats

    system = bench.system
    qd = np.diag([10.0, 0.1, 0.01, 0.01])
    task = bench.task.copy()
    task.set_cost(QuadCost(system, qd, 0.001 * np.eye(1), qd, goal=np.zeros(4)))
    bounds = task.get_ctrl_bounds()
    umax = float(bounds[0, 1])
    obs = torch.as_tensor(task.get_init_obs(), dtype=default_dtype(dev), device=dev)
    m64 = cpu64_sindy(system, model)
    rows = {}

    # ---- (a) MPPI ----
    kw = dict(horizon=CT_H, num_path=CT_PATHS, sigma=CT_SIGMA, lmda=CT_LMDA)
    mppi = MPPI(system, task, model, **kw)
    lat, us = step_latency(mppi, obs, CT_STEP_REPS, dev)
    rows["mppi_control_step_latency_ms"] = lat * 1e3
    rows["mppi_sampled_rollouts_per_s"] = CT_PATHS / lat
    print(f"[14a] mppi_control_step_latency_ms {lat * 1e3:.3f} ({CT_PATHS} paths, H={CT_H}, "
          f"{CT_STEP_REPS} Controller.run calls after one warm) -> mppi_sampled_rollouts_per_s "
          f"{CT_PATHS / lat:.1f}; within dt {lat < system.dt}; on {card}", flush=True)
    if not controls_ok(us, bounds):
        raise RuntimeError(f"MPPI step: a control is not finite or outside its bounds: {us}")

    run = make_receding_mppi_loop(system, task, model, bench.dynamics, n_steps=CT_LOOP_STEPS,
                                  **kw)
    warm, per_run, (xs, us) = timed_runs(lambda: run(model.params, obs[None]), CT_LOOP_REPS)
    lat = per_run / CT_LOOP_STEPS
    rows["mppi_closed_loop_per_step_latency_ms"] = lat * 1e3
    rows["mppi_closed_loop_rollouts_per_s"] = CT_PATHS / lat
    print(f"[14a] receding MPPI loop, {CT_LOOP_STEPS} steps from the canonical start on the true "
          f"dynamics: warm run {warm:.2f} s, {CT_LOOP_REPS} timed runs -> per-step latency "
          f"{lat * 1e3:.3f} ms, {CT_PATHS / lat:.1f} rollouts/s; final state "
          f"{[round(float(v), 4) for v in xs[0, -1]]}", flush=True)
    if not (controls_ok(us, bounds) and torch.isfinite(xs).all()):
        raise RuntimeError("receding MPPI loop: a control or a state is not finite or bounded")

    # The first step on the card against the float64 CPU step, given the
    # card's draws.
    cs0 = mppi.traj_to_state(traj_zeros(system, 1, device=dev))
    x0 = model.update_state_core(model.params, cs0["model_state"], cs0["last_u"], obs)
    seq = torch.cat([cs0["act_sequence"][1:], cs0["act_sequence"][-1:]])
    eps = math.sqrt(CT_SIGMA) * mppi_module.standard_normal(
        (CT_H, CT_PATHS, 1), (mppi.seed, cs0["draws"]), obs)
    c_card, e_card = mppi._do_rollouts(model.params, x0, seq, None, eps=eps)
    u_card = mppi._update_sequence(seq, c_card, e_card)[0] * umax
    mppi64 = MPPI(system, task, m64, **kw)
    c_cpu, e_cpu = mppi64._do_rollouts(m64.params, x0.double().cpu(), seq.double().cpu(), None,
                                       eps=eps.double().cpu())
    u_cpu = mppi64._update_sequence(seq.double().cpu(), c_cpu, e_cpu)[0] * umax
    cost_rel = float(((c_card.double().cpu() - c_cpu).abs()
                      / c_cpu.abs().clamp_min(1e-30)).max())
    du0 = float((u_card.double().cpu() - u_cpu).abs().max())
    rows["mppi_first_step_cost_rel"], rows["mppi_first_step_du0"] = cost_rel, du0
    print(f"[14a] first step, card (float32) against CPU (float64) on the card's draws: per-path "
          f"costs within {cost_rel:.3e} (relative, max {CT_COST_TOL}); |du0| {du0:.3e} (max "
          f"{CT_DU0_TOL * umax:.3g} = {CT_DU0_TOL} umax)", flush=True)
    if not (cost_rel <= CT_COST_TOL and du0 <= CT_DU0_TOL * umax):
        raise RuntimeError(f"MPPI first step: costs {cost_rel:.3e}, |du0| {du0:.3e}")

    hc_obs = torch.as_tensor(hc.task.get_init_obs(), dtype=default_dtype(dev), device=dev)
    hc_mppi = MPPI(hc.system, hc.task, hc_model, horizon=CT_H, num_path=CT_PATHS,
                   sigma=HC_MPPI_SIGMA, lmda=HC_MPPI_LMDA)
    lat, us = step_latency(hc_mppi, hc_obs, CT_STEP_REPS, dev)
    rows["halfcheetah_mppi_control_step_latency_ms"] = lat * 1e3
    print(f"[14a] halfcheetah_mppi_control_step_latency_ms {lat * 1e3:.3f} (MLP 24-64-64-18, "
          f"ds=18, dc=6, {CT_PATHS} paths, H={CT_H}) -> {CT_PATHS / lat:.1f} rollouts/s; within "
          f"dt {lat < hc.system.dt}", flush=True)
    if not controls_ok(us, hc.task.get_ctrl_bounds()):
        raise RuntimeError("halfcheetah MPPI: a control is not finite or outside its bounds")

    # ---- (b) direct transcription ----
    dt_con = DirectTranscriptionController(system, task, model, horizon=DT_HORIZON_S)
    lat, us = step_latency(dt_con, obs, DT_STEP_REPS, dev)
    rows["dt_sqp_control_step_latency_ms"] = lat * 1e3
    print(f"[14b] dt_sqp_control_step_latency_ms {lat * 1e3:.3f} ({dt_con.horizon} knots, 10 SQP "
          f"iterations of 8 step sizes, {DT_STEP_REPS} Controller.run calls after one warm); "
          f"within dt {lat < system.dt}", flush=True)
    if not controls_ok(us, bounds):
        raise RuntimeError("DT step: a control is not finite or outside its bounds")
    run = make_receding_sqp_loop(model.pred_core, task.get_cost(), bench.dynamics,
                                 H=DT_LOOP_KNOTS, ds=4, dc=1, obsdim=4, dt=system.dt,
                                 n_steps=DT_LOOP_STEPS, ubounds=(bounds[:, 0], bounds[:, 1]))
    warm, per_run, (xs, us) = timed_runs(lambda: run(model.params, obs[None]), DT_LOOP_REPS)
    lat = per_run / DT_LOOP_STEPS
    rows["dt_sqp_closed_loop_per_step_latency_ms"] = lat * 1e3
    print(f"[14b] receding SQP loop, {DT_LOOP_KNOTS} knots, {DT_LOOP_STEPS} steps from the "
          f"canonical start: warm run {warm:.2f} s, {DT_LOOP_REPS} timed runs -> per-step "
          f"latency {lat * 1e3:.3f} ms; final state "
          f"{[round(float(v), 4) for v in xs[0, -1]]}", flush=True)
    if not (controls_ok(us, bounds) and torch.isfinite(xs).all()):
        raise RuntimeError("receding SQP loop: a control or a state is not finite or bounded")
    x0b = torch.cat([obs[None], draw_x0(np.random.default_rng(CF_SEED), DT_CHECK_B - 1, dev)])
    H_dt = dt_con.horizon
    _, us_c, st_c = dt_con._solve(model.params, x0b, x0b.new_zeros((DT_CHECK_B, H_dt + 1, 4)),
                                  x0b.new_zeros((DT_CHECK_B, H_dt, 1)), steps=True)
    dt64 = DirectTranscriptionController(system, task, m64, horizon=DT_HORIZON_S)
    x64 = x0b.double().cpu()
    _, us_p, st_p = dt64._solve(m64.params, x64, x64.new_zeros((DT_CHECK_B, H_dt + 1, 4)),
                                x64.new_zeros((DT_CHECK_B, H_dt, 1)), steps=True)
    same = (st_c.cpu() == st_p).all(1)
    err = (us_c.double().cpu() - us_p).abs().amax((1, 2))
    scale = us_p.abs().amax((1, 2)).clamp_min(1.0)
    bad = int((same & ~(err <= DT_US_TOL * scale)).sum())
    share = float(same.double().mean())
    rows["dt_same_steps_share"] = share
    print(f"[14b] first solve from {DT_CHECK_B} starts, card (float32) against CPU (float64): "
          f"the same step size at every iteration on {share:.4f} of the lanes (canonical start "
          f"{bool(same[0])}); their controls within {float((err / scale)[same].max()):.3e} "
          f"(relative to the lane's largest, at least 1; max {DT_US_TOL}), {bad} beyond",
          flush=True)
    if not same.any() or bad:
        raise RuntimeError(f"DT first solve: {bad} lanes of the same steps beyond {DT_US_TOL}, "
                           f"share {share}")

    # ---- (c) the fan-outs ----
    S, mu = _gauss_reg_stats(trajs)
    batch = fanout_candidates(dev, CF_B, CF_SEED)
    rng = np.random.default_rng(CF_SEED + 1)
    for k, v in (("sigma", rng.uniform(0.1, 2, CF_B)), ("lmda", rng.uniform(0.1, 2, CF_B)),
                 ("regw", 10 ** rng.uniform(-3, 4, CF_B))):
        batch[k] = batch["Qdiag"].new_tensor(v)
    for name, make in (
            ("MPPIFanout", lambda reg: MPPIFanout(
                system, bench.task, model, model, horizon=CF_H, num_path=CF_PATHS,
                n_steps=CF_STEPS, goal=np.zeros(4), **reg)),
            ("DirectTranscriptionFanout", lambda reg: DirectTranscriptionFanout(
                system, bench.task, model, model, horizon_knots=CF_KNOTS, n_steps=CF_DT_STEPS,
                goal=np.zeros(4), **reg))):
        for tag, reg in (("", {}), (" + GaussReg", dict(reg_matrix=S, reg_goal=mu))):
            fan = make(reg)
            warm, per_call, out = timed_runs(lambda: fan(batch), CF_CALLS)
            finite = int(torch.isfinite(out).sum())
            rows[f"{name}{tag}_evals_per_s"] = CF_B / per_call
            steps = CF_STEPS if name == "MPPIFanout" else CF_DT_STEPS
            print(f"[14c] {name}{tag}: B={CF_B}, {steps} steps ("
                  + (f"H={CF_H}, {CF_PATHS} paths" if name == "MPPIFanout" else
                     f"{CF_KNOTS} knots") + f"): warm call {warm:.2f} s, {CF_CALLS} timed calls "
                  f"{per_call:.3f} s each -> {CF_B / per_call:.1f} evals/s; finite scores "
                  f"{finite} / {CF_B}", flush=True)
            if torch.isnan(out).any() or out.shape != (CF_B,):
                raise RuntimeError(f"{name}{tag}: a score is NaN or the shape is wrong")
    return rows


def controller_tunes(bench, model, trajs, card):
    """Phase 14 (d): the tuner's kinds "mppi" and "dt"."""
    from autompc_torch.control import DirectTranscriptionControllerFactory, MPPIFactory
    from autompc_torch.costs import QuadCost, QuadCostFactory
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.tuning import PipelineTuner

    system, goal = bench.system, np.zeros(4)
    rows = {}
    for kind, cf, steps, seq_steps in (
            ("mppi", MPPIFactory(system, num_path=200, horizon=20), CT_TUNE_STEPS, CT_SEQ_STEPS),
            ("dt", DirectTranscriptionControllerFactory(system, horizon=0.5), CT_DT_TUNE_STEPS,
             CT_DT_SEQ_STEPS)):
        task = bench.task.copy()
        task.set_num_steps(steps)
        seq_task = bench.task.copy()
        seq_task.set_cost(QuadCost(system, Q=np.eye(4), R=0.01 * np.eye(1), F=np.eye(4),
                                   goal=goal))
        seq_task.set_init_obs(np.array([0.5, 0.0, 0.0, 0.0]))
        seq_task.set_num_steps(seq_steps)
        pipeline = Pipeline(system, model, QuadCostFactory(system, goal=goal), cf)
        tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=CT_TUNE_BATCH, use_fanout=True)
        if tuner._fanout_kind(pipeline, model)[0] != kind:
            raise RuntimeError(f"the tuner did not select the {kind!r} fan-out")
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)    # a fallback warning fails the phase
            _, res = tuner.run(pipeline, task, trajs, n_iters=CT_TUNE_BATCH,
                               rng=np.random.default_rng(100), surrogate=model,
                               truedyn=bench.dynamics)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
        costs, true_costs = np.array(res.costs), np.array(res.truedyn_costs)
        rows[f"tune_{kind}_evals_per_s"] = CT_TUNE_BATCH / tune_s
        print(f"[14d] tune {kind!r}: one BO round of {CT_TUNE_BATCH} candidates x "
              f"{steps - 1} steps, surrogate and true dynamics: {tune_s:.2f} s -> "
              f"{CT_TUNE_BATCH / tune_s:.1f} evals/s (both fan-outs) on {card}; finite "
              f"{int(np.isfinite(costs).sum())} / {costs.size} on the surrogate, "
              f"{int(np.isfinite(true_costs).sum())} / {true_costs.size} on the true dynamics; "
              f"NaN {bool(np.isnan(costs).any() or np.isnan(true_costs).any())}; incumbent "
              f"{res.inc_cfg.get_dictionary()}: surrogate {res.inc_costs[-1]:.1f}, true "
              f"dynamics {res.inc_truedyn_costs[-1]:.1f}", flush=True)
        if len(costs) != CT_TUNE_BATCH or len(true_costs) != CT_TUNE_BATCH \
                or np.isnan(costs).any() or np.isnan(true_costs).any():
            raise RuntimeError(f"tune {kind!r}: a score is missing or NaN")
        t0 = time.perf_counter()
        scores = [
            PipelineTuner(surrogate_mode="pretrain", eval_batch=CT_SEQ_ITERS, **fkw).run(
                pipeline, seq_task, trajs, n_iters=CT_SEQ_ITERS, rng=np.random.default_rng(3),
                surrogate=model)[1]
            for fkw in ({}, dict(use_fanout=True))
        ]
        agree = 0
        for i, (a, b) in enumerate(zip(scores[0].costs, scores[1].costs)):
            ok = (a == b) or (np.isfinite(a) and np.isfinite(b)
                              and abs(a - b) <= SEQ_TOL * max(abs(b), 1e-30))
            agree += ok
            print(f"[14d] {kind!r} candidate {i}: sequential {a!r}, fan-out {b!r}, relative "
                  f"difference {abs(a - b) / max(abs(b), 1e-30):.3e}{'' if ok else ' DIFFER'}",
                  flush=True)
        print(f"[14d] {kind!r} sequential vs fan-out ({seq_steps}-step near-upright task, "
              f"quadratic task cost): {agree} of {CT_SEQ_ITERS} within {SEQ_TOL} (min "
              f"{SEQ_AGREE_MIN}); {time.perf_counter() - t0:.2f} s", flush=True)
        if agree < SEQ_AGREE_MIN:
            raise RuntimeError(f"tune {kind!r}: sequential and fan-out agree on {agree} of "
                               f"{CT_SEQ_ITERS}")
    return rows


def lm_fit(model, trajs):
    """Seconds of ``model.train(trajs)`` to its result on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.train(trajs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def cpu64_trajs(trajs):
    """The sysid data as float64 on the CPU (for the float64 fits)."""
    from autompc_torch import TrajectoryBatch

    return TrajectoryBatch(trajs.system, trajs.obs.double().cpu(), trajs.ctrls.double().cpu(),
                           trajs.lengths.cpu())


def linear_models_phase(bench, model, trajs, dev, card, K6):
    """Phase 15 (a)-(c). Returns what phase [3] needs for K6 at (12, 1):
    (c2)'s fan-out, the candidates, the lanes' (A, B) and K6's launches by
    batch size on (c2)."""
    from autompc_torch.benchmarks.data_generation import uniform_random_generate_batch
    from autompc_torch.control import (
        DirectTranscriptionController,
        FiniteHorizonLQR,
        InfiniteHorizonLQR,
        make_scheduled_ilqr_solver,
        parse_schedule,
    )
    from autompc_torch.costs import QuadCost
    from autompc_torch.ops.riccati import finite_horizon_lqr, infinite_horizon_lqr
    from autompc_torch.parallel import JointKoopmanLassoQuadCostFanout
    from autompc_torch.sysid import ARXFactory, Koopman
    from autompc_torch.utils.simulation import simulate

    system = bench.system
    cpu64 = cpu64_trajs(trajs)

    # ---- (a1) configs[0] as the JAX slice test builds it ----
    small = bench.task.copy()
    small.set_ctrl_bound("u", -2.0, 2.0)
    local = uniform_random_generate_batch(
        system, small, bench.dynamics, torch.Generator(device=dev).manual_seed(42),
        init_min=-0.15 * np.ones(4), init_max=0.15 * np.ones(4), traj_len=LM_LOCAL_LEN,
        n_trajs=LM_LOCAL_TRAJS)
    arx2 = ARXFactory(system)({"history": 2}, local)
    q = np.diag([100.0, 10.0, 1.0, 1.0])
    task = bench.task.copy()
    task.set_cost(QuadCost(system, q, 0.01 * np.eye(1), q, goal=np.zeros(4)))
    t0 = time.perf_counter()
    traj = simulate(FiniteHorizonLQR(system, task, arx2, LM_A1_H), np.array([0.3, 0.0, 0.0, 0.0]),
                    dynamics=bench.dynamics, max_steps=LM_A1_STEPS)
    final = traj.obs[-1].double().cpu().numpy()
    ok = traj.size == LM_A1_STEPS + 1 and abs(final[0]) < LM_A1_GATE \
        and abs(final[1]) < LM_A1_GATE
    print(f"[15a1] configs[0]: ARX history 2 on {LM_LOCAL_TRAJS} x {LM_LOCAL_LEN} near-upright "
          f"trajectories, FiniteHorizonLQR H={LM_A1_H}, {LM_A1_STEPS} steps from (0.3, 0, 0, 0) "
          f"on the true dynamics ({time.perf_counter() - t0:.2f} s): final theta {final[0]:+.5f},"
          f" omega {final[1]:+.5f} (gate |.| < {LM_A1_GATE}): {ok}; on {card}", flush=True)
    if not ok:
        raise RuntimeError(f"configs[0] closed loop: final state {final}")

    # ---- (a2) full width: ARXFactory's default, LQRFactory's horizon ----
    af = ARXFactory(system)
    arx = af(af.get_configuration_space().get_default_configuration(), None,
             skip_train_model=True)
    fit_s = lm_fit(arx, trajs)
    A, B = arx.to_linear()
    A64, B64 = A.double().cpu(), B.double().cpu()
    fin = FiniteHorizonLQR(system, task, arx, 10)
    inf = InfiniteHorizonLQR(system, task, arx)
    Qp64, R64, Fp64 = fin.Qp.double().cpu(), fin.Rp.double().cpu(), fin.Qp.double().cpu() * 0
    Fp64[:4, :4] = torch.as_tensor(q)
    N64 = A64.new_zeros((arx.state_dim, 1))
    K_fin64 = finite_horizon_lqr(A64, B64, Qp64, R64, N64, Fp64, 10)[0]
    K_inf64 = infinite_horizon_lqr(A64, B64, Qp64, R64)[0]
    e_fin, e_inf = rel_err(fin.K.cpu(), K_fin64), rel_err(inf.K.cpu(), K_inf64)
    # The same designs in float32 on the card, for the record (the
    # controllers design in float64: control/lqr.py).
    f32 = [M.float().to(dev) for M in (A64, B64, Qp64, R64, N64, Fp64)]
    e32_fin = rel_err(finite_horizon_lqr(*f32, 10)[0].cpu(), K_fin64)
    e32_inf = rel_err(infinite_horizon_lqr(*f32[:4])[0].cpu(), K_inf64)
    obs = torch.as_tensor(task.get_init_obs(), dtype=A.dtype, device=dev)
    lat = {name: step_latency(con, obs, LM_STEP_REPS, dev)
           for name, con in (("finite", fin), ("infinite", inf))}
    print(f"[15a2] ARX history {arx.k} (ds={arx.state_dim}) on the main path's data: fit "
          f"{fit_s:.3f} s; LQR gains against float64 on the CPU from the same (A, B): finite "
          f"H=10 {e_fin:.3e}, infinite {e_inf:.3e} (tol {LM_GAIN_TOL}; the same designs run "
          f"in float32 on the card: {e32_fin:.3e}, {e32_inf:.3e}); "
          f"lqr_control_step_latency_ms finite {lat['finite'][0] * 1e3:.4f}, infinite "
          f"{lat['infinite'][0] * 1e3:.4f} ({LM_STEP_REPS} Controller.run calls after one warm) "
          f"on {card}", flush=True)
    for name, (_, us) in lat.items():
        if not controls_ok(us, task.get_ctrl_bounds()):
            raise RuntimeError(f"LQR ({name}) step: a control is not finite or bounded")
    if not (e_fin <= LM_GAIN_TOL and e_inf <= LM_GAIN_TOL):
        raise RuntimeError(f"LQR gains against float64: finite {e_fin:.3e}, infinite {e_inf:.3e}")

    # ---- (b) configs[3]: Koopman + direct transcription ----
    qd = np.diag([10.0, 0.1, 0.01, 0.01])
    dtask = bench.task.copy()
    dtask.set_cost(QuadCost(system, qd, 0.001 * np.eye(1), qd, goal=np.zeros(4)))
    km = Koopman(system, method="lstsq", **JK_BASIS)
    fit_s = lm_fit(km, trajs)
    km64 = Koopman(system, method="lstsq", device="cpu", **JK_BASIS)
    km64.train(cpu64)
    e_fit = rel_err(km.A.cpu(), km64.A)
    dt_con = DirectTranscriptionController(system, dtask, km, horizon=DT_HORIZON_S)
    obs = torch.as_tensor(dtask.get_init_obs(), dtype=km.A.dtype, device=dev)
    lat, us = step_latency(dt_con, obs, DT_STEP_REPS, dev)
    print(f"[15b] Koopman lstsq, trig basis (ds={km.state_dim}): fit {fit_s:.3f} s, A "
          f"{e_fit:.3e} from float64 (normwise); dt_sqp_koopman_control_step_latency_ms "
          f"{lat * 1e3:.3f} ({dt_con.horizon} knots, {DT_STEP_REPS} Controller.run calls after "
          f"one warm) on {card}", flush=True)
    if not controls_ok(us, dtask.get_ctrl_bounds()):
        raise RuntimeError("Koopman DT step: a control is not finite or outside its bounds")
    x0b = torch.cat([obs[None], draw_x0(np.random.default_rng(CF_SEED), DT_CHECK_B - 1, dev)])
    z0 = km._apply_basis(x0b)
    H_dt, ds = dt_con.horizon, km.state_dim
    _, us_c, st_c = dt_con._solve(km.params, z0, z0.new_zeros((DT_CHECK_B, H_dt + 1, ds)),
                                  z0.new_zeros((DT_CHECK_B, H_dt, 1)), steps=True)
    km_c64 = Koopman(system, method="lstsq", device="cpu", **JK_BASIS)
    km_c64.set_parameters(km.get_parameters())
    dt64 = DirectTranscriptionController(system, dtask, km_c64, horizon=DT_HORIZON_S)
    z64 = km_c64._apply_basis(x0b.double().cpu())
    _, us_p, st_p = dt64._solve(km_c64.params, z64, z64.new_zeros((DT_CHECK_B, H_dt + 1, ds)),
                                z64.new_zeros((DT_CHECK_B, H_dt, 1)), steps=True)
    same = (st_c.cpu() == st_p).all(1)
    err = (us_c.double().cpu() - us_p).abs().amax((1, 2))
    scale = us_p.abs().amax((1, 2)).clamp_min(1.0)
    bad = int((same & ~(err <= DT_US_TOL * scale)).sum())
    share = float(same.double().mean())
    print(f"[15b] first solve from {DT_CHECK_B} starts, card (float32) against CPU (float64) "
          f"on the card's (A, B): the same step size at every iteration on {share:.4f} of the "
          f"lanes (canonical start {bool(same[0])}); their controls within "
          f"{float((err / scale)[same].max()) if same.any() else float('nan'):.3e} (max "
          f"{DT_US_TOL}), {bad} beyond", flush=True)
    if not same.any() or bad:
        raise RuntimeError(f"Koopman DT first solve: {bad} lanes beyond {DT_US_TOL}, share {share}")
    t0 = time.perf_counter()
    traj = simulate(dt_con, dtask.get_init_obs(), dynamics=bench.dynamics,
                    max_steps=DT_LOOP_STEPS)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / DT_LOOP_STEPS
    print(f"[15b] receding DT loop on the Koopman model, {DT_LOOP_STEPS} steps from the "
          f"canonical start on the true dynamics: per-step latency {per_step * 1e3:.3f} ms; "
          f"final state {[round(float(v), 4) for v in traj.obs[-1]]}", flush=True)
    if not (torch.isfinite(traj.obs).all() and controls_ok(traj.ctrls[:-1],
                                                           dtask.get_ctrl_bounds())):
        raise RuntimeError("receding Koopman DT loop: a state or a control is not finite")
    for method in ("lasso", "stable"):
        m = Koopman(system, method=method, lasso_alpha=LM_LASSO_ALPHA, **JK_BASIS)
        fit_s = lm_fit(m, trajs)
        m64 = Koopman(system, method=method, lasso_alpha=LM_LASSO_ALPHA, device="cpu",
                      **JK_BASIS)
        fit64 = time.perf_counter()
        m64.train(cpu64)
        fit64 = time.perf_counter() - fit64
        rho = float(np.abs(np.linalg.eigvals(m.A.double().cpu().numpy())).max())
        print(f"[15b] Koopman {method} fit (alpha {LM_LASSO_ALPHA}): {fit_s:.3f} s on the card "
              f"({fit64:.3f} s float64 on the CPU); A {rel_err(m.A.cpu(), m64.A):.3e}, B "
              f"{rel_err(m.B.cpu(), m64.B):.3e} from float64 (normwise); spectral radius "
              f"{rho:.6f}", flush=True)
        if not torch.isfinite(m.A).all() or (method == "stable" and not rho < 1.0):
            raise RuntimeError(f"Koopman {method} fit: not finite, or spectral radius {rho}")

    # ---- (c) bench_scaling.py's joint-Koopman row ----
    rng = np.random.default_rng(JK_SEED)
    batch = fanout_candidates(dev, JK_B, JK_SEED)
    batch["reg"] = batch["Qdiag"].new_tensor(10 ** rng.uniform(-6, 0, JK_B))
    fans, out = {}, {}
    for tag, backward in (("c1", "scan"), ("c2", "pallas")):
        fan = JointKoopmanLassoQuadCostFanout(
            system, bench.task, JK_BASIS, trajs, model, horizon=JK_H, n_steps=JK_STEPS,
            goal=np.zeros(4), compact_schedule=JK_SCHEDULE, backward=backward)
        fans[tag] = fan
        K6.backward_quad.launches, K6.backward_quad.launches_by_B = 0, {}
        warm, per_call, scores = timed_runs(lambda: fan(batch), JK_CALLS)
        launches, by_B = K6.backward_quad.launches, dict(K6.backward_quad.launches_by_B)
        out[tag] = dict(launches=launches, by_B=by_B)
        fin = torch.isfinite(scores)
        print(f"[15{tag}] JointKoopmanLassoQuadCostFanout backward={backward!r}: B={JK_B} "
              f"H={JK_H} ds={fan.state_dim}, {JK_STEPS} steps, schedule {JK_SCHEDULE}: warm call "
              f"{warm:.2f} s, {JK_CALLS} timed calls {per_call:.3f} s each -> "
              f"{JK_B / per_call:.1f} evals/s on {card}; finite {int(fin.sum())} / {JK_B}, mean "
              f"of finite {float(scores[fin].mean()) if fin.any() else float('nan'):.2f}; K6 "
              f"launches {launches} by B {by_B}", flush=True)
        if tuple(scores.shape) != (JK_B,) or torch.isnan(scores).any():
            raise RuntimeError(f"joint Koopman fan-out ({tag}): malformed or NaN scores")
    if out["c1"]["launches"] or not out["c2"]["launches"]:
        raise RuntimeError(f"K6 launches: scan {out['c1']['launches']}, pallas "
                           f"{out['c2']['launches']} (the pallas body must launch it)")
    # The first MPC step's solve, (c1) against (c2): the lanes' models,
    # costs and the lifted start shared.
    params = fans["c2"].train_lanes(batch["reg"])
    cp = {k: batch[k] for k in ("Qdiag", "Rdiag", "Fdiag")}
    z0 = km._apply_basis(batch["Qdiag"].new_tensor(np.tile(bench.task.get_init_obs(),
                                                           (JK_B, 1))))
    ug = z0.new_zeros((JK_B, JK_H, 1))
    from autompc_torch.sysid.arx import linear_pred
    sols = {tag: make_scheduled_ilqr_solver(linear_pred, None,
                                            schedule=parse_schedule(JK_SCHEDULE),
                                            **fans[tag].solver_kw)(params, z0, ug, cp)
            for tag in fans}
    dt = system.dt
    obj = {tag: lane_objective(o[1][..., :4], o[2], cp, dt) for tag, o in sols.items()}
    both = sols["c1"][0] & sols["c2"][0]
    rel = ((obj["c1"] - obj["c2"]).abs() / obj["c2"].abs().clamp_min(1e-30))[both]
    share = float((rel <= FAN_OBJ_TOL).float().mean()) if both.any() else 0.0
    print(f"[15c] first MPC step, (c1) vs (c2): converged (c1) {int(sols['c1'][0].sum())}, (c2) "
          f"{int(sols['c2'][0].sum())}, both {int(both.sum())} of {JK_B}; accepted objective "
          f"relative difference on those: median "
          f"{float(rel.median()) if both.any() else float('nan'):.3e}, max "
          f"{float(rel.max()) if both.any() else float('nan'):.3e}; within {FAN_OBJ_TOL} on "
          f"{share:.4f} (min {FAN_AGREE_MIN})", flush=True)
    if int(both.sum()) < JK_B // 4 or share < FAN_AGREE_MIN:
        raise RuntimeError(f"joint Koopman first step: {int(both.sum())} lanes converged in "
                           f"both, objectives agree on {share:.4f}")
    return dict(fan=fans["c2"], batch=batch, params=params, z0=z0,
                launches=out["c2"]["launches"], by_B=out["c2"]["by_B"])


def linear_tunes(bench, model, trajs, card, K6):
    """Phase 15 (d): the tuner's kinds "joint_arx" and "joint_koopman", and
    the LQR pipeline through the sequential objective. Returns K6's
    launches by batch size in the "joint_koopman" tune (its fan-outs take
    ``backward="pallas"``: K6 at (12, 1))."""
    from autompc_torch.control import IterativeLQRFactory, LQRFactory
    from autompc_torch.costs import QuadCost, QuadCostFactory
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.sysid import ARXFactory, KoopmanFactory
    from autompc_torch.tuning import PipelineTuner

    system, goal = bench.system, np.zeros(4)
    seq_task = bench.task.copy()
    seq_task.set_cost(QuadCost(system, Q=np.eye(4), R=0.01 * np.eye(1), F=np.eye(4), goal=goal))
    seq_task.set_init_obs(np.array([0.5, 0.0, 0.0, 0.0]))
    seq_task.set_num_steps(LM_SEQ_STEPS)
    task = bench.task.copy()
    task.set_num_steps(LM_TUNE_STEPS)
    k6_by_B = {}
    for kind, mf, backward in (
            ("joint_arx", ARXFactory(system, history=4), "scan"),
            ("joint_koopman", KoopmanFactory(system, poly_basis="false", trig_basis="true",
                                             trig_freq=1), "pallas")):
        pipeline = Pipeline(system, mf, QuadCostFactory(system, goal=goal),
                            IterativeLQRFactory(system, horizon=LM_TUNE_H))
        tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=LM_TUNE_BATCH,
                              use_fanout=True, fanout_backward=backward)
        K6.backward_quad.launches_by_B = {}
        if tuner._fanout_kind(pipeline, model)[0] != kind:
            raise RuntimeError(f"the tuner did not select the {kind!r} fan-out")
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)    # a fallback warning fails the phase
            _, res = tuner.run(pipeline, task, trajs, n_iters=LM_TUNE_BATCH,
                               rng=np.random.default_rng(100), surrogate=model,
                               truedyn=bench.dynamics)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
        if backward == "pallas":
            k6_by_B = dict(K6.backward_quad.launches_by_B)
        costs, true_costs = np.array(res.costs), np.array(res.truedyn_costs)
        buckets = sorted({str(c.get("_model:method", "arx")) for c in res.cfgs})
        print(f"[15d] tune {kind!r}: one BO round of {LM_TUNE_BATCH} candidates x "
              f"{LM_TUNE_STEPS - 1} steps (buckets {buckets}, H={LM_TUNE_H}, backward="
              f"{backward!r}), surrogate and true dynamics: {tune_s:.2f} s -> "
              f"{LM_TUNE_BATCH / tune_s:.1f} evals/s (both fan-outs) on {card}; K6 launches "
              f"{dict(K6.backward_quad.launches_by_B)} by B; finite "
              f"{int(np.isfinite(costs).sum())} / {costs.size} on the "
              f"surrogate, {int(np.isfinite(true_costs).sum())} / {true_costs.size} on the true "
              f"dynamics; incumbent {res.inc_cfg.get_dictionary()}: surrogate "
              f"{res.inc_costs[-1]:.1f}, true dynamics {res.inc_truedyn_costs[-1]:.1f}",
              flush=True)
        if len(costs) != LM_TUNE_BATCH or len(true_costs) != LM_TUNE_BATCH \
                or np.isnan(costs).any() or np.isnan(true_costs).any():
            raise RuntimeError(f"tune {kind!r}: a score is missing or NaN")
        t0 = time.perf_counter()
        scores = [
            PipelineTuner(surrogate_mode="pretrain", eval_batch=SEQ_ITERS, **fkw).run(
                pipeline, seq_task, trajs, n_iters=SEQ_ITERS, rng=np.random.default_rng(3),
                surrogate=model)[1]
            for fkw in ({}, dict(use_fanout=True, fanout_backward=backward))
        ]
        agree = 0
        for i, (a, b) in enumerate(zip(scores[0].costs, scores[1].costs)):
            ok = (a == b) or (np.isfinite(a) and np.isfinite(b)
                              and abs(a - b) <= SEQ_TOL * max(abs(b), 1e-30))
            agree += ok
            print(f"[15d] {kind!r} candidate {i}: sequential {a!r}, fan-out {b!r}, relative "
                  f"difference {abs(a - b) / max(abs(b), 1e-30):.3e}{'' if ok else ' DIFFER'}",
                  flush=True)
        print(f"[15d] {kind!r} sequential vs fan-out ({LM_SEQ_STEPS}-step near-upright task, "
              f"quadratic task cost): {agree} of {SEQ_ITERS} within {SEQ_TOL} (min "
              f"{SEQ_AGREE_MIN}); {time.perf_counter() - t0:.2f} s", flush=True)
        if agree < SEQ_AGREE_MIN:
            raise RuntimeError(f"tune {kind!r}: sequential and fan-out agree on {agree} of "
                               f"{SEQ_ITERS}")
    # configs[0] through the tuner: no fan-out, the sequential objective.
    pipeline = Pipeline(system, ARXFactory(system), QuadCostFactory(system, goal=goal),
                        LQRFactory(system))
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, res = PipelineTuner(surrogate_mode="pretrain", eval_batch=LM_LQR_ITERS,
                               use_fanout=True).run(
            pipeline, task, trajs, n_iters=LM_LQR_ITERS, rng=np.random.default_rng(5),
            surrogate=model)
    fell_back = any("falling back" in str(w.message) for w in caught)
    print(f"[15d] ARX + QuadCost + LQR through the tuner: fell back to the sequential objective "
          f"{fell_back}; {LM_LQR_ITERS} candidates {[c.get_dictionary() for c in res.cfgs]}: "
          f"costs {res.costs}; incumbent {res.inc_costs[-1]!r} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    if not (fell_back and np.isfinite(res.inc_costs[-1])):
        raise RuntimeError(f"LQR pipeline: fell back {fell_back}, incumbent {res.inc_costs[-1]}")
    if not k6_by_B:
        raise RuntimeError("the 'joint_koopman' tune with backward='pallas' never launched K6")
    return k6_by_B


def check_k6_wide(lm, K6, dt, tune_by_B):
    """K6 at (12, 1) against its plain version on (c2)'s carry (the first
    MPC step, three iterations in) at every batch size (c2) launched it
    with, and at each batch size the "joint_koopman" tune launched it
    with (``tune_by_B``; the first lanes of the same carry). Returns (its
    report row, failures)."""
    from autompc_torch.control import make_batched_ilqr_solver
    from autompc_torch.sysid.arx import linear_pred

    fan, batch = lm["fan"], lm["batch"]
    _, carry0, _, make_body = make_batched_ilqr_solver(linear_pred, None, return_pieces=True,
                                                       **fan.solver_kw)
    cp = {k: batch[k] for k in ("Qdiag", "Rdiag", "Fdiag")}
    c = carry0(lm["params"], lm["z0"], lm["z0"].new_zeros((JK_B, JK_H, 1)), cp)
    body = make_body(lm["params"])
    for _ in range(3):
        c = body(c)
    Bs = sorted(lm["by_B"], reverse=True)
    meas, failures = {}, []
    for Bc in sorted(set(Bs) | set(tune_by_B), reverse=True):
        sc = sub_carry(c, Bc)
        args = (sc["Jx"], sc["Ju"], sc["xs"], sc["us"], sc["cost"]["Qdiag"], sc["cost"]["Rdiag"],
                sc["cost"]["Fdiag"], (0.0,) * 4, dt, 4)
        gk = K6.backward_quad(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp = K6.backward_quad_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs = [rel_err(a, b) for a, b in zip(gk, gp)]
        g6 = K6.bq_bm_geometry(Bc, JK_H, 12, K6._build.sm_count(sc["xs"].device))
        meas[Bc] = dict(
            max_abs_err=max(abs_err(a, b) for a, b in zip(gk, gp)),
            ms=time_ms(lambda: K6.backward_quad(*args)),
            device_ms=device_ms(lambda: K6.backward_quad(*args)),
            plain_ms=plain_ms,
            **bound_keys(n_bytes(*args[:7], *gk), Bc * JK_H * (riccati_flops(12, 1) + 4 * 12)),
            launches=lm["by_B"].get(Bc, 0),
        )
        print(f"[3] K6 at (12, 1) on (c2)'s carry B={Bc} H={JK_H} ({g6['group']} threads a lane, "
              f"{g6['lanes_per_block']} lanes a block, {g6['blocks']} blocks, ring {g6['ring']}):"
              f" rel err K/k/lin/quad {[f'{e:.3e}' for e in errs]} (tol {TOL_K6}); kernel "
              f"{meas[Bc]['ms']:.4f} ms (device {meas[Bc]['device_ms']:.4f}), plain "
              f"{plain_ms:.1f} ms, bound {meas[Bc]['bound_ms']:.5f} ms "
              f"({meas[Bc]['bound_by']}); {lm['by_B'].get(Bc, 0)} launches on (c2), "
              f"{tune_by_B.get(Bc, 0)} in the tune", flush=True)
        if not max(errs) <= TOL_K6:
            failures.append(f"K6 at (12, 1) B={Bc} rel err {max(errs):.3e} > {TOL_K6}")
    top = dict(meas[Bs[0]])
    top.pop("launches")
    at = {f"at_B{Bc}_H{JK_H}": meas[Bc] for Bc in meas if Bc != Bs[0]}
    for w in at.values():
        w.pop("library_ms")
    row = dict(name=f"backward_quad[ds=12,B={Bs[0]},H={JK_H}]", route="cuda",
               source="autompc_torch/csrc/riccati_quad_bm.cu",
               replaces="autompc_tpu/ops/pallas_riccati.py:456", launches=lm["launches"],
               launches_by_B=lm["by_B"], launches_joint_koopman=lm["launches"],
               launches_tune=sum(tune_by_B.values()), launches_tune_by_B=tune_by_B, **top, **at)
    return row, failures


def gp_first_step(tag, pred_core, params, fans, batch, H, init_obs, dt, schedule):
    """The first MPC step's scheduled solves of two fan-out configurations
    (``fans``: config -> fan-out) on the same candidates and predictor
    params: the accepted objectives within FAN_OBJ_TOL on FAN_AGREE_MIN of
    the lanes converged in both, as phase 8's."""
    from autompc_torch.control import make_scheduled_ilqr_solver, parse_schedule

    n = batch["Qdiag"].shape[0]
    cp = {k: batch[k] for k in ("Qdiag", "Rdiag", "Fdiag")}
    x0 = batch["Qdiag"].new_tensor(np.tile(init_obs, (n, 1)))
    ug = x0.new_zeros((n, H, 1))
    sols = {cfg: make_scheduled_ilqr_solver(pred_core, None, schedule=parse_schedule(schedule),
                                            **fan.solver_kw)(params, x0, ug, cp)
            for cfg, fan in fans.items()}
    (ka, ra), (kb, rb) = sols.items()
    obj = {cfg: lane_objective(o[1], o[2], cp, dt) for cfg, o in sols.items()}
    both = ra[0] & rb[0]
    rel = ((obj[ka] - obj[kb]).abs() / obj[kb].abs().clamp_min(1e-30))[both]
    share = float((rel <= FAN_OBJ_TOL).float().mean()) if both.any() else 0.0
    print(f"[16{tag}] first MPC step, ({ka}) vs ({kb}): converged ({ka}) {int(ra[0].sum())}, "
          f"({kb}) {int(rb[0].sum())}, both {int(both.sum())} of {n}; accepted objective "
          f"relative difference on those: median "
          f"{float(rel.median()) if both.any() else float('nan'):.3e}, max "
          f"{float(rel.max()) if both.any() else float('nan'):.3e}; within {FAN_OBJ_TOL} on "
          f"{share:.4f} (min {FAN_AGREE_MIN})", flush=True)
    if int(both.sum()) < n // 4 or share < FAN_AGREE_MIN:
        raise RuntimeError(f"GP fan-out ({tag}) first step: {int(both.sum())} lanes converged "
                           f"in both, objectives agree on {share:.4f}")


def gp_finite_report(w):
    """(buckets with a task not finite, tasks not finite) of cached mean
    weights ``w`` (K, n_task, M) or (n_task, M)."""
    bad = ~torch.isfinite(w).all(-1)
    return (int(bad.reshape(-1, bad.shape[-1]).any(-1).sum()), int(bad.sum()))


def gp_phase(bench, model, trajs, dev, card, K6, K4):
    """Phase 16 (a)-(c'). Returns what phase [3] needs for K6 and K4 at
    (4, 1) on the GP path: the fan-outs, the candidates, the lanes'
    predictor params and the kernels' launches by batch size."""
    from autompc_torch import TrajectoryBatch, default_dtype
    from autompc_torch.parallel import JointGPQuadCostFanout, QuadCostFanout
    from autompc_torch.sysid import ApproximateGPModel
    from autompc_torch.sysid.gp import gp_pred_core_cached
    from autompc_torch.tuning.pipeline_tuner import _gauss_reg_stats

    system, dt = bench.system, bench.system.dt
    init = bench.task.get_init_obs()
    out = {}

    # ---- (a) bench_extra.py's svgp_train_s_and_pred_throughput ----
    gp = ApproximateGPModel(system, **GP_A)
    sub = TrajectoryBatch(system, trajs.obs[:GP_A_TRAJS], trajs.ctrls[:GP_A_TRAJS],
                          trajs.lengths[:GP_A_TRAJS])
    train_s = lm_fit(gp, sub)
    xs = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (GP_A_POINTS, 4)),
                         dtype=default_dtype(dev), device=dev)
    us = xs.new_zeros((GP_A_POINTS, 1))
    warm, per_call, preds = timed_runs(lambda: gp.pred_batch(xs, us), GP_A_REPS)
    gp64 = ApproximateGPModel(system, device="cpu")
    gp64.set_parameters(gp.get_parameters())
    p64 = gp64.pred_batch(xs.double().cpu(), us.double().cpu())
    bk, tk = gp_finite_report(gp._w)
    print(f"[16a] svgp_train_s_and_pred_throughput: ApproximateGPModel({GP_A}) on the first "
          f"{GP_A_TRAJS} trajectories ({sub.step_mask().sum().item()} pairs): train_s "
          f"{train_s:.3f}; pred_batch of {GP_A_POINTS} points: warm call {warm * 1e3:.2f} ms, "
          f"{GP_A_REPS} timed calls {per_call * 1e3:.3f} ms each -> {GP_A_POINTS / per_call:.1f} "
          f"preds/s; losses {[round(v, 1) for v in gp._losses.tolist()]}; non-finite tasks in "
          f"float32 {tk} of 4; predictions {rel_err(preds.cpu(), p64):.3e} from float64 on the "
          f"CPU at the same parameters (normwise) on {card}", flush=True)
    if tk or not torch.isfinite(preds).all() or not rel_err(preds.cpu(), p64) <= GP_PRED_TOL:
        raise RuntimeError(f"GP (a): non-finite tasks {tk}, or predictions "
                           f"{rel_err(preds.cpu(), p64):.3e} from float64 (max {GP_PRED_TOL})")

    # ---- (b) bench_scaling.py SCALE_MODE=gp: the fixed GP in QuadCostFanout ----
    gpm = ApproximateGPModel(system, induce_count=GP_M)
    fit_s = lm_fit(gpm, trajs)
    bk, tk = gp_finite_report(gpm._w)
    print(f"[16b] ApproximateGPModel(induce_count={GP_M}) on the main path's data: fit "
          f"{fit_s:.3f} s; non-finite tasks in float32 {tk} of 4", flush=True)
    batch = fanout_candidates(dev, GP_B, GP_SEED)
    fans, counts = {}, {}
    for tag, backward in (("b1", "scan"), ("b2", "pallas")):
        fan = QuadCostFanout(system, bench.task, gpm, model, horizon=GP_H, n_steps=GP_STEPS,
                             goal=np.zeros(4), compact_schedule=GP_SCHEDULE, backward=backward)
        fans[tag] = fan
        K6.backward_quad.launches, K6.backward_quad.launches_by_B = 0, {}
        warm, per_call, scores = timed_runs(lambda: fan(batch), GP_CALLS)
        counts[tag] = (K6.backward_quad.launches, dict(K6.backward_quad.launches_by_B))
        fin = torch.isfinite(scores)
        print(f"[16{tag}] QuadCostFanout, ApproximateGPModel (jacfwd relinearization), "
              f"backward={backward!r}: B={GP_B} H={GP_H}, {GP_STEPS} steps, schedule "
              f"{GP_SCHEDULE}: warm call {warm:.2f} s, {GP_CALLS} timed calls {per_call:.3f} s "
              f"each -> gp_candidate_evals_per_s {GP_B / per_call:.1f} on {card}; finite "
              f"{int(fin.sum())} / {GP_B}, mean of finite "
              f"{float(scores[fin].mean()) if fin.any() else float('nan'):.2f}; K6 launches "
              f"{counts[tag][0]} by B {counts[tag][1]}", flush=True)
        if tuple(scores.shape) != (GP_B,) or torch.isnan(scores).any():
            raise RuntimeError(f"GP fan-out ({tag}): malformed or NaN scores")
    if counts["b1"][0] or not counts["b2"][0]:
        raise RuntimeError(f"K6 launches on the GP fan-out: scan {counts['b1'][0]}, pallas "
                           f"{counts['b2'][0]} (the pallas body must launch it)")
    gp_first_step("b", gpm.pred_core, gpm.params, fans, batch, GP_H, init, dt, GP_SCHEDULE)
    out["b"] = dict(fan=fans["b2"], batch=batch, params=gpm.params, pred_core=gpm.pred_core,
                    launches=counts["b2"][0], by_B=counts["b2"][1])

    # ---- (c) SCALE_MODE=joint_gp: mixed induce_counts ----
    # bench_scaling.py's draws: the diagonals, then the counts from the
    # same generator.
    rng = np.random.default_rng(GP_SEED)
    jbatch = {k: batch["Qdiag"].new_tensor(10 ** rng.uniform(lo, hi, (GP_B, n)))
              for k, lo, hi, n in (("Qdiag", -1, 1.5, 4), ("Fdiag", -1, 1.5, 4),
                                   ("Rdiag", -3, 0, 1))}
    choices = np.linspace(50, 200, GP_DISTINCT).astype(int)
    counts_c = rng.choice(choices, size=GP_B)
    jbatch["induce_count"] = counts_c
    jfans, jcounts = {}, {}
    for tag, backward in (("c1", "scan"), ("c2", "pallas")):
        fan = JointGPQuadCostFanout(system, bench.task, dict(niter=GP_ITERS), trajs, model,
                                    horizon=GP_H, n_steps=GP_STEPS, goal=np.zeros(4),
                                    compact_schedule=GP_SCHEDULE, backward=backward)
        if jfans:
            fan.buckets = jfans["c1"].buckets     # the same training: once
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fan.ensure_buckets(counts_c.tolist())
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            w = torch.stack([fan.buckets[m]["w"] for m in sorted(fan.buckets)])
            bk, tk = gp_finite_report(w)
            print(f"[16c] train_svgp_buckets: {len(fan.buckets)} distinct induce_counts "
                  f"{sorted(fan.buckets)} at pad_to={fan.pad_to}, niter {GP_ITERS}, one call: "
                  f"{train_s:.3f} s on {card}; non-finite in float32: {bk} buckets, {tk} tasks "
                  f"of {w.shape[0] * w.shape[1]}", flush=True)
        jfans[tag] = fan
        K6.backward_quad.launches, K6.backward_quad.launches_by_B = 0, {}
        warm, per_call, scores = timed_runs(lambda: fan(jbatch), GP_CALLS)
        jcounts[tag] = (K6.backward_quad.launches, dict(K6.backward_quad.launches_by_B))
        fin = torch.isfinite(scores)
        print(f"[16{tag}] JointGPQuadCostFanout backward={backward!r}: B={GP_B} H={GP_H}, "
              f"{GP_STEPS} steps, {GP_DISTINCT} distinct induce_counts, schedule {GP_SCHEDULE}:"
              f" warm call {warm:.2f} s (the buckets trained before it), {GP_CALLS} timed calls "
              f"{per_call:.3f} s each -> joint_gp_mixed_bucket_evals_per_s "
              f"{GP_B / per_call:.1f} on {card}; finite {int(fin.sum())} / {GP_B}, mean of "
              f"finite {float(scores[fin].mean()) if fin.any() else float('nan'):.2f}; K6 "
              f"launches {jcounts[tag][0]} by B {jcounts[tag][1]}", flush=True)
        if tuple(scores.shape) != (GP_B,) or torch.isnan(scores).any():
            raise RuntimeError(f"joint GP fan-out ({tag}): malformed or NaN scores")
    if jcounts["c1"][0] or not jcounts["c2"][0]:
        raise RuntimeError(f"K6 launches on the joint GP fan-out: scan {jcounts['c1'][0]}, "
                           f"pallas {jcounts['c2'][0]}")
    lane_params = jfans["c2"].lane_params(counts_c.tolist())
    gp_first_step("c", gp_pred_core_cached, lane_params, jfans, jbatch, GP_H, init, dt,
                  GP_SCHEDULE)
    # One padded bucket against the model trained alone (the same data,
    # seed and epoch orders): the real rows to rounding, the dummies exact.
    M = int(choices[0])
    solo = ApproximateGPModel(system, niter=GP_ITERS, induce_count=M)
    solo.train(trajs)
    bucket = jfans["c1"].buckets[M]
    real = dict(bucket["gp"], Z=bucket["gp"]["Z"][..., :M, :], m=bucket["gp"]["m"][..., :M],
                Ls=bucket["gp"]["Ls"][..., :M, :M])
    dist = max(rel_err(real[k], v) for k, v in solo._params.items())
    w_dist = rel_err(bucket["w"][:, :M], solo._w)
    dummy_w = bool((bucket["w"][:, M:] == 0).all())
    print(f"[16c] the induce_count={M} bucket (padded to {jfans['c1'].pad_to}) against "
          f"ApproximateGPModel(induce_count={M}) trained alone on the card: parameters "
          f"{dist:.3e}, w {w_dist:.3e} apart (normwise, the largest leaf); the dummy rows of w "
          f"exactly 0: {dummy_w}", flush=True)
    if not dummy_w:
        raise RuntimeError("a padded bucket's dummy weights are not exactly 0")
    out["c"] = dict(fan=jfans["c2"], batch=jbatch, params=lane_params,
                    launches=jcounts["c2"][0], by_B=jcounts["c2"][1])

    # ---- (c') the GaussReg term: K4 at (4, 1) ----
    S, mu = _gauss_reg_stats(trajs)
    rbatch = dict(jbatch, regw=jbatch["Qdiag"].new_tensor(
        10 ** np.random.default_rng(GP_SEED + GR_SEED).uniform(-3, 4, GP_B)))
    rfan = JointGPQuadCostFanout(system, bench.task, dict(niter=GP_ITERS), trajs, model,
                                 horizon=GP_H, n_steps=GP_REG_STEPS, goal=np.zeros(4),
                                 compact_schedule=GP_SCHEDULE, backward="pallas",
                                 reg_matrix=S, reg_goal=mu)
    rfan.buckets = jfans["c1"].buckets
    K4.riccati_general.launches, K4.riccati_general.launches_by_B = 0, {}
    K6.backward_quad.launches = 0
    t0 = time.perf_counter()
    scores = rfan(rbatch)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    k4 = (K4.riccati_general.launches, dict(K4.riccati_general.launches_by_B))
    fin = torch.isfinite(scores)
    print(f"[16c'] JointGPQuadCostFanout + GaussReg (S, mu of the main path's data, regw "
          f"10^U(-3, 4)), backward='pallas': B={GP_B}, {GP_REG_STEPS} steps, one call {call_s:.2f}"
          f" s; finite {int(fin.sum())} / {GP_B}; K4 launches {k4[0]} by B {k4[1]}, K6 "
          f"{K6.backward_quad.launches}", flush=True)
    if torch.isnan(scores).any() or not k4[0] or K6.backward_quad.launches:
        raise RuntimeError(f"GP fan-out + GaussReg: NaN scores, or K4 launched {k4[0]} times, "
                           f"K6 {K6.backward_quad.launches}")
    out["c'"] = dict(fan=rfan, batch=rbatch, params=rfan.lane_params(counts_c.tolist()), S=S,
                     mu=mu, launches=k4[0], by_B=k4[1])
    return out


def gp_tune(bench, model, trajs, card, K6):
    """Phase 16 (d): the tuner's kind "joint_gp" (backward "pallas": K6 at
    (4, 1)), then sequential against fan-out. Returns K6's launches by
    batch size in the tune."""
    from autompc_torch.control import IterativeLQRFactory
    from autompc_torch.costs import QuadCost, QuadCostFactory
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.sysid import ApproximateGPModelFactory
    from autompc_torch.tuning import PipelineTuner

    system, goal = bench.system, np.zeros(4)
    task = bench.task.copy()
    task.set_num_steps(GP_TUNE_STEPS)
    pipeline = Pipeline(system, ApproximateGPModelFactory(system, niter=GP_ITERS),
                        QuadCostFactory(system, goal=goal),
                        IterativeLQRFactory(system, horizon=GP_TUNE_H))
    tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=GP_TUNE_BATCH, use_fanout=True,
                          fanout_backward="pallas")
    if tuner._fanout_kind(pipeline, model)[0] != "joint_gp":
        raise RuntimeError("the tuner did not select the 'joint_gp' fan-out")
    K6.backward_quad.launches_by_B = {}
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)    # a fallback warning fails the phase
        _, res = tuner.run(pipeline, task, trajs, n_iters=GP_TUNE_BATCH,
                           rng=np.random.default_rng(100), surrogate=model,
                           truedyn=bench.dynamics)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    by_B = dict(K6.backward_quad.launches_by_B)
    costs, true_costs = np.array(res.costs), np.array(res.truedyn_costs)
    n_counts = len({c["_model:induce_count"] for c in res.cfgs})
    print(f"[16d] tune 'joint_gp': one BO round of {GP_TUNE_BATCH} candidates ({n_counts} "
          f"distinct induce_counts) x {GP_TUNE_STEPS - 1} steps (H={GP_TUNE_H}, backward="
          f"'pallas'), surrogate and true dynamics, each fan-out training its buckets: "
          f"{tune_s:.2f} s -> {GP_TUNE_BATCH / tune_s:.1f} evals/s on {card}; K6 launches "
          f"{by_B} by B; finite {int(np.isfinite(costs).sum())} / {costs.size} on the "
          f"surrogate, {int(np.isfinite(true_costs).sum())} / {true_costs.size} on the true "
          f"dynamics; incumbent {res.inc_cfg.get_dictionary()}: surrogate "
          f"{res.inc_costs[-1]:.1f}, true dynamics {res.inc_truedyn_costs[-1]:.1f}", flush=True)
    if len(costs) != GP_TUNE_BATCH or np.isnan(costs).any() or np.isnan(true_costs).any() \
            or not np.isfinite(res.inc_costs[-1]) or not by_B:
        raise RuntimeError("tune 'joint_gp': a score is missing or NaN, the incumbent is not "
                           "finite, or K6 never ran")
    seq_task = bench.task.copy()
    seq_task.set_cost(QuadCost(system, Q=np.eye(4), R=0.01 * np.eye(1), F=np.eye(4), goal=goal))
    seq_task.set_init_obs(np.array([0.5, 0.0, 0.0, 0.0]))
    seq_task.set_num_steps(GP_SEQ_STEPS)
    t0 = time.perf_counter()
    scores = [
        PipelineTuner(surrogate_mode="pretrain", eval_batch=SEQ_ITERS, **fkw).run(
            pipeline, seq_task, trajs, n_iters=SEQ_ITERS, rng=np.random.default_rng(3),
            surrogate=model)[1]
        for fkw in ({}, dict(use_fanout=True, fanout_backward="pallas"))
    ]
    agree = 0
    for i, (a, b) in enumerate(zip(scores[0].costs, scores[1].costs)):
        ok = (a == b) or (np.isfinite(a) and np.isfinite(b)
                          and abs(a - b) <= SEQ_TOL * max(abs(b), 1e-30))
        agree += ok
        print(f"[16d] 'joint_gp' candidate {i} (induce_count "
              f"{scores[0].cfgs[i]['_model:induce_count']}): sequential {a!r}, fan-out {b!r}, "
              f"relative difference {abs(a - b) / max(abs(b), 1e-30):.3e}"
              f"{'' if ok else ' DIFFER'}", flush=True)
    print(f"[16d] 'joint_gp' sequential vs fan-out ({GP_SEQ_STEPS}-step near-upright task, "
          f"quadratic task cost): {agree} of {SEQ_ITERS} within {SEQ_TOL} (min "
          f"{SEQ_AGREE_MIN}); {time.perf_counter() - t0:.2f} s", flush=True)
    if agree < SEQ_AGREE_MIN:
        raise RuntimeError(f"tune 'joint_gp': sequential and fan-out agree on {agree} of "
                           f"{SEQ_ITERS}")
    return by_B


def pendulum_draws(method, n, T, gen, dev):
    """Draws for the pendulum's generators, made on the card."""
    from autompc_torch import default_dtype

    def u(*shape):
        return torch.rand(shape, generator=gen, dtype=default_dtype(dev), device=dev)

    d = {"inits": u(n, 2)}
    if method == "uniform_random":
        d["u"] = u(n, T, 1)
    elif method == "multisine":
        P = len(range(1, T, 20))
        d["vals"], d["phases"] = u(n, 1, P - 1), 2 * np.pi * u(n, P)
    else:
        d["u0"], d["w"] = u(n, 1), 2 * u(n, T, 1) - 1
    return d


def pendulum_phase(dev, card):
    """Phase 16 (e): the pendulum benchmark and BASELINE.json configs[2]
    (an MLP + MPPI with 4,096 sampled rollouts a step)."""
    import math

    from autompc_torch import default_dtype
    from autompc_torch.benchmarks import PendulumSwingupBenchmark
    from autompc_torch.control import MPPI, make_receding_mppi_loop
    from autompc_torch.control import mppi as mppi_module
    from autompc_torch.core.trajectory import zeros as traj_zeros
    from autompc_torch.costs import QuadCost
    from autompc_torch.sysid import MLP

    gen = torch.Generator(device=dev).manual_seed(PEND_SEED)
    for method in PendulumSwingupBenchmark.data_gen_methods():
        pend = PendulumSwingupBenchmark(method)
        d = pendulum_draws(method, PEND_CHECK_N, PEND_LEN, gen, dev)
        card_tb = pend._gen_trajs(PEND_CHECK_N, PEND_LEN, None, draws=d)
        cpu_tb = pend._gen_trajs(PEND_CHECK_N, PEND_LEN, None,
                                 draws={k: v.double().cpu() for k, v in d.items()})
        err = rel_err(card_tb.obs.cpu(), cpu_tb.obs)
        own = pend.gen_trajs_batch(PEND_SEED, PEND_CHECK_N, PEND_LEN)
        ok = err <= PEND_DATA_TOL and bool(torch.isfinite(own.obs).all()) and \
            controls_ok(own.ctrls, pend.task.get_ctrl_bounds())
        print(f"[16e] pendulum {method!r}: {PEND_CHECK_N} x {PEND_LEN} on the card against "
              f"float64 on the CPU from the same draws: {err:.3e} (normwise, max "
              f"{PEND_DATA_TOL}); gen_trajs_batch on the card finite and bounded: {ok}",
              flush=True)
        if not ok:
            raise RuntimeError(f"pendulum data ({method}): {err:.3e} from float64, or not "
                               "finite/bounded")

    pend = PendulumSwingupBenchmark()
    t0 = time.perf_counter()
    data = pend.gen_trajs_batch(PEND_SEED, PEND_TRAJS, PEND_TRAJ_LEN)
    mlp = MLP(pend.system, n_hidden_layers=2, hidden_size=PEND_WIDTH, n_train_iters=PEND_EPOCHS,
              n_batch=64)
    mlp.train(data)
    torch.cuda.synchronize()
    losses = mlp._losses.tolist()
    print(f"[16e] configs[2]: MLP 3-{PEND_WIDTH}-{PEND_WIDTH}-2 (relu) on {PEND_TRAJS} x "
          f"{PEND_TRAJ_LEN} uniform-random pendulum trajectories, {PEND_EPOCHS} epochs: "
          f"{time.perf_counter() - t0:.2f} s with the data; epoch loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}", flush=True)
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f"pendulum MLP training diverged: {losses}")
    system = pend.system
    q = np.diag([10.0, 0.1])
    task = pend.task.copy()
    task.set_cost(QuadCost(system, q, 0.001 * np.eye(1), q, goal=np.zeros(2)))
    bounds = task.get_ctrl_bounds()
    umax = float(bounds[0, 1])
    obs = torch.as_tensor(task.get_init_obs(), dtype=default_dtype(dev), device=dev)
    kw = dict(horizon=CT_H, num_path=CT_PATHS, sigma=CT_SIGMA, lmda=CT_LMDA)
    mppi = MPPI(system, task, mlp, **kw)
    lat, us = step_latency(mppi, obs, CT_STEP_REPS, dev)
    print(f"[16e] pendulum mppi_control_step_latency_ms {lat * 1e3:.3f} ({CT_PATHS} paths, "
          f"H={CT_H}, {CT_STEP_REPS} Controller.run calls after one warm) -> "
          f"{CT_PATHS / lat:.1f} rollouts/s; within dt {lat < system.dt}; on {card}", flush=True)
    if not controls_ok(us, bounds):
        raise RuntimeError("pendulum MPPI step: a control is not finite or outside its bounds")
    cs0 = mppi.traj_to_state(traj_zeros(system, 1, device=dev))
    x0 = mlp.update_state_core(mlp.params, cs0["model_state"], cs0["last_u"], obs)
    seq = torch.cat([cs0["act_sequence"][1:], cs0["act_sequence"][-1:]])
    eps = math.sqrt(CT_SIGMA) * mppi_module.standard_normal(
        (CT_H, CT_PATHS, 1), (mppi.seed, cs0["draws"]), obs)
    c_card, e_card = mppi._do_rollouts(mlp.params, x0, seq, None, eps=eps)
    u_card = mppi._update_sequence(seq, c_card, e_card)[0] * umax
    m64 = MLP(system, n_hidden_layers=2, hidden_size=PEND_WIDTH, device="cpu")
    m64.set_parameters(mlp.get_parameters())
    mppi64 = MPPI(system, task, m64, **kw)
    c_cpu, e_cpu = mppi64._do_rollouts(m64.params, x0.double().cpu(), seq.double().cpu(), None,
                                       eps=eps.double().cpu())
    u_cpu = mppi64._update_sequence(seq.double().cpu(), c_cpu, e_cpu)[0] * umax
    cost_rel = float(((c_card.double().cpu() - c_cpu).abs()
                      / c_cpu.abs().clamp_min(1e-30)).max())
    du0 = float((u_card.double().cpu() - u_cpu).abs().max())
    print(f"[16e] pendulum first step, card (float32) against CPU (float64) on the card's "
          f"draws: per-path costs within {cost_rel:.3e} (relative, max {CT_COST_TOL}); |du0| "
          f"{du0:.3e} (max {CT_DU0_TOL * umax:.3g})", flush=True)
    if not (cost_rel <= CT_COST_TOL and du0 <= CT_DU0_TOL * umax):
        raise RuntimeError(f"pendulum MPPI first step: costs {cost_rel:.3e}, |du0| {du0:.3e}")
    run = make_receding_mppi_loop(system, task, mlp, pend.dynamics, n_steps=PEND_LOOP_STEPS,
                                  **kw)
    t0 = time.perf_counter()
    xs, us = run(mlp.params, obs[None])
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / PEND_LOOP_STEPS
    theta = float(xs[0, -1, 0])
    wrapped = abs(math.remainder(theta, 2 * math.pi))
    print(f"[16e] pendulum receding MPPI loop, {PEND_LOOP_STEPS} steps from (pi, 0) on the "
          f"true dynamics: per-step latency {per_step * 1e3:.3f} ms; final |theta| "
          f"{abs(theta):.4f} (wrapped {wrapped:.4f}), omega {float(xs[0, -1, 1]):+.4f}; task "
          f"metric {float(pend.task.get_cost().eval_obs_cost(xs[0]).sum()):.0f} of "
          f"{PEND_LOOP_STEPS + 1} steps outside 0.2", flush=True)
    if not (torch.isfinite(xs).all() and controls_ok(us, bounds)):
        raise RuntimeError("pendulum receding MPPI loop: a state or a control is not finite or "
                           "bounded")


def check_gp_kernels(gpd, K6, K4, dt):
    """K6 at (4, 1) against its plain version on (c2)'s carry (the first
    MPC step, three iterations in) at every batch size (b2), (c2) and the
    "joint_gp" tune launched it with, and K4 at (4, 1) on (c')'s dense
    expansions at every batch size (c') launched it with. Returns (the
    report rows, failures)."""
    from autompc_torch.sysid.gp import gp_pred_core_cached

    rows, failures = [], []
    c = gauss_reg_carry(gp_pred_core_cached, gpd["c"]["fan"], gpd["c"]["batch"],
                        gpd["c"]["params"], GP_H, gpd["init"])
    by_B = {"b2": gpd["b"]["by_B"], "c2": gpd["c"]["by_B"], "tune": gpd["tune_by_B"]}
    Bs = sorted(set().union(*by_B.values()), reverse=True)
    meas = {}
    for Bc in Bs:
        sc = sub_carry(c, Bc)
        args = (sc["Jx"], sc["Ju"], sc["xs"], sc["us"], sc["cost"]["Qdiag"], sc["cost"]["Rdiag"],
                sc["cost"]["Fdiag"], (0.0,) * 4, dt, 4)
        gk = K6.backward_quad(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp_ = K6.backward_quad_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs = [rel_err(a, b) for a, b in zip(gk, gp_)]
        meas[Bc] = dict(
            max_abs_err=max(abs_err(a, b) for a, b in zip(gk, gp_)),
            ms=time_ms(lambda: K6.backward_quad(*args)),
            device_ms=device_ms(lambda: K6.backward_quad(*args)),
            plain_ms=plain_ms,
            **bound_keys(n_bytes(*args[:7], *gk), Bc * GP_H * (riccati_flops(4, 1) + 4 * 4)),
            launches={k: v.get(Bc, 0) for k, v in by_B.items()},
        )
        print(f"[3] K6 at (4, 1) on the joint GP fan-out's (c2) carry B={Bc} H={GP_H}: rel err "
              f"K/k/lin/quad {[f'{e:.3e}' for e in errs]} (tol {TOL_K6}); kernel "
              f"{meas[Bc]['ms']:.4f} ms (device {meas[Bc]['device_ms']:.4f}), plain "
              f"{plain_ms:.1f} ms, bound {meas[Bc]['bound_ms']:.5f} ms ({meas[Bc]['bound_by']});"
              f" launches {meas[Bc]['launches']}", flush=True)
        if not max(errs) <= TOL_K6:
            failures.append(f"K6 on the GP path B={Bc} rel err {max(errs):.3e} > {TOL_K6}")
    top = dict(meas[Bs[0]])
    top.pop("launches")
    at = {f"at_B{Bc}_H{GP_H}": meas[Bc] for Bc in Bs[1:]}
    for w in at.values():
        w.pop("library_ms")
    launches = {k: sum(v.values()) for k, v in by_B.items()}
    rows.append(dict(name=f"backward_quad[gp,B={Bs[0]},H={GP_H}]", route="cuda",
                     source="autompc_torch/csrc/riccati_quad_bm.cu",
                     replaces="autompc_tpu/ops/pallas_riccati.py:456",
                     launches=sum(launches.values()), launches_gp=launches,
                     launches_by_B=by_B, **top, **at))
    rg = gpd["c'"]
    cr = gauss_reg_carry(gp_pred_core_cached, rg["fan"], rg["batch"], rg["params"], GP_H,
                         gpd["init"])
    k4_meas = {}
    for Bc in sorted(rg["by_B"], reverse=True):
        sc = sub_carry(cr, Bc)
        k4_args = (sc["Jx"], sc["Ju"], *gauss_reg_expansions(sc, rg["S"], rg["mu"], dt))
        row, fails, _, _ = check_k4(f"GP fan-out + GaussReg (c') carry (B={Bc}, H={GP_H})", K4,
                                    k4_args, rg["by_B"][Bc], device_time=True)
        failures += fails
        k4_meas[Bc] = row
    Bs = sorted(k4_meas, reverse=True)
    top = k4_meas[Bs[0]]
    for Bc in Bs[1:]:
        w = {k: v for k, v in k4_meas[Bc].items()
             if k not in ("name", "route", "source", "replaces", "library_ms")}
        top[f"at_B{Bc}_H{GP_H}"] = w
    top.update(name=f"riccati_general[4,1,gp,B={Bs[0]},H={GP_H}]", launches=rg["launches"],
               launches_by_B=rg["by_B"], launches_gp=rg["launches"])
    rows.append(top)
    return rows, failures


def bucket_timed(fn, *args):
    """(the call's result, its wall seconds), the card synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mt_rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def model_tuning_phase(bench, model, trajs, dev, card, wrappers):
    """Phase 17, (a)-(e). ``wrappers`` are K1's batch-major entry, K6 and
    K7, whose launches (d) counts. Returns {"launches", "by_B": (d)'s
    launches and by batch size, "kw": (d)'s fan-out solver keywords,
    "batch": its candidates' diagonals}."""
    from autompc_torch.control import IterativeLQRFactory
    from autompc_torch.costs import QuadCost, QuadCostFactory
    from autompc_torch.evaluation import HoldoutModelEvaluator
    from autompc_torch.parallel import QuadCostFanout
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.sysid import KoopmanFactory, MLPFactory, SINDyFactory
    from autompc_torch.tuning import PipelineTuner, bucketed, model_tuner, pipeline_tuner

    system, task = bench.system, bench.task
    tl = trajs.to_list()
    train, hold = tl[:MT_TRAIN], tl[MT_TRAIN:]

    # (a) the ARX bucket, bench_extra.py's row.
    ks = list(range(1, MT_KMAX + 1))
    arx, build_s = bucket_timed(bucketed.ARXBucketEvaluator, system, train, hold, MT_KMAX,
                                MT_ARX_H)
    _, warm_s = bucket_timed(arx, ks)
    t0 = time.perf_counter()
    for _ in range(MT_ARX_REPS):
        rmses = arx(ks)
    lat = (time.perf_counter() - t0) / MT_ARX_REPS
    tl64 = cpu64_trajs(trajs).to_list()
    ref = bucketed.ARXBucketEvaluator(system, tl64[:MT_TRAIN], tl64[MT_TRAIN:], MT_KMAX,
                                      MT_ARX_H)(ks)
    gaps = [mt_rel(a, b) for a, b in zip(rmses, ref)]
    print(f"[17a] ARX bucket (kmax {MT_KMAX}, horizon {MT_ARX_H}, {len(train)} trajectories "
          f"trained on, {len(hold)} held out): staging {build_s:.3f} s, warm call {warm_s:.3f} s, "
          f"{MT_ARX_REPS} timed calls {lat * 1e3:.2f} ms each -> {len(ks) / lat:.1f} configs/s "
          f"on {card}; RMSEs {[round(v, 6) for v in rmses]}; float64 CPU {[round(v, 6) for v in ref]}"
          f"; relative gap max {max(gaps):.3e} (tol {MT_ARX_TOL}), by k "
          f"{[f'{g:.2e}' for g in gaps]}", flush=True)
    if not all(np.isfinite(rmses)) or max(gaps) > MT_ARX_TOL:
        raise RuntimeError(f"ARX bucket: RMSEs {rmses}, gaps from float64 {gaps}")

    # (b) the other three buckets, and two candidates of each against the
    # per-candidate path.
    ev = HoldoutModelEvaluator(system, tl, "rmse", np.random.default_rng(0), holdout_set=hold)
    if len(ev.training_set) != len(train):
        raise RuntimeError(f"holdout_set matched {len(tl) - len(ev.training_set)} trajectories")
    sindy_cfg = dict(method="lstsq", time_mode="discrete", trig_basis="true", trig_freq=1,
                     trig_interaction="true", poly_basis="false", poly_degree=3,
                     poly_cross_terms="false")

    def per_config(factory, values):
        cfg = factory.get_configuration_space().get_default_configuration()
        for k, v in values.items():
            cfg[k] = v
        return ev(factory, cfg)

    buckets = {
        "SINDy": (lambda: bucketed.SINDyBucketEvaluator(system, train, hold, sindy_cfg),
                  lambda b: b(MT_SINDY_REGS), MT_SINDY_REGS,
                  lambda r: per_config(SINDyFactory(system), dict(
                      sindy_cfg, threshold=r))),
        "Koopman": (lambda: bucketed.KoopmanLassoBucketEvaluator(
                        system, train, hold, dict(poly_basis="false", poly_degree=3,
                                                  trig_basis="false", trig_freq=1,
                                                  product_terms="false")),
                    lambda b: b(MT_KOOPMAN_ALPHAS), MT_KOOPMAN_ALPHAS,
                    lambda a: per_config(KoopmanFactory(system), dict(method="lasso",
                                                                      lasso_alpha=a))),
        "MLP": (lambda: bucketed.MLPBucketEvaluator(system, train, hold, 2, "relu"),
                lambda b: b([w for w, _ in MT_MLP], [lr for _, lr in MT_MLP]), MT_MLP,
                lambda c: per_config(MLPFactory(system), dict(
                    n_hidden_layers="2", nonlintype="relu", hidden_size_1=c[0][0],
                    hidden_size_2=c[0][1], lr=c[1]))),
    }
    for name, (make, call, values, alone) in buckets.items():
        bucket, stage_s = bucket_timed(make)
        scores, wall = bucket_timed(call, bucket)
        checks = []
        for i in (0, len(values) - 1):
            (single, single_s) = bucket_timed(alone, values[i])
            checks.append((i, single, single_s,
                           abs(scores[i] - single) / max(abs(single), MT_RMSE_FLOOR)))
        worst = max(c[3] for c in checks)
        print(f"[17b] {name} bucket, {len(values)} candidates: staging {stage_s:.3f} s, "
              f"training and scoring {wall:.3f} s -> {len(values) / wall:.1f} configs/s on {card}"
              f"; RMSEs {[round(v, 6) for v in scores]}; against the per-candidate path "
              + ", ".join(f"[{i}] {single:.6f} ({single_s:.2f} s, relative gap {g:.2e})"
                          for i, single, single_s, g in checks)
              + f" (tol {MT_AGREE_TOL[name]}, relative to at least {MT_RMSE_FLOOR})", flush=True)
        if not all(np.isfinite(scores)) or worst > MT_AGREE_TOL[name]:
            raise RuntimeError(f"{name} bucket: RMSEs {scores}, per-candidate gaps "
                               f"{[c[3] for c in checks]}")

    # (c) "autoselect": which route scored each candidate.
    routes = {}

    class CountingTuner(model_tuner.ModelTuner):
        def _bucket_runners(self):
            def counted(name, runner):
                def run(cfgs, idxs, costs):
                    before = sum(c is not None for c in costs)
                    runner(cfgs, idxs, costs)
                    routes.setdefault(name, {"bucket": 0, "per_config": 0})
                    routes[name]["bucket"] += sum(c is not None for c in costs) - before
                return run
            return tuple((name, counted(name, r)) for name, r in super()._bucket_runners())

        def _evaluate(self, cfg):
            routes.setdefault(cfg["model"], {"bucket": 0, "per_config": 0})
            routes[cfg["model"]]["per_config"] += 1
            return super()._evaluate(cfg)

    pipeline = Pipeline(system, model, QuadCostFactory(system, goal=np.zeros(4)),
                        IterativeLQRFactory(system, horizon=TUNE_H))
    saved = pipeline_tuner.ModelTuner
    pipeline_tuner.ModelTuner = CountingTuner
    try:
        sel = PipelineTuner(surrogate_mode="autoselect", eval_batch=MT_SEL_BATCH)
        (surr, res), sel_s = bucket_timed(sel._get_surrogate, pipeline, tl,
                                          np.random.default_rng(MT_SEL_SEED), MT_SEL_ITERS)
    finally:
        pipeline_tuner.ModelTuner = saved
    eligible = {}
    for c in res.cfgs:
        if c["model"] != "ApproximateGP" and (c["model"] != "Koopman"
                                              or c["_Koopman:method"] == "lasso"):
            eligible[c["model"]] = eligible.get(c["model"], 0) + 1
    print(f"[17c] autoselect, {MT_SEL_ITERS} candidates in rounds of {MT_SEL_BATCH}: "
          f"{sel_s:.2f} s on {card}; scored by route {routes}; bucket-eligible {eligible}; "
          f"winner {res.inc_cfg.get_dictionary()} (holdout RMSE {res.inc_costs[-1]:.6f}), its "
          f"model {type(surr).__name__}; costs {[round(v, 5) for v in res.costs]}", flush=True)
    quiet = [k for k, n in eligible.items() if n and not routes.get(k, {}).get("bucket")]
    if quiet or not np.isfinite(res.inc_costs[-1]):
        raise RuntimeError(f"autoselect: bucket routes that scored none of their candidates "
                           f"{quiet}; winner's RMSE {res.inc_costs[-1]}")

    # (d) "autotune" end to end, through phase 10's fan-out options.
    goal = np.zeros(4)
    task_d = task.copy()
    task_d.set_num_steps(MT_TUNE_STEPS)
    tuner = PipelineTuner(
        surrogate_mode="autotune", surrogate_factory=SINDyFactory(system), surrogate_split=0.5,
        eval_batch=MT_TUNE_BATCH, use_fanout=True, fanout_backward="pallas",
        fanout_feature_kernels=True, fanout_compact=TUNE_COMPACT)
    kept = {}
    real_get = tuner._get_surrogate

    def keep(*a, **k):
        t0 = time.perf_counter()
        kept["surrogate"], out = real_get(*a, **k)
        kept["s"] = time.perf_counter() - t0
        return kept["surrogate"], out

    tuner._get_surrogate = keep
    for w in wrappers:
        w.launches, w.launches_by_B = 0, {}
    (_, res), tune_s = bucket_timed(lambda: tuner.run(
        pipeline, task_d, trajs, n_iters=MT_TUNE_BATCH, rng=np.random.default_rng(MT_TUNE_SEED),
        surrogate_tune_iters=MT_TUNE_SURR_ITERS))
    launches = {w.__name__: w.launches for w in wrappers}
    by_B = {w.__name__: dict(w.launches_by_B) for w in wrappers}
    costs = np.array(res.costs)
    st = res.surr_tune_result
    print(f"[17d] autotune: the SINDy surrogate from {MT_TUNE_SURR_ITERS} candidates in "
          f"{kept['s']:.2f} s (selected {st.inc_cfg.get_dictionary()}, holdout RMSE "
          f"{st.inc_costs[-1]:.6f}; RMSEs {[round(v, 5) for v in st.costs]}); then "
          f"{MT_TUNE_BATCH} candidates x {MT_TUNE_STEPS - 1} steps (H={TUNE_H}) through the "
          f"fan-out: whole run {tune_s:.2f} s -> {MT_TUNE_BATCH / (tune_s - kept['s']):.1f} "
          f"evals/s on {card}; finite {int(np.isfinite(costs).sum())} / {costs.size}; "
          f"incumbent {res.inc_costs[-1]:.4f}; launches {launches}, by B {by_B}", flush=True)
    if len(costs) != MT_TUNE_BATCH or np.isnan(costs).any() \
            or not np.isfinite(res.inc_costs[-1]):
        raise RuntimeError(f"autotune: scores malformed or no finite incumbent "
                           f"({res.inc_costs[-1]})")
    if min(launches.values()) == 0:
        raise RuntimeError(f"a kernel never ran in the autotune run: {launches}")
    spec = (model.library, "coeffs")
    kw = QuadCostFanout(system, task_d, model, model, horizon=TUNE_H, goal=goal,
                        compact_schedule=TUNE_COMPACT, backward="pallas",
                        feature_spec=spec).solver_kw
    batch = tune_candidates(res.cfgs[:MT_TUNE_BATCH], system, dev)

    # (e) impl="vmap" against impl="batched" on the same candidates.
    task_e = task.copy()
    task_e.set_cost(QuadCost(system, Q=np.eye(4), R=0.01 * np.eye(1), F=np.eye(4), goal=goal))
    task_e.set_init_obs(np.array([0.5, 0.0, 0.0, 0.0]))
    few = {k: v[:MT_VMAP_N] for k, v in batch.items()}
    common = dict(horizon=TUNE_H, n_steps=MT_VMAP_STEPS, goal=goal)
    surr = kept["surrogate"]
    vm, vm_s = bucket_timed(QuadCostFanout(system, task_e, model, surr, impl="vmap",
                                           **common), few)
    bt, bt_s = bucket_timed(QuadCostFanout(system, task_e, model, surr, backward="pallas",
                                           feature_spec=spec, compact_schedule=TUNE_COMPACT,
                                           **common), few)
    vm, bt = vm.cpu().double().numpy(), bt.cpu().double().numpy()
    rel = [mt_rel(a, b) for a, b in zip(vm, bt)]
    agree = sum((a == b) or (np.isfinite(a) and np.isfinite(b) and r <= SEQ_TOL)
                for a, b, r in zip(vm, bt, rel))
    print(f"[17e] QuadCostFanout impl='vmap' ({MT_VMAP_N} single-lane closed loops, "
          f"{MT_VMAP_STEPS} steps) {vm_s:.2f} s, impl='batched' {bt_s:.2f} s on {card}; scores "
          f"vmap {[round(float(v), 4) for v in vm]}, batched {[round(float(v), 4) for v in bt]}; "
          f"relative "
          f"differences {[f'{r:.2e}' for r in rel]}; {agree} of {MT_VMAP_N} within {SEQ_TOL} "
          f"(min {MT_VMAP_AGREE_MIN})", flush=True)
    if agree < MT_VMAP_AGREE_MIN:
        raise RuntimeError(f"impl='vmap' and 'batched' agree on {agree} of {MT_VMAP_N}")
    return dict(launches=launches, by_B=by_B, kw=kw, batch=batch)


def pendulum_setup():
    """Phase 18 (a)'s pendulum: the benchmark, its data (50 x 100, seed
    42, on the card), the SINDy fit (phase 2's options), the support, the
    quadratic cost (Q = F = diag(PD_Q), R = PD_R) and the lanes-last
    solver's options. Returns them in a dict."""
    from autompc_torch.benchmarks import PendulumSwingupBenchmark
    from autompc_torch.costs import QuadCost
    from autompc_torch.sysid import SINDy

    pb = PendulumSwingupBenchmark()
    t0 = time.perf_counter()
    pm = SINDy(pb.system, **SINDY_KW)
    ptrajs = pb.gen_trajs_batch(seed=42, n_trajs=50, traj_len=100)
    pm.train(ptrajs)
    coeffs = pm.coeffs.cpu().numpy()
    if not np.isfinite(coeffs).all():
        raise RuntimeError("pendulum SINDy fit produced non-finite coefficients")
    active = tuple(int(k) for k in np.flatnonzero(np.any(coeffs != 0, axis=0)))
    torch.cuda.synchronize()
    print(f"[18a] pendulum data 50x100 + SINDy fit: {time.perf_counter() - t0:.2f} s; support "
          f"{len(active)} of {coeffs.shape[1]} features: "
          f"{[pm.library.names[k] for k in active]}", flush=True)
    qd = np.diag(PD_Q)
    pcost = QuadCost(pb.system, qd, PD_R * np.eye(1), qd, goal=np.zeros(2))
    bounds = pb.task.get_ctrl_bounds()
    common = dict(ds=2, dc=1, obsdim=2, dt=pb.system.dt, ubounds=(bounds[:, 0], bounds[:, 1]),
                  backward="pallas", feature_spec=(pm.library, "coeffs"), fuse_ls=True,
                  lanes_last=True, feature_mask=active)
    return dict(pb=pb, pm=pm, ptrajs=ptrajs, pcost=pcost, common=common, active=active)


def shapes_phase(dev, card, mods, hc, hc_trajs):
    """Phase 18: (a) the pendulum's main path and closed loop, (b) its
    cost fan-out in both configurations, (c) its "ilqr" tune, (d) the
    halfcheetah's SINDy through the batch-major solve. ``mods`` are the
    kernel modules (K1, K2, K3, K4); ``hc`` and ``hc_trajs`` phase 6's
    benchmark and data. Each path's kernels are counted from 0 just
    before it and read just after. Returns what phase [3]'s checks of the
    new instances read."""
    from autompc_torch.benchmarks.pendulum import RECOVERY_SPREAD
    from autompc_torch.control import (make_receding_ilqr_loop, make_scheduled_ilqr_solver,
                                       parse_schedule)
    from autompc_torch.costs import QuadCost
    from autompc_torch.utils.profiling import timeit_distinct

    K1, K2, K3, K4 = mods
    t_phase = time.perf_counter()
    f32 = dict(dtype=torch.float32, device=dev)
    sp = {}

    # ---- (a) the pendulum's main path: K1, K2, K3 at (2, 1) ----------------
    pd = pendulum_setup()
    pb, pm, ptrajs, pcost, common, active = (
        pd[k] for k in ("pb", "pm", "ptrajs", "pcost", "common", "active"))
    bounds = pb.task.get_ctrl_bounds()
    ll = (K1.relin_jacobians, K2.backward_quad_ll, K3.fused_line_search)
    rng = np.random.default_rng(0)

    def draw(n):
        return torch.as_tensor(rng.uniform(-1, 1, (n, 2)) * np.array([np.pi, 1.0]), **f32)

    reset_launches(ll)
    solve = make_scheduled_ilqr_solver(pm.pred_core, pcost, H=H,
                                       schedule=parse_schedule(SCHEDULE), **common)
    ug = torch.zeros((B_SOLVE, H, 1), **f32)
    x0 = draw(B_SOLVE)
    t0 = time.perf_counter()
    solve(pm.params, x0, ug)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    solve(pm.params, x0 - 0.01, ug)
    pool = [draw(B_SOLVE) for _ in range(3)]
    torch.cuda.synchronize()
    conv = []
    t0 = time.perf_counter()
    for x0r in pool:
        out = solve(pm.params, x0r, ug)
        conv.append(out[0].float().mean())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if tuple(out[1].shape) != (B_SOLVE, H + 1, 2) or not torch.isfinite(out[1]).all():
        raise RuntimeError(f"pendulum solve malformed or not finite: {tuple(out[1].shape)}")
    solve_launches = {w.__name__: w.launches for w in ll}
    print(f"[18a] pendulum scheduled lanes-last solve B={B_SOLVE} H={H}: first run "
          f"{first_s:.2f} s; 3 timed runs {elapsed:.3f} s -> {B_SOLVE * 3 / elapsed:.1f} "
          f"solves/s on {card}; open-loop converged {float(torch.stack(conv).mean()):.4f}; "
          f"launches {solve_launches}", flush=True)
    run_cl = make_receding_ilqr_loop(pm.pred_core, pcost, pb.dynamics, H=PD_CL_H,
                                     n_steps=PD_CL_STEPS, **common)
    x0_cl = torch.as_tensor(np.random.default_rng(7).uniform(
        -RECOVERY_SPREAD, RECOVERY_SPREAD, (PD_CL_B, 2)), **f32)
    t0 = time.perf_counter()
    xs_cl, us_cl, nconv = run_cl(pm.params, x0_cl)
    torch.cuda.synchronize()
    t_cl = time.perf_counter() - t0
    if not (torch.isfinite(xs_cl).all() and torch.isfinite(us_cl).all()):
        raise RuntimeError("pendulum closed loop produced non-finite states or controls")
    if (us_cl.abs() > float(bounds[0, 1]) + 1e-6).any():
        raise RuntimeError("pendulum closed loop: a control outside its bounds")
    fx = xs_cl[:, -1]
    box = ((fx[:, 0].abs() < 0.2) & (fx[:, 1].abs() < 0.2)).float().mean().item()
    wrapped = torch.remainder(fx[:, 0] + np.pi, 2 * np.pi) - np.pi
    box_mod = ((wrapped.abs() < 0.2) & (fx[:, 1].abs() < 0.2)).float().mean().item()
    cl_launches = {w.__name__: w.launches - solve_launches[w.__name__] for w in ll}
    print(f"[18a] pendulum closed loop {PD_CL_B} starts within {RECOVERY_SPREAD} of upright x "
          f"{PD_CL_STEPS} steps "
          f"(H={PD_CL_H}): {t_cl:.2f} s ({t_cl / PD_CL_STEPS * 1e3:.1f} ms a step); ending in the "
          f"task's 0.2 box {box:.4f} (theta taken modulo 2 pi: {box_mod:.4f}; not gated); solver "
          f"converged {nconv.float().mean().item() / PD_CL_STEPS:.4f} of steps; launches "
          f"{cl_launches}", flush=True)
    a_launches = {w.__name__: w.launches for w in ll}
    if min(solve_launches.values()) == 0 or min(cl_launches.values()) == 0:
        raise RuntimeError(f"a kernel never ran on the pendulum's main path: solves "
                           f"{solve_launches}, closed loop {cl_launches}")
    sp.update(pb=pb, pm=pm, ptrajs=ptrajs, pcost=pcost, common=common, active=active, x0_cl=x0_cl,
              a_launches=a_launches, a_solve=solve_launches, a_loop=cl_launches)

    # ---- (b) the pendulum's cost fan-out, both configurations --------------
    from autompc_torch.parallel import QuadCostFanout

    batch = fanout_candidates(dev, FAN_B, obsdim=2)
    wrappers = {"a": ll, "b": (K1.relin_jacobians_bm, K2.backward_quad, K3.sindy_line_search)}
    counts, by_B, solver_kw = {}, {}, {}
    for cfg in FAN_CONFIGS:
        fan = QuadCostFanout(pb.system, pb.task, pm, pm, horizon=FAN_H, n_steps=PD_FAN_STEPS,
                             goal=np.zeros(2), compact_schedule=FAN_SCHEDULE,
                             feature_spec=(pm.library, "coeffs"), **FAN_CONFIGS[cfg])
        solver_kw[cfg] = fan.solver_kw
        reset_launches(wrappers[cfg])
        t0 = time.perf_counter()
        scores = fan(batch)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(FAN_CALLS):
            scores = fan(batch)
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts[cfg] = {w.__name__: w.launches for w in wrappers[cfg]}
        by_B[cfg] = {w.__name__: dict(w.launches_by_B) for w in wrappers[cfg]
                     if hasattr(w, "launches_by_B")}
        if tuple(scores.shape) != (FAN_B,) or torch.isnan(scores).any():
            raise RuntimeError(f"pendulum fan-out ({cfg}): malformed or NaN scores")
        fin = torch.isfinite(scores)
        print(f"[18b] pendulum fan-out ({cfg}) {FAN_CONFIGS[cfg]}: B={FAN_B} H={FAN_H} "
              f"{PD_FAN_STEPS} steps: warm call {warm_s:.2f} s; {FAN_CALLS} timed calls "
              f"{elapsed:.3f} s -> {FAN_CALLS * FAN_B / elapsed:.1f} evals/s on {card}; scores "
              f"finite {int(fin.sum())}, mean {float(scores[fin].mean()):.2f}; launches in "
              f"{FAN_CALLS + 1} calls {counts[cfg]}, by B {by_B[cfg]}", flush=True)
        if min(counts[cfg].values()) == 0:
            raise RuntimeError(f"a kernel never ran on the pendulum fan-out ({cfg}): "
                               f"{counts[cfg]}")
    x0f = batch["Qdiag"].new_tensor(np.tile(PD_FAN_X0, (FAN_B, 1)))
    ugf = x0f.new_zeros((FAN_B, FAN_H, 1))
    outs = {cfg: make_scheduled_ilqr_solver(
        pm.pred_core, None, schedule=parse_schedule(FAN_SCHEDULE), **solver_kw[cfg]
    )(pm.params, x0f, ugf, batch) for cfg in FAN_CONFIGS}
    obj = {cfg: lane_objective(o[1], o[2], batch, pb.system.dt) for cfg, o in outs.items()}
    both = outs["a"][0] & outs["b"][0]
    rel = ((obj["a"] - obj["b"]).abs() / obj["b"].abs().clamp_min(1e-30))[both]
    share = float((rel <= FAN_OBJ_TOL).float().mean()) if both.any() else 0.0
    print(f"[18b] first MPC step from {PD_FAN_X0}, (a) vs (b): converged (a) {int(outs['a'][0].sum())}, (b) "
          f"{int(outs['b'][0].sum())}, both {int(both.sum())} of {FAN_B}; accepted objectives "
          f"within {FAN_OBJ_TOL} on {share:.4f} (min {FAN_AGREE_MIN}; median "
          f"{float(rel.median()) if both.any() else float('nan'):.3e})", flush=True)
    if int(both.sum()) < FAN_B // 4 or share < FAN_AGREE_MIN:
        raise RuntimeError(f"pendulum fan-out first step: {int(both.sum())} lanes converged "
                           f"in both, objectives agree on {share:.4f}")
    sp.update(fan_batch=batch, fan_kw=solver_kw, fan_counts=counts, fan_by_B=by_B)

    # ---- (c) the pendulum's "ilqr" tune ------------------------------------
    from autompc_torch.control import IterativeLQRFactory
    from autompc_torch.costs import QuadCostFactory
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.tuning import PipelineTuner

    system = pb.system
    task = pb.recovery_task(num_steps=PD_TUNE_STEPS)
    tw = wrappers["b"]
    reset_launches(tw)
    pipeline = Pipeline(system, pm, QuadCostFactory(system, goal=np.zeros(2)),
                        IterativeLQRFactory(system, horizon=TUNE_H))
    t0 = time.perf_counter()
    _, res = PipelineTuner(
        surrogate_mode="pretrain", eval_batch=PD_TUNE_BATCH, use_fanout=True,
        fanout_backward="pallas", fanout_feature_kernels=True, fanout_compact=TUNE_COMPACT,
    ).run(pipeline, task, ptrajs, n_iters=PD_TUNE_BATCH, rng=np.random.default_rng(100),
          surrogate=pm, truedyn=pb.dynamics)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    t_launches = {w.__name__: w.launches for w in tw}
    t_by_B = {w.__name__: dict(w.launches_by_B) for w in tw}
    costs, true_costs = np.array(res.costs), np.array(res.truedyn_costs)
    print(f"[18c] pendulum 'ilqr' tune, one round of {PD_TUNE_BATCH} (H={TUNE_H}, "
          f"{PD_TUNE_STEPS - 1} steps, both fan-outs): {tune_s:.2f} s -> "
          f"{PD_TUNE_BATCH / tune_s:.1f} evals/s with both fan-outs on {card}; scores finite "
          f"{int(np.isfinite(costs).sum())} / {costs.size}, true dynamics "
          f"{int(np.isfinite(true_costs).sum())}; incumbent {res.inc_cfg.get_dictionary()} "
          f"(surrogate {res.inc_costs[-1]:.1f}, true {res.inc_truedyn_costs[-1]:.1f}); launches "
          f"{t_launches}, by B {t_by_B}", flush=True)
    if len(costs) != PD_TUNE_BATCH or np.isnan(costs).any() or np.isnan(true_costs).any():
        raise RuntimeError("pendulum tune: a score is missing or NaN")
    if min(t_launches.values()) == 0:
        raise RuntimeError(f"a kernel never ran in the pendulum tune: {t_launches}")
    seq_task = pb.task.copy()
    seq_task.set_cost(QuadCost(system, Q=np.eye(2), R=0.01 * np.eye(1), F=np.eye(2),
                               goal=np.zeros(2)))
    seq_task.set_init_obs(np.array(PD_SEQ_X0))
    seq_task.set_num_steps(SEQ_STEPS)
    free = Pipeline(system, pm, QuadCostFactory(system, goal=np.zeros(2)),
                    IterativeLQRFactory(system))
    t0 = time.perf_counter()
    agree, same_cfgs = seq_against_fanout("18c", free, seq_task, ptrajs, SEQ_ITERS, surrogate=pm)
    print(f"[18c] sequential vs fan-out ({SEQ_STEPS}-step near-upright task, quadratic task "
          f"cost): {agree} of {SEQ_ITERS} within {SEQ_TOL} (min {SEQ_AGREE_MIN}); same "
          f"configurations {same_cfgs}; {time.perf_counter() - t0:.2f} s", flush=True)
    if agree < SEQ_AGREE_MIN or not same_cfgs:
        raise RuntimeError(f"pendulum tune: sequential and fan-out agree on {agree} of "
                           f"{SEQ_ITERS}")
    from autompc_torch.parallel import QuadCostFanout as _Fan

    sp.update(tune_launches=t_launches, tune_by_B=t_by_B, tune_batch=tune_candidates(
        res.cfgs[:PD_TUNE_BATCH], system, dev),
        tune_kw=_Fan(system, task, pm, pm, horizon=TUNE_H, goal=np.zeros(2),
                     compact_schedule=TUNE_COMPACT, backward="pallas",
                     feature_spec=(pm.library, "coeffs")).solver_kw)

    # ---- (d) the halfcheetah's SINDy: K1's batch-major entry, K4, K7 at (18, 6)
    t0 = time.perf_counter()
    h = cheetah_sindy(hc, hc_trajs)
    hm, hcost, hkw, h_active = h["hm"], h["hcost"], h["hkw"], h["h_active"]
    torch.cuda.synchronize()
    print(f"[18d] cheetah SINDy fit ({hm.library.n_features} terms, poly degree 2): "
          f"{time.perf_counter() - t0:.2f} s; support {len(h_active)}; coefficients finite",
          flush=True)
    bm = (K1.relin_jacobians_bm, K4.riccati_general, K3.sindy_line_search)
    reset_launches(bm)
    hsolve = make_scheduled_ilqr_solver(hm.pred_core, hcost, H=H_HC, max_iter=50,
                                        schedule=parse_schedule(HC_SCHEDULE), **hkw)
    hx0 = cheetah_x0(dev)
    hug = torch.zeros((B_HC, H_HC, 6), **f32)
    inputs = [(hm.params, hx0 + 0.001 * (r + 1), hug) for r in range(5)]
    t0 = time.perf_counter()
    lat, hout = timeit_distinct(hsolve, inputs, silent=True)
    total_s = time.perf_counter() - t0
    if tuple(hout[1].shape) != (B_HC, H_HC + 1, 18) or tuple(hout[2].shape) != (B_HC, H_HC, 6):
        raise RuntimeError(f"cheetah SINDy solve malformed: {tuple(hout[1].shape)}")
    if not all(torch.isfinite(o[hout[0]]).all() for o in hout[1:]):
        raise RuntimeError("cheetah SINDy solve: non-finite output on a converged lane")
    h_conv = hout[0].float().mean().item()
    h_finite = torch.isfinite(hout[1]).all(dim=(1, 2)).float().mean().item()
    d_launches = {w.__name__: w.launches for w in bm}
    print(f"[18d] cheetah SINDy batch-major solve with its feature_spec B={B_HC} H={H_HC} "
          f"(18, 6): first run {total_s - 4 * lat:.2f} s; 4 timed runs {4 * lat:.3f} s -> "
          f"{B_HC / lat:.1f} solves/s on {card}; open-loop converged {h_conv:.4f}; lanes "
          f"finite {h_finite:.4f} (not gated: K4's Cholesky is unguarded); launches "
          f"{d_launches}", flush=True)
    if min(d_launches.values()) == 0:
        raise RuntimeError(f"a kernel never ran on the cheetah SINDy path: {d_launches}")
    sp.update(hm=hm, hcost=hcost, hkw=hkw, h_active=h_active, d_launches=d_launches,
              d_by_B={w.__name__: dict(w.launches_by_B) for w in bm})
    print(f"[18] phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    return sp


def check_shape_kernels(sp, mods, failures):
    """Phase [3] on phase 18's instances: K1 (both entries), K2, K3, K6
    and K7 at (2, 1) and K1's batch-major entry and K7 at (18, 6) against
    their plain versions, as the (4, 1) rows are held: K1-K3 on the
    pendulum's main-path carry after make_carry0 (B=4096, H=200), on its
    closed loop's first carry (B=256, H=20) and on fan-out (a)'s carry
    after three iterations (B=1,024, H=10, per-lane planes); K1's
    batch-major entry, K6 and K7 on fan-out (b)'s carry at every batch
    size (b) launched them with and on the tune's carry at every batch
    size the tune launched them with; K1's batch-major entry and K7 (on
    the carry's gains) on the cheetah SINDy solve's carry after three
    iterations (B=1024, H=200). Appends to ``failures``; returns the
    kernels line's rows."""
    from autompc_torch.control import make_batched_ilqr_solver

    K1, K2, K3, K4 = mods
    pm, pcost, common, pb = sp["pm"], sp["pcost"], sp["common"], sp["pb"]
    dev = pm.coeffs.device
    dt = pb.system.dt
    terms = tuple(pm.library.terms[k] for k in sp["active"])
    ca = pm.coeffs[:, list(sp["active"])].contiguous()
    alphas = tuple(0.2 ** k for k in range(10))
    bound = float(pb.task.get_ctrl_bounds()[0, 1])
    ctx = PhaseCtx(terms=terms, ca=ca, dt=dt, lo=-bound, hi=bound, alphas=alphas, dev=dev,
                   failures=failures, K1=K1, K2=K2, K3=K3)
    rows = []
    tag = "2x1"
    # K1-K3 on the main path's carry (a row each), the closed loop's and
    # fan-out (a)'s (``at_*`` keys, each with its launches).
    _, carry0, _, make_body = make_batched_ilqr_solver(pm.pred_core, pcost, H=H,
                                                       return_pieces=True, **common)
    # The starts around the rest state (PD_KERNEL_SPREAD): from anywhere
    # on the circle a 200-step float32 rollout under the first
    # iteration's gains amplifies rounding so far that no float32 order
    # meets TOL_K3 normwise (tools/torch_pendulum_conditioning.py), so K3
    # is held normwise, as on the (4, 1) main-path carry, where it is not.
    rng = np.random.default_rng(1)
    x0 = torch.as_tensor(np.array([np.pi, 0.0]) + rng.uniform(
        -PD_KERNEL_SPREAD, PD_KERNEL_SPREAD, (B_KERNEL, 2)), dtype=torch.float32, device=dev)
    c = carry0(pm.params, x0, x0.new_zeros((B_KERNEL, H, 1)))
    diag = (PD_Q, (PD_R,), PD_Q, (0.0, 0.0))
    a_solve = sp["a_solve"]
    once = dict(reps=1, warm=0)
    r1 = check_k1_ll(ctx, f"pendulum main-path carry ({tag})", c, a_solve["relin_jacobians"],
                     plain=once)
    rk = k2_k3_rows_ll(ctx, check_k2_k3_ll(ctx, f"fixed cost, pendulum main-path carry ({tag})",
                                           c, diag, plain=once), c, "fixed cost", a_solve,
                       plain=once)
    main_rows = [r1] + rk
    for r in main_rows:
        r["name"] = r["name"].replace("[", f"[{tag},", 1)
    _, carry_g, _, _ = make_batched_ilqr_solver(pm.pred_core, pcost, H=PD_CL_H,
                                                return_pieces=True, **common)
    cg = carry_g(pm.params, sp["x0_cl"], sp["x0_cl"].new_zeros((PD_CL_B, PD_CL_H, 1)))
    gate = [check_k1_ll(ctx, f"pendulum closed-loop carry ({tag})", cg,
                        sp["a_loop"]["relin_jacobians"])]
    gate += k2_k3_rows_ll(ctx, check_k2_k3_ll(ctx, f"fixed cost, pendulum closed-loop carry "
                                                   f"({tag})", cg, diag), cg, "fixed cost",
                          sp["a_loop"])
    batch = sp["fan_batch"]
    x0f = batch["Qdiag"].new_tensor(np.tile(pb.task.get_init_obs(), (FAN_B, 1)))

    def fan_carry(cfg):
        _, c0, _, body_ = make_batched_ilqr_solver(pm.pred_core, None, return_pieces=True,
                                                   **sp["fan_kw"][cfg])
        cc, body = c0(pm.params, x0f, x0f.new_zeros((FAN_B, FAN_H, 1)), batch), body_(pm.params)
        for _ in range(3):
            cc = body(cc)
        return cc

    cfa = fan_carry("a")
    fan_cost = (*(cfa["cost"][k] for k in ("Qdiag", "Rdiag", "Fdiag")), (0.0, 0.0))
    fan_rows = [check_k1_ll(ctx, f"pendulum fan-out (a) carry ({tag})", cfa,
                            sp["fan_counts"]["a"]["relin_jacobians"])]
    fan_rows += k2_k3_rows_ll(ctx, check_k2_k3_ll(
        ctx, f"per-lane cost, pendulum fan-out (a) carry ({tag})", cfa, fan_cost,
        agree_min=K3_FAN_AGREE_MIN, within_min=K3_FAN_WITHIN_MIN), cfa, "per-lane cost",
        sp["fan_counts"]["a"])
    for r, g, f in zip(main_rows, gate, fan_rows):
        base = r["name"].split("[")[0]
        r[f"launches_B{B_SOLVE}_H{H}"] = a_solve[base]
        r["launches"] = sp["a_launches"][base]
        for key, w in ((f"at_B{PD_CL_B}_H{PD_CL_H}", g), (f"at_B{FAN_B}_H{FAN_H}", f)):
            r[key] = {k: v for k, v in w.items()
                      if k not in ("name", "route", "source", "replaces", "library_ms")}
        r["launches_fanout_a"] = sp["fan_counts"]["a"][base]
    rows += main_rows

    # K1's batch-major entry, K6 and K7 on fan-out (b)'s and the tune's carries.
    cfb = fan_carry("b")
    fan_by_B = sp["fan_by_B"]["b"]
    fan_Bs = sorted({b for d in fan_by_B.values() for b in d}, reverse=True)
    k67 = {}
    for Bs in fan_Bs:
        sub = {k: cfb[k][:Bs].contiguous() for k in ("x0s", "xs", "us", "Jx", "Ju")}
        k67[Bs], fails = check_fanout_kernels(
            f"pendulum fan-out (b) carry ({tag})", K1, K2, K3, terms, ca, sub,
            {k: v[:Bs] for k, v in batch.items()}, (0.0, 0.0), dt, alphas, bound)
        failures += fails
    tune_Bs = sorted({b for d in sp["tune_by_B"].values() for b in d}, reverse=True)
    _, tc0, _, tbody_ = make_batched_ilqr_solver(pm.pred_core, None, return_pieces=True,
                                                 **sp["tune_kw"])
    tb = sp["tune_batch"]
    n = tb["Qdiag"].shape[0]
    x0t = tb["Qdiag"].new_tensor(np.tile(pb.task.get_init_obs(), (n, 1)))
    ct, tbody = tc0(pm.params, x0t, x0t.new_zeros((n, TUNE_H, 1)), tb), tbody_(pm.params)
    for _ in range(3):
        ct = tbody(ct)
    k67t = {}
    for Bs in tune_Bs:
        sub = {k: ct[k][:Bs].contiguous() for k in ("x0s", "xs", "us", "Jx", "Ju")}
        k67t[Bs], fails = check_fanout_kernels(
            f"pendulum tune carry ({tag})", K1, K2, K3, terms, ca, sub,
            {k: v[:Bs] for k, v in tb.items()}, (0.0, 0.0), dt, alphas, bound)
        failures += fails
    for k, (name, source, replaces) in enumerate((
        ("relin_jacobians_bm", "autompc_torch/csrc/relin.cu",
         "autompc_tpu/ops/pallas_relin.py:192"),
        ("backward_quad", "autompc_torch/csrc/riccati_quad_bm.cu",
         "autompc_tpu/ops/pallas_riccati.py:456"),
        ("sindy_line_search", "autompc_torch/csrc/sindy_linesearch.cu",
         "autompc_tpu/ops/pallas_linesearch.py:191"),
    )):
        at = {f"at_B{Bs}_H{FAN_H}": dict(k67[Bs][k], launches=fan_by_B[name].get(Bs, 0))
              for Bs in fan_Bs[1:]}
        at.update({f"at_B{Bs}_H{TUNE_H}_tune": dict(
            k67t[Bs][k], launches=sp["tune_by_B"][name].get(Bs, 0)) for Bs in tune_Bs})
        for w in at.values():
            w.pop("library_ms")
        rows.append(dict(
            name=f"{name}[{tag},B={FAN_B},H={FAN_H}]", route="cuda", source=source,
            replaces=replaces, launches=sp["fan_counts"]["b"][name], launches_by_B=fan_by_B[name],
            launches_tune=sp["tune_launches"][name], launches_tune_by_B=sp["tune_by_B"][name],
            **k67[FAN_B][k], **at))

    # K1's batch-major entry and K7 at (18, 6) on the cheetah SINDy carry.
    hm, hkw = sp["hm"], sp["hkw"]
    hterms = tuple(hm.library.terms[k] for k in sp["h_active"])
    hca = hm.coeffs[:, list(sp["h_active"])].contiguous()
    _, hc0, _, hbody_ = make_batched_ilqr_solver(hm.pred_core, sp["hcost"], H=H_HC,
                                                 return_pieces=True, **hkw)
    hx0 = cheetah_x0(dev)
    ch, hbody = hc0(hm.params, hx0, hx0.new_zeros((B_HC, H_HC, 6))), hbody_(hm.params)
    for _ in range(3):
        ch = hbody(ch)
    hbound = np.asarray(hkw["ubounds"][1], dtype=np.float64)
    h_rows, fails = check_fanout_kernels(
        "cheetah SINDy carry (18x6)", K1, None, K3, hterms, hca,
        {k: ch[k].contiguous() for k in ("x0s", "xs", "us", "Jx", "Ju")}, None, None,
        sp["hkw"]["dt"], alphas, hbound, gains=(ch["Ks"].contiguous(), ch["ks"].contiguous()),
        # K7's plain version takes seconds a call at this shape: timed once,
        # the check's own call its warm-up.
        plain=dict(reps=1, warm=0))
    failures += fails
    for meas, (name, source, replaces) in zip(h_rows, (
        ("relin_jacobians_bm", "autompc_torch/csrc/relin.cu",
         "autompc_tpu/ops/pallas_relin.py:192"),
        ("sindy_line_search", "autompc_torch/csrc/sindy_linesearch.cu",
         "autompc_tpu/ops/pallas_linesearch.py:191"),
    )):
        rows.append(dict(name=f"{name}[18x6,B={B_HC},H={H_HC}]", route="cuda", source=source,
                         replaces=replaces, launches=sp["d_launches"][name],
                         launches_by_B=sp["d_by_B"][name], **meas))
    return rows


# ---- Phase 19: the remaining kernels at every (ds, dc) ---------------------------------

# Phase 19: K4 from dense expansions at shapes no earlier path gave it,
# the per-lane K1/K3/K7 instances off (4, 1), K8/K9 and K2's 4D entry at
# (2, 1), each through the entry points a user calls. (a) phase 15's
# joint-Koopman cell (the cartpole, JK_BASIS: lift (12, 1), B=JK_B,
# H=JK_H, JK_SCHEDULE) with the GaussReg term (phase 13's S, mu of the
# main path's data and a regw a lane, 10**U(-3, 4) from GR_SEED), cut to
# DS_JK_STEPS closed-loop steps (JK_STEPS uncut), backward "scan" and
# "pallas" (K4 at (12, 1)) on the same batch, one warm and one timed call
# each, their first MPC-step solves compared as phase 8's; then the
# Koopman space's basis DS_JK_BASIS2 (polynomials to degree 2: lift
# (8, 1)) under "pallas" at DS_JK2_B lanes, DS_JK2_STEPS steps. (b) the
# "joint_mlp" tune on the pendulum (data 50 x 100, seed 42, the recovery
# task from (0.15, 0) at DS_TUNE_STEPS - 1 steps, phase 11's MLP pin and
# epochs, the horizon mask on, fanout_backward "pallas": K4 at (2, 1) on
# the masked per-lane expansions; the per-lane MLPs take no MLP line
# search, K5, as in the JAX package): one round
# of DS_TUNE_ITERS candidates, then sequential against fan-out on them
# at DS_SEQ_STEPS - 1 steps (their nets trained DS_SEQ_EPOCHS epochs).
# (c) JointSINDyQuadCostFanout on phase 18's pendulum data in phase 12's
# two configurations ((a) lanes-last: per-lane K1 and K3, K2; (b)
# batch-major: per-lane K1 batch-major entry and K7, K6) at JS_B, JS_H,
# DS_JS_STEPS steps (phase 12's bucket at d = 3: 21 terms, the small
# trees) and DS_JS_BIG (trig to frequency 4: 75 terms, the large trees)
# at JS_BIG_B, DS_JS_BIG_STEPS; the first-step agreement of (a) and (b)
# from PD_FAN_X0; then the "joint_sindy" tune, one round of
# DS_TUNE_ITERS with fanout_feature_kernels, and sequential against
# fan-out at DS_SEQ_STEPS - 1 steps. (d) phase 18 (a)'s solve (B_SOLVE, H, SCHEDULE, at most
# DS_WIDE_ITERS iterations) in its default body, with ls_wide=True (K8,
# K9) and with AMPC_BQ_WIDE_IO=reshape (K2's 4D entry), 3 timed runs
# each on the same draws: solves/s, converged fraction and the share of
# lanes converged in both whose accepted objectives agree within
# FAN_OBJ_TOL (gate FAN_AGREE_MIN: two float32 bodies part on a few
# lanes, ROADMAP hazard 7); ll must be the default's bits.
DS_JK_STEPS = 10
DS_JK_BASIS2 = dict(poly_basis=True, poly_degree=2)
DS_JK2_B, DS_JK2_STEPS = 128, 5
# DS_TUNE_STEPS: 10 since phase 20 was added [20].
DS_TUNE_ITERS, DS_TUNE_STEPS = 4, 10
# The sequential checks of (b) and (c) run DS_SEQ_STEPS - 1 steps (the
# sequential objective is a host loop of single-lane solves: at 19 steps
# the two checks took 79.3 s of the phase's 114.2 on an NVIDIA H100 80GB
# HBM3, 700 W). The joint-MLP one trains DS_SEQ_EPOCHS epochs: the
# per-lane masked max-width training and MLP.train's unpadded one are one
# function (within 1e-12 in float64 at 20 epochs), but their float32
# roundings part further each epoch, and a closed loop on the pendulum
# turns that into 1-46% (`python3 tools/torch_joint_mlp_seq_check.py`,
# CPU: 0 of 4 within SEQ_TOL at 20 epochs, all 4 at 1).
DS_SEQ_STEPS, DS_SEQ_EPOCHS = 10, 1
DS_JS_STEPS = 10
DS_JS_BIG = dict(JS_BUCKET, trig_freq=4)
DS_JS_BIG_STEPS = 5
DS_WIDE_ITERS = 50
# The shapes phase 19 builds at first use beside phase 18's.
SHAPES_19 = (("riccati_general", 12, 1), ("riccati_general", 2, 1), ("riccati_general", 8, 1),
             ("ls_obj_wide", 2, 1), ("ls_reroll_wide", 2, 1))


def capture_k4(K4, pred_core, solver_kw, params, x0, cp, n_iters=3):
    """K4's inputs on a path: the batch-major solver's carry after
    ``n_iters`` iterations from ``x0`` (a zero control guess), then the
    next iteration's backward pass captured (its plain version runs in
    its place). Returns the eight input tensors."""
    from autompc_torch.control import ilqr, make_batched_ilqr_solver

    _, carry0, _, make_body = make_batched_ilqr_solver(pred_core, None, return_pieces=True,
                                                       **solver_kw)
    B = x0.shape[0]
    carry = carry0(params, x0, x0.new_zeros((B, solver_kw["H"], solver_kw["dc"])), cp)
    body = make_body(params)
    for _ in range(n_iters):
        carry = body(carry)
    captured = []

    def capture(*args):
        captured.append(tuple(a.contiguous() for a in args))
        return K4.riccati_general_plain(*args)

    real = ilqr.riccati_general
    ilqr.riccati_general = capture
    try:
        body(carry)
    finally:
        ilqr.riccati_general = real
    return captured[0]


def k4_counts(K4):
    return K4.riccati_general.launches, dict(K4.riccati_general.launches_by_B)


def reset_k4(K4):
    K4.riccati_general.launches, K4.riccati_general.launches_by_B = 0, {}


def seq_against_fanout(tag, pipeline, task, trajs, n, **kw):
    """The tuner's sequential objective against its fan-out on the same
    ``n`` candidates (phase 10's rule): prints each pair, returns the
    number within SEQ_TOL and whether both drew the same
    configurations."""
    from autompc_torch.tuning import PipelineTuner

    scores = [PipelineTuner(surrogate_mode="pretrain", eval_batch=n, **k).run(
        pipeline, task, trajs, n_iters=n, rng=np.random.default_rng(3), **kw)[1]
        for k in ({}, dict(use_fanout=True, fanout_backward="pallas",
                           fanout_feature_kernels=True))]
    agree = 0
    for i, (cfg, a, b) in enumerate(zip(scores[0].cfgs, scores[0].costs, scores[1].costs)):
        ok = (a == b) or (np.isfinite(a) and np.isfinite(b)
                          and abs(a - b) <= SEQ_TOL * max(abs(b), 1e-30))
        agree += ok
        print(f"[{tag}] candidate {i} (horizon {cfg['_ctrlr:horizon']}): sequential {a!r}, "
              f"fan-out {b!r}{'' if ok else ' DIFFER'}", flush=True)
    same = [c.get_dictionary() for c in scores[0].cfgs] == \
        [c.get_dictionary() for c in scores[1].cfgs]
    return agree, same


def dense_shapes_phase(dev, card, mods, sp, bench, model, trajs, jk_steps=DS_JK_STEPS):
    """Phase 19 (a)-(d); ``mods`` the kernel modules (K1, K2, K3, K4),
    ``sp`` phase 18's results (the pendulum's model, data and cost),
    ``bench``, ``model``, ``trajs`` the cartpole's (phase 2). Each path's
    kernels are counted from 0 just before it and read just after.
    Returns what phase [3]'s checks of the new instances read."""
    from autompc_torch.control import IterativeLQRFactory, make_scheduled_ilqr_solver
    from autompc_torch.control import parse_schedule
    from autompc_torch.costs import QuadCost, QuadCostFactory
    from autompc_torch.parallel import JointKoopmanLassoQuadCostFanout, JointSINDyQuadCostFanout
    from autompc_torch.pipeline import Pipeline
    from autompc_torch.sysid import MLPFactory, SINDyFactory
    from autompc_torch.sysid.arx import linear_pred
    from autompc_torch.tuning import PipelineTuner
    from autompc_torch.tuning.pipeline_tuner import _gauss_reg_stats

    K1, K2, K3, K4 = mods
    t_phase = time.perf_counter()
    out = {}

    # ---- (a) the joint-Koopman fan-out with the GaussReg term ---------------
    system = bench.system
    S, mu = _gauss_reg_stats(trajs)
    reg = dict(reg_matrix=S, reg_goal=mu)
    batch = gauss_reg_candidates(dev, JK_B, JK_SEED)
    batch["reg"] = batch["Qdiag"].new_tensor(10 ** np.random.default_rng(JK_SEED).uniform(
        -6, 0, JK_B))
    fans, res = {}, {}
    for tag, backward in (("a1", "scan"), ("a2", "pallas")):
        fan = JointKoopmanLassoQuadCostFanout(
            system, bench.task, JK_BASIS, trajs, model, horizon=JK_H, n_steps=jk_steps,
            goal=np.zeros(4), compact_schedule=JK_SCHEDULE, backward=backward, **reg)
        fans[tag] = fan
        reset_k4(K4)
        warm, per_call, scores = timed_runs(lambda: fan(batch), 1)
        res[tag] = k4_counts(K4)
        fin = torch.isfinite(scores)
        print(f"[19a] joint-Koopman fan-out with the GaussReg term, backward={backward!r}: "
              f"B={JK_B} H={JK_H} ds={fan.state_dim}, {jk_steps} steps: warm call {warm:.2f} s, "
              f"timed call {per_call:.3f} s -> {JK_B / per_call:.1f} evals/s on {card}; finite "
              f"{int(fin.sum())} / {JK_B}; K4 launches {res[tag][0]} by B {res[tag][1]}",
              flush=True)
        if tuple(scores.shape) != (JK_B,) or torch.isnan(scores).any():
            raise RuntimeError(f"joint Koopman fan-out with GaussReg ({tag}): malformed or NaN")
    if res["a1"][0] or not res["a2"][0]:
        raise RuntimeError(f"K4 launches: scan {res['a1'][0]}, pallas {res['a2'][0]} (the "
                           f"pallas body with the GaussReg term must launch it)")
    params = fans["a2"].train_lanes(batch["reg"])
    cp = {k: batch[k] for k in ("Qdiag", "Rdiag", "Fdiag", "regw")}
    from autompc_torch.sysid import Koopman

    km = Koopman(system, method="lstsq", **JK_BASIS)
    z0 = km._apply_basis(batch["Qdiag"].new_tensor(np.tile(bench.task.get_init_obs(),
                                                           (JK_B, 1))))
    ug = z0.new_zeros((JK_B, JK_H, 1))
    sols = {tag: make_scheduled_ilqr_solver(linear_pred, None, schedule=parse_schedule(
        JK_SCHEDULE), **fans[tag].solver_kw)(params, z0, ug, cp) for tag in fans}
    obj = {tag: reg_lane_objective(o[1][..., :4], o[2], cp, system.dt, S, mu)
           for tag, o in sols.items()}
    both = sols["a1"][0] & sols["a2"][0]
    rel = ((obj["a1"] - obj["a2"]).abs() / obj["a2"].abs().clamp_min(1e-30))[both]
    share = float((rel <= FAN_OBJ_TOL).float().mean()) if both.any() else 0.0
    print(f"[19a] first MPC step, scan vs pallas: converged {int(sols['a1'][0].sum())}, "
          f"{int(sols['a2'][0].sum())}, both {int(both.sum())} of {JK_B}; accepted objectives "
          f"within {FAN_OBJ_TOL} on {share:.4f} (min {FAN_AGREE_MIN}; median "
          f"{float(rel.median()) if both.any() else float('nan'):.3e})", flush=True)
    if int(both.sum()) < JK_B // 4 or share < FAN_AGREE_MIN:
        raise RuntimeError(f"joint Koopman with GaussReg first step: {int(both.sum())} lanes "
                           f"converged in both, objectives agree on {share:.4f}")
    out["jk"] = dict(counts=res["a2"], k4_args=capture_k4(
        K4, linear_pred, fans["a2"].solver_kw, params, z0, cp))
    # A second basis of the Koopman space: another lifted dimension.
    b2 = {k: v[:DS_JK2_B] for k, v in batch.items()}
    fan2 = JointKoopmanLassoQuadCostFanout(
        system, bench.task, DS_JK_BASIS2, trajs, model, horizon=JK_H, n_steps=DS_JK2_STEPS,
        goal=np.zeros(4), compact_schedule=JK_SCHEDULE, backward="pallas", **reg)
    reset_k4(K4)
    t0 = time.perf_counter()
    scores = fan2(b2)
    torch.cuda.synchronize()
    counts2 = k4_counts(K4)
    print(f"[19a] joint-Koopman fan-out {DS_JK_BASIS2}, GaussReg, backward='pallas': "
          f"B={DS_JK2_B} H={JK_H} ds={fan2.state_dim}, {DS_JK2_STEPS} steps in "
          f"{time.perf_counter() - t0:.2f} s; finite {int(torch.isfinite(scores).sum())}; K4 "
          f"launches {counts2[0]} by B {counts2[1]}", flush=True)
    if torch.isnan(scores).any() or not counts2[0] or fan2.state_dim in (4, 12):
        raise RuntimeError(f"joint Koopman at ds={fan2.state_dim}: NaN scores or K4 never ran")
    p2 = fan2.train_lanes(b2["reg"])
    km2 = Koopman(system, method="lstsq", **DS_JK_BASIS2)
    z2 = km2._apply_basis(b2["Qdiag"].new_tensor(np.tile(bench.task.get_init_obs(),
                                                         (DS_JK2_B, 1))))
    out["jk2"] = dict(counts=counts2, k4_args=capture_k4(
        K4, linear_pred, fan2.solver_kw, p2, z2, {k: b2[k] for k in cp}))

    # ---- (b) the "joint_mlp" tune on the pendulum ----------------------------
    pb, pm, ptrajs = sp["pb"], sp["pm"], sp["ptrajs"]
    psys = pb.system
    task = pb.recovery_task(num_steps=DS_TUNE_STEPS)
    from autompc_torch.parallel import JointMLPQuadCostFanout

    calls = []
    real_call = JointMLPQuadCostFanout.__call__

    def noted_call(self, batch_, init_nets=None, perms=None):
        calls.append((self, batch_))
        return real_call(self, batch_, init_nets, perms)

    pipeline = Pipeline(psys, MLPFactory(psys, n_train_iters=JM_EPOCHS, **JM_PIN),
                        QuadCostFactory(psys, goal=np.zeros(2)), IterativeLQRFactory(psys))
    reset_k4(K4)
    JointMLPQuadCostFanout.__call__ = noted_call
    try:
        t0 = time.perf_counter()
        _, rm = PipelineTuner(
            surrogate_mode="pretrain", eval_batch=DS_TUNE_ITERS, use_fanout=True,
            fanout_backward="pallas", fanout_compact=JM_COMPACT, fanout_horizon_mask=True,
        ).run(pipeline, task, ptrajs, n_iters=DS_TUNE_ITERS, rng=np.random.default_rng(100),
              surrogate=pm)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
    finally:
        JointMLPQuadCostFanout.__call__ = real_call
    jm_counts = k4_counts(K4)
    costs = np.array(rm.costs)
    print(f"[19b] pendulum 'joint_mlp' tune, {DS_TUNE_ITERS} candidates (recovery task, "
          f"{DS_TUNE_STEPS - 1} steps, horizon mask): {tune_s:.2f} s -> "
          f"{DS_TUNE_ITERS / tune_s:.2f} evals/s on {card}; scores {costs.tolist()}; K4 "
          f"launches {jm_counts[0]} by B {jm_counts[1]}", flush=True)
    if len(costs) != DS_TUNE_ITERS or np.isnan(costs).any() or not jm_counts[0]:
        raise RuntimeError(f"pendulum joint-MLP tune: scores {costs.tolist()}, K4 "
                           f"{jm_counts[0]}")
    seq_task = pb.recovery_task(num_steps=DS_SEQ_STEPS)
    seq_task.set_cost(QuadCost(psys, Q=np.eye(2), R=0.01 * np.eye(1), F=np.eye(2),
                               goal=np.zeros(2)))
    seq_pipe = Pipeline(psys, MLPFactory(psys, n_train_iters=DS_SEQ_EPOCHS, **JM_PIN),
                        QuadCostFactory(psys, goal=np.zeros(2)), IterativeLQRFactory(psys))
    t0 = time.perf_counter()
    agree, same = seq_against_fanout("19b", seq_pipe, seq_task, ptrajs, DS_TUNE_ITERS,
                                     surrogate=pm)
    print(f"[19b] sequential vs fan-out ({DS_SEQ_EPOCHS} training epoch): {agree} of "
          f"{DS_TUNE_ITERS} within {SEQ_TOL} (min {DS_TUNE_ITERS - 1}); same configurations "
          f"{same}; {time.perf_counter() - t0:.2f} s", flush=True)
    if agree < DS_TUNE_ITERS - 1 or not same:
        raise RuntimeError(f"pendulum joint-MLP tune: sequential and fan-out agree on {agree}")
    fan_m, batch_m = calls[0]
    full, _ = fan_m._prepare(batch_m)
    mparams, mcp = fan_m._solver_inputs(full, fan_m._train(full))
    x0m = full["lr"].new_tensor(np.tile(task.get_init_obs(), (full["lr"].shape[0], 1)))
    out["jm"] = dict(counts=jm_counts, k4_args=capture_k4(
        K4, fan_m._pred_core, fan_m.solver_kw, mparams, x0m, mcp))

    # ---- (c) the joint-SINDy fan-out and tune on the pendulum ---------------
    js_wrappers = joint_counters(K1, K2, K3)
    jbatch = joint_candidates(dev, JS_B)
    jbatch = {k: v[:, :2].contiguous() if v.ndim == 2 and v.shape[1] == 4 else v
              for k, v in jbatch.items()}
    out["js"] = {"fans": {}, "counts": {}, "batch": jbatch}
    for size, bucket, B_, steps in (("small", JS_BUCKET, JS_B, DS_JS_STEPS),
                                    ("big", DS_JS_BIG, JS_BIG_B, DS_JS_BIG_STEPS)):
        cand = {k: v[:B_] for k, v in jbatch.items()}
        for cfg in JS_CONFIGS:
            fan = JointSINDyQuadCostFanout(psys, pb.task, bucket, ptrajs, pm, horizon=JS_H,
                                           n_steps=steps, goal=np.zeros(2),
                                           compact_schedule=JS_SCHEDULE, **JS_CONFIGS[cfg])
            out["js"]["fans"][size, cfg] = fan
            reset_launches(js_wrappers[cfg])
            warm, per_call, scores = timed_runs(lambda: fan(cand), 1)
            counts, by_B = lane_launches(js_wrappers[cfg])
            out["js"]["counts"][size, cfg] = (counts, by_B)
            fin = torch.isfinite(scores)
            print(f"[19c] pendulum joint-SINDy fan-out ({cfg}) F={fan.n_features}: B={B_} "
                  f"H={JS_H} {steps} steps: warm call {warm:.2f} s, timed call {per_call:.3f} s "
                  f"-> {B_ / per_call:.1f} evals/s on {card}; finite {int(fin.sum())}; per-lane "
                  f"launches {counts}, by B {by_B}", flush=True)
            if tuple(scores.shape) != (B_,) or torch.isnan(scores).any() \
                    or min(counts.values()) == 0:
                raise RuntimeError(f"pendulum joint-SINDy fan-out ({cfg}, F={fan.n_features}): "
                                   f"malformed or NaN scores, or a kernel that never ran: "
                                   f"{counts}")
    fa = out["js"]["fans"]["small", "a"]
    coeffs = fa.train_lanes(jbatch["reg"])
    x0f = jbatch["Qdiag"].new_tensor(np.tile(PD_FAN_X0, (JS_B, 1)))
    cpj = {k: jbatch[k] for k in ("Qdiag", "Rdiag", "Fdiag")}
    sol = {cfg: make_scheduled_ilqr_solver(
        out["js"]["fans"]["small", cfg]._pred_core, None, schedule=parse_schedule(JS_SCHEDULE),
        **out["js"]["fans"]["small", cfg].solver_kw)({"coeffs": coeffs}, x0f,
                                                      x0f.new_zeros((JS_B, JS_H, 1)), cpj)
        for cfg in JS_CONFIGS}
    obj = {cfg: lane_objective(o[1], o[2], cpj, psys.dt) for cfg, o in sol.items()}
    both = sol["a"][0] & sol["b"][0]
    rel = ((obj["a"] - obj["b"]).abs() / obj["b"].abs().clamp_min(1e-30))[both]
    share = float((rel <= FAN_OBJ_TOL).float().mean()) if both.any() else 0.0
    print(f"[19c] first MPC step from {PD_FAN_X0}, (a) vs (b): both converged {int(both.sum())} "
          f"of {JS_B}; accepted objectives within {FAN_OBJ_TOL} on {share:.4f} (min "
          f"{FAN_AGREE_MIN})", flush=True)
    if int(both.sum()) < JS_B // 4 or share < FAN_AGREE_MIN:
        raise RuntimeError(f"pendulum joint-SINDy first step: {int(both.sum())} converged in "
                           f"both, agree on {share:.4f}")
    spipe = Pipeline(psys, SINDyFactory(psys), QuadCostFactory(psys, goal=np.zeros(2)),
                     IterativeLQRFactory(psys))
    reset_launches(js_wrappers["b"])
    t0 = time.perf_counter()
    _, rs = PipelineTuner(
        surrogate_mode="pretrain", eval_batch=DS_TUNE_ITERS, use_fanout=True,
        fanout_backward="pallas", fanout_feature_kernels=True, fanout_compact=TUNE_COMPACT,
    ).run(spipe, task, ptrajs, n_iters=DS_TUNE_ITERS, rng=np.random.default_rng(JS_TUNE_SEED),
          surrogate=pm)
    torch.cuda.synchronize()
    stune_s = time.perf_counter() - t0
    s_counts = lane_launches(js_wrappers["b"])
    scosts = np.array(rs.costs)
    print(f"[19c] pendulum 'joint_sindy' tune, {DS_TUNE_ITERS} candidates: {stune_s:.2f} s -> "
          f"{DS_TUNE_ITERS / stune_s:.2f} evals/s on {card}; scores {scosts.tolist()}; per-lane "
          f"launches {s_counts[0]}, by B {s_counts[1]}", flush=True)
    if np.isnan(scosts).any() or len(scosts) != DS_TUNE_ITERS:
        raise RuntimeError("pendulum joint-SINDy tune: a score is missing or NaN")
    t0 = time.perf_counter()
    agree, same = seq_against_fanout("19c", spipe, seq_task, ptrajs, DS_TUNE_ITERS,
                                     surrogate=pm)
    print(f"[19c] sequential vs fan-out: {agree} of {DS_TUNE_ITERS} within {SEQ_TOL} (min "
          f"{DS_TUNE_ITERS - 1}); same configurations {same}; {time.perf_counter() - t0:.2f} s",
          flush=True)
    if agree < DS_TUNE_ITERS - 1 or not same:
        raise RuntimeError(f"pendulum joint-SINDy tune: sequential and fan-out agree on {agree}")
    out["js"]["tune"] = s_counts

    # ---- (d) the pendulum's main path with ls_wide and the 4D IO --------------
    common = dict(sp["common"], max_iter=DS_WIDE_ITERS)
    counters = wide_counters(K1, K2, K3)
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    draw = lambda: torch.as_tensor(rng.uniform(-1, 1, (B_SOLVE, 2)) * np.array([np.pi, 1.0]),
                                   **f32)
    warm_x, pool = draw(), [draw() for _ in range(3)]
    ugd = torch.zeros((B_SOLVE, H, 1), **f32)
    rows = {k: warm_x.new_tensor(v).expand(B_SOLVE, 2) for k, v in (
        ("Qdiag", PD_Q), ("Rdiag", (PD_R,)), ("Fdiag", PD_Q))}
    runs = {}
    for name, kw, env in (("default", {}, "cast"), ("llw", dict(ls_wide=True), "cast"),
                          ("ll", {}, "reshape")):
        solve = make_scheduled_ilqr_solver(pm.pred_core, sp["pcost"], H=H,
                                           schedule=parse_schedule(SCHEDULE), **common, **kw)
        reset_counters(counters)
        with wide_io_env(env):
            solve(pm.params, warm_x, ugd)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [solve(pm.params, x, ugd) for x in pool]
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        runs[name] = dict(outs=outs, rate=B_SOLVE * len(pool) / elapsed,
                          conv=float(torch.stack([o[0].float().mean() for o in outs]).mean()),
                          counts=read_counters(counters))
    ref = runs["default"]
    failures = []
    for name in ("llw", "ll"):
        r = runs[name]
        rel, n_both = [], 0
        for o, d in zip(r["outs"], ref["outs"]):
            bothd = o[0] & d[0]
            n_both += int(bothd.sum())
            a = lane_objective(o[1], o[2], rows, psys.dt)
            b = lane_objective(d[1], d[2], rows, psys.dt)
            rel.append(((a - b).abs() / b.abs().clamp_min(1e-30))[bothd])
        rel = torch.cat(rel)
        share = float((rel <= FAN_OBJ_TOL).float().mean()) if rel.numel() else 0.0
        same = all(bits_equal(x, y) for o, d in zip(r["outs"], ref["outs"]) for x, y in zip(o, d))
        finite = all(torch.isfinite(o[1]).all() for o in r["outs"])
        r.update(share=share, same=same)
        print(f"[19d] pendulum {name} B={B_SOLVE} H={H} (<= {DS_WIDE_ITERS} iterations): "
              f"{r['rate']:.1f} solves/s (default {ref['rate']:.1f}) on {card}; converged "
              f"{r['conv']:.4f} (default {ref['conv']:.4f}); lanes converged in both {n_both}, "
              f"accepted objectives within {FAN_OBJ_TOL} on {share:.4f} (min {FAN_AGREE_MIN}); "
              f"bit for bit the default: {same}; launches {r['counts']}", flush=True)
        missing = [k for k in WIDE_REQUIRED[name] if r["counts"][k] == 0]
        if missing or not finite:
            failures.append(f"pendulum {name}: {missing} never ran, finite {finite}")
        if name == "ll" and not same:
            failures.append("pendulum ll: not bit for bit the default solve")
        if name == "llw" and (share < FAN_AGREE_MIN or n_both < len(pool) * B_SOLVE // 4):
            failures.append(f"pendulum llw: objectives within {FAN_OBJ_TOL} on {share:.4f} "
                            f"of {n_both} lanes")
    if failures:
        raise RuntimeError("; ".join(failures))
    out["wide"] = {k: v["counts"] for k, v in runs.items()}
    print(f"[19] phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    return out


def embed_model(small, small_terms, terms, eps=1e-3, seed=5):
    """(B, ds, F) per-lane models over ``terms``: each lane's ``small``
    model (B, ds, F_small over ``small_terms``) at those terms' places,
    every other coefficient ``eps`` N(0, 1) / F, so that every block of
    the larger library's trees holds a nonzero summand while the
    rollouts stay near the small model's."""
    place = [terms.index(t) for t in small_terms]
    F = len(terms)
    noise = np.random.default_rng(seed).standard_normal(tuple(small.shape[:2]) + (F,))
    C = small.new_tensor(noise) * (eps / F)
    C[:, :, place] = small
    return C.contiguous()


def check_dense_kernels(ds19, sp, mods, failures):
    """Phase [3] on phase 19's instances: K4 on the dense expansions of
    (a)'s two joint-Koopman fan-outs ((12, 1) and (8, 1)) and of (b)'s
    joint-MLP tune ((2, 1), horizon-masked), each three iterations into
    a first MPC step; the per-lane K1 (both entries), K3 and K7 at (2, 1)
    on (c)'s carries (21 and 75 terms, the 75-term lanes each the 21-term
    model embedded with a small remainder), one iteration from PD_FAN_X0
    (by the third the pendulum's lanes have converged); K2's 4D entry, K8 and K9 at (2, 1) on the pendulum's
    main-path carry (B_KERNEL, H, starts as phase 18's checks). Appends
    to ``failures``; returns the kernels line's rows."""
    from autompc_torch.control import make_batched_ilqr_solver

    K1, K2, K3, K4 = mods
    rows = []
    for key, tag in (("jk", "joint-Koopman fan-out with the GaussReg term (19a)"),
                     ("jk2", f"joint-Koopman fan-out {DS_JK_BASIS2} (19a)"),
                     ("jm", "pendulum joint-MLP tune, horizon-masked (19b)")):
        d = ds19[key]
        row, fails, _, _ = check_k4(tag, K4, d["k4_args"], d["counts"][0], device_time=True)
        B, H_, ds, dc = d["k4_args"][1].shape
        row.update(name=f"riccati_general[{ds},{dc},B={B},H={H_}]", launches_by_B=d["counts"][1])
        rows.append(row)
        failures += fails

    pm, pb = sp["pm"], sp["pb"]
    dev = pm.coeffs.device
    dt = pb.system.dt
    alphas = tuple(0.2 ** k for k in range(10))
    bound = float(pb.task.get_ctrl_bounds()[0, 1])
    terms = tuple(pm.library.terms[k] for k in sp["active"])
    ca = pm.coeffs[:, list(sp["active"])].contiguous()
    ctx = PhaseCtx(terms=terms, ca=ca, dt=dt, lo=-bound, hi=bound, alphas=alphas, dev=dev,
                   failures=failures, K1=K1, K2=K2, K3=K3)
    js = ds19["js"]
    batch = js["batch"]
    small = None
    src = {
        "relin_jacobians_bm": ("autompc_torch/csrc/relin.cu", "autompc_tpu/ops/pallas_relin.py:192"),
        "sindy_line_search": ("autompc_torch/csrc/sindy_linesearch.cu",
                              "autompc_tpu/ops/pallas_linesearch.py:191"),
    }
    for size, B_ in (("small", JS_B), ("big", JS_BIG_B)):
        fa, fb = js["fans"][size, "a"], js["fans"][size, "b"]
        tms = fa.library.terms
        tag = f"2x1,F={len(tms)}"
        cand = {k: v[:B_] for k, v in batch.items()}
        if size == "small":
            small = fa.train_lanes(batch["reg"])
            coeffs = small
        else:
            coeffs = embed_model(small[:B_], js["fans"]["small", "a"].library.terms, tms)
        x0 = cand["Qdiag"].new_tensor(np.tile(PD_FAN_X0, (B_, 1)))
        cp = {k: cand[k] for k in ("Qdiag", "Rdiag", "Fdiag")}
        carries = {}
        for cfg, fan in (("a", fa), ("b", fb)):
            _, c0, _, body_ = make_batched_ilqr_solver(fan._pred_core, None, return_pieces=True,
                                                       **fan.solver_kw)
            params = {"coeffs": coeffs}
            cc, body = c0(params, x0, x0.new_zeros((B_, JS_H, 1)), cp), body_(params)
            carries[cfg] = body(cc)
        ca_counts, ca_by_B = js["counts"][size, "a"]
        cja = carries["a"]
        r1 = check_k1_ll(ctx, f"pendulum joint fan-out (a) carry, per-lane coefficients, {tag}",
                         cja, ca_counts["relin_jacobians"], tms=tms, coef=cja["params"],
                         name=f"relin_jacobians_lane[{tag}]")
        ja_cost = (*(cja["cost"][k] for k in ("Qdiag", "Rdiag", "Fdiag")), (0.0, 0.0))
        res_a = check_k2_k3_ll(ctx, f"pendulum joint fan-out (a) carry, per-lane "
                                    f"coefficients, {tag}", cja, ja_cost,
                               agree_min=K3_FAN_AGREE_MIN, within_min=K3_FAN_WITHIN_MIN,
                               tms=tms, coef=cja["params"])
        k3_row = k2_k3_rows_ll(ctx, res_a, cja, "per-lane cost", {
            "backward_quad_ll": ca_counts["backward_quad_ll"],
            "fused_line_search": ca_counts["fused_line_search"]})[1]
        k3_row["name"] = f"fused_line_search_lane[{tag},B={B_},H={JS_H},per-lane cost]"
        k3_row["device_ms"] = device_ms(res_a["k3"])
        rows += [dict(r1, launches_by_B=ca_by_B["relin_jacobians"]),
                 dict(k3_row, launches_by_B=ca_by_B["fused_line_search"])]
        cjb = carries["b"]
        plane = cjb["params"]["coeffs"].permute(1, 2, 0).contiguous()
        cb_counts, cb_by_B = js["counts"][size, "b"]
        sub = {k: cjb[k].contiguous() for k in ("x0s", "xs", "us", "Jx", "Ju")}
        meas, fails = check_fanout_kernels(
            f"pendulum joint fan-out (b) carry, per-lane coefficients, {tag}", K1, K2, K3, tms,
            plane, sub, cp, (0.0, 0.0), dt, alphas, bound)
        failures += fails
        for k, name in ((0, "relin_jacobians_bm"), (2, "sindy_line_search")):
            m = dict(meas[k])
            extra = {}
            if size == "small":
                extra = dict(launches_joint_tune=js["tune"][0][name],
                             launches_joint_tune_by_B=js["tune"][1][name])
            rows.append(dict(name=f"{name}_lane[{tag},B={B_},H={JS_H}]", route="cuda",
                             source=src[name][0], replaces=src[name][1],
                             launches=cb_counts[name], launches_by_B=cb_by_B[name], **m, **extra))

    # K2's 4D entry, K8 and K9 on the pendulum's main-path carry.
    _, carry0, _, _ = make_batched_ilqr_solver(pm.pred_core, sp["pcost"], H=H,
                                               return_pieces=True, **sp["common"])
    rng = np.random.default_rng(1)
    x0 = torch.as_tensor(np.array([np.pi, 0.0]) + rng.uniform(
        -PD_KERNEL_SPREAD, PD_KERNEL_SPREAD, (B_KERNEL, 2)), dtype=torch.float32, device=dev)
    c = carry0(pm.params, x0, x0.new_zeros((B_KERNEL, H, 1)))
    diag = (PD_Q, (PD_R,), PD_Q, (0.0, 0.0))
    wide = check_wide_ll(ctx, "pendulum main-path carry (2x1)", c, diag, plain_reps=1)
    counts = ds19["wide"]
    for key, name, source, replaces, n, by_B in (
        ("k2_4d", "backward_quad_ll_wide_4d", "autompc_torch/csrc/riccati_quad.cu",
         "autompc_tpu/ops/pallas_riccati.py:1012", counts["ll"]["backward_quad_ll_wide_4d"],
         None),
        ("k8", "wide_objectives", "autompc_torch/csrc/ls_obj_wide.cu",
         "autompc_tpu/ops/pallas_linesearch.py:1129", counts["llw"]["wide_objectives"],
         counts["llw"]["wide_objectives[by B]"]),
        ("k9", "wide_reroll", "autompc_torch/csrc/ls_reroll_wide.cu",
         "autompc_tpu/ops/pallas_linesearch.py:1200", counts["llw"]["wide_reroll"],
         counts["llw"]["wide_reroll[by B]"]),
    ):
        row = dict(name=f"{name}[2x1,B={B_KERNEL},H={H},fixed cost]", route="cuda",
                   source=source, replaces=replaces, launches=n, **wide[key])
        if by_B is not None:
            row["launches_by_B"] = by_B
        rows.append(row)
    return rows



def check_wide_ll(ctx, tag, c, cost, plain_reps=3):
    """K2's reshape-IO entry and bfloat16 instances, K3's bfloat16
    instances, K8 and K9 (both storage types) against their plain
    versions on the lanes-last carry ``c`` under ``cost = (qd, rd, fd,
    goal)``, at the carry's ds, and the split search (K8 + acceptance +
    K9) against K3. Appends to ``ctx.failures``; returns the timings:
    {row: dict}."""
    terms, ca, dt, alphas, dev = ctx.terms, ctx.ca, ctx.dt, ctx.alphas, ctx.dev
    failures, K1, K2, K3 = ctx.failures, ctx.K1, ctx.K2, ctx.K3
    Hc, Bc = c["us"].shape
    ds, obsdim = c["xs"].shape[1], len(cost[3])
    act = ~c["converged"] & ~c["failed"]
    carry = dict(carry=(act, c["Ks"], c["ks"]))
    jb = c["jac"].to(torch.bfloat16)
    k2 = lambda jac: (jac, c["xs"], c["us"], *cost, dt, obsdim)
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
    lo, hi = ctx.lo, ctx.hi
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
    traj = lambda st: st[:, :ds].permute(0, 1, 3, 2).reshape(-1, Bc * len(alphas))[
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

    z = [rk[0][:-1, i].double() for i in range(ds)] + [rk[1].double()]
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
    k2_ops = Bc * Hc * (riccati_flops(ds, 1) + 16)
    ls_bytes = n_bytes(c["x0s"], c["xs"], c["us"], KsT, ksT, ca)
    step_ops = feature_value_flops(terms, ds) + 20
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
    k9_in = n_bytes(c["x0s"], c["xs"], c["us"], ca, sel, tm, jm) + 4 * Bc * (Hc * (ds + 1) + 1)
    k9_ops = Bc * Hc * feature_jac_flops(terms, ds)
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
            **k3_bound(ls_bytes + n_bytes(*tail, jb, *lkb), Bc, Hc, terms,
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


# Phase 20: the solver's remaining options through the entry points a user
# calls, each beside its yardstick on the same draws, counts reset before
# and read after each path. (a) the main path's problem (phase 2's model,
# its feature mask, the fixed diagonal QuadCost, fuse_ls) on the
# batch-major body under backward "assoc", "pallas" (K6) and "scan":
# solves/s, converged fractions, and the share of the lanes converged in
# both whose accepted objective agrees with "pallas" within FAN_OBJ_TOL
# (min FAN_AGREE_MIN); the SQP under "assoc" against "scan" on phase 15's
# Koopman (trig basis, ds = 12) and quadratic task cost, SO_DT_STEPS
# receding steps from SO_DT_B starts on the true dynamics: each step's
# seconds and the first step's agreement (the lanes with the same step
# sizes at every iteration: controls within DT_US_TOL, as phase 15 (b));
# (b) make_staged_ilqr_solver (SO_STAGED) against the scheduled solver's
# batch-major body (SCHEDULE); (c) relin="xla" (jacfwd), and with
# analytic_jac, against (a)'s "pallas", and each one's Jacobians on its
# first carry against K1's; (d) (a)'s problem under a fixed
# QuadCost whose Q couples the pole angle and its rate (SO_DENSE_Q,
# positive definite), fuse_ls=True (K3's DENSE form, K4 at (4, 1))
# against fuse_ls=False (K7), then with a model a lane (batch_params:
# K3's DENSE form with per-lane coefficients against K7's per-lane
# instance); (e) the GaussReg joint-SINDy fan-out on
# phase 12's 105-term library (JS_BIG), fused (K3's batch-major per-lane
# entry past 64 terms) against unfused (K7), JS_BIG_B lanes, H = JS_H:
# evals/s and the first step's agreement; then its trained lanes under
# (d)'s dense cost (K3's DENSE form past 64 terms); (f) the cheetah row (phase 6's
# model and weights, B_HC, H_HC, layout "feat") at mlp_ls precisions
# "highest", "default" and "bf16x3" one after another: solves/s and
# converged fractions (not gated: on the TPU bf16x3 converged on 91.2% of
# lanes, fewer than "highest"), then "default" with layout "mxu" on phase
# 7's cartpole MLP. chip_smoke.py runs SO_SMOKE (smaller batches and
# fewer steps); tools/torch_solver_options_phase.py runs SO_FULL.
SO_FULL = dict(B=B_KERNEL, B_STAGED=B_SOLVE, js_steps=10, dt_steps=5, hc=True)
SO_SMOKE = dict(B=1024, B_STAGED=B_KERNEL, js_steps=5, dt_steps=3, hc=True)
SO_ITERS = 50
SO_STAGED = dict(chunk_iters=5, min_bucket=1024)
SO_DENSE_Q = np.diag([10.0, 0.1, 0.01, 0.01])
SO_DENSE_Q[0, 1] = SO_DENSE_Q[1, 0] = 0.3     # eigenvalues > 0.09: positive definite
SO_DT_B = 256
SO_LANE_EPS = 0.01
SO_PRECISIONS = ("highest", "default", "bf16x3")
# The agreement gates. Phase 8's FAN_AGREE_MIN of the lanes within
# FAN_OBJ_TOL holds where the two bodies compute the same float32
# arithmetic up to a few roundings at H=10 (hazard 7), and it gates (b),
# whose bodies are one arithmetic, and (e), a first MPC step at H=10. At
# H=200 and up to 50 iterations two float32 bodies part on a third of the
# lanes converged in both: on one call (NVIDIA H100 80GB HBM3, 700.00 W,
# B=1024, the draws of (a)) scan against pallas agreed within 1e-3 on
# 0.6325 of them, assoc against pallas on 0.6712, and each of the three
# against a float64 solve on 0.66-0.69, which converged on fewer lanes
# (PERF.md §6): the knife edge of hazard 1 at every one of the 50
# acceptances, with no body closer to float64 than another. So (a), (c)
# and (d) take as floor the share at which scan and pallas, two bodies
# that predate them, agree in the same call, less SO_SHARE_SLACK; and
# assoc's gains on (a)'s first carry are held against K6's normwise to
# TOL_K2, as K2 is held against its plain version.
SO_SHARE_SLACK = 0.05


def so_need(ok, msg):
    """Raise ``msg`` unless ``ok``: phase 20's gates."""
    if not ok:
        raise RuntimeError(f"phase 20 {msg}")


def so_objective(cost, xs, us, dt):
    """The fixed cost's objective of batch-major trajectories, float64."""
    xs, us = xs.double(), us.double()
    H = us.shape[1]
    return (dt * (cost.eval_obs_cost(xs[:, :H]).sum(1) + cost.eval_ctrl_cost(us).sum(1))
            + cost.eval_term_obs_cost(xs[:, H]))


def so_agreement(tag, out, ref, cost, dt, min_both, floor=FAN_AGREE_MIN):
    """The share of the lanes converged in both solves whose accepted
    objectives agree within FAN_OBJ_TOL (relative), gated at ``floor``
    with at least ``min_both`` such lanes; the converged fractions may
    differ by SO_SHARE_SLACK at most."""
    both = out[0] & ref[0]
    a, b = so_objective(cost, out[1], out[2], dt), so_objective(cost, ref[1], ref[2], dt)
    rel = ((a - b).abs() / b.abs().clamp_min(1e-30))[both]
    share = float((rel <= FAN_OBJ_TOL).float().mean()) if both.any() else 0.0
    conv_a, conv_b = float(out[0].float().mean()), float(ref[0].float().mean())
    print(f"[20] {tag}: converged {conv_a:.4f} against {conv_b:.4f}, both {int(both.sum())}; "
          f"accepted objectives within {FAN_OBJ_TOL} on {share:.4f} of those (min "
          f"{floor:.4f}), within 1e-2 on "
          f"{float((rel <= 1e-2).float().mean()) if both.any() else 0.0:.4f}", flush=True)
    so_need(int(both.sum()) >= min_both and share >= floor
            and abs(conv_a - conv_b) <= SO_SHARE_SLACK,
            f"{tag}: {int(both.sum())} lanes converged in both, objectives agree on "
            f"{share:.4f} (min {floor:.4f}), converged {conv_a:.4f} against {conv_b:.4f}")
    return share


def so_timed(solve, *args):
    """(output, seconds) of one call, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solve(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def so_counters(mods):
    K1, K2, K3, K4, K5 = mods
    return {"K1": K1.relin_jacobians_bm, "K6": K2.backward_quad, "K3": K3.fused_line_search_bm,
            "K4": K4.riccati_general, "K7": K3.sindy_line_search, "K5": K5.mlp_line_search}


def so_reset(ws):
    from autompc_torch.ops.cuda_linesearch import reset_bm_counters

    reset_launches(ws.values())
    reset_bm_counters()
    ws["K5"].launches_by_precision = dict.fromkeys(SO_PRECISIONS, 0)


def so_read(ws):
    out = {k: w.launches for k, w in ws.items()}
    k3 = ws["K3"]
    out.update({"K3[dense]": k3.launches_dense, "K3[dense lane]": k3.launches_dense_lane,
                "K3[no jac]": k3.launches_no_jac,
                "K3[lane past 64]": k3.launches_lane_big, "K3[lane]": k3.launches_lane})
    out.update({f"K5[{p}]": n for p, n in ws["K5"].launches_by_precision.items()})
    return out


def solver_options_phase(dev, card, mods, bench, model, trajs, hc_run, cp_run, size=SO_SMOKE):
    """Phase 20 (a)-(f) at ``size``. ``hc_run`` = (model, cost, kw, x0, ug) of
    phase 6's cheetah row, ``cp_run`` = (model, cost, kw, x0, ug) of phase
    7's cartpole MLP. Returns what ``check_solver_option_kernels`` needs."""
    from autompc_torch.control import (
        make_batched_ilqr_solver,
        make_scheduled_ilqr_solver,
        make_staged_ilqr_solver,
        parse_schedule,
    )
    from autompc_torch.control.nmpc import make_sqp_solver, knot_count
    from autompc_torch.costs import QuadCost
    from autompc_torch.parallel import JointSINDyQuadCostFanout
    from autompc_torch.sysid import Koopman
    from autompc_torch.tuning.pipeline_tuner import _gauss_reg_stats

    t20 = time.perf_counter()
    ws = so_counters(mods)
    B, dt = size["B"], bench.system.dt
    coeffs = model.coeffs.cpu().numpy()
    active = tuple(int(k) for k in np.flatnonzero(np.any(coeffs != 0, axis=0)))
    qd = np.diag([10.0, 0.1, 0.01, 0.01])
    cost = QuadCost(bench.system, qd, 0.001 * np.eye(1), qd, goal=np.zeros(4))
    bounds = bench.task.get_ctrl_bounds()
    kw = dict(H=H, ds=4, dc=1, obsdim=4, dt=dt, ubounds=(bounds[:, 0], bounds[:, 1]),
              feature_spec=(model.library, "coeffs"), feature_mask=active, fuse_ls=True,
              lanes_last=False, max_iter=SO_ITERS)
    x0 = draw_x0(np.random.default_rng(20), B, dev)
    ug = x0.new_zeros((B, H, 1))
    out = dict(kw=kw, cost=cost, x0=x0, active=active, counts={}, rates={}, model=model,
               init=bench.task.get_init_obs())

    def run(tag, solve, *args, n=B):
        so_reset(ws)
        res, sec = so_timed(solve, *args)
        counts = so_read(ws)
        out["counts"][tag], out["rates"][tag] = counts, n / sec
        print(f"[20] {tag}: {sec:.3f} s -> {n / sec:.1f} solves/s on {card}; converged "
              f"{float(res[0].float().mean()):.4f}; launches {counts}", flush=True)
        return res

    # ---- (a) backward="assoc" against "pallas" (K6) and "scan" ----
    res = {}
    for bk in ("pallas", "assoc", "scan"):
        solve = make_batched_ilqr_solver(model.pred_core, cost, backward=bk, **kw)
        if bk == "pallas":
            solve(model.params, x0 - 0.01, ug)      # the body's first call, untimed
        res[bk] = run(f"(a) backward={bk!r} B={B} H={H}", solve, model.params, x0, ug)
    min_both = max(8, B // 50)
    # scan against pallas: how far two bodies that predate this phase
    # part here; the floor of (a), (c) and (d) (SO_SHARE_SLACK).
    scan_share = so_agreement("(a) scan against pallas", res["scan"], res["pallas"], cost, dt,
                              min_both, floor=0.0)
    floor = scan_share - SO_SHARE_SLACK
    out["agree_a"] = {"scan": scan_share, "assoc": so_agreement(
        "(a) assoc against pallas", res["assoc"], res["pallas"], cost, dt, min_both, floor)}
    out["floor"] = floor
    # One backward pass on the first carry: assoc's gains against K6's,
    # scan's beside them (the plain float32 recursion).
    from autompc_torch.ops.riccati import tvlqr_backward_assoc, tvlqr_backward_scan

    _, carry0, _, _ = make_batched_ilqr_solver(model.pred_core, cost, return_pieces=True,
                                               backward="pallas", **kw)
    c0 = carry0(model.params, x0, ug)
    Qd = x0.new_tensor(np.diag(qd)).expand(B, 4).contiguous()
    k6 = mods[1].backward_quad(c0["Jx"], c0["Ju"], c0["xs"], c0["us"], Qd,
                               x0.new_full((B, 1), 0.001), Qd, (0.0,) * 4, dt, 4)
    exp = stage_expansions(cost, c0["xs"], c0["us"], H, dt)
    e_assoc = max(rel_err(a, b) for a, b in zip(tvlqr_backward_assoc(c0["Jx"], c0["Ju"], *exp),
                                                  k6))
    e_scan = max(rel_err(a, b) for a, b in zip(tvlqr_backward_scan(c0["Jx"], c0["Ju"], *exp),
                                                 k6))
    print(f"[20] (a) one backward pass on the first carry (B={B}, H={H}): assoc against K6 "
          f"{e_assoc:.3e}, scan against K6 {e_scan:.3e} (normwise, the worst of K, k, lin, "
          f"quad; tol {TOL_K2})", flush=True)
    so_need(e_assoc <= TOL_K2, f"(a) assoc's gains {e_assoc:.3e} from K6's")
    so_need(out["counts"][f"(a) backward='pallas' B={B} H={H}"]["K6"] > 0,
            "(a): K6 never ran under backward='pallas'")

    # The SQP, "assoc" against "scan": phase 15's Koopman + DT.
    dtask = bench.task.copy()
    dtask.set_cost(cost)
    km = Koopman(bench.system, method="lstsq", device=dev, **JK_BASIS)
    km.train(trajs)
    knots = knot_count(DT_HORIZON_S, dt)
    xd0 = torch.cat([x0[:1].new_tensor(dtask.get_init_obs())[None],
                     draw_x0(np.random.default_rng(CF_SEED), SO_DT_B - 1, dev)])
    sqp = {}
    for bk in ("scan", "assoc"):
        solve = make_sqp_solver(km.pred_core, cost, H=knots, ds=km.state_dim, dc=1, obsdim=4,
                                dt=dt, ubounds=(bounds[:, 0], bounds[:, 1]), backward=bk)
        x, ds_k = xd0, km.state_dim
        xs_g, us_g = x.new_zeros((SO_DT_B, knots + 1, ds_k)), x.new_zeros((SO_DT_B, knots, 1))
        secs, first = [], None
        for step in range(size["dt_steps"]):
            z = km._apply_basis(x)
            (sx, su, st), sec = so_timed(lambda: solve(km.params, z, xs_g, us_g, steps=True))
            secs.append(sec)
            if first is None:
                first = (su, st)
            x = bench.dynamics(x, su[:, 0])
            xs_g = torch.cat([sx[:, 1:], sx[:, -1:]], dim=1)
            us_g = torch.cat([su[:, 1:], su[:, -1:]], dim=1)
        if not torch.isfinite(x).all():
            raise RuntimeError(f"phase 20 SQP ({bk}): a state is not finite")
        sqp[bk] = (first, secs)
        print(f"[20] (a) SQP backward={bk!r} on the Koopman model (ds={ds_k}, {knots} knots), "
              f"{SO_DT_B} starts, {size['dt_steps']} receding steps: seconds a step "
              f"{[round(v, 4) for v in secs]} on {card}", flush=True)
    (ua, sa), (us_, ss) = sqp["assoc"][0], sqp["scan"][0]
    same = (sa == ss).all(1)
    err = (ua - us_).abs().amax((1, 2)) / us_.abs().amax((1, 2)).clamp_min(1.0)
    bad = int((same & ~(err <= DT_US_TOL)).sum())
    out["sqp_share"] = float(same.float().mean())
    print(f"[20] (a) SQP first step, assoc against scan: the same step sizes at every "
          f"iteration on {out['sqp_share']:.4f} of the lanes; their controls within "
          f"{float(err[same].max()) if same.any() else float('nan'):.3e} (max {DT_US_TOL}), "
          f"{bad} beyond", flush=True)
    if not same.any() or bad:
        raise RuntimeError(f"phase 20 SQP first step: {bad} lanes beyond {DT_US_TOL}")

    # ---- (b) the staged driver against the scheduled one (batch-major) ----
    Bs = size["B_STAGED"]
    xs0 = draw_x0(np.random.default_rng(21), Bs, dev)
    ugs = xs0.new_zeros((Bs, H, 1))
    sched = make_scheduled_ilqr_solver(model.pred_core, cost, schedule=parse_schedule(SCHEDULE),
                                       **{k: v for k, v in kw.items() if k != "max_iter"})
    staged = make_staged_ilqr_solver(model.pred_core, cost, **SO_STAGED,
                                     **{k: v for k, v in kw.items() if k != "max_iter"})
    r_sched = run(f"(b) scheduled B={Bs}", sched, model.params, xs0, ugs, n=Bs)
    r_staged = run(f"(b) staged {SO_STAGED} B={Bs}", staged, model.params, xs0, ugs, n=Bs)
    out["agree_b"] = so_agreement("(b) staged against scheduled", r_staged, r_sched, cost, dt,
                                  max(8, Bs // 50))

    # ---- (c) relin="xla" and analytic_jac against relin="pallas" ----
    for tag, extra in (("relin='xla'", dict(relin="xla")),
                       ("relin='xla', analytic_jac", dict(relin="xla", analytic_jac=True))):
        solve = make_batched_ilqr_solver(model.pred_core, cost, backward="pallas", **kw, **extra)
        r = run(f"(c) {tag} B={B}", solve, model.params, x0, ug)
        out.setdefault("agree_c", {})[tag] = so_agreement(f"(c) {tag} against pallas", r,
                                                          res["pallas"], cost, dt, min_both,
                                                          floor)
        c_counts = out["counts"][f"(c) {tag} B={B}"]
        so_need(c_counts["K1"] == 0 and c_counts["K3[no jac]"] > 0,
                f"(c) {tag}: the feature kernels relinearized, or K3 wrote Jacobians: "
                f"{c_counts}")
        # The option's Jacobians on its first carry against K1's at the
        # same trajectory, normwise to TOL_K1.
        _, carry0_c, _, _ = make_batched_ilqr_solver(model.pred_core, cost, return_pieces=True,
                                                     backward="pallas", **kw, **extra)
        cc = carry0_c(model.params, x0, ug)
        jk = mods[0].relin_jacobians_bm(
            tuple(model.library.terms[k] for k in active), cc["xs"], cc["us"],
            model.coeffs[:, list(active)].contiguous())
        e_j = max(rel_err(cc["Jx"], jk[0]), rel_err(cc["Ju"], jk[1]))
        j64 = mods[0].relin_jacobians_bm_plain(
            tuple(model.library.terms[k] for k in active), cc["xs"].double(),
            cc["us"].double(), model.coeffs[:, list(active)].double())
        e64 = [max(rel_err(a[0], j64[0]), rel_err(a[1], j64[1]))
               for a in ((cc["Jx"], cc["Ju"]), jk)]
        out.setdefault("jac_c", {})[tag] = e_j
        print(f"[20] (c) {tag}: the first carry's Jacobians against K1's at its trajectory "
              f"(B={B}, H={H}): {e_j:.3e} normwise (tol {TOL_K1}); against float64 there "
              f"{e64[0]:.3e}, K1's {e64[1]:.3e}", flush=True)
        so_need(e_j <= TOL_K1, f"(c) {tag}: Jacobians {e_j:.3e} from K1's")

    # ---- (d) a fixed dense cost: K3's DENSE form against K7 ----
    dense = QuadCost(bench.system, SO_DENSE_Q, 0.001 * np.eye(1), SO_DENSE_Q, goal=np.zeros(4))
    rd = {}
    for fused in (True, False):
        solve = make_batched_ilqr_solver(model.pred_core, dense, backward="pallas",
                                         **dict(kw, fuse_ls=fused))
        rd[fused] = run(f"(d) dense Q, fuse_ls={fused} B={B}", solve, model.params, x0, ug)
    out["agree_d"] = so_agreement("(d) dense cost, fused against unfused", rd[True], rd[False],
                                  dense, dt, min_both, floor)
    cd = out["counts"][f"(d) dense Q, fuse_ls=True B={B}"]
    so_need(cd["K3[dense]"] > 0 and cd["K4"] > 0, f"(d): K3's dense form or K4 never ran: {cd}")
    out["dense"] = dense
    # One model a lane (batch_params): the main path's coefficients, each
    # lane's scaled by 1 + SO_LANE_EPS N(0, 1), fused (K3's DENSE form
    # with per-lane coefficients) against unfused (K7's per-lane instance).
    def lane_pred(prm, x, u):
        return torch.einsum("b...f,bnf->b...n", model.library(torch.cat([x, u], dim=-1)),
                            prm["coeffs"])

    noise = torch.as_tensor(np.random.default_rng(22).standard_normal(
        (B,) + tuple(model.coeffs.shape)), dtype=model.coeffs.dtype, device=dev)
    lane_p = {"coeffs": (model.coeffs[None] * (1 + SO_LANE_EPS * noise)).contiguous()}
    rl = {}
    for fused in (True, False):
        lkw = dict(kw, fuse_ls=fused, batch_params=True)
        solve = make_batched_ilqr_solver(lane_pred, dense, backward="pallas", **lkw)
        rl[fused] = run(f"(d) dense Q, a model a lane, fuse_ls={fused} B={B}", solve, lane_p,
                        x0, ug)
    out["agree_d_lane"] = so_agreement("(d) dense cost, a model a lane, fused against unfused",
                                       rl[True], rl[False], dense, dt, min_both, floor)
    cl = out["counts"][f"(d) dense Q, a model a lane, fuse_ls=True B={B}"]
    so_need(cl["K3[dense lane]"] > 0, f"(d): K3's dense form with per-lane coefficients "
                                      f"never ran: {cl}")
    out["lane_runs"] = {"small": (lane_pred, dict(kw, batch_params=True), lane_p, x0,
                                  tuple(model.library.terms[k] for k in active), active)}

    # ---- (e) the GaussReg joint-SINDy fan-out past 64 terms ----
    S, mu = _gauss_reg_stats(trajs)
    jbatch = gauss_reg_candidates(dev, JS_BIG_B, seed=3, joint=True)
    fans = {}
    for cfg in ("1", "2"):
        fan = JointSINDyQuadCostFanout(
            bench.system, bench.task, JS_BIG, trajs, model, horizon=JS_H,
            n_steps=size["js_steps"], goal=np.zeros(4), compact_schedule=JS_SCHEDULE,
            use_feature_kernels=True, reg_matrix=S, reg_goal=mu, device=dev, **GR_CONFIGS[cfg])
        fans[cfg] = fan
        so_reset(ws)
        scores, sec = so_timed(fan, jbatch)
        counts = so_read(ws)
        out["counts"][f"(e) fan-out {cfg}"], out["rates"][f"(e) fan-out {cfg}"] = \
            counts, JS_BIG_B / sec
        fin = torch.isfinite(scores)
        print(f"[20] (e) GaussReg joint-SINDy fan-out {GR_CONFIGS[cfg]}, F={fan.n_features}, "
              f"B={JS_BIG_B} H={JS_H} {size['js_steps']} steps: {sec:.3f} s -> "
              f"{JS_BIG_B / sec:.1f} evals/s (per-lane training included) on {card}; scores "
              f"finite {int(fin.sum())}; launches {counts}", flush=True)
        if torch.isnan(scores).any():
            raise RuntimeError(f"phase 20 (e) ({cfg}): NaN scores")
    ce = out["counts"]["(e) fan-out 1"]
    so_need(ce["K3[lane past 64]"] > 0,
            f"(e): K3's per-lane entry past 64 terms never ran: {ce}")
    coeffs_j = fans["1"].train_lanes(jbatch["reg"])
    cpj = {k: jbatch[k] for k in ("Qdiag", "Rdiag", "Fdiag", "regw")}
    xj = jbatch["Qdiag"].new_tensor(np.tile(bench.task.get_init_obs(), (JS_BIG_B, 1)))
    first_step_agreement(
        "(e) joint SINDy F=105", {c: make_scheduled_ilqr_solver(
            fans[c]._pred_core, None, schedule=parse_schedule(JS_SCHEDULE), **fans[c].solver_kw)
            for c in ("1", "2")},
        xj, xj.new_zeros((JS_BIG_B, JS_H, 1)), cpj, dt, S, mu, {"coeffs": coeffs_j},
        label="[20]", min_both=max(8, JS_BIG_B // 8))
    out.update(fans=fans, jbatch=jbatch, S=S, mu=mu)
    # (e)'s trained lanes (F=105, one model a lane) under (d)'s fixed dense
    # cost: K3's DENSE form with per-lane coefficients past 64 terms
    # against K7's per-lane instance, H = JS_H (phase 8's gate).
    fan = fans["1"]
    kj = dict(H=JS_H, ds=4, dc=1, obsdim=4, dt=dt, ubounds=(bounds[:, 0], bounds[:, 1]),
              feature_spec=(fan.library, "coeffs"), batch_params=True, lanes_last=False,
              max_iter=SO_ITERS)
    pj = {"coeffs": coeffs_j}
    rj = {}
    for fused in (True, False):
        solve = make_batched_ilqr_solver(fan._pred_core, dense, backward="pallas",
                                         **dict(kj, fuse_ls=fused))
        rj[fused] = run(f"(e) F={fan.n_features} dense Q, fuse_ls={fused} B={JS_BIG_B} "
                        f"H={JS_H}", solve, pj, xj, xj.new_zeros((JS_BIG_B, JS_H, 1)),
                        n=JS_BIG_B)
    out["agree_e_dense"] = so_agreement(
        f"(e) F={fan.n_features} dense cost, fused against unfused", rj[True], rj[False], dense,
        dt, max(8, JS_BIG_B // 8))
    cj = out["counts"][f"(e) F={fan.n_features} dense Q, fuse_ls=True B={JS_BIG_B} H={JS_H}"]
    so_need(cj["K3[dense lane]"] > 0 and cj["K3[lane past 64]"] > 0,
            f"(e): K3's dense form with per-lane coefficients past 64 terms never ran: {cj}")
    out["lane_runs"]["big"] = (fan._pred_core, kj, pj, xj, tuple(fan.library.terms),
                               tuple(range(fan.n_features)))

    # ---- (f) K5's precisions ----
    hc_model, hc_cost, hc_kw, hc_x0, hc_ug = hc_run
    out["hc"] = {}
    for prec in SO_PRECISIONS:
        kwp = dict(hc_kw, mlp_ls=dict(hc_kw["mlp_ls"], precision=prec))
        solve = cheetah_solver(hc_model, hc_cost, kwp)
        r = run(f"(f) cheetah {prec} B={B_HC} H={H_HC}", solve, hc_model.params, hc_x0, hc_ug,
                n=B_HC)
        out["hc"][prec] = float(r[0].float().mean())
        if not all(torch.isfinite(o[r[0]]).all() for o in r[1:]):
            raise RuntimeError(f"phase 20 (f) cheetah {prec}: non-finite on a converged lane")
        so_need(out["counts"][f"(f) cheetah {prec} B={B_HC} H={H_HC}"][f"K5[{prec}]"] > 0,
                f"(f): K5 {prec} never ran")
    print(f"[20] (f) cheetah converged fractions by precision {out['hc']} (not gated; on the "
          f"TPU bf16x3 converged on 0.912 of the lanes, fewer than 'highest')", flush=True)
    cp_model, cp_cost, cp_kw, cp_x0, cp_ug = cp_run
    kwd = dict(cp_kw, mlp_ls=dict(cp_kw["mlp_ls"], precision="default"))
    solve = make_batched_ilqr_solver(cp_model.pred_core, cp_cost, max_iter=50, **kwd)
    r = run(f"(f) cartpole MLP default, layout mxu B={B_DENSE}", solve, cp_model.params, cp_x0,
            cp_ug, n=B_DENSE)
    if not all(torch.isfinite(o[r[0]]).all() for o in r[1:]):
        raise RuntimeError("phase 20 (f) cartpole mxu default: non-finite on a converged lane")
    out.update(hc_run=hc_run, cp_run=cp_run, cp_kw_default=kwd)
    print(f"[20] phase wall {time.perf_counter() - t20:.2f} s", flush=True)
    return out


def check_k3_dense(tag, K1, K3, K4, terms, coeffs, c, cost, dt, alphas, bound):
    """K3's batch-major DENSE form against its plain twin on the dense-cost
    carry ``c`` (after the solver's backward pass on it; ``coeffs`` shared
    (ds, n) or a lanes-last per-lane (ds, n, B) plane), with the gates
    of check_k3_bm: decisions on K3_FAN_AGREE_MIN of the active lanes,
    states of the lanes of equal decisions within TOL_K3 on
    K3_FAN_WITHIN_MIN of them, the objective normwise to TOL_K3; against
    float64 at the kernel's own trajectory: the objective under the dense
    cost (TOL_K3), du2 (TOL_K3), the Jacobians (TOL_K1); no output not
    finite where the twin's is; and with jac=False the same outputs bit
    for bit. Returns (measurements, failure strings)."""
    from autompc_torch.ops.cuda_linesearch import _sweep

    failures = []
    B, H = c["us"].shape[:2]
    act = ~c["converged"] & ~c["failed"]
    Ks, ks, lin, quad = K4.riccati_general(c["Jx"], c["Ju"],
                                           *stage_expansions(cost, c["xs"], c["us"], H, dt))
    ks_small = torch.sqrt((ks * ks).sum(dim=(1, 2))) < 1e-3
    QRF = tuple(M.detach().cpu().numpy().astype(np.float64) for M in (cost._Q, cost._R, cost._F))
    base = (terms, c["x0s"], c["xs"], c["us"], Ks, ks, coeffs, alphas, -bound, bound, *QRF,
            (0.0,) * 4, dt, c["obj"], lin, quad, ks_small)
    kk, kp = K3.fused_line_search_bm(*base), K3.fused_line_search_bm_plain(*base)
    x0T, xsT, usT, KsT, ksT = (c["x0s"].T, c["xs"].permute(1, 2, 0), c["us"][:, :, 0].T,
                               Ks[:, :, 0].permute(1, 2, 0), ks[:, :, 0].T)
    objs = _sweep(terms, x0T, xsT, usT, KsT, ksT, coeffs, alphas, -bound, bound, *QRF,
                  (0.0,) * 4, dt, True, keep=False, dense=True)[0]

    def lane_finite(o):
        return torch.stack([torch.isfinite(t.float()).reshape(B, -1).all(1) for t in o]).all(0)

    kernel_only = int((~lane_finite(kk) & lane_finite(kp)).sum())
    choice = lambda o: (objs - o[None]).abs().argmin(0)
    pick = lambda i: objs.gather(0, i[None])[0]
    ck, cq = choice(kk[2]), choice(kp[2])
    same_choice = (ck == cq) | ((pick(ck) - pick(cq)).abs() <= K3_TIE * pick(cq).abs())
    same_flags = (kk[3] == kp[3]) & (kk[4] == kp[4])
    stalled = ((kk[2] - c["obj"]).abs() <= K3_TIE * c["obj"].abs()) \
        & ((kp[2] - c["obj"]).abs() <= K3_TIE * c["obj"].abs())
    agree_lane = stalled | (same_flags & same_choice)
    agree = agree_lane[act].float().mean().item() if act.any() else 1.0
    n_differ = int((act & ~agree_lane).sum())
    lanes = same_flags & (ck == cq)
    dx = (kk[0][lanes].double() - kp[0][lanes].double()).abs().amax(dim=(1, 2))
    within = (dx <= TOL_K3 * kp[0][lanes].double().abs().amax(dim=(1, 2)).clamp_min(1e-30))
    within = within.float().mean().item() if lanes.any() else 1.0
    e_obj = rel_err(kk[2][lanes], kp[2][lanes]) if lanes.any() else 0.0
    fin = lane_finite(kk)
    obj64 = so_objective(cost, kk[0], kk[1], dt)
    e_obj64 = float(((kk[2].double() - obj64).abs() / obj64.abs().clamp_min(1e-30))[fin].max())
    du2_64 = ((kk[1].double() - c["us"].double()) ** 2).sum(dim=(1, 2))
    e_du2 = rel_err(kk[7][fin], du2_64[fin])
    j64 = K1.relin_jacobians_bm_plain(terms, kk[0][fin].double(), kk[1][fin].double(),
                                      (coeffs[..., fin] if coeffs.ndim == 3 else coeffs).double())
    e_jac = max(rel_err(kk[5][fin], j64[0]), rel_err(kk[6][fin], j64[1]))
    nojac = K3.fused_line_search_bm(*base, jac=False)
    same_nojac = nojac[5] is None and all(bits_equal(a, b) for a, b in
                                          zip(nojac[:5] + nojac[7:], kk[:5] + kk[7:]))
    print(f"[3] K3 batch-major dense cost, {tag} B={B} H={H}: active lanes {int(act.sum())}; "
          f"not finite only in the kernel {kernel_only}; decisions agree with the twin on "
          f"{agree:.5f} of the active lanes ({n_differ} differ; min {K3_FAN_AGREE_MIN}); on "
          f"the {int(lanes.sum())} lanes of equal decisions: states within {TOL_K3} on "
          f"{within:.4f} (min {K3_FAN_WITHIN_MIN}), objective {e_obj:.3e}; vs float64 at the "
          f"kernel's trajectories: objective {e_obj64:.3e}, du2 {e_du2:.3e} (tol {TOL_K3}), "
          f"Jacobians {e_jac:.3e} (tol {TOL_K1}); without Jacobians bit for bit: "
          f"{same_nojac}", flush=True)
    if kernel_only or n_differ > max(1, int((1 - K3_FAN_AGREE_MIN) * int(act.sum()))) \
            or within < K3_FAN_WITHIN_MIN or e_obj > TOL_K3 or max(e_obj64, e_du2) > TOL_K3 \
            or e_jac > TOL_K1 or not same_nojac:
        failures.append(f"K3 dense ({tag}): kernel-only non-finite {kernel_only}, agree "
                        f"{agree:.5f}, within {within:.4f}, obj {e_obj:.3e}, obj64 "
                        f"{e_obj64:.3e}, du2 {e_du2:.3e}, jac {e_jac:.3e}, no-jac {same_nojac}")
    call = lambda: K3.fused_line_search_bm(*base)
    tensors = [t for t in base if isinstance(t, torch.Tensor)]
    meas = dict(
        max_abs_err=abs_err(kk[0][lanes], kp[0][lanes]) if lanes.any() else 0.0,
        ms=time_ms(call), device_ms=device_ms(call),
        plain_ms=time_ms(lambda: K3.fused_line_search_bm_plain(*base), reps=1, warm=0),
        # The dense forms: obsdim^2 three-factor products and their sum
        # a stage instead of the diagonal's obsdim.
        **k3_bound(n_bytes(*tensors, *kk), B, H, terms, len(alphas)))
    meas.update(bound_keys(n_bytes(*tensors, *kk), meas["bound_ops_ms"] * F32_FLOPS / 1e3
                           + B * H * len(alphas) * 3 * 12), scratch_bytes_ms=meas["scratch_bytes_ms"])
    return meas, failures


def check_solver_option_kernels(so, mods, failures):
    """Phase 20's new kernel modes against their plain versions on their
    paths' own inputs: K3's DENSE form on (d)'s carry three iterations
    in, with per-lane coefficients on (d)'s and (e)'s lanes' carries,
    K3's batch-major per-lane entry past 64 terms (with and without
    the GaussReg term) on (e)'s, K5 at "bf16x3" and "default" on the
    cheetah row's carry and "default" on the cartpole MLP's (layout
    "mxu"). Returns report rows."""
    from autompc_torch.control import make_batched_ilqr_solver

    K1, K2, K3, K4, K5 = mods
    rows = []
    alphas = tuple(0.2 ** k for k in range(10))
    model_terms = so["kw"]["feature_spec"][0].terms
    terms = tuple(model_terms[k] for k in so["active"])
    dev = so["x0"].device
    # K3 DENSE on (d)'s fused carry.
    kwd = dict(so["kw"])
    _, carry0, _, make_body = make_batched_ilqr_solver(so["model"].pred_core, so["dense"],
                                                       return_pieces=True, **kwd)
    params = so["model"].params
    ug = so["x0"].new_zeros((so["x0"].shape[0], H, 1))
    c = carry0(params, so["x0"], ug)
    body = make_body(params)
    for _ in range(3):
        c = body(c)
    coeffs = so["model"].coeffs[:, list(so["active"])].contiguous()
    meas, fails = check_k3_dense("(d)'s carry", K1, K3, K4, terms, coeffs, c, so["dense"],
                                 kwd["dt"], alphas, float(kwd["ubounds"][1][0]))
    failures += fails
    cd = so["counts"][f"(d) dense Q, fuse_ls=True B={so['x0'].shape[0]}"]
    rows.append(dict(name=f"fused_line_search_bm[dense,B={so['x0'].shape[0]},H={H}]",
                     route="cuda", source="autompc_torch/csrc/linesearch_fused.cu",
                     replaces="autompc_tpu/ops/pallas_linesearch.py:803",
                     launches=cd["K3[dense]"], **meas))
    # K3 DENSE with per-lane coefficients: (d)'s lanes (a model a lane)
    # and (e)'s trained F=105 lanes under the dense cost, each on its
    # fused carry three iterations in.
    # (e)'s lanes have all converged three iterations in at H = JS_H, so
    # that carry is taken after one.
    for key, tag, count, n_it in (
            ("small", f"(d)'s carry, a model a lane",
             f"(d) dense Q, a model a lane, fuse_ls=True B={so['x0'].shape[0]}", 3),
            ("big", f"(e)'s lanes F={so['fans']['1'].n_features}",
             f"(e) F={so['fans']['1'].n_features} dense Q, fuse_ls=True B={JS_BIG_B} H={JS_H}",
             1)):
        pred, lkw, lp, lx0, lterms, lactive = so["lane_runs"][key]
        _, carry0, _, make_body = make_batched_ilqr_solver(pred, so["dense"], return_pieces=True,
                                                           **dict(lkw, fuse_ls=True))
        cl = carry0(lp, lx0, lx0.new_zeros((lx0.shape[0], lkw["H"], 1)))
        body = make_body(lp)
        for _ in range(n_it):
            cl = body(cl)
        plane = cl["params"]["coeffs"][..., list(lactive)].permute(1, 2, 0).contiguous()
        meas, fails = check_k3_dense(tag, K1, K3, K4, lterms, plane, cl, so["dense"],
                                     kwd["dt"], alphas, float(kwd["ubounds"][1][0]))
        failures += fails
        B_l, H_l = lx0.shape[0], lkw["H"]
        rows.append(dict(name=f"fused_line_search_bm[dense,lane,F={len(lterms)},B={B_l},"
                              f"H={H_l}]", route="cuda",
                         source="autompc_torch/csrc/linesearch_fused.cu",
                         replaces="autompc_tpu/ops/pallas_linesearch.py:803",
                         launches=so["counts"][count]["K3[dense lane]"], **meas))
    # K3's per-lane batch-major entry past 64 terms on (e)'s fused carry.
    fan = so["fans"]["1"]
    _, carry0, _, make_body = make_batched_ilqr_solver(fan._pred_core, None,
                                                       return_pieces=True, **fan.solver_kw)
    jb = so["jbatch"]
    pj = {"coeffs": fan.train_lanes(jb["reg"])}
    xj = jb["Qdiag"].new_tensor(np.tile(so["init"], (JS_BIG_B, 1)))
    cpj = {k: jb[k] for k in ("Qdiag", "Rdiag", "Fdiag", "regw")}
    cj = carry0(pj, xj, xj.new_zeros((JS_BIG_B, JS_H, 1)), cpj)
    body = make_body(pj)
    for _ in range(3):
        cj = body(cj)
    plane = cj["params"]["coeffs"].permute(1, 2, 0).contiguous()
    bm, fails = check_k3_bm(f"(e)'s carry, F={fan.n_features}", K1, K3, K4,
                            tuple(fan.library.terms), plane, cj, so["S"], so["mu"],
                            kwd["dt"], alphas, float(kwd["ubounds"][1][0]),
                            plain=dict(reps=1, warm=0), device_time=True)
    failures += fails
    ce = so["counts"]["(e) fan-out 1"]
    rows.append(dict(name=f"fused_line_search_bm_lane[F={fan.n_features},B={JS_BIG_B},"
                          f"H={JS_H},reg]", route="cuda",
                     source="autompc_torch/csrc/linesearch_fused.cu",
                     replaces="autompc_tpu/ops/pallas_linesearch.py:803",
                     launches=ce["K3[lane past 64]"], **bm["reg"], no_reg=bm["no_reg"]))
    # K5's precisions.
    hc_model, hc_cost, hc_kw, hc_x0, _ = so["hc_run"]
    for prec in ("default", "bf16x3"):
        kwp = dict(hc_kw, H=H_HC, mlp_ls=dict(hc_kw["mlp_ls"], precision=prec))
        n = so["counts"][f"(f) cheetah {prec} B={B_HC} H={H_HC}"]
        r5, fails = check_batch_major_kernels(f"cheetah {prec}", hc_model, hc_cost, kwp, hc_x0,
                                              K4, K5, {"K5": n[f"K5[{prec}]"]}, k4=False,
                                              device_time=True)
        failures += fails
        rows += r5
    cp_model, cp_cost, _, cp_x0, _ = so["cp_run"]
    n = so["counts"][f"(f) cartpole MLP default, layout mxu B={B_DENSE}"]
    r5, fails = check_batch_major_kernels("cartpole mxu default", cp_model, cp_cost,
                                          dict(so["cp_kw_default"], H=H), cp_x0, K4, K5,
                                          {"K5": n["K5[default]"]}, k4=False, device_time=True)
    failures += fails
    rows += r5
    return rows


# ---- Phase 21: Koopman lifts past 24 states; K3's batch-major entry at dc > 1 ----------
# (a) the joint-Koopman fan-out (phase 15's cell, SCALE_MODE=joint_koopman)
#     on the cartpole at each lifted dimension of ``lifts`` (LIFTS_21: the
#     basis of each), backward="pallas" (K6's wide instance), and with the
#     GaussReg term (phase 19's, K4's wide instance at (N, 1)); with
#     ``scan`` also backward="scan" in the same call and the first MPC
#     step's agreement (1e-3 on the lanes converged in both, at least
#     FAN_AGREE_MIN as phases 15 and 19 hold H=10); (b) with ``tune``
#     candidates, a "joint_koopman" tune over KoopmanFactory's whole space
#     with fanout_backward="pallas": no candidate's lift is refused; (c)
#     phase 18 (d)'s cheetah SINDy (18, 6) solve with fuse_ls (K3's
#     multi-control instances) and, with ``hc_unfused``, without (K7) and
#     with the scan backward pass: solves/s, converged shares, the fused
#     body's agreement with the unfused within 1e-3 on the lanes converged
#     in both, gated at the scan-vs-pallas share of the same call less
#     SO_SHARE_SLACK (two float32 bodies part on a share of the lanes at
#     H=200: ROADMAP §C hazard 7); (d) QuadCostFanout(fuse_ls=True) on the
#     cheetah SINDy and, with ``joint_sindy``, JointSINDyQuadCostFanout
#     (fuse_ls=True, per-lane coefficients) on the cheetah's data.
# The shape phase 21 builds beside the main library (K3's multi-control
# instances at the cheetah's (18, 6)); the wide K6 and K4 are the main
# library's.
SHAPES_21 = (("linesearch_fused_mc", 18, 6),)
LIFTS_21 = {28: dict(trig_basis=True, trig_freq=3),
            56: dict(poly_basis=True, poly_degree=8, trig_basis=True, trig_freq=3),
            72: dict(poly_basis=True, poly_degree=2, trig_basis=True, trig_freq=8),
            96: dict(poly_basis=True, poly_degree=8, trig_basis=True, trig_freq=8)}
LM_H = 10
# chip_smoke.py's depth (LM_SMOKE) and tools/torch_lift_multicontrol_phase.py's
# (LM_FULL): the fan-out's batch and MPC steps, the cheetah solve's batch
# and horizon, the cheetah fan-outs' batch and steps.
LM_SMOKE = dict(lifts=(28, 72, 96), B=256, steps=2, scan=False, tune=0, hc_B=256, hc_H=50,
                hc_unfused=False, fan_B=64, fan_steps=2, joint_sindy=False)
LM_FULL = dict(lifts=(28, 56, 72, 96), B=JK_B, steps=5, scan=True, tune=8, hc_B=B_HC, hc_H=H_HC,
               hc_unfused=True, fan_B=256, fan_steps=5, joint_sindy=True)
LM_SEED = 21
# (a)'s first-step agreement is gated where at least this many lanes
# converged in both bodies. At 56 and 96 lifted states (polynomials to
# degree 8: the cartpole's velocities to the 8th power reach ~4e12) every
# lane's float32 Lasso fit is NaN, in the JAX package's fista_lasso as in
# the port's (the same iteration; PERF.md §6), so no lane converges in
# either body and the fan-out scores every candidate inf, as JAX's does;
# lanes that did not converge are no comparison (ROADMAP §C hazard 1).
# The lanes' finite models are counted beside it.
LM_MIN_BOTH = 8
LM_HC_SCHEDULE = HC_SCHEDULE
# The cheetah fan-outs: phase 18 (d)'s library, the Lasso alphas of the
# joint fan-out's lanes.
LM_JS_BUCKET = dict(method="lasso", poly_basis=True, poly_degree=2)


def cheetah_sindy(hc, hc_trajs):
    """Phase 18 (d)'s cheetah SINDy (HC_SINDY on phase 6's data), its
    fixed cost and its solver keywords (unfused, as phase 18 runs it):
    the sp keys ``hm``, ``hcost``, ``hkw`` that phase 21 reads."""
    from autompc_torch.costs import QuadCost
    from autompc_torch.sysid import SINDy

    hm = SINDy(hc.system, **HC_SINDY)
    hm.train(hc_trajs)
    hco = hm.coeffs.cpu().numpy()
    if not np.isfinite(hco).all():
        raise RuntimeError("cheetah SINDy fit produced non-finite coefficients")
    h_active = tuple(int(k) for k in np.flatnonzero(np.any(hco != 0, axis=0)))
    hcost = QuadCost(hc.system, np.eye(18), 0.01 * np.eye(6), np.eye(18), goal=np.zeros(18))
    hb = hc.task.get_ctrl_bounds()
    hkw = dict(ds=18, dc=6, obsdim=18, dt=hc.system.dt, ubounds=(hb[:, 0], hb[:, 1]),
               backward="pallas", feature_spec=(hm.library, "coeffs"), feature_mask=h_active,
               fuse_ls=False, lanes_last=False)
    return dict(hm=hm, hcost=hcost, hkw=hkw, h_active=h_active)


def cheetah_candidates(dev, n, seed=0):
    """Cost candidates of the cheetah's fan-outs: Qdiag, Fdiag (n, 18) =
    10**U(-1, 1), Rdiag (n, 6) = 10**U(-3, -1), reg (the Lasso alpha) =
    10**U(-4, -2)."""
    rng = np.random.default_rng(seed)
    batch = {"Qdiag": 10 ** rng.uniform(-1, 1, (n, 18)), "Fdiag": 10 ** rng.uniform(-1, 1, (n, 18)),
             "Rdiag": 10 ** rng.uniform(-3, -1, (n, 6)), "reg": 10 ** rng.uniform(-4, -2, n)}
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in batch.items()}


def lift_counts(K4, K6):
    """The wide instances' launches by lifted dimension, K6's and K4's."""
    return (dict(K6.backward_quad.launches_big_by_ds), dict(K4.riccati_general.launches_big_by_ds))


def reset_lift_counts(K4, K6):
    for w in (K6.backward_quad, K4.riccati_general):
        w.launches, w.launches_by_B, w.launches_big, w.launches_big_by_ds = 0, {}, 0, {}


def lift_multicontrol_phase(dev, card, mods, bench, model, trajs, sp, hc, hc_trajs,
                            size=LM_SMOKE):
    """Phase 21 (a)-(d) (see LIFTS_21); ``mods`` the kernel modules (K1,
    K2, K3, K4), ``sp`` phase 18's results (the cheetah's SINDy ``hm``,
    its cost and solver keywords), ``hc`` the halfcheetah benchmark and
    ``hc_trajs`` phase 6's data, the
    cartpole's ``bench``, ``model``, ``trajs`` (phase 2). Each path's
    kernels are counted from 0 just before it and read just after.
    Returns what ``check_lift_multicontrol_kernels`` reads."""
    from autompc_torch.control import make_scheduled_ilqr_solver, parse_schedule
    from autompc_torch.parallel import (JointKoopmanLassoQuadCostFanout,
                                        JointSINDyQuadCostFanout, QuadCostFanout)
    from autompc_torch.sysid import Koopman
    from autompc_torch.sysid.arx import linear_pred
    from autompc_torch.tuning.pipeline_tuner import _gauss_reg_stats

    K1, K2, K3, K4 = mods
    t_phase = time.perf_counter()
    system = bench.system
    S, mu = _gauss_reg_stats(trajs)
    batch = gauss_reg_candidates(dev, size["B"], LM_SEED)
    batch["reg"] = batch["Qdiag"].new_tensor(10 ** np.random.default_rng(LM_SEED).uniform(
        -6, 0, size["B"]))
    out = dict(jk={}, rates={}, counts={})

    # ---- (a) the joint-Koopman fan-out at each lift ----------------------------
    for N in size["lifts"]:
        basis = LIFTS_21[N]
        for reg in (False, True):
            kw = dict(reg_matrix=S, reg_goal=mu) if reg else {}
            b = batch if reg else {k: v for k, v in batch.items() if k != "regw"}
            tag = f"N={N}{', GaussReg' if reg else ''}"
            fans, fan_scores = {}, {}
            for backward in (("scan", "pallas") if size["scan"] else ("pallas",)):
                fan = JointKoopmanLassoQuadCostFanout(
                    system, bench.task, basis, trajs, model, horizon=LM_H,
                    n_steps=size["steps"], goal=np.zeros(4), compact_schedule=JK_SCHEDULE,
                    backward=backward, **kw)
                if fan.state_dim != N:
                    raise RuntimeError(f"phase 21 (a): the basis {basis} lifts to "
                                       f"{fan.state_dim}, not {N}")
                reset_lift_counts(K4, K2)
                warm, per_call, scores = timed_runs(lambda: fan(b), 1)
                k6n, k4n = lift_counts(K4, K2)
                n_wide = (k4n if reg else k6n).get(N, 0)
                fin = torch.isfinite(scores)
                rate = size["B"] / per_call
                out["rates"][f"(a) {tag} {backward}"] = rate
                out["counts"][f"(a) {tag} {backward}"] = dict(K6=k6n, K4=k4n)
                print(f"[21a] joint-Koopman fan-out {tag} ({basis}), backward={backward!r}: "
                      f"B={size['B']} H={LM_H}, {size['steps']} steps: warm call {warm:.2f} s, "
                      f"timed call {per_call:.3f} s -> {rate:.1f} evals/s on {card}; finite "
                      f"{int(fin.sum())} / {size['B']}; {'K4' if reg else 'K6'} wide launches "
                      f"{n_wide} (K6 {k6n}, K4 {k4n})", flush=True)
                if tuple(scores.shape) != (size["B"],) or torch.isnan(scores).any():
                    raise RuntimeError(f"phase 21 (a) {tag} {backward}: malformed or NaN scores")
                if (backward == "pallas") != bool(n_wide):
                    raise RuntimeError(f"phase 21 (a) {tag} {backward}: wide launches {n_wide}")
                fans[backward], fan_scores[backward] = fan, scores
            params = fans["pallas"].train_lanes(b["reg"])
            models_finite = int((torch.isfinite(params["A"]).flatten(1).all(1)
                                 & torch.isfinite(params["B"]).flatten(1).all(1)).sum())
            print(f"[21a] {tag}: the lanes' float32 Lasso fits finite on {models_finite} of "
                  f"{size['B']}", flush=True)
            cp = {k: b[k] for k in ("Qdiag", "Rdiag", "Fdiag") + (("regw",) if reg else ())}
            km = Koopman(system, method="lstsq", **basis)
            z0 = km._apply_basis(b["Qdiag"].new_tensor(np.tile(bench.task.get_init_obs(),
                                                               (size["B"], 1))))
            if size["scan"]:
                ug = z0.new_zeros((size["B"], LM_H, 1))
                sols = {bk: make_scheduled_ilqr_solver(
                    linear_pred, None, schedule=parse_schedule(JK_SCHEDULE),
                    **fans[bk].solver_kw)(params, z0, ug, cp) for bk in fans}
                obj = {bk: (reg_lane_objective(o[1][..., :4], o[2], cp, system.dt, S, mu) if reg
                            else lane_objective(o[1][..., :4], o[2], cp, system.dt))
                       for bk, o in sols.items()}
                both = sols["scan"][0] & sols["pallas"][0]
                rel = ((obj["scan"] - obj["pallas"]).abs()
                       / obj["pallas"].abs().clamp_min(1e-30))[both]
                share = float((rel <= FAN_OBJ_TOL).float().mean()) if both.any() else 0.0
                # The fan-out's scores (task costs of the closed loops) of the
                # two bodies, on the candidates finite in both.
                sa, sb = fan_scores["scan"], fan_scores["pallas"]
                fs = torch.isfinite(sa) & torch.isfinite(sb)
                s_share = float(((sa - sb).abs() <= FAN_OBJ_TOL * sb.abs().clamp_min(1e-30))[fs]
                                .float().mean()) if fs.any() else 0.0
                out["rates"][f"(a) {tag} agreement"] = share
                out["rates"][f"(a) {tag} score agreement"] = s_share
                gated = int(both.sum()) >= LM_MIN_BOTH
                print(f"[21a] {tag} first MPC step, scan vs pallas: converged "
                      f"{int(sols['scan'][0].sum())}, {int(sols['pallas'][0].sum())}, both "
                      f"{int(both.sum())} of {size['B']}; accepted objectives within "
                      f"{FAN_OBJ_TOL} on {share:.4f} (min {FAN_AGREE_MIN}"
                      + ("" if gated else f"; not gated: fewer than {LM_MIN_BOTH} lanes "
                                          f"converged in both") + f"); the fan-out's scores "
                      f"within {FAN_OBJ_TOL} on {s_share:.4f} of the {int(fs.sum())} finite in "
                      f"both", flush=True)
                if gated and share < FAN_AGREE_MIN:
                    raise RuntimeError(f"phase 21 (a) {tag}: {int(both.sum())} lanes converged "
                                       f"in both, objectives agree on {share:.4f}")
            out["jk"][(N, reg)] = dict(fan=fans["pallas"], params=params, z0=z0, cp=cp,
                                       launches=n_wide, models_finite=models_finite)

    # ---- (b) a "joint_koopman" tune over the whole Koopman space ----------------
    if size["tune"]:
        from autompc_torch.control import IterativeLQRFactory
        from autompc_torch.costs import QuadCostFactory
        from autompc_torch.pipeline import Pipeline
        from autompc_torch.sysid import KoopmanFactory
        from autompc_torch.tuning import PipelineTuner

        pipe = Pipeline(system, KoopmanFactory(system), QuadCostFactory(system, goal=np.zeros(4)),
                        IterativeLQRFactory(system, horizon=LM_H))
        task = bench.task.copy()
        task.set_num_steps(size["steps"] + 1)
        tuner = PipelineTuner(surrogate_mode="pretrain", eval_batch=size["tune"],
                              use_fanout=True, fanout_backward="pallas")
        reset_lift_counts(K4, K2)
        t0 = time.perf_counter()
        _, res = tuner.run(pipe, task, trajs, n_iters=size["tune"],
                           rng=np.random.default_rng(LM_SEED), surrogate=model)
        torch.cuda.synchronize()
        k6n, k4n = lift_counts(K4, K2)
        lifts = []
        for cfg in res.cfgs:
            d = cfg.get_dictionary()
            p, t = d.get("_model:poly_basis") == "true", d.get("_model:trig_basis") == "true"
            lifts.append(4 * (1 + (int(d.get("_model:poly_degree", 1)) - 1) * p
                              + 2 * int(d.get("_model:trig_freq", 0)) * t))
        n_inf = int(np.sum(~np.isfinite(res.costs)))
        refused = [n for n in lifts if n > min(K2._build.BQBM_BIG_MAX_DS,
                                               K2._build.RG_BIG_MAX_DS)]
        out["rates"]["(b) tune evals/s"] = len(res.costs) / (time.perf_counter() - t0)
        out["counts"]["(b) tune"] = dict(K6=k6n, K4=k4n)
        print(f"[21b] joint_koopman tune over KoopmanFactory's space, fanout_backward='pallas': "
              f"{len(res.costs)} candidates in {time.perf_counter() - t0:.2f} s; lifts {lifts}; "
              f"scores not finite {n_inf} (a bad model, never a refusal: lifts past the wide "
              f"instances {refused}); K6 wide launches {k6n}, K4 {k4n}", flush=True)
        if refused:
            raise RuntimeError(f"phase 21 (b): lifts {refused} past the wide instances")

    # ---- (c) the cheetah SINDy (18, 6) solve, fused -----------------------------
    hm, hcost, hkw = sp["hm"], sp["hcost"], sp["hkw"]
    hB, hH = size["hc_B"], size["hc_H"]
    hx0 = cheetah_x0(dev)[:hB].contiguous()
    hug = torch.zeros((hB, hH, 6), dtype=torch.float32, device=dev)
    bodies = {"fused": dict(hkw, fuse_ls=True)}
    if size["hc_unfused"]:
        bodies.update(unfused=dict(hkw, fuse_ls=False),
                      scan=dict(hkw, fuse_ls=False, backward="scan"))
    sols = {}
    for name, kw in bodies.items():
        solve = make_scheduled_ilqr_solver(hm.pred_core, hcost, H=hH, max_iter=50,
                                           schedule=parse_schedule(LM_HC_SCHEDULE), **kw)
        K3.reset_bm_counters()
        for w in (K1.relin_jacobians_bm, K4.riccati_general, K3.sindy_line_search):
            w.launches = 0
        warm, per_call, sol = timed_runs(lambda: solve(hm.params, hx0, hug), 1)
        n = dict(K3_mc=K3.fused_line_search_bm.launches_mc,
                 K1=K1.relin_jacobians_bm.launches, K4=K4.riccati_general.launches,
                 K7=K3.sindy_line_search.launches)
        conv = sol[0].float().mean().item()
        finite = torch.isfinite(sol[1]).all(dim=(1, 2)).float().mean().item()
        out["rates"][f"(c) cheetah {name} solves/s"] = hB / per_call
        out["counts"][f"(c) cheetah {name}"] = n
        sols[name] = sol
        print(f"[21c] cheetah SINDy (18, 6) solve, {name} (backward {kw['backward']!r}, fuse_ls "
              f"{kw['fuse_ls']}): B={hB} H={hH}: warm {warm:.2f} s, timed {per_call:.3f} s -> "
              f"{hB / per_call:.1f} solves/s on {card}; converged {conv:.4f}, lanes finite "
              f"{finite:.4f}; launches {n}", flush=True)
        if not all(torch.isfinite(o[sol[0]]).all() for o in sol[1:]):
            raise RuntimeError(f"phase 21 (c) cheetah {name}: non-finite on a converged lane")
        if name == "fused" and not (n["K3_mc"] and n["K1"] and n["K4"]) or \
                name == "fused" and n["K7"]:
            raise RuntimeError(f"phase 21 (c): the fused cheetah solve's kernels {n}")
    if size["hc_unfused"]:
        def share(a, b):
            oa, ob = (so_objective(hcost, s[1], s[2], hkw["dt"]) for s in (a, b))
            both = a[0] & b[0]
            rel = ((oa - ob).abs() / ob.abs().clamp_min(1e-30))[both]
            return (float((rel <= FAN_OBJ_TOL).float().mean()) if both.any() else 0.0,
                    int(both.sum()))
        ref, n_ref = share(sols["scan"], sols["unfused"])
        got, n_got = share(sols["fused"], sols["unfused"])
        out["rates"]["(c) agreement fused/unfused"] = got
        out["rates"]["(c) agreement scan/pallas"] = ref
        print(f"[21c] cheetah SINDy: fused vs unfused within {FAN_OBJ_TOL} on {got:.4f} of "
              f"{n_got} lanes converged in both; scan vs pallas (unfused) {ref:.4f} of {n_ref} "
              f"(the floor: {ref - SO_SHARE_SLACK:.4f}); fused / unfused solves/s "
              f"{out['rates']['(c) cheetah fused solves/s'] / out['rates']['(c) cheetah unfused solves/s']:.3f}",
              flush=True)
        if got < ref - SO_SHARE_SLACK:
            raise RuntimeError(f"phase 21 (c): fused vs unfused agree on {got:.4f}, under the "
                               f"scan-vs-pallas share {ref:.4f} less {SO_SHARE_SLACK}")
    out["hc"] = dict(hm=hm, hcost=hcost, hkw=dict(hkw, fuse_ls=True), hx0=hx0, hH=hH,
                     launches=out["counts"]["(c) cheetah fused"]["K3_mc"])

    # ---- (d) the cheetah's fan-outs with fuse_ls ---------------------------------
    cand = cheetah_candidates(dev, size["fan_B"], LM_SEED)
    task = hc.task.copy()
    task.set_num_steps(size["fan_steps"] + 1)
    h_goal = np.zeros(18)
    fan_list = [("QuadCostFanout", lambda: QuadCostFanout(
        hc.system, task, hm, hm, horizon=LM_H, n_steps=size["fan_steps"], goal=h_goal,
        compact_schedule=JS_SCHEDULE, backward="pallas", feature_spec=(hm.library, "coeffs"),
        fuse_ls=True), {k: v for k, v in cand.items() if k != "reg"})]
    if size["joint_sindy"]:
        fan_list.append(("JointSINDyQuadCostFanout", lambda: JointSINDyQuadCostFanout(
            hc.system, task, LM_JS_BUCKET, hc_trajs, hm, horizon=LM_H,
            n_steps=size["fan_steps"], goal=h_goal, compact_schedule=JS_SCHEDULE,
            backward="pallas", use_feature_kernels=True, fuse_ls=True), cand))
    for name, make, b in fan_list:
        fan = make()
        K3.reset_bm_counters()
        warm, per_call, scores = timed_runs(lambda: fan(b), 1)
        n = dict(K3_mc=K3.fused_line_search_bm.launches_mc,
                 K3_mc_lane=K3.fused_line_search_bm.launches_lane)
        fin = int(torch.isfinite(scores).sum())
        out["rates"][f"(d) {name} evals/s"] = size["fan_B"] / per_call
        out["counts"][f"(d) {name}"] = n
        print(f"[21d] {name}(fuse_ls=True) on the cheetah SINDy: B={size['fan_B']} H={LM_H}, "
              f"{size['fan_steps']} steps: warm {warm:.2f} s, timed {per_call:.3f} s -> "
              f"{size['fan_B'] / per_call:.1f} evals/s on {card}; finite {fin} / "
              f"{size['fan_B']}; K3 multi-control launches {n}", flush=True)
        if torch.isnan(scores).any() or not n["K3_mc"]:
            raise RuntimeError(f"phase 21 (d) {name}: NaN scores or K3 never ran at dc > 1")
    print(f"[21] phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    return out


def k3_mc_bound(io_bytes, B, H, terms, L, ds, dc, obsdim, dense):
    """K3's bound keys at dc > 1 (``k3_bound``'s count): L rollout-steps a
    lane-step (the term values and coefficient products, dc feedback sums
    of ds products, the state and control forms, du2) and one evaluation
    of the Jacobian; its scratch (every candidate's ds + dc floats a
    lane-step, the chosen one read back) beside it."""
    forms = 3 * obsdim * (obsdim if dense else 1) + 3 * dc * (dc if dense else 1)
    step = feature_value_flops(terms, ds) + dc * (2 * ds + 4) + forms + 3 * dc + 4
    ops = B * H * (L * step + feature_jac_flops(terms, ds))
    stash = 4 * (ds + dc) * H * B * (L + 1)
    return dict(bound_keys(io_bytes, ops), scratch_bytes_ms=stash / HBM_BYTES_PER_S * 1e3)


def check_lift_multicontrol_kernels(lm, mods, failures):
    """Phase 21's kernels against their plain versions: K6's and K4's wide
    instance at each lift on (a)'s first backward pass of its first MPC
    step (K6 on the carry from the zero control guess, K4 on that pass's
    dense expansions, GaussReg) and on well-conditioned inputs at the
    same shape (``tools/ab_torch_kernels.py``'s ``k6_wide_inputs`` and
    ``k4_inputs``: near-identity Jacobians, every lane finite), each by
    ``check_backward`` at TOL_K6 / TOL_K4. (Later iterations' feedforward
    terms near a converged trajectory are differences of nearly equal
    float32 numbers: there the plain float32 version itself is 0.3-0.9 off
    float64 per lane, no test of the kernel.) A row takes the path's
    check where the lift's models are finite on some lane, else (the
    float32 Lasso fits of the polynomial degree-8 lifts are NaN on every
    lane, as the JAX package's are: PERF.md §6) the well-conditioned
    inputs', named in ``inputs``; each kind of instance must be held on
    some path. K3's multi-control instances on (c)'s fused carry one
    iteration in (decisions on K3_FAN_AGREE_MIN of the active lanes,
    states of equal decisions within TOL_K3 on K3_FAN_WITHIN_MIN of them,
    the objective to TOL_K3, the Jacobians against the plain version's to
    TOL_K1; at the kernel's own trajectories against float64: the
    objective and du2 to TOL_K3, the Jacobians to TOL_K1). Returns report
    rows."""
    from autompc_torch.control import make_batched_ilqr_solver
    from autompc_torch.sysid.arx import linear_pred

    K1, K2, K3, K4 = mods
    rows, on_path = [], {"K6": 0, "K4": 0}
    for (N, reg), d in sorted(lm["jk"].items()):
        fan, params, z0, cp = d["fan"], d["params"], d["z0"], d["cp"]
        B = z0.shape[0]
        if reg:
            kind, kernel, plain, tol = "K4", K4.riccati_general, K4.riccati_general_plain, TOL_K4
            args = capture_k4(K4, linear_pred, fan.solver_kw, params, z0, cp, n_iters=0)
            synth = k4_inputs(N, 1, B, LM_H, z0.device)
            ops = B * LM_H * riccati_flops(N, 1)
        else:
            kind, kernel, plain, tol = "K6", K2.backward_quad, K2.backward_quad_plain, TOL_K6
            _, carry0, _, _ = make_batched_ilqr_solver(
                linear_pred, None, return_pieces=True, **fan.solver_kw)
            c = carry0(params, z0, z0.new_zeros((B, LM_H, 1)), cp)
            args = (c["Jx"], c["Ju"], c["xs"], c["us"], c["cost"]["Qdiag"],
                    c["cost"]["Rdiag"], c["cost"]["Fdiag"], (0.0,) * 4, fan.solver_kw["dt"], 4)
            synth = k6_wide_inputs(B, LM_H, z0.device, N)
            ops = B * LM_H * (riccati_flops(N, 1) + 4 * N)
        n_in = 8 if reg else 7
        name = (f"backward_quad[ds={N},wide,B={B},H={LM_H}]" if kind == "K6"
                else f"riccati_general[{N},1,wide,B={B},H={LM_H}]")
        head = dict(name=name, route="cuda", source="autompc_torch/csrc/riccati_big.cuh",
                    replaces="autompc_tpu/ops/pallas_riccati.py:" + ("456" if kind == "K6"
                                                                     else "1338"),
                    launches=d["launches"])
        s_row, fails, _ = check_backward(
            f"{kind} wide instance at ({N}, 1), well-conditioned inputs H={LM_H}", kernel,
            plain, synth, tol, dict(head, inputs="well-conditioned"), ops, n_in, True)[:3]
        failures += fails
        if s_row["lanes_checked"] < B:
            failures.append(f"{kind} wide ({N}, 1): {B - s_row['lanes_checked']} lanes of the "
                            f"well-conditioned inputs not finite")
        if d["models_finite"]:
            row, fails, _ = check_backward(
                f"{kind} wide instance at ({N}, 1), (a)'s first backward pass H={LM_H} "
                f"({d['models_finite']} lanes' models finite)", kernel, plain, args, tol,
                dict(head, inputs="path"), ops, n_in, True)[:3]
            failures += fails
            on_path[kind] += 1
            row.update(synthetic_max_abs_err=s_row["max_abs_err"])
        else:
            print(f"[3] {kind} wide instance at ({N}, 1): no lane's model of (a) is finite (the "
                  f"float32 Lasso fits); the row holds the well-conditioned inputs' check",
                  flush=True)
            row = s_row
        g = (K2.bq_bm_geometry(B, LM_H, N) if kind == "K6"
             else K4.general_geometry(N, 1, B))
        print(f"[3] {kind} wide instance at ({N}, 1) B={B} H={LM_H} ({g['threads']} threads a "
              f"block, one lane, {g['blocks']} blocks, {g['smem']} bytes of shared memory), "
              f"{row['inputs']} inputs: kernel {row['ms']:.4f} ms (device "
              f"{row['device_ms']:.4f}), plain {row['plain_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}); {d['launches']} launches on (a)",
              flush=True)
        rows.append(row)
    for kind, n in on_path.items():
        if not n:
            failures.append(f"{kind}'s wide instance was held on no path's inputs")

    # K3 at dc > 1 on (c)'s fused carry.
    h = lm["hc"]
    hm, hkw, hx0, hH = h["hm"], h["hkw"], h["hx0"], h["hH"]
    B = hx0.shape[0]
    active = hkw["feature_mask"]
    terms = tuple(hm.library.terms[k] for k in active)
    coeffs = hm.coeffs[:, list(active)].contiguous()
    from autompc_torch.control import ilqr

    _, carry0, _, make_body = make_batched_ilqr_solver(hm.pred_core, h["hcost"], H=hH,
                                                       return_pieces=True, **hkw)
    c = carry0(hm.params, hx0, hx0.new_zeros((B, hH, 6)))
    body = make_body(hm.params)
    c = body(c)
    # The next iteration's backward pass on this carry (its inputs captured;
    # K4's plain version gives the gains the line search takes).
    captured, real = [], ilqr.riccati_general
    ilqr.riccati_general = lambda *a: (captured.append(a), K4.riccati_general_plain(*a))[1]
    try:
        body(c)
    finally:
        ilqr.riccati_general = real
    Ks, ks, lin, quad = K4.riccati_general_plain(*captured[0])
    ks_small = torch.sqrt((ks * ks).sum(dim=(1, 2))) < 1e-3
    ub = hkw["ubounds"]
    planes = (c["x0s"].new_ones((18, B)), c["x0s"].new_full((6, B), 0.01),
              c["x0s"].new_ones((18, B)))
    alphas = tuple(0.2 ** k for k in range(10))
    base = (terms, c["x0s"], c["xs"], c["us"], Ks.contiguous(), ks.contiguous(), coeffs, alphas,
            np.asarray(ub[0]), np.asarray(ub[1]), *planes, (0.0,) * 18, hkw["dt"], c["obj"], lin,
            quad, ks_small)
    kk = K3.fused_line_search_bm(*base)
    # The plain version takes seconds a call at this shape: the check's own
    # call is its one timed run.
    kp, kp_ms = plain_once(lambda: K3.fused_line_search_bm_plain(*base), dict(reps=1, warm=0))
    act = ~c["converged"] & ~c["failed"]

    def lane_finite(o):
        return torch.stack([torch.isfinite(t.float()).reshape(B, -1).all(1) for t in o]).all(0)

    kernel_only = int((~lane_finite(kk) & lane_finite(kp)).sum())
    same_flags = (kk[3] == kp[3]) & (kk[4] == kp[4])
    same_obj = (kk[2] - kp[2]).abs() <= K3_TIE * kp[2].abs()
    agree_lane = same_flags & same_obj
    agree = agree_lane[act].float().mean().item() if act.any() else 1.0
    n_differ = int((act & ~agree_lane).sum())
    lanes = agree_lane & lane_finite(kk) & lane_finite(kp)
    dx = (kk[0][lanes].double() - kp[0][lanes].double()).abs().amax(dim=(1, 2))
    within = (dx <= TOL_K3 * kp[0][lanes].double().abs().amax(dim=(1, 2)).clamp_min(1e-30))
    within = within.float().mean().item() if lanes.any() else 1.0
    e_obj = rel_err(kk[2][lanes], kp[2][lanes]) if lanes.any() else 0.0
    e_jac = max(rel_err(kk[5][lanes], kp[5][lanes]), rel_err(kk[6][lanes], kp[6][lanes])) \
        if lanes.any() else 0.0
    # Against float64 at the kernel's own trajectories (its finite lanes):
    # the objective under the cost planes (hcost's diagonals), du2, the
    # Jacobians.
    fin = lane_finite(kk)
    if fin.any():
        obj64 = so_objective(h["hcost"], kk[0], kk[1], hkw["dt"])
        e_obj64 = float(((kk[2].double() - obj64).abs() / obj64.abs().clamp_min(1e-30))[fin].max())
        du2_64 = ((kk[1].double() - c["us"].double()) ** 2).sum(dim=(1, 2))
        e_du2 = rel_err(kk[7][fin], du2_64[fin])
        j64 = K1.relin_jacobians_bm_plain(terms, kk[0][fin].double(), kk[1][fin].double(),
                                          coeffs.double())
        e_jac64 = max(rel_err(kk[5][fin], j64[0]), rel_err(kk[6][fin], j64[1]))
    else:
        e_obj64 = e_du2 = e_jac64 = float("inf")
    print(f"[3] K3 batch-major at dc > 1, (c)'s cheetah carry (18, 6) B={B} H={hH}: active "
          f"lanes {int(act.sum())}; not finite only in the kernel {kernel_only}; decisions agree "
          f"with the plain version on {agree:.5f} of the active lanes ({n_differ} differ; min "
          f"{K3_FAN_AGREE_MIN}); on the {int(lanes.sum())} lanes of equal decisions: states "
          f"within {TOL_K3} on {within:.4f} (min {K3_FAN_WITHIN_MIN}), objective {e_obj:.3e}, "
          f"Jacobians {e_jac:.3e} (tol {TOL_K1}); vs float64 at the kernel's trajectories "
          f"({int(fin.sum())} finite lanes): objective {e_obj64:.3e}, du2 {e_du2:.3e} (tol "
          f"{TOL_K3}), Jacobians {e_jac64:.3e} (tol {TOL_K1})", flush=True)
    if kernel_only or n_differ > max(1, int((1 - K3_FAN_AGREE_MIN) * int(act.sum()))) \
            or within < K3_FAN_WITHIN_MIN or e_obj > TOL_K3 or e_jac > TOL_K1 \
            or not lanes.any() or max(e_obj64, e_du2) > TOL_K3 or e_jac64 > TOL_K1:
        failures.append(f"K3 at dc > 1 (cheetah): kernel-only non-finite {kernel_only}, agree "
                        f"{agree:.5f}, within {within:.4f}, obj {e_obj:.3e}, jac {e_jac:.3e}, "
                        f"lanes of equal decisions {int(lanes.sum())}, obj64 {e_obj64:.3e}, "
                        f"du2 {e_du2:.3e}, jac64 {e_jac64:.3e}")
    tensors = [t for t in base if isinstance(t, torch.Tensor)]
    rows.append(dict(
        name=f"fused_line_search_bm[18x6,B={B},H={hH}]", route="cuda",
        source="autompc_torch/csrc/linesearch_fused_mc.cu",
        replaces="autompc_tpu/ops/pallas_linesearch.py:803", launches=h["launches"],
        max_abs_err=abs_err(kk[0][lanes], kp[0][lanes]) if lanes.any() else None,
        ms=time_ms(lambda: K3.fused_line_search_bm(*base), reps=5),
        device_ms=device_ms(lambda: K3.fused_line_search_bm(*base)),
        plain_ms=kp_ms,
        **k3_mc_bound(n_bytes(*tensors, *kk), B, hH, terms, len(alphas), 18, 6, 18, False)))
    return rows


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
    from autompc_torch.sysid import SINDy

    card = card_line()
    print(f"[0] card: {card} | torch {torch.__version__} | "
          f"cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    # The main library and phase 18's shapes (built at first use from the
    # same sources), one nvcc a source or shape, all started together,
    # before any timed window.
    t0 = time.perf_counter()
    _build.build_shapes(SHAPES_18 + SHAPES_19 + SHAPES_21, main=True)
    print(f"[1] build/load kernels: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name}, and phases 18's, 19's and 21's shapes "
          f"{SHAPES_18 + SHAPES_19 + SHAPES_21})", flush=True)
    # Registers a thread (ptxas) and resident warps an SM: K3 and K5 from
    # the CUDA occupancy query at each shape their paths launch; the other
    # kernels' 64-thread blocks bounded by registers alone.
    for name, regs, spill in ptxas_report(_build.build_log()):
        print(f"    ptxas: {name}: {regs} registers, {spill} bytes spilled, <= "
              f"{min(64, 65536 // (-(-regs // 8) * 8 * 32))} warps an SM by registers")
    for shape in SHAPES_18 + SHAPES_19 + SHAPES_21:
        for name, regs, spill in ptxas_report(_build.shape_build_log(*shape)):
            print(f"    ptxas {shape[0]} ({shape[1]}, {shape[2]}): {name}: {regs} registers, "
                  f"{spill} bytes spilled")
    for tag, B, lane, bf16, coef in (
            ("main path", B_SOLVE, 0, 0, 0), ("main path", B_KERNEL, 0, 0, 0),
            ("fan-out, per-lane cost", FAN_B, 1, 0, 0), ("llb, bf16 carry", B_SOLVE, 0, 1, 0),
            ("joint fan-out, per-lane coefficients", JS_B, 1, 0, 1),
            ("joint fan-out, per-lane coefficients past 64 terms", JS_BIG_B, 1, 0, 2)):
        g = K3.fused_geometry(B, 10, _build.sm_count(dev))
        o = _build.occupancy("ampc_fused_line_search_occupancy", lane, bf16, coef,
                             g["threads"], dev.index or 0)
        print(f"[1] K3 {tag} B={B}: {g['lanes_per_block']} lanes x 10 = {g['threads']} threads, "
              f"{g['blocks']} blocks; {o['registers']} registers, {o['local_bytes']} local "
              f"bytes; {o['blocks_per_sm']} blocks = "
              f"{o['blocks_per_sm'] * -(-g['threads'] // 32)} warps resident an SM", flush=True)
    # K3's batch-major instances at phase 13's batch.
    for lane, reg in ((0, 1), (1, 1), (0, 0), (1, 0)):
        g = K3.fused_geometry(FAN_B, 10, _build.sm_count(dev))
        o = _build.occupancy("ampc_fused_line_search_bm_occupancy", lane, reg, g["threads"],
                             dev.index or 0)
        print(f"[1] K3 batch-major{' with the GaussReg term' if reg else ''}, "
              f"{'per-lane' if lane else 'shared'} coefficients, B={FAN_B}: "
              f"{g['lanes_per_block']} lanes x 10 = {g['threads']} threads, {g['blocks']} blocks; "
              f"{o['registers']} registers, {o['local_bytes']} local bytes; "
              f"{o['blocks_per_sm']} blocks = {o['blocks_per_sm'] * -(-g['threads'] // 32)} warps "
              f"resident an SM", flush=True)
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
                           ("dense cartpole", 4, 1, B_DENSE), ("joint Koopman", 12, 1, JK_B),
                           ("joint Koopman, second basis", 8, 1, DS_JK2_B),
                           ("pendulum joint MLP", 2, 1, 8)):
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
    cp_model, cp_cost, cp_kw = dense_cartpole_problem(bench, trajs)
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

    # ---- [12] the joint-SINDy fan-out and tune ---------------------------------
    t12 = time.perf_counter()
    js_wrappers = joint_counters(K1, K2, K3)
    js = joint_sindy_phase(bench, model, trajs, dev, card, js_wrappers, profile=profile)
    js_tune, js_split = joint_sindy_tune(bench, model, trajs, dev, card, js_wrappers["b"])
    print(f"[12] phase wall {time.perf_counter() - t12:.2f} s", flush=True)

    # ---- [13] the GaussReg / SumCost costs ------------------------------------
    t13 = time.perf_counter()
    gr_wrappers = gauss_reg_counters(K1, K3, K4)
    gr = gauss_reg_phase(bench, model, trajs, dev, card, gr_wrappers)
    gr_tune = gauss_reg_tune(bench, model, trajs, dev, card, gr_wrappers["2"])
    print(f"[13] phase wall {time.perf_counter() - t13:.2f} s", flush=True)

    # ---- [14] the MPPI and direct-transcription controllers ----------------------
    t14 = time.perf_counter()
    controllers_phase(bench, model, trajs, hc, dflt[0], dev, card)
    controller_tunes(bench, model, trajs, card)
    print(f"[14] phase wall {time.perf_counter() - t14:.2f} s", flush=True)

    # ---- [15] the linear models ------------------------------------------------
    t15 = time.perf_counter()
    lm = linear_models_phase(bench, model, trajs, dev, card, K2)
    lm_tune_by_B = linear_tunes(bench, model, trajs, card, K2)
    print(f"[15] phase wall {time.perf_counter() - t15:.2f} s", flush=True)

    # ---- [16] the approximate GP and the pendulum --------------------------------
    t16 = time.perf_counter()
    gpd = gp_phase(bench, model, trajs, dev, card, K2, K4)
    gpd["tune_by_B"] = gp_tune(bench, model, trajs, card, K2)
    gpd["init"] = bench.task.get_init_obs()
    pendulum_phase(dev, card)
    print(f"[16] phase wall {time.perf_counter() - t16:.2f} s", flush=True)

    # ---- [17] the model-tuning path ---------------------------------------------
    t17 = time.perf_counter()
    mt = model_tuning_phase(bench, model, trajs, dev, card, fan_wrappers["b"])
    print(f"[17] phase wall {time.perf_counter() - t17:.2f} s", flush=True)

    # ---- [18] the feature kernels off the cartpole's shape -----------------------
    sp = shapes_phase(dev, card, (K1, K2, K3, K4), hc, hc_trajs)

    # ---- [19] the remaining kernels at every (ds, dc) ----------------------------
    ds19 = dense_shapes_phase(dev, card, (K1, K2, K3, K4), sp, bench, model, trajs)

    # ---- [20] the solver's remaining options ---------------------------------------
    so = solver_options_phase(dev, card, (K1, K2, K3, K4, K5), bench, model, trajs,
                              (hc_model, hc_cost, hc_kw, hc_x0, hc_ug),
                              (cp_model, cp_cost, cp_kw, cp_x0, ug[:B_DENSE]))

    # ---- [21] Koopman lifts past 24 states; K3 at dc > 1 ----------------------------
    lm21 = lift_multicontrol_phase(dev, card, (K1, K2, K3, K4), bench, model, trajs, sp, hc,
                                   hc_trajs)

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

    ctx = PhaseCtx(terms=terms, ca=ca, dt=dt, lo=float(bounds[0, 0]), hi=float(bounds[0, 1]),
                   alphas=alphas, dev=dev, failures=failures, K1=K1, K2=K2, K3=K3)
    check_k1 = functools.partial(check_k1_ll, ctx)
    check_k2_k3 = functools.partial(check_k2_k3_ll, ctx)
    k2_k3_rows = functools.partial(k2_k3_rows_ll, ctx)

    check_wide = functools.partial(check_wide_ll, ctx)

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
    # K3's batch-major entry on the same carry, transposed: the lanes-last
    # instance's results bit for bit.
    failures += check_bm_identity("fan-out (a) carry", K3, terms, ca, cfa, fan_cost, dt, alphas,
                                  float(bounds[0, 1]))

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
    # The same three on phase 17 (d)'s carry (the autotune run's fan-out,
    # its own candidates) at every batch size it launched them with.
    mt_Bs = sorted({Bs for counts in mt["by_B"].values() for Bs in counts}, reverse=True)
    k67_mt, fails = check_tune_kernels(model, mt["kw"], mt["batch"], mt_Bs,
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
        # Phase 17 (d)'s launches, each shape's measurements beside them.
        at.update({f"at_B{Bs}_H{TUNE_H}_model_tuning": dict(
            k67_mt[Bs][k], launches=mt["by_B"][name].get(Bs, 0)) for Bs in mt_Bs})
        for w in at.values():
            w.pop("library_ms")
        report.append(dict(
            name=f"{name}[B={FAN_B},H={FAN_H}]", route="cuda", source=source,
            replaces=replaces, launches=fan_launches["b"][name], launches_by_B=by_B,
            launches_tune=tune_launches[name], launches_tune_by_B=tune_by_B[name],
            launches_model_tuning=mt["launches"][name],
            launches_model_tuning_by_B=mt["by_B"][name],
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
    # Phase 12's per-lane instances at the shapes its paths give them:
    # K1 and K3 on (a)'s lanes-last carry, K1's batch-major entry and K7
    # on (b)'s (at every batch (b) launched them with), three iterations
    # into the first MPC step, each lane with its own trained model; the
    # same on the 105-term library's carries and on the 1,336-term
    # library's, there with the model JS_HUGE describes; and, at the main
    # bucket, each per-lane instance given B copies of one matrix against
    # its shared instance, bit for bit.
    def joint_carry(fan, batch_, coeffs=None):
        _, carry0, _, make_body = make_batched_ilqr_solver(
            fan._pred_core, None, return_pieces=True, **fan.solver_kw)
        n = batch_["reg"].shape[0]
        params = {"coeffs": fan.train_lanes(batch_["reg"]) if coeffs is None else coeffs}
        x0j = batch_["Qdiag"].new_tensor(np.tile(bench.task.get_init_obs(), (n, 1)))
        cpj = {k: batch_[k] for k in ("Qdiag", "Rdiag", "Fdiag")}
        carry, body = carry0(params, x0j, x0j.new_zeros((n, JS_H, 1)), cpj), make_body(params)
        for _ in range(3):
            carry = body(carry)
        return carry, cpj

    def lane_row(name, source, replaces, meas, counts, **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=counts, **meas, **extra)

    lane_src = {
        "relin_jacobians": ("autompc_torch/csrc/relin.cu", "autompc_tpu/ops/pallas_relin.py:192"),
        "relin_jacobians_bm": ("autompc_torch/csrc/relin.cu",
                               "autompc_tpu/ops/pallas_relin.py:192"),
        "fused_line_search": ("autompc_torch/csrc/linesearch_fused.cu",
                              "autompc_tpu/ops/pallas_linesearch.py:803"),
        "sindy_line_search": ("autompc_torch/csrc/sindy_linesearch.cu",
                              "autompc_tpu/ops/pallas_linesearch.py:191"),
    }
    def huge_model(fan, batch_):
        """(B, ds, F) per-lane models over ``fan``'s library: each lane's
        trained JS_BUCKET model at those terms' places, every other
        coefficient JS_HUGE_EPS * N(0, 1) / (F * the term's largest
        magnitude on the sysid data)."""
        small = js["fans"]["a"].train_lanes(batch_["reg"])
        place = [fan.library.terms.index(t) for t in js["fans"]["a"].library.terms]
        F = fan.n_features
        scale = JS_HUGE_EPS / (F * fan._A.abs().amax(0).clamp_min(1.0))
        noise = np.random.default_rng(5).standard_normal(tuple(small.shape[:2]) + (F,))
        C = small.new_tensor(noise) * scale
        C[:, :, place] = small
        return C.contiguous()

    bound_b = float(bounds[0, 1])
    for size, fans, batch_j, counts_j in (("", js["fans"], js["batch"], js["main"]),
                                          ("big", js["big_fans"], js["big_batch"], js["big"]),
                                          ("huge", js["huge_fans"], js["big_batch"], js["huge"])):
        fa, fb = fans["a"], fans["b"]
        tms = fa.library.terms
        tag = f"F={len(tms)}"
        lanes_j = huge_model(fa, batch_j) if size == "huge" else None
        # The plain versions take seconds a call past 1,000 terms (K3's
        # ~13 s): timed once there, the check's own call their warm-up.
        plain = dict(reps=1, warm=0) if size == "huge" else None
        cja, _ = joint_carry(fa, batch_j, lanes_j)
        Bj = cja["us"].shape[1]
        ca_counts, ca_by_B = counts_j["a"]
        r1 = check_k1(f"joint fan-out (a) carry, per-lane coefficients, {tag}", cja,
                      ca_counts["relin_jacobians"], tms=tms, coef=cja["params"],
                      name=f"relin_jacobians_lane[{tag}]", plain=plain)
        ja_cost = (*(cja["cost"][k] for k in ("Qdiag", "Rdiag", "Fdiag")), (0.0,) * 4)
        res_a = check_k2_k3(f"joint fan-out (a) carry, per-lane coefficients, {tag}", cja, ja_cost,
                            agree_min=K3_FAN_AGREE_MIN, within_min=K3_FAN_WITHIN_MIN, tms=tms,
                            coef=cja["params"], plain=plain)
        k3_row = k2_k3_rows(res_a, cja, "per-lane cost", {
            "backward_quad_ll": ca_counts["backward_quad_ll"],
            "fused_line_search": ca_counts["fused_line_search"]}, plain=plain)[1]
        k3_row["name"] = f"fused_line_search_lane[{tag},B={Bj},H={JS_H},per-lane cost]"
        k3_row["device_ms"] = device_ms(res_a["k3"])
        report += [dict(r1, launches_by_B=ca_by_B["relin_jacobians"]),
                   dict(k3_row, launches_by_B=ca_by_B["fused_line_search"])]
        cjb, cpb = joint_carry(fb, batch_j, lanes_j)
        plane_b = cjb["params"]["coeffs"].permute(1, 2, 0).contiguous()
        cb_counts, cb_by_B = counts_j["b"]
        b_Bs = sorted({Bs for d in cb_by_B.values() for Bs in d}, reverse=True)
        if b_Bs[0] != Bj:
            failures.append(f"joint fan-out (b) {tag} launched at {b_Bs}, not at B={Bj} first")
        k17 = {}
        for Bs in b_Bs:
            sub = {k: cjb[k][:Bs].contiguous() for k in ("x0s", "xs", "us", "Jx", "Ju")}
            k17[Bs], fails = check_fanout_kernels(
                f"joint fan-out (b) carry, per-lane coefficients, {tag}", K1, K2, K3, tms,
                plane_b[:, :, :Bs].contiguous(), sub, {k: v[:Bs] for k, v in cpb.items()},
                (0.0,) * 4, dt, alphas, bound_b, plain=plain)
            failures += fails
        for k, name in ((0, "relin_jacobians_bm"), (2, "sindy_line_search")):
            at = {f"at_B{Bs}_H{JS_H}": dict(k17[Bs][k], launches=cb_by_B[name].get(Bs, 0))
                  for Bs in b_Bs[1:]}
            for w in at.values():
                w.pop("library_ms")
            tune_key = size or "small"
            report.append(lane_row(
                f"{name}_lane[{tag},B={b_Bs[0]},H={JS_H}]", *lane_src[name], k17[b_Bs[0]][k],
                cb_counts[name], launches_by_B=cb_by_B[name],
                launches_joint_tune=js_tune[tune_key].get(name, 0), **at))
        if size:
            continue
        failures += check_bm_identity(f"joint fan-out (a) carry, per-lane coefficients, {tag}",
                                      K3, tms, cja["params"], cja, ja_cost, dt, alphas, bound_b)
        # Copies of one matrix (phase 2's model over the whole library)
        # through the per-lane instances against the shared instances.
        C1 = model.coeffs.contiguous()
        copies = C1[:, :, None].expand(-1, -1, Bj).contiguous()
        same = {"K1": bits_equal(K1.relin_jacobians(tms, cja["xs"], cja["us"], copies),
                                 K1.relin_jacobians(tms, cja["xs"], cja["us"], C1))}
        ka, kb = list(res_a["k3_args"]), list(res_a["k3_args"])
        ka[6], kb[6] = copies, C1
        same["K3"] = all(bits_equal(x, y) for x, y in zip(K3.fused_line_search(*ka),
                                                            K3.fused_line_search(*kb)))
        same["K1 batch-major"] = all(bits_equal(x, y) for x, y in zip(
            K1.relin_jacobians_bm(tms, cjb["xs"], cjb["us"], copies),
            K1.relin_jacobians_bm(tms, cjb["xs"], cjb["us"], C1)))
        Ksb, ksb = K2.backward_quad(cjb["Jx"], cjb["Ju"], cjb["xs"], cjb["us"], cpb["Qdiag"],
                                    cpb["Rdiag"], cpb["Fdiag"], (0.0,) * 4, dt, 4)[:2]
        k7 = (tms, cjb["x0s"], cjb["xs"], cjb["us"], Ksb, ksb)
        same["K7"] = all(bits_equal(x, y) for x, y in zip(
            K3.sindy_line_search(*k7, copies, alphas, -bound_b, bound_b),
            K3.sindy_line_search(*k7, C1, alphas, -bound_b, bound_b)))
        print(f"[3] per-lane instances given {Bj} copies of one {tuple(C1.shape)} matrix, bit "
              f"for bit the shared instances: {same}", flush=True)
        if not all(same.values()):
            failures.append(f"per-lane instances with copies differ from the shared ones: {same}")

    # Phase 13's kernels: K3's batch-major entry (with and without the
    # GaussReg term, shared and per-lane coefficients) on (a1)'s and
    # (b1)'s carries, K4 at (4, 1) on (a1)'s dense expansions; the
    # phase's launches of K1's batch-major entry, K4 and K7 beside their
    # rows.
    gr_rows, gr_k4, fails = check_gauss_reg_kernels(gr, model, bench, dev, K1, K3, K4, alphas)
    failures += fails
    report += gr_rows
    gr_counts = {cfg: counts for cfg, (counts, _) in gr["counts"].items()}
    gr_counts["tune"] = gr_tune[0]
    lane_tag = f"_lane[F={gr['fans']['b1'].n_features},"
    for r in report:
        base = r["name"].split("[")[0]
        if r["name"] == "riccati_general[4,1]":
            r["launches_gauss_reg"] = {k: v["riccati_general"] for k, v in gr_counts.items()}
            r[f"at_B{FAN_B}_H{FAN_H}_gauss_reg"] = {
                k: v for k, v in gr_k4.items()
                if k not in ("name", "route", "source", "replaces", "library_ms")}
        for name in ("relin_jacobians_bm", "sindy_line_search"):
            # The fixed model's configurations and the tune on the shared
            # instances' rows, the joint ones on the per-lane rows.
            cfgs = (("a1", "a2", "tune") if base == name else ("b1", "b2")
                    if r["name"].startswith(name + lane_tag) else ())
            if cfgs:
                r["launches_gauss_reg"] = {k: gr_counts[k][name] for k in cfgs
                                           if name in gr_counts[k]}

    # K6 at (12, 1), phase 15 (c2)'s instance, in a row of its own.
    k6w, fails = check_k6_wide(lm, K2, bench.system.dt, lm_tune_by_B)
    failures += fails
    report.append(k6w)

    # K6 and K4 at (4, 1) on phase 16's GP path, in rows of their own.
    gp_rows, fails = check_gp_kernels(gpd, K2, K4, bench.system.dt)
    failures += fails
    report += gp_rows

    # Phase 18's instances: K1 (both entries), K2, K3, K6, K7 at (2, 1), K1's
    # batch-major entry and K7 at (18, 6), in rows of their own.
    t3 = time.perf_counter()
    report += check_shape_kernels(sp, (K1, K2, K3, K4), failures)
    print(f"[3] phase 18's instances checked in {time.perf_counter() - t3:.2f} s", flush=True)

    # Phase 19's instances: K4 at (12, 1), (8, 1) and (2, 1), the per-lane
    # K1, K3, K7 at (2, 1), K2's 4D entry, K8, K9 at (2, 1), in rows of
    # their own.
    t3 = time.perf_counter()
    report += check_dense_kernels(ds19, sp, (K1, K2, K3, K4), failures)
    print(f"[3] phase 19's instances checked in {time.perf_counter() - t3:.2f} s", flush=True)
    # Phase 20's kernel modes: K3's DENSE form and per-lane entry past 64
    # terms, K5 at "default" and "bf16x3", in rows of their own.
    t3 = time.perf_counter()
    report += check_solver_option_kernels(so, (K1, K2, K3, K4, K5), failures)
    print(f"[3] phase 20's modes checked in {time.perf_counter() - t3:.2f} s", flush=True)
    # Phase 21's instances: K6 and K4 wide at each lift, K3 at (18, 6).
    t3 = time.perf_counter()
    report += check_lift_multicontrol_kernels(lm21, (K1, K2, K3, K4), failures)
    print(f"[3] phase 21's instances checked in {time.perf_counter() - t3:.2f} s", flush=True)

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
                 f"{r['launches_joint_mlp_by_B']} by B" if "launches_joint_mlp" in r else "")
              + (f"; {r['launches_joint_tune']} in the joint-SINDy tune"
                 if "launches_joint_tune" in r else "")
              + (f"; {r['launches_joint_koopman']} in the joint-Koopman fan-out (c2)"
                 if "launches_joint_koopman" in r else "")
              + (f"; {r['launches_model_tuning']} in phase 17's autotune run "
                 f"{r['launches_model_tuning_by_B']} by B"
                 if "launches_model_tuning" in r else "")
              + (f"; in phase 13 {r['launches_gauss_reg']}" if "launches_gauss_reg" in r else "")
              + (f"; on the GP path (phase 16) {r['launches_gp']}" if "launches_gp" in r else "")
              + (f"; {r['registers']} registers" if "registers" in r else ""))
        if "lane_cost_ms" in r:
            print(f"        with per-lane cost planes at this shape: kernel "
                  f"{r['lane_cost_ms']:.3f} ms (no path launches it so)")
        if "split_entry_ms" in r:
            print(f"        {split_txt(r)}")
        for key, w in r.items():
            if key.startswith("at_B") or key in ("bf16_jac", "no_reg"):
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
