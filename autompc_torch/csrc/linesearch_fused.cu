// K3: fused iLQR line search with acceptance, relinearization and carry
// select, lanes-last, dc=1, diagonal quadratic cost: one fixed cost for
// every lane (host constants in LSParams) or one cost per lane (lanes-last
// device planes qdT/fdT (obsdim, B), rdT (1, B): the TPU kernel's
// per_lane_diag_cost=True, the tuner's cost fan-out). The two forms are a
// template switch over one kernel body.
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_linesearch.py:
// _fused_kernel, entry pallas_fused_line_search with ll_io=True,
// carry=(act, old_jac), grad_terms and one shared (ds, F) coefficient
// plane. Per lane:
//   rollouts  every step size alpha_l through the feature-library
//             dynamics, u = clip(alpha k + ubar + K (x - xbar)), with the
//             objective dt * sum_t ((x-g)'Q(x-g) + R u^2) + (x_H-g)'F(x_H-g)
//             and du2 = sum_t (u-ubar)^2;
//   accept    the reference rule: the first alpha whose expected-reduction
//             ratio exceeds the threshold, else the strict-< argmin; a tiny
//             ||k|| forces alpha index 0 and success; the lane fails when it
//             did not succeed and its last objective worsens obj0 by > 1e-3;
//   write     the selected rollout's xs/us where the lane is active and
//             did not fail, its packed Jacobians (the relinearization) where
//             it also succeeded, old values elsewhere, plus obj, success,
//             failure and du2.
//
// What bounds it on an H100: arithmetic, not bytes: per lane and step each
// of the L candidates evaluates the active terms (sinf/cosf), and the
// lane's streams are ~10 floats in per step. Each candidate is a chain of
// H dependent steps, so the time is set by how many chains run side by
// side. Design:
//   - Candidates across threads. A block holds NL lanes x L step sizes,
//     thread (l, j) = threadIdx.x = l * NL + j rolling step size l of lane
//     j: a warp is 32 (or 16) neighbouring lanes at one step size, so its
//     reads of the lanes-last carry are coalesced. Each thread runs
//     ls_obj_step (ls_step.cuh), the step K8 runs, so every objective is
//     K8's to the bit. NL (from the wrapper) spreads the blocks over the
//     SMs; __launch_bounds__ caps registers at 128 (two blocks of 256
//     threads an SM).
//   - No re-roll: each candidate thread stashes its states and controls
//     in a scratch buffer (H, ds+1, L, B) that the wrapper allocates,
//     L (ds+1) floats a lane-step, and the selected candidate's rows are
//     read back: those are the states the re-roll of K9 computes, to the
//     bit (the same ls_control and ampc_dynamics).
//   - Acceptance in the kernel. Objectives and du2 meet in shared memory;
//     thread l = 0 of each lane applies the rule with the reference's
//     float operations (unchanged from the one-thread-per-lane kernel).
//   - The Jacobians off the chain. After a barrier the lane's L threads
//     write the selected trajectory and compute its packed Jacobian rows
//     in parallel over t (t = l, l + L, ...), one column of ds rows at a
//     time (ampc_jac_col), so no thread holds all ds (ds+1) rows; a warp
//     writes 32 (16) neighbouring lanes of one row.
//
// The Jacobian carry is float or bfloat16 (jac_io.cuh): old rows are
// read, and new rows written, in the carry's own storage type (the TPU
// wrapper's jac_dtype), a second template switch.
#include "ls_step.cuh"

// Threads of a block: lanes per block x step sizes.
#define AMPC_LS_MAX_THREADS 256

template <int DS, bool LANE_COST, typename JT>
__global__ void __launch_bounds__(AMPC_LS_MAX_THREADS, 2) fused_ls_kernel(
    const __grid_constant__ FeatTable T, const __grid_constant__ LSParams P,
    const float* __restrict__ coeffs, const float* __restrict__ x0T,
    const float* __restrict__ xsT, const float* __restrict__ usT,
    const float* __restrict__ KsT, const float* __restrict__ ksT,
    const float* __restrict__ qdT, const float* __restrict__ rdT,
    const float* __restrict__ fdT, const float* __restrict__ obj0_in, const float* __restrict__ lin_in,
    const float* __restrict__ quad_in, const uint8_t* __restrict__ ks_small_in,
    const uint8_t* __restrict__ act_in, const JT* __restrict__ old_jac,
    float* stash, float* __restrict__ out_xs,
    float* __restrict__ out_us, float* __restrict__ out_obj,
    uint8_t* __restrict__ out_succ, uint8_t* __restrict__ out_fail,
    JT* __restrict__ out_jac, float* __restrict__ out_du2, int H, int B) {
  constexpr int D = DS + 1;
  __shared__ float s_coef[DS * AMPC_MAX_F];
  __shared__ float s_obj[AMPC_LS_MAX_THREADS];
  __shared__ float s_du2[AMPC_LS_MAX_THREADS];
  __shared__ int s_pick[AMPC_LS_MAX_THREADS];
  ampc_load_coef(s_coef, coeffs, DS * T.n);
  const int L = P.L;
  const int NL = blockDim.x / L;
  const int l = threadIdx.x / NL;
  const int j = threadIdx.x - l * NL;
  const int b = blockIdx.x * NL + j;
  const bool valid = b < B;
  // Stash row (t, i, l) of lane b: i < DS holds x_{t+1}, i = DS holds u_t.
  const long long LB = (long long)L * B;

  // ---- candidate l of lane b: rollout, objective, du2 -----------------
  float x0[DS];
  float obj = 0.f, du2 = 0.f;
  if (valid) {
    float x[DS];
#pragma unroll
    for (int i = 0; i < DS; ++i) x[i] = x0[i] = x0T[(long long)i * B + b];
    // The stage-cost diagonal: the lane's own, held in registers through
    // the rollout, or the shared constants.
    float q_lane[DS];
    float rd = P.rd;
    if constexpr (LANE_COST) {
#pragma unroll
      for (int i = 0; i < DS; ++i)
        q_lane[i] = i < P.obsdim ? qdT[(long long)i * B + b] : 0.f;
      rd = rdT[b];
    }
    const float* wq = LANE_COST ? q_lane : P.qd;
    const float alpha = P.alphas[l];
    float* st = stash + (long long)l * B + b;
    for (int t = 0; t < H; ++t) {
      float xbar[DS], K[DS], ubar, kk;
      ls_load_row<DS>(xsT, usT, KsT, ksT, t, B, b, xbar, K, ubar, kk);
      const float u =
          ls_obj_step<DS>(T, s_coef, P, x, xbar, K, ubar, kk, alpha, wq, rd, obj);
      const float du = u - ubar;
      du2 = du2 + du * du;
      float* row = st + (long long)t * D * LB;
#pragma unroll
      for (int i = 0; i < DS; ++i) row[i * LB] = x[i];
      row[DS * LB] = u;
    }
    // The terminal diagonal is fetched only now, after the rollout.
    float f_lane[DS];
    if constexpr (LANE_COST) {
#pragma unroll
      for (int i = 0; i < DS; ++i)
        f_lane[i] = i < P.obsdim ? fdT[(long long)i * B + b] : 0.f;
    }
    const float* wf = LANE_COST ? f_lane : P.fd;
    obj = obj + ls_quad_form<DS>(P, x, wf);
  }
  s_obj[threadIdx.x] = obj;
  s_du2[threadIdx.x] = du2;
  __syncthreads();

  // ---- acceptance, one thread per lane ----------------------------------
  if (l == 0 && valid) {
    float objs[AMPC_MAX_L];
#pragma unroll
    for (int m = 0; m < AMPC_MAX_L; ++m) objs[m] = m < L ? s_obj[m * NL + j] : 0.f;
    const float obj0 = obj0_in[b];
    const float lin = lin_in[b];
    const float quad = quad_in[b];
    const bool ks_small = ks_small_in[b] != 0;
    int first_acc = L;
    int best = 0;
    float best_val = objs[0];
#pragma unroll
    for (int m = AMPC_MAX_L - 1; m >= 0; --m) {
      if (m < L) {
        const float a = P.alphas[m];
        const float expect = a * lin + (a * a) * quad * 0.5f;
        const float denom = -expect;
        const float ratio =
            fabsf(denom) > 1e-30f ? (obj0 - objs[m]) / denom : -__int_as_float(0x7f800000);
        if (ratio > P.thresh) first_acc = m;
      }
    }
#pragma unroll
    for (int m = 1; m < AMPC_MAX_L; ++m) {
      if (m < L && objs[m] < best_val) {
        best = m;
        best_val = objs[m];
      }
    }
    const bool any_acc = first_acc < L;
    const int chosen = ks_small ? 0 : (any_acc ? first_acc : best);
    const int idx_last = ks_small ? 0 : (any_acc ? first_acc : L - 1);
    float chosen_obj = objs[0], last_obj = objs[0];
#pragma unroll
    for (int m = 1; m < AMPC_MAX_L; ++m) {
      if (m == chosen) chosen_obj = objs[m];
      if (m == idx_last) last_obj = objs[m];
    }
    const bool success = (chosen_obj < obj0) || ks_small;
    const bool failed = !success && (last_obj > obj0 + 1e-3f);
    const float new_obj = success ? chosen_obj : last_obj;
    const int sel = success ? chosen : idx_last;

    const bool act = act_in[b] != 0;
    const bool traj_mask = act && !failed;
    const bool jac_mask = traj_mask && success;
    out_obj[b] = traj_mask ? new_obj : obj0;
    out_succ[b] = success ? 1 : 0;
    out_fail[b] = failed ? 1 : 0;
    out_du2[b] = s_du2[sel * NL + j];
    s_pick[j] = sel | (traj_mask ? 0x100 : 0) | (jac_mask ? 0x200 : 0);
  }
  __syncthreads();
  if (!valid) return;

  // ---- the selected rollout: xs, us and Jacobians, in parallel over t ---
  const int pick = s_pick[j];
  const bool traj_mask = (pick & 0x100) != 0;
  const bool jac_mask = (pick & 0x200) != 0;
  const float* sw = stash + (long long)(pick & 0xff) * B + b;
  if (l == 0) {
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      const long long o = (long long)i * B + b;
      out_xs[o] = traj_mask ? x0[i] : xsT[o];
    }
  }
  for (int t = l; t < H; t += L) {
    const float* row = sw + (long long)t * D * LB;
    float z[D];
#pragma unroll
    for (int i = 0; i < DS; ++i) z[i] = t == 0 ? x0[i] : row[(i - D) * LB];
    z[DS] = row[DS * LB];
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      const long long o = ((long long)(t + 1) * DS + i) * B + b;
      out_xs[o] = traj_mask ? row[i * LB] : xsT[o];
    }
    out_us[(long long)t * B + b] = traj_mask ? z[DS] : usT[(long long)t * B + b];
    const long long jt = (long long)t * DS * D;
    if (jac_mask) {
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        float col[DS];
        ampc_jac_col<DS, D>(T, s_coef, z, dd, col);
#pragma unroll
        for (int i = 0; i < DS; ++i)
          out_jac[(jt + i * D + dd) * B + b] = ampc_jac_store<JT>(col[i]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < DS * D; ++r) {
        const long long o = (jt + r) * B + b;
        out_jac[o] = old_jac[o];
      }
    }
  }
}

template <bool LANE_COST, typename JT>
static void launch(const FeatTable* T, const LSParams* P, const float* coeffs,
                   const float* x0T, const float* xsT, const float* usT,
                   const float* KsT, const float* ksT, const float* qdT,
                   const float* rdT, const float* fdT, const float* obj0,
                   const float* lin, const float* quad,
                   const uint8_t* ks_small, const uint8_t* act,
                   const void* old_jac, float* stash, float* out_xs,
                   float* out_us, float* out_obj, uint8_t* out_succ,
                   uint8_t* out_fail, void* out_jac, float* out_du2, int H,
                   int B, int lanes_per_block, cudaStream_t s) {
  const int threads = lanes_per_block * P->L;
  const unsigned blocks = (unsigned)((B + lanes_per_block - 1) / lanes_per_block);
  fused_ls_kernel<4, LANE_COST, JT><<<blocks, threads, 0, s>>>(
      *T, *P, coeffs, x0T, xsT, usT, KsT, ksT, qdT, rdT, fdT, obj0, lin,
      quad, ks_small, act, (const JT*)old_jac, stash, out_xs, out_us, out_obj,
      out_succ, out_fail, (JT*)out_jac, out_du2, H, B);
}

// qdT/rdT/fdT: per-lane cost planes, or all three null for the fixed
// cost held in P. jac_bf16: old_jac and out_jac are bfloat16, else float.
// stash: H (ds+1) L B floats of scratch. lanes_per_block x L threads a
// block (the wrapper's fused_geometry).
extern "C" int ampc_fused_line_search(
    const FeatTable* T, const LSParams* P, const float* coeffs,
    const float* x0T, const float* xsT, const float* usT, const float* KsT,
    const float* ksT, const float* qdT, const float* rdT, const float* fdT,
    const float* obj0, const float* lin, const float* quad,
    const uint8_t* ks_small, const uint8_t* act, const void* old_jac,
    float* stash, float* out_xs, float* out_us, float* out_obj,
    uint8_t* out_succ, uint8_t* out_fail, void* out_jac, float* out_du2,
    int jac_bf16, int ds, int H, int B, int lanes_per_block, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool lane = qdT != nullptr;
  if (ds != 4 || T->d != ds + 1 || T->n < 1 || T->n > AMPC_MAX_F ||
      P->L < 1 || P->L > AMPC_MAX_L || P->obsdim < 1 || P->obsdim > ds ||
      (rdT != nullptr) != lane || (fdT != nullptr) != lane || H < 1 ||
      B < 1 || lanes_per_block < 1 ||
      lanes_per_block * P->L > AMPC_LS_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define AMPC_LAUNCH(LC, JT_)                                                 \
  launch<LC, JT_>(T, P, coeffs, x0T, xsT, usT, KsT, ksT, qdT, rdT, fdT, obj0, \
                  lin, quad, ks_small, act, old_jac, stash, out_xs, out_us,   \
                  out_obj, out_succ, out_fail, out_jac, out_du2, H, B,        \
                  lanes_per_block, s)
  if (lane && jac_bf16)
    AMPC_LAUNCH(true, __nv_bfloat16);
  else if (lane)
    AMPC_LAUNCH(true, float);
  else if (jac_bf16)
    AMPC_LAUNCH(false, __nv_bfloat16);
  else
    AMPC_LAUNCH(false, float);
#undef AMPC_LAUNCH
  return (int)cudaGetLastError();
}

// The compiled instance's registers and local (spill) bytes a thread, and
// its resident blocks an SM at `threads` a block: out[0..2].
extern "C" int ampc_fused_line_search_occupancy(int lane_cost, int jac_bf16,
                                                int threads, int device,
                                                int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* f =
      lane_cost ? (jac_bf16 ? (const void*)fused_ls_kernel<4, true, __nv_bfloat16>
                            : (const void*)fused_ls_kernel<4, true, float>)
                : (jac_bf16 ? (const void*)fused_ls_kernel<4, false, __nv_bfloat16>
                            : (const void*)fused_ls_kernel<4, false, float>);
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, f);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, threads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return 0;
}
