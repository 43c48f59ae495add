// K3: fused iLQR line search with acceptance, re-roll, relinearization and
// carry select, lanes-last, dc=1, diagonal quadratic cost: one fixed cost
// for every lane (host constants in LSParams) or one cost per lane
// (lanes-last device planes qdT/fdT (obsdim, B), rdT (1, B): the TPU
// kernel's per_lane_diag_cost=True, the tuner's cost fan-out). The two
// forms are a template switch over one kernel body.
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_linesearch.py:
// _fused_kernel, entry pallas_fused_line_search with ll_io=True,
// carry=(act, old_jac), grad_terms and one shared (ds, F) coefficient
// plane. Per lane:
//   pass 1  rolls all L step sizes alpha_l through the feature-library
//           dynamics, u = clip(alpha k + ubar + K (x - xbar)), and sums
//           the objective dt * sum_t ((x-g)'Q(x-g) + R u^2) + (x_H-g)'F(x_H-g);
//   accept  the reference rule: the first alpha whose expected-reduction
//           ratio exceeds the threshold, else the strict-< argmin; a tiny
//           ||k|| forces alpha index 0 and success; the lane fails when it
//           did not succeed and its last objective worsens obj0 by > 1e-3;
//   pass 2  re-rolls the chosen alpha, writes xs/us where the lane is
//           active and did not fail, the packed Jacobians (relinearization
//           fused into the re-roll) where it also succeeded, old values
//           elsewhere, plus obj, success, failure and du2 = sum_t (u-ubar)^2.
// Only the chosen trajectory ever reaches device memory.
//
// What bounds it on an H100: arithmetic, not bytes. Per lane and step
// pass 1 evaluates the active terms (sinf/cosf) for each of the L
// candidates; the lane's streams are ~10 floats in per step for pass 1
// and ~50 in/out for pass 2. With one thread per lane and B = 16384 lanes
// only 512 warps exist, so each SM runs a handful of warps and the long
// dependent chain of 200 steps x L candidates sets the time. Design for
// now (simple and right first): one thread holds all L candidate states
// (L * ds floats) and objectives in registers through pass 1, so the
// candidates never leave registers; lanes-last layout for coalesced
// streams; coefficient plane in shared memory, term table in the
// constant bank; 64-thread blocks to spread the warps over the SMs.
// Splitting the candidates across threads is the obvious next step; the
// split line search (K8 + acceptance + K9) is that split, and shares this
// kernel's step arithmetic (ls_step.cuh).
//
// The Jacobian carry is float or bfloat16 (jac_io.cuh): old rows are
// read, and new rows written, in the carry's own storage type (the TPU
// wrapper's jac_dtype), a second template switch.
#include "ls_step.cuh"

template <int DS, bool LANE_COST, typename JT>
__global__ void fused_ls_kernel(
    const __grid_constant__ FeatTable T, const __grid_constant__ LSParams P,
    const float* __restrict__ coeffs, const float* __restrict__ x0T,
    const float* __restrict__ xsT, const float* __restrict__ usT,
    const float* __restrict__ KsT, const float* __restrict__ ksT,
    const float* __restrict__ qdT, const float* __restrict__ rdT,
    const float* __restrict__ fdT, const float* __restrict__ obj0_in, const float* __restrict__ lin_in,
    const float* __restrict__ quad_in, const uint8_t* __restrict__ ks_small_in,
    const uint8_t* __restrict__ act_in, const JT* __restrict__ old_jac,
    float* __restrict__ out_xs, float* __restrict__ out_us,
    float* __restrict__ out_obj, uint8_t* __restrict__ out_succ,
    uint8_t* __restrict__ out_fail, JT* __restrict__ out_jac,
    float* __restrict__ out_du2, int H, int B) {
  __shared__ float s_coef[DS * AMPC_MAX_F];
  ampc_load_coef(s_coef, coeffs, DS * T.n);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int L = P.L;

  float x0[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) x0[i] = x0T[(long long)i * B + b];

  // The stage-cost diagonal: the lane's own, held in registers through
  // pass 1, or the shared constants.
  float q_lane[DS];
  float rd = P.rd;
  if constexpr (LANE_COST) {
#pragma unroll
    for (int i = 0; i < DS; ++i)
      q_lane[i] = i < P.obsdim ? qdT[(long long)i * B + b] : 0.f;
    rd = rdT[b];
  }
  const float* wq = LANE_COST ? q_lane : P.qd;

  // ---- pass 1: every candidate step size, objective only -------------
  float x[AMPC_MAX_L][DS], obj[AMPC_MAX_L];
#pragma unroll
  for (int l = 0; l < AMPC_MAX_L; ++l) {
    obj[l] = 0.f;
#pragma unroll
    for (int i = 0; i < DS; ++i) x[l][i] = x0[i];
  }
  for (int t = 0; t < H; ++t) {
    float xbar[DS], K[DS], ubar, kk;
    ls_load_row<DS>(xsT, usT, KsT, ksT, t, B, b, xbar, K, ubar, kk);
#pragma unroll
    for (int l = 0; l < AMPC_MAX_L; ++l)
      if (l < L)
        ls_obj_step<DS>(T, s_coef, P, x[l], xbar, K, ubar, kk, P.alphas[l],
                        wq, rd, obj[l]);
  }
  // The terminal diagonal is fetched only now, after the rollouts.
  float f_lane[DS];
  if constexpr (LANE_COST) {
#pragma unroll
    for (int i = 0; i < DS; ++i)
      f_lane[i] = i < P.obsdim ? fdT[(long long)i * B + b] : 0.f;
  }
  const float* wf = LANE_COST ? f_lane : P.fd;
#pragma unroll
  for (int l = 0; l < AMPC_MAX_L; ++l)
    if (l < L) obj[l] = obj[l] + ls_quad_form<DS>(P, x[l], wf);

  // ---- acceptance -----------------------------------------------------
  const float obj0 = obj0_in[b];
  const float lin = lin_in[b];
  const float quad = quad_in[b];
  const bool ks_small = ks_small_in[b] != 0;
  int first_acc = L;
  int best = 0;
  float best_val = obj[0];
#pragma unroll
  for (int l = AMPC_MAX_L - 1; l >= 0; --l) {
    if (l < L) {
      const float a = P.alphas[l];
      const float expect = a * lin + (a * a) * quad * 0.5f;
      const float denom = -expect;
      const float ratio =
          fabsf(denom) > 1e-30f ? (obj0 - obj[l]) / denom : -__int_as_float(0x7f800000);
      if (ratio > P.thresh) first_acc = l;
    }
  }
#pragma unroll
  for (int l = 1; l < AMPC_MAX_L; ++l) {
    if (l < L && obj[l] < best_val) {
      best = l;
      best_val = obj[l];
    }
  }
  const bool any_acc = first_acc < L;
  const int chosen = ks_small ? 0 : (any_acc ? first_acc : best);
  const int idx_last = ks_small ? 0 : (any_acc ? first_acc : L - 1);
  float chosen_obj = obj[0], last_obj = obj[0], alpha_chosen = P.alphas[0],
        alpha_last = P.alphas[0];
#pragma unroll
  for (int l = 1; l < AMPC_MAX_L; ++l) {
    if (l == chosen) {
      chosen_obj = obj[l];
      alpha_chosen = P.alphas[l];
    }
    if (l == idx_last) {
      last_obj = obj[l];
      alpha_last = P.alphas[l];
    }
  }
  const bool success = (chosen_obj < obj0) || ks_small;
  const bool failed = !success && (last_obj > obj0 + 1e-3f);
  const float new_obj = success ? chosen_obj : last_obj;
  const float a_sel = success ? alpha_chosen : alpha_last;

  const bool act = act_in[b] != 0;
  const bool traj_mask = act && !failed;
  const bool jac_mask = traj_mask && success;
  out_obj[b] = traj_mask ? new_obj : obj0;
  out_succ[b] = success ? 1 : 0;
  out_fail[b] = failed ? 1 : 0;

  // ---- pass 2: re-roll the chosen step size ---------------------------
  const float du2 =
      ls_reroll_lane<DS, JT>(T, s_coef, P, x0, a_sel, traj_mask, jac_mask,
                             xsT, usT, KsT, ksT, old_jac, out_xs, out_us,
                             out_jac, H, B, b);
  out_du2[b] = du2;
}

template <bool LANE_COST, typename JT>
static void launch(const FeatTable* T, const LSParams* P, const float* coeffs,
                   const float* x0T, const float* xsT, const float* usT,
                   const float* KsT, const float* ksT, const float* qdT,
                   const float* rdT, const float* fdT, const float* obj0,
                   const float* lin, const float* quad,
                   const uint8_t* ks_small, const uint8_t* act,
                   const void* old_jac, float* out_xs, float* out_us,
                   float* out_obj, uint8_t* out_succ, uint8_t* out_fail,
                   void* out_jac, float* out_du2, int H, int B,
                   cudaStream_t s) {
  const int threads = 64;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  fused_ls_kernel<4, LANE_COST, JT><<<blocks, threads, 0, s>>>(
      *T, *P, coeffs, x0T, xsT, usT, KsT, ksT, qdT, rdT, fdT, obj0, lin,
      quad, ks_small, act, (const JT*)old_jac, out_xs, out_us, out_obj,
      out_succ, out_fail, (JT*)out_jac, out_du2, H, B);
}

// qdT/rdT/fdT: per-lane cost planes, or all three null for the fixed
// cost held in P. jac_bf16: old_jac and out_jac are bfloat16, else float.
extern "C" int ampc_fused_line_search(
    const FeatTable* T, const LSParams* P, const float* coeffs,
    const float* x0T, const float* xsT, const float* usT, const float* KsT,
    const float* ksT, const float* qdT, const float* rdT, const float* fdT,
    const float* obj0, const float* lin, const float* quad,
    const uint8_t* ks_small, const uint8_t* act, const void* old_jac,
    float* out_xs, float* out_us, float* out_obj, uint8_t* out_succ,
    uint8_t* out_fail, void* out_jac, float* out_du2, int jac_bf16, int ds,
    int H, int B, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool lane = qdT != nullptr;
  if (ds != 4 || T->d != ds + 1 || T->n < 1 || T->n > AMPC_MAX_F ||
      P->L < 1 || P->L > AMPC_MAX_L || P->obsdim < 1 || P->obsdim > ds ||
      (rdT != nullptr) != lane || (fdT != nullptr) != lane)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define AMPC_LAUNCH(LC, JT_)                                                 \
  launch<LC, JT_>(T, P, coeffs, x0T, xsT, usT, KsT, ksT, qdT, rdT, fdT, obj0, \
                  lin, quad, ks_small, act, old_jac, out_xs, out_us, out_obj, \
                  out_succ, out_fail, out_jac, out_du2, H, B, s)
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
