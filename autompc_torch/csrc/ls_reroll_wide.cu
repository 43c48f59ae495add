// K9: the second half of the split ("wide") line search, lanes-last,
// dc=1: the selected step size's trajectory read back from K8's stash,
// its packed relinearization, and the iLQR carry select applied at the
// writes.
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_linesearch.py:
// _ls_reroll_kernel_wide (the second pallas_call of
// pallas_fused_line_search_wide). Per lane b, given the selected
// candidate sel[b] and the masks that the acceptance rule (tensor code
// between K8 and this kernel) decided:
//   xs, us        the selected candidate's trajectory (x_0 from x0T, the
//                 rest from the stash) where tmask, the old elsewhere;
//   jac           the packed rows i*(ds+1)+dd = d x'_i / d z_dd at every
//                 (x_t, u_t) of it where jmask, the old rows elsewhere,
//                 in the carry's storage type (float or bfloat16);
//   du2           the selected candidate's sum_t (u_t - ubar_t)^2, from
//                 K8's (L, B) plane, on every lane.
// The TPU kernel rolls the chosen step size again, one dependent chain a
// lane, and writes xs[0..H-1] and the terminal row through separate
// outputs so that its blocks stay aligned. Here K8 has already rolled
// every candidate with ls_step.cuh's ls_candidate and kept its states and
// controls, which are the re-roll's to the bit (the same ls_control and
// ampc_dynamics), so nothing is rolled: xs (H+1, ds, B) is written
// directly, and the Jacobian columns are ampc_jac_col's, as in K1 and in
// the fused kernel K3.
//
// Design: no chain. A thread per (step t, lane b), a block holding
// neighbouring lanes of one step (blockIdx.y = t), so every read and
// write of a row is one coalesced transaction a warp (the stash reads
// spread over the L planes by the lanes' choices); term table in the
// constant bank, coefficient plane in shared memory.
//
// What bounds it on an H100: bytes, the selected rows in and the new
// carry out (~(2 ds + 2 + ds(ds+1)) words a lane-step), with the
// Jacobian terms (sinf/cosf) of the active terms at every point beside
// them, as in K1.
#include "ls_step.cuh"

// Most threads (lanes of one step) a block.
#define AMPC_RR_THREADS 256

template <int DS, typename JT>
__global__ void ls_reroll_wide_kernel(
    const __grid_constant__ FeatTable T, const float* __restrict__ coeffs,
    const float* __restrict__ x0T, const float* __restrict__ xsT,
    const float* __restrict__ usT, const JT* __restrict__ old_jac,
    const float* __restrict__ stash, const float* __restrict__ du2s,
    const long long* __restrict__ sel, const uint8_t* __restrict__ tmask,
    const uint8_t* __restrict__ jmask, float* __restrict__ out_xs,
    float* __restrict__ out_us, JT* __restrict__ out_jac,
    float* __restrict__ out_du2, int L, int H, int B) {
  constexpr int D = DS + 1;
  __shared__ float s_coef[DS * AMPC_MAX_F];
  ampc_load_coef(s_coef, coeffs, DS * T.n);
  const int t = blockIdx.y;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long LB = (long long)L * B;
  const int s = (int)sel[b];
  const bool traj_mask = tmask[b] != 0;
  const bool jac_mask = jmask[b] != 0;
  // Stash row (t, i, s) of lane b: i < DS holds x_{t+1}, i = DS holds u_t.
  const float* row = stash + (long long)t * D * LB + (long long)s * B + b;
  float z[D];
#pragma unroll
  for (int i = 0; i < DS; ++i)
    z[i] = t == 0 ? x0T[(long long)i * B + b] : row[(i - D) * LB];
  z[DS] = row[DS * LB];
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      const long long o = (long long)i * B + b;
      out_xs[o] = traj_mask ? z[i] : xsT[o];
    }
    out_du2[b] = du2s[(long long)s * B + b];
  }
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const long long o = ((long long)(t + 1) * DS + i) * B + b;
    out_xs[o] = traj_mask ? row[i * LB] : xsT[o];
  }
  const long long ou = (long long)t * B + b;
  out_us[ou] = traj_mask ? z[DS] : usT[ou];
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

// The ds of this object: 4 in the main library, else the shape it was
// built for at first use (-DAMPC_DS; ops/_build.py: shape_library), dc = 1.
#ifndef AMPC_DS
#define AMPC_DS 4
#endif

template <typename JT>
static void launch(const FeatTable* T, const float* coeffs, const float* x0T,
                   const float* xsT, const float* usT, const void* old_jac,
                   const float* stash, const float* du2s, const long long* sel,
                   const uint8_t* tmask, const uint8_t* jmask, float* out_xs,
                   float* out_us, void* out_jac, float* out_du2, int L, int H,
                   int B, cudaStream_t s) {
  const dim3 grid((unsigned)((B + AMPC_RR_THREADS - 1) / AMPC_RR_THREADS),
                  (unsigned)H);
  ls_reroll_wide_kernel<AMPC_DS, JT><<<grid, AMPC_RR_THREADS, 0, s>>>(
      *T, coeffs, x0T, xsT, usT, (const JT*)old_jac, stash, du2s, sel, tmask,
      jmask, out_xs, out_us, (JT*)out_jac, out_du2, L, H, B);
}

// stash (H, ds+1, L, B) and du2s (L, B) from K8; sel (B,) int64 in
// [0, L); tmask, jmask (B,) bool. jac_bf16: old_jac and out_jac are
// bfloat16, else float. A grid of (ceil(B / AMPC_RR_THREADS), H) blocks
// of AMPC_RR_THREADS threads: thread j of block (x, t) takes lane
// x * AMPC_RR_THREADS + j at step t.
extern "C" int ampc_ls_reroll_wide(
    const FeatTable* T, const float* coeffs, const float* x0T,
    const float* xsT, const float* usT, const void* old_jac,
    const float* stash, const float* du2s, const long long* sel,
    const uint8_t* tmask, const uint8_t* jmask, float* out_xs, float* out_us,
    void* out_jac, float* out_du2, int jac_bf16, int ds, int L, int H, int B,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ds != AMPC_DS || T->d != ds + 1 || T->n < 1 || T->n > AMPC_MAX_F || L < 1 ||
      L > AMPC_MAX_L || H < 1 || H > 65535 || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (jac_bf16)
    launch<__nv_bfloat16>(T, coeffs, x0T, xsT, usT, old_jac, stash, du2s, sel,
                          tmask, jmask, out_xs, out_us, out_jac, out_du2, L, H,
                          B, s);
  else
    launch<float>(T, coeffs, x0T, xsT, usT, old_jac, stash, du2s, sel, tmask,
                  jmask, out_xs, out_us, out_jac, out_du2, L, H, B, s);
  return (int)cudaGetLastError();
}
