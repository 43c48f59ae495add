// K9: the re-roll of the split ("wide") line search, lanes-last, dc=1:
// the selected step size of every lane rolled once more, with the packed
// relinearization fused into the roll and the iLQR carry select applied
// at the writes.
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_linesearch.py:
// _ls_reroll_kernel_wide (the second pallas_call of
// pallas_fused_line_search_wide). Per lane b, given the step size a_sel[b]
// and the masks that the acceptance rule (tensor code between K8 and
// this kernel) decided:
//   xs, us        the re-rolled trajectory where tmask, the old elsewhere;
//   jac           the packed rows i*(ds+1)+dd = d x'_i / d z_dd at every
//                 (x_t, u_t) of it where jmask, the old rows elsewhere,
//                 in the carry's storage type (float or bfloat16);
//   du2           sum_t (u_t - ubar_t)^2 over every lane.
// The TPU kernel writes xs[0..H-1] and the terminal row through separate
// outputs so that its blocks stay aligned; here xs (H+1, ds, B) is
// written directly. The whole lane is ls_step.cuh's ls_reroll_lane: its
// rollout step is the one K8 and the fused kernel (linesearch_fused.cu)
// scored, and its Jacobian columns are the fused kernel's.
//
// Design: one thread per lane (one chain of H steps, the Jacobian terms
// from features.cuh as in K1 and K3), lanes-last so that a warp's reads
// and writes of a row are coalesced; term table in the constant bank,
// coefficient plane in shared memory.
//
// What bounds it on an H100: by bytes, the carry in and the new carry out
// (~(2 ds + 2 + ds(ds+1)) words a lane-step each way); in fact, with B
// threads only, the dependent chain of each lane's H steps.
#include "ls_step.cuh"

template <int DS, typename JT>
__global__ void ls_reroll_wide_kernel(
    const __grid_constant__ FeatTable T, const __grid_constant__ LSParams P,
    const float* __restrict__ coeffs, const float* __restrict__ x0T,
    const float* __restrict__ xsT, const float* __restrict__ usT,
    const float* __restrict__ KsT, const float* __restrict__ ksT,
    const JT* __restrict__ old_jac, const float* __restrict__ a_sel,
    const uint8_t* __restrict__ tmask, const uint8_t* __restrict__ jmask,
    float* __restrict__ out_xs, float* __restrict__ out_us,
    JT* __restrict__ out_jac, float* __restrict__ out_du2, int H, int B) {
  __shared__ float s_coef[DS * AMPC_MAX_F];
  ampc_load_coef(s_coef, coeffs, DS * T.n);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float x0[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) x0[i] = x0T[(long long)i * B + b];
  out_du2[b] = ls_reroll_lane<DS, JT>(
      T, s_coef, P, x0, a_sel[b], tmask[b] != 0, jmask[b] != 0, xsT, usT,
      KsT, ksT, old_jac, out_xs, out_us, out_jac, H, B, b);
}

template <typename JT>
static void launch(const FeatTable* T, const LSParams* P, const float* coeffs,
                   const float* x0T, const float* xsT, const float* usT,
                   const float* KsT, const float* ksT, const void* old_jac,
                   const float* a_sel, const uint8_t* tmask,
                   const uint8_t* jmask, float* out_xs, float* out_us,
                   void* out_jac, float* out_du2, int H, int B,
                   cudaStream_t s) {
  const int threads = 64;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  ls_reroll_wide_kernel<4, JT><<<blocks, threads, 0, s>>>(
      *T, *P, coeffs, x0T, xsT, usT, KsT, ksT, (const JT*)old_jac, a_sel,
      tmask, jmask, out_xs, out_us, (JT*)out_jac, out_du2, H, B);
}

// P: only umin and umax are read. jac_bf16: old_jac and out_jac
// are bfloat16, else float.
extern "C" int ampc_ls_reroll_wide(
    const FeatTable* T, const LSParams* P, const float* coeffs,
    const float* x0T, const float* xsT, const float* usT, const float* KsT,
    const float* ksT, const void* old_jac, const float* a_sel,
    const uint8_t* tmask, const uint8_t* jmask, float* out_xs, float* out_us,
    void* out_jac, float* out_du2, int jac_bf16, int ds, int H, int B,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ds != 4 || T->d != ds + 1 || T->n < 1 || T->n > AMPC_MAX_F)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (jac_bf16)
    launch<__nv_bfloat16>(T, P, coeffs, x0T, xsT, usT, KsT, ksT, old_jac,
                          a_sel, tmask, jmask, out_xs, out_us, out_jac,
                          out_du2, H, B, s);
  else
    launch<float>(T, P, coeffs, x0T, xsT, usT, KsT, ksT, old_jac, a_sel,
                  tmask, jmask, out_xs, out_us, out_jac, out_du2, H, B, s);
  return (int)cudaGetLastError();
}
