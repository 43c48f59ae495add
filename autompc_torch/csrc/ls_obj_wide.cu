// K8: the objective sweep of the split ("wide") line search, lanes-last,
// dc=1, diagonal quadratic cost: one fixed cost for every lane (host
// constants in LSParams) or one cost per lane (lanes-last device planes
// qdT/fdT (obsdim, B), rdT (1, B)), a template switch.
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_linesearch.py:
// _ls_obj_kernel_wide (the first pallas_call of
// pallas_fused_line_search_wide, make_batched_ilqr_solver(ls_wide=True)).
// For every (lane b, step size l):
//   x_0 = x0[b];  for t < H:
//     u_t = clip(alpha_l k_t + ubar_t + K_t (x_t - xbar_t)),
//     obj += dt ((x_t - g)'Q(x_t - g) + R u_t^2),
//     x_{t+1} = coeffs @ features([x_t, u_t]);
//   objs[l, b] = obj + (x_H - g)'F(x_H - g).
// Only the (L, B) objectives leave the kernel: the acceptance rule runs in
// tensor code and K9 (ls_reroll_wide.cu) re-rolls the chosen step size.
// The step is ls_step.cuh's ls_obj_step, the same code as the fused
// kernel's candidate threads (linesearch_fused.cu), so the two score a
// candidate identically.
//
// Design: the TPU kernel puts the L candidates of a (S, 128) lane slab on
// the vector unit together; here each (lane, step size) is a thread of its
// own, a lane's L threads adjacent (K7's layout, sindy_linesearch.cu), so
// B x L independent chains of H dependent steps hide each other's
// latency, where the fused kernel runs a lane's L chains in one thread.
// The lanes-last carry is read in place (the L threads of a lane read the
// same words), the term table sits in the constant bank
// (__grid_constant__), the coefficient plane in shared memory, and no
// trajectory is written.
//
// What bounds it on an H100: by bytes, reading the carry once
// (~(2 ds + 2) floats a lane-step) and writing L floats a lane; in fact
// the H-step chain of sinf/cosf terms per thread, as for K7.
#include "ls_step.cuh"

template <int DS, bool LANE_COST>
__global__ void ls_obj_wide_kernel(
    const __grid_constant__ FeatTable T, const __grid_constant__ LSParams P,
    const float* __restrict__ coeffs, const float* __restrict__ x0T,
    const float* __restrict__ xsT, const float* __restrict__ usT,
    const float* __restrict__ KsT, const float* __restrict__ ksT,
    const float* __restrict__ qdT, const float* __restrict__ rdT,
    const float* __restrict__ fdT, float* __restrict__ objs, int H, int B) {
  __shared__ float s_coef[DS * AMPC_MAX_F];
  ampc_load_coef(s_coef, coeffs, DS * T.n);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * P.L) return;
  const int b = (int)(idx / P.L);
  const int l = (int)(idx - (long long)b * P.L);
  const float alpha = P.alphas[l];

  float x[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) x[i] = x0T[(long long)i * B + b];

  float q_lane[DS];
  float rd = P.rd;
  if constexpr (LANE_COST) {
#pragma unroll
    for (int i = 0; i < DS; ++i)
      q_lane[i] = i < P.obsdim ? qdT[(long long)i * B + b] : 0.f;
    rd = rdT[b];
  }
  const float* wq = LANE_COST ? q_lane : P.qd;

  float obj = 0.f;
  for (int t = 0; t < H; ++t) {
    float xbar[DS], K[DS], ubar, kk;
    ls_load_row<DS>(xsT, usT, KsT, ksT, t, B, b, xbar, K, ubar, kk);
    ls_obj_step<DS>(T, s_coef, P, x, xbar, K, ubar, kk, alpha, wq, rd, obj);
  }
  float f_lane[DS];
  if constexpr (LANE_COST) {
#pragma unroll
    for (int i = 0; i < DS; ++i)
      f_lane[i] = i < P.obsdim ? fdT[(long long)i * B + b] : 0.f;
  }
  const float* wf = LANE_COST ? f_lane : P.fd;
  objs[(long long)l * B + b] = obj + ls_quad_form<DS>(P, x, wf);
}

// qdT/rdT/fdT: per-lane cost planes, or all three null for the fixed
// cost held in P. objs: (L, B).
extern "C" int ampc_ls_obj_wide(const FeatTable* T, const LSParams* P,
                                const float* coeffs, const float* x0T,
                                const float* xsT, const float* usT,
                                const float* KsT, const float* ksT,
                                const float* qdT, const float* rdT,
                                const float* fdT, float* objs, int ds, int H,
                                int B, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool lane = qdT != nullptr;
  if (ds != 4 || T->d != ds + 1 || T->n < 1 || T->n > AMPC_MAX_F ||
      P->L < 1 || P->L > AMPC_MAX_L || P->obsdim < 1 || P->obsdim > ds ||
      (rdT != nullptr) != lane || (fdT != nullptr) != lane)
    return (int)cudaErrorInvalidValue;
  const int threads = 64;
  const long long n = (long long)B * P->L;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (lane)
    ls_obj_wide_kernel<4, true><<<blocks, threads, 0, s>>>(
        *T, *P, coeffs, x0T, xsT, usT, KsT, ksT, qdT, rdT, fdT, objs, H, B);
  else
    ls_obj_wide_kernel<4, false><<<blocks, threads, 0, s>>>(
        *T, *P, coeffs, x0T, xsT, usT, KsT, ksT, qdT, rdT, fdT, objs, H, B);
  return (int)cudaGetLastError();
}
