// K7: unfused iLQR line-search rollouts for a linear-in-features model,
// batch-major, dc=1: every candidate step size is rolled through the
// dynamics and WRITTEN OUT; the objective and the choice are the
// caller's.
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_linesearch.py:
// _ls_kernel (entry pallas_sindy_line_search) with one shared (ds, F)
// coefficient plane. Per (lane b, step size l):
//   x_0 = x0[b];  for t < H:
//     u_t = clip(alpha_l k_t + ubar_t + K_t (x_t - xbar_t)),
//     x_{t+1} = coeffs @ features([x_t, u_t]),
//   ls_xs[b, l, t] = x_t (t <= H), ls_us[b, l, t] = u_t.
// The feedback sum is a left fold over the state components, the order of
// _ls_kernel's sum(); the feature sum is the balanced tree of features.cuh
// (the same pairing as _ls_kernel's tree_sum). The clip is written with
// comparisons so that a NaN control (NaN gains) stays NaN.
//
// Design: B x L independent chains of H dependent steps, one thread per
// (lane, step size), the L threads of a lane adjacent so that they read
// the lane's carry rows (xbar, K, ubar, k: 40 bytes a step at ds=4) from
// the same sectors. Inputs are read in place from the batch-major carry
// and each thread writes its own rows of the (B, L, H+1, ds) and
// (B, L, H, 1) outputs; the TPU wrapper's seven transposes have no
// counterpart. Term table in the constant bank (__grid_constant__),
// coefficient plane in shared memory.
//
// What bounds it on an H100: by bytes it should be the written
// trajectories (L (ds + 1) floats a lane-step); in fact, as for the fused
// kernel, the chain of H steps of sinf/cosf terms per thread, with B x L
// threads to hide it behind (ten times the fused kernel's thread count at
// the same batch). Measured on an H100 (700 W) at B=4096, H=200, L=10,
// seven active terms: 1.37 ms, against 10.6 ms for the fused kernel, which
// rolls the same ten chains (and one more) in one thread.
#include "features.cuh"

#define AMPC_MAX_L 10

struct SindyLS {
  int L;
  float alphas[AMPC_MAX_L];
  float umin, umax;
};

template <int DS>
__global__ void sindy_ls_kernel(
    const __grid_constant__ FeatTable T, const __grid_constant__ SindyLS P,
    const float* __restrict__ coeffs, const float* __restrict__ x0,
    const float* __restrict__ xs, const float* __restrict__ us,
    const float* __restrict__ Ks, const float* __restrict__ ks,
    float* __restrict__ out_xs, float* __restrict__ out_us, int H, int B) {
  constexpr int D = DS + 1;
  __shared__ float s_coef[DS * AMPC_MAX_F];
  ampc_load_coef(s_coef, coeffs, DS * T.n);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * P.L) return;
  const int b = (int)(idx / P.L);
  const int l = (int)(idx - (long long)b * P.L);
  const float alpha = P.alphas[l];

  float x[DS];
  float* oxs = out_xs + idx * (H + 1) * DS;
  float* ous = out_us + idx * H;
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    x[i] = x0[(long long)b * DS + i];
    oxs[i] = x[i];
  }
  const float* xbar_row = xs + (long long)b * (H + 1) * DS;
  for (int t = 0; t < H; ++t) {
    const long long bt = (long long)b * H + t;
    float fb = 0.f;
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      const float term = Ks[bt * DS + i] * (x[i] - xbar_row[t * DS + i]);
      fb = i == 0 ? term : fb + term;
    }
    float u = alpha * ks[bt] + us[bt] + fb;
    u = u < P.umin ? P.umin : (u > P.umax ? P.umax : u);
    float z[D];
#pragma unroll
    for (int i = 0; i < DS; ++i) z[i] = x[i];
    z[DS] = u;
    ampc_dynamics<DS, D>(T, s_coef, z, x);
#pragma unroll
    for (int i = 0; i < DS; ++i) oxs[(t + 1) * DS + i] = x[i];
    ous[t] = u;
  }
}

extern "C" int ampc_sindy_line_search(
    const FeatTable* T, const SindyLS* P, const float* coeffs,
    const float* x0, const float* xs, const float* us, const float* Ks,
    const float* ks, float* out_xs, float* out_us, int ds, int H, int B,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ds != 4 || T->d != ds + 1 || T->n < 1 || T->n > AMPC_MAX_F ||
      P->L < 1 || P->L > AMPC_MAX_L)
    return (int)cudaErrorInvalidValue;
  const int threads = 64;
  const long long n = (long long)B * P->L;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  sindy_ls_kernel<4><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *T, *P, coeffs, x0, xs, us, Ks, ks, out_xs, out_us, H, B);
  return (int)cudaGetLastError();
}
