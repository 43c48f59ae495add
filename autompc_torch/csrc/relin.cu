// K1: batched dynamics relinearization for linear-in-features models.
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_relin.py:
// _relin_kernel (sparse grad_terms branch), entry
// pallas_feature_jacobians. It computes J(x_t, u_t) = coeffs . dTheta/dz
// at every (lane, step) of the lanes-last trajectory and writes the
// PACKED plane jac (H, ds*(ds+1), B), row i*(ds+1)+dd = d x'_i / d z_dd —
// the layout the Riccati and line-search kernels consume, so the solver
// skips the JAX path's (B, H, ds, d) -> (H, ds*d, B) transposes.
//
// What bounds it on an H100: nothing sequential — one thread per
// (step, lane), B*H threads. Per point it reads ds+1 floats and writes
// ds*(ds+1) (20 at ds=4), and evaluates the sparse partials of the
// active terms (sinf/cosf dominate the arithmetic). At the main-path
// shape (H=200, B up to 16384) that is a few million threads: the card
// is filled and the store stream is the larger cost. Design: neighbouring
// threads take neighbouring lanes of one step, so every load and every
// row store is one coalesced transaction per warp; the coefficient plane
// sits in shared memory and the term table in the constant bank, both
// read as broadcasts.
#include "features.cuh"

template <int DS>
__global__ void relin_kernel(const __grid_constant__ FeatTable T,
                             const float* __restrict__ coeffs,
                             const float* __restrict__ xsT,
                             const float* __restrict__ usT,
                             float* __restrict__ jac, int H, int B) {
  constexpr int D = DS + 1;
  __shared__ float s_coef[DS * AMPC_MAX_F];
  ampc_load_coef(s_coef, coeffs, DS * T.n);

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)H * B) return;
  const int t = (int)(idx / B);
  const int b = (int)(idx - (long long)t * B);

  float z[D];
#pragma unroll
  for (int i = 0; i < DS; ++i) z[i] = xsT[((long long)t * DS + i) * B + b];
  z[DS] = usT[(long long)t * B + b];

  float rows[DS * D];
  ampc_jac_rows<DS, D>(T, s_coef, z, rows);
#pragma unroll
  for (int r = 0; r < DS * D; ++r)
    jac[((long long)t * DS * D + r) * B + b] = rows[r];
}

extern "C" int ampc_relin_jacobians(const FeatTable* T, const float* coeffs,
                                    const float* xsT, const float* usT,
                                    float* jac, int ds, int H, int B,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ds != 4 || T->d != ds + 1 || T->n < 1 || T->n > AMPC_MAX_F)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long total = (long long)H * B;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  relin_kernel<4><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *T, coeffs, xsT, usT, jac, H, B);
  return (int)cudaGetLastError();
}
