// K2: lanes-last Riccati backward pass for a diagonal quadratic cost, dc=1.
//
// Replaces the Pallas TPU kernels autompc_tpu/ops/pallas_riccati.py:
// _backward_quad_kernel_packed (via pallas_tvlqr_backward_quad_ll, any B)
// and _backward_quad_kernel_wide with step_mode="std" (via
// _backward_quad_ll_wide_cast, B % 1024 == 0). Both evaluate one step
// function, _bq_step, in two TPU tile layouts; this kernel is that math
// once, for every batch size:
//   stage expansions built inline from the trajectory (cx = 2 Q dt (x-g),
//   cu = 2 R dt u, Cxx = diag(2 Q dt), Cuu = 2 R dt), terminal
//   Vn = diag(2 F), vn = 2 F (x_H - g), then for t = H-1 .. 0
//   Quu = Cuu + Ju'V Ju, Qux = Ju'V Jx, qu = cu + Ju'v,
//   K = -Qux/Quu, k = -qu/Quu, lin += qu k, quad += k Quu k,
//   V <- Cxx + Jx'V Jx + Qux'K + K'Qux + K'Quu K,
//   v <- cx + Jx'v + Qux' k + K'(qu + Quu k).
// In-kernel carry select: a lane that is no longer active writes its old
// K/k back, so the solver needs no separate select pass.
//
// What bounds it on an H100: the recursion is sequential in t and
// independent across lanes, so the kernel runs one thread per lane with
// V (ds x ds) and v in registers, ~300 flops per step. Each step streams
// ds*(ds+1) Jacobian floats in and ds+1 gain floats out per lane; with
// B=16384 lanes there are only 16384 threads, far fewer than the card
// holds, so the kernel is latency-bound on the dependent chain of each
// step rather than on bandwidth. Design for now: lanes-last layout so a
// warp's loads and stores of one row are coalesced, small blocks (64
// threads) to spread the few warps over all SMs. The TPU's (8, 128) wide
// tiles and in-VMEM casts have no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

#define AMPC_MAX_OBS 8

struct QuadDiag {
  int obsdim;
  float two_dt;  // 2 * dt
  float qd[AMPC_MAX_OBS];
  float rd;
  float fd[AMPC_MAX_OBS];
  float goal[AMPC_MAX_OBS];
};

template <int DS>
__global__ void backward_quad_kernel(
    const __grid_constant__ QuadDiag P, const float* __restrict__ jac,
    const float* __restrict__ xsT, const float* __restrict__ usT,
    const uint8_t* __restrict__ act, const float* __restrict__ oldK,
    const float* __restrict__ oldk, float* __restrict__ KsT,
    float* __restrict__ ksT, float* __restrict__ lin_out,
    float* __restrict__ quad_out, int H, int B) {
  constexpr int D = DS + 1;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const bool active = act[b] != 0;
  const int obsdim = P.obsdim;

  float qd[DS], goal[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    qd[i] = i < obsdim ? P.qd[i] * P.two_dt : 0.f;
    goal[i] = i < obsdim ? P.goal[i] : 0.f;
  }
  const float rd2 = P.rd * P.two_dt;

  // Terminal expansion.
  float V[DS][DS], v[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const float fd2 = i < obsdim ? P.fd[i] * 2.f : 0.f;
#pragma unroll
    for (int j = 0; j < DS; ++j) V[i][j] = (i == j) ? fd2 : 0.f;
    v[i] = i < obsdim ? fd2 * (xsT[((long long)H * DS + i) * B + b] - goal[i])
                      : 0.f;
  }

  float lin = 0.f, quad = 0.f;
  for (int t = H - 1; t >= 0; --t) {
    const float* row = jac + (long long)t * DS * D * B + b;
    float Jx[DS][DS], Ju[DS];
#pragma unroll
    for (int k = 0; k < DS; ++k) {
#pragma unroll
      for (int j = 0; j < DS; ++j) Jx[k][j] = row[(long long)(k * D + j) * B];
      Ju[k] = row[(long long)(k * D + DS) * B];
    }
    float cx[DS];
#pragma unroll
    for (int i = 0; i < DS; ++i)
      cx[i] = i < obsdim
                  ? qd[i] * (xsT[((long long)t * DS + i) * B + b] - goal[i])
                  : 0.f;
    const float cu = rd2 * usT[(long long)t * B + b];

    float JuV[DS];
#pragma unroll
    for (int j = 0; j < DS; ++j) {
      float s = Ju[0] * V[0][j];
#pragma unroll
      for (int k = 1; k < DS; ++k) s = s + Ju[k] * V[k][j];
      JuV[j] = s;
    }
    float sq = JuV[0] * Ju[0];
#pragma unroll
    for (int k = 1; k < DS; ++k) sq = sq + JuV[k] * Ju[k];
    const float Quu = rd2 + sq;
    const float inv_quu = 1.f / Quu;
    float Qux[DS];
#pragma unroll
    for (int j = 0; j < DS; ++j) {
      float s = JuV[0] * Jx[0][j];
#pragma unroll
      for (int k = 1; k < DS; ++k) s = s + JuV[k] * Jx[k][j];
      Qux[j] = s;
    }
    float sv = Ju[0] * v[0];
#pragma unroll
    for (int k = 1; k < DS; ++k) sv = sv + Ju[k] * v[k];
    const float qu = cu + sv;
    float K[DS];
#pragma unroll
    for (int j = 0; j < DS; ++j) K[j] = -Qux[j] * inv_quu;
    const float kff = -qu * inv_quu;
    lin = lin + qu * kff;
    quad = quad + kff * Quu * kff;

    float JxV[DS][DS];
#pragma unroll
    for (int i = 0; i < DS; ++i)
#pragma unroll
      for (int j = 0; j < DS; ++j) {
        float s = Jx[0][i] * V[0][j];
#pragma unroll
        for (int k = 1; k < DS; ++k) s = s + Jx[k][i] * V[k][j];
        JxV[i][j] = s;
      }
    float qx[DS];
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      float s = Jx[0][i] * v[0];
#pragma unroll
      for (int k = 1; k < DS; ++k) s = s + Jx[k][i] * v[k];
      qx[i] = cx[i] + s;
    }
#pragma unroll
    for (int i = 0; i < DS; ++i)
#pragma unroll
      for (int j = 0; j < DS; ++j) {
        float s = JxV[i][0] * Jx[0][j];
#pragma unroll
        for (int k = 1; k < DS; ++k) s = s + JxV[i][k] * Jx[k][j];
        const float qxx = s + ((i == j) ? qd[i] : 0.f);
        V[i][j] = qxx + Qux[i] * K[j] + K[i] * Qux[j] + K[i] * K[j] * Quu;
      }
    const float resid = qu + Quu * kff;
#pragma unroll
    for (int i = 0; i < DS; ++i) v[i] = qx[i] + Qux[i] * kff + K[i] * resid;

#pragma unroll
    for (int j = 0; j < DS; ++j) {
      const long long o = ((long long)t * DS + j) * B + b;
      KsT[o] = active ? K[j] : oldK[o];
    }
    ksT[(long long)t * B + b] = active ? kff : oldk[(long long)t * B + b];
  }
  lin_out[b] = lin;
  quad_out[b] = quad;
}

extern "C" int ampc_backward_quad_ll(const QuadDiag* P, const float* jac,
                                     const float* xsT, const float* usT,
                                     const uint8_t* act, const float* oldK,
                                     const float* oldk, float* KsT,
                                     float* ksT, float* lin, float* quad,
                                     int ds, int H, int B, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ds != 4 || P->obsdim < 1 || P->obsdim > ds)
    return (int)cudaErrorInvalidValue;
  const int threads = 64;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  backward_quad_kernel<4><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *P, jac, xsT, usT, act, oldK, oldk, KsT, ksT, lin, quad, H, B);
  return (int)cudaGetLastError();
}
