// K6: batch-major Riccati backward pass for a per-lane diagonal quadratic
// cost, dc=1.
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_riccati.py:
// _backward_quad_kernel (entry pallas_tvlqr_backward_quad): the same
// recursion as the lanes-last kernel (riccati_quad.cu; the step itself is
// riccati_quad_step.cuh), on the arrays the batch-major iLQR body carries:
//   Jx (B, H, ds, ds), Ju (B, H, ds, 1), xs (B, H+1, ds), us (B, H, 1),
//   Qd/Fd (B, obsdim), Rd (B, 1), goal shared
//   -> Ks (B, H, 1, ds), ks (B, H, 1), lin (B,), quad (B,).
// The stage and terminal expansions are built inline from the trajectory
// and the lane's cost diagonals. There is no carry select: the solver body
// masks the gains afterwards.
//
// The TPU wrapper transposes all five streams to lanes-last and the two
// gain arrays back, because a TPU tile wants the batch in its lane
// dimension. None of that is carried over: one thread owns one lane and
// reads its rows in place. A lane's step is ds*ds + 3*ds + 2 contiguous
// floats in four arrays (64 + 16 + 16 + 4 bytes at ds=4), fetched with
// 16-byte loads where ds is a multiple of 4; neighbouring threads are H
// rows apart, so the loads are not coalesced across a warp, but every
// 32-byte sector fetched is used whole (Jx) or by the next step of the
// same thread (Ju, xs, Ks).
//
// What bounds it on an H100: as the lanes-last kernel, the dependent chain
// of H steps per thread, not bytes. At the fan-out's shape (H=10, B <=
// 1024, 128 lanes after compaction) the grid is a few warps and the card
// is mostly empty; 32-thread blocks spread what warps there are.
#include "riccati_quad_step.cuh"

// DS contiguous floats; one 16-byte load per four where DS allows it
// (every row start is then 16-byte aligned: row index times DS floats).
template <int DS>
__device__ __forceinline__ void bm_load_row(const float* __restrict__ p,
                                            float (&out)[DS]) {
  if constexpr (DS % 4 == 0) {
#pragma unroll
    for (int q = 0; q < DS / 4; ++q) {
      const float4 w = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = w.x;
      out[4 * q + 1] = w.y;
      out[4 * q + 2] = w.z;
      out[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DS; ++i) out[i] = p[i];
  }
}

template <int DS>
__device__ __forceinline__ void bm_store_row(float* __restrict__ p,
                                             const float (&v)[DS]) {
  if constexpr (DS % 4 == 0) {
#pragma unroll
    for (int q = 0; q < DS / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < DS; ++i) p[i] = v[i];
  }
}

template <int DS>
__global__ void backward_quad_bm_kernel(
    const __grid_constant__ QuadDiag P, const float* __restrict__ Jx_in,
    const float* __restrict__ Ju_in, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ Qd,
    const float* __restrict__ Rd, const float* __restrict__ Fd,
    float* __restrict__ Ks, float* __restrict__ ks,
    float* __restrict__ lin_out, float* __restrict__ quad_out, int H, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int obsdim = P.obsdim;

  float qd[DS], goal[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    qd[i] = i < obsdim ? Qd[(long long)b * obsdim + i] * P.two_dt : 0.f;
    goal[i] = i < obsdim ? P.goal[i] : 0.f;
  }
  const float rd2 = Rd[b] * P.two_dt;

  const float* xrow = xs + (long long)b * (H + 1) * DS;
  float x[DS];
  bm_load_row<DS>(xrow + (long long)H * DS, x);
  float V[DS][DS], v[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const float fd2 = i < obsdim ? Fd[(long long)b * obsdim + i] * 2.f : 0.f;
#pragma unroll
    for (int j = 0; j < DS; ++j) V[i][j] = (i == j) ? fd2 : 0.f;
    v[i] = i < obsdim ? fd2 * (x[i] - goal[i]) : 0.f;
  }

  float lin = 0.f, quad = 0.f;
  for (int t = H - 1; t >= 0; --t) {
    const long long bt = (long long)b * H + t;
    float Jx[DS][DS], Ju[DS];
#pragma unroll
    for (int k = 0; k < DS; ++k)
      bm_load_row<DS>(Jx_in + (bt * DS + k) * DS, Jx[k]);
    bm_load_row<DS>(Ju_in + bt * DS, Ju);
    bm_load_row<DS>(xrow + (long long)t * DS, x);
    float cx[DS];
#pragma unroll
    for (int i = 0; i < DS; ++i)
      cx[i] = i < obsdim ? qd[i] * (x[i] - goal[i]) : 0.f;
    const float cu = rd2 * us[bt];

    float K[DS], kff;
    ampc_bq_step<DS>(Jx, Ju, cx, cu, rd2, qd, V, v, K, kff, lin, quad);

    bm_store_row<DS>(Ks + bt * DS, K);
    ks[bt] = kff;
  }
  lin_out[b] = lin;
  quad_out[b] = quad;
}

extern "C" int ampc_backward_quad_bm(const QuadDiag* P, const float* Jx,
                                     const float* Ju, const float* xs,
                                     const float* us, const float* Qd,
                                     const float* Rd, const float* Fd,
                                     float* Ks, float* ks, float* lin,
                                     float* quad, int ds, int H, int B,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ds != 4 || P->obsdim < 1 || P->obsdim > ds)
    return (int)cudaErrorInvalidValue;
  const int threads = 32;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  backward_quad_bm_kernel<4><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *P, Jx, Ju, xs, us, Qd, Rd, Fd, Ks, ks, lin, quad, H, B);
  return (int)cudaGetLastError();
}
