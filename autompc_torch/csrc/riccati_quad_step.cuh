// One step of the dc=1 Riccati recursion for a diagonal quadratic cost,
// shared by the lanes-last kernel (riccati_quad.cu) and the batch-major
// kernel (riccati_quad_bm.cu). The two kernels differ only in how they
// fetch a step's Jacobians, trajectory point and cost diagonals and in
// where they store the gains; the arithmetic below is written once, in
// the order of autompc_tpu/ops/pallas_riccati.py: _bq_step (left folds
// over k for every contraction):
//   Quu = Cuu + Ju'V Ju, Qux = Ju'V Jx, qu = cu + Ju'v,
//   K = -Qux/Quu, k = -qu/Quu, lin += qu k, quad += k Quu k,
//   V <- Cxx + Jx'V Jx + Qux'K + K'Qux + K'Quu K,
//   v <- cx + Jx'v + Qux' k + K'(qu + Quu k).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define AMPC_MAX_OBS 8

// The cost's host-side constants. qd/rd/fd are read only by a kernel
// that is not handed per-lane cost planes; obsdim, two_dt and goal are
// read by all.
struct QuadDiag {
  int obsdim;
  float two_dt;  // 2 * dt
  float qd[AMPC_MAX_OBS];
  float rd;
  float fd[AMPC_MAX_OBS];
  float goal[AMPC_MAX_OBS];
};

// Jx[k][j] = d x'_k / d x_j, Ju[k] = d x'_k / d u; cx, cu the dt-scaled
// stage gradients; rd2 = 2 R dt; qd[i] = 2 Q_ii dt (0 beyond obsdim).
// Updates V, v, lin, quad in place and returns the step's gains.
template <int DS>
__device__ __forceinline__ void ampc_bq_step(
    const float (&Jx)[DS][DS], const float (&Ju)[DS], const float (&cx)[DS],
    float cu, float rd2, const float (&qd)[DS], float (&V)[DS][DS],
    float (&v)[DS], float (&K)[DS], float& kff, float& lin, float& quad) {
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
#pragma unroll
  for (int j = 0; j < DS; ++j) K[j] = -Qux[j] * inv_quu;
  kff = -qu * inv_quu;
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
}
