// K4: batch-major Riccati backward pass for any (ds, dc) from dense stage
// expansions.
//
// Replaces the Pallas TPU kernels of autompc_tpu/ops/pallas_riccati.py:
// _backward_general_kernel (via pallas_tvlqr_backward_general, any ds, dc)
// and, instantiated at dc = 1, _backward_kernel (via pallas_tvlqr_backward:
// the same recursion with a scalar Quu). Per lane, for t = H-1 .. 0:
//   JV = [Jx | Ju]' [V | v]                      (one product, P1)
//   Qxx = Cxx + JxV Jx, Qux = JuV Jx, Quu = Cuu + JuV Ju,
//   qx = cx + Jx'v, qu = cu + Ju'v               (P2)
//   Quu = L L' (Cholesky, no pivoting, no regularization; at dc = 1 the
//   reciprocal of the scalar Quu, as _backward_kernel takes it);
//   K = -Quu^-1 Qux column by column, k = -Quu^-1 qu   (P3)
//   lin += qu.k, quad += k'Quu k, KQuu = K'Quu, resid = qu + Quu k  (P4)
//   V <- Qxx + Qux'K + K'Qux + KQuu K, v <- qx + Qux'k + K' resid   (P5)
// Every sum is a left fold in index order, as the TPU body's Python sum();
// a Quu that is not positive definite gives NaN for that lane, as there.
//
// What bounds it on an H100: bytes. Per lane and step the kernel reads
// 2 ds^2 + ds dc + dc^2 + ds + dc floats and writes dc (ds + 1): 3.72 KB
// at (18, 6), 762 MB for B = 1024, H = 200, against ~48 kflop per
// lane-step. The TPU kernel gives a lane one vector slot and streams
// time-major slabs; here V (ds x ds + ds floats) does not fit one thread's
// registers, so a lane is one thread block: V and every intermediate live
// in shared memory (9.4 KB at (18, 6)), each product is spread over the
// block's threads one output element at a time, and the dc x dc
// factorization is repeated in registers by each of the ds + 1 threads
// that solves one right-hand side. The batch-major inputs are then the
// natural layout (a lane-step is one contiguous run of each array, read
// coalesced), so no time-major copy is made. The next step's inputs are
// loaded into registers while the current step computes.
#include <cuda_runtime.h>

template <int DS, int DC, int NT>
__global__ void __launch_bounds__(NT) riccati_general_kernel(
    const float* __restrict__ Jx, const float* __restrict__ Ju,
    const float* __restrict__ Cxx, const float* __restrict__ Cuu,
    const float* __restrict__ cx, const float* __restrict__ cu,
    const float* __restrict__ Vn, const float* __restrict__ vn,
    float* __restrict__ Ks, float* __restrict__ ks,
    float* __restrict__ lin_out, float* __restrict__ quad_out, int H) {
  constexpr int DD = DS * DS, DU = DS * DC, UU = DC * DC;
  constexpr int NV = DS + 1;   // columns of [V | v]
  constexpr int NJ = DS + DC;  // columns of [Jx | Ju]
  constexpr int RDD = (DD + NT - 1) / NT, RDU = (DU + NT - 1) / NT;
  constexpr int RUU = (UU + NT - 1) / NT, RDS = (DS + NT - 1) / NT;
  constexpr int RDC = (DC + NT - 1) / NT;
  const int tid = threadIdx.x;
  const long long lane = blockIdx.x;

  __shared__ float sJx[DD], sJu[DU], sCxx[DD], sCuu[UU], scx[DS], scu[DC];
  __shared__ float sVv[DS * NV];  // row k: V[k][0..DS-1], v[k]
  __shared__ float sJV[NJ * NV];  // rows 0..DS-1: Jx'[V|v]; then Ju'[V|v]
  __shared__ float sQ[NJ * DS];   // rows 0..DS-1: Qxx; then Qux
  __shared__ float sQuu[UU], sqx[DS], squ[DC];
  __shared__ float sK[DU], skff[DC], sKQuu[DU], sresid[DC], sQk[DC];

  float pJx[RDD], pJu[RDU], pCxx[RDD], pCuu[RUU], pcx[RDS], pcu[RDC];

  auto fetch = [&](int t) {
    const long long s = lane * H + t;
#pragma unroll
    for (int r = 0; r < RDD; ++r) {
      const int i = tid + r * NT;
      if (i < DD) {
        pJx[r] = Jx[s * DD + i];
        pCxx[r] = Cxx[s * DD + i];
      }
    }
#pragma unroll
    for (int r = 0; r < RDU; ++r) {
      const int i = tid + r * NT;
      if (i < DU) pJu[r] = Ju[s * DU + i];
    }
#pragma unroll
    for (int r = 0; r < RUU; ++r) {
      const int i = tid + r * NT;
      if (i < UU) pCuu[r] = Cuu[s * UU + i];
    }
#pragma unroll
    for (int r = 0; r < RDS; ++r) {
      const int i = tid + r * NT;
      if (i < DS) pcx[r] = cx[s * DS + i];
    }
#pragma unroll
    for (int r = 0; r < RDC; ++r) {
      const int i = tid + r * NT;
      if (i < DC) pcu[r] = cu[s * DC + i];
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int r = 0; r < RDD; ++r) {
      const int i = tid + r * NT;
      if (i < DD) {
        sJx[i] = pJx[r];
        sCxx[i] = pCxx[r];
      }
    }
#pragma unroll
    for (int r = 0; r < RDU; ++r) {
      const int i = tid + r * NT;
      if (i < DU) sJu[i] = pJu[r];
    }
#pragma unroll
    for (int r = 0; r < RUU; ++r) {
      const int i = tid + r * NT;
      if (i < UU) sCuu[i] = pCuu[r];
    }
#pragma unroll
    for (int r = 0; r < RDS; ++r) {
      const int i = tid + r * NT;
      if (i < DS) scx[i] = pcx[r];
    }
#pragma unroll
    for (int r = 0; r < RDC; ++r) {
      const int i = tid + r * NT;
      if (i < DC) scu[i] = pcu[r];
    }
  };

  // Terminal expansion and the last step's inputs.
  for (int e = tid; e < DD; e += NT)
    sVv[(e / DS) * NV + e % DS] = Vn[lane * DD + e];
  for (int e = tid; e < DS; e += NT) sVv[e * NV + DS] = vn[lane * DS + e];
  fetch(H - 1);
  stage();
  __syncthreads();

  float lin = 0.f, quad = 0.f;  // thread 0's accumulators
  for (int t = H - 1; t >= 0; --t) {
    if (t > 0) fetch(t - 1);

    // P1: JV[c][j] = sum_k J[k][c] Vv[k][j]; the v column gives qx, qu.
    for (int e = tid; e < NJ * NV; e += NT) {
      const int c = e / NV, j = e % NV;
      const float* Jc = c < DS ? sJx + c : sJu + (c - DS);
      const int st = c < DS ? DS : DC;
      float s = Jc[0] * sVv[j];
#pragma unroll
      for (int k = 1; k < DS; ++k) s = s + Jc[k * st] * sVv[k * NV + j];
      if (j < DS)
        sJV[c * NV + j] = s;
      else if (c < DS)
        sqx[c] = scx[c] + s;
      else
        squ[c - DS] = scu[c - DS] + s;
    }
    __syncthreads();

    // P2: Qxx, Qux (rows of sQ) and Quu.
    for (int e = tid; e < NJ * DS + UU; e += NT) {
      if (e < NJ * DS) {
        const int c = e / DS, j = e % DS;
        const float* JVc = sJV + c * NV;
        float s = JVc[0] * sJx[j];
#pragma unroll
        for (int k = 1; k < DS; ++k) s = s + JVc[k] * sJx[k * DS + j];
        sQ[e] = c < DS ? sCxx[e] + s : s;
      } else {
        const int a = (e - NJ * DS) / DC, b2 = (e - NJ * DS) % DC;
        const float* JVa = sJV + (DS + a) * NV;
        float s = JVa[0] * sJu[b2];
#pragma unroll
        for (int k = 1; k < DS; ++k) s = s + JVa[k] * sJu[k * DC + b2];
        sQuu[a * DC + b2] = sCuu[a * DC + b2] + s;
      }
    }
    __syncthreads();

    // P3: per right-hand side (ds columns of Qux, then qu) one thread:
    // Cholesky of Quu in registers, forward and back substitution.
    if constexpr (DC == 1) {
      // The dc = 1 TPU kernel divides by the scalar Quu: a negative Quu
      // gives finite (useless) gains there, not the NaN of a square root.
      if (tid < DS + 1) {
        const float inv = 1.f / sQuu[0];
        if (tid < DS)
          sK[tid] = -(sQ[DS * DS + tid] * inv);
        else
          skff[0] = -(squ[0] * inv);
      }
    } else if (tid < DS + 1) {
      float L[DC][DC], inv[DC];
#pragma unroll
      for (int a = 0; a < DC; ++a) {
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < a; ++m) acc = acc + L[a][m] * L[a][m];
        L[a][a] = sqrtf(sQuu[a * DC + a] - acc);
        inv[a] = 1.f / L[a][a];
#pragma unroll
        for (int r = a + 1; r < DC; ++r) {
          float acc2 = 0.f;
#pragma unroll
          for (int m = 0; m < a; ++m) acc2 = acc2 + L[r][m] * L[a][m];
          L[r][a] = (sQuu[r * DC + a] - acc2) * inv[a];
        }
      }
      float y[DC], x[DC];
#pragma unroll
      for (int a = 0; a < DC; ++a) {
        const float rhs = tid < DS ? sQ[(DS + a) * DS + tid] : squ[a];
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < a; ++m) acc = acc + L[a][m] * y[m];
        y[a] = (rhs - acc) * inv[a];
      }
#pragma unroll
      for (int a = DC - 1; a >= 0; --a) {
        float acc = 0.f;
#pragma unroll
        for (int r = a + 1; r < DC; ++r) acc = acc + L[r][a] * x[r];
        x[a] = (y[a] - acc) * inv[a];
      }
#pragma unroll
      for (int a = 0; a < DC; ++a) {
        if (tid < DS)
          sK[a * DS + tid] = -x[a];
        else
          skff[a] = -x[a];
      }
    }
    __syncthreads();

    // P4: KQuu = K'Quu, Quu k, resid = qu + Quu k.
    for (int e = tid; e < DU + DC; e += NT) {
      if (e < DU) {
        const int i = e / DC, b2 = e % DC;
        float s = sK[i] * sQuu[b2];
#pragma unroll
        for (int a = 1; a < DC; ++a) s = s + sK[a * DS + i] * sQuu[a * DC + b2];
        sKQuu[e] = s;
      } else {
        const int a = e - DU;
        float s = sQuu[a * DC] * skff[0];
#pragma unroll
        for (int b2 = 1; b2 < DC; ++b2) s = s + sQuu[a * DC + b2] * skff[b2];
        sQk[a] = s;
        sresid[a] = squ[a] + s;
      }
    }
    __syncthreads();

    // P5: next V and v, the expected reductions, the gains to memory, and
    // the prefetched inputs of step t-1 into shared memory.
    for (int e = tid; e < DD + DS; e += NT) {
      if (e < DD) {
        const int i = e / DS, j = e % DS;
        float s1 = sQ[DS * DS + i] * sK[j];
        float s2 = sK[i] * sQ[DS * DS + j];
        float s3 = sKQuu[i * DC] * sK[j];
#pragma unroll
        for (int a = 1; a < DC; ++a) {
          s1 = s1 + sQ[(DS + a) * DS + i] * sK[a * DS + j];
          s2 = s2 + sK[a * DS + i] * sQ[(DS + a) * DS + j];
          s3 = s3 + sKQuu[i * DC + a] * sK[a * DS + j];
        }
        sVv[i * NV + j] = sQ[e] + s1 + s2 + s3;
      } else {
        const int i = e - DD;
        float s1 = sQ[DS * DS + i] * skff[0];
        float s2 = sK[i] * sresid[0];
#pragma unroll
        for (int a = 1; a < DC; ++a) {
          s1 = s1 + sQ[(DS + a) * DS + i] * skff[a];
          s2 = s2 + sK[a * DS + i] * sresid[a];
        }
        sVv[i * NV + DS] = sqx[i] + s1 + s2;
      }
    }
    if (tid == 0) {
      float s1 = squ[0] * skff[0], s2 = skff[0] * sQk[0];
#pragma unroll
      for (int a = 1; a < DC; ++a) {
        s1 = s1 + squ[a] * skff[a];
        s2 = s2 + skff[a] * sQk[a];
      }
      lin = lin + s1;
      quad = quad + s2;
    }
    const long long s = lane * H + t;
    for (int e = tid; e < DU; e += NT) Ks[s * DU + e] = sK[e];
    for (int e = tid; e < DC; e += NT) ks[s * DC + e] = skff[e];
    if (t > 0) stage();
    __syncthreads();
  }
  if (tid == 0) {
    lin_out[lane] = lin;
    quad_out[lane] = quad;
  }
}

extern "C" int ampc_riccati_general(
    const float* Jx, const float* Ju, const float* Cxx, const float* Cuu,
    const float* cx, const float* cu, const float* Vn, const float* vn,
    float* Ks, float* ks, float* lin, float* quad, int ds, int dc, int H,
    int B, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (ds == 18 && dc == 6) {
    riccati_general_kernel<18, 6, 128><<<(unsigned)B, 128, 0, st>>>(
        Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn, Ks, ks, lin, quad, H);
  } else if (ds == 4 && dc == 1) {
    riccati_general_kernel<4, 1, 32><<<(unsigned)B, 32, 0, st>>>(
        Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn, Ks, ks, lin, quad, H);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
