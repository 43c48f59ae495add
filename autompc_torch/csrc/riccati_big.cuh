// The dc=1 Riccati backward pass at a state too wide for the per-shape
// instances: the Koopman lifts past ds + dc = AMPC_MAX_D (24), up to the
// lift of the cartpole at polynomial degree 8 and trig frequency 8
// (N = 96). Shared by K6 (riccati_quad_bm.cu: the stage and terminal
// expansions built inline from the trajectory and the lane's diagonal
// cost) and K4 at dc = 1 (riccati_general.cu: dense expansions read from
// device memory); the state width N is a run-time argument, so one
// instance in the main library serves every lift.
//
// Replaces, at those widths, the Pallas TPU kernels of
// autompc_tpu/ops/pallas_riccati.py: _backward_quad_kernel (entry
// pallas_tvlqr_backward_quad; DENSE false) and _backward_kernel (entry
// pallas_tvlqr_backward; DENSE true), which take any ds. Per lane, for
// t = H-1 .. 0:
//   JuV = Ju'V, Quu = Cuu + JuV Ju, Qux = JuV Jx, qu = cu + Ju'v,
//   K = -Qux (1/Quu), k = -qu (1/Quu), lin += qu k, quad += k Quu k,
//   JxV = Jx'V, qx = cx + Jx'v,
//   V <- Cxx + JxV Jx + Qux'K + K'Qux + K'Quu K,
//   v <- qx + Qux'k + K'(qu + Quu k),
// every contraction a left fold over k (the order of the plain versions'
// per-lane loops; their batched products in PyTorch may sum in another
// order, so the kernel is held to them within a tolerance, not bit for
// bit).
//
// What bounds it on an H100: per lane and step ~4 N^2 operations
// (Jx'V, then (Jx'V) Jx) and N^2 floats of Jx in (2 N^2 with K4's
// dense Cxx): 36.9 kFLOP and 36.9 KB at N = 96. A lane's value matrix
// (N^2 floats, 36.9 KB at N = 96) fits no thread's registers, and the
// per-shape kernels' ring of 12 steps (~440 KB at N = 96) no block. The
// design, simple first:
// - one lane a block of RB_G threads a row (the rows N rounded up to a
//   warp): thread (i, g) owns the columns j of row i of Jx'V and of the
//   new V in its group's runs of RB_J (j / RB_J = g mod RB_G), the
//   group's first thread entry i of Ju'V, Qux, K, qx and the new v; V,
//   Jx'V (rows at an odd stride LD, so that a warp reading a column and a
//   warp reading its own rows both hit 32 banks) and the small vectors
//   live in shared memory. (At N = 96 the block's shared memory leaves
//   one block an SM: with one thread a row, 3 warps, each a chain of
//   dependent shared-memory loads with nothing to hide it.);
// - the step's inputs (Jx, Ju and x_t, u_t or cx, cu, Cuu and Cxx) stream
//   through a ring of RB_RING = 2 slots by cp.async, one step ahead of the
//   step that reads them (16-byte copies where a block is aligned);
// - each thread carries RB_J = 4 outputs of a row at once (4 independent
//   chains a thread, each operand loaded once for the 4);
// - Quu, qu, 1/Quu and k are formed by every thread from the same
//   operands in the same order, so they need no exchange; a step needs
//   three block barriers (V read, JuV formed, Qux and K formed).
// Tensor cores and TMA are later work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

#define RB_RING 2
#define RB_G 4
#define RB_MAX_THREADS 512
#define RB_J 4

__host__ __device__ constexpr int rb_up4(int n) { return (n + 3) / 4 * 4; }
// The rows of a block (N rounded up to a warp) and its threads, RB_G a row.
__host__ __device__ constexpr int rb_rows(int n) { return (n + 31) / 32 * 32; }
__host__ __device__ constexpr int rb_threads(int n) { return rb_rows(n) * RB_G; }
// The row stride of V and Jx'V: N made odd.
__host__ __device__ constexpr int rb_ld(int n) { return n | 1; }
// Floats of one ring slot: Jx (N^2), Ju (N), x_t or cx (N), then u_t, or
// cu and Cuu (4 floats), then (dense) Cxx (N^2); each region on 16 bytes.
__host__ __device__ constexpr int rb_slot(int n, bool dense) {
  return rb_up4(n * n) + 2 * rb_up4(n) + 4 + (dense ? rb_up4(n * n) : 0);
}
// Floats of a block's shared memory: V and v, Jx'V, JuV, Qux and K, the
// ring (ops/cuda_riccati.py: big_smem mirrors it).
__host__ __device__ constexpr int rb_floats(int n, bool dense) {
  return rb_up4(n * rb_ld(n)) + rb_up4(n) + rb_up4(n * rb_ld(n)) + 3 * rb_up4(n) +
         RB_RING * rb_slot(n, dense);
}

// The inputs of one lane's pass. K6 (DENSE false): the trajectory xs
// (B, H+1, N), us (B, H), the lane's cost diagonals Qd/Fd (B, obsdim) and
// Rd (B,), goal and 2 dt in QuadDiag-like scalars; K4 (DENSE true): Cxx
// (B, H, N, N), Cuu and cu (B, H), cx (B, H, N), Vn (B, N, N), vn (B, N).
struct RbArgs {
  const float* Jx;   // (B, H, N, N)
  const float* Ju;   // (B, H, N)
  const float* xs;   // K6: (B, H+1, N); K4: cx (B, H, N)
  const float* us;   // K6: (B, H); K4: cu (B, H)
  const float* Cuu;  // K4: (B, H)
  const float* Cxx;  // K4: (B, H, N, N)
  const float* Vn;   // K4: (B, N, N)
  const float* vn;   // K4: (B, N)
  const float* Qd;   // K6: (B, obsdim)
  const float* Rd;   // K6: (B,)
  const float* Fd;   // K6: (B, obsdim)
  float* Ks;         // (B, H, N)
  float* ks;         // (B, H)
  float* lin;        // (B,)
  float* quad;       // (B,)
  int obsdim;
  float two_dt;
  float goal[8];
};

// n floats from src into shared dst by the block's threads: 16-byte
// copies where both ends are 16-byte aligned and n is a multiple of 4,
// else 4-byte copies.
__device__ __forceinline__ void rb_copy(float* dst, const float* src, int n) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
      n % 4 == 0) {
    for (int q = threadIdx.x; q < n / 4; q += blockDim.x)
      ampc_cp_async16(dst + 4 * q, src + 4 * q);
  } else {
    for (int q = threadIdx.x; q < n; q += blockDim.x) ampc_cp_async4(dst + q, src + q);
  }
}

template <bool DENSE>
__global__ void __launch_bounds__(RB_MAX_THREADS)
    riccati_big_kernel(const __grid_constant__ RbArgs a, int N, int H) {
  extern __shared__ float4 rb_smem[];
  const int LD = rb_ld(N), SLOT = rb_slot(N, DENSE);
  float* sV = reinterpret_cast<float*>(rb_smem);  // [N][LD]
  float* sv = sV + rb_up4(N * LD);                // [N]
  float* sW = sv + rb_up4(N);                     // [N][LD] Jx'V
  float* sJuV = sW + rb_up4(N * LD);              // [N]
  float* sQux = sJuV + rb_up4(N);                 // [N]
  float* sK = sQux + rb_up4(N);                   // [N]
  float* sRing = sK + rb_up4(N);                  // [RB_RING][SLOT]
  const int i = threadIdx.x % rb_rows(N);  // the row
  const int g = threadIdx.x / rb_rows(N);  // its group of columns
  const bool row = i < N;
  const bool lead = row && g == 0;  // the row's vector entries
  const long long b = blockIdx.x;
  const int obsdim = DENSE ? 0 : a.obsdim;

  // Step t's inputs into its slot ((H - 1 - t) % RB_RING).
  auto fetch = [&](int t) {
    float* s = sRing + ((H - 1 - t) % RB_RING) * SLOT;
    const long long bt = b * H + t;
    rb_copy(s, a.Jx + bt * N * N, N * N);
    rb_copy(s + rb_up4(N * N), a.Ju + bt * N, N);
    float* s2 = s + rb_up4(N * N) + rb_up4(N);
    float* s3 = s2 + rb_up4(N);
    if constexpr (DENSE) {
      rb_copy(s2, a.xs + bt * N, N);  // cx
      if (threadIdx.x == 0) {
        ampc_cp_async4(s3, a.us + bt);       // cu
        ampc_cp_async4(s3 + 1, a.Cuu + bt);  // Cuu
      }
      rb_copy(s3 + 4, a.Cxx + bt * N * N, N * N);
    } else {
      rb_copy(s2, a.xs + (b * (H + 1) + t) * N, N);  // x_t
      if (threadIdx.x == 0) ampc_cp_async4(s3, a.us + bt);  // u_t
    }
  };

  // The lane's cost (K6): 2 dt Q_ii and 2 R dt; the terminal V and v.
  float qd = 0.f, goal = 0.f, rd2 = 0.f;
  if constexpr (!DENSE) {
    rd2 = a.Rd[b] * a.two_dt;
    if (row && i < obsdim) {
      qd = a.Qd[b * obsdim + i] * a.two_dt;
      goal = a.goal[i];
    }
  }
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
    const int r = e / N, c = e % N;
    float val;
    if constexpr (DENSE)
      val = a.Vn[b * N * N + e];
    else
      val = (r == c && r < obsdim) ? a.Fd[b * obsdim + r] * 2.f : 0.f;
    sV[r * LD + c] = val;
  }
  if (lead) {
    if constexpr (DENSE) {
      sv[i] = a.vn[b * N + i];
    } else {
      sv[i] = i < obsdim
                  ? (a.Fd[b * obsdim + i] * 2.f) * (a.xs[(b * (H + 1) + H) * N + i] - goal)
                  : 0.f;
    }
  }
  fetch(H - 1);
  ampc_cp_async_commit();

  float lin = 0.f, quad = 0.f;
  for (int t = H - 1; t >= 0; --t) {
    ampc_cp_async_wait<0>();  // step t's copies have landed
    __syncthreads();          // every thread's copies, and the last step's V and v
    // The slot of step t + 1 is free: step t - 1 into it.
    if (t >= 1) fetch(t - 1);
    ampc_cp_async_commit();
    const float* s = sRing + ((H - 1 - t) % RB_RING) * SLOT;
    const float* Jx = s;                  // Jx[k][j] = Jx[k * N + j]
    const float* Ju = s + rb_up4(N * N);  // Ju[k]
    const float* X = Ju + rb_up4(N);      // x_t (K6) or cx (K4)
    const float* U = X + rb_up4(N);       // u_t, or cu and Cuu
    const float* Cxx = U + 4;             // K4

    // JuV[j] = sum_k Ju[k] V[k][j].
    if (lead) {
      float acc = Ju[0] * sV[i];
      for (int k = 1; k < N; ++k) acc = acc + Ju[k] * sV[k * LD + i];
      sJuV[i] = acc;
    }
    __syncthreads();

    // The scalars, formed by every thread from the same operands.
    float sq = sJuV[0] * Ju[0], sv0 = Ju[0] * sv[0];
    for (int k = 1; k < N; ++k) {
      sq = sq + sJuV[k] * Ju[k];
      sv0 = sv0 + Ju[k] * sv[k];
    }
    const float cuu = DENSE ? U[1] : rd2;
    const float cu = DENSE ? U[0] : rd2 * U[0];
    const float Quu = cuu + sq;
    const float qu = cu + sv0;
    const float inv = 1.f / Quu;
    const float kff = -(qu * inv);
    const float quu_k = Quu * kff;
    lin = lin + qu * kff;
    quad = quad + kff * quu_k;
    const float resid = qu + quu_k;

    float qx = 0.f;
    if (lead) {
      // Qux[i] = sum_k JuV[k] Jx[k][i], K[i]; qx[i] = cx[i] + sum_k Jx[k][i] v[k].
      float acc = sJuV[0] * Jx[i], accv = Jx[i] * sv[0];
      for (int k = 1; k < N; ++k) {
        const float jk = Jx[k * N + i];
        acc = acc + sJuV[k] * jk;
        accv = accv + jk * sv[k];
      }
      const float K_i = -(acc * inv);
      sQux[i] = acc;
      sK[i] = K_i;
      a.Ks[(b * H + t) * N + i] = K_i;
      const float cx = DENSE ? X[i] : (i < obsdim ? qd * (X[i] - goal) : 0.f);
      qx = cx + accv;
    }
    if (row) {
      // Row i of Jx'V: W[i][j] = sum_k Jx[k][i] V[k][j], RB_J columns at a
      // time, the group's runs.
      float* W = sW + i * LD;
      for (int j0 = g * RB_J; j0 < N; j0 += RB_G * RB_J) {
        float w[RB_J];
        const float j0v = Jx[i];
#pragma unroll
        for (int q = 0; q < RB_J; ++q) w[q] = j0 + q < N ? j0v * sV[j0 + q] : 0.f;
        for (int k = 1; k < N; ++k) {
          const float jk = Jx[k * N + i];
          const float* Vk = sV + k * LD + j0;
#pragma unroll
          for (int q = 0; q < RB_J; ++q)
            if (j0 + q < N) w[q] = w[q] + jk * Vk[q];
        }
#pragma unroll
        for (int q = 0; q < RB_J; ++q)
          if (j0 + q < N) W[j0 + q] = w[q];
      }
    }
    if (threadIdx.x == 0) a.ks[b * H + t] = kff;
    __syncthreads();  // Qux, K and Jx'V complete; V and v read by every thread

    if (row) {
      // Row i of the new V: (Jx'V) Jx + Cxx + Qux_i K_j + K_i Qux_j + K_i K_j Quu.
      const float* W = sW + i * LD;
      const float qux_i = sQux[i], K_i = sK[i];
      for (int j0 = g * RB_J; j0 < N; j0 += RB_G * RB_J) {
        float w[RB_J];
        const float w0 = W[0];
#pragma unroll
        for (int q = 0; q < RB_J; ++q) w[q] = j0 + q < N ? w0 * Jx[j0 + q] : 0.f;
        for (int k = 1; k < N; ++k) {
          const float wk = W[k];
          const float* Jk = Jx + k * N + j0;
#pragma unroll
          for (int q = 0; q < RB_J; ++q)
            if (j0 + q < N) w[q] = w[q] + wk * Jk[q];
        }
#pragma unroll
        for (int q = 0; q < RB_J; ++q) {
          const int j = j0 + q;
          if (j < N) {
            float c;
            if constexpr (DENSE)
              c = Cxx[i * N + j];
            else
              c = (i == j && i < obsdim) ? qd : 0.f;
            sV[i * LD + j] =
                w[q] + c + qux_i * sK[j] + K_i * sQux[j] + K_i * sK[j] * Quu;
          }
        }
      }
      if (lead) sv[i] = qx + qux_i * kff + K_i * resid;
    }
  }
  if (threadIdx.x == 0) {
    a.lin[b] = lin;
    a.quad[b] = quad;
  }
}

// One lane a block of RB_G threads a row, the rows N rounded up to a
// warp; B blocks.
template <bool DENSE>
static int rb_launch(const RbArgs& a, int N, int H, int B, cudaStream_t st) {
  const int threads = rb_threads(N);
  if (N < 1 || H < 1 || B < 1 || threads > RB_MAX_THREADS || (!DENSE && a.obsdim > 8) ||
      (!DENSE && (a.obsdim < 1 || a.obsdim > N)))
    return (int)cudaErrorInvalidValue;
  auto kernel = riccati_big_kernel<DENSE>;
  const int smem = rb_floats(N, DENSE) * (int)sizeof(float);
  static int allowed = 48 * 1024;  // dynamic shared memory opted into
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  kernel<<<(unsigned)B, threads, smem, st>>>(a, N, H);
  return (int)cudaGetLastError();
}
