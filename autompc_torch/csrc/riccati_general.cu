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
// What bounds it on an H100: not device memory. Per lane and step the
// kernel reads 2 ds^2 + ds dc + dc^2 + ds + dc floats and writes
// dc (ds + 1): 3.72 KB at (18, 6), 762 MB for B = 1024, H = 200 (0.23 ms
// at the memory rate), against ~22.5 kFMA. A lane's value matrix
// (ds x ds + ds floats) does not fit one thread's registers, so a lane is
// spread over TPL threads and V and every intermediate live in shared
// memory. Spread one output element a thread over a 128-thread block, as
// before, each FMA read both of its operands from shared memory (~45k
// loads a lane-step at (18, 6)), five block barriers split a step, and
// 109 of the 128 threads waited while 19 ran the dc x dc Cholesky.
// The design here:
// - register tiles: each thread owns an R x C tile of each product
//   ([Jx|Ju]'[V|v]; Qxx and Qux; Quu; the next V) and loads each operand
//   once per tile row or column in the contraction loop (vector loads
//   where a tile row is aligned), under one load per FMA, with R x C
//   independent chains a thread;
// - a lane is two warps at (18, 6) (TPL = 64, with a named barrier of
//   its own) and 8 threads at (4, 1) (four lanes a warp,
//   __syncwarp), so a step's phases are separated by the lane's own
//   barrier, not block barriers;
// - with two or more warps, the last one forms Quu and factors it while
//   the others form Qxx and Qux: the serial chain of the Cholesky factor
//   (square roots and reciprocals) runs beside the step's largest
//   product instead of after it. That warp's first thread also solves
//   for k and forms Quu k, the residual and the expected reductions;
//   each substitution thread for a column of K then forms its row of
//   K'Quu from the gains it holds in registers, which removes a phase;
// - the inputs stream through a ring of RING steps in shared memory by
//   cp.async, RING - 1 steps ahead of the step that reads them (a
//   lane-step is one contiguous run of each batch-major array).
// Every output keeps the sum order of the one-element-a-thread form: a
// left fold over the contraction index from the same first term, the
// same grouping of the final additions and the same products taken into
// FMAs, each written as its own expression (v apart from V), so the
// outputs are the same bits; only which thread computes an element, and
// when, has changed. (At dc = 1 that form's compiler rounded the first
// product of Quu's sum on its own; the tile here does the same there.)
// Lanes a block and threads a lane come from the wrapper's
// general_geometry (ops/cuda_riccati_general.py).
#include <cuda_runtime.h>

#include "cp_async.cuh"

__host__ __device__ constexpr int rg_up4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int rg_cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int rg_pow2(int n) { return n <= 1 ? 1 : 2 * rg_pow2((n + 1) / 2); }
__host__ __device__ constexpr int rg_gcd(int a, int b) { return b ? rg_gcd(b, a % b) : a; }
// The largest divisor of n that is at most m.
__host__ __device__ constexpr int rg_divisor(int n, int m) {
  return m >= n ? n : n % m == 0 ? m : rg_divisor(n, m - 1);
}
// Floats of one ring slot: a step's J = [Jx | Ju], Cxx, Cuu, cx, cu.
__host__ __device__ constexpr int rg_slot(int ds, int dc) {
  return rg_up4(ds * (ds + dc)) + rg_up4(ds * ds) + rg_up4(dc * dc) + rg_up4(ds) + rg_up4(dc);
}
__host__ __device__ constexpr int rg_clamp(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}
// Threads a lane at a shape with no hand-set tiling: ds (ds + dc) / 8
// (a thread for about eight entries of J'V) rounded up to a power of
// two, from 8 to 64, and at least ds + dc (a thread for each element of
// cx and cu in the ring's copy) rounded up to a power of two.
__host__ __device__ constexpr int rg_tpl(int ds, int dc) {
  return rg_clamp(rg_pow2(rg_cdiv(ds * (ds + dc), 8)), 8, 64) > rg_pow2(ds + dc)
             ? rg_clamp(rg_pow2(rg_cdiv(ds * (ds + dc), 8)), 8, 64)
             : rg_pow2(ds + dc);
}

// Register tiles (rows x columns) of the products ([Jx|Ju]'[V|v]; Qxx
// and Qux; Quu; the next V), input ring depth and the most lanes a block
// takes, per instance (ds, dc, threads a lane). The rule for any shape:
// tiles as wide as a divisor of the product's dimension allows (rows of
// J'V and of the next V up to 2, Qxx/Qux columns up to 4, Quu up to 2 x
// 2, and 4 columns where a ragged last tile is masked); a ring of
// 3072 / slot steps, from 2 to 6 (the (18, 6) tiling's 3 and the (4, 1)
// tiling's 6); 256 threads a block up to a warp a lane, 4 lanes (the
// named barriers of rg_sync) from two warps on. The hand-set tilings
// of the main library's two shapes follow; a library built at first use
// at another (ds, dc) (-DAMPC_DS, -DAMPC_DC; ops/_build.py:
// shape_library) has only the rule, so at (18, 6) or (4, 1) it gives the
// rule's instance.
template <int DS, int DC, int TPL>
struct RgShape {
  static constexpr int P1R = rg_divisor(DS + DC, 2), P1C = 4, P2R = rg_divisor(rg_gcd(DS, DC), 2),
                       P2C = rg_divisor(DS, 4), PUR = rg_divisor(DC, 2), PUC = rg_divisor(DC, 2),
                       P5R = rg_divisor(DS, 2), P5C = 4;
  static constexpr int RING = rg_clamp(3072 / rg_slot(DS, DC), 2, 6);
  static constexpr int MAX_LANES = TPL <= 32 ? 256 / TPL : 4;
};
#ifndef AMPC_DS
template <>
struct RgShape<18, 6, 64> {
  static constexpr int P1R = 4, P1C = 2, P2R = 3, P2C = 6, PUR = 2, PUC = 2, P5R = 2, P5C = 3;
  static constexpr int RING = 3, MAX_LANES = 4;
};
template <>
struct RgShape<4, 1, 8> {
  static constexpr int P1R = 1, P1C = 5, P2R = 1, P2C = 4, PUR = 1, PUC = 1, P5R = 1, P5C = 4;
  static constexpr int RING = 6, MAX_LANES = 32;
};
#endif


// Shared-memory layout of one lane (floats; every region starts on a
// 16-byte boundary).
template <int DS, int DC, int TPL>
struct RgLayout {
  using S = RgShape<DS, DC, TPL>;
  static constexpr int NJ = DS + DC, NV = DS + 1;
  // Row strides: J = [Jx | Ju] (ds rows), [V | v] (ds rows), Q = [Qxx |
  // qx] over [Qux | resid] (NJ rows), K = [K | k] (dc rows); wide enough
  // for whole tiles of the products that read them, and 16-byte rows.
  static constexpr int SJ = NJ;
  static constexpr int SV = rg_up4(rg_cdiv(NV, S::P1C) * S::P1C);
  static constexpr int SQ = rg_up4(rg_cdiv(DS, S::P5C) * S::P5C > NV
                                       ? rg_cdiv(DS, S::P5C) * S::P5C
                                       : NV);
  static constexpr int SK = SQ;
  static constexpr int J = 0, CXX = J + rg_up4(DS * SJ), CUU = CXX + rg_up4(DS * DS),
                       CX = CUU + rg_up4(DC * DC), CU = CX + rg_up4(DS),
                       SLOT = CU + rg_up4(DC);
  static constexpr int VV = S::RING * SLOT, JVT = VV + rg_up4(DS * SV),
                       Q = JVT + rg_up4(DS * NJ), QUU = Q + rg_up4(NJ * SQ),
                       QU = QUU + rg_up4(DC * DC), K = QU + rg_up4(DC),
                       KQUUT = K + rg_up4(DC * SK), L = KQUUT + rg_up4(DC * DS),
                       INV = L + rg_up4(DC * DC), LANE = INV + rg_up4(DC);
};

// N floats from shared memory at p into out: float4 (float2) loads where
// ALIGN says p is 16- (8-) byte aligned and N a multiple of 4 (2).
template <int N, int ALIGN>
__device__ __forceinline__ void rg_row(const float* p, float (&out)[N]) {
  if constexpr (ALIGN >= 16 && N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 w = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = w.x;
      out[4 * q + 1] = w.y;
      out[4 * q + 2] = w.z;
      out[4 * q + 3] = w.w;
    }
  } else if constexpr (ALIGN >= 8 && N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 w = reinterpret_cast<const float2*>(p)[q];
      out[2 * q] = w.x;
      out[2 * q + 1] = w.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) out[q] = p[q];
  }
}

// The alignment (bytes) of p + stride * k + w * g for any k and g, p
// 16-byte aligned: what a tile of width w at stride allows.
__host__ __device__ constexpr int rg_align(int stride, int w) {
  return (stride % 4 == 0 && w % 4 == 0) ? 16 : (stride % 2 == 0 && w % 2 == 0) ? 8 : 4;
}

// An R x C tile of A'B over a contraction of length KD: A's rows k are
// at a + k lda (R consecutive floats), B's at b + k ldb (C floats). Each
// element is a left fold over k from the product of index 0; with
// ROUND_FIRST that first product is rounded on its own (an FMA takes the
// second), else it is the one the FMA of index 1 takes.
template <int R, int C, int KD, int ALIGN_A, int ALIGN_B, bool ROUND_FIRST>
__device__ __forceinline__ void rg_tile(const float* a, int lda, const float* b, int ldb,
                                        float (&s)[R][C]) {
  float x[R], y[C];
  rg_row<R, ALIGN_A>(a, x);
  rg_row<C, ALIGN_B>(b, y);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < C; ++q) {
      s[r][q] = x[r] * y[q];
      if constexpr (ROUND_FIRST) asm volatile("" : "+f"(s[r][q]));
    }
#pragma unroll
  for (int k = 1; k < KD; ++k) {
    rg_row<R, ALIGN_A>(a + k * lda, x);
    rg_row<C, ALIGN_B>(b + k * ldb, y);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < C; ++q) s[r][q] = s[r][q] + x[r] * y[q];
  }
}

// Cholesky Quu = L L' (row-major DC x DC in shared memory), no pivoting,
// no regularization: a pivot that is not positive gives NaN.
template <int DC>
__device__ __forceinline__ void rg_cholesky(const float* Quu, float (&L)[DC][DC],
                                            float (&inv)[DC]) {
#pragma unroll
  for (int a = 0; a < DC; ++a) {
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < a; ++m) acc = acc + L[a][m] * L[a][m];
    L[a][a] = sqrtf(Quu[a * DC + a] - acc);
    inv[a] = 1.f / L[a][a];
#pragma unroll
    for (int r = a + 1; r < DC; ++r) {
      float acc2 = 0.f;
#pragma unroll
      for (int m = 0; m < a; ++m) acc2 = acc2 + L[r][m] * L[a][m];
      L[r][a] = (Quu[r * DC + a] - acc2) * inv[a];
    }
  }
}

// kv = -Quu^-1 rhs by forward and back substitution; rhs[a] at
// rhs[a * stride].
template <int DC>
__device__ __forceinline__ void rg_solve(const float (&L)[DC][DC], const float (&inv)[DC],
                                         const float* rhs, int stride, float (&kv)[DC]) {
  float y[DC], x[DC];
#pragma unroll
  for (int a = 0; a < DC; ++a) {
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < a; ++m) acc = acc + L[a][m] * y[m];
    y[a] = (rhs[a * stride] - acc) * inv[a];
  }
#pragma unroll
  for (int a = DC - 1; a >= 0; --a) {
    float acc = 0.f;
#pragma unroll
    for (int r = a + 1; r < DC; ++r) acc = acc + L[r][a] * x[r];
    x[a] = (y[a] - acc) * inv[a];
  }
#pragma unroll
  for (int a = 0; a < DC; ++a) kv[a] = -x[a];
}

// From the feedforward gain k (kv): column ds of [K | k], k to device
// memory (ks_out, unless null), Quu k, the residual qu + Quu k (column
// ds of Q's Qux rows), and qu.k and k'Quu k added to the expected
// reductions.
template <int DS, int DC, int SQ, int SK>
__device__ __forceinline__ void rg_feedforward(float (&kv)[DC], const float* sQuu,
                                               const float* squ, float* sQ, float* sK,
                                               float* ks_out, float& lin, float& quad) {
  // lin, quad: the lane's running sums, which this step's terms join.
  float Qk[DC];
#pragma unroll
  for (int a = 0; a < DC; ++a) {
    asm volatile("" : "+f"(kv[a]));  // the gain as stored, as the sums below read it
    sK[a * SK + DS] = kv[a];
    if (ks_out) ks_out[a] = kv[a];
  }
#pragma unroll
  for (int a = 0; a < DC; ++a) {
    float s = sQuu[a * DC] * kv[0];
#pragma unroll
    for (int b2 = 1; b2 < DC; ++b2) s = s + sQuu[a * DC + b2] * kv[b2];
    Qk[a] = s;
    sQ[(DS + a) * SQ + DS] = squ[a] + s;  // the residual
  }
  float s1 = squ[0] * kv[0], s2 = kv[0] * Qk[0];
#pragma unroll
  for (int a = 1; a < DC; ++a) {
    s1 = s1 + squ[a] * kv[a];
    s2 = s2 + kv[a] * Qk[a];
  }
  lin = lin + s1;
  quad = quad + s2;
}

// The lane's threads meet: a warp (or part of one) by __syncwarp, two or
// more warps by a named barrier of their own, id 1 + the lane's place in
// the block. The ids are spelled out as constants: a barrier id in a
// register makes the compiler reserve all 16 barriers for every block,
// which caps the blocks an SM holds.
template <int TPL>
__device__ __forceinline__ void rg_sync(int lane_in_block) {
  if constexpr (TPL <= 32) {
    __syncwarp();
  } else {
    switch (lane_in_block) {
      case 0: asm volatile("bar.sync 1, %0;\n" ::"n"(TPL) : "memory"); break;
      case 1: asm volatile("bar.sync 2, %0;\n" ::"n"(TPL) : "memory"); break;
      case 2: asm volatile("bar.sync 3, %0;\n" ::"n"(TPL) : "memory"); break;
      default: asm volatile("bar.sync 4, %0;\n" ::"n"(TPL) : "memory"); break;
    }
  }
}

template <int DS, int DC, int TPL>
__global__ void __launch_bounds__(TPL * RgShape<DS, DC, TPL>::MAX_LANES)
    riccati_general_kernel(
        const float* __restrict__ Jx, const float* __restrict__ Ju,
        const float* __restrict__ Cxx, const float* __restrict__ Cuu,
        const float* __restrict__ cx, const float* __restrict__ cu,
        const float* __restrict__ Vn, const float* __restrict__ vn,
        float* __restrict__ Ks, float* __restrict__ ks,
        float* __restrict__ lin_out, float* __restrict__ quad_out, int H,
        int B) {
  using S = RgShape<DS, DC, TPL>;
  using Y = RgLayout<DS, DC, TPL>;
  constexpr int DD = DS * DS, DU = DS * DC, UU = DC * DC, NJ = Y::NJ, NV = Y::NV;
  constexpr int SJ = Y::SJ, SV = Y::SV, SQ = Y::SQ, SK = Y::SK;
  static_assert(NJ % S::P1R == 0 && DS % S::P2R == 0 && DC % S::P2R == 0 &&
                    DS % S::P2C == 0 && DC % S::PUR == 0 && DC % S::PUC == 0 &&
                    DS % S::P5R == 0,
                "tiles must cover the products exactly, Q's tiles on one side of row ds");
  constexpr int G1 = rg_cdiv(NV, S::P1C), G5 = rg_cdiv(DS, S::P5C);
  constexpr int N1 = (NJ / S::P1R) * G1;
  constexpr int NQ = (NJ / S::P2R) * (DS / S::P2C);  // Qxx, Qux tiles
  constexpr int NU = (DC / S::PUR) * (DC / S::PUC);  // Quu tiles
  constexpr int N5 = (DS / S::P5R) * G5;
  // Two or more warps a lane and dc > 1: the last warp forms Quu and
  // factors it while the others form Qxx and Qux (at dc = 1 the scalar
  // Quu has no factor to overlap).
  constexpr bool SPLIT = TPL >= 64 && DC > 1;
  static_assert(TPL <= 32 || S::MAX_LANES <= 4, "rg_sync names four lane barriers");
  constexpr int QT = SPLIT ? TPL - 32 : TPL;  // threads on Q's tiles
  extern __shared__ float4 rg_smem[];
  const int lt = threadIdx.x % TPL;  // thread within the lane
  const int lb = threadIdx.x / TPL;  // lane within the block
  const int lanes = blockDim.x / TPL;
  const long long lane = (long long)blockIdx.x * lanes + lb;
  const bool valid = lane < B;
  // Threads past the batch run the recursion on the last lane's inputs
  // and store nothing, so every thread of a lane reaches each barrier.
  const long long ln = valid ? lane : B - 1;
  float* sm = reinterpret_cast<float*>(rg_smem) + lb * Y::LANE;
  float* sVv = sm + Y::VV;
  float* sJVt = sm + Y::JVT;  // [j][c] = ([Jx | Ju]'V)[c][j], j < ds
  float* sQ = sm + Y::Q;
  float* sQuu = sm + Y::QUU;
  float* squ = sm + Y::QU;
  float* sK = sm + Y::K;
  float* sKQuuT = sm + Y::KQUUT;  // [a][i] = (K'Quu)[i][a]
  float* sL = sm + Y::L;  // Cholesky factor of Quu, [a][m]
  float* sInv = sm + Y::INV;  // 1 / L[a][a]

  // Step t's inputs into its ring slot (t counts down from H-1). Thread lt
  // copies elements e = lt + m TPL of each array; element e of Jx (Ju)
  // goes to row e / ds (e / dc) of J, an offset fixed for the whole run,
  // so it is worked out once here.
  constexpr int MX = rg_cdiv(DD, TPL), MU = rg_cdiv(DU, TPL);
  int dJx[MX], dJu[MU];
#pragma unroll
  for (int m = 0; m < MX; ++m) {
    const int e = lt + m * TPL;
    dJx[m] = (e / DS) * SJ + e % DS;
  }
#pragma unroll
  for (int m = 0; m < MU; ++m) {
    const int e = lt + m * TPL;
    dJu[m] = (e / DC) * SJ + DS + e % DC;
  }
  auto fetch_step = [&](int t) {
    float* slot = sm + ((H - 1 - t) % S::RING) * Y::SLOT;
    const long long st = ln * H + t;
    const float* gJx = Jx + st * DD + lt;
    const float* gCxx = Cxx + st * DD + lt;
    const float* gJu = Ju + st * DU + lt;
#pragma unroll
    for (int m = 0; m < MX; ++m) {
      if (DD % TPL == 0 || lt + m * TPL < DD) {
        ampc_cp_async4(slot + Y::J + dJx[m], gJx + m * TPL);
        ampc_cp_async4(slot + Y::CXX + lt + m * TPL, gCxx + m * TPL);
      }
    }
#pragma unroll
    for (int m = 0; m < MU; ++m)
      if (DU % TPL == 0 || lt + m * TPL < DU)
        ampc_cp_async4(slot + Y::J + dJu[m], gJu + m * TPL);
#pragma unroll
    for (int m = 0; m < rg_cdiv(UU, TPL); ++m)
      if (lt + m * TPL < UU)
        ampc_cp_async4(slot + Y::CUU + lt + m * TPL, Cuu + st * UU + lt + m * TPL);
    if (lt >= TPL - DS) {
      const int e = lt - (TPL - DS);
      ampc_cp_async4(slot + Y::CX + e, cx + st * DS + e);
    }
    if (lt >= TPL - DS - DC && lt < TPL - DS) {
      const int e = lt - (TPL - DS - DC);
      ampc_cp_async4(slot + Y::CU + e, cu + st * DC + e);
    }
  };
  static_assert(DS + DC <= TPL, "one element of cx or cu a thread");

  // Terminal expansion, and the first steps' inputs in flight.
  for (int e = lt; e < DD; e += TPL) sVv[(e / DS) * SV + e % DS] = Vn[ln * DD + e];
  for (int e = lt; e < DS; e += TPL) sVv[e * SV + DS] = vn[ln * DS + e];
  for (int r = 0; r < S::RING - 1; ++r) {
    if (H - 1 - r >= 0) fetch_step(H - 1 - r);
    ampc_cp_async_commit();
  }

  // The expected reductions, kept by thread ds (by the last warp's first
  // thread with the split).
  float lin = 0.f, quad = 0.f;
  for (int t = H - 1; t >= 0; --t) {
    if (t - (S::RING - 1) >= 0) fetch_step(t - (S::RING - 1));
    ampc_cp_async_commit();
    ampc_cp_async_wait<S::RING - 1>();
    rg_sync<TPL>(lb);
    const float* slot = sm + ((H - 1 - t) % S::RING) * Y::SLOT;
    const float* sJ = slot + Y::J;  // [k][c] = [Jx | Ju][k][c]

    // P1: JV[c][j] = sum_k J[k][c] Vv[k][j]; the v column gives qx
    // (into column ds of Q's first ds rows) and qu.
    for (int tile = lt; tile < N1; tile += TPL) {
      const int c0 = (tile / G1) * S::P1R, j0 = (tile % G1) * S::P1C;
      float s[S::P1R][S::P1C];
      rg_tile<S::P1R, S::P1C, DS, rg_align(SJ, S::P1R), rg_align(SV, S::P1C), false>(
          sJ + c0, SJ, sVv + j0, SV, s);
      if (j0 + S::P1C <= DS) {
#pragma unroll
        for (int r = 0; r < S::P1R; ++r)
#pragma unroll
          for (int q = 0; q < S::P1C; ++q) sJVt[(j0 + q) * NJ + c0 + r] = s[r][q];
      } else {
#pragma unroll
        for (int r = 0; r < S::P1R; ++r)
#pragma unroll
          for (int q = 0; q < S::P1C; ++q) {
            const int c = c0 + r, j = j0 + q;
            if (j < DS)
              sJVt[j * NJ + c] = s[r][q];
            else if (j == DS && c < DS)
              sQ[c * SQ + DS] = slot[Y::CX + c] + s[r][q];
            else if (j == DS)
              squ[c - DS] = slot[Y::CU + c - DS] + s[r][q];
          }
      }
    }
    rg_sync<TPL>(lb);

    // P2: Qxx and Qux (columns 0..ds-1 of Q's rows) in tiles, Quu in
    // tiles of its own; with two or more warps a lane, Quu on the last
    // warp, which then factors it (P3 below needs only Quu and qu) while
    // the other warps finish Qxx and Qux.
    if (lt < QT) {
      for (int tile = lt; tile < NQ; tile += QT) {
        const int c0 = (tile / (DS / S::P2C)) * S::P2R;
        const int j0 = (tile % (DS / S::P2C)) * S::P2C;
        float s[S::P2R][S::P2C];
        rg_tile<S::P2R, S::P2C, DS, rg_align(NJ, S::P2R), rg_align(SJ, S::P2C), false>(
            sJVt + c0, NJ, sJ + j0, SJ, s);
        if (c0 < DS) {  // Qxx = Cxx + J'VJ
#pragma unroll
          for (int r = 0; r < S::P2R; ++r)
#pragma unroll
            for (int q = 0; q < S::P2C; ++q)
              sQ[(c0 + r) * SQ + j0 + q] = slot[Y::CXX + (c0 + r) * DS + j0 + q] + s[r][q];
        } else {  // Qux
#pragma unroll
          for (int r = 0; r < S::P2R; ++r)
#pragma unroll
            for (int q = 0; q < S::P2C; ++q) sQ[(c0 + r) * SQ + j0 + q] = s[r][q];
        }
      }
    }
    if (!SPLIT || lt >= QT) {
      // Without the split, Quu's tiles go to the last threads, which have
      // no Q tile when NQ + NU <= TPL.
      for (int tile = SPLIT ? lt - QT : TPL - 1 - lt; tile < NU; tile += SPLIT ? 32 : TPL) {
        const int a0 = (tile / (DC / S::PUC)) * S::PUR;
        const int b0 = (tile % (DC / S::PUC)) * S::PUC;
        float s[S::PUR][S::PUC];
        // At dc = 1 the sum rounds its first product before the next is
        // added (an FMA takes the second), as the one-element-a-thread
        // kernel compiled it; elsewhere the first product is the one an
        // FMA takes, as in every other sum here.
        rg_tile<S::PUR, S::PUC, DS, rg_align(NJ, S::PUR), rg_align(SJ, S::PUC), DC == 1>(
            sJVt + DS + a0, NJ, sJ + DS + b0, SJ, s);
#pragma unroll
        for (int r = 0; r < S::PUR; ++r)
#pragma unroll
          for (int q = 0; q < S::PUC; ++q)
            sQuu[(a0 + r) * DC + b0 + q] = slot[Y::CUU + (a0 + r) * DC + b0 + q] + s[r][q];
      }
      if constexpr (SPLIT) {
        __syncwarp();
        // Every thread of the warp factors Quu (the same values); the
        // first also solves for k, forms Quu k, the residual and the
        // expected reductions, and leaves L and 1 / L[a][a] for the
        // substitutions of P3.
        float L[DC][DC], inv[DC];
        rg_cholesky<DC>(sQuu, L, inv);
        float kv[DC];
        rg_solve<DC>(L, inv, squ, 1, kv);
        if (lt == QT) {
#pragma unroll
          for (int a = 0; a < DC; ++a) {
#pragma unroll
            for (int m = 0; m <= a; ++m) sL[a * DC + m] = L[a][m];
            sInv[a] = inv[a];
          }
          rg_feedforward<DS, DC, SQ, SK>(kv, sQuu, squ, sQ, sK, valid ? ks + (lane * H + t) * DC : nullptr,
                                         lin, quad);
        }
      }
    }
    rg_sync<TPL>(lb);

    // P3 + P4: per right-hand side (ds columns of Qux, then qu) one
    // thread: forward and back substitution through the Cholesky factor
    // of Quu, the gains to shared and device memory; with them, thread
    // i < ds forms row i of K'Quu, thread ds (without the split above)
    // Quu k, the residual qu + Quu k and the expected reductions.
    const long long st = lane * H + t;
    if (lt < DS || (!SPLIT && lt == DS)) {
      float kv[DC];  // column lt of [K | k]
      if constexpr (DC == 1) {
        // The dc = 1 TPU kernel divides by the scalar Quu: a negative Quu
        // gives finite (useless) gains there, not the NaN of a square root.
        float inv = 1.f / sQuu[0];
        // A reciprocal, then a product: kept apart, as the one-element-a-
        // thread form computes them (the compiler would otherwise fold
        // the negation below into a division).
        asm volatile("" : "+f"(inv));
        kv[0] = lt < DS ? -(sQ[DS * SQ + lt] * inv) : -(squ[0] * inv);
      } else {
        float L[DC][DC], inv[DC];
        if constexpr (SPLIT) {
#pragma unroll
          for (int a = 0; a < DC; ++a) {
#pragma unroll
            for (int m = 0; m <= a; ++m) L[a][m] = sL[a * DC + m];
            inv[a] = sInv[a];
          }
        } else {
          rg_cholesky<DC>(sQuu, L, inv);
        }
        rg_solve<DC>(L, inv, lt < DS ? sQ + DS * SQ + lt : squ, lt < DS ? SQ : 1, kv);
      }
      if (lt < DS) {
#pragma unroll
        for (int a = 0; a < DC; ++a) {
          asm volatile("" : "+f"(kv[a]));  // the gain as stored, as the sums below read it
          sK[a * SK + lt] = kv[a];
          if (valid) Ks[st * DU + a * DS + lt] = kv[a];
        }
#pragma unroll
        for (int b2 = 0; b2 < DC; ++b2) {
          float s = kv[0] * sQuu[b2];
#pragma unroll
          for (int a = 1; a < DC; ++a) s = s + kv[a] * sQuu[a * DC + b2];
          sKQuuT[b2 * DS + lt] = s;
        }
      } else {
        rg_feedforward<DS, DC, SQ, SK>(kv, sQuu, squ, sQ, sK, valid ? ks + st * DC : nullptr,
                                       lin, quad);
      }
    }
    rg_sync<TPL>(lb);

    // P5: next V = Qxx + Qux'K + K'Qux + (K'Quu)K in tiles; next v =
    // qx + Qux'k + K'resid, one element a thread.
    for (int tile = lt; tile < N5; tile += TPL) {
      const int i0 = (tile / G5) * S::P5R, j0 = (tile % G5) * S::P5C;
      float s1[S::P5R][S::P5C], s2[S::P5R][S::P5C], s3[S::P5R][S::P5C];
#pragma unroll
      for (int a = 0; a < DC; ++a) {
        float qi[S::P5R], ki[S::P5R], mi[S::P5R], kj[S::P5C], qj[S::P5C];
        rg_row<S::P5R, 4>(sQ + (DS + a) * SQ + i0, qi);
        rg_row<S::P5R, 4>(sK + a * SK + i0, ki);
        rg_row<S::P5R, 4>(sKQuuT + a * DS + i0, mi);
        rg_row<S::P5C, rg_align(SK, S::P5C)>(sK + a * SK + j0, kj);
        rg_row<S::P5C, rg_align(SQ, S::P5C)>(sQ + (DS + a) * SQ + j0, qj);
#pragma unroll
        for (int r = 0; r < S::P5R; ++r)
#pragma unroll
          for (int q = 0; q < S::P5C; ++q) {
            if (a == 0) {
              s1[r][q] = qi[r] * kj[q];
              s2[r][q] = ki[r] * qj[q];
              s3[r][q] = mi[r] * kj[q];
            } else {
              s1[r][q] = s1[r][q] + qi[r] * kj[q];
              s2[r][q] = s2[r][q] + ki[r] * qj[q];
              s3[r][q] = s3[r][q] + mi[r] * kj[q];
            }
          }
      }
#pragma unroll
      for (int r = 0; r < S::P5R; ++r)
#pragma unroll
        for (int q = 0; q < S::P5C; ++q) {
          const int i = i0 + r, j = j0 + q;
          if (DS % S::P5C == 0 || j0 + S::P5C <= DS || j < DS)
            sVv[i * SV + j] = sQ[i * SQ + j] + s1[r][q] + s2[r][q] + s3[r][q];
        }
    }
    if (lt < DS) {
      const int i = lt;
      float s1 = sQ[DS * SQ + i] * sK[DS], s2 = sK[i] * sQ[DS * SQ + DS];
#pragma unroll
      for (int a = 1; a < DC; ++a) {
        s1 = s1 + sQ[(DS + a) * SQ + i] * sK[a * SK + DS];
        s2 = s2 + sK[a * SK + i] * sQ[(DS + a) * SQ + DS];
      }
      sVv[i * SV + DS] = sQ[i * SQ + DS] + s1 + s2;
    }
    rg_sync<TPL>(lb);
  }
  if (lt == (SPLIT ? QT : DS) && valid) {
    lin_out[lane] = lin;
    quad_out[lane] = quad;
  }
}

template <int DS, int DC, int TPL>
static int rg_launch(const float* Jx, const float* Ju, const float* Cxx,
                     const float* Cuu, const float* cx, const float* cu,
                     const float* Vn, const float* vn, float* Ks, float* ks,
                     float* lin, float* quad, int H, int B, int lanes,
                     cudaStream_t st) {
  static_assert(RgShape<DS, DC, TPL>::MAX_LANES * RgLayout<DS, DC, TPL>::LANE * 4 <= 232448,
                "the largest block's shared memory");
  if (lanes < 1 || lanes > RgShape<DS, DC, TPL>::MAX_LANES || (lanes * TPL) % 32 != 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = riccati_general_kernel<DS, DC, TPL>;
  const int smem = lanes * RgLayout<DS, DC, TPL>::LANE * (int)sizeof(float);
  static int allowed = 48 * 1024;  // dynamic shared memory opted into
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  kernel<<<(unsigned)((B + lanes - 1) / lanes), lanes * TPL, smem, st>>>(
      Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn, Ks, ks, lin, quad, H, B);
  return (int)cudaGetLastError();
}

// lanes: lanes a block; threads_per_lane: the instance's (64 at
// (18, 6), 8 at (4, 1) in the main library; rg_tpl(ds, dc) in a library
// built at first use); general_geometry picks both.
extern "C" int ampc_riccati_general(
    const float* Jx, const float* Ju, const float* Cxx, const float* Cuu,
    const float* cx, const float* cu, const float* Vn, const float* vn,
    float* Ks, float* ks, float* lin, float* quad, int ds, int dc, int H,
    int B, int lanes, int threads_per_lane, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#ifdef AMPC_DS
  constexpr int TPL = rg_tpl(AMPC_DS, AMPC_DC);
  if (ds == AMPC_DS && dc == AMPC_DC && threads_per_lane == TPL)
    return rg_launch<AMPC_DS, AMPC_DC, TPL>(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn, Ks, ks, lin,
                                            quad, H, B, lanes, st);
#else
  if (ds == 18 && dc == 6 && threads_per_lane == 64)
    return rg_launch<18, 6, 64>(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn, Ks, ks, lin,
                                quad, H, B, lanes, st);
  if (ds == 4 && dc == 1 && threads_per_lane == 8)
    return rg_launch<4, 1, 8>(Jx, Ju, Cxx, Cuu, cx, cu, Vn, vn, Ks, ks, lin,
                              quad, H, B, lanes, st);
#endif
  return (int)cudaErrorInvalidValue;
}

#ifndef AMPC_DS
// K4 at dc = 1 and a state wider than the per-shape instances take
// (ds + 1 > 24; the GaussReg joint-Koopman fan-out's lifts):
// riccati_big.cuh's kernel on the dense expansions, ds a run-time
// argument, one lane a block (the main library only). Cuu and cu are
// (B, H) at dc = 1.
#include "riccati_big.cuh"

extern "C" int ampc_riccati_general_big(
    const float* Jx, const float* Ju, const float* Cxx, const float* Cuu,
    const float* cx, const float* cu, const float* Vn, const float* vn,
    float* Ks, float* ks, float* lin, float* quad, int ds, int H, int B, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  RbArgs a = {};
  a.Jx = Jx, a.Ju = Ju, a.Cxx = Cxx, a.Cuu = Cuu, a.xs = cx, a.us = cu, a.Vn = Vn,
  a.vn = vn, a.Ks = Ks, a.ks = ks, a.lin = lin, a.quad = quad;
  return rb_launch<true>(a, ds, H, B, (cudaStream_t)stream);
}
#endif
