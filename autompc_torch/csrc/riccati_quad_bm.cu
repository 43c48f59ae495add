// K6: batch-major Riccati backward pass for a per-lane diagonal quadratic
// cost, dc=1.
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_riccati.py:
// _backward_quad_kernel (entry pallas_tvlqr_backward_quad): the recursion
// of _bq_step, on the arrays the batch-major iLQR body carries:
//   Jx (B, H, ds, ds), Ju (B, H, ds, 1), xs (B, H+1, ds), us (B, H, 1),
//   Qd/Fd (B, obsdim), Rd (B, 1), goal shared
//   -> Ks (B, H, 1, ds), ks (B, H, 1), lin (B,), quad (B,).
// The stage and terminal expansions are built inline from the trajectory
// and the lane's cost diagonals (cx = 2 Q dt (x-g), cu = 2 R dt u,
// Cxx = diag(2 Q dt), Cuu = 2 R dt, Vn = diag(2 F), vn = 2 F (x_H - g));
// then for t = H-1 .. 0
//   Quu = Cuu + Ju'V Ju, Qux = Ju'V Jx, qu = cu + Ju'v,
//   K = -Qux/Quu, k = -qu/Quu, lin += qu k, quad += k Quu k,
//   V <- Cxx + Jx'V Jx + Qux'K + K'Qux + K'Quu K,
//   v <- cx + Jx'v + Qux' k + K'(qu + Quu k).
// There is no carry select: the solver body masks the gains afterwards.
// The TPU wrapper transposes all five streams to lanes-last and the two
// gain arrays back, because a TPU tile wants the batch in its lane
// dimension; none of that is carried over: the carry is read in place.
//
// What bounds it on an H100: not bytes (ds*ds + 3 ds + 2 floats in and
// ds + 1 out a lane-step) but the chain of H dependent steps of each lane,
// and at the cost fan-out's shapes (B = 1,024 ... 128 lanes, H = 10) a
// grid of a few warps on 132 SMs. Before this design one thread owned a
// lane and loaded each step's rows at the step, neighbouring threads H
// rows apart: every step waited a trip to memory (~0.94 us a step at
// B=4096, H=200, where the 82 MB of inputs miss L2). The design:
// - a group of G = ds = 4 threads a lane (8 lanes a warp), thread g owning
//   row g of the value matrix: its row of Jx'V, of Qxx and of the new V, and
//   entry g of qx and of the new v. The group meets once a step: each
//   thread writes its row of V and its entry of v to shared memory (two
//   buffers, by the parity of t), and after __syncwarp every thread holds
//   all of V and v. Each thread then forms the values a row needs from
//   the others (Ju'V, Quu, 1/Quu, Qux, K, qu, k, lin, quad) itself, from
//   the same operands in the same order, so the group needs no second or
//   third exchange a step; thread 0 of the group stores lin and quad.
//   One thread a lane with the same ring was slower at every shape timed
//   (PERF.md §6);
// - a lane's inputs (the rows of Jx, Ju, x_t and u_t) stream through a
//   ring of AMPC_BQBM_RING time steps in shared memory by cp.async,
//   AMPC_BQBM_RING - 1 steps ahead of the step that reads them, each
//   thread of a group copying part of its lane's step (16-byte copies).
//   Where H <= AMPC_BQBM_RING (the fan-out's H = 10) the whole horizon is
//   in flight from the start, so only the first step waits on memory;
// - the gains are staged in shared memory and written every
//   AMPC_BQBM_RING steps (at t = 0 for a whole horizon): a lane's group
//   writes the lane's staged steps of Ks (16 bytes a step) and ks (4) as
//   one contiguous run, the G threads on consecutive steps, instead of
//   one 16-byte row and one float a step at a stride of H rows.
// What holds it now: the step's dependent chain (the exchange, Ju'V, Quu,
// the IEEE reciprocal, the V update), the same at every batch timed, and
// at H = 10 the launch and the first step's wait on memory (PERF.md §6
// gives the cost of a step).
// Lanes a block come from the wrapper's bq_bm_geometry
// (ops/cuda_riccati.py).
//
// Bits: every output is computed with the roundings that the one-thread
// kernel (this file before its redesign, which called
// riccati_quad_step.cuh: ampc_bq_step) compiled to, read from its SASS and
// pinned here with intrinsics so that no contraction choice of the
// compiler can move them: each sum over k a left fold whose second product
// is rounded and whose first is fused into their sum, then one FMA a
// term (bqbm_fold); cu = 2 R dt u fused into qu; cx rounded before it is
// added to Jx'v; Quu = Cuu + Ju'V Ju one add; the reciprocal rounded
// (rcp.rn); K and k rounded products; lin and quad one FMA each (k Quu
// rounded first); V's off-diagonal qxx added to 0 as the source had it,
// then Qux_i K_j and K_i Qux_j fused in that order and the rounded K_i K_j
// fused with Quu; qu + Quu k one add of the rounded product; v one FMA a
// term. ampc_bq_step itself (K2's step) is not used here and is unchanged.
// tests/test_torch_kernel_geometry.py models the group's step against the
// one-thread step.
#include "cp_async.cuh"
#include "riccati_quad_step.cuh"

// Steps of inputs held in shared memory; the copies run this many steps
// minus one ahead of the step that reads them (bq_bm_geometry mirrors it).
#define AMPC_BQBM_RING 12
// Threads a block may take (lanes x ds).
#define AMPC_BQBM_MAX_THREADS 128

// Floats of shared memory a lane takes with S ring slots: the ring (Jx
// rows and Ju: 20, x_t: 4, u_t: 1 a slot), the gain stage (K: 4, k: 1 a
// slot) and the group's two exchange buffers (V and v: 20 each).
__host__ __device__ constexpr int bqbm_floats_per_lane(int S) {
  return S * 30 + 40;
}

// sum_k a(k) b(k), k = 0 .. N-1, with the one-thread kernel's roundings:
// the second product rounded, the first fused into their sum, one FMA for
// each further term.
template <int N, typename A, typename Bv>
__device__ __forceinline__ float bqbm_fold(A a, Bv b) {
  static_assert(N >= 2, "a fold of at least two terms");
  float s = __fmaf_rn(a(0), b(0), __fmul_rn(a(1), b(1)));
#pragma unroll
  for (int k = 2; k < N; ++k) s = __fmaf_rn(a(k), b(k), s);
  return s;
}

template <int DS>
__global__ void backward_quad_bm_kernel(
    const __grid_constant__ QuadDiag P, const float* __restrict__ Jx_in,
    const float* __restrict__ Ju_in, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ Qd,
    const float* __restrict__ Rd, const float* __restrict__ Fd,
    float* __restrict__ Ks, float* __restrict__ ks,
    float* __restrict__ lin_out, float* __restrict__ quad_out, int H, int B) {
  static_assert(DS == 4, "16-byte rows: built for ds = 4");
  constexpr int RING = AMPC_BQBM_RING, G = DS;
  constexpr int JW = DS * DS + DS;  // a slot's Jx rows and Ju
  extern __shared__ float4 bqbm_smem[];
  const int NL = blockDim.x / G;    // lanes a block
  const int S = H < RING ? H : RING;
  const int tid = threadIdx.x, g = tid % G, l = tid / G;
  const long long b = (long long)blockIdx.x * NL + l;
  const bool valid = b < B;
  // Threads past the batch run the recursion on the last lane's inputs
  // and store nothing.
  const long long bl = valid ? b : B - 1;
  float* sJ = reinterpret_cast<float*>(bqbm_smem);  // [S][NL][JW]
  float* sX = sJ + S * NL * JW;                       // [S][NL][DS]
  float* sK = sX + S * NL * DS;                       // [S][NL][DS] gain stage
  float* sV = sK + S * NL * DS;                       // [2][NL][JW] exchange
  float* sU = sV + 2 * NL * JW;                       // [S][NL]
  float* sk = sU + S * NL;                            // [S][NL] gain stage

  const int obsdim = P.obsdim;
  const float rd2 = __fmul_rn(Rd[bl], P.two_dt);
  // The thread's row i = g: cost diagonal, goal, terminal V and v.
  const int i = g;
  const bool obs = i < obsdim;
  const float qd = obs ? __fmul_rn(Qd[bl * obsdim + i], P.two_dt) : 0.f;
  const float goal = obs ? P.goal[i] : 0.f;
  const float* xrow = xs + bl * (H + 1) * DS;
  float Vr[DS], vr;
  {
    const float fd2 = obs ? __fmul_rn(Fd[bl * obsdim + i], 2.f) : 0.f;
#pragma unroll
    for (int j = 0; j < DS; ++j) Vr[j] = i == j ? fd2 : 0.f;
    vr = obs ? __fmul_rn(fd2, __fsub_rn(xrow[(long long)H * DS + i], goal)) : 0.f;
  }

  // Item q of step t of the thread's lane into ring slot s: Jx rows
  // 0..DS-1, Ju, x_t, u_t; thread g of the group copies items g, g + G, ...
  auto fetch = [&](int t, int s) {
    const long long lt = bl * H + t;
    float* J = sJ + (s * NL + l) * JW;
#pragma unroll
    for (int q0 = 0; q0 < DS + 3; q0 += G) {
      const int q = q0 + g;
      if (q < DS)
        ampc_cp_async16(J + q * DS, Jx_in + (lt * DS + q) * DS);
      else if (q == DS)
        ampc_cp_async16(J + DS * DS, Ju_in + lt * DS);
      else if (q == DS + 1)
        ampc_cp_async16(sX + (s * NL + l) * DS, xrow + (long long)t * DS);
      else if (q == DS + 2)
        ampc_cp_async4(sU + s * NL + l, us + lt);
    }
  };

  for (int s = 0; s < RING - 1; ++s) {
    if (H - 1 - s >= 0) fetch(H - 1 - s, s);
    ampc_cp_async_commit();
  }
  float lin = 0.f, quad = 0.f;
  int s = 0;  // the ring slot of step t: (H - 1 - t) % RING
  for (int t = H - 1; t >= 0; --t) {
    ampc_cp_async_wait<RING - 2>();  // step t's copies have landed
    float V[DS][DS], v[DS];
    {
      float* xv = sV + ((t & 1) * NL + l) * JW;
      *reinterpret_cast<float4*>(xv + i * DS) = make_float4(Vr[0], Vr[1], Vr[2], Vr[3]);
      xv[DS * DS + i] = vr;
      __syncwarp();  // the group's rows, and its copies of step t
#pragma unroll
      for (int k = 0; k < DS; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(xv + k * DS);
        V[k][0] = w.x, V[k][1] = w.y, V[k][2] = w.z, V[k][3] = w.w;
      }
      const float4 w = *reinterpret_cast<const float4*>(xv + DS * DS);
      v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    }
    // Refill the slot that step t + 1 read (every thread of the warp is
    // past it) with step t - (RING - 1).
    if (t - (RING - 1) >= 0) fetch(t - (RING - 1), s == 0 ? RING - 1 : s - 1);
    ampc_cp_async_commit();

    const float* J = sJ + (s * NL + l) * JW;
    float Jx[DS][DS], Ju[DS];
#pragma unroll
    for (int k = 0; k < DS; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(J + k * DS);
      Jx[k][0] = w.x, Jx[k][1] = w.y, Jx[k][2] = w.z, Jx[k][3] = w.w;
    }
    {
      const float4 w = *reinterpret_cast<const float4*>(J + DS * DS);
      Ju[0] = w.x, Ju[1] = w.y, Ju[2] = w.z, Ju[3] = w.w;
    }
    const float u = sU[s * NL + l];

    // The values every row needs, formed by each thread of the group.
    float JuV[DS], Qux[DS], K[DS];
#pragma unroll
    for (int j = 0; j < DS; ++j)
      JuV[j] = bqbm_fold<DS>([&](int k) { return Ju[k]; }, [&](int k) { return V[k][j]; });
    const float sq = bqbm_fold<DS>([&](int k) { return JuV[k]; }, [&](int k) { return Ju[k]; });
    const float Quu = __fadd_rn(sq, rd2);
    const float inv_quu = __frcp_rn(Quu);
#pragma unroll
    for (int j = 0; j < DS; ++j) {
      Qux[j] = bqbm_fold<DS>([&](int k) { return JuV[k]; }, [&](int k) { return Jx[k][j]; });
      K[j] = -__fmul_rn(Qux[j], inv_quu);
    }
    const float sv = bqbm_fold<DS>([&](int k) { return Ju[k]; }, [&](int k) { return v[k]; });
    const float qu = __fmaf_rn(u, rd2, sv);
    const float kff = -__fmul_rn(qu, inv_quu);
    lin = __fmaf_rn(qu, kff, lin);
    const float quu_k = __fmul_rn(Quu, kff);
    quad = __fmaf_rn(quu_k, kff, quad);
    const float resid = __fadd_rn(qu, quu_k);

    // The thread's row: column i of Jx from the slot (a run-time column),
    // Qux_i and K_i formed again from it (the same bits as Qux[i], K[i]).
    float Jc[DS];
#pragma unroll
    for (int k = 0; k < DS; ++k) Jc[k] = J[k * DS + i];
    const float qux_i = bqbm_fold<DS>([&](int k) { return JuV[k]; }, [&](int k) { return Jc[k]; });
    const float K_i = -__fmul_rn(qux_i, inv_quu);
    float JxV[DS];
#pragma unroll
    for (int j = 0; j < DS; ++j)
      JxV[j] = bqbm_fold<DS>([&](int k) { return Jc[k]; }, [&](int k) { return V[k][j]; });
    const float xi = sX[(s * NL + l) * DS + i];
    const float cx = obs ? __fmul_rn(__fsub_rn(xi, goal), qd) : 0.f;
    const float qx = __fadd_rn(
        bqbm_fold<DS>([&](int k) { return Jc[k]; }, [&](int k) { return v[k]; }), cx);
#pragma unroll
    for (int j = 0; j < DS; ++j) {
      const float sxx =
          bqbm_fold<DS>([&](int k) { return JxV[k]; }, [&](int k) { return Jx[k][j]; });
      float a = __fadd_rn(sxx, i == j ? qd : 0.f);
      a = __fmaf_rn(qux_i, K[j], a);
      a = __fmaf_rn(K_i, Qux[j], a);
      Vr[j] = __fmaf_rn(__fmul_rn(K_i, K[j]), Quu, a);
    }
    vr = __fmaf_rn(K_i, resid, __fmaf_rn(qux_i, kff, qx));
    sK[(s * NL + l) * DS + i] = K_i;
    if (g == 0) sk[s * NL + l] = kff;

    // Every RING steps, and at t = 0: each group writes its lane's staged
    // steps t .. t + s as one run of Ks and one of ks, thread g taking
    // steps t + g, t + g + G, ...
    if (s == RING - 1 || t == 0) {
      __syncwarp();
      if (valid) {
        for (int d = g; d <= s; d += G) {
          const long long o = b * H + t + d;
          const int sd = s - d;  // the slot of step t + d
          *reinterpret_cast<float4*>(Ks + o * DS) =
              *reinterpret_cast<const float4*>(sK + (sd * NL + l) * DS);
          ks[o] = sk[sd * NL + l];
        }
      }
      __syncwarp();
    }
    s = s == RING - 1 ? 0 : s + 1;
  }
  if (valid && g == 0) {
    lin_out[b] = lin;
    quad_out[b] = quad;
  }
}

// lanes: lanes a block, 4 threads each, lanes x 4 a multiple of 32 up to
// AMPC_BQBM_MAX_THREADS (bq_bm_geometry).
extern "C" int ampc_backward_quad_bm(const QuadDiag* P, const float* Jx,
                                     const float* Ju, const float* xs,
                                     const float* us, const float* Qd,
                                     const float* Rd, const float* Fd,
                                     float* Ks, float* ks, float* lin,
                                     float* quad, int ds, int H, int B,
                                     int lanes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int G = 4;
  if (ds != G || H < 1 || B < 1 || P->obsdim < 1 || P->obsdim > ds ||
      lanes < 1 || lanes * G > AMPC_BQBM_MAX_THREADS || (lanes * G) % 32 != 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = backward_quad_bm_kernel<4>;
  const int S = H < AMPC_BQBM_RING ? H : AMPC_BQBM_RING;
  const int smem = lanes * bqbm_floats_per_lane(S) * (int)sizeof(float);
  static int allowed = 48 * 1024;  // dynamic shared memory opted into
  if (smem > allowed) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const unsigned blocks = (unsigned)((B + lanes - 1) / lanes);
  kernel<<<blocks, lanes * G, smem, (cudaStream_t)stream>>>(
      *P, Jx, Ju, xs, us, Qd, Rd, Fd, Ks, ks, lin, quad, H, B);
  return (int)cudaGetLastError();
}
