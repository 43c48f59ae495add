// K2: lanes-last Riccati backward pass for a diagonal quadratic cost, dc=1.
//
// Replaces the Pallas TPU kernels autompc_tpu/ops/pallas_riccati.py:
// _backward_quad_kernel_packed (via pallas_tvlqr_backward_quad_ll, any B)
// and _backward_quad_kernel_wide with step_mode="std", both through
// _backward_quad_ll_wide_cast (cast IO) and through
// _backward_quad_ll_wide_4d (reshape IO, arrays pre-split to
// (..., B/128, 128)); the wide forms need B % 1024 == 0. All evaluate one
// step function, _bq_step, in three TPU tile layouts; this kernel is that
// math once, for every batch size. The 4D layout is a view of the
// lanes-last one, so the reshape-IO entry launches this kernel on views
// of its arrays; its terminal state arrives as its own array, hence the
// separate xterm pointer (xsT + H*ds*B for the 3D entry):
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
// The cost diagonals come in one of two forms, as a template switch over
// one recursion (riccati_quad_step.cuh): host constants in QuadDiag (one
// fixed cost for every lane), or lanes-last device planes qdT/fdT
// (obsdim, B) and rdT (1, B), one cost per lane (the tuner's cost
// fan-out). The TPU kernel only ever sees planes; its fixed cost is a
// broadcast. The Jacobian plane is float or bfloat16 (jac_io.cuh), a
// second template switch; the recursion runs in float32 either way.
//
// What bounds it on an H100: the latency of device memory. The recursion
// is sequential in t and independent across lanes, so one thread owns one
// lane, with V (ds x ds) and v in registers: ~300 dependent flops a step,
// ~0.1-0.2 us. A step's inputs (ds*(ds+1) Jacobian rows, ds+1 trajectory
// rows, and for an inactive lane ds+1 rows of old gains) head that step's
// chain; loaded at the step, as they were, each step waits a full trip to
// device memory (~1.35 us a step measured), and with one or two warps an
// SM there is nothing to hide it behind. So the inputs stream through a
// ring of AMPC_BQ_RING steps in shared memory, each thread copying its
// own lane's elements with cp.async (lanes-last rows: a warp's copies of
// one row are 128 contiguous bytes) AMPC_BQ_RING - 1 steps ahead of the
// step that reads them. A bfloat16 Jacobian row goes through the ring in
// 4-byte words too: when B is even, each thread copies the aligned pair
// of lanes that holds its own into a word of its own and reads its half
// (so no thread reads another's copy and a warp needs no barrier); when
// B is odd it is read at the step, by an instance of its own (JRING), so
// that neither instance's step waits behind a run-time branch. The step's
// arithmetic is unchanged (ampc_bq_step), so the outputs are the same
// bits as a kernel that loads at the step. Blocks are small (the
// wrapper's bq_geometry: 32 lanes up to B = 4 x SMs x 32) so the few
// warps spread over as many SMs as they can. The TPU's (8, 128) wide tiles
// and in-VMEM casts have no counterpart here.
//
// The main library holds ds = 4; another ds (the pendulum's 2) is the
// same kernel compiled at first use with -DAMPC_DS (ops/_build.py:
// shape_library), its ring AMPC_BQ_RING steps of that ds's rows.
#include "cp_async.cuh"
#include "jac_io.cuh"
#include "riccati_quad_step.cuh"

// Steps of inputs held in shared memory; the copies run this many steps
// minus one ahead of the step that reads them.
#define AMPC_BQ_RING 8
// Lanes (threads) a block may take: bq_geometry in ops/cuda_riccati.py.
#define AMPC_BQ_MAX_LANES 128

template <int DS>
constexpr int bq_ring_bytes_per_lane() {
  // Jacobian rows (a 4-byte word each: a float or a pair of bfloat16
  // lanes), then the trajectory rows (ds states, the control) and the old
  // gains (ds + 1) in float.
  return AMPC_BQ_RING * (DS * (DS + 1) * 4 + 2 * (DS + 1) * 4);
}

// JRING: the Jacobian rows go through the ring (float rows, and bfloat16
// rows when B is even), else they are read at the step. It is a template
// switch, not a run-time flag, so that each instance's step is one
// straight run of loads the compiler can start together.
template <int DS, bool LANE_COST, typename JT, bool JRING>
__global__ void __launch_bounds__(AMPC_BQ_MAX_LANES) backward_quad_kernel(
    const __grid_constant__ QuadDiag P, const JT* __restrict__ jac,
    const float* __restrict__ xsT, const float* __restrict__ xterm,
    const float* __restrict__ usT,
    const float* __restrict__ qdT, const float* __restrict__ rdT,
    const float* __restrict__ fdT, const uint8_t* __restrict__ act,
    const float* __restrict__ oldK, const float* __restrict__ oldk,
    float* __restrict__ KsT, float* __restrict__ ksT,
    float* __restrict__ lin_out, float* __restrict__ quad_out, int H, int B) {
  constexpr int D = DS + 1, NJ = DS * D, NF = 2 * D;
  constexpr bool BF16 = sizeof(JT) == 2;
  extern __shared__ float4 bq_smem[];
  const int nl = blockDim.x, tid = threadIdx.x;
  // Ring slot k: NF float rows of nl lanes (xs rows 0..DS-1, us, old K
  // rows, old k), then NJ Jacobian rows of nl 4-byte words.
  float* fring = reinterpret_cast<float*>(bq_smem);
  uint32_t* jring = reinterpret_cast<uint32_t*>(fring + AMPC_BQ_RING * NF * nl);
  const int b = blockIdx.x * nl + tid;
  const bool valid = b < B;
  // Threads past the batch run the recursion on the last lane's inputs
  // and store nothing.
  const long long bl = valid ? b : B - 1;
  const bool active = act[bl] != 0;
  // The Jacobian word a thread copies starts at lane jl: its own lane, or
  // for bfloat16 the even lane of its pair (half jh of the word).
  const long long jl = BF16 ? (bl & ~1LL) : bl;
  const int jh = (int)(bl & 1);
  const int obsdim = P.obsdim;

  float qd[DS], goal[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const float q = LANE_COST ? (i < obsdim ? qdT[(long long)i * B + bl] : 0.f)
                              : P.qd[i];
    qd[i] = i < obsdim ? q * P.two_dt : 0.f;
    goal[i] = i < obsdim ? P.goal[i] : 0.f;
  }
  const float rd2 = (LANE_COST ? rdT[bl] : P.rd) * P.two_dt;

  // Step t's inputs into its ring slot (t counts down from H-1).
  auto fetch_step = [&](int t) {
    const int k = (H - 1 - t) % AMPC_BQ_RING;
    float* fr = fring + k * NF * nl + tid;
    uint32_t* jr = jring + k * NJ * nl + tid;
    const long long jrow = (long long)t * NJ * B;
    if constexpr (JRING) {
#pragma unroll
      for (int r = 0; r < NJ; ++r)
        ampc_cp_async4(jr + r * nl, jac + jrow + (long long)r * B + jl);
    }
#pragma unroll
    for (int i = 0; i < DS; ++i)
      ampc_cp_async4(fr + i * nl, xsT + ((long long)t * DS + i) * B + bl);
    ampc_cp_async4(fr + DS * nl, usT + (long long)t * B + bl);
    if (!active) {
#pragma unroll
      for (int j = 0; j < DS; ++j)
        ampc_cp_async4(fr + (D + j) * nl, oldK + ((long long)t * DS + j) * B + bl);
      ampc_cp_async4(fr + (D + DS) * nl, oldk + (long long)t * B + bl);
    }
  };

  // Terminal expansion.
  float V[DS][DS], v[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const float f = LANE_COST ? (i < obsdim ? fdT[(long long)i * B + bl] : 0.f)
                              : P.fd[i];
    const float fd2 = i < obsdim ? f * 2.f : 0.f;
#pragma unroll
    for (int j = 0; j < DS; ++j) V[i][j] = (i == j) ? fd2 : 0.f;
    v[i] = i < obsdim ? fd2 * (xterm[(long long)i * B + bl] - goal[i]) : 0.f;
  }

  for (int s = 0; s < AMPC_BQ_RING - 1; ++s) {
    if (H - 1 - s >= 0) fetch_step(H - 1 - s);
    ampc_cp_async_commit();
  }
  float lin = 0.f, quad = 0.f;
  for (int t = H - 1; t >= 0; --t) {
    if (t - (AMPC_BQ_RING - 1) >= 0) fetch_step(t - (AMPC_BQ_RING - 1));
    ampc_cp_async_commit();
    ampc_cp_async_wait<AMPC_BQ_RING - 1>();
    const int k = (H - 1 - t) % AMPC_BQ_RING;
    const float* fr = fring + k * NF * nl + tid;
    const uint32_t* jr = jring + k * NJ * nl + tid;
    const JT* row = jac + (long long)t * NJ * B + bl;
    // The step's Jacobian rows: the thread's words in the ring (a float,
    // or its half of a bfloat16 pair), or read at the step.
    float jv[NJ];
#pragma unroll
    for (int r = 0; r < NJ; ++r) {
      if constexpr (!JRING) {
        jv[r] = ampc_jac_load(row[(long long)r * B]);
      } else {
        const uint32_t w = jr[r * nl];
        if constexpr (BF16)
          jv[r] = ampc_jac_load(__ushort_as_bfloat16(
              (unsigned short)(jh ? w >> 16 : w & 0xffffu)));
        else
          jv[r] = __uint_as_float(w);
      }
    }
    float Jx[DS][DS], Ju[DS];
#pragma unroll
    for (int kk = 0; kk < DS; ++kk) {
#pragma unroll
      for (int j = 0; j < DS; ++j) Jx[kk][j] = jv[kk * D + j];
      Ju[kk] = jv[kk * D + DS];
    }
    float cx[DS];
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      const float x = fr[i * nl];  // every state row is in the slot
      cx[i] = i < obsdim ? qd[i] * (x - goal[i]) : 0.f;
    }
    const float cu = rd2 * fr[DS * nl];

    float K[DS], kff;
    ampc_bq_step<DS>(Jx, Ju, cx, cu, rd2, qd, V, v, K, kff, lin, quad);

    if (valid) {
#pragma unroll
      for (int j = 0; j < DS; ++j)
        KsT[((long long)t * DS + j) * B + b] = active ? K[j] : fr[(D + j) * nl];
      ksT[(long long)t * B + b] = active ? kff : fr[(D + DS) * nl];
    }
  }
  if (valid) {
    lin_out[b] = lin;
    quad_out[b] = quad;
  }
}

template <int DS, bool LANE_COST, typename JT, bool JRING>
static int launch_one(const QuadDiag* P, const void* jac, const float* xsT,
                      const float* xterm, const float* usT, const float* qdT,
                      const float* rdT, const float* fdT, const uint8_t* act,
                      const float* oldK, const float* oldk, float* KsT,
                      float* ksT, float* lin, float* quad, int H, int B,
                      int lanes, cudaStream_t s) {
  auto kernel = backward_quad_kernel<DS, LANE_COST, JT, JRING>;
  const int smem = lanes * bq_ring_bytes_per_lane<DS>();
  static int allowed = 48 * 1024;  // dynamic shared memory opted into
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const unsigned blocks = (unsigned)((B + lanes - 1) / lanes);
  kernel<<<blocks, lanes, smem, s>>>(*P, (const JT*)jac, xsT, xterm, usT, qdT,
                                     rdT, fdT, act, oldK, oldk, KsT, ksT, lin,
                                     quad, H, B);
  return (int)cudaGetLastError();
}

template <int DS, bool LANE_COST, typename JT>
static int launch(const QuadDiag* P, const void* jac, const float* xsT,
                  const float* xterm, const float* usT, const float* qdT,
                  const float* rdT, const float* fdT, const uint8_t* act,
                  const float* oldK, const float* oldk, float* KsT, float* ksT,
                  float* lin, float* quad, int H, int B, int lanes,
                  cudaStream_t s) {
  // bfloat16 rows go through the ring in pairs of lanes when every pair
  // starts on a 4-byte boundary, and are read at the step otherwise.
  if constexpr (sizeof(JT) == 2) {
    if (B % 2 != 0 || (uintptr_t)jac % 4 != 0)
      return launch_one<DS, LANE_COST, JT, false>(P, jac, xsT, xterm, usT, qdT,
                                              rdT, fdT, act, oldK, oldk, KsT,
                                              ksT, lin, quad, H, B, lanes, s);
  }
  return launch_one<DS, LANE_COST, JT, true>(P, jac, xsT, xterm, usT, qdT, rdT,
                                         fdT, act, oldK, oldk, KsT, ksT, lin,
                                         quad, H, B, lanes, s);
}

// The ds of this object: 4 in the main library, else the shape it was
// built for at first use.
#ifndef AMPC_DS
#define AMPC_DS 4
#endif

// qdT/rdT/fdT: per-lane cost planes, or all three null for the fixed
// cost held in P. jac_bf16: the Jacobian plane is bfloat16, else float.
// xterm: the terminal state (ds, B). lanes: lanes (threads) a block, a
// multiple of 32 up to AMPC_BQ_MAX_LANES (bq_geometry).
extern "C" int ampc_backward_quad_ll(const QuadDiag* P, const void* jac,
                                     const float* xsT, const float* xterm,
                                     const float* usT, const float* qdT,
                                     const float* rdT, const float* fdT,
                                     const uint8_t* act, const float* oldK,
                                     const float* oldk, float* KsT,
                                     float* ksT, float* lin, float* quad,
                                     int jac_bf16, int ds, int H, int B,
                                     int lanes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool lane = qdT != nullptr;
  if (ds != AMPC_DS || H < 1 || B < 1 || P->obsdim < 1 || P->obsdim > ds ||
      (rdT != nullptr) != lane || (fdT != nullptr) != lane ||
      lanes < 32 || lanes > AMPC_BQ_MAX_LANES || lanes % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (lane && jac_bf16)
    return launch<AMPC_DS, true, __nv_bfloat16>(P, jac, xsT, xterm, usT, qdT, rdT, fdT,
                                       act, oldK, oldk, KsT, ksT, lin, quad,
                                       H, B, lanes, s);
  if (lane)
    return launch<AMPC_DS, true, float>(P, jac, xsT, xterm, usT, qdT, rdT, fdT, act,
                               oldK, oldk, KsT, ksT, lin, quad, H, B, lanes, s);
  if (jac_bf16)
    return launch<AMPC_DS, false, __nv_bfloat16>(P, jac, xsT, xterm, usT, qdT, rdT,
                                        fdT, act, oldK, oldk, KsT, ksT, lin,
                                        quad, H, B, lanes, s);
  return launch<AMPC_DS, false, float>(P, jac, xsT, xterm, usT, qdT, rdT, fdT, act,
                              oldK, oldk, KsT, ksT, lin, quad, H, B, lanes, s);
}
