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
#include "jac_io.cuh"
#include "riccati_quad_step.cuh"

template <int DS, bool LANE_COST, typename JT>
__global__ void backward_quad_kernel(
    const __grid_constant__ QuadDiag P, const JT* __restrict__ jac,
    const float* __restrict__ xsT, const float* __restrict__ xterm,
    const float* __restrict__ usT,
    const float* __restrict__ qdT, const float* __restrict__ rdT,
    const float* __restrict__ fdT, const uint8_t* __restrict__ act,
    const float* __restrict__ oldK, const float* __restrict__ oldk,
    float* __restrict__ KsT, float* __restrict__ ksT,
    float* __restrict__ lin_out, float* __restrict__ quad_out, int H, int B) {
  constexpr int D = DS + 1;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const bool active = act[b] != 0;
  const int obsdim = P.obsdim;

  float qd[DS], goal[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const float q = LANE_COST ? (i < obsdim ? qdT[(long long)i * B + b] : 0.f)
                              : P.qd[i];
    qd[i] = i < obsdim ? q * P.two_dt : 0.f;
    goal[i] = i < obsdim ? P.goal[i] : 0.f;
  }
  const float rd2 = (LANE_COST ? rdT[b] : P.rd) * P.two_dt;

  // Terminal expansion.
  float V[DS][DS], v[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const float f = LANE_COST ? (i < obsdim ? fdT[(long long)i * B + b] : 0.f)
                              : P.fd[i];
    const float fd2 = i < obsdim ? f * 2.f : 0.f;
#pragma unroll
    for (int j = 0; j < DS; ++j) V[i][j] = (i == j) ? fd2 : 0.f;
    v[i] = i < obsdim ? fd2 * (xterm[(long long)i * B + b] - goal[i]) : 0.f;
  }

  float lin = 0.f, quad = 0.f;
  for (int t = H - 1; t >= 0; --t) {
    const JT* row = jac + (long long)t * DS * D * B + b;
    float Jx[DS][DS], Ju[DS];
#pragma unroll
    for (int k = 0; k < DS; ++k) {
#pragma unroll
      for (int j = 0; j < DS; ++j)
        Jx[k][j] = ampc_jac_load(row[(long long)(k * D + j) * B]);
      Ju[k] = ampc_jac_load(row[(long long)(k * D + DS) * B]);
    }
    float cx[DS];
#pragma unroll
    for (int i = 0; i < DS; ++i)
      cx[i] = i < obsdim
                  ? qd[i] * (xsT[((long long)t * DS + i) * B + b] - goal[i])
                  : 0.f;
    const float cu = rd2 * usT[(long long)t * B + b];

    float K[DS], kff;
    ampc_bq_step<DS>(Jx, Ju, cx, cu, rd2, qd, V, v, K, kff, lin, quad);

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

template <bool LANE_COST, typename JT>
static void launch(const QuadDiag* P, const void* jac, const float* xsT,
                   const float* xterm, const float* usT, const float* qdT,
                   const float* rdT, const float* fdT, const uint8_t* act,
                   const float* oldK, const float* oldk, float* KsT,
                   float* ksT, float* lin, float* quad, int H, int B,
                   cudaStream_t s) {
  const int threads = 64;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  backward_quad_kernel<4, LANE_COST, JT><<<blocks, threads, 0, s>>>(
      *P, (const JT*)jac, xsT, xterm, usT, qdT, rdT, fdT, act, oldK, oldk,
      KsT, ksT, lin, quad, H, B);
}

// qdT/rdT/fdT: per-lane cost planes, or all three null for the fixed
// cost held in P. jac_bf16: the Jacobian plane is bfloat16, else float.
// xterm: the terminal state (ds, B).
extern "C" int ampc_backward_quad_ll(const QuadDiag* P, const void* jac,
                                     const float* xsT, const float* xterm,
                                     const float* usT, const float* qdT,
                                     const float* rdT, const float* fdT,
                                     const uint8_t* act, const float* oldK,
                                     const float* oldk, float* KsT,
                                     float* ksT, float* lin, float* quad,
                                     int jac_bf16, int ds, int H, int B,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool lane = qdT != nullptr;
  if (ds != 4 || P->obsdim < 1 || P->obsdim > ds ||
      (rdT != nullptr) != lane || (fdT != nullptr) != lane)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (lane && jac_bf16)
    launch<true, __nv_bfloat16>(P, jac, xsT, xterm, usT, qdT, rdT, fdT, act,
                                oldK, oldk, KsT, ksT, lin, quad, H, B, s);
  else if (lane)
    launch<true, float>(P, jac, xsT, xterm, usT, qdT, rdT, fdT, act, oldK,
                        oldk, KsT, ksT, lin, quad, H, B, s);
  else if (jac_bf16)
    launch<false, __nv_bfloat16>(P, jac, xsT, xterm, usT, qdT, rdT, fdT, act,
                                 oldK, oldk, KsT, ksT, lin, quad, H, B, s);
  else
    launch<false, float>(P, jac, xsT, xterm, usT, qdT, rdT, fdT, act, oldK,
                         oldk, KsT, ksT, lin, quad, H, B, s);
  return (int)cudaGetLastError();
}
