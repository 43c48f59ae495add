// K8: the objective sweep of the split ("wide") line search, lanes-last,
// dc=1, diagonal quadratic cost: one fixed cost for every lane (host
// constants in LSParams) or one cost per lane (lanes-last device planes
// qdT/fdT (obsdim, B), rdT (1, B)), a template switch.
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_linesearch.py:
// _ls_obj_kernel_wide (the first pallas_call of
// pallas_fused_line_search_wide, make_batched_ilqr_solver(ls_wide=True)).
// For every (lane b, step size l):
//   x_0 = x0[b];  for t < H:
//     u_t = clip(alpha_l k_t + ubar_t + K_t (x_t - xbar_t)),
//     obj += dt ((x_t - g)'Q(x_t - g) + R u_t^2),
//     du2 += (u_t - ubar_t)^2,
//     x_{t+1} = coeffs @ features([x_t, u_t]);
//   objs[l, b] = obj + (x_H - g)'F(x_H - g),  du2s[l, b] = du2,
// and every candidate's states and controls go to the scratch stash
// (H, ds+1, L, B) that the wrapper allocates: row (t, i < ds, l) holds
// x_{t+1}, row (t, ds, l) u_t. The acceptance rule runs in tensor code,
// and K9 (ls_reroll_wide.cu) reads the selected candidate back from the
// stash instead of rolling it again, as the fused kernel (K3,
// linesearch_fused.cu) reads its own stash back. The TPU kernel keeps no
// trajectory (its re-roll kernel rolls the chosen step size again); the
// stash is what lets the re-roll leave the chain here.
//
// Each thread is ls_step.cuh's ls_candidate, the candidate pass of K3's
// threads, so K8 and K3 score and stash every candidate identically.
//
// What bounds it on an H100: by bytes, the carry read once (~(2 ds + 2)
// floats a lane-step) and, with the stash, L (ds + 1) floats written a
// lane-step; in fact each thread's chain of H dependent steps, each the
// active terms' values (sinf/cosf) and their tree sums. Design:
//   - K3's geometry: a block holds NL lanes x L step sizes, thread
//     l * NL + j rolling step size l of lane j, so a warp is 32 (or 16)
//     neighbouring lanes at one step size and its reads of the carry and
//     writes of the stash are coalesced; NL from the wrapper
//     (fused_geometry) spreads the blocks over the SMs.
//   - Fewer instructions a chain-step: the term sums push each term into
//     the ds trees at once (features.cuh: ampc_tree_push_cv), the same
//     additions in the same order.
#include "ls_step.cuh"

template <int DS, bool LANE_COST>
__global__ void __launch_bounds__(AMPC_LS_MAX_THREADS, 2) ls_obj_wide_kernel(
    const __grid_constant__ FeatTable T, const __grid_constant__ LSParams P,
    const float* __restrict__ coeffs, const float* __restrict__ x0T,
    const float* __restrict__ xsT, const float* __restrict__ usT,
    const float* __restrict__ KsT, const float* __restrict__ ksT,
    const float* __restrict__ qdT, const float* __restrict__ rdT,
    const float* __restrict__ fdT, float* stash, float* __restrict__ objs,
    float* __restrict__ du2s, int H, int B) {
  __shared__ float s_coef[DS * AMPC_MAX_F];
  ampc_load_coef(s_coef, coeffs, DS * T.n);
  const int NL = blockDim.x / P.L;
  const int l = threadIdx.x / NL;
  const int j = threadIdx.x - l * NL;
  const int b = blockIdx.x * NL + j;
  if (b >= B) return;
  float x0[DS];
  float obj = 0.f, du2 = 0.f;
  ls_candidate<DS, LANE_COST>(T, s_coef, P, x0T, xsT, usT, KsT, ksT, qdT, rdT,
                              fdT, stash, l, H, B, b, x0, obj, du2);
  objs[(long long)l * B + b] = obj;
  du2s[(long long)l * B + b] = du2;
}

static const void* kernel_of(bool lane_cost) {
  return lane_cost ? (const void*)ls_obj_wide_kernel<4, true>
                   : (const void*)ls_obj_wide_kernel<4, false>;
}

// qdT/rdT/fdT: per-lane cost planes, or all three null for the fixed
// cost held in P. stash: H (ds+1) L B floats; objs, du2s: (L, B).
// lanes_per_block x L threads a block (the wrapper's fused_geometry).
extern "C" int ampc_ls_obj_wide(const FeatTable* T, const LSParams* P,
                                const float* coeffs, const float* x0T,
                                const float* xsT, const float* usT,
                                const float* KsT, const float* ksT,
                                const float* qdT, const float* rdT,
                                const float* fdT, float* stash, float* objs,
                                float* du2s, int ds, int H, int B,
                                int lanes_per_block, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool lane = qdT != nullptr;
  if (ds != 4 || T->d != ds + 1 || T->n < 1 || T->n > AMPC_MAX_F ||
      P->L < 1 || P->L > AMPC_MAX_L || P->obsdim < 1 || P->obsdim > ds ||
      (rdT != nullptr) != lane || (fdT != nullptr) != lane || H < 1 ||
      B < 1 || lanes_per_block < 1 ||
      lanes_per_block * P->L > AMPC_LS_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const int threads = lanes_per_block * P->L;
  const unsigned blocks = (unsigned)((B + lanes_per_block - 1) / lanes_per_block);
  cudaStream_t s = (cudaStream_t)stream;
  if (lane)
    ls_obj_wide_kernel<4, true><<<blocks, threads, 0, s>>>(
        *T, *P, coeffs, x0T, xsT, usT, KsT, ksT, qdT, rdT, fdT, stash, objs,
        du2s, H, B);
  else
    ls_obj_wide_kernel<4, false><<<blocks, threads, 0, s>>>(
        *T, *P, coeffs, x0T, xsT, usT, KsT, ksT, qdT, rdT, fdT, stash, objs,
        du2s, H, B);
  return (int)cudaGetLastError();
}

// The compiled instance's registers and local (spill) bytes a thread, and
// its resident blocks an SM at `threads` a block: out[0..2].
extern "C" int ampc_ls_obj_wide_occupancy(int lane_cost, int threads,
                                          int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel_of(lane_cost != 0));
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_of(lane_cost != 0), threads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return 0;
}
