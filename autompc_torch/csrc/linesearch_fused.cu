// K3: fused iLQR line search with acceptance, relinearization and carry
// select, lanes-last, dc=1, diagonal quadratic cost: one fixed cost for
// every lane (host constants in LSParams) or one cost per lane (lanes-last
// device planes qdT/fdT (obsdim, B), rdT (1, B): the TPU kernel's
// per_lane_diag_cost=True, the tuner's cost fan-out). The two forms are a
// template switch over one kernel body.
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_linesearch.py:
// _fused_kernel, entry pallas_fused_line_search with ll_io=True,
// carry=(act, old_jac), grad_terms and one shared (ds, F) coefficient
// plane, or (ampc_fused_line_search_lane, per-lane costs and a float
// carry) one plane a lane: a lanes-last (ds, F, B) plane read in place,
// the table in device memory, the whole library up to AMPC_MAX_F_BIG
// terms (128 registers with the small trees, 148 with the large, one
// block of 256 threads an SM fewer). Per lane:
//   rollouts  every step size alpha_l through the feature-library
//             dynamics, u = clip(alpha k + ubar + K (x - xbar)), with the
//             objective dt * sum_t ((x-g)'Q(x-g) + R u^2) + (x_H-g)'F(x_H-g)
//             and du2 = sum_t (u-ubar)^2;
//   accept    the reference rule: the first alpha whose expected-reduction
//             ratio exceeds the threshold, else the strict-< argmin; a tiny
//             ||k|| forces alpha index 0 and success; the lane fails when it
//             did not succeed and its last objective worsens obj0 by > 1e-3;
//   write     the selected rollout's xs/us where the lane is active and
//             did not fail, its packed Jacobians (the relinearization) where
//             it also succeeded, old values elsewhere, plus obj, success,
//             failure and du2.
//
// What bounds it on an H100: arithmetic, not bytes: per lane and step each
// of the L candidates evaluates the active terms (sinf/cosf), and the
// lane's streams are ~10 floats in per step. Each candidate is a chain of
// H dependent steps, so the time is set by how many chains run side by
// side. Design:
//   - Candidates across threads. A block holds NL lanes x L step sizes,
//     thread (l, j) = threadIdx.x = l * NL + j rolling step size l of lane
//     j: a warp is 32 (or 16) neighbouring lanes at one step size, so its
//     reads of the lanes-last carry are coalesced. Each thread runs
//     ls_candidate (ls_step.cuh), the candidate pass K8 runs, so every
//     objective is K8's to the bit. NL (from the wrapper) spreads the
//     blocks over the SMs; __launch_bounds__ caps registers at 128 (two
//     blocks of 256 threads an SM).
//   - No re-roll: each candidate thread stashes its states and controls
//     in a scratch buffer (H, ds+1, L, B) that the wrapper allocates,
//     L (ds+1) floats a lane-step, and the selected candidate's rows are
//     read back, as K9 reads K8's stash back.
//   - Acceptance in the kernel. Objectives and du2 meet in shared memory;
//     thread l = 0 of each lane applies the rule with the reference's
//     float operations (unchanged from the one-thread-per-lane kernel).
//   - The Jacobians off the chain. After a barrier the lane's L threads
//     write the selected trajectory and compute its packed Jacobian rows
//     in parallel over t (t = l, l + L, ...), one column of ds rows at a
//     time (ampc_jac_col), so no thread holds all ds (ds+1) rows; a warp
//     writes 32 (16) neighbouring lanes of one row.
//
// The Jacobian carry is float or bfloat16 (jac_io.cuh): old rows are
// read, and new rows written, in the carry's own storage type (the TPU
// wrapper's jac_dtype), a second template switch.
//
// Batch-major entry (BM; ampc_fused_line_search_bm and _bm_lane, the TPU
// entry with ll_io=False, its iLQR body's fused search on the batch-major
// carry): x0 (B, ds), xs (B, H+1, ds), us (B, H, 1), Ks (B, H, 1, ds),
// ks (B, H, 1) in; the chosen trajectory xs (B, H+1, ds), us (B, H, 1),
// obj, success, failure, du2 and the Jacobians along it, Jx (B, H, ds, ds)
// and Ju (B, H, ds, 1), out, for every lane: no carry select (the TPU
// entry returns the new values and the body selects). Costs are per-lane
// lanes-last planes, the Jacobians float. A thread reads and writes its
// own lane's rows, so a warp's accesses are strided by a lane's row
// length: the simple form, left for a later redesign. REG adds the
// GaussReg term (ls_step.cuh: RegParams, S and mu shared as a kernel
// parameter, the weight a per-lane vector regw (B,)) to every candidate's
// stage cost. With both switches off the kernel is the lanes-last one as
// it was; the trailing parameters (R, regw, out_ju) are read by the BM
// and REG instances only.
#include "ls_step.cuh"

// TA: FeatTable (shared coefficients, staged in shared memory) or
// FeatTableRef<S> (per-lane coefficients, a lanes-last (ds, n, B) plane
// read in place, lane b's column by its L candidate threads; the table in
// device memory, trees of S slots). An instance with the large trees may
// take twice the registers (one block of 256 threads an SM).
template <int DS, bool LANE_COST, typename JT, class TA = FeatTable, bool BM = false,
          bool REG = false>
__global__ void __launch_bounds__(
    AMPC_LS_MAX_THREADS, AmpcTableTraits<TA>::slots == AMPC_TREE_SLOTS ? 2 : 1)
    fused_ls_kernel(const __grid_constant__ TA T,
    const __grid_constant__ LSParams P,
    const float* __restrict__ coeffs, const float* __restrict__ x0T,
    const float* __restrict__ xsT, const float* __restrict__ usT,
    const float* __restrict__ KsT, const float* __restrict__ ksT,
    const float* __restrict__ qdT, const float* __restrict__ rdT,
    const float* __restrict__ fdT, const float* __restrict__ obj0_in, const float* __restrict__ lin_in,
    const float* __restrict__ quad_in, const uint8_t* __restrict__ ks_small_in,
    const uint8_t* __restrict__ act_in, const JT* __restrict__ old_jac,
    float* stash, float* __restrict__ out_xs,
    float* __restrict__ out_us, float* __restrict__ out_obj,
    uint8_t* __restrict__ out_succ, uint8_t* __restrict__ out_fail,
    JT* __restrict__ out_jac, float* __restrict__ out_du2, int H, int B,
    const __grid_constant__ RegParams R, const float* __restrict__ regw,
    float* __restrict__ out_ju) {
  constexpr bool LANE = AmpcTableTraits<TA>::lane;
  constexpr int S = AmpcTableTraits<TA>::slots;
  constexpr int D = DS + 1;
  __shared__ float s_coef[DS * AMPC_MAX_F];
  __shared__ float s_obj[AMPC_LS_MAX_THREADS];
  __shared__ float s_du2[AMPC_LS_MAX_THREADS];
  __shared__ int s_pick[AMPC_LS_MAX_THREADS];
  if constexpr (!LANE) ampc_load_coef(s_coef, coeffs, DS * T.n);
  const int L = P.L;
  const int NL = blockDim.x / L;
  const int l = threadIdx.x / NL;
  const int j = threadIdx.x - l * NL;
  const int b = blockIdx.x * NL + j;
  const bool valid = b < B;
  // Stash row (t, i, l) of lane b: i < DS holds x_{t+1}, i = DS holds u_t.
  const long long LB = (long long)L * B;

  // ---- candidate l of lane b: rollout, objective, du2 -----------------
  float x0[DS];
  float obj = 0.f, du2 = 0.f;
  if (valid) {
    if constexpr (LANE)
      ls_candidate_cv<DS, LANE_COST, S, BM, REG>(
          ampc_table(T), CoefLane{coeffs + b, T.n, B}, P, x0T, xsT, usT, KsT, ksT,
          qdT, rdT, fdT, stash, l, H, B, b, x0, obj, du2, &R, regw);
    else
      ls_candidate<DS, LANE_COST, BM, REG>(T, s_coef, P, x0T, xsT, usT, KsT, ksT, qdT,
                                           rdT, fdT, stash, l, H, B, b, x0, obj, du2,
                                           &R, regw);
  }
  s_obj[threadIdx.x] = obj;
  s_du2[threadIdx.x] = du2;
  __syncthreads();

  // ---- acceptance, one thread per lane ----------------------------------
  if (l == 0 && valid) {
    float objs[AMPC_MAX_L];
#pragma unroll
    for (int m = 0; m < AMPC_MAX_L; ++m) objs[m] = m < L ? s_obj[m * NL + j] : 0.f;
    const float obj0 = obj0_in[b];
    const float lin = lin_in[b];
    const float quad = quad_in[b];
    const bool ks_small = ks_small_in[b] != 0;
    int first_acc = L;
    int best = 0;
    float best_val = objs[0];
#pragma unroll
    for (int m = AMPC_MAX_L - 1; m >= 0; --m) {
      if (m < L) {
        const float a = P.alphas[m];
        const float expect = a * lin + (a * a) * quad * 0.5f;
        const float denom = -expect;
        const float ratio =
            fabsf(denom) > 1e-30f ? (obj0 - objs[m]) / denom : -__int_as_float(0x7f800000);
        if (ratio > P.thresh) first_acc = m;
      }
    }
#pragma unroll
    for (int m = 1; m < AMPC_MAX_L; ++m) {
      if (m < L && objs[m] < best_val) {
        best = m;
        best_val = objs[m];
      }
    }
    const bool any_acc = first_acc < L;
    const int chosen = ks_small ? 0 : (any_acc ? first_acc : best);
    const int idx_last = ks_small ? 0 : (any_acc ? first_acc : L - 1);
    float chosen_obj = objs[0], last_obj = objs[0];
#pragma unroll
    for (int m = 1; m < AMPC_MAX_L; ++m) {
      if (m == chosen) chosen_obj = objs[m];
      if (m == idx_last) last_obj = objs[m];
    }
    const bool success = (chosen_obj < obj0) || ks_small;
    const bool failed = !success && (last_obj > obj0 + 1e-3f);
    const float new_obj = success ? chosen_obj : last_obj;
    const int sel = success ? chosen : idx_last;

    // The batch-major entry selects nothing: every lane's chosen rollout.
    bool traj_mask = true, jac_mask = true;
    if constexpr (!BM) {
      const bool act = act_in[b] != 0;
      traj_mask = act && !failed;
      jac_mask = traj_mask && success;
    }
    out_obj[b] = traj_mask ? new_obj : obj0;
    out_succ[b] = success ? 1 : 0;
    out_fail[b] = failed ? 1 : 0;
    out_du2[b] = s_du2[sel * NL + j];
    s_pick[j] = sel | (traj_mask ? 0x100 : 0) | (jac_mask ? 0x200 : 0);
  }
  __syncthreads();
  if (!valid) return;

  // ---- the selected rollout: xs, us and Jacobians, in parallel over t ---
  const int pick = s_pick[j];
  const bool traj_mask = (pick & 0x100) != 0;
  const bool jac_mask = (pick & 0x200) != 0;
  const float* sw = stash + (long long)(pick & 0xff) * B + b;
  if constexpr (BM) {
    if (l == 0) {
#pragma unroll
      for (int i = 0; i < DS; ++i) out_xs[(long long)b * (H + 1) * DS + i] = x0[i];
    }
    for (int t = l; t < H; t += L) {
      const float* row = sw + (long long)t * D * LB;
      float z[D];
#pragma unroll
      for (int i = 0; i < DS; ++i) z[i] = t == 0 ? x0[i] : row[(i - D) * LB];
      z[DS] = row[DS * LB];
      const long long bt = (long long)b * H + t;
#pragma unroll
      for (int i = 0; i < DS; ++i) out_xs[(bt + b + 1) * DS + i] = row[i * LB];
      out_us[bt] = z[DS];
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        float col[DS];
        if constexpr (LANE)
          ampc_jac_col_cv<DS, D, S>(ampc_table(T), CoefLane{coeffs + b, T.n, B}, z,
                                    dd, col);
        else
          ampc_jac_col<DS, D>(T, s_coef, z, dd, col);
#pragma unroll
        for (int i = 0; i < DS; ++i) {
          if (dd < DS)
            out_jac[(bt * DS + i) * DS + dd] = ampc_jac_store<JT>(col[i]);
          else
            out_ju[bt * DS + i] = col[i];
        }
      }
    }
    return;
  }
  if (l == 0) {
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      const long long o = (long long)i * B + b;
      out_xs[o] = traj_mask ? x0[i] : xsT[o];
    }
  }
  for (int t = l; t < H; t += L) {
    const float* row = sw + (long long)t * D * LB;
    float z[D];
#pragma unroll
    for (int i = 0; i < DS; ++i) z[i] = t == 0 ? x0[i] : row[(i - D) * LB];
    z[DS] = row[DS * LB];
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      const long long o = ((long long)(t + 1) * DS + i) * B + b;
      out_xs[o] = traj_mask ? row[i * LB] : xsT[o];
    }
    out_us[(long long)t * B + b] = traj_mask ? z[DS] : usT[(long long)t * B + b];
    const long long jt = (long long)t * DS * D;
    if (jac_mask) {
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        float col[DS];
        if constexpr (LANE)
          ampc_jac_col_cv<DS, D, S>(ampc_table(T), CoefLane{coeffs + b, T.n, B}, z,
                                    dd, col);
        else
          ampc_jac_col<DS, D>(T, s_coef, z, dd, col);
#pragma unroll
        for (int i = 0; i < DS; ++i)
          out_jac[(jt + i * D + dd) * B + b] = ampc_jac_store<JT>(col[i]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < DS * D; ++r) {
        const long long o = (jt + r) * B + b;
        out_jac[o] = old_jac[o];
      }
    }
  }
}

// The ds of this object: 4 in the main library, with the occupancy
// queries, else the shape it was built for at first use (-DAMPC_DS;
// ops/_build.py: shape_library). Every library holds the shared- and the
// per-lane-coefficient entries at its ds.
#ifndef AMPC_DS
#define AMPC_DS 4
#define AMPC_LS_MAIN_LIBRARY
#endif

template <bool LANE_COST, typename JT, class TA, bool BM = false, bool REG = false>
static void launch(const TA& T, const LSParams* P,
                   const float* coeffs, const float* x0T, const float* xsT,
                   const float* usT, const float* KsT, const float* ksT,
                   const float* qdT, const float* rdT, const float* fdT,
                   const float* obj0, const float* lin, const float* quad,
                   const uint8_t* ks_small, const uint8_t* act,
                   const void* old_jac, float* stash, float* out_xs,
                   float* out_us, float* out_obj, uint8_t* out_succ,
                   uint8_t* out_fail, void* out_jac, float* out_du2, int H,
                   int B, int lanes_per_block, cudaStream_t s,
                   const RegParams* R = nullptr, const float* regw = nullptr,
                   float* out_ju = nullptr) {
  const int threads = lanes_per_block * P->L;
  const unsigned blocks = (unsigned)((B + lanes_per_block - 1) / lanes_per_block);
  const RegParams none = {};
  fused_ls_kernel<AMPC_DS, LANE_COST, JT, TA, BM, REG><<<blocks, threads, 0, s>>>(
      T, *P, coeffs, x0T, xsT, usT, KsT, ksT, qdT, rdT, fdT, obj0, lin,
      quad, ks_small, act, (const JT*)old_jac, stash, out_xs, out_us, out_obj,
      out_succ, out_fail, (JT*)out_jac, out_du2, H, B, R ? *R : none, regw, out_ju);
}

static int fused_check(int n, int max_n, const LSParams* P, int ds, int H,
                       int B, int lanes_per_block, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ds != AMPC_DS || n < 1 || n > max_n || P->L < 1 || P->L > AMPC_MAX_L ||
      P->obsdim < 1 || P->obsdim > ds || H < 1 || B < 1 || lanes_per_block < 1 ||
      lanes_per_block * P->L > AMPC_LS_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// qdT/rdT/fdT: per-lane cost planes, or all three null for the fixed
// cost held in P. jac_bf16: old_jac and out_jac are bfloat16, else float.
// stash: H (ds+1) L B floats of scratch. lanes_per_block x L threads a
// block (the wrapper's fused_geometry).
extern "C" int ampc_fused_line_search(
    const FeatTable* T, const LSParams* P, const float* coeffs,
    const float* x0T, const float* xsT, const float* usT, const float* KsT,
    const float* ksT, const float* qdT, const float* rdT, const float* fdT,
    const float* obj0, const float* lin, const float* quad,
    const uint8_t* ks_small, const uint8_t* act, const void* old_jac,
    float* stash, float* out_xs, float* out_us, float* out_obj,
    uint8_t* out_succ, uint8_t* out_fail, void* out_jac, float* out_du2,
    int jac_bf16, int ds, int H, int B, int lanes_per_block, int device,
    void* stream) {
  const int rc = fused_check(T->n, AMPC_MAX_F, P, ds, H, B, lanes_per_block, device);
  if (rc) return rc;
  const bool lane = qdT != nullptr;
  if (T->d != ds + 1 || (rdT != nullptr) != lane || (fdT != nullptr) != lane)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define AMPC_LAUNCH(LC, JT_)                                                  \
  launch<LC, JT_>(*T, P, coeffs, x0T, xsT, usT, KsT, ksT, qdT, rdT, fdT, obj0, \
                  lin, quad, ks_small, act, old_jac, stash, out_xs, out_us,    \
                  out_obj, out_succ, out_fail, out_jac, out_du2, H, B,         \
                  lanes_per_block, s)
  if (lane && jac_bf16)
    AMPC_LAUNCH(true, __nv_bfloat16);
  else if (lane)
    AMPC_LAUNCH(true, float);
  else if (jac_bf16)
    AMPC_LAUNCH(false, __nv_bfloat16);
  else
    AMPC_LAUNCH(false, float);
#undef AMPC_LAUNCH
  return (int)cudaGetLastError();
}

// The same with per-lane coefficients (a lanes-last (ds, n, B) plane),
// the device table Tdev of n terms (up to AMPC_MAX_F_BIG), per-lane cost
// planes and a float Jacobian carry (the joint fan-out's form): trees of
// AMPC_TREE_SLOTS slots up to AMPC_MAX_F terms, else AMPC_TREE_SLOTS_BIG.
extern "C" int ampc_fused_line_search_lane(
    const FeatTableBig* Tdev, int n, const LSParams* P, const float* coeffs,
    const float* x0T, const float* xsT, const float* usT, const float* KsT,
    const float* ksT, const float* qdT, const float* rdT, const float* fdT,
    const float* obj0, const float* lin, const float* quad,
    const uint8_t* ks_small, const uint8_t* act, const void* old_jac,
    float* stash, float* out_xs, float* out_us, float* out_obj,
    uint8_t* out_succ, uint8_t* out_fail, void* out_jac, float* out_du2, int ds,
    int H, int B, int lanes_per_block, int device, void* stream) {
  const int rc =
      fused_check(n, AMPC_MAX_F_BIG, P, ds, H, B, lanes_per_block, device);
  if (rc) return rc;
  if (qdT == nullptr || rdT == nullptr || fdT == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define AMPC_LAUNCH(S_)                                                       \
  launch<true, float>(FeatTableRef<S_>{Tdev, n}, P, coeffs, x0T, xsT, usT, KsT, \
                      ksT, qdT, rdT, fdT, obj0, lin, quad, ks_small, act,      \
                      old_jac, stash, out_xs, out_us, out_obj, out_succ,       \
                      out_fail, out_jac, out_du2, H, B, lanes_per_block, s)
  if (n <= AMPC_MAX_F)
    AMPC_LAUNCH(AMPC_TREE_SLOTS);
  else
    AMPC_LAUNCH(AMPC_TREE_SLOTS_BIG);
#undef AMPC_LAUNCH
  return (int)cudaGetLastError();
}

// The batch-major entry (BM): x0 (B, ds), xs (B, H+1, ds), us (B, H),
// Ks (B, H, ds), ks (B, H) in; out_xs (B, H+1, ds), out_us (B, H), obj,
// success, failure, du2, out_jx (B, H, ds, ds) and out_ju (B, H, ds), no
// carry select; per-lane cost planes qdT/fdT (obsdim, B), rdT (1, B). R
// and regw (B,) both set: the GaussReg instance (REG), both null: none.
extern "C" int ampc_fused_line_search_bm(
    const FeatTable* T, const LSParams* P, const RegParams* R, const float* coeffs,
    const float* x0, const float* xs, const float* us, const float* Ks,
    const float* ks, const float* qdT, const float* rdT, const float* fdT,
    const float* obj0, const float* lin, const float* quad,
    const uint8_t* ks_small, const float* regw, float* stash, float* out_xs,
    float* out_us, float* out_obj, uint8_t* out_succ, uint8_t* out_fail,
    float* out_jx, float* out_ju, float* out_du2, int ds, int H, int B,
    int lanes_per_block, int device, void* stream) {
  const int rc = fused_check(T->n, AMPC_MAX_F, P, ds, H, B, lanes_per_block, device);
  if (rc) return rc;
  if (T->d != ds + 1 || !qdT || !rdT || !fdT || (R != nullptr) != (regw != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define AMPC_LAUNCH(REG_)                                                      \
  launch<true, float, FeatTable, true, REG_>(                                   \
      *T, P, coeffs, x0, xs, us, Ks, ks, qdT, rdT, fdT, obj0, lin, quad,         \
      ks_small, nullptr, nullptr, stash, out_xs, out_us, out_obj, out_succ,      \
      out_fail, out_jx, out_du2, H, B, lanes_per_block, s, R, regw, out_ju)
  if (R)
    AMPC_LAUNCH(true);
  else
    AMPC_LAUNCH(false);
#undef AMPC_LAUNCH
  return (int)cudaGetLastError();
}

// The batch-major entry with per-lane coefficients (a lanes-last (ds, n, B)
// plane, the device table Tdev of n <= AMPC_MAX_F terms, trees of
// AMPC_TREE_SLOTS slots).
extern "C" int ampc_fused_line_search_bm_lane(
    const FeatTableBig* Tdev, int n, const LSParams* P, const RegParams* R,
    const float* coeffs, const float* x0, const float* xs, const float* us,
    const float* Ks, const float* ks, const float* qdT, const float* rdT,
    const float* fdT, const float* obj0, const float* lin, const float* quad,
    const uint8_t* ks_small, const float* regw, float* stash, float* out_xs,
    float* out_us, float* out_obj, uint8_t* out_succ, uint8_t* out_fail,
    float* out_jx, float* out_ju, float* out_du2, int ds, int H, int B,
    int lanes_per_block, int device, void* stream) {
  const int rc = fused_check(n, AMPC_MAX_F, P, ds, H, B, lanes_per_block, device);
  if (rc) return rc;
  if (!qdT || !rdT || !fdT || (R != nullptr) != (regw != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define AMPC_LAUNCH(REG_)                                                      \
  launch<true, float, FeatTableRef<AMPC_TREE_SLOTS>, true, REG_>(               \
      FeatTableRef<AMPC_TREE_SLOTS>{Tdev, n}, P, coeffs, x0, xs, us, Ks, ks, qdT, \
      rdT, fdT, obj0, lin, quad, ks_small, nullptr, nullptr, stash, out_xs,      \
      out_us, out_obj, out_succ, out_fail, out_jx, out_du2, H, B,                \
      lanes_per_block, s, R, regw, out_ju)
  if (R)
    AMPC_LAUNCH(true);
  else
    AMPC_LAUNCH(false);
#undef AMPC_LAUNCH
  return (int)cudaGetLastError();
}

#ifdef AMPC_LS_MAIN_LIBRARY
// The batch-major instances' registers, local bytes and resident blocks
// an SM at `threads` a block (out[0..2]): shared (lane_coef 0) or per-lane
// (1) coefficients, without (reg 0) or with (1) the GaussReg term.
extern "C" int ampc_fused_line_search_bm_occupancy(int lane_coef, int reg, int threads,
                                                   int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  typedef FeatTableRef<AMPC_TREE_SLOTS> Ref;
  const void* f =
      lane_coef ? (reg ? (const void*)fused_ls_kernel<4, true, float, Ref, true, true>
                       : (const void*)fused_ls_kernel<4, true, float, Ref, true, false>)
                : (reg ? (const void*)fused_ls_kernel<4, true, float, FeatTable, true, true>
                       : (const void*)fused_ls_kernel<4, true, float, FeatTable, true, false>);
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, f);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, threads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return 0;
}

// The compiled instance's registers and local (spill) bytes a thread, and
// its resident blocks an SM at `threads` a block: out[0..2]. lane_coef
// picks a per-lane-coefficient instance (per-lane cost, float carry) with
// the small (1) or the large (2) trees.
extern "C" int ampc_fused_line_search_occupancy(int lane_cost, int jac_bf16,
                                                int lane_coef, int threads,
                                                int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* f =
      lane_coef == 1
          ? (const void*)fused_ls_kernel<4, true, float, FeatTableRef<AMPC_TREE_SLOTS>>
      : lane_coef == 2
          ? (const void*)fused_ls_kernel<4, true, float, FeatTableRef<AMPC_TREE_SLOTS_BIG>>
      : lane_cost ? (jac_bf16 ? (const void*)fused_ls_kernel<4, true, __nv_bfloat16>
                              : (const void*)fused_ls_kernel<4, true, float>)
                  : (jac_bf16 ? (const void*)fused_ls_kernel<4, false, __nv_bfloat16>
                              : (const void*)fused_ls_kernel<4, false, float>);
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, f);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, threads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return 0;
}
#endif
