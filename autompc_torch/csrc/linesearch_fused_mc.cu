// K3 at dc > 1: the fused iLQR line search with acceptance and
// relinearization on the batch-major carry of a multi-control
// linear-in-features model (the halfcheetah's SINDy at (18, 6)).
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_linesearch.py:
// _fused_kernel, entry pallas_fused_line_search with ll_io=False,
// grad_terms and any dc (the iLQR body's fused search when fuse_ls is set,
// the model has a feature_spec and the cost is quadratic,
// autompc_tpu/control/ilqr.py:1102-1142). Per lane, for every step size
// alpha_l:
//   u_j = clip(alpha k_j + ubar_j + sum_i K_ji (x_i - xbar_i), umin_j, umax_j)
//         for each control j, its own bounds and its own feedback row;
//   obj += dt (q-form(x - g) + r-form(u) [+ w (x - mu)' S (x - mu)]),
//   x <- coeffs @ features([x, u]); obj += f-form(x_H - g);
// then the reference acceptance rule, and the chosen rollout written with
// its Jacobians Jx (B, H, ds, ds) and Ju (B, H, ds, dc) along it. The cost
// forms are the TPU kernel's: per-lane diagonals (Q/F (obsdim, B), R (dc,
// B) lanes-last planes, each form the balanced tree of M_i v_i v_i) or one
// fixed dense cost (``dense``: Q, F obsdim x obsdim, R dc x dc, each form
// the tree of M_ij v_i v_j over all entries in row order), and the
// GaussReg term (``reg``, per-lane costs: S's upper triangle with the
// off-diagonal entries doubled, in row order, weight w_b); the two are
// run-time switches of one instance a table type. The feedback sum
// of each control and the cost forms are the balanced tree of features.cuh;
// du2 adds the tree over the controls of (u_j - ubar_j)^2 a step, in a
// left fold over the steps.
//
// Design: K3's (linesearch_fused.cu): a thread per (lane, step size), NL
// lanes x L step sizes a block (fused_geometry), each candidate's states
// and controls stashed in scratch (H, ds+dc, L, B) floats, the acceptance
// by thread l = 0 of each lane, then the lane's L threads write the
// chosen rollout and its Jacobian columns in parallel over the steps. The
// shared coefficient plane, the dense cost and the GaussReg matrix sit in
// dynamic shared memory (fused_mc_smem in ops/cuda_linesearch.py mirrors
// the layout). A thread reads its lane's carry rows at a stride of a
// lane's row length: the simple form.
//
// What bounds it on an H100: arithmetic: per lane and step each candidate
// evaluates the active terms and the dc feedback sums and cost forms (at
// obsdim 18 the dense forms are 324 terms), against (ds + dc) (1 + ds)
// floats in a step. At (18, 6) a candidate's ds trees and state take
// more than a thread's 255 registers: the compiler spills (its report is
// in the build log); a later PR splits a candidate over a group of
// threads, as K7 does.
//
// Built only at first use at a shape with dc > 1 (-DAMPC_DS, -DAMPC_DC;
// ops/_build.py: shape_library); the main library leaves it out
// (_build.main_sources: the source has no prebuilt shape). The
// dc = 1 instances are linesearch_fused.cu's, whose bits this file does
// not touch.
#include "features.cuh"

#define AMPC_MC_MAX_L 10
#define AMPC_MC_MAX_THREADS 256
// Slots of the cost forms' trees: obsdim^2 <= 23^2 terms.
#define AMPC_MC_FORM_SLOTS 10

// The step sizes, each control's bounds, the goal and the constants.
struct LSParamsMC {
  int L;
  int obsdim;
  float alphas[AMPC_MC_MAX_L];
  float umin[AMPC_MAX_D], umax[AMPC_MAX_D];
  float goal[AMPC_MAX_D];
  float dt;
  float thresh;
};

typedef TreeAccT<AMPC_MC_FORM_SLOTS> McFormAcc;

#if defined(AMPC_DS) && AMPC_DC > 1

// Floats of dynamic shared memory before the per-thread reductions:
// the shared coefficient plane (DS n, none with per-lane coefficients),
// the dense Q, R, F (dense cost) or S and mu (GaussReg), each region a
// multiple of 4 floats (ops/cuda_linesearch.py: fused_mc_smem).
__host__ __device__ constexpr int mc_up4(int n) { return (n + 3) / 4 * 4; }

// The cost forms walk their terms in run-time loops over a copy of the
// state in local memory (n = obsdim or dc entries, v[i] the offset
// entry): unrolled over the cheetah's 18 x 18 dense terms they made each
// instance's build take minutes. Each term is pushed into the balanced
// tree in the TPU kernel's order.
// sum_i w_i v_i v_i, w a lanes-last plane (row i at w + i B) of lane b.
__device__ __forceinline__ float mc_diag_form(const float* v, int n, const float* w, int B,
                                              int b) {
  McFormAcc acc;
  for (int i = 0; i < n; ++i) acc.push(w[(long long)i * B + b] * v[i] * v[i], i);
  return acc.total(n);
}

// sum_ij (M_ij v_i) v_j over every entry in row order, M n x n row-major
// (shared memory); ``upper``: i <= j only (the GaussReg form, M holding
// S_ij on the diagonal and 2 S_ij above it).
__device__ __forceinline__ float mc_dense_form(const float* v, int n, const float* M,
                                               bool upper) {
  McFormAcc acc;
  int k = 0;
  for (int i = 0; i < n; ++i)
    for (int j = upper ? i : 0; j < n; ++j)
      acc.push(__fmul_rn(__fmul_rn(M[i * n + j], v[i]), v[j]), k++);
  return acc.total(k);
}

// dense: one fixed dense cost (else per-lane diagonal planes); reg: the
// GaussReg term (per-lane costs only): run-time switches, uniform across
// the grid.
template <int DS, int DC, class TA>
__global__ void __launch_bounds__(AMPC_MC_MAX_THREADS)
    fused_ls_mc_kernel(const __grid_constant__ TA T, const __grid_constant__ LSParamsMC P,
                       const float* __restrict__ coeffs, const float* __restrict__ x0,
                       const float* __restrict__ xs, const float* __restrict__ us,
                       const float* __restrict__ Ks, const float* __restrict__ ks,
                       const float* __restrict__ qd, const float* __restrict__ rd,
                       const float* __restrict__ fd, const float* __restrict__ regS,
                       const float* __restrict__ regmu, const float* __restrict__ regw,
                       const float* __restrict__ obj0_in, const float* __restrict__ lin_in,
                       const float* __restrict__ quad_in,
                       const uint8_t* __restrict__ ks_small_in, float* stash,
                       float* __restrict__ out_xs, float* __restrict__ out_us,
                       float* __restrict__ out_obj, uint8_t* __restrict__ out_succ,
                       uint8_t* __restrict__ out_fail, float* __restrict__ out_jx,
                       float* __restrict__ out_ju, float* __restrict__ out_du2, int H,
                       int B, int dense, int reg) {
  constexpr bool LANE = AmpcTableTraits<TA>::lane;
  constexpr int S = AmpcTableTraits<TA>::slots;
  constexpr int D = DS + DC;
  extern __shared__ float4 mc_smem[];
  const int o = P.obsdim;
  float* sm = reinterpret_cast<float*>(mc_smem);
  float* s_coef = sm;
  sm += LANE ? 0 : mc_up4(DS * AMPC_MAX_F);
  // Dense cost: Q, R, F; GaussReg: cS, mu.
  float* s_q = sm;
  float* s_r = s_q + mc_up4(o * o);
  float* s_f = s_r + mc_up4(DC * DC);
  float* s_mu = s_q + mc_up4(o * o);
  sm += dense ? 2 * mc_up4(o * o) + mc_up4(DC * DC) : reg ? mc_up4(o * o) + mc_up4(o) : 0;
  float* s_obj = sm;
  float* s_du2 = s_obj + AMPC_MC_MAX_THREADS;
  int* s_pick = reinterpret_cast<int*>(s_du2 + AMPC_MC_MAX_THREADS);
  if (dense) {
    for (int e = threadIdx.x; e < o * o; e += blockDim.x) {
      s_q[e] = qd[e];
      s_f[e] = fd[e];
    }
    for (int e = threadIdx.x; e < DC * DC; e += blockDim.x) s_r[e] = rd[e];
  }
  if (reg) {
    for (int e = threadIdx.x; e < o * o; e += blockDim.x) s_q[e] = regS[e];
    for (int e = threadIdx.x; e < o; e += blockDim.x) s_mu[e] = regmu[e];
  }
  if constexpr (!LANE)
    for (int e = threadIdx.x; e < DS * T.n; e += blockDim.x) s_coef[e] = coeffs[e];
  __syncthreads();

  const int L = P.L;
  const int NL = blockDim.x / L;
  const int l = threadIdx.x / NL;
  const int jl = threadIdx.x - l * NL;
  const int b = blockIdx.x * NL + jl;
  const bool valid = b < B;
  const long long LB = (long long)L * B;
  auto coef_lane = [&]() { return CoefLane{coeffs + b, T.n, B}; };

  // ---- candidate l of lane b: rollout, objective, du2, stash ----------
  float x0v[DS];
  float obj = 0.f, du2 = 0.f;
  if (valid) {
    float x[DS];
#pragma unroll
    for (int i = 0; i < DS; ++i) x[i] = x0v[i] = x0[(long long)b * DS + i];
    const float alpha = P.alphas[l];
    const float rw = reg ? regw[b] : 0.f;
    float v[AMPC_MAX_D];  // a copy of x - g (or of u) the cost forms index at run time
    float* st = stash + (long long)l * B + b;
    for (int t = 0; t < H; ++t) {
      const long long bt = (long long)b * H + t;
      const float* xbar = xs + ((long long)b * (H + 1) + t) * DS;
      float dx[DS];
#pragma unroll
      for (int i = 0; i < DS; ++i) dx[i] = x[i] - xbar[i];
      float u[DC];
      TreeAcc dacc;
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float* Kj = Ks + (bt * DC + j) * DS;
        TreeAcc fb;
#pragma unroll
        for (int i = 0; i < DS; ++i) fb.push(Kj[i] * dx[i], i);
        const float ubar = us[bt * DC + j];
        const float uj = alpha * ks[bt * DC + j] + ubar + fb.total(DS);
        // Comparisons: a NaN control (NaN gains) stays NaN.
        u[j] = uj < P.umin[j] ? P.umin[j] : (uj > P.umax[j] ? P.umax[j] : uj);
        const float du = u[j] - ubar;
        dacc.push(du * du, j);
      }
      du2 = du2 + dacc.total(DC);
#pragma unroll
      for (int i = 0; i < DS; ++i) v[i] = x[i] - P.goal[i];
      float oc = dense ? mc_dense_form(v, o, s_q, false) : mc_diag_form(v, o, qd, B, b);
      if (reg) {
#pragma unroll
        for (int i = 0; i < DS; ++i) v[i] = x[i] - s_mu[i < o ? i : 0];
        oc = __fadd_rn(oc, __fmul_rn(rw, mc_dense_form(v, o, s_q, true)));
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) v[j] = u[j];
      const float cc = dense ? mc_dense_form(v, DC, s_r, false) : mc_diag_form(v, DC, rd, B, b);
      obj = obj + P.dt * (oc + cc);
      float z[D];
#pragma unroll
      for (int i = 0; i < DS; ++i) z[i] = x[i];
#pragma unroll
      for (int j = 0; j < DC; ++j) z[DS + j] = u[j];
      if constexpr (LANE)
        ampc_dynamics_cv<DS, D, S>(ampc_table(T), coef_lane(), z, x);
      else
        ampc_dynamics_cv<DS, D, S>(T, CoefShared{s_coef, T.n}, z, x);
      float* row = st + (long long)t * D * LB;
#pragma unroll
      for (int i = 0; i < DS; ++i) row[i * LB] = x[i];
#pragma unroll
      for (int j = 0; j < DC; ++j) row[(DS + j) * LB] = u[j];
    }
#pragma unroll
    for (int i = 0; i < DS; ++i) v[i] = x[i] - P.goal[i];
    obj = obj + (dense ? mc_dense_form(v, o, s_f, false) : mc_diag_form(v, o, fd, B, b));
  }
  s_obj[threadIdx.x] = obj;
  s_du2[threadIdx.x] = du2;
  __syncthreads();

  // ---- acceptance, one thread per lane (the reference rule) ------------
  if (l == 0 && valid) {
    float objs[AMPC_MC_MAX_L];
#pragma unroll
    for (int m = 0; m < AMPC_MC_MAX_L; ++m) objs[m] = m < L ? s_obj[m * NL + jl] : 0.f;
    const float obj0 = obj0_in[b];
    const float lin = lin_in[b];
    const float quad = quad_in[b];
    const bool ks_small = ks_small_in[b] != 0;
    int first_acc = L;
    int best = 0;
    float best_val = objs[0];
#pragma unroll
    for (int m = AMPC_MC_MAX_L - 1; m >= 0; --m) {
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
    for (int m = 1; m < AMPC_MC_MAX_L; ++m) {
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
    for (int m = 1; m < AMPC_MC_MAX_L; ++m) {
      if (m == chosen) chosen_obj = objs[m];
      if (m == idx_last) last_obj = objs[m];
    }
    const bool success = (chosen_obj < obj0) || ks_small;
    const bool failed = !success && (last_obj > obj0 + 1e-3f);
    const int sel = success ? chosen : idx_last;
    out_obj[b] = success ? chosen_obj : last_obj;
    out_succ[b] = success ? 1 : 0;
    out_fail[b] = failed ? 1 : 0;
    out_du2[b] = s_du2[sel * NL + jl];
    s_pick[jl] = sel;
  }
  __syncthreads();
  if (!valid) return;

  // ---- the chosen rollout and its Jacobians, in parallel over t -------
  const float* sw = stash + (long long)s_pick[jl] * B + b;
  if (l == 0) {
#pragma unroll
    for (int i = 0; i < DS; ++i) out_xs[(long long)b * (H + 1) * DS + i] = x0v[i];
  }
  for (int t = l; t < H; t += L) {
    const float* row = sw + (long long)t * D * LB;
    float z[D];
#pragma unroll
    for (int i = 0; i < DS; ++i) z[i] = t == 0 ? x0v[i] : row[(i - D) * LB];
#pragma unroll
    for (int j = 0; j < DC; ++j) z[DS + j] = row[(DS + j) * LB];
    const long long bt = (long long)b * H + t;
#pragma unroll
    for (int i = 0; i < DS; ++i) out_xs[(bt + b + 1) * DS + i] = row[i * LB];
#pragma unroll
    for (int j = 0; j < DC; ++j) out_us[bt * DC + j] = z[DS + j];
    if (out_jx == nullptr) continue;  // relin="xla": no Jacobians
    for (int dd = 0; dd < D; ++dd) {
      float col[DS];
      if constexpr (LANE)
        ampc_jac_col_cv<DS, D, S>(ampc_table(T), coef_lane(), z, dd, col);
      else
        ampc_jac_col_cv<DS, D, S>(T, CoefShared{s_coef, T.n}, z, dd, col);
#pragma unroll
      for (int i = 0; i < DS; ++i) {
        if (dd < DS)
          out_jx[(bt * DS + i) * DS + dd] = col[i];
        else
          out_ju[(bt * DS + i) * DC + (dd - DS)] = col[i];
      }
    }
  }
}

template <class TA>
static int mc_launch(const TA& T, const LSParamsMC* P, int dense, const float* qd,
                     const float* rd, const float* fd, const float* regS, const float* regmu,
                     const float* regw, const float* coeffs, const float* x0, const float* xs,
                     const float* us, const float* Ks, const float* ks, const float* obj0,
                     const float* lin, const float* quad, const uint8_t* ks_small,
                     float* stash, float* out_xs, float* out_us, float* out_obj,
                     uint8_t* out_succ, uint8_t* out_fail, float* out_jx, float* out_ju,
                     float* out_du2, int H, int B, int lanes, int smem, cudaStream_t s) {
  auto kernel = fused_ls_mc_kernel<AMPC_DS, AMPC_DC, TA>;
  static int allowed = 48 * 1024;  // dynamic shared memory opted into
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const unsigned blocks = (unsigned)((B + lanes - 1) / lanes);
  kernel<<<blocks, lanes * P->L, smem, s>>>(
      T, *P, coeffs, x0, xs, us, Ks, ks, qd, rd, fd, regS, regmu, regw, obj0, lin, quad,
      ks_small, stash, out_xs, out_us, out_obj, out_succ, out_fail, out_jx, out_ju,
      out_du2, H, B, dense, regS != nullptr);
  return (int)cudaGetLastError();
}

// The batch-major entry at dc > 1. T: the table by value (shared
// coefficients, (ds, n) plane), or Tdev (per-lane coefficients, a
// lanes-last (ds, n, B) plane, the device table of n terms). dense 0:
// per-lane diagonal planes qd/fd (obsdim, B), rd (dc, B); dense 1: one
// fixed dense cost Q/F (obsdim^2), R (dc^2) in device memory. regS
// (obsdim^2: S_ij on the diagonal, 2 S_ij above it), regmu (obsdim) and
// regw (B,) all set: the GaussReg term (per-lane costs only). out_jx and
// out_ju both null: no Jacobians. smem: the wrapper's fused_mc_smem.
extern "C" int ampc_fused_line_search_mc(
    const FeatTable* T, const FeatTableBig* Tdev, int n, const LSParamsMC* P, int dense,
    const float* qd, const float* rd, const float* fd, const float* regS,
    const float* regmu, const float* regw, const float* coeffs, const float* x0,
    const float* xs, const float* us, const float* Ks, const float* ks, const float* obj0,
    const float* lin, const float* quad, const uint8_t* ks_small, float* stash,
    float* out_xs, float* out_us, float* out_obj, uint8_t* out_succ, uint8_t* out_fail,
    float* out_jx, float* out_ju, float* out_du2, int ds, int dc, int H, int B,
    int lanes_per_block, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool lane = Tdev != nullptr;
  const bool reg = regS != nullptr;
  if (ds != AMPC_DS || dc != AMPC_DC || n < 1 || n > (lane ? AMPC_MAX_F_BIG : AMPC_MAX_F) ||
      (!lane && (T == nullptr || T->d != ds + dc || T->n != n)) || P->L < 1 ||
      P->L > AMPC_MC_MAX_L || P->obsdim < 1 || P->obsdim > ds || H < 1 || B < 1 ||
      lanes_per_block < 1 || lanes_per_block * P->L > AMPC_MC_MAX_THREADS || !qd || !rd ||
      !fd || (reg && (dense || !regmu || !regw)) ||
      (out_jx != nullptr) != (out_ju != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define AMPC_MC(TA_, T_)                                                             \
  return mc_launch<TA_>(T_, P, dense, qd, rd, fd, regS, regmu, regw, coeffs, x0, xs, us, \
                        Ks, ks, obj0, lin, quad, ks_small, stash, out_xs, out_us, out_obj, \
                        out_succ, out_fail, out_jx, out_ju, out_du2, H, B, lanes_per_block, \
                        smem, s)
  if (!lane) {
    AMPC_MC(FeatTable, *T);
  } else if (n <= AMPC_MAX_F) {
    typedef FeatTableRef<AMPC_TREE_SLOTS> Ref;
    AMPC_MC(Ref, (Ref{Tdev, n}));
  } else {
    typedef FeatTableRef<AMPC_TREE_SLOTS_BIG> RefBig;
    AMPC_MC(RefBig, (RefBig{Tdev, n}));
  }
#undef AMPC_MC
  return (int)cudaErrorInvalidValue;
}

#endif  // AMPC_DS && AMPC_DC > 1
