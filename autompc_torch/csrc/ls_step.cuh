// The per-step arithmetic of the dc=1 line search for linear-in-features
// models under a diagonal quadratic cost, written once and shared by the
// fused kernel (linesearch_fused.cu, K3) and the objective sweep of the
// split line search (ls_obj_wide.cu, K8):
//   ls_obj_step   one step of one candidate rollout with its stage cost;
//   ls_candidate  a whole candidate: the rollout of one (lane, step size)
//                 from x0 with its objective and du2, every state and
//                 control kept in the scratch stash (H, ds+1, L, B).
// The control comes from ls_control and the next state from
// ampc_dynamics (features.cuh). Written once, the kernels compile to the
// same instructions for the same inputs (FMA contraction included), so
// K3's candidate threads and K8 roll, score and stash the same trajectory
// for the same step size; the split search's re-roll kernel (K9,
// ls_reroll_wide.cu) reads the selected candidate back from K8's stash
// and takes its Jacobians with ampc_jac_col as K3 does, so the split
// search returns what the fused kernel returns wherever the two choose
// the same step size.
//
// The fused kernel also rolls the batch-major carry (BM: x0 (B, ds), xs
// (B, H+1, ds), us/ks (B, H), Ks (B, H, ds), the TPU entry's
// ll_io=False), adds the GaussReg stage term (REG, ls_reg_form) and takes
// one fixed dense cost (DENSE, ls_dense_form: the TPU entry's
// per_lane_diag_cost=False with a Q or F that is not diagonal); all are
// template switches that leave the lanes-last, no-reg instances' code as
// it was.
//
// Orders follow autompc_tpu/ops/pallas_linesearch.py (_fused_kernel,
// _ls_obj_kernel_wide, _ls_reroll_kernel_wide): the feedback sum and the
// quadratic forms are the balanced tree of features.cuh, the stage cost
// is dt * ((x-g)'Q(x-g) + R u^2) with R u^2 = (R u) u, du2 is the left
// fold of (u_t - ubar_t)^2 over t, and the clip is written with
// comparisons so that a NaN control (NaN gains) stays NaN.
#pragma once

#include "features.cuh"
#include "jac_io.cuh"

#define AMPC_MAX_L 10
#define AMPC_MAX_OBS 8
// Threads of a K3 or K8 block: lanes per block x step sizes (the
// wrappers' fused_geometry).
#define AMPC_LS_MAX_THREADS 256

struct LSParams {
  int L;
  int obsdim;
  float alphas[AMPC_MAX_L];
  float umin, umax;
  float qd[AMPC_MAX_OBS];  // diag Q
  float rd;                // R (dc = 1)
  float fd[AMPC_MAX_OBS];  // diag F
  float goal[AMPC_MAX_OBS];
  float dt;
  float thresh;  // expected-reduction acceptance threshold
};

// The GaussReg term of a stage: w (x - mu)' S (x - mu) with S shared,
// summed over the upper triangle of S (cS holds S_ij for i == j and
// 2 S_ij off the diagonal, exact doublings, row-major with row stride
// AMPC_MAX_OBS) and mu shared; the weight w is the lane's.
struct RegParams {
  float cS[AMPC_MAX_OBS * AMPC_MAX_OBS];
  float mu[AMPC_MAX_OBS];
};

template <int DS>
__device__ __forceinline__ float ls_control(const LSParams& P,
                                            const float (&x)[DS],
                                            const float (&xbar)[DS],
                                            const float (&K)[DS], float ubar,
                                            float kk, float alpha) {
  TreeAcc fb;
#pragma unroll
  for (int i = 0; i < DS; ++i) fb.push(K[i] * (x[i] - xbar[i]), i);
  const float u = alpha * kk + ubar + fb.total(DS);
  // Comparisons, not fminf/fmaxf: a NaN control (NaN gains) stays NaN,
  // as in the plain version, and the lane then fails its line search.
  return u < P.umin ? P.umin : (u > P.umax ? P.umax : u);
}

// Balanced sum over the obs dims of w_i (x_i - g_i)^2; w is P.qd / P.fd
// or the lane's own diagonal in registers. The TPU's fixed-cost form sums
// w_ij (x_i - g_i)(x_j - g_j) over all obsdim^2 entries of the full
// matrices; the off-diagonal zeros add exactly, so the two differ only in
// the pairing of the tree (by rounding), and not at all for obsdim = 4.
template <int DS>
__device__ __forceinline__ float ls_quad_form(const LSParams& P,
                                              const float (&x)[DS],
                                              const float* w) {
  TreeAcc acc;
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    if (i < P.obsdim) {
      const float d = x[i] - P.goal[i];
      acc.push(w[i] * d * d, i);
    }
  }
  return acc.total(P.obsdim);
}

// (x - g)' M (x - g) for a dense M (obsdim x obsdim, row-major, in shared
// memory): the terms (M_ij (x_i - g_i)) (x_j - g_j) over every (i, j) in
// row order, each product rounded on its own, into the balanced tree (the
// TPU kernel's quad_form of a full matrix).
template <int DS>
__device__ __forceinline__ float ls_dense_form(const LSParams& P,
                                               const float (&x)[DS],
                                               const float* M) {
  TreeAcc acc;
  int k = 0;
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    if (i < P.obsdim) {
      const float di = x[i] - P.goal[i];
#pragma unroll
      for (int j = 0; j < DS; ++j) {
        if (j < P.obsdim) {
          const float dj = x[j] - P.goal[j];
          acc.push(__fmul_rn(__fmul_rn(M[i * P.obsdim + j], di), dj), k);
          ++k;
        }
      }
    }
  }
  return acc.total(k);
}

// (x - mu)' S (x - mu) over the obs dims: the terms cS_ij (x_i - mu_i)
// (x_j - mu_j) for i <= j in row order, each product rounded on its own,
// into the balanced tree (the TPU kernel's reg_terms and _tree_sum).
template <int DS>
__device__ __forceinline__ float ls_reg_form(const LSParams& P,
                                             const RegParams& R,
                                             const float (&x)[DS]) {
  TreeAcc acc;
  int k = 0;
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    if (i < P.obsdim) {
      const float di = x[i] - R.mu[i];
#pragma unroll
      for (int j = i; j < DS; ++j) {
        if (j < P.obsdim) {
          const float dj = x[j] - R.mu[j];
          acc.push(__fmul_rn(__fmul_rn(R.cS[i * AMPC_MAX_OBS + j], di), dj), k);
          ++k;
        }
      }
    }
  }
  return acc.total(k);
}

// The lane's carry row at step t: xbar, K (DS each), ubar, k.
template <int DS>
__device__ __forceinline__ void ls_load_row(const float* xsT,
                                            const float* usT,
                                            const float* KsT,
                                            const float* ksT, int t, int B,
                                            int b, float (&xbar)[DS],
                                            float (&K)[DS], float& ubar,
                                            float& kk) {
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    xbar[i] = xsT[((long long)t * DS + i) * B + b];
    K[i] = KsT[((long long)t * DS + i) * B + b];
  }
  ubar = usT[(long long)t * B + b];
  kk = ksT[(long long)t * B + b];
}

// The same row of the batch-major carry: xs (B, H+1, DS), Ks (B, H, DS),
// us and ks (B, H).
template <int DS>
__device__ __forceinline__ void ls_load_row_bm(const float* xs,
                                               const float* us,
                                               const float* Ks,
                                               const float* ks, int t, int H,
                                               int b, float (&xbar)[DS],
                                               float (&K)[DS], float& ubar,
                                               float& kk) {
  const long long bt = (long long)b * H + t;
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    xbar[i] = xs[((long long)b * (H + 1) + t) * DS + i];
    K[i] = Ks[bt * DS + i];
  }
  ubar = us[bt];
  kk = ks[bt];
}

// One step of a candidate rollout: u = clip(alpha k + ubar + K (x - xbar)),
// obj += dt (q-form(x) + R u^2), x <- coeffs @ features([x, u]); returns u.
// The coefficients come from cv (features.cuh: CoefShared, CoefLane), the
// feature sum over a tree of S slots. REG adds rw times the GaussReg form
// to the state cost, oc + rw r as the TPU kernel adds it, rounded on its
// own: with rw = 0 the state cost, and so the objective, is the no-reg
// instance's to the bit. DENSE: wq is the dense Q (ls_dense_form).
template <int DS, int S, bool REG = false, bool DENSE = false, class TT, class CV>
__device__ __forceinline__ float ls_obj_step_cv(
    const TT& T, CV cv, const LSParams& P, float (&x)[DS],
    const float (&xbar)[DS], const float (&K)[DS], float ubar, float kk,
    float alpha, const float* wq, float rd, float& obj,
    const RegParams* R = nullptr, float rw = 0.f) {
  constexpr int D = DS + 1;
  const float u = ls_control<DS>(P, x, xbar, K, ubar, kk, alpha);
  float oc = DENSE ? ls_dense_form<DS>(P, x, wq) : ls_quad_form<DS>(P, x, wq);
  if constexpr (REG) oc = __fadd_rn(oc, __fmul_rn(rw, ls_reg_form<DS>(P, *R, x)));
  const float cc = rd * u * u;
  obj = obj + P.dt * (oc + cc);
  float z[D];
#pragma unroll
  for (int i = 0; i < DS; ++i) z[i] = x[i];
  z[DS] = u;
  ampc_dynamics_cv<DS, D, S>(T, cv, z, x);
  return u;
}

// Candidate l (step size P.alphas[l]) of lane b: rolls x0 (read into
// x0) through the H steps, adding each step's cost to obj and
// (u_t - ubar_t)^2 to du2, and stashes x_{t+1} in rows (t, i < DS, l) and
// u_t in row (t, DS, l) of the stash (H, DS+1, L, B); obj then takes the
// terminal cost. The cost diagonals are the lane's own planes (qdT, rdT,
// fdT (obsdim, B), LANE_COST) or P's constants; the coefficients come
// from cv, the feature sums over trees of S slots. BM: the carry is
// batch-major (x0T (B, DS), ls_load_row_bm); REG: the GaussReg term with
// R and the lane's weight regw[b]; DENSE: the fixed dense cost, Q at
// dense[0 .. obsdim^2) and F after it (row-major, in shared memory), R in
// P.rd.
template <int DS, bool LANE_COST, int S, bool BM = false, bool REG = false,
          bool DENSE = false, class TT, class CV>
__device__ __forceinline__ void ls_candidate_cv(
    const TT& T, CV cv, const LSParams& P,
    const float* __restrict__ x0T, const float* __restrict__ xsT,
    const float* __restrict__ usT, const float* __restrict__ KsT,
    const float* __restrict__ ksT, const float* __restrict__ qdT,
    const float* __restrict__ rdT, const float* __restrict__ fdT,
    float* stash, int l, int H, int B, int b, float (&x0)[DS], float& obj,
    float& du2, const RegParams* R = nullptr, const float* __restrict__ regw = nullptr,
    const float* dense = nullptr) {
  constexpr int D = DS + 1;
  const long long LB = (long long)P.L * B;
  float x[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i)
    x[i] = x0[i] = BM ? x0T[(long long)b * DS + i] : x0T[(long long)i * B + b];
  float rw = 0.f;
  if constexpr (REG) rw = regw[b];
  // The stage-cost diagonal: the lane's own, held in registers through
  // the rollout, or the shared constants.
  float q_lane[DS];
  float rd = P.rd;
  if constexpr (LANE_COST) {
#pragma unroll
    for (int i = 0; i < DS; ++i)
      q_lane[i] = i < P.obsdim ? qdT[(long long)i * B + b] : 0.f;
    rd = rdT[b];
  }
  const float* wq = DENSE ? dense : (LANE_COST ? q_lane : P.qd);
  const float alpha = P.alphas[l];
  float* st = stash + (long long)l * B + b;
  for (int t = 0; t < H; ++t) {
    float xbar[DS], K[DS], ubar, kk;
    if constexpr (BM)
      ls_load_row_bm<DS>(xsT, usT, KsT, ksT, t, H, b, xbar, K, ubar, kk);
    else
      ls_load_row<DS>(xsT, usT, KsT, ksT, t, B, b, xbar, K, ubar, kk);
    const float u = ls_obj_step_cv<DS, S, REG, DENSE>(T, cv, P, x, xbar, K, ubar, kk,
                                                      alpha, wq, rd, obj, R, rw);
    const float du = u - ubar;
    du2 = du2 + du * du;
    float* row = st + (long long)t * D * LB;
#pragma unroll
    for (int i = 0; i < DS; ++i) row[i * LB] = x[i];
    row[DS * LB] = u;
  }
  // The terminal diagonal is fetched only now, after the rollout.
  float f_lane[DS];
  if constexpr (LANE_COST) {
#pragma unroll
    for (int i = 0; i < DS; ++i)
      f_lane[i] = i < P.obsdim ? fdT[(long long)i * B + b] : 0.f;
  }
  if constexpr (DENSE) {
    obj = obj + ls_dense_form<DS>(P, x, dense + P.obsdim * P.obsdim);
  } else {
    const float* wf = LANE_COST ? f_lane : P.fd;
    obj = obj + ls_quad_form<DS>(P, x, wf);
  }
}

// ls_candidate_cv with one shared (DS, n) coefficient plane (s_coef).
template <int DS, bool LANE_COST, bool BM = false, bool REG = false, bool DENSE = false>
__device__ __forceinline__ void ls_candidate(
    const FeatTable& T, const float* s_coef, const LSParams& P,
    const float* __restrict__ x0T, const float* __restrict__ xsT,
    const float* __restrict__ usT, const float* __restrict__ KsT,
    const float* __restrict__ ksT, const float* __restrict__ qdT,
    const float* __restrict__ rdT, const float* __restrict__ fdT,
    float* stash, int l, int H, int B, int b, float (&x0)[DS], float& obj,
    float& du2, const RegParams* R = nullptr, const float* __restrict__ regw = nullptr,
    const float* dense = nullptr) {
  ls_candidate_cv<DS, LANE_COST, AMPC_TREE_SLOTS, BM, REG, DENSE>(
      T, CoefShared{s_coef, T.n}, P, x0T, xsT, usT, KsT, ksT, qdT, rdT, fdT,
      stash, l, H, B, b, x0, obj, du2, R, regw, dense);
}
