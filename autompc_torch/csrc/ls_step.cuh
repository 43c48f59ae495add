// The per-step arithmetic of the dc=1 line search for linear-in-features
// models under a diagonal quadratic cost, written once and shared by the
// fused kernel (linesearch_fused.cu, K3) and the two kernels of the split
// line search (ls_obj_wide.cu, K8, and ls_reroll_wide.cu, K9):
//   ls_obj_step     one step of one candidate rollout with its stage cost
//                   (K3's candidate threads and K8);
//   ls_reroll_lane  the whole re-roll of one lane at its selected step
//                   size with the fused relinearization and the carry
//                   select (K9).
// Both take the control from ls_control and the next state from
// ampc_dynamics (features.cuh), and K3 takes its Jacobians from
// ampc_jac_col, the function ampc_jac_rows is made of. Written once, the
// kernels compile to the same instructions for the same inputs (FMA
// contraction included), so K3's candidate threads, K8 and K9 roll the
// same trajectory for the same step size, and the split search returns
// what the fused kernel returns wherever the two choose the same step
// size.
//
// Orders follow autompc_tpu/ops/pallas_linesearch.py (_fused_kernel,
// _ls_obj_kernel_wide, _ls_reroll_kernel_wide): the feedback sum and the
// quadratic forms are the balanced tree of features.cuh, the stage cost
// is dt * ((x-g)'Q(x-g) + R u^2) with R u^2 = (R u) u, and the clip is
// written with comparisons so that a NaN control (NaN gains) stays NaN.
#pragma once

#include "features.cuh"
#include "jac_io.cuh"

#define AMPC_MAX_L 10
#define AMPC_MAX_OBS 8

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

// One step of a candidate rollout: u = clip(alpha k + ubar + K (x - xbar)),
// obj += dt (q-form(x) + R u^2), x <- coeffs @ features([x, u]); returns u.
template <int DS>
__device__ __forceinline__ float ls_obj_step(
    const FeatTable& T, const float* s_coef, const LSParams& P,
    float (&x)[DS], const float (&xbar)[DS], const float (&K)[DS],
    float ubar, float kk, float alpha, const float* wq, float rd,
    float& obj) {
  constexpr int D = DS + 1;
  const float u = ls_control<DS>(P, x, xbar, K, ubar, kk, alpha);
  const float oc = ls_quad_form<DS>(P, x, wq);
  const float cc = rd * u * u;
  obj = obj + P.dt * (oc + cc);
  float z[D];
#pragma unroll
  for (int i = 0; i < DS; ++i) z[i] = x[i];
  z[DS] = u;
  ampc_dynamics<DS, D>(T, s_coef, z, x);
  return u;
}

// Re-roll lane b at step size a_sel from x0. Writes xs (H+1, DS, B) and
// us (H, B) where traj_mask, the old values elsewhere; the packed
// Jacobian rows i*(DS+1)+dd at each (x_t, u_t) where jac_mask, the old
// rows elsewhere, stored as JT. Returns du2 = sum_t (u_t - ubar_t)^2.
template <int DS, typename JT>
__device__ __forceinline__ float ls_reroll_lane(
    const FeatTable& T, const float* s_coef, const LSParams& P,
    const float (&x0)[DS], float a_sel, bool traj_mask, bool jac_mask,
    const float* __restrict__ xsT, const float* __restrict__ usT,
    const float* __restrict__ KsT, const float* __restrict__ ksT,
    const JT* __restrict__ old_jac, float* __restrict__ out_xs,
    float* __restrict__ out_us, JT* __restrict__ out_jac, int H, int B,
    int b) {
  constexpr int D = DS + 1;
  float x[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    x[i] = x0[i];
    const long long o = (long long)i * B + b;
    out_xs[o] = traj_mask ? x0[i] : xsT[o];
  }
  float du2 = 0.f;
  for (int t = 0; t < H; ++t) {
    float xbar[DS], K[DS], ubar, kk;
    ls_load_row<DS>(xsT, usT, KsT, ksT, t, B, b, xbar, K, ubar, kk);
    const float u = ls_control<DS>(P, x, xbar, K, ubar, kk, a_sel);
    float z[D];
#pragma unroll
    for (int i = 0; i < DS; ++i) z[i] = x[i];
    z[DS] = u;
    float xn[DS];
    ampc_dynamics<DS, D>(T, s_coef, z, xn);
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      const long long o = ((long long)(t + 1) * DS + i) * B + b;
      out_xs[o] = traj_mask ? xn[i] : xsT[o];
    }
    const float du = u - ubar;
    du2 = du2 + du * du;
    out_us[(long long)t * B + b] = traj_mask ? u : ubar;
    float rows[DS * D];
    ampc_jac_rows<DS, D>(T, s_coef, z, rows);
#pragma unroll
    for (int r = 0; r < DS * D; ++r) {
      const long long o = ((long long)t * DS * D + r) * B + b;
      out_jac[o] = jac_mask ? ampc_jac_store<JT>(rows[r]) : old_jac[o];
    }
#pragma unroll
    for (int i = 0; i < DS; ++i) x[i] = xn[i];
  }
  return du2;
}
