// Feature-term descriptors and the summation order shared by the
// relinearization kernel (relin.cu) and the line-search kernels
// (linesearch_fused.cu, ls_obj_wide.cu, ls_reroll_wide.cu).
//
// A term is  prod_c z_c^exps[c] * trig(freq * z[comp])  with trig one of
// none / sin / cos (autompc_torch/sysid/basis.py: TermDesc). The table
// holds only the ACTIVE terms (after the solver's feature mask) and is
// passed by value as a __grid_constant__ kernel parameter: every thread
// reads the same entry at the same time, which the constant cache
// broadcasts. Component indices of the per-thread input vector z are
// compile-time constants after unrolling, so z stays in registers; only
// the term index k is a runtime loop variable.
//
// Summation order: the JAX kernels sum the per-term contributions with a
// balanced pairwise tree (_tree_sum, ops/pallas_linesearch.py), because
// a float32 left fold over many terms visibly changes iLQR convergence.
// TreeAcc reproduces that exact tree for a runtime term count with a
// binary counter: slot l holds the sum of a block of 2^l consecutive
// terms; pushing term k merges the blocks given by the trailing one-bits
// of k (earlier block on the left), and total(n) folds the blocks named
// by the one-bits of n from the newest (lowest bit) to the oldest.
// tests/test_torch_basis.py checks the grouping against _tree_sum.
//
// A column dd of the Jacobian sums only the terms whose partial in z_dd
// is not structurally zero (ampc_term_partial's test, which depends on
// the table alone): the host lists them once per table (col_n,
// col_terms; ops/_build.py: feat_table), in term order, so a column walks
// its own terms and pushes them with consecutive indices, as the walk
// over the whole table with the test did.
//
// The term loops (ampc_dynamics, ampc_jac_col) push with a run-time k,
// for which TreeAcc::push walks all seven slots in predicated code for
// every one of the ds sums (~500 SASS instructions a term at ds = 4, on
// sm_90a). ampc_tree_push decodes the walk once a term for all ds sums
// (a switch on the number of trailing one-bits of k) and performs the
// same additions in the same order. Its products and merges are rounded
// one by one (__fmul_rn, __fadd_rn, which are never contracted into an
// FMA): the predicated walk also rounds the product on its own, because
// the product has a second use there, so the bits are unchanged.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define AMPC_MAX_F 64  // active terms per table
#define AMPC_MAX_D 8   // input components d = ds + dc
#define AMPC_TREE_SLOTS 7  // 2^7 > AMPC_MAX_F

struct FeatTable {
  int n;  // active terms
  int d;  // input components
  signed char exps[AMPC_MAX_F][AMPC_MAX_D];
  signed char kind[AMPC_MAX_F];  // 0 none, 1 sin, 2 cos
  signed char comp[AMPC_MAX_F];  // trig component
  float freq[AMPC_MAX_F];
  // Per Jacobian column dd < d: the col_n[dd] terms with a nonzero
  // partial in z_dd, in term order.
  signed char col_n[AMPC_MAX_D];
  signed char col_terms[AMPC_MAX_D][AMPC_MAX_F];
};

struct TreeAcc {
  float slot[AMPC_TREE_SLOTS];

  // Add the k-th term (k = number of terms pushed before it).
  __device__ __forceinline__ void push(float v, int k) {
    float carry = v;
    bool go = true;
#pragma unroll
    for (int l = 0; l < AMPC_TREE_SLOTS; ++l) {
      if (go) {
        if ((k >> l) & 1) {
          carry = slot[l] + carry;
        } else {
          slot[l] = carry;
          go = false;
        }
      }
    }
  }

  // Sum of the n terms pushed; 0 when n == 0.
  __device__ __forceinline__ float total(int n) const {
    float r = 0.f;
    bool any = false;
#pragma unroll
    for (int l = 0; l < AMPC_TREE_SLOTS; ++l) {
      if ((n >> l) & 1) {
        r = any ? slot[l] + r : slot[l];
        any = true;
      }
    }
    return r;
  }
};

// x^e for e >= 1 by binary exponentiation (lax.integer_pow's order).
__device__ __forceinline__ float ampc_ipow(float x, int e) {
  if (e == 1) return x;  // the loop's result for e = 1, without the loop
  float acc = 1.f;
  bool have = false;
  while (e > 0) {
    if (e & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    e >>= 1;
    if (e) x = x * x;
  }
  return acc;
}

// Close the M blocks below slot M of each of N trees with its carry,
// earlier block on the left (TreeAcc::push for a k with M trailing ones).
template <int M, int N>
__device__ __forceinline__ void ampc_tree_close(TreeAcc (&acc)[N],
                                                float (&carry)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int l = 0; l < M; ++l) carry[i] = __fadd_rn(acc[i].slot[l], carry[i]);
    acc[i].slot[M] = carry[i];
  }
}

// Push the k-th summand of each of N trees at once: tree i receives
// carry[i] where TreeAcc::push(carry[i], k) would place it (k < 127).
template <int N>
__device__ __forceinline__ void ampc_tree_push_carry(TreeAcc (&acc)[N],
                                                     float (&carry)[N], int k) {
  switch (__ffs(~k) - 1) {  // trailing one-bits of k
    case 0: ampc_tree_close<0>(acc, carry); break;
    case 1: ampc_tree_close<1>(acc, carry); break;
    case 2: ampc_tree_close<2>(acc, carry); break;
    case 3: ampc_tree_close<3>(acc, carry); break;
    case 4: ampc_tree_close<4>(acc, carry); break;
    case 5: ampc_tree_close<5>(acc, carry); break;
    default: ampc_tree_close<6>(acc, carry); break;
  }
}

// Push term k into N trees at once: tree i receives coef[i * stride] * v
// where TreeAcc::push(coef[i * stride] * v, k) would place it (k < 127).
template <int N>
__device__ __forceinline__ void ampc_tree_push(TreeAcc (&acc)[N],
                                               const float* coef, int stride,
                                               float v, int k) {
  float carry[N];
#pragma unroll
  for (int i = 0; i < N; ++i) carry[i] = __fmul_rn(coef[i * stride], v);
  ampc_tree_push_carry<N>(acc, carry, k);
}

template <int D>
__device__ __forceinline__ float ampc_select(const float (&z)[D], int c) {
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i)
    if (i == c) a = z[i];
  return a;
}

// Product of z_c^e_c over the term's monomial components other than
// `skip`; returns false when there is none.
template <int D>
__device__ __forceinline__ bool ampc_monomial(const FeatTable& T, int k,
                                              const float (&z)[D], int skip,
                                              float& out) {
  bool have = false;
  float v = 1.f;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const int e = T.exps[k][c];
    if (e > 0 && c != skip) {
      const float p = ampc_ipow(z[c], e);
      v = have ? v * p : p;
      have = true;
    }
  }
  out = v;
  return have;
}

template <int D>
__device__ __forceinline__ float ampc_term_value(const FeatTable& T, int k,
                                                 const float (&z)[D]) {
  float mono;
  const bool hm = ampc_monomial<D>(T, k, z, -1, mono);
  const int kind = T.kind[k];
  if (kind == 0) return mono;
  const float a = T.freq[k] * ampc_select<D>(z, T.comp[k]);
  const float tv = (kind == 1) ? sinf(a) : cosf(a);
  return hm ? mono * tv : tv;
}

// d(term k)/d(z_c) by the product rule; false where structurally zero.
template <int D>
__device__ __forceinline__ bool ampc_term_partial(const FeatTable& T, int k,
                                                  int c, const float (&z)[D],
                                                  float& g) {
  const int e = T.exps[k][c];
  const int kind = T.kind[k];
  const bool trig_here = kind != 0 && T.comp[k] == c;
  if (e == 0 && !trig_here) return false;
  bool have = false;
  float out = 0.f;
  if (e > 0) {
    float dm = (e == 1) ? 1.f : (float)e * ampc_ipow(z[c], e - 1);
#pragma unroll
    for (int c2 = 0; c2 < D; ++c2) {
      const int e2 = T.exps[k][c2];
      if (c2 != c && e2 > 0) dm = dm * ampc_ipow(z[c2], e2);
    }
    out = dm;
    have = true;
  }
  if (kind != 0) {
    const float f = T.freq[k];
    const float a = f * ampc_select<D>(z, T.comp[k]);
    const float s = sinf(a), co = cosf(a);
    const float tv = (kind == 1) ? s : co;
    if (have) out = out * tv;
    if (trig_here) {
      const float dtv = (kind == 1) ? f * co : (-f) * s;
      float mono;
      const bool hm = ampc_monomial<D>(T, k, z, -1, mono);
      const float d2 = hm ? mono * dtv : dtv;
      out = have ? out + d2 : d2;
      have = true;
    }
  }
  g = out;
  return true;
}

// x'_i = sum_k coef[i][k] * term_k(z), i < DS (coef row-major (DS, n)).
template <int DS, int D>
__device__ __forceinline__ void ampc_dynamics(const FeatTable& T,
                                              const float* coef,
                                              const float (&z)[D],
                                              float (&xn)[DS]) {
  TreeAcc acc[DS];
  const int n = T.n;
  for (int k = 0; k < n; ++k)
    ampc_tree_push<DS>(acc, coef + k, n, ampc_term_value<D>(T, k, z), k);
#pragma unroll
  for (int i = 0; i < DS; ++i) xn[i] = acc[i].total(n);
}

// Column dd of the packed Jacobian at z: col[i] = d x'_i / d z_dd, summed
// over the column's listed terms (0 if none touches z_dd).
template <int DS, int D>
__device__ __forceinline__ void ampc_jac_col(const FeatTable& T,
                                             const float* coef,
                                             const float (&z)[D], int dd,
                                             float (&col)[DS]) {
  const int n = T.n, m = T.col_n[dd];
  TreeAcc acc[DS];
  for (int j = 0; j < m; ++j) {
    const int k = T.col_terms[dd][j];
    float g;
    ampc_term_partial<D>(T, k, dd, z, g);  // listed: never structurally 0
    ampc_tree_push<DS>(acc, coef + k, n, g, j);
  }
#pragma unroll
  for (int i = 0; i < DS; ++i) col[i] = acc[i].total(m);
}

// Block-wide copy of the (DS, n) coefficient plane into shared memory.
__device__ __forceinline__ void ampc_load_coef(float* s_coef,
                                               const float* coeffs, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) s_coef[i] = coeffs[i];
  __syncthreads();
}
