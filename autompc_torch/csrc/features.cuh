// Feature-term descriptors and the summation order shared by the
// relinearization kernel (relin.cu) and the line-search kernels
// (linesearch_fused.cu, sindy_linesearch.cu, ls_obj_wide.cu,
// ls_reroll_wide.cu).
//
// A term is  prod_c z_c^exps[c] * trig(freq * z[comp])  with trig one of
// none / sin / cos (autompc_torch/sysid/basis.py: TermDesc). With one
// coefficient plane for every lane the table holds only the ACTIVE terms
// (after the solver's feature mask) and is passed by value as a
// __grid_constant__ kernel parameter: every thread reads the same entry
// at the same time, which the constant cache broadcasts. With a model a
// lane (the joint fan-out) the table holds the whole library, up to
// AMPC_MAX_F_BIG terms, in device memory (FeatTableRef), and each lane
// reads its own column of a lanes-last coefficient plane (CoefLane); the
// sums are the same, so B copies of one matrix give the shared
// instance's bits. Component indices of the per-thread input vector z are
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
// sm_90a). ampc_tree_push_cv decodes the walk once a term for all ds sums
// (a switch on the number of trailing one-bits of k) and performs the
// same additions in the same order. Its products and merges are rounded
// one by one (__fmul_rn, __fadd_rn, which are never contracted into an
// FMA): the predicated walk also rounds the product on its own, because
// the product has a second use there, so the bits are unchanged.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define AMPC_MAX_F 64  // terms of a table passed by value
// Input components d = ds + dc: 24 covers the halfcheetah's (18, 6). The
// table passed by value is then 3,488 bytes (1,424 at 8), within a
// kernel's parameter space; the kernels read only the first d entries of
// a term's row, so the table's width moves no bit.
#define AMPC_MAX_D 24
#define AMPC_TREE_SLOTS 7  // 2^7 > AMPC_MAX_F
// The per-lane-coefficient instances (the joint fan-out's, whose lanes
// each carry their own model) walk the whole library, up to
// AMPC_MAX_F_BIG terms. Their table lives in device memory (~60 KB, more
// than a kernel's parameters may take) with 16-bit column lists, and
// their trees have AMPC_TREE_SLOTS_BIG slots where the library has more
// than AMPC_MAX_F terms (a counter of n terms needs 2^slots > n). Up to
// AMPC_MAX_F terms they keep AMPC_TREE_SLOTS: the large trees add the
// same blocks in the same order there, but took 2-3% more device time in
// K1 and K3 and 6-10% more in K7 at 55 terms, B=1,024 and 128, H=10
// (NVIDIA H100 80GB HBM3, 700 W; tools/ab_torch_kernels.py --only lane).
#define AMPC_MAX_F_BIG 2048
#define AMPC_TREE_SLOTS_BIG 12  // 2^12 > AMPC_MAX_F_BIG

template <int MAXF, typename IT>
struct FeatTableT {
  int n;  // active terms
  int d;  // input components
  signed char exps[MAXF][AMPC_MAX_D];
  signed char kind[MAXF];  // 0 none, 1 sin, 2 cos
  signed char comp[MAXF];  // trig component
  float freq[MAXF];
  // Per Jacobian column dd < d: the col_n[dd] terms with a nonzero
  // partial in z_dd, in term order.
  IT col_n[AMPC_MAX_D];
  IT col_terms[AMPC_MAX_D][MAXF];
};
typedef FeatTableT<AMPC_MAX_F, signed char> FeatTable;
typedef FeatTableT<AMPC_MAX_F_BIG, short> FeatTableBig;

// A kernel parameter naming a device-resident table and its term count
// (read on the host, so that no launch reads the table to size itself);
// S: the slots of the term sums' trees.
template <int S>
struct FeatTableRef {
  const FeatTableBig* p;
  int n;
};

// What a kernel's table parameter says about the instance: the table by
// value (shared coefficients, AMPC_TREE_SLOTS) or a reference to the
// device table (per-lane coefficients, S slots).
template <class TA>
struct AmpcTableTraits {
  static constexpr bool lane = false;
  static constexpr int slots = AMPC_TREE_SLOTS;
};
template <int S>
struct AmpcTableTraits<FeatTableRef<S>> {
  static constexpr bool lane = true;
  static constexpr int slots = S;
};
__device__ __forceinline__ const FeatTable& ampc_table(const FeatTable& T) {
  return T;
}
template <int S>
__device__ __forceinline__ const FeatTableBig& ampc_table(const FeatTableRef<S>& T) {
  return *T.p;
}

// The coefficients a term sum reads, coefficient (i, k) of output i and
// term k: one (DS, n) row-major plane shared by every thread (staged in
// shared memory), or one lane's column of a lanes-last (DS, n, B) plane
// in global memory (the per-lane instances), p pointing at the lane's
// first word: a warp of neighbouring lanes reads one line for each
// (i, k).
struct CoefShared {
  const float* p;
  int n;
  __device__ __forceinline__ float get(int i, int k) const { return p[i * n + k]; }
};
struct CoefLane {
  const float* p;
  int n;
  int B;
  __device__ __forceinline__ float get(int i, int k) const {
    return __ldg(p + ((long long)i * n + k) * B);
  }
};

template <int S>
struct TreeAccT {
  float slot[S];

  // Add the k-th term (k = number of terms pushed before it).
  __device__ __forceinline__ void push(float v, int k) {
    float carry = v;
    bool go = true;
#pragma unroll
    for (int l = 0; l < S; ++l) {
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
    for (int l = 0; l < S; ++l) {
      if ((n >> l) & 1) {
        r = any ? slot[l] + r : slot[l];
        any = true;
      }
    }
    return r;
  }
};
typedef TreeAccT<AMPC_TREE_SLOTS> TreeAcc;

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
template <int M, int N, int S>
__device__ __forceinline__ void ampc_tree_close(TreeAccT<S> (&acc)[N],
                                                float (&carry)[N]) {
  static_assert(M < S, "a block beyond the tree's slots");
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int l = 0; l < M; ++l) carry[i] = __fadd_rn(acc[i].slot[l], carry[i]);
    acc[i].slot[M] = carry[i];
  }
}

// Push the k-th summand of each of N trees at once: tree i receives
// carry[i] where TreeAcc::push(carry[i], k) would place it (k < 2^S - 1).
template <int N, int S>
__device__ __forceinline__ void ampc_tree_push_carry(TreeAccT<S> (&acc)[N],
                                                     float (&carry)[N], int k) {
  static_assert(S == AMPC_TREE_SLOTS || S == AMPC_TREE_SLOTS_BIG, "tree slots");
  switch (__ffs(~k) - 1) {  // trailing one-bits of k
    case 0: ampc_tree_close<0>(acc, carry); break;
    case 1: ampc_tree_close<1>(acc, carry); break;
    case 2: ampc_tree_close<2>(acc, carry); break;
    case 3: ampc_tree_close<3>(acc, carry); break;
    case 4: ampc_tree_close<4>(acc, carry); break;
    case 5: ampc_tree_close<5>(acc, carry); break;
    default:
      if constexpr (S == AMPC_TREE_SLOTS) {
        ampc_tree_close<6>(acc, carry);
      } else {
        switch (__ffs(~k) - 1) {
          case 6: ampc_tree_close<6>(acc, carry); break;
          case 7: ampc_tree_close<7>(acc, carry); break;
          case 8: ampc_tree_close<8>(acc, carry); break;
          case 9: ampc_tree_close<9>(acc, carry); break;
          case 10: ampc_tree_close<10>(acc, carry); break;
          default: ampc_tree_close<11>(acc, carry); break;
        }
      }
      break;
  }
}

// Push term k into N trees at once: tree i receives cv.get(i, k) * v
// where TreeAcc::push(cv.get(i, k) * v, pos) would place it (pos, the
// number of summands pushed before it, < 2^S - 1).
template <int N, int S, class CV>
__device__ __forceinline__ void ampc_tree_push_cv(TreeAccT<S> (&acc)[N], CV cv,
                                                  int k, float v, int pos) {
  float carry[N];
#pragma unroll
  for (int i = 0; i < N; ++i) carry[i] = __fmul_rn(cv.get(i, k), v);
  ampc_tree_push_carry<N>(acc, carry, pos);
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
template <int D, class TT>
__device__ __forceinline__ bool ampc_monomial(const TT& T, int k,
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

template <int D, class TT>
__device__ __forceinline__ float ampc_term_value(const TT& T, int k,
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
template <int D, class TT>
__device__ __forceinline__ bool ampc_term_partial(const TT& T, int k,
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

// x'_i = sum_k cv.get(i, k) * term_k(z), i < DS, over a tree of S slots.
template <int DS, int D, int S = AMPC_TREE_SLOTS, class TT, class CV>
__device__ __forceinline__ void ampc_dynamics_cv(const TT& T, CV cv,
                                                 const float (&z)[D],
                                                 float (&xn)[DS]) {
  TreeAccT<S> acc[DS];
  const int n = cv.n;
  for (int k = 0; k < n; ++k)
    ampc_tree_push_cv<DS>(acc, cv, k, ampc_term_value<D>(T, k, z), k);
#pragma unroll
  for (int i = 0; i < DS; ++i) xn[i] = acc[i].total(n);
}

// x'_i = sum_k coef[i][k] * term_k(z), i < DS (coef row-major (DS, n)).
template <int DS, int D>
__device__ __forceinline__ void ampc_dynamics(const FeatTable& T,
                                              const float* coef,
                                              const float (&z)[D],
                                              float (&xn)[DS]) {
  ampc_dynamics_cv<DS, D>(T, CoefShared{coef, T.n}, z, xn);
}

// Column dd of the packed Jacobian at z: col[i] = d x'_i / d z_dd, summed
// over the column's listed terms (0 if none touches z_dd), coefficients
// from cv, over a tree of S slots.
template <int DS, int D, int S = AMPC_TREE_SLOTS, class TT, class CV>
__device__ __forceinline__ void ampc_jac_col_cv(const TT& T, CV cv,
                                                const float (&z)[D], int dd,
                                                float (&col)[DS]) {
  const int m = T.col_n[dd];
  TreeAccT<S> acc[DS];
  for (int j = 0; j < m; ++j) {
    const int k = T.col_terms[dd][j];
    float g;
    ampc_term_partial<D>(T, k, dd, z, g);  // listed: never structurally 0
    ampc_tree_push_cv<DS>(acc, cv, k, g, j);
  }
#pragma unroll
  for (int i = 0; i < DS; ++i) col[i] = acc[i].total(m);
}

// The same with one shared (DS, n) row-major plane.
template <int DS, int D>
__device__ __forceinline__ void ampc_jac_col(const FeatTable& T,
                                             const float* coef,
                                             const float (&z)[D], int dd,
                                             float (&col)[DS]) {
  ampc_jac_col_cv<DS, D>(T, CoefShared{coef, T.n}, z, dd, col);
}

// Block-wide copy of the (DS, n) coefficient plane into shared memory.
__device__ __forceinline__ void ampc_load_coef(float* s_coef,
                                               const float* coeffs, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) s_coef[i] = coeffs[i];
  __syncthreads();
}
