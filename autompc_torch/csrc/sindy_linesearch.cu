// K7: unfused iLQR line-search rollouts for a linear-in-features model,
// batch-major, any (ds, dc) with ds + dc <= AMPC_MAX_D: every candidate
// step size is rolled through the dynamics and WRITTEN OUT; the objective
// and the choice are the caller's.
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_linesearch.py:
// _ls_kernel (entry pallas_sindy_line_search) with one shared (ds, F)
// coefficient plane, or (ampc_sindy_line_search_lane) one a lane: a
// lanes-last (ds, F, B) plane whose column b the candidates of lane b read
// in place, the term table in device memory and its decoded words in
// dynamic shared memory, over the whole library (up to AMPC_MAX_F_BIG
// terms; 86-96 registers, no spill). Per candidate (lane b, step size l):
//   x_0 = x0[b];  for t < H:
//     u_t = clip(alpha_l k_t + ubar_t + K_t (x_t - xbar_t)),  (dc controls)
//     x_{t+1} = coeffs @ features([x_t, u_t]),
//   ls_xs[b, l, t] = x_t (t <= H), ls_us[b, l, t] = u_t.
// The feedback sum is a left fold over the state components, the order of
// _ls_kernel's sum(); the feature sum is the balanced tree of features.cuh
// (the same pairing as _ls_kernel's tree_sum). The clip is written with
// comparisons so that a NaN control (NaN gains) stays NaN.
//
// Design: a group of G threads a candidate (G = 8, or 4 where the batch
// fills the card: ops/cuda_linesearch.py: sindy_geometry),
// the groups of one lane's L candidates adjacent. A step: every thread of
// the group computes the control u (the same arithmetic, so the same
// value); the active terms are taken in rounds of G consecutive terms,
// thread g evaluating term r G + g and its ds products coef[i][k] * term;
// each output's products are summed across the group by a butterfly of
// __shfl_xor_sync (log2 G levels, a block added only where it holds a
// term), which leaves every thread with the round's sums; the sums of
// complete rounds are pushed into a counter tree over rounds, and the
// last, partial round's sum opens the final fold. That is the pairing of
// the balanced tree over all terms (features.cuh: TreeAcc): the butterfly
// sums aligned blocks of 2^l consecutive terms, earlier with later, and a
// partial block is the fold of its own aligned blocks, newest first
// (tests/test_torch_basis.py holds a model of it against tree_sum for up
// to 64 terms). Against one thread a candidate (the earlier design), where
// a step evaluated every term and pushed it into ds trees in turn, the
// dependent chain of a step is one term evaluation and log2 G levels of
// shuffles (all terms at once for n <= G), and a batch runs G times as
// many threads: the fan-out's B = 1,024 ... 128 candidates' 10,240 ...
// 1,280 threads filled at most ~2 warps an SM. The threads of a group read
// different terms at once, so the terms' powers and frequencies are
// copied to shared memory (the constant bank serializes different
// addresses in a warp), each term
// decoded once a block into one word (sls_term_desc: the monomial's
// components, read without the powers where every power is 1). The lane's
// carry rows are loaded a step ahead. Thread 0 of a group writes each
// state row as one 16-byte store. Inputs are read in place from the
// batch-major carry; the TPU wrapper's seven transposes have no
// counterpart.
//
// Bits: each output's sum adds the same products (__fmul_rn) in the same
// pairs (__fadd_rn; an addition's two operands in either order give the
// same bits), with the same sinf/cosf, and the control is computed with
// the rounding that the one-thread kernel compiled to (its SASS: the
// second feedback product rounded, the first fused into their sum, one
// FMA for each further component, alpha k + ubar fused, then one add),
// pinned with intrinsics so that no contraction choice of the compiler
// can move it. So every G gives the same outputs, and the one-thread
// kernel's (tools/ab_torch_kernels.py compares the digests).
//
// What bounds it on an H100: by bytes, the written trajectories (L (ds+1)
// floats a lane-step: 0.0008 ms at the fan-out's B=1,024, H=10, 0.0589 ms
// at B=4096, H=200); in fact the chain of H dependent steps of each
// candidate, hidden behind B x L x G threads. Measured
// (tools/ab_torch_kernels.py, device time, NVIDIA H100 80GB HBM3 at
// 700 W): 0.0151 ms at B=1,024, H=10 (G=8), 0.0114, 0.0103 and
// 0.0095-0.0099 at B=512, 256 and 128; 0.591 ms at B=4096, H=200 (G=4),
// 10x the byte bound. The one-thread kernel took 0.0329, 0.0297, 0.0294,
// 0.0294 and 0.953 ms there.
//
// Other shapes (the pendulum's (2, 1), the halfcheetah's (18, 6)): the
// same group, butterfly and trees; where a state row is not one float4
// (ds != 4) or there are several controls, a step's carry rows are read
// at the step instead of a step ahead, thread 0 of a group stores the
// state row and the controls element by element, and control j's
// feedback sum is the fold above over the row K_t[j] (the second product
// rounded, the first fused, one FMA a further component). The (4, 1)
// instance is the code above, unchanged. The per-lane-coefficient
// instances are built at each library's (ds, dc), as the shared ones.
#include "features.cuh"

#define AMPC_MAX_L 10
// Most threads a block the entry takes (the wrapper launches SINDY_THREADS).
#define AMPC_SLS_MAX_THREADS 256

// The step sizes and each control's bounds.
struct SindyLS {
  int L;
  float alphas[AMPC_MAX_L];
  float umin[AMPC_MAX_D], umax[AMPC_MAX_D];
};

// The part of the term table that a term's value reads into shared
// memory, word by word: the powers (rows of exps) and the trig frequency
// of the n active terms. The kinds and trig components are decoded into
// the block's term words (sls_term_desc, from the kernel parameter) and
// the Jacobian column lists are not read, so they stay behind: the whole
// table is 3,488 bytes at AMPC_MAX_D = 24, the part read 28 bytes a term.
__device__ __forceinline__ void sls_load_table(FeatTable* dst,
                                               const FeatTable& src) {
  static_assert(AMPC_MAX_D % 4 == 0, "a row of exps is whole words");
  constexpr int ROW = AMPC_MAX_D / 4;  // words a row of exps
  const int n = src.n;
  const int* se = reinterpret_cast<const int*>(&src.exps[0][0]);
  int* de = reinterpret_cast<int*>(&dst->exps[0][0]);
  for (int i = threadIdx.x; i < n * ROW; i += blockDim.x) de[i] = se[i];
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst->freq[i] = src.freq[i];
}

// A term in one word, decoded once a block: bits 0..M-1 the components
// with a power (mask), bit M set if every power is 1, bits M+1..M+2 the
// kind, the bits from M+3 the trig component; M = 8 up to 8 inputs (the
// trig component in 3 bits), else 24 (in 5).
template <int D>
struct SlsDesc {
  static_assert(D <= 24, "a term's mask in 24 bits");
  static constexpr int M = D <= 8 ? 8 : 24;
  static constexpr unsigned COMP = D <= 8 ? 7u : 31u;
};

template <int D, class TT>
__device__ __forceinline__ unsigned sls_term_desc(const TT& T, int k) {
  constexpr int M = SlsDesc<D>::M;
  unsigned mask = 0, ones = 1;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const int e = T.exps[k][c];
    if (e > 0) mask |= 1u << c;
    if (e > 1) ones = 0;
  }
  return mask | ones << M | (unsigned)T.kind[k] << (M + 1) | (unsigned)T.comp[k] << (M + 3);
}

// ampc_term_value from the decoded word: where every power is 1 the
// monomial is the product of its components in component order, which is
// what ampc_monomial computes (ampc_ipow(x, 1) = x), without reading the
// powers; the same product, trig factor and roundings.
template <int D, class TT>
__device__ __forceinline__ float sls_term_value(const TT& T, int k,
                                                unsigned desc,
                                                const float (&z)[D]) {
  constexpr int M = SlsDesc<D>::M;
  float mono = 1.f;
  bool hm = false;
  if ((desc >> M) & 1u) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      if ((desc >> c) & 1u) {
        mono = hm ? mono * z[c] : z[c];
        hm = true;
      }
    }
  } else {
    hm = ampc_monomial<D>(T, k, z, -1, mono);
  }
  const int kind = (desc >> (M + 1)) & 3u;
  if (kind == 0) return mono;
  const float a = T.freq[k] * ampc_select<D>(z, (int)((desc >> (M + 3)) & SlsDesc<D>::COMP));
  const float tv = (kind == 1) ? sinf(a) : cosf(a);
  return hm ? mono * tv : tv;
}

// TA: FeatTable (shared coefficients, staged in shared memory with the
// table) or FeatTableRef<S> (per-lane coefficients, a lanes-last
// (ds, n, B) plane, lane b's column read by its candidates' threads; the
// table in device memory and its decoded words in dynamic shared memory,
// n words; trees of S slots).
// Control j of a step at the other shapes: clip(alpha k_j + ubar_j +
// K_j (x - xbar)), the feedback fold with the roundings of the (4, 1)
// kernel's (the second product rounded, the first fused into their sum,
// one FMA a further component; at ds = 1 the product alone), alpha k +
// ubar fused, then one add.
template <int DS>
__device__ __forceinline__ float sls_control(const float (&x)[DS], const float* xbar,
                                             const float* K, float kk, float ubar,
                                             float alpha, float lo, float hi) {
  float fb;
  if constexpr (DS == 1) {
    fb = __fmul_rn(K[0], __fsub_rn(x[0], xbar[0]));
  } else {
    fb = __fmaf_rn(K[0], __fsub_rn(x[0], xbar[0]), __fmul_rn(K[1], __fsub_rn(x[1], xbar[1])));
#pragma unroll
    for (int i = 2; i < DS; ++i) fb = __fmaf_rn(K[i], __fsub_rn(x[i], xbar[i]), fb);
  }
  const float u = __fadd_rn(__fmaf_rn(alpha, kk, ubar), fb);
  return u < lo ? lo : (u > hi ? hi : u);
}

template <int DS, int DC, int G, class TA = FeatTable>
__global__ void sindy_ls_kernel(
    const __grid_constant__ TA T,
    const __grid_constant__ SindyLS P, const float* __restrict__ coeffs,
    const float* __restrict__ x0, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ Ks,
    const float* __restrict__ ks, float* __restrict__ out_xs,
    float* __restrict__ out_us, int H, int B) {
  constexpr int D = DS + DC;
  // The (4, 1) instance: a state row and a gain row are one float4 each,
  // the carry rows read a step ahead.
  constexpr bool ROW4 = DS == 4 && DC == 1;
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two");
  constexpr bool LANE = AmpcTableTraits<TA>::lane;
  constexpr int S = AmpcTableTraits<TA>::slots;
  __shared__ FeatTable sT;
  __shared__ float s_coef[DS * AMPC_MAX_F];
  __shared__ unsigned s_desc_fixed[AMPC_MAX_F];
  extern __shared__ unsigned s_desc_lane[];
  unsigned* s_desc = LANE ? s_desc_lane : s_desc_fixed;
  // The table the terms are read from: the device table (per lane) or
  // its copy in shared memory.
  const auto& Tk = [&]() -> const auto& {
    if constexpr (LANE) return ampc_table(T); else return sT;
  }();
  if constexpr (LANE) {
    for (int k = threadIdx.x; k < T.n; k += blockDim.x)
      s_desc[k] = sls_term_desc<D>(Tk, k);
    __syncthreads();
  } else {
    sls_load_table(&sT, T);
    for (int k = threadIdx.x; k < T.n; k += blockDim.x)
      s_desc[k] = sls_term_desc<D>(T, k);
    ampc_load_coef(s_coef, coeffs, DS * T.n);  // ends with __syncthreads
  }

  // Candidate c = b * L + l; a tail group past the last candidate repeats
  // it (its shuffles must run) and stores nothing.
  const int g = (int)(threadIdx.x % G);
  const long long nc = (long long)B * P.L;
  const long long cr = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const bool valid = cr < nc;
  const long long c = valid ? cr : nc - 1;
  const int b = (int)(c / P.L);
  const float alpha = P.alphas[c - (long long)b * P.L];
  const int n = T.n, full = n / G, part = n - full * G;
  const bool store = valid && g == 0;
  // The coefficients: lane b's column of the per-lane plane, or the plane
  // staged in shared memory.
  const auto cv = [&] {
    if constexpr (LANE) return CoefLane{coeffs + b, n, B}; else return CoefShared{s_coef, n};
  }();

  float x[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) x[i] = x0[(long long)b * DS + i];
  float* oxf = out_xs + c * (H + 1) * DS;
  float4* oxs = reinterpret_cast<float4*>(oxf);
  float* ous = out_us + c * H * DC;
  if (store) {
    if constexpr (ROW4) {
      oxs[0] = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int i = 0; i < DS; ++i) oxf[i] = x[i];
    }
  }
  // The lane's carry rows of step t (gains, nominal state, nominal and
  // feedforward control) are loaded a step ahead, off the chain.
  const float4* Krow = reinterpret_cast<const float4*>(Ks + (long long)b * H * DS);
  const float4* xrow = reinterpret_cast<const float4*>(xs + (long long)b * (H + 1) * DS);
  const float* ksb = ks + (long long)b * H;
  const float* usb = us + (long long)b * H;
  float4 Kn, xbn;
  float ksn, usn;
  if constexpr (ROW4) {
    Kn = Krow[0], xbn = xrow[0];
    ksn = ksb[0], usn = usb[0];
  }
  for (int t = 0; t < H; ++t) {
    float z[D];
#pragma unroll
    for (int i = 0; i < DS; ++i) z[i] = x[i];
    if constexpr (ROW4) {
      const float4 Kc = Kn, xbc = xbn;
      const float ksc = ksn, usc = usn;
      if (t + 1 < H) {
        Kn = Krow[t + 1];
        xbn = xrow[t + 1];
        ksn = ksb[t + 1];
        usn = usb[t + 1];
      }
      float fb = __fmaf_rn(Kc.x, __fsub_rn(x[0], xbc.x),
                           __fmul_rn(Kc.y, __fsub_rn(x[1], xbc.y)));
      fb = __fmaf_rn(Kc.z, __fsub_rn(x[2], xbc.z), fb);
      fb = __fmaf_rn(Kc.w, __fsub_rn(x[3], xbc.w), fb);
      float u = __fadd_rn(__fmaf_rn(alpha, ksc, usc), fb);
      u = u < P.umin[0] ? P.umin[0] : (u > P.umax[0] ? P.umax[0] : u);
      z[DS] = u;
    } else {
      // The lane's rows of step t: xbar (DS), K (DC, DS), k and ubar (DC).
      const long long bt = (long long)b * H + t;
      const float* xbar = xs + ((long long)b * (H + 1) + t) * DS;
#pragma unroll
      for (int j = 0; j < DC; ++j)
        z[DS + j] = sls_control<DS>(x, xbar, Ks + (bt * DC + j) * DS, ks[bt * DC + j],
                                    us[bt * DC + j], alpha, P.umin[j], P.umax[j]);
    }

    TreeAccT<S> acc[DS];  // over complete rounds (blocks of G terms)
    float sum[DS];
    for (int r = 0; r * G < n; ++r) {
      const int cnt = r < full ? G : part;  // terms in this round
      const int k = r * G + (g < cnt ? g : 0);
      const float v = g < cnt ? sls_term_value<D>(Tk, k, s_desc[k], z) : 0.f;
#pragma unroll
      for (int i = 0; i < DS; ++i) sum[i] = __fmul_rn(cv.get(i, k), v);
#pragma unroll
      for (int l = 1; l < G; l <<= 1) {
        const int own = g & ~(l - 1);  // this thread's block of l terms
        const bool has_own = own < cnt, has_other = (own ^ l) < cnt;
#pragma unroll
        for (int i = 0; i < DS; ++i) {
          const float o = __shfl_xor_sync(0xffffffffu, sum[i], l, G);
          sum[i] = has_own ? (has_other ? __fadd_rn(sum[i], o) : sum[i]) : o;
        }
      }
      if (r < full) ampc_tree_push_carry<DS>(acc, sum, r);
    }
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      if (part == 0) {
        x[i] = acc[i].total(full);
      } else {
        float s2 = sum[i];
#pragma unroll
        for (int l = 0; l < S; ++l)
          if ((full >> l) & 1) s2 = __fadd_rn(acc[i].slot[l], s2);
        x[i] = s2;
      }
    }
    if (store) {
      if constexpr (ROW4) {
        oxs[t + 1] = make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int i = 0; i < DS; ++i) oxf[(t + 1) * DS + i] = x[i];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) ous[t * DC + j] = z[DS + j];
    }
  }
}

template <int DS, int DC, int G, class TA>
static void sls_launch(const TA& T, const SindyLS* P, const float* coeffs,
                       const float* x0, const float* xs, const float* us,
                       const float* Ks, const float* ks, float* out_xs,
                       float* out_us, int H, int B, int threads, cudaStream_t s) {
  const long long n = (long long)B * P->L * G;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const size_t smem =
      AmpcTableTraits<TA>::lane ? (size_t)T.n * sizeof(unsigned) : 0;
  sindy_ls_kernel<DS, DC, G, TA><<<blocks, threads, smem, s>>>(
      T, *P, coeffs, x0, xs, us, Ks, ks, out_xs, out_us, H, B);
}

static int sls_check(int n, int max_n, const SindyLS* P, int ds, int H, int B,
                     int threads, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || n > max_n || P->L < 1 || P->L > AMPC_MAX_L || B < 1 ||
      H < 1 || threads < 32 || threads > AMPC_SLS_MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int DS, int DC, class TA>
static int sls_group(const TA& T, const SindyLS* P, const float* coeffs,
                     const float* x0, const float* xs, const float* us,
                     const float* Ks, const float* ks, float* out_xs,
                     float* out_us, int H, int B, int group, int threads,
                     cudaStream_t s) {
  switch (group) {
    case 4:
      sls_launch<DS, DC, 4>(T, P, coeffs, x0, xs, us, Ks, ks, out_xs, out_us, H, B,
                            threads, s);
      break;
    case 8:
      sls_launch<DS, DC, 8>(T, P, coeffs, x0, xs, us, Ks, ks, out_xs, out_us, H, B,
                            threads, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The (ds, dc) instances of this object, shared- and per-lane-coefficient
// alike: the main library's (4, 1), or the one shape of a library built
// at first use (-DAMPC_DS, -DAMPC_DC; ops/_build.py: shape_library).
// Another shape is refused.
#ifndef AMPC_DS
#define AMPC_DS 4
#define AMPC_DC 1
#endif

// A grid of ceil(B L G / threads) blocks of `threads` threads (a multiple
// of 32, at most AMPC_SLS_MAX_THREADS); thread tid of block bx is thread
// g = tid % G of candidate c = (bx * threads + tid) / G, lane c / L, step
// size c % L, for G = group in {4, 8}.
extern "C" int ampc_sindy_line_search(
    const FeatTable* T, const SindyLS* P, const float* coeffs,
    const float* x0, const float* xs, const float* us, const float* Ks,
    const float* ks, float* out_xs, float* out_us, int ds, int dc, int H, int B,
    int group, int threads, int device, void* stream) {
  const int rc = sls_check(T->n, AMPC_MAX_F, P, ds, H, B, threads, device);
  if (rc) return rc;
  if (ds != AMPC_DS || dc != AMPC_DC || T->d != ds + dc) return (int)cudaErrorInvalidValue;
  return sls_group<AMPC_DS, AMPC_DC>(*T, P, coeffs, x0, xs, us, Ks, ks, out_xs, out_us, H,
                                     B, group, threads, (cudaStream_t)stream);
}

// The same launch with per-lane coefficients, a lanes-last (ds, n, B)
// plane, and the device table Tdev of n terms (up to AMPC_MAX_F_BIG):
// trees of AMPC_TREE_SLOTS slots up to AMPC_MAX_F terms, else
// AMPC_TREE_SLOTS_BIG; the object's (ds, dc) only.
extern "C" int ampc_sindy_line_search_lane(
    const FeatTableBig* Tdev, int n, const SindyLS* P, const float* coeffs,
    const float* x0, const float* xs, const float* us, const float* Ks,
    const float* ks, float* out_xs, float* out_us, int ds, int dc, int H, int B,
    int group, int threads, int device, void* stream) {
  const int rc = sls_check(n, AMPC_MAX_F_BIG, P, ds, H, B, threads, device);
  if (rc) return rc;
  if (ds != AMPC_DS || dc != AMPC_DC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= AMPC_MAX_F)
    return sls_group<AMPC_DS, AMPC_DC>(FeatTableRef<AMPC_TREE_SLOTS>{Tdev, n}, P, coeffs, x0,
                                       xs, us, Ks, ks, out_xs, out_us, H, B, group, threads,
                                       s);
  return sls_group<AMPC_DS, AMPC_DC>(FeatTableRef<AMPC_TREE_SLOTS_BIG>{Tdev, n}, P, coeffs,
                                     x0, xs, us, Ks, ks, out_xs, out_us, H, B, group, threads,
                                     s);
}
