// K1: batched dynamics relinearization for linear-in-features models.
//
// Replaces the Pallas TPU kernel autompc_tpu/ops/pallas_relin.py:
// _relin_kernel (sparse grad_terms branch), entry
// pallas_feature_jacobians. It computes J(x_t, u_t) = coeffs . dTheta/dz
// at every (step, lane) of a trajectory, in one of two layouts:
//   lanes-last (ampc_relin_jacobians): xsT (H+1, ds, B), usT (H, B) in,
//     the PACKED plane jac (H, ds*(ds+1), B) out, row i*(ds+1)+dd =
//     d x'_i / d z_dd: the layout the lanes-last Riccati and line-search
//     kernels consume;
//   batch-major (ampc_relin_jacobians_bm): xs (B, H+1, ds), us (B, H, 1)
//     in, Jx (B, H, ds, ds) and Ju (B, H, ds, 1) out, read and written in
//     place: the contract of pallas_feature_jacobians, whose transposes
//     exist only for the TPU's lane tiling.
// The same kernel serves both (a template switch on the layout); the two
// give the same numbers, bit for bit, at the same point.
//
// Design: a block of NL points x CT threads a point, blockDim (NL, CT).
// Two geometries, picked by the wrapper from the number of points
// (ops/cuda_relin.py: relin_geometry):
//   split (CT = ds+1, NL = 32) where the points are too few to fill the
//     card (the gate's, the fan-outs'): a thread per (point, column dd),
//     a warp holding 32 points of one column, so that the column's term
//     list (features.cuh: col_terms, the terms with a nonzero partial in
//     z_dd) is walked warp-uniformly and ds+1 times as many threads share
//     the work of a point;
//   whole (CT = 1, NL = 256) where they fill it many times over (the main
//     path's B=4096 and 16384, H=200): a thread per point walks the five
//     columns' lists in turn, so the point's inputs are loaded once and
//     every warp does the same work.
// Each column is ampc_jac_col's, the function the fused and the wide line
// searches (K3, K9) call per column, so the bits are theirs. Lanes-last:
// the points of a block are neighbouring lanes of one step (blockIdx.y =
// t), and every row store i*(ds+1)+dd is one coalesced transaction a
// warp. Batch-major: the points of a block are consecutive (b, t) of the
// flattened (B, H) and their outputs are two contiguous runs of Jx and
// Ju; the block stages them in shared memory and writes each run with
// neighbouring threads on neighbouring words.
//
// What bounds it on an H100: bytes. Per point it reads ds+1 floats and
// writes ds (ds+1) (20 at ds=4); the arithmetic is the partials of the
// active terms (the sinf/cosf of the trig terms). At the main path's
// B=4096, H=200 that is 65.5 MB of output (0.0245 ms at 3.35 TB/s).
// Measured (tools/ab_torch_kernels.py, device time, NVIDIA H100 80GB HBM3
// at 700 W, the cartpole model's 7 active terms): whole, 0.0497 ms at
// B=4096 and 0.186 ms at B=16384, H=200 (2.0x and 1.9x the byte bound;
// the earlier design, a thread per point walking the whole table for each
// column, took 0.076 and 0.29); split, 0.0035-0.0036 ms at the gate's
// and the fan-outs' shapes (B=128 ... 1,024, H=10 or 20; the earlier
// design 0.008, its 5-40 blocks leaving most SMs idle), about the time of
// a launch. The batch-major entry adds ~0.0003-0.007 ms for its staging
// and replaces the four copy kernels of a layout adapter (0.010-0.016 ms
// at the fan-out's shapes, 0.255 at B=4096 with the adapter).
//
// Per-lane coefficients (ampc_relin_jacobians_lane, _bm_lane; the joint
// fan-out, a model a lane): the same kernel and geometry with the table in
// device memory and a lanes-last (ds, n, B) plane, each thread reading
// its lane's column in place (lanes-last: a warp of 32 neighbouring
// lanes reads one line for each (i, k)); no feature mask, so up to
// AMPC_MAX_F_BIG terms, trees of AMPC_TREE_SLOTS_BIG slots past
// AMPC_MAX_F. Registers (ptxas, sm_90a): 56-77 with the small trees,
// 84-107 with the large, no spill.
#include "features.cuh"

// Points a block holds: one warp per Jacobian column (split), or a thread
// per point (whole).
#define AMPC_RELIN_SPLIT_LANES 32
#define AMPC_RELIN_WHOLE_LANES 256
// Static shared memory a block may take.
#define AMPC_RELIN_STATIC_SMEM (48 * 1024)

// Bytes of static shared memory of relin_kernel<DS, DC, BM, ., NL>: the
// coefficient plane and, batch-major, the staging of NL points' Jx and
// Ju rows (ops/cuda_relin.py: relin_smem mirrors it).
__host__ __device__ constexpr int relin_smem(int DS, int DC, bool BM, int NL) {
  return 4 * (DS * AMPC_MAX_F + (BM ? NL : 1) * (DS * DS + 1) + (BM ? NL : 1) * (DS * DC + 1));
}

// Points a split block holds: AMPC_RELIN_SPLIT_LANES, halved until the
// batch-major staging fits the static shared memory (16 at (18, 6)).
__host__ __device__ constexpr int relin_split_lanes(int DS, int DC, bool BM) {
  int nl = AMPC_RELIN_SPLIT_LANES;
  while (nl > 1 && relin_smem(DS, DC, BM, nl) > AMPC_RELIN_STATIC_SMEM) nl /= 2;
  return nl;
}

// A whole block (a thread per point) fits its staging: at (18, 6) the
// batch-major staging of 256 points would take 444 KB, so that entry
// always splits.
__host__ __device__ constexpr bool relin_whole_fits(int DS, int DC, bool BM) {
  return relin_smem(DS, DC, BM, AMPC_RELIN_WHOLE_LANES) <= AMPC_RELIN_STATIC_SMEM;
}

// TA: FeatTable (shared coefficients, a (ds, n) plane staged in shared
// memory) or FeatTableRef<S> (per-lane coefficients, a lanes-last
// (ds, n, B) plane, lane b's column read in place; trees of S slots).
// DC: controls, the last DC of the D = DS + DC inputs; the lanes-last
// layout (the packed plane of the dc = 1 kernels) takes DC = 1.
template <int DS, int DC, bool BM, int CT, int NL, class TA = FeatTable>
__global__ void __launch_bounds__(NL* CT) relin_kernel(
    const __grid_constant__ TA T, const float* __restrict__ coeffs,
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ jac, float* __restrict__ Ju, int H, int B) {
  constexpr bool LANE = AmpcTableTraits<TA>::lane;
  constexpr int S = AmpcTableTraits<TA>::slots;
  constexpr int D = DS + DC;
  static_assert(CT == 1 || CT == D, "a column or all columns a thread");
  static_assert(BM || DC == 1, "the packed lanes-last plane is dc = 1");
  static_assert(relin_smem(DS, DC, BM, NL) <= AMPC_RELIN_STATIC_SMEM, "static shared memory");
  __shared__ float s_coef[DS * AMPC_MAX_F];
  // Batch-major staging, one padded row a point (odd strides at ds = 4:
  // no bank conflict when a warp writes one column of 32 points).
  __shared__ float s_jx[BM ? NL : 1][DS * DS + 1];
  __shared__ float s_ju[BM ? NL : 1][DS * DC + 1];
  const int tid = threadIdx.y * NL + threadIdx.x;
  if constexpr (!LANE) {
    for (int i = tid; i < DS * T.n; i += NL * CT) s_coef[i] = coeffs[i];
    __syncthreads();
  }

  const int dd0 = CT == 1 ? 0 : (int)threadIdx.y;  // first column
  long long p0 = 0;  // batch-major: the block's first point
  int b, t, np = NL;
  bool valid;
  if (BM) {
    const long long n = (long long)B * H;
    p0 = (long long)blockIdx.x * NL;
    const long long p = p0 + threadIdx.x;
    np = (int)(n - p0 < NL ? n - p0 : NL);
    valid = p < n;
    const long long q = valid ? p : n - 1;
    b = (int)(q / H);
    t = (int)(q - (long long)b * H);
  } else {
    t = blockIdx.y;
    b = blockIdx.x * NL + threadIdx.x;
    valid = b < B;
  }
  if (valid) {
    float z[D];
    if (BM) {
      const float* row = xs + ((long long)b * (H + 1) + t) * DS;
#pragma unroll
      for (int i = 0; i < DS; ++i) z[i] = row[i];
#pragma unroll
      for (int j = 0; j < DC; ++j) z[DS + j] = us[((long long)b * H + t) * DC + j];
    } else {
#pragma unroll
      for (int i = 0; i < DS; ++i) z[i] = xs[((long long)t * DS + i) * B + b];
      z[DS] = us[(long long)t * B + b];
    }
#pragma unroll
    for (int dd = dd0; dd < D; dd += CT) {
      float col[DS];
      if constexpr (LANE)
        ampc_jac_col_cv<DS, D, S>(ampc_table(T), CoefLane{coeffs + b, T.n, B}, z,
                                  dd, col);
      else
        ampc_jac_col<DS, D>(T, s_coef, z, dd, col);
#pragma unroll
      for (int i = 0; i < DS; ++i) {
        if (!BM)
          jac[((long long)t * DS * D + i * D + dd) * B + b] = col[i];
        else if (dd < DS)
          s_jx[threadIdx.x][i * DS + dd] = col[i];
        else
          s_ju[threadIdx.x][i * DC + dd - DS] = col[i];
      }
    }
  }
  if (!BM) return;
  __syncthreads();
  float* jx_out = jac + p0 * DS * DS;
  for (int o = tid; o < np * DS * DS; o += NL * CT)
    jx_out[o] = s_jx[o / (DS * DS)][o % (DS * DS)];
  float* ju_out = Ju + p0 * DS * DC;
  for (int o = tid; o < np * DS * DC; o += NL * CT)
    ju_out[o] = s_ju[o / (DS * DC)][o % (DS * DC)];
}

template <int DS, int DC, bool BM, int CT, int NL, class TA>
static void relin_launch(const TA& T, const float* coeffs, const float* xs,
                         const float* us, float* jac, float* Ju, int H, int B,
                         cudaStream_t s) {
  const dim3 block(NL, CT);
  if constexpr (BM) {
    const long long n = (long long)B * H;
    const unsigned grid = (unsigned)((n + NL - 1) / NL);
    relin_kernel<DS, DC, true, CT, NL, TA><<<grid, block, 0, s>>>(T, coeffs, xs, us,
                                                                 jac, Ju, H, B);
  } else {
    const dim3 grid((unsigned)((B + NL - 1) / NL), (unsigned)H);
    relin_kernel<DS, DC, false, CT, NL, TA><<<grid, block, 0, s>>>(T, coeffs, xs, us,
                                                                  jac, Ju, H, B);
  }
}

// split: a thread per (point, column), else a thread per point where
// that block's staging fits (relin_whole_fits; the wrapper's
// relin_geometry decides the same).
template <int DS, int DC, bool BM, class TA>
static void relin_dispatch(const TA& T, const float* coeffs, const float* xs,
                           const float* us, float* jac, float* Ju, int H, int B,
                           int split, cudaStream_t s) {
  if constexpr (relin_whole_fits(DS, DC, BM)) {
    if (!split) {
      relin_launch<DS, DC, BM, 1, AMPC_RELIN_WHOLE_LANES>(T, coeffs, xs, us, jac, Ju, H,
                                                          B, s);
      return;
    }
  }
  relin_launch<DS, DC, BM, DS + DC, relin_split_lanes(DS, DC, BM)>(T, coeffs, xs, us,
                                                                   jac, Ju, H, B, s);
}

static int relin_check(int n, int d, int max_n, int H, int B, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d > AMPC_MAX_D || n < 1 || n > max_n || H < 1 || H > 65535 || B < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The (ds, dc) instances of this object: the main library's (4, 1), or
// the one shape of a library built at first use (-DAMPC_DS, -DAMPC_DC;
// ops/_build.py: shape_library). Another shape is refused.
#ifdef AMPC_DS
#define AMPC_RELIN_SHAPE(ds, dc) ((ds) == AMPC_DS && (dc) == AMPC_DC)
#else
#define AMPC_DS 4
#define AMPC_DC 1
#define AMPC_RELIN_SHAPE(ds, dc) ((ds) == 4 && (dc) == 1)
#define AMPC_RELIN_LANE_INSTANCES
#endif

// The shared-coefficient entries at (ds, dc); the lanes-last layout
// takes dc = 1.
template <bool BM>
static int relin_shared(const FeatTable* T, const float* coeffs, const float* xs,
                        const float* us, float* jac, float* Ju, int ds, int dc, int H,
                        int B, int split, int device, void* stream) {
  const int rc = relin_check(T->n, T->d, AMPC_MAX_F, H, B, device);
  if (rc) return rc;
  if (!AMPC_RELIN_SHAPE(ds, dc) || T->d != ds + dc || (!BM && dc != 1))
    return (int)cudaErrorInvalidValue;
  if constexpr (BM || AMPC_DC == 1)
    relin_dispatch<AMPC_DS, AMPC_DC, BM>(*T, coeffs, xs, us, jac, Ju, H, B, split,
                                         (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// Lanes-last: a grid of (ceil(B / NL), H) blocks of (NL, CT) threads;
// thread (x, y) of block (bx, t) takes lane bx * NL + x at step t, columns
// y, y + CT, ... (split: NL = relin_split_lanes, CT = ds+1; whole: NL =
// AMPC_RELIN_WHOLE_LANES, CT = 1). dc = 1.
extern "C" int ampc_relin_jacobians(const FeatTable* T, const float* coeffs,
                                    const float* xsT, const float* usT,
                                    float* jac, int ds, int H, int B,
                                    int split, int device, void* stream) {
  return relin_shared<false>(T, coeffs, xsT, usT, jac, nullptr, ds, 1, H, B, split, device,
                             stream);
}

// Batch-major: a grid of ceil(B H / NL) blocks of (NL, CT) threads; thread
// (x, y) of block bx takes point p = bx * NL + x of the flattened (B, H),
// lane b = p / H, step t = p % H, columns y, y + CT, ...; us (B, H, dc),
// Ju (B, H, ds, dc).
extern "C" int ampc_relin_jacobians_bm(const FeatTable* T,
                                       const float* coeffs, const float* xs,
                                       const float* us, float* Jx, float* Ju,
                                       int ds, int dc, int H, int B, int split,
                                       int device, void* stream) {
  return relin_shared<true>(T, coeffs, xs, us, Jx, Ju, ds, dc, H, B, split, device, stream);
}

#ifdef AMPC_RELIN_LANE_INSTANCES
// The per-lane instances (main library only, at (4, 1)): the device table
// Tdev of n terms, coefficients a lanes-last (ds, n, B) plane; trees of
// AMPC_TREE_SLOTS slots up to AMPC_MAX_F terms, else AMPC_TREE_SLOTS_BIG.
template <bool BM>
static int relin_lane(const FeatTableBig* Tdev, int n, const float* coeffs,
                      const float* xs, const float* us, float* jac, float* Ju,
                      int ds, int H, int B, int split, int device,
                      void* stream) {
  const int rc = relin_check(n, ds + 1, AMPC_MAX_F_BIG, H, B, device);
  if (rc) return rc;
  if (!AMPC_RELIN_SHAPE(ds, 1)) return (int)cudaErrorInvalidValue;
  if (n <= AMPC_MAX_F)
    relin_dispatch<4, 1, BM>(FeatTableRef<AMPC_TREE_SLOTS>{Tdev, n}, coeffs, xs, us, jac,
                             Ju, H, B, split, (cudaStream_t)stream);
  else
    relin_dispatch<4, 1, BM>(FeatTableRef<AMPC_TREE_SLOTS_BIG>{Tdev, n}, coeffs, xs, us,
                             jac, Ju, H, B, split, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The two entries with per-lane coefficients (a lanes-last (ds, n, B)
// plane, lane b's column read by every thread of lane b), the term
// table in device memory: the same geometry and the same sums.
extern "C" int ampc_relin_jacobians_lane(const FeatTableBig* Tdev, int n,
                                         const float* coeffs, const float* xsT,
                                         const float* usT, float* jac, int ds,
                                         int H, int B, int split, int device,
                                         void* stream) {
  return relin_lane<false>(Tdev, n, coeffs, xsT, usT, jac, nullptr, ds, H, B,
                           split, device, stream);
}

extern "C" int ampc_relin_jacobians_bm_lane(const FeatTableBig* Tdev, int n,
                                            const float* coeffs,
                                            const float* xs, const float* us,
                                            float* Jx, float* Ju, int ds, int H,
                                            int B, int split, int device,
                                            void* stream) {
  return relin_lane<true>(Tdev, n, coeffs, xs, us, Jx, Ju, ds, H, B, split,
                          device, stream);
}
#endif
