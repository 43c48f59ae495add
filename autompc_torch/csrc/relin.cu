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
#include "features.cuh"

// Points a block holds: one warp per Jacobian column (split), or a thread
// per point (whole).
#define AMPC_RELIN_SPLIT_LANES 32
#define AMPC_RELIN_WHOLE_LANES 256

template <int DS, bool BM, int CT, int NL>
__global__ void __launch_bounds__(NL* CT) relin_kernel(const __grid_constant__ FeatTable T,
                 const float* __restrict__ coeffs,
                 const float* __restrict__ xs, const float* __restrict__ us,
                 float* __restrict__ jac, float* __restrict__ Ju, int H,
                 int B) {
  constexpr int D = DS + 1;
  static_assert(CT == 1 || CT == D, "a column or all columns a thread");
  __shared__ float s_coef[DS * AMPC_MAX_F];
  // Batch-major staging, one padded row a point (odd strides: no bank
  // conflict when a warp writes one column of 32 points).
  __shared__ float s_jx[BM ? NL : 1][DS * DS + 1];
  __shared__ float s_ju[BM ? NL : 1][DS + 1];
  const int tid = threadIdx.y * NL + threadIdx.x;
  for (int i = tid; i < DS * T.n; i += NL * CT) s_coef[i] = coeffs[i];
  __syncthreads();

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
      z[DS] = us[(long long)b * H + t];
    } else {
#pragma unroll
      for (int i = 0; i < DS; ++i) z[i] = xs[((long long)t * DS + i) * B + b];
      z[DS] = us[(long long)t * B + b];
    }
#pragma unroll
    for (int dd = dd0; dd < D; dd += CT) {
      float col[DS];
      ampc_jac_col<DS, D>(T, s_coef, z, dd, col);
#pragma unroll
      for (int i = 0; i < DS; ++i) {
        if (!BM)
          jac[((long long)t * DS * D + i * D + dd) * B + b] = col[i];
        else if (dd < DS)
          s_jx[threadIdx.x][i * DS + dd] = col[i];
        else
          s_ju[threadIdx.x][i] = col[i];
      }
    }
  }
  if (!BM) return;
  __syncthreads();
  float* jx_out = jac + p0 * DS * DS;
  for (int o = tid; o < np * DS * DS; o += NL * CT)
    jx_out[o] = s_jx[o / (DS * DS)][o % (DS * DS)];
  float* ju_out = Ju + p0 * DS;
  for (int o = tid; o < np * DS; o += NL * CT) ju_out[o] = s_ju[o / DS][o % DS];
}

template <bool BM, int CT, int NL>
static void relin_launch(const FeatTable* T, const float* coeffs,
                         const float* xs, const float* us, float* jac,
                         float* Ju, int H, int B, cudaStream_t s) {
  const dim3 block(NL, CT);
  if (BM) {
    const long long n = (long long)B * H;
    const unsigned grid = (unsigned)((n + NL - 1) / NL);
    relin_kernel<4, true, CT, NL><<<grid, block, 0, s>>>(*T, coeffs, xs, us,
                                                         jac, Ju, H, B);
  } else {
    const dim3 grid((unsigned)((B + NL - 1) / NL), (unsigned)H);
    relin_kernel<4, false, CT, NL><<<grid, block, 0, s>>>(*T, coeffs, xs, us,
                                                          jac, Ju, H, B);
  }
}

template <bool BM>
static void relin_dispatch(const FeatTable* T, const float* coeffs,
                           const float* xs, const float* us, float* jac,
                           float* Ju, int H, int B, int split,
                           cudaStream_t s) {
  if (split)
    relin_launch<BM, 5, AMPC_RELIN_SPLIT_LANES>(T, coeffs, xs, us, jac, Ju, H,
                                                B, s);
  else
    relin_launch<BM, 1, AMPC_RELIN_WHOLE_LANES>(T, coeffs, xs, us, jac, Ju, H,
                                                B, s);
}

static int relin_check(const FeatTable* T, int ds, int H, int B,
                       int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ds != 4 || T->d != ds + 1 || T->n < 1 || T->n > AMPC_MAX_F || H < 1 ||
      H > 65535 || B < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Lanes-last: a grid of (ceil(B / NL), H) blocks of (NL, CT) threads;
// thread (x, y) of block (bx, t) takes lane bx * NL + x at step t, columns
// y, y + CT, ... (split: NL = AMPC_RELIN_SPLIT_LANES, CT = ds+1; whole: NL
// = AMPC_RELIN_WHOLE_LANES, CT = 1).
extern "C" int ampc_relin_jacobians(const FeatTable* T, const float* coeffs,
                                    const float* xsT, const float* usT,
                                    float* jac, int ds, int H, int B,
                                    int split, int device, void* stream) {
  const int rc = relin_check(T, ds, H, B, device);
  if (rc) return rc;
  relin_dispatch<false>(T, coeffs, xsT, usT, jac, nullptr, H, B, split,
                        (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// Batch-major: a grid of ceil(B H / NL) blocks of (NL, CT) threads; thread
// (x, y) of block bx takes point p = bx * NL + x of the flattened (B, H),
// lane b = p / H, step t = p % H, columns y, y + CT, ...
extern "C" int ampc_relin_jacobians_bm(const FeatTable* T,
                                       const float* coeffs, const float* xs,
                                       const float* us, float* Jx, float* Ju,
                                       int ds, int H, int B, int split,
                                       int device, void* stream) {
  const int rc = relin_check(T, ds, H, B, device);
  if (rc) return rc;
  relin_dispatch<true>(T, coeffs, xs, us, Jx, Ju, H, B, split,
                       (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
