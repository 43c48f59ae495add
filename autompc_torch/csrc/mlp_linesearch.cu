// K5: all-alpha closed-loop line-search rollouts through a folded MLP.
//
// Replaces the Pallas TPU kernels of
// autompc_tpu/ops/pallas_mlp_linesearch.py: _mlp_ls_kernel (slab),
// _mlp_ls_kernel_feat and _mlp_ls_kernel_mxu, which are one function in
// three TPU data layouts, at precision "highest". For each lane b and step
// size l, from x = x0, for t = 0 .. H-1:
//   u = clip(alpha_l k_t + ubar_t + K_t (x - xbar_t), umin, umax)
//   x <- x + net([x; u])
// with net a plain stack (hidden layers act(z W + b), linear head; the
// z-scoring is folded into the first and last layer by the wrapper). Every
// x and u is written: ls_xs (B, L, H+1, ds) with the x0 row, ls_us
// (B, L, H, dc).
//
// What bounds it on an H100: operations. The B x L rollouts are
// independent 200-step chains of three small products (13.8 kflop per
// rollout-step at 24-64-64-18, 27.8 GFLOP at B = 1024, L = 10, H = 200:
// ~0.4 ms at the f32 FMA rate) against ~285 MB of gains in and
// trajectories out. Products are plain f32 FMAs: TF32 or split-bf16 tensor
// core products cost lanes their convergence. Design:
//   - A block takes a tile of R = NL x L rollouts (NL lanes, all their step
//     sizes, up to 40 rollouts; NL and the threads from the wrapper's
//     mlp_geometry: at B = 1024, 20 rollouts and 160 threads a block, four
//     blocks an SM, all resident at once). Rollout r of the block is
//     global rollout blockIdx.x * R + r = (lane, l) of the output.
//   - The weights sit in shared memory once per block, each layer's output
//     columns padded to a multiple of 4; the tile's activations too,
//     feature-major (row c holds the R rollouts' c-th input, padded to RP,
//     a multiple of 4).
//   - Each thread computes a register tile of a layer, up to 4 rollouts x
//     4 units: per input c one 16-byte load of activations and one of
//     weights feed 16 FMAs. Per layer the block takes the tile shape (4 x 4,
//     2 x 4, 2 x 2, 1 x 2, 1 x 1) that needs the fewest rounds of its
//     threads, the smallest of those: a narrow head takes small tiles, and
//     a block sized for one 2 x 4 tile a thread (a grid that fits on the
//     card at once, bound by each thread's chain) takes 2 x 4 tiles on the
//     wide layers. Each output keeps the summation order of the
//     one-rollout-per-output form (c = 0 .. n_in-1 into 0, then the bias),
//     whatever its tile.
//   - At most 320 threads and 96 registers a thread
//     (__launch_bounds__(320, 2)), so at least two blocks share an SM and
//     the warps of one cover the barriers of another.
//   - Step t + 1's gains, xbar, ubar and k are copied into a second shared
//     buffer by cp.async while step t computes.
#include <cuda_runtime.h>
#include <stdint.h>

#define AMPC_MLP_MAX_LAYERS 5
#define AMPC_MLP_MAX_W 128
#define AMPC_MLP_MAX_DC 32
#define AMPC_MLP_MAX_L 10
#define AMPC_MLP_TILE 4  // a thread's largest tile: 4 rollouts x 4 units
#define AMPC_MLP_MAX_THREADS 320

struct MlpLS {
  int n_layers;
  int widths[AMPC_MLP_MAX_LAYERS + 1];
  int act;  // 0 relu, 1 tanh, 2 sigmoid, 3 selu
  int ds, dc, L;
  float alphas[AMPC_MLP_MAX_L];
  float umin[AMPC_MLP_MAX_DC];
  float umax[AMPC_MLP_MAX_DC];
};

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }

// Shared memory of a block of nl lanes, in floats: the padded weights,
// the activations z ((ds + dc) x RP), two hidden buffers (max width x RP)
// and the staged step inputs (two buffers of nl x r4(nin)).
struct MlpSmem {
  int rp, nin, w, z, h, in, total;
};

__host__ __device__ inline MlpSmem mlp_smem(const MlpLS& P, int nl) {
  MlpSmem S;
  S.rp = r4(nl * P.L);
  S.nin = P.dc * P.ds + P.ds + 2 * P.dc;
  int wtot = 0, maxw = 0;
  for (int li = 0; li < P.n_layers; ++li) {
    wtot += (P.widths[li] + 1) * r4(P.widths[li + 1]);
    maxw = P.widths[li + 1] > maxw ? P.widths[li + 1] : maxw;
  }
  S.w = 0;
  S.z = S.w + wtot;
  S.h = S.z + (P.ds + P.dc) * S.rp;
  S.in = S.h + 2 * maxw * S.rp;
  S.total = S.in + 2 * nl * r4(S.nin);
  return S;
}

// NaN passes through the activation and the control clip, as it does in
// the plain version (fmaxf and fminf would drop it): a lane whose gains
// are NaN must not come out with finite controls at the bounds.
__device__ inline float mlp_act(float a, int kind) {
  switch (kind) {
    case 0: return a < 0.f ? 0.f : a;
    case 1: return tanhf(a);
    case 2: return 1.f / (1.f + expf(-a));
    default:
      return 1.0507009873554805f *
             (a > 0.f ? a : 1.6732632423543772f * expm1f(a));
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void mlp_load(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void mlp_store(float* p, const float (&v)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (N == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    p[0] = v[0];
}

// One layer over the block's rollouts, out[k][r] = act(sum_c in[c][r]
// W[c][k] + b[k]), in register tiles of TR rollouts x TU units: per input
// c one TR-vector of activations and one TU-vector of weights feed TR x TU
// FMAs. Each output sums c = 0 .. n_in-1 into 0, then adds the bias,
// whatever the tile. A warp's tiles run along the rollouts, so its stores
// of a unit's row are consecutive.
template <int TR, int TU>
__device__ __forceinline__ void mlp_layer(const float* in, const float* Wl,
                                          float* out, int n_in, int n_out,
                                          int nop, int RP, bool last, int act,
                                          int tid, int nt) {
  const int nrg = RP / TR, nug = (n_out + TU - 1) / TU;
  for (int tile = tid; tile < nrg * nug; tile += nt) {
    const int ug = tile / nrg, rg = tile - ug * nrg;
    const float* ap = in + TR * rg;
    const float* wp = Wl + TU * ug;
    float acc[TR][TU];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int k = 0; k < TU; ++k) acc[a][k] = 0.f;
#pragma unroll 4
    for (int c = 0; c < n_in; ++c) {
      float av[TR], wv[TU];
      mlp_load<TR>(ap + c * RP, av);
      mlp_load<TU>(wp + c * nop, wv);
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int k = 0; k < TU; ++k) acc[a][k] = acc[a][k] + av[a] * wv[k];
    }
    float bv[TU];
    mlp_load<TU>(wp + n_in * nop, bv);
#pragma unroll
    for (int k = 0; k < TU; ++k) {
      if (TU * ug + k < n_out) {
        float v[TR];
#pragma unroll
        for (int a = 0; a < TR; ++a) {
          v[a] = acc[a][k] + bv[k];
          v[a] = last ? v[a] : mlp_act(v[a], act);
        }
        mlp_store<TR>(out + (TU * ug + k) * RP + TR * rg, v);
      }
    }
  }
}

__global__ void __launch_bounds__(AMPC_MLP_MAX_THREADS, 2) mlp_ls_kernel(
    const __grid_constant__ MlpLS P, const float* __restrict__ weights,
    const float* __restrict__ x0, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ Ks,
    const float* __restrict__ ks, float* __restrict__ out_xs,
    float* __restrict__ out_us, int H, int B, int nl) {
  extern __shared__ __align__(16) float smem[];
  const int ds = P.ds, dc = P.dc, L = P.L;
  const int tid = threadIdx.x, nt = blockDim.x;
  const MlpSmem S = mlp_smem(P, nl);
  const int R = nl * L, RP = S.rp, nin = S.nin, NINP = r4(nin);
  const long long lane0 = (long long)blockIdx.x * nl;
  const long long g0 = lane0 * L, G = (long long)B * L;
  float* sW = smem + S.w;
  float* z = smem + S.z;
  float* hA = smem + S.h;
  float* hB = hA + (S.in - S.h) / 2;
  float* sIn = smem + S.in;

  // Weights, each layer's (n_in + 1) x n_out block (bias row last) with
  // its columns padded to r4(n_out) by zeros.
  {
    float* dst = sW;
    const float* src = weights;
    for (int li = 0; li < P.n_layers; ++li) {
      const int n_in = P.widths[li], n_out = P.widths[li + 1], nop = r4(n_out);
      const int cnt = (n_in + 1) * nop;
      for (int i = tid; i < cnt; i += nt) {
        const int c = i / nop, k = i - c * nop;
        dst[i] = k < n_out ? src[c * n_out + k] : 0.f;
      }
      dst += cnt;
      src += (n_in + 1) * n_out;
    }
  }
  // Initial states; the controls' rows and the padded rollouts start at 0.
  for (int e = tid; e < (ds + dc) * RP; e += nt) {
    const int i = e / RP, r = e - i * RP;
    long long lane = lane0 + r / L;
    lane = lane < B ? lane : B - 1;
    z[e] = (r < R && i < ds) ? x0[lane * ds + i] : 0.f;
  }
  for (int e = tid; e < R * ds; e += nt) {
    const int r = e / ds, i = e - r * ds;
    const long long g = g0 + r;
    if (g < G) out_xs[g * (H + 1) * ds + i] = x0[(g / L) * ds + i];
  }

  // Step t's inputs of lane ll at buf + ll * NINP: Ks (dc x ds), xbar (ds),
  // ubar (dc), k (dc).
  auto stage = [&](int t, float* buf) {
    for (int ll = 0; ll < nl; ++ll) {
      long long lane = lane0 + ll;
      lane = lane < B ? lane : B - 1;
      for (int i = tid; i < nin; i += nt) {
        const float* src;
        int q = i;
        if (q < dc * ds) {
          src = Ks + (lane * H + t) * dc * ds + q;
        } else if ((q -= dc * ds) < ds) {
          src = xs + (lane * (H + 1) + t) * ds + q;
        } else if ((q -= ds) < dc) {
          src = us + (lane * H + t) * dc + q;
        } else {
          src = ks + (lane * H + t) * dc + (q - dc);
        }
        cp_async4(buf + ll * NINP + i, src);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0, sIn);

  for (int t = 0; t < H; ++t) {
    const float* cur = sIn + (t & 1) * nl * NINP;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // step t's inputs, and the previous step's z, in place
    if (t + 1 < H) stage(t + 1, sIn + ((t + 1) & 1) * nl * NINP);

    // Controls of every rollout of the tile.
    for (int e = tid; e < R * dc; e += nt) {
      const int r = e / dc, j = e - r * dc;
      const int ll = r / L, l = r - ll * L;
      const float* sKs = cur + ll * NINP;
      const float* sxb = sKs + dc * ds;
      const float* sub = sxb + ds;
      const float* skk = sub + dc;
      float s = sKs[j * ds] * (z[r] - sxb[0]);
      for (int i = 1; i < ds; ++i)
        s = s + sKs[j * ds + i] * (z[i * RP + r] - sxb[i]);
      float u = P.alphas[l] * skk[j] + sub[j] + s;
      u = u < P.umin[j] ? P.umin[j] : (u > P.umax[j] ? P.umax[j] : u);
      z[(ds + j) * RP + r] = u;
      const long long g = g0 + r;
      if (g < G) out_us[(g * H + t) * dc + j] = u;
    }
    __syncthreads();

    // The layer stack; each layer reads `in` and writes the other buffer.
    const float* in = z;
    const float* Wl = sW;
    for (int li = 0; li < P.n_layers; ++li) {
      const int n_in = P.widths[li], n_out = P.widths[li + 1];
      float* out = (li & 1) ? hB : hA;
      const bool last = li == P.n_layers - 1;
      const int nop = r4(n_out);
      // The tile that takes the fewest rounds of the block's threads, the
      // smallest of those: the shortest chain of loads and FMAs a thread.
      constexpr int T = AMPC_MLP_TILE;
      constexpr int kTR[5] = {T, 2, 2, 1, 1}, kTU[5] = {T, T, 2, 2, 1};
      int best = 0, best_rounds = 1 << 30;
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const int tiles = (RP / kTR[q]) * ((n_out + kTU[q] - 1) / kTU[q]);
        const int rounds = (tiles + nt - 1) / nt;
        if (rounds <= best_rounds) {
          best = q;
          best_rounds = rounds;
        }
      }
      switch (best) {
        case 0: mlp_layer<T, T>(in, Wl, out, n_in, n_out, nop, RP, last, P.act, tid, nt); break;
        case 1: mlp_layer<2, 4>(in, Wl, out, n_in, n_out, nop, RP, last, P.act, tid, nt); break;
        case 2: mlp_layer<2, 2>(in, Wl, out, n_in, n_out, nop, RP, last, P.act, tid, nt); break;
        case 3: mlp_layer<1, 2>(in, Wl, out, n_in, n_out, nop, RP, last, P.act, tid, nt); break;
        default: mlp_layer<1, 1>(in, Wl, out, n_in, n_out, nop, RP, last, P.act, tid, nt);
      }
      __syncthreads();
      in = out;
      Wl += (n_in + 1) * nop;
    }

    // x <- x + net([x; u]); `in` is the head's output.
    for (int e = tid; e < R * ds; e += nt) {
      const int r = e / ds, i = e - r * ds;
      const float xn = z[i * RP + r] + in[i * RP + r];
      z[i * RP + r] = xn;
      const long long g = g0 + r;
      if (g < G) out_xs[(g * (H + 1) + t + 1) * ds + i] = xn;
    }
  }
}

static int check_params(const MlpLS* P, int lanes_per_block, int threads) {
  if (P->L < 1 || P->L > AMPC_MLP_MAX_L || P->n_layers < 1 ||
      P->n_layers > AMPC_MLP_MAX_LAYERS || P->dc < 1 ||
      P->dc > AMPC_MLP_MAX_DC || P->act < 0 || P->act > 3 ||
      P->widths[0] != P->ds + P->dc || P->widths[P->n_layers] != P->ds ||
      lanes_per_block < 1 || threads < 32 || threads > AMPC_MLP_MAX_THREADS)
    return 1;
  for (int li = 0; li <= P->n_layers; ++li)
    if (P->widths[li] < 1 || P->widths[li] > AMPC_MLP_MAX_W) return 1;
  return 0;
}

// Dynamic shared memory of a block (bytes), with the attribute set for
// sizes above 48 KB; 0 when the block would need more than 227 KB.
static size_t prepare_smem(const MlpLS* P, int lanes_per_block) {
  const size_t bytes = sizeof(float) * (size_t)mlp_smem(*P, lanes_per_block).total;
  if (bytes > 227 * 1024) return 0;
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(mlp_ls_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess)
    return 0;
  return bytes;
}

// lanes_per_block lanes (all their step sizes) and `threads` threads a
// block (the wrapper's mlp_geometry).
extern "C" int ampc_mlp_line_search(
    const MlpLS* P, const float* weights, const float* x0, const float* xs,
    const float* us, const float* Ks, const float* ks, float* out_xs,
    float* out_us, int H, int B, int lanes_per_block, int threads,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || B < 1 || check_params(P, lanes_per_block, threads))
    return (int)cudaErrorInvalidValue;
  const size_t smem = prepare_smem(P, lanes_per_block);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + lanes_per_block - 1) / lanes_per_block);
  mlp_ls_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      *P, weights, x0, xs, us, Ks, ks, out_xs, out_us, H, B, lanes_per_block);
  return (int)cudaGetLastError();
}

// The kernel's registers and local (spill) bytes a thread, and its
// resident blocks an SM at this geometry: out[0..2].
extern "C" int ampc_mlp_line_search_occupancy(const MlpLS* P,
                                              int lanes_per_block, int threads,
                                              int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (check_params(P, lanes_per_block, threads)) return (int)cudaErrorInvalidValue;
  const size_t smem = prepare_smem(P, lanes_per_block);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, mlp_ls_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mlp_ls_kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return 0;
}
