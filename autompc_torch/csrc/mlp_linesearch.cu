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
// core products cost lanes their convergence. Design: the weights sit in
// shared memory for the whole launch; a lane's L rollouts share one thread
// group of 64 x G threads (G = ceil(L / 5)), thread (k, g) computes hidden
// unit k for the 5 rollouts of group g, so one weight load feeds 5 FMAs
// and the 5 activations come from one broadcast 16-byte load plus one
// 4-byte load. The lane's gains, xbar, ubar and k of step t + 1 are
// fetched into registers while step t computes. Large batches put two
// lanes in a block so that one wave of blocks covers B = 1024.
#include <cuda_runtime.h>

#define AMPC_MLP_MAX_LAYERS 5
#define AMPC_MLP_MAX_W 128
#define AMPC_MLP_MAX_DC 32
#define AMPC_MLP_MAX_L 10
#define AMPC_MLP_RPT 5     // rollouts per thread
#define AMPC_MLP_SLOT 8    // floats reserved per rollout group (16-byte rows)
#define AMPC_MLP_TX 64     // threads along the hidden units
#define AMPC_MLP_PF 8      // prefetch registers per thread

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

// Floats of shared memory: the weights, then per lane of the block the
// activations z, two hidden buffers and the staged step inputs.
__host__ __device__ inline int mlp_weight_floats(const MlpLS& P) {
  int n = 0;
  for (int li = 0; li < P.n_layers; ++li)
    n += (P.widths[li] + 1) * P.widths[li + 1];
  return n;
}
__host__ __device__ inline int mlp_max_width(const MlpLS& P) {
  int w = 0;
  for (int li = 1; li <= P.n_layers; ++li)
    w = P.widths[li] > w ? P.widths[li] : w;
  return w;
}
__host__ __device__ inline int mlp_lane_floats(const MlpLS& P, int LP) {
  return r4((P.ds + P.dc) * LP) + 2 * r4(mlp_max_width(P) * LP) +
         r4(P.dc * P.ds + P.ds + 2 * P.dc);
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

__global__ void mlp_ls_kernel(
    const __grid_constant__ MlpLS P, const float* __restrict__ weights,
    const float* __restrict__ x0, const float* __restrict__ xs,
    const float* __restrict__ us, const float* __restrict__ Ks,
    const float* __restrict__ ks, float* __restrict__ out_xs,
    float* __restrict__ out_us, int H, int B) {
  constexpr int RPT = AMPC_MLP_RPT, SLOT = AMPC_MLP_SLOT, TX = AMPC_MLP_TX;
  constexpr int PF = AMPC_MLP_PF;
  extern __shared__ __align__(16) float smem[];
  const int ds = P.ds, dc = P.dc, L = P.L;
  const int tx = threadIdx.x, g = threadIdx.y, lz = threadIdx.z;
  const int G = blockDim.y, LP = G * SLOT, NTL = TX * G;
  const int tidl = g * TX + tx;
  const int flat = lz * NTL + tidl, nthreads = NTL * blockDim.z;
  const long long lane_raw = (long long)blockIdx.x * blockDim.z + lz;
  const bool valid = lane_raw < B;
  const long long lane = valid ? lane_raw : B - 1;

  const int wtot = mlp_weight_floats(P);
  float* sW = smem;
  float* base = smem + r4(wtot) + lz * mlp_lane_floats(P, LP);
  float* z = base;
  float* hA = z + r4((ds + dc) * LP);
  float* hB = hA + r4(mlp_max_width(P) * LP);
  float* sIn = hB + r4(mlp_max_width(P) * LP);
  const float* sKs = sIn;
  const float* sxb = sIn + dc * ds;
  const float* sub = sxb + ds;
  const float* skk = sub + dc;
  const int nin = dc * ds + ds + 2 * dc;

  for (int i = flat; i < wtot; i += nthreads) sW[i] = weights[i];
  for (int e = tidl; e < ds * LP; e += NTL) z[e] = x0[lane * ds + e / LP];
  for (int e = ds * LP + tidl; e < (ds + dc) * LP; e += NTL) z[e] = 0.f;
  if (valid)
    for (int e = tidl; e < L * ds; e += NTL)
      out_xs[((lane * L + e / ds) * (H + 1)) * ds + e % ds] =
          x0[lane * ds + e % ds];

  float pf[PF];
  auto fetch = [&](int t) {
#pragma unroll
    for (int r = 0; r < PF; ++r) {
      int i = tidl + r * NTL;
      if (i < dc * ds) {
        pf[r] = Ks[(lane * H + t) * dc * ds + i];
      } else if ((i -= dc * ds) < ds) {
        pf[r] = xs[(lane * (H + 1) + t) * ds + i];
      } else if ((i -= ds) < dc) {
        pf[r] = us[(lane * H + t) * dc + i];
      } else if ((i -= dc) < dc) {
        pf[r] = ks[(lane * H + t) * dc + i];
      }
    }
  };
  fetch(0);

  for (int t = 0; t < H; ++t) {
#pragma unroll
    for (int r = 0; r < PF; ++r) {
      const int i = tidl + r * NTL;
      if (i < nin) sIn[i] = pf[r];
    }
    __syncthreads();  // also orders the previous step's update of z
    if (t + 1 < H) fetch(t + 1);

    // Controls of every rollout of the lane.
    for (int e = tidl; e < dc * L; e += NTL) {
      const int j = e / L, l = e % L;
      const int slot = (l / RPT) * SLOT + l % RPT;
      float s = sKs[j * ds] * (z[slot] - sxb[0]);
      for (int i = 1; i < ds; ++i)
        s = s + sKs[j * ds + i] * (z[i * LP + slot] - sxb[i]);
      float u = P.alphas[l] * skk[j] + sub[j] + s;
      u = u < P.umin[j] ? P.umin[j] : (u > P.umax[j] ? P.umax[j] : u);
      z[(ds + j) * LP + slot] = u;
      if (valid) out_us[((lane * L + l) * H + t) * dc + j] = u;
    }
    __syncthreads();

    // The layer stack; each layer reads `in` and writes the other buffer.
    const float* in = z;
    const float* Wl = sW;
    for (int li = 0; li < P.n_layers; ++li) {
      const int n_in = P.widths[li], n_out = P.widths[li + 1];
      const float* bl = Wl + n_in * n_out;
      float* out = (li & 1) ? hB : hA;
      const bool last = li == P.n_layers - 1;
      for (int k = tx; k < n_out; k += TX) {
        float acc[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
        const float* ing = in + g * SLOT;
        for (int c = 0; c < n_in; ++c) {
          const float w = Wl[c * n_out + k];
          const float4 a = *reinterpret_cast<const float4*>(ing + c * LP);
          const float a4 = ing[c * LP + 4];
          acc[0] = acc[0] + a.x * w;
          acc[1] = acc[1] + a.y * w;
          acc[2] = acc[2] + a.z * w;
          acc[3] = acc[3] + a.w * w;
          acc[4] = acc[4] + a4 * w;
        }
        const float bias = bl[k];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float v = acc[r] + bias;
          out[k * LP + g * SLOT + r] = last ? v : mlp_act(v, P.act);
        }
      }
      __syncthreads();
      in = out;
      Wl = bl + n_out;
    }

    // x <- x + net([x; u]); `in` is the head's output.
    for (int i = tx; i < ds; i += TX) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int l = g * RPT + r;
        const float xn = z[i * LP + g * SLOT + r] + in[i * LP + g * SLOT + r];
        z[i * LP + g * SLOT + r] = xn;
        if (valid && l < L)
          out_xs[((lane * L + l) * (H + 1) + t + 1) * ds + i] = xn;
      }
    }
  }
}

extern "C" int ampc_mlp_line_search(
    const MlpLS* P, const float* weights, const float* x0, const float* xs,
    const float* us, const float* Ks, const float* ks, float* out_xs,
    float* out_us, int H, int B, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || B < 1 || P->L < 1 || P->L > AMPC_MLP_MAX_L ||
      P->n_layers < 1 || P->n_layers > AMPC_MLP_MAX_LAYERS ||
      P->dc < 1 || P->dc > AMPC_MLP_MAX_DC || P->act < 0 || P->act > 3 ||
      P->widths[0] != P->ds + P->dc || P->widths[P->n_layers] != P->ds)
    return (int)cudaErrorInvalidValue;
  for (int li = 0; li <= P->n_layers; ++li)
    if (P->widths[li] < 1 || P->widths[li] > AMPC_MLP_MAX_W)
      return (int)cudaErrorInvalidValue;
  const int G = (P->L + AMPC_MLP_RPT - 1) / AMPC_MLP_RPT;
  const int LP = G * AMPC_MLP_SLOT;
  if (P->dc * P->ds + P->ds + 2 * P->dc > AMPC_MLP_PF * AMPC_MLP_TX * G)
    return (int)cudaErrorInvalidValue;
  auto bytes = [&](int lpb) {
    return sizeof(float) *
           (size_t)(r4(mlp_weight_floats(*P)) + lpb * mlp_lane_floats(*P, LP));
  };
  // Two lanes per block when that still leaves two blocks per SM: at
  // B = 1024 one wave of 512 blocks then covers the batch.
  const int lpb = (B >= 512 && bytes(2) <= 110 * 1024) ? 2 : 1;
  const size_t smem = bytes(lpb);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mlp_ls_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(AMPC_MLP_TX, G, lpb);
  const unsigned blocks = (unsigned)((B + lpb - 1) / lpb);
  mlp_ls_kernel<<<blocks, block, smem, (cudaStream_t)stream>>>(
      *P, weights, x0, xs, us, Ks, ks, out_xs, out_us, H, B);
  return (int)cudaGetLastError();
}
