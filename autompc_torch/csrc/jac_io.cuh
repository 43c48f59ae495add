// Storage type of the packed Jacobian carry jac (H, ds*(ds+1), B): float,
// or bfloat16 (make_batched_ilqr_solver(jac_dtype="bf16"): half the
// carry's bytes and half the backward pass's largest stream). Compute
// stays float32: a kernel upcasts at the read (as the TPU kernels'
// load_jac does, autompc_tpu/ops/pallas_riccati.py:383-390) and rounds
// to nearest even at the write (as an XLA / PyTorch float32 -> bfloat16
// convert does).
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float ampc_jac_load(float v) { return v; }
__device__ __forceinline__ float ampc_jac_load(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename JT>
__device__ __forceinline__ JT ampc_jac_store(float v);
template <>
__device__ __forceinline__ float ampc_jac_store<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 ampc_jac_store<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
