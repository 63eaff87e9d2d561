// Shared helpers for the annonet_tpu_torch CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace annonet {

// gridDim.y and gridDim.z are limited to 65535: batch and cout slabs are
// launched in chunks of at most this many.
constexpr int64_t kMaxGridYZ = 65535;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Makes `device` current for a launch and restores the caller's after it.
struct DeviceScope {
  int prev = -1;
  explicit DeviceScope(int device) {
    if (cudaGetDevice(&prev) != cudaSuccess || prev == device || cudaSetDevice(device) != cudaSuccess)
      prev = -1;
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// K1/K2 in bf16 (conv_igemm.cu): launches the tensor-core implicit GEMM on
// ``s`` and returns cudaGetLastError(). x, x2 (may be null when c2 == 0),
// w and out are bf16; stride is 1 or 2.
cudaError_t conv3x3_igemm_bf16(const void* x, const void* x2, const void* w,
                               const float* bias, void* out, int64_t n,
                               int64_t h, int64_t wd, int c1, int c2,
                               int cout, int stride, cudaStream_t s);

// K3 in bf16 (up_igemm.cu), both modes: launches the tensor-core GEMM on
// ``s`` and returns cudaGetLastError(). Float: x, w, out bf16, e0 the f32
// bias (s_in, e1 null), the ReLU applied where relu != 0. requant: x and
// out int8, w bf16, s_in [cin], e0 and e1 the f32 requant scale and offset
// [cout] (relu unused).
cudaError_t up2x2_igemm_bf16(const void* x, const float* s_in, const void* w,
                             const float* e0, const float* e1, void* out,
                             int64_t n, int64_t h, int64_t wd, int cin,
                             int cout, bool requant, int relu, cudaStream_t s);

}  // namespace annonet
