// Small helpers shared by the tensor-core conv kernels (act_conv.cu,
// convblock.cu, convt.cu, head_mask.cu, timetap_conv.cu): 16-byte bf16
// vector moves, the leaky ReLU, the dynamic shared memory opt-in, and the
// size of a persistent grid.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lass {

constexpr float kNegSlope = 0.01f;

// leaky ReLU in float32: max(v, 0.01 * v)
__device__ __forceinline__ float leaky(float v) {
  return fmaxf(v, __fmul_rn(kNegSlope, v));
}

// a * x + b rounded after the product and after the sum (no contraction
// into an FMA), as the plain version's separate multiply and add compute it
__device__ __forceinline__ float affine(float a, float x, float b) {
  return __fadd_rn(__fmul_rn(a, x), b);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// eight bf16 values held in a 16-byte word -> float32
__device__ __forceinline__ void unpack8(uint4 raw, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// eight bf16 values at a 16-byte aligned address -> float32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  unpack8(raw, v);
}

// eight float32 values -> bf16 (round to nearest even) at a 16-byte
// aligned address
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void zero8(__nv_bfloat16* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
}

// 16-byte loads each thread keeps in flight while it fills a tile
constexpr int kLoadBatch = 4;

// Copy a (rows, 8 * chunks) bf16 block from device memory (row stride
// src_ld elements) to shared memory (row stride dst_ld), every thread of
// the block taking a share with kLoadBatch 16-byte loads in flight.
// Strides, pointers and the copied width must be 16-byte aligned.
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int dst_ld,
                                          const __nv_bfloat16* src,
                                          int64_t src_ld, int rows,
                                          int chunks) {
  const int total = rows * chunks;
  const int step = blockDim.x;
  for (int base = threadIdx.x; base < total; base += kLoadBatch * step) {
    uint4 raw[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * step;
      if (idx < total) {
        const int r = idx / chunks;
        raw[u] = *reinterpret_cast<const uint4*>(
            src + r * src_ld + (idx - r * chunks) * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = base + u * step;
      if (idx < total) {
        const int r = idx / chunks;
        *reinterpret_cast<uint4*>(dst + r * dst_ld + (idx - r * chunks) * 8) =
            raw[u];
      }
    }
  }
}

// Allow `bytes` of dynamic shared memory for `kernel` (above 48 KB a
// kernel must opt in). Returns the CUDA error code.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int64_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

constexpr int64_t kMaxSmem = 232448;  // bytes a block may use on an H100

// How many blocks of `kernel` (`threads` threads, `bytes` of dynamic shared
// memory) the current device holds at once: the size of a persistent grid.
// Returns the CUDA error code; *blocks is 0 if none fits.
template <typename Kernel>
inline int resident_blocks(Kernel kernel, int threads, int64_t bytes,
                           int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, static_cast<size_t>(bytes));
  *blocks = sms * per_sm;
  if (err == cudaSuccess && *blocks == 0) err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace lass
