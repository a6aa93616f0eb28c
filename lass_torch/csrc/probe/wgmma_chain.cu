// Microbench of the tensor cores alone, for lass_torch.kernel_parts: each
// warpgroup loops over products on zeroed shared memory, as the fused
// conv kernels issue them, and nothing else.
//   mode 0: one group of six m64n96k16 with A and B from shared memory
//           (descriptors), then its wait (a three-tap row product);
//   mode 1: nine chained pairs of m64n32k16 with A from registers, each
//           pair a group, with at most two groups in flight (the 9-tap
//           loop of convblock.cu at 32 channels).
#include <cstdint>

#include "sm90_pipe.cuh"  // on the include path (-I lass_torch/csrc)

namespace {

constexpr int kSmem = 40960;

__device__ __forceinline__ void wgmma_m64n96k16_ss(float (&d)[48],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// no-swizzle K-major descriptor: core matrices lbo bytes apart along K,
// sbo along M or N
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}

template <int MODE>
__global__ void __launch_bounds__(128) wgmma_chain_kernel(float* out,
                                                          int iters) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s = sm90::smem_u32(smem);
  for (int i = threadIdx.x; i < kSmem / 16; i += 128)
    sm90::st_shared_zero16(s + 16 * i);
  sm90::fence_proxy_async();
  __syncthreads();
  float acc96[48] = {};
  float acc32[16] = {};
  const uint32_t fa[4] = {0, 0, 0, 0};
  for (int it = 0; it < iters; ++it) {
    if (MODE == 0) {
      sm90::fence_regs(acc96);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 6; ++k)
        wgmma_m64n96k16_ss(acc96, desc(s + k * 32, 1056, 128),
                           desc(s + 16384 + k * 3072, 128, 256));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc96);
    } else {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        sm90::fence_regs(acc32);
        sm90::wgmma_fence();
        sm90::wgmma_m64n32k16(acc32, fa,
                              sm90::desc_b(s + 16384 + tap * 2048), 1);
        sm90::wgmma_m64n32k16(acc32, fa,
                              sm90::desc_b(s + 16384 + tap * 2048 + 1024),
                              1);
        sm90::wgmma_commit();
        sm90::fence_regs(acc32);
        sm90::wgmma_wait<1>();
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc32);
    }
  }
  float t = 0.f;
  for (int i = 0; i < 48; ++i) t += acc96[i];
  for (int i = 0; i < 16; ++i) t += acc32[i];
  out[blockIdx.x * 128 + threadIdx.x] = t;
}

template <int MODE>
int run(float* out, int blocks, int iters, cudaStream_t stream) {
  auto kernel = wgmma_chain_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, 128, kSmem, stream>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: float32 of blocks * 128 (a sink for the sums). Returns
// cudaGetLastError() after the launch.
extern "C" int lass_wgmma_chain(int64_t mode, void* out, int64_t blocks,
                                int64_t iters, void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mode == 0 ? run<0>(o, int(blocks), int(iters), s)
                   : run<1>(o, int(blocks), int(iters), s);
}
