// K=3 complex-mask apply with phase rotation, one pass over the spectrum.
//
// Replaces the Pallas TPU kernel lass_tpu/ops/pallas_masking.py
// apply_complex_mask_ri (body _kernel_ri, formula _mask_math_from_ri); the
// per-element chain is lass::mask_one in mask_math.cuh.
//
// What bounds it on an H100: memory. Five float32 inputs are read and two
// float32 outputs written, 28 bytes per element for some 30 floating-point
// operations. At the serving shape (B=16 clips of 10 s: N=16, T=1001,
// F=512) that is 229.6 MB, 68.5 us at the data sheet's 3.35 TB/s.
//
// What the design does about it: one pass, no intermediate in device
// memory, and no copies around it. Each input is an (N, T, F) view with
// its own element strides for n and t and unit stride along F, so the
// wrapper hands in the channel slices of the UNet output cropped in time
// and the 513-bin spectrum cropped to 512 bins as they lie. Consecutive
// threads take consecutive elements of a row, so every load and store is
// coalesced; where every row stride and base pointer allows, a thread
// moves a 4-wide vector (16-byte accesses). The outputs are contiguous
// (N, T, F).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (lass_torch/ops/_build.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "mask_math.cuh"

namespace {

struct View {
  const float* ptr;
  int64_t sn;  // element stride between n
  int64_t st;  // element stride between t
};

struct MaskArgs {
  View l_mag, l_real, l_imag, re, im;
  float* out_re;
  float* out_im;
  int64_t n, t, f;
};

template <int kVec>
__global__ void __launch_bounds__(256)
    apply_complex_mask_ri_kernel(MaskArgs a) {
  const int64_t per_row = a.f / kVec;
  const int64_t total = a.n * a.t * per_row;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int64_t row = i / per_row;
    const int64_t col = (i - row * per_row) * kVec;
    const int64_t n = row / a.t;
    const int64_t t = row - n * a.t;
    const int64_t o_lm = n * a.l_mag.sn + t * a.l_mag.st + col;
    const int64_t o_lr = n * a.l_real.sn + t * a.l_real.st + col;
    const int64_t o_li = n * a.l_imag.sn + t * a.l_imag.st + col;
    const int64_t o_re = n * a.re.sn + t * a.re.st + col;
    const int64_t o_im = n * a.im.sn + t * a.im.st + col;
    const int64_t o_out = row * a.f + col;
    if constexpr (kVec == 4) {
      const float4 lm = *reinterpret_cast<const float4*>(a.l_mag.ptr + o_lm);
      const float4 lr = *reinterpret_cast<const float4*>(a.l_real.ptr + o_lr);
      const float4 li = *reinterpret_cast<const float4*>(a.l_imag.ptr + o_li);
      const float4 re = *reinterpret_cast<const float4*>(a.re.ptr + o_re);
      const float4 im = *reinterpret_cast<const float4*>(a.im.ptr + o_im);
      float4 r, m;
      lass::mask_one(lm.x, lr.x, li.x, re.x, im.x, &r.x, &m.x);
      lass::mask_one(lm.y, lr.y, li.y, re.y, im.y, &r.y, &m.y);
      lass::mask_one(lm.z, lr.z, li.z, re.z, im.z, &r.z, &m.z);
      lass::mask_one(lm.w, lr.w, li.w, re.w, im.w, &r.w, &m.w);
      *reinterpret_cast<float4*>(a.out_re + o_out) = r;
      *reinterpret_cast<float4*>(a.out_im + o_out) = m;
    } else {
      lass::mask_one(a.l_mag.ptr[o_lm], a.l_real.ptr[o_lr], a.l_imag.ptr[o_li],
               a.re.ptr[o_re], a.im.ptr[o_im], a.out_re + o_out,
               a.out_im + o_out);
    }
  }
}

}  // namespace

// C entry point bound with ctypes. Pointers and the stream come as void*,
// shapes and strides as int64. vec4 != 0 selects 4-wide accesses; the
// caller guarantees then that f and every stride are multiples of 4 and
// every pointer is 16-byte aligned. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int lass_apply_complex_mask_ri(
    const void* l_mag, int64_t l_mag_sn, int64_t l_mag_st,
    const void* l_real, int64_t l_real_sn, int64_t l_real_st,
    const void* l_imag, int64_t l_imag_sn, int64_t l_imag_st,
    const void* re, int64_t re_sn, int64_t re_st,
    const void* im, int64_t im_sn, int64_t im_st,
    void* out_re, void* out_im, int64_t n, int64_t t, int64_t f,
    int64_t vec4, void* stream) {
  MaskArgs a;
  a.l_mag = {static_cast<const float*>(l_mag), l_mag_sn, l_mag_st};
  a.l_real = {static_cast<const float*>(l_real), l_real_sn, l_real_st};
  a.l_imag = {static_cast<const float*>(l_imag), l_imag_sn, l_imag_st};
  a.re = {static_cast<const float*>(re), re_sn, re_st};
  a.im = {static_cast<const float*>(im), im_sn, im_st};
  a.out_re = static_cast<float*>(out_re);
  a.out_im = static_cast<float*>(out_im);
  a.n = n;
  a.t = t;
  a.f = f;
  const int kThreads = 256;
  const int64_t items = n * t * (vec4 ? f / 4 : f);
  if (items == 0) return static_cast<int>(cudaSuccess);
  // grid-stride loop: enough blocks to fill the card, capped so the grid
  // stays well inside gridDim.x limits for any length
  const int64_t blocks_needed = (items + kThreads - 1) / kThreads;
  const int blocks =
      static_cast<int>(blocks_needed < 132 * 64 ? blocks_needed : 132 * 64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    apply_complex_mask_ri_kernel<4><<<blocks, kThreads, 0, s>>>(a);
  } else {
    apply_complex_mask_ri_kernel<1><<<blocks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
