// K=3 complex-mask apply with phase rotation, one pass over the spectrum.
//
// Replaces two Pallas TPU kernels of lass_tpu/ops/pallas_masking.py:
// apply_complex_mask_ri (B1: body _kernel_ri, formula _mask_math_from_ri),
// which takes the mixture as its raw spectrum (re, im), and
// apply_complex_mask (B2: body _kernel, formula _mask_math), which takes
// it as precomputed mag, cos and sin. One kernel template serves both;
// the per-element chain is lass::mask_one / lass::mask_apply in
// mask_math.cuh, so the formula exists once.
//
// What bounds it on an H100: memory. Five (B2: six) float32 inputs are
// read and two float32 outputs written, 28 (32) bytes per element for
// some 30 floating-point operations. At the serving shape (B=16 clips of
// 10 s: N=16, T=1001, F=512) that is 229.6 MB (262.4 MB), 68.5 us
// (78.3 us) at the data sheet's 3.35 TB/s.
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

// x[0..2] are the logits (l_mag, l_real, l_imag); the mixture is x[3..4]
// (re, im) or, in the six-input mode, x[3..5] (mag, cos, sin)
struct MaskArgs {
  View x[6];
  float* out_re;
  float* out_im;
  int64_t n, t, f;
};

template <int kVec>
__device__ __forceinline__ void load(const View& v, int64_t n, int64_t t,
                                     int64_t col, float* dst) {
  const float* p = v.ptr + n * v.sn + t * v.st + col;
  if constexpr (kVec == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    dst[0] = q.x;
    dst[1] = q.y;
    dst[2] = q.z;
    dst[3] = q.w;
  } else {
    dst[0] = *p;
  }
}

template <int kVec, int kInputs>  // kInputs 5: raw re/im; 6: mag/cos/sin
__global__ void __launch_bounds__(256) apply_complex_mask_kernel(MaskArgs a) {
  const int64_t per_row = a.f / kVec;
  const int64_t total = a.n * a.t * per_row;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int64_t row = i / per_row;
    const int64_t col = (i - row * per_row) * kVec;
    const int64_t n = row / a.t;
    const int64_t t = row - n * a.t;
    float v[kInputs][kVec];
#pragma unroll
    for (int k = 0; k < kInputs; ++k) load<kVec>(a.x[k], n, t, col, v[k]);
    float r[kVec], m[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if constexpr (kInputs == 5) {
        lass::mask_one(v[0][j], v[1][j], v[2][j], v[3][j], v[4][j], &r[j],
                       &m[j]);
      } else {
        lass::mask_apply(v[0][j], v[1][j], v[2][j], v[3][j], v[4][j],
                         v[5][j], &r[j], &m[j]);
      }
    }
    const int64_t o = row * a.f + col;
    if constexpr (kVec == 4) {
      *reinterpret_cast<float4*>(a.out_re + o) =
          make_float4(r[0], r[1], r[2], r[3]);
      *reinterpret_cast<float4*>(a.out_im + o) =
          make_float4(m[0], m[1], m[2], m[3]);
    } else {
      a.out_re[o] = r[0];
      a.out_im[o] = m[0];
    }
  }
}

template <int kInputs>
int launch(const MaskArgs& a, bool vec4, cudaStream_t s) {
  const int kThreads = 256;
  const int64_t items = a.n * a.t * (vec4 ? a.f / 4 : a.f);
  if (items == 0) return static_cast<int>(cudaSuccess);
  // grid-stride loop: enough blocks to fill the card, capped so the grid
  // stays well inside gridDim.x limits for any length
  const int64_t blocks_needed = (items + kThreads - 1) / kThreads;
  const int blocks =
      static_cast<int>(blocks_needed < 132 * 64 ? blocks_needed : 132 * 64);
  if (vec4) {
    apply_complex_mask_kernel<4, kInputs><<<blocks, kThreads, 0, s>>>(a);
  } else {
    apply_complex_mask_kernel<1, kInputs><<<blocks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

MaskArgs make_args(const void* const* ptrs, const int64_t* strides,
                   int inputs, void* out_re, void* out_im, int64_t n,
                   int64_t t, int64_t f) {
  MaskArgs a;
  for (int k = 0; k < 6; ++k) {
    a.x[k] = k < inputs ? View{static_cast<const float*>(ptrs[k]),
                               strides[2 * k], strides[2 * k + 1]}
                        : View{nullptr, 0, 0};
  }
  a.out_re = static_cast<float*>(out_re);
  a.out_im = static_cast<float*>(out_im);
  a.n = n;
  a.t = t;
  a.f = f;
  return a;
}

}  // namespace

// C entry points bound with ctypes. Pointers and the stream come as void*,
// shapes and strides as int64; each input is (pointer, n stride, t stride).
// vec4 != 0 selects 4-wide accesses; the caller guarantees then that f and
// every stride are multiples of 4 and every pointer is 16-byte aligned.
// Each returns cudaGetLastError() after the launch (0 on success).

// B1: logits and the raw mixture spectrum (re, im)
extern "C" int lass_apply_complex_mask_ri(
    const void* l_mag, int64_t l_mag_sn, int64_t l_mag_st,
    const void* l_real, int64_t l_real_sn, int64_t l_real_st,
    const void* l_imag, int64_t l_imag_sn, int64_t l_imag_st,
    const void* re, int64_t re_sn, int64_t re_st,
    const void* im, int64_t im_sn, int64_t im_st,
    void* out_re, void* out_im, int64_t n, int64_t t, int64_t f,
    int64_t vec4, void* stream) {
  const void* ptrs[5] = {l_mag, l_real, l_imag, re, im};
  const int64_t strides[10] = {l_mag_sn,  l_mag_st, l_real_sn, l_real_st,
                               l_imag_sn, l_imag_st, re_sn,    re_st,
                               im_sn,     im_st};
  return launch<5>(make_args(ptrs, strides, 5, out_re, out_im, n, t, f),
                   vec4 != 0, static_cast<cudaStream_t>(stream));
}

// B2, the six-input mode: logits and the mixture's mag, cos and sin
// (lass_tpu/ops/pallas_masking.py apply_complex_mask)
extern "C" int lass_apply_complex_mask(
    const void* l_mag, int64_t l_mag_sn, int64_t l_mag_st,
    const void* l_real, int64_t l_real_sn, int64_t l_real_st,
    const void* l_imag, int64_t l_imag_sn, int64_t l_imag_st,
    const void* mag, int64_t mag_sn, int64_t mag_st,
    const void* cos_in, int64_t cos_sn, int64_t cos_st,
    const void* sin_in, int64_t sin_sn, int64_t sin_st,
    void* out_re, void* out_im, int64_t n, int64_t t, int64_t f,
    int64_t vec4, void* stream) {
  const void* ptrs[6] = {l_mag, l_real, l_imag, mag, cos_in, sin_in};
  const int64_t strides[12] = {l_mag_sn,  l_mag_st, l_real_sn, l_real_st,
                               l_imag_sn, l_imag_st, mag_sn,   mag_st,
                               cos_sn,    cos_st,   sin_sn,    sin_st};
  return launch<6>(make_args(ptrs, strides, 6, out_re, out_im, n, t, f),
                   vec4 != 0, static_cast<cudaStream_t>(stream));
}
