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
// memory, no copies around it, and few instructions per byte. Each input
// is an (N, T, F) view with its own element strides for n and t and unit
// stride along F, so the wrapper hands in the channel slices of the UNet
// output cropped in time and the 513-bin spectrum cropped to 512 bins as
// they lie. A block is (threads per row) x (rows per block); each thread
// takes kBins = 4 consecutive bins of one row, so a warp reads whole
// 128-byte lines of each input. A row's (n, t) comes once per thread from
// a multiply-shift divisor the wrapper computes (no integer division per
// element). A thread reads its bins of each input as four scalar loads,
// which a warp coalesces into whole lines at any alignment: the
// spectrum's rows, 513 (serving) or 257 (variants) floats apart, start at
// a different alignment on each row. A row whose width is not a multiple
// of 4 ends in a partial group. The outputs are contiguous (N, T, F) and
// stored as one 16-byte vector a thread where the group is whole and
// aligned. Measured against it on the card (python -m
// lass_torch.mask_bench --variants): 16-byte loads on the rows that are
// aligned gained nothing (the logits, B2's mag/cos/sin); 8 bins a thread,
// and the unaligned rows as aligned 16-byte loads funnel-shifted across
// lanes by the row's misalignment, were slower (the shuffles and selects
// cost more issue slots than the scalar loads).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (lass_torch/ops/_build.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "mask_math.cuh"

namespace {

constexpr int kThreads = 256;  // most threads in a block
constexpr int kBins = 4;       // consecutive bins a thread takes (4 or 8)

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
  int64_t rows;       // n * t
  int64_t t;
  int64_t fast_rows;  // rows below this split with t_mul / t_shift
  int f;              // bins per row
  int groups;         // kBins-bin groups per row, ceil(f / kBins)
  uint32_t t_mul;     // row / t = umulhi(row, t_mul) >> t_shift (t_mul 0:
  uint32_t t_shift;   // t == 1)
};

// (n, t) of a row: multiply-shift below fast_rows, else 64-bit division
__device__ __forceinline__ void split_row(const MaskArgs& a, int64_t row,
                                          int64_t* n, int64_t* t) {
  if (row < a.fast_rows) {
    const uint32_t r = static_cast<uint32_t>(row);
    const uint32_t q = a.t_mul ? __umulhi(r, a.t_mul) >> a.t_shift : r;
    *n = q;
    *t = r - q * static_cast<uint32_t>(a.t);
  } else {
    *n = row / a.t;
    *t = row - *n * a.t;
  }
}

// bins [0, valid) of p, valid <= kBins, as scalar loads at any alignment
// of the row: the warp's lanes take consecutive groups, so its four loads
// touch the same 128-byte lines, which L1 keeps between them
__device__ __forceinline__ void load_bins(const float* p, int valid,
                                          float* v) {
#pragma unroll
  for (int j = 0; j < kBins; ++j) v[j] = j < valid ? __ldg(p + j) : 0.0f;
}

__device__ __forceinline__ void store_bins(float* out, int valid,
                                           const float* v) {
  if (valid == kBins && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < kBins; j += 4) {
      *reinterpret_cast<float4*>(out + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      if (j < valid) out[j] = v[j];
    }
  }
}

// blockDim: x threads along a row (a loop covers wider rows), y rows.
// Blocks an SM must hold: 4 for B1 (64 registers), its fastest; 3 for B2,
// whose sixth input runs slower at 64 registers (python -m
// lass_torch.mask_bench --variants).
template <int kInputs>  // 5: raw re/im; 6: mag/cos/sin
__global__ void __launch_bounds__(kThreads, kInputs == 5 ? 4 : 3)
    apply_complex_mask_kernel(MaskArgs a) {
  const int64_t row_step = static_cast<int64_t>(gridDim.x) * blockDim.y;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y +
                     threadIdx.y;
       row < a.rows; row += row_step) {
    int64_t n, t;
    split_row(a, row, &n, &t);
    const float* in[kInputs];
#pragma unroll
    for (int k = 0; k < kInputs; ++k) {
      in[k] = a.x[k].ptr + n * a.x[k].sn + t * a.x[k].st;
    }
    float* o_re = a.out_re + row * a.f;
    float* o_im = a.out_im + row * a.f;
    for (int g = threadIdx.x; g < a.groups; g += blockDim.x) {
      const int col = g * kBins;
      const int valid = min(kBins, a.f - col);
      float v[kInputs][kBins];
#pragma unroll
      for (int k = 0; k < kInputs; ++k) load_bins(in[k] + col, valid, v[k]);
      float r[kBins], m[kBins];
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        if constexpr (kInputs == 5) {
          lass::mask_one(v[0][j], v[1][j], v[2][j], v[3][j], v[4][j], &r[j],
                         &m[j]);
        } else {
          lass::mask_apply(v[0][j], v[1][j], v[2][j], v[3][j], v[4][j],
                           v[5][j], &r[j], &m[j]);
        }
      }
      store_bins(o_re + col, valid, r);
      store_bins(o_im + col, valid, m);
    }
  }
}

template <int kInputs>
int launch(const void* const* ptrs, const int64_t* strides, void* out_re,
           void* out_im, int64_t n, int64_t t, int64_t f, int64_t t_mul,
           int64_t t_shift, int64_t fast_rows, int64_t block_x,
           int64_t block_y, int64_t blocks, cudaStream_t s) {
  if (n * t * f == 0) return static_cast<int>(cudaSuccess);
  if (block_x < 1 || block_y < 1 || block_x * block_y > kThreads ||
      blocks < 1 || blocks > INT32_MAX || f > INT32_MAX - kBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MaskArgs a;
  for (int k = 0; k < 6; ++k) {
    a.x[k] = k < kInputs ? View{static_cast<const float*>(ptrs[k]),
                                strides[2 * k], strides[2 * k + 1]}
                         : View{nullptr, 0, 0};
  }
  a.out_re = static_cast<float*>(out_re);
  a.out_im = static_cast<float*>(out_im);
  a.rows = n * t;
  a.t = t;
  a.fast_rows = fast_rows;
  a.f = static_cast<int>(f);
  a.groups = static_cast<int>((f + kBins - 1) / kBins);
  a.t_mul = static_cast<uint32_t>(t_mul);
  a.t_shift = static_cast<uint32_t>(t_shift);
  apply_complex_mask_kernel<kInputs>
      <<<static_cast<unsigned>(blocks),
         dim3(static_cast<unsigned>(block_x), static_cast<unsigned>(block_y)),
         0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points bound with ctypes. Pointers and the stream come as void*,
// shapes, strides and the launch plan as int64; each input is (pointer, n
// stride, t stride). The plan (lass_torch/ops/masking.py mask_plan): the
// multiply-shift divisor of t (t_mul, t_shift) valid for rows below
// fast_rows, the block's threads along a row (block_x) and rows
// (block_y), and the number of blocks. Each returns cudaGetLastError()
// after the launch (0 on success).

// B1: logits and the raw mixture spectrum (re, im)
extern "C" int lass_apply_complex_mask_ri(
    const void* l_mag, int64_t l_mag_sn, int64_t l_mag_st,
    const void* l_real, int64_t l_real_sn, int64_t l_real_st,
    const void* l_imag, int64_t l_imag_sn, int64_t l_imag_st,
    const void* re, int64_t re_sn, int64_t re_st,
    const void* im, int64_t im_sn, int64_t im_st,
    void* out_re, void* out_im, int64_t n, int64_t t, int64_t f,
    int64_t t_mul, int64_t t_shift, int64_t fast_rows, int64_t block_x,
    int64_t block_y, int64_t blocks, void* stream) {
  const void* ptrs[5] = {l_mag, l_real, l_imag, re, im};
  const int64_t strides[10] = {l_mag_sn,  l_mag_st, l_real_sn, l_real_st,
                               l_imag_sn, l_imag_st, re_sn,    re_st,
                               im_sn,     im_st};
  return launch<5>(ptrs, strides, out_re, out_im, n, t, f, t_mul, t_shift,
                   fast_rows, block_x, block_y, blocks,
                   static_cast<cudaStream_t>(stream));
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
    int64_t t_mul, int64_t t_shift, int64_t fast_rows, int64_t block_x,
    int64_t block_y, int64_t blocks, void* stream) {
  const void* ptrs[6] = {l_mag, l_real, l_imag, mag, cos_in, sin_in};
  const int64_t strides[12] = {l_mag_sn,  l_mag_st, l_real_sn, l_real_st,
                               l_imag_sn, l_imag_st, mag_sn,   mag_st,
                               cos_sn,    cos_st,   sin_sn,    sin_st};
  return launch<6>(ptrs, strides, out_re, out_im, n, t, f, t_mul, t_shift,
                   fast_rows, block_x, block_y, blocks,
                   static_cast<cudaStream_t>(stream));
}
