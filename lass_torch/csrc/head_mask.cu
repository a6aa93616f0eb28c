// Fused head: the 1x1 after_conv (C -> C_out * 3 mask logits, + bias) and
// the K=3 complex-mask apply with phase rotation, in one pass:
//
//   l[o, k] = bias[o*3 + k] + sum_c h[b, t, f, c] * w[c, o*3 + k]
//   (re_out, im_out)[b*C_out + o, t, f] = mask_one(l[o, 0..2], re, im)
//
// Replaces the Pallas TPU kernel lass_tpu/ops/pallas_masking.py
// apply_head_mask_folded (on the logical layout). Rounding points as in
// the TPU kernel: w is rounded to h's dtype (bf16) by the wrapper, the
// products are exact in float32 and summed in float32, the bias and the
// mask chain (lass::mask_one, mask_math.cuh) are float32. The logits are
// never rounded to bf16, which the unfused after_conv + mask path does.
//
// What bounds it on an H100: memory. Per position it reads C bf16
// activations (64 bytes at C = 32) and two float32 spectrum values and
// writes two float32 outputs per output channel: 656 MB at B=16 x 10 s,
// 196 us; the 3 * C FMAs per position are far below the card's float32
// rate.
//
// Design: one thread per (b, t, f). h is read as a strided view (its first
// T of T_pad rows, channels contiguous: four 16-byte loads per position),
// the spectrum as the (B, T, 513) -> 512-bin crop in place, each with its
// own batch and time strides; the weights and bias sit in shared memory.
// A block covers 128 frequency bins of one (b, t) row, so no thread
// divides an index. Every output channel o reads spectrum channel 0 (the
// fused head serves models with one input channel).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mask_math.cuh"
#include "tile_util.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kC = 32;          // channels of h (the UNet's last width)
constexpr int kMaxLogits = 24;  // C_out * 3, C_out <= 8

struct HeadArgs {
  const bf16* h;
  int64_t hb, ht, hf;       // element strides; channels contiguous
  const float* w;           // (C, C_out * 3), values rounded to bf16
  const float* bias;        // (C_out * 3,)
  const float* re;
  int64_t re_b, re_t;       // unit stride along frequency
  const float* im;
  int64_t im_b, im_t;
  float* out_re;            // (B * C_out, T, F) contiguous
  float* out_im;
  int t, f, cout;
};

__global__ void __launch_bounds__(kThreads) head_mask_kernel(HeadArgs p) {
  __shared__ float ws[kC * kMaxLogits];
  __shared__ float bs[kMaxLogits];
  const int m = 3 * p.cout;
  for (int i = threadIdx.x; i < kC * m; i += kThreads) ws[i] = p.w[i];
  for (int i = threadIdx.x; i < m; i += kThreads) bs[i] = p.bias[i];
  __syncthreads();

  const int bi = blockIdx.z;
  const int ti = blockIdx.y;
  const int fi = blockIdx.x * kThreads + threadIdx.x;
  if (fi >= p.f) return;

  float hv[kC];
  const bf16* hp = p.h + bi * p.hb + ti * p.ht + fi * p.hf;
#pragma unroll
  for (int c = 0; c < kC; c += 8) lass::load8(hp + c, hv + c);
  const float re = p.re[bi * p.re_b + ti * p.re_t + fi];
  const float im = p.im[bi * p.im_b + ti * p.im_t + fi];
  for (int o = 0; o < p.cout; ++o) {
    float l[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        acc = fmaf(hv[c], ws[c * m + 3 * o + k], acc);
      }
      l[k] = acc + bs[3 * o + k];
    }
    const int64_t dst =
        ((int64_t(bi) * p.cout + o) * p.t + ti) * p.f + fi;
    lass::mask_one(l[0], l[1], l[2], re, im, p.out_re + dst, p.out_im + dst);
  }
}

}  // namespace

// C entry point bound with ctypes. h: bf16 with 32 contiguous channels
// and 16-byte aligned rows; w: (32, 3 * cout) float32; bias: (3 * cout,)
// float32; re/im: float32 with unit frequency stride; outputs: contiguous
// (B * cout, T, F) float32; 1 <= cout <= 8, T <= 65535. Returns
// cudaGetLastError() after the launch.
extern "C" int lass_head_mask(
    const void* h, int64_t hb, int64_t ht, int64_t hf, int64_t c,
    const void* w, const void* bias, int64_t cout, const void* re,
    int64_t re_b, int64_t re_t, const void* im, int64_t im_b, int64_t im_t,
    void* out_re, void* out_im, int64_t batch, int64_t t, int64_t f,
    void* stream) {
  HeadArgs p;
  p.h = static_cast<const bf16*>(h);
  p.hb = hb;
  p.ht = ht;
  p.hf = hf;
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.re = static_cast<const float*>(re);
  p.re_b = re_b;
  p.re_t = re_t;
  p.im = static_cast<const float*>(im);
  p.im_b = im_b;
  p.im_t = im_t;
  p.out_re = static_cast<float*>(out_re);
  p.out_im = static_cast<float*>(out_im);
  p.t = int(t);
  p.f = int(f);
  p.cout = int(cout);
  if (batch == 0 || t == 0 || f == 0) return static_cast<int>(cudaSuccess);
  if (c != kC || cout < 1 || 3 * cout > kMaxLogits || t > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.f + kThreads - 1) / kThreads, p.t, int(batch));
  head_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
