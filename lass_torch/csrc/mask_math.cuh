// The K=3 complex-mask chain for one spectrum element, shared by
// masking.cu (logits read from device memory; the mixture as raw re/im or,
// in the six-input mode, as mag/cos/sin) and head_mask.cu (logits computed
// in registers by the fused after_conv).
//
//   mag      = sqrt(max(re^2 + im^2, 1e-10)),  cos = re / mag,  sin = im / mag
//   mask_mag = sigmoid(l_mag)
//   (mr, mi) = tanh(l_real, l_imag) / max(|tanh(l_real, l_imag)|, 1e-10)
//   out      = relu(mag * mask_mag) * (cos*mr - sin*mi, sin*mr + cos*mi)
//
// Formula of lass_tpu/ops/pallas_masking.py _mask_math_from_ri (mask_one)
// and _mask_math (mask_apply, from the second line on). Plain IEEE
// expf/tanhf/sqrtf and division: no fast-math.
#pragma once

#include <cuda_runtime.h>

namespace lass {

// the chain from the mixture's mag/cos/sin on: formula of
// lass_tpu/ops/pallas_masking.py _mask_math
__device__ __forceinline__ void mask_apply(float lm, float lr, float li,
                                           float mag, float cos_in,
                                           float sin_in, float* o_re,
                                           float* o_im) {
  const float mask_mag = 1.0f / (1.0f + expf(-lm));
  const float mr = tanhf(lr);
  const float mi = tanhf(li);
  const float denom = fmaxf(sqrtf(mr * mr + mi * mi), 1e-10f);
  const float mask_cos = mr / denom;
  const float mask_sin = mi / denom;
  const float out_cos = cos_in * mask_cos - sin_in * mask_sin;
  const float out_sin = sin_in * mask_cos + cos_in * mask_sin;
  const float out_mag = fmaxf(mag * mask_mag, 0.0f);
  *o_re = out_mag * out_cos;
  *o_im = out_mag * out_sin;
}

// the whole chain from the raw spectrum (re, im)
__device__ __forceinline__ void mask_one(float lm, float lr, float li,
                                         float re, float im,
                                         float* o_re, float* o_im) {
  const float mag = sqrtf(fmaxf(re * re + im * im, 1e-10f));
  mask_apply(lm, lr, li, mag, re / mag, im / mag, o_re, o_im);
}

}  // namespace lass
