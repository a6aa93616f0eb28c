// Fused eval BatchNorm affine + FiLM beta + leaky ReLU + 2x2 stride-2
// transposed convolution (the decoder's up-sampling):
//
//   z = leaky(x * inv + shift + beta[b])          (in bf16, as PyTorch
//                                                   rounds each op)
//   out[b, 2t + i, 2f + j, o] = sum_c z[b, t, f, c] * W[c, o, i, j]
//
// Replaces the Pallas TPU kernel lass_tpu/ops/pallas_convt.py
// fused_act_convT (on the logical layout: the TPU kernel's fold-slot
// columns are the frequency tap j here). W is torch's ConvTranspose2d
// weight (C_in, C_out, 2, 2), packed by the wrapper as a (C_in, 4 * C_out)
// matrix with column (2i + j) * C_out + o. Rounding points: the product,
// each sum and the leaky ReLU round to bf16 as the activation-dtype chain
// of the TPU kernel does, its slope bf16(0.01) too; float32 accumulation;
// the output rounded to bf16.
//
// What bounds it on an H100: memory (K = C_in is 64 or 128: 34 GFLOP
// against 0.4-0.8 GB per call at B=16 x 10 s).
//
// Design (simple first): a GEMM with M = B*T*F positions, K = C_in and
// N = 4 * C_out, with the activation in the operand load and a
// depth-to-space store. One block of 8 warps takes 128 consecutive
// positions (the input is NHWC-contiguous), activates them into shared
// memory once, then walks N in chunks of 64 columns: the block stages the
// chunk's (C_in, 64) weights, each warp multiplies its 16 positions by
// them with 16x16x16 bf16 WMMA and writes its 16 x 64 result through a
// per-warp float32 staging tile as 16-byte bf16 stores. For a fixed
// (position, i) the (j, o) outputs are 2 * C_out contiguous elements.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "tile_util.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kM = kWarps * 16;  // positions per block
constexpr int kNC = 64;          // output columns per chunk
constexpr int kLdb = kNC + 16;
constexpr int kLdc = kNC + 8;
// the leaky slope 0.01 rounded to bf16, as the TPU kernel's 0.01 * h
// with a bf16 h rounds it
constexpr float kNegSlopeBf16 = 0.010009765625f;

struct ConvTArgs {
  const bf16* x;        // (B, T, F, cin) contiguous
  const float* inv;     // (cin,) values already rounded to bf16
  const float* shift;   // (cin,)
  const float* beta;    // (B, cin)
  const bf16* w;        // (cin, 4 * cout)
  bf16* out;            // (B, 2T, 2F, cout) contiguous
  int batch, t, f, cin, cout;
};

inline int64_t smem_bytes(int cin) {
  return int64_t(kM) * (cin + 16) * 2 + int64_t(cin) * kLdb * 2 +
         int64_t(kWarps) * 16 * kLdc * 4;
}

__global__ void __launch_bounds__(kWarps * 32) act_convt_kernel(ConvTArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = p.cin + 16;
  bf16* z = reinterpret_cast<bf16*>(smem);
  bf16* wc = z + kM * lda;
  float* stage = reinterpret_cast<float*>(wc + p.cin * kLdb);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tf = p.t * p.f;
  const int m_total = p.batch * tf;
  const int m0 = blockIdx.x * kM;

  // ---- z = leaky(x * inv + shift + beta[b]) in bf16 -> shared ---------
  const int c8 = p.cin / 8;
  for (int idx = tid; idx < kM * c8; idx += blockDim.x) {
    const int row = idx / c8;
    const int ch = (idx - row * c8) * 8;
    const int m = m0 + row;
    bf16* dst = z + row * lda + ch;
    if (m >= m_total) {
      lass::zero8(dst);
      continue;
    }
    const float* beta = p.beta + (m / tf) * p.cin;
    float v[8];
    lass::load8(p.x + int64_t(m) * p.cin + ch, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float h = lass::bf16_round(v[i] * p.inv[ch + i]);
      h = lass::bf16_round(h + p.shift[ch + i]);
      h = lass::bf16_round(h + beta[ch + i]);
      v[i] = h > 0.0f ? h : lass::bf16_round(kNegSlopeBf16 * h);
    }
    lass::store8(dst, v);
  }

  const int n_total = 4 * p.cout;
  float* my_stage = stage + warp * 16 * kLdc;
  for (int n0 = 0; n0 < n_total; n0 += kNC) {
    __syncthreads();  // z is written; the previous chunk's weights consumed
    lass::copy_rows(wc, kLdb, p.w + n0, n_total, p.cin, kNC / 8);
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kNC / 16];
#pragma unroll
    for (int ni = 0; ni < kNC / 16; ++ni) wmma::fill_fragment(acc[ni], 0.0f);
    for (int k0 = 0; k0 < p.cin; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, z + warp * 16 * lda + k0, lda);
#pragma unroll
      for (int ni = 0; ni < kNC / 16; ++ni) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, wc + k0 * kLdb + ni * 16, kLdb);
        wmma::mma_sync(acc[ni], af, bfr, acc[ni]);
      }
    }
#pragma unroll
    for (int ni = 0; ni < kNC / 16; ++ni) {
      wmma::store_matrix_sync(my_stage + ni * 16, acc[ni], kLdc,
                              wmma::mem_row_major);
    }
    __syncwarp();
    // 16 positions x 8 chunks of 8 columns, 4 per lane
    for (int idx = lane; idx < 16 * (kNC / 8); idx += 32) {
      const int row = idx / (kNC / 8);
      const int n = (idx - row * (kNC / 8)) * 8;
      const int m = m0 + warp * 16 + row;
      if (m >= m_total) continue;
      const int bi = m / tf;
      const int rem = m - bi * tf;
      const int ti = rem / p.f;
      const int fi = rem - ti * p.f;
      const int col = n0 + n;
      const int ij = col / p.cout;
      const int o = col - ij * p.cout;
      const int i = ij >> 1;
      const int j = ij & 1;
      const int64_t orow = int64_t(bi) * 2 * p.t + 2 * ti + i;
      lass::store8(p.out + (orow * 2 * p.f + 2 * fi + j) * p.cout + o,
                   my_stage + row * kLdc + n);
    }
    __syncwarp();
  }
}

}  // namespace

// C entry point bound with ctypes. x: bf16 (B, T, F, cin) contiguous
// (channels_last of (B, cin, T, F)); inv, shift: (cin,) float32 holding
// bf16 values; beta: (B, cin) float32 holding bf16 values; w: (cin,
// 4 * cout) bf16; out: bf16 (B, 2T, 2F, cout) contiguous. cin % 16 == 0,
// cout % 16 == 0. Returns cudaGetLastError() after the launch.
extern "C" int lass_act_convt(const void* x, const void* inv,
                              const void* shift, const void* beta,
                              const void* w, void* out, int64_t batch,
                              int64_t t, int64_t f, int64_t cin,
                              int64_t cout, void* stream) {
  ConvTArgs p;
  p.x = static_cast<const bf16*>(x);
  p.inv = static_cast<const float*>(inv);
  p.shift = static_cast<const float*>(shift);
  p.beta = static_cast<const float*>(beta);
  p.w = static_cast<const bf16*>(w);
  p.out = static_cast<bf16*>(out);
  p.batch = int(batch);
  p.t = int(t);
  p.f = int(f);
  p.cin = int(cin);
  p.cout = int(cout);
  const int64_t m_total = batch * t * f;
  if (m_total == 0) return static_cast<int>(cudaSuccess);
  if (cin % 16 || cout % 16 || m_total >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bytes = smem_bytes(p.cin);
  if (bytes > lass::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int err = lass::allow_smem(act_convt_kernel, bytes);
  if (err != 0) return err;
  const int blocks = static_cast<int>((m_total + kM - 1) / kM);
  act_convt_kernel<<<blocks, kWarps * 32, bytes,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
