// One whole residual conv block with an identity shortcut, fused:
//
//   out = x + conv3x3(leaky(a2 * conv3x3(leaky(a1 * x + b1), W1) + b2), W2)
//
// Replaces the Pallas TPU kernel lass_tpu/ops/pallas_convblock.py
// fused_residual_conv_block (on the logical layout). In the UNet that is
// encoder_block1.conv_block1 (32 -> 32 channels at the widest level).
// Rounding points as in the TPU kernel: the first activation in float32,
// rounded to bf16 for conv1; conv1's float32 sum y1 is NOT rounded before
// leaky(a2 * y1 + b2); that activation is rounded to bf16 for conv2; conv2's
// sum is rounded to bf16 and added to x in bf16. Both activations are zero
// outside [0, T) x [0, F) (SAME padding of the activated tensors).
//
// What bounds it on an H100: at 32 channels, 1024 x 512 and B=16 it moves
// 1.07 GB (x in, out) for 309 GFLOP: 320 us of memory against 312 us of
// bf16 tensor-core peak, so both nearly at once.
//
// Design (simple first): one block of 16 warps computes a 8 x 28 output
// tile. The activated input halo (12 x 32 positions) goes to shared
// memory as bf16, each thread keeping four 16-byte loads in flight; conv1
// runs on the 10 x 32 positions that conv2 needs, as WMMA 16x16x16
// products over flattened rows of stride 32 (a 16-row fragment that runs
// past a row's end only computes columns that are thrown away, so no
// position is ever read outside the buffer); its
// float32 result is activated in shared memory and rounded to bf16 with
// the out-of-range rows and columns zeroed; conv2 runs on the 8 x 32
// positions of the output tile; the epilogue adds x and stores bf16.
// Both weight sets stay in shared memory for the whole block. y1 never
// reaches device memory: the block reads x once (plus halo) and writes
// out once.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "tile_util.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kTT = 8;            // output rows per block
constexpr int kTF = 28;           // output columns per block
constexpr int kW = kTF + 4;       // row stride of every shared tile (32)
constexpr int kWarps = 16;
constexpr int kM1 = (kTT + 2) * kW;   // conv1 positions (flattened)
constexpr int kM2 = kTT * kW;         // conv2 positions (flattened)
// rows held: the last fragment of a conv reads up to 2 rows + 2 further
constexpr int kH1Rows = kTT + 5;
constexpr int kH2Rows = kTT + 3;

struct BlockArgs {
  const bf16* x;
  int64_t sb, st, sf;
  const bf16* w1;  // (9, u, u), tap = 3 * dt + df
  const bf16* w2;
  const float* a1;  // (B, u)
  const float* b1;
  const float* a2;
  const float* b2;
  bf16* out;
  int64_t ob, ot, of;
  int t, f;
};

template <int U>
struct Layout {
  static constexpr int lda = U + 16;  // bf16 operand rows
  static constexpr int ldc = U + 8;   // float32 staging rows
  static constexpr int64_t h1 = int64_t(kH1Rows) * kW * lda * 2;
  static constexpr int64_t w = int64_t(9) * U * lda * 2;  // per weight set
  static constexpr int64_t y1 = int64_t(kM1) * ldc * 4;
  static constexpr int64_t h2 = int64_t(kH2Rows) * kW * lda * 2;
  static constexpr int64_t bytes = h1 + 2 * w + y1 + h2;
};

template <int U>
__device__ __forceinline__ void conv_tiles(
    const bf16* act, const bf16* wts, float* stage, int n_mtiles, int warp) {
  constexpr int NT = U / 16;
  constexpr int lda = Layout<U>::lda, ldc = Layout<U>::ldc;
  for (int mt = warp; mt < n_mtiles; mt += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) wmma::fill_fragment(acc[ni], 0.0f);
    for (int tap = 0; tap < 9; ++tap) {
      const int dt = tap / 3;
      const int df = tap - 3 * dt;
      const bf16* arow = act + (mt * 16 + dt * kW + df) * lda;
      const bf16* wtap = wts + tap * U * lda;
#pragma unroll
      for (int k0 = 0; k0 < U; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, arow + k0, lda);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              bfr;
          wmma::load_matrix_sync(bfr, wtap + k0 * lda + ni * 16, lda);
          wmma::mma_sync(acc[ni], af, bfr, acc[ni]);
        }
      }
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      wmma::store_matrix_sync(stage + mt * 16 * ldc + ni * 16, acc[ni], ldc,
                              wmma::mem_row_major);
    }
  }
}

template <int U>
__global__ void __launch_bounds__(kWarps * 32)
    residual_conv_block_kernel(BlockArgs p) {
  using L = Layout<U>;
  constexpr int lda = L::lda, ldc = L::ldc, u8 = U / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* h1 = reinterpret_cast<bf16*>(smem);
  bf16* w1 = reinterpret_cast<bf16*>(smem + L::h1);
  bf16* w2 = reinterpret_cast<bf16*>(smem + L::h1 + L::w);
  float* y1 = reinterpret_cast<float*>(smem + L::h1 + 2 * L::w);
  bf16* h2 = reinterpret_cast<bf16*>(smem + L::h1 + 2 * L::w + L::y1);
  float* y2 = y1;  // conv2's staging reuses y1's once h2 is built

  const int bi = blockIdx.z;
  const int t0 = blockIdx.y * kTT;
  const int f0 = blockIdx.x * kTF;
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  // ---- weights and the activated input halo -> shared memory ----------
  lass::copy_rows(w1, lda, p.w1, U, 9 * U, u8);  // rows: tap * U + k
  lass::copy_rows(w2, lda, p.w2, U, 9 * U, u8);
  const float* a1 = p.a1 + bi * U;
  const float* b1 = p.b1 + bi * U;
  constexpr int total = kH1Rows * kW * u8;
  for (int base = tid; base < total; base += lass::kLoadBatch * blockDim.x) {
    uint4 raw[lass::kLoadBatch];
    bool live[lass::kLoadBatch];
#pragma unroll
    for (int u = 0; u < lass::kLoadBatch; ++u) {  // issue the loads
      const int idx = base + u * blockDim.x;
      const int pos = idx / u8;
      const int ch = (idx - pos * u8) * 8;
      const int r = pos / kW;
      const int gt = t0 - 2 + r;
      const int gf = f0 - 2 + pos - r * kW;
      live[u] = idx < total && r < kTT + 4 && gt >= 0 && gt < p.t &&
                gf >= 0 && gf < p.f;
      if (live[u]) {
        raw[u] = *reinterpret_cast<const uint4*>(
            p.x + bi * p.sb + gt * p.st + gf * p.sf + ch);
      }
    }
#pragma unroll
    for (int u = 0; u < lass::kLoadBatch; ++u) {  // activate and store
      const int idx = base + u * blockDim.x;
      if (idx >= total) break;
      const int pos = idx / u8;
      const int ch = (idx - pos * u8) * 8;
      bf16* dst = h1 + pos * lda + ch;
      if (!live[u]) {
        lass::zero8(dst);
        continue;
      }
      float v[8];
      lass::unpack8(raw[u], v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = lass::leaky(lass::affine(a1[ch + i], v[i], b1[ch + i]));
      }
      lass::store8(dst, v);
    }
  }
  __syncthreads();

  // ---- conv1 over the (kTT + 2) x kW positions, float32 to y1 --------
  conv_tiles<U>(h1, w1, y1, kM1 / 16, warp);
  __syncthreads();

  // ---- h2 = leaky(a2 * y1 + b2) -> bf16, zero outside the tensor ------
  const float* a2 = p.a2 + bi * U;
  const float* b2 = p.b2 + bi * U;
  for (int idx = tid; idx < kH2Rows * kW * u8; idx += blockDim.x) {
    const int pos = idx / u8;
    const int ch = (idx - pos * u8) * 8;
    const int r = pos / kW;
    const int c = pos - r * kW;
    const int gt = t0 - 1 + r;
    const int gf = f0 - 1 + c;
    bf16* dst = h2 + pos * lda + ch;
    if (r >= kTT + 2 || c >= kTF + 2 || gt < 0 || gt >= p.t || gf < 0 ||
        gf >= p.f) {
      lass::zero8(dst);
      continue;
    }
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = lass::leaky(
          lass::affine(a2[ch + i], y1[pos * ldc + ch + i], b2[ch + i]));
    }
    lass::store8(dst, v);
  }
  __syncthreads();

  // ---- conv2 over the kTT x kW positions, float32 to y2 ---------------
  conv_tiles<U>(h2, w2, y2, kM2 / 16, warp);
  __syncthreads();

  // ---- out = x + bf16(y2), rounded to bf16 ----------------------------
  for (int idx = tid; idx < kM2 * u8; idx += blockDim.x) {
    const int pos = idx / u8;
    const int ch = (idx - pos * u8) * 8;
    const int r = pos / kW;
    const int c = pos - r * kW;
    const int gt = t0 + r;
    const int gf = f0 + c;
    if (c >= kTF || gt >= p.t || gf >= p.f) continue;
    float v[8];
    lass::load8(p.x + bi * p.sb + gt * p.st + gf * p.sf + ch, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = v[i] + lass::bf16_round(y2[pos * ldc + ch + i]);
    }
    lass::store8(p.out + bi * p.ob + gt * p.ot + gf * p.of + ch, v);
  }
}

template <int U>
int launch(const BlockArgs& p, int batch, cudaStream_t stream) {
  const int64_t bytes = Layout<U>::bytes;
  const int err = lass::allow_smem(residual_conv_block_kernel<U>, bytes);
  if (err != 0) return err;
  const dim3 grid((p.f + kTF - 1) / kTF, (p.t + kTT - 1) / kTT, batch);
  residual_conv_block_kernel<U><<<grid, kWarps * 32, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

static_assert(Layout<32>::bytes <= lass::kMaxSmem, "shared memory");

}  // namespace

// C entry point bound with ctypes. x and out: bf16 (B, T, F, U) in memory
// with contiguous channels and 16-byte aligned rows (strides multiples of
// 8); w1, w2: (9, U, U) bf16; a1, b1, a2, b2: contiguous (B, U) float32;
// U = 32 (encoder_block1). Returns cudaGetLastError() after the launch.
extern "C" int lass_residual_conv_block(
    const void* x, int64_t sb, int64_t st, int64_t sf, const void* w1,
    const void* w2, const void* a1, const void* b1, const void* a2,
    const void* b2, void* out, int64_t ob, int64_t ot, int64_t of,
    int64_t batch, int64_t t, int64_t f, int64_t u, void* stream) {
  BlockArgs p;
  p.x = static_cast<const bf16*>(x);
  p.sb = sb;
  p.st = st;
  p.sf = sf;
  p.w1 = static_cast<const bf16*>(w1);
  p.w2 = static_cast<const bf16*>(w2);
  p.a1 = static_cast<const float*>(a1);
  p.b1 = static_cast<const float*>(b1);
  p.a2 = static_cast<const float*>(a2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<bf16*>(out);
  p.ob = ob;
  p.ot = ot;
  p.of = of;
  p.t = int(t);
  p.f = int(f);
  if (batch == 0 || t == 0 || f == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u != 32) return static_cast<int>(cudaErrorInvalidValue);
  return launch<32>(p, int(batch), s);
}
