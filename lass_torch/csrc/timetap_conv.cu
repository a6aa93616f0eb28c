// Time-tap convolution on bf16 tensor cores (the dw = 0 column of a 3x3
// conv): for x of (B, T, G, C) and w3 of (3C, C),
//
//   y[b,t,g,:] = sum_{dt=0..2} act(x[b, t+dt-1, g, :]) @ w3[dt*C:(dt+1)*C, :]
//
// with rows outside [0, T) zero (SAME padding) and act the identity or
// max(x, bf16(0.01) * x) rounded to bf16, as the TPU kernel's
// jnp.maximum(x, 0.01 * x) on a bf16 x computes it. float32 accumulation,
// the output rounded to bf16.
//
// Replaces the Pallas TPU kernel scripts/microbench_tridiag.py
// tridiag_conv (body _kernel): three K=C products over a (t_tile + 2)-row
// halo of x, the microbench's question being whether a kernel that does
// only these taps can beat the dense 3x3 conv. The TPU kernel's edge
// tiles read shifted (first tile) or out-of-range (last tile) rows; this
// kernel computes the function the microbench stands for, the SAME-padded
// time conv, on every tile.
//
// What bounds it on an H100: at the microbench's shape (16, 1024, 128,
// 128) memory, barely: 1.07 GB moved (320 us at 3.35 TB/s) against 206
// GFLOP (208 us at 989 TFLOP/s), 192 flop per byte.
//
// Design (simple first, like act_conv.cu): one block of 8 warps computes
// a 128-row output tile, t_tile time rows x (128 / t_tile) positions of
// G, for all C output channels. It loads the (t_tile + 2)-row halo of x
// once from device memory, applies the activation in registers and
// stores it to shared memory as bf16, rows ordered (time, g), so the A
// operand of tap dt is the same tile shifted by dt * (128 / t_tile) rows.
// For each tap it stages that tap's (C, C) weights in shared memory and
// runs 16x16x16 bf16 WMMA products with float32 accumulators; the eight
// warps split the tile 4 (rows) x 2 (channels). The accumulators go
// through shared memory to 16-byte bf16 stores. Two blocks per SM; no
// TMA, wgmma or pipelining yet. t_tile trades the halo's extra reads
// (2 / t_tile) against the tile's extent along G.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "tile_util.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kM = 128;      // output rows (time x g positions) per block
constexpr int kWarps = 8;    // 4 along the rows x 2 along the channels
constexpr int kWarpRows = kM / 4;
constexpr int kMT = kWarpRows / 16;  // m-tiles per warp
// the leaky slope 0.01 rounded to bf16, as the TPU kernel's 0.01 * x
constexpr float kNegSlopeBf16 = 0.010009765625f;

struct TimeTapArgs {
  const bf16* x;   // (B, T, G, C) contiguous
  const bf16* w;   // (3C, C) contiguous
  bf16* out;       // (B, T, G, C) contiguous
  int t, g, tt, fuse_act;
};

template <int C>
struct Layout {
  static constexpr int ldx = C + 16;  // rows 32-byte aligned for WMMA
  static constexpr int ldw = C + 16;
  static constexpr int ldc = C + 8;
  static int64_t smem_bytes(int tt) {
    const int64_t operands =
        int64_t(tt + 2) * (kM / tt) * ldx * 2 + int64_t(C) * ldw * 2;
    const int64_t staging = int64_t(kM) * ldc * 4;
    return operands > staging ? operands : staging;
  }
};

template <int C>
__global__ void __launch_bounds__(kWarps * 32, 2)
    timetap_conv_kernel(TimeTapArgs p) {
  using L = Layout<C>;
  constexpr int NT = C / 16 / 2;  // n-tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const int kg = kM / p.tt;  // g positions per block
  const int rows = (p.tt + 2) * kg;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  bf16* wt = tile + rows * L::ldx;
  float* stage = reinterpret_cast<float*>(smem);  // after the products

  const int bi = blockIdx.z;
  const int t0 = blockIdx.y * p.tt;
  const int g0 = blockIdx.x * kg;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp % 4;
  const int wn = warp / 4;
  const int64_t row_stride = int64_t(p.g) * C;  // elements per time row
  const bf16* xb = p.x + int64_t(bi) * p.t * row_stride;

  // ---- activated halo, rows (t0 - 1 .. t0 + tt) x (g0 .. g0 + kg) -------
  constexpr int c8 = C / 8;
  for (int idx = tid; idx < rows * c8; idx += blockDim.x) {
    const int r = idx / c8;
    const int ch = (idx - r * c8) * 8;
    const int rt = r / kg;
    const int gt = t0 - 1 + rt;
    const int gg = g0 + (r - rt * kg);
    bf16* dst = tile + r * L::ldx + ch;
    if (gt < 0 || gt >= p.t || gg >= p.g) {
      lass::zero8(dst);
      continue;
    }
    const bf16* src = xb + gt * row_stride + int64_t(gg) * C + ch;
    if (!p.fuse_act) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      continue;
    }
    float v[8];
    lass::load8(src, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = fmaxf(v[i], lass::bf16_round(__fmul_rn(kNegSlopeBf16, v[i])));
    }
    lass::store8(dst, v);
  }

  // ---- 3 taps x (C / 16) k-steps of WMMA -------------------------------
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMT][NT];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) wmma::fill_fragment(acc[mi][ni], 0.0f);

  for (int dt = 0; dt < 3; ++dt) {
    __syncthreads();  // the previous tap's weights are consumed
    lass::copy_rows(wt, L::ldw, p.w + int64_t(dt) * C * C, C, C, c8);
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          af[kMT];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        wmma::load_matrix_sync(
            af[mi], tile + (wm * kWarpRows + mi * 16 + dt * kg) * L::ldx + k0,
            L::ldx);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, wt + k0 * L::ldw + (wn * NT + ni) * 16,
                               L::ldw);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          wmma::mma_sync(acc[mi][ni], af[mi], bf, acc[mi][ni]);
        }
      }
    }
  }

  // ---- accumulators -> shared float32 -> bf16 output ------------------
  __syncthreads();  // every warp is done reading the operands
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      wmma::store_matrix_sync(
          stage + (wm * kWarpRows + mi * 16) * L::ldc + (wn * NT + ni) * 16,
          acc[mi][ni], L::ldc, wmma::mem_row_major);
    }
  __syncthreads();
  bf16* ob = p.out + int64_t(bi) * p.t * row_stride;
  for (int idx = tid; idx < kM * c8; idx += blockDim.x) {
    const int m = idx / c8;
    const int n = (idx - m * c8) * 8;
    const int rt = m / kg;
    const int gt = t0 + rt;
    const int gg = g0 + (m - rt * kg);
    if (gt >= p.t || gg >= p.g) continue;
    lass::store8(ob + gt * row_stride + int64_t(gg) * C + n,
                 stage + m * L::ldc + n);
  }
}

template <int C>
int launch(const TimeTapArgs& p, int batch, cudaStream_t stream) {
  const int64_t bytes = Layout<C>::smem_bytes(p.tt);
  const int err = lass::allow_smem(timetap_conv_kernel<C>, bytes);
  if (err != 0) return err;
  const int kg = kM / p.tt;
  const dim3 grid((p.g + kg - 1) / kg, (p.t + p.tt - 1) / p.tt, batch);
  timetap_conv_kernel<C><<<grid, kWarps * 32, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point bound with ctypes. Pointers and the stream come as void*,
// sizes as int64. The caller guarantees: x and out contiguous (B, T, G, C)
// bf16, w contiguous (3C, C) bf16, every pointer 16-byte aligned, C 32, 64
// or 128, t_tile 16, 32 or 64. Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int lass_timetap_conv(const void* x, const void* w, void* out,
                                 int64_t batch, int64_t t, int64_t g,
                                 int64_t c, int64_t t_tile, int64_t fuse_act,
                                 void* stream) {
  TimeTapArgs p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.out = static_cast<bf16*>(out);
  p.t = int(t);
  p.g = int(g);
  p.tt = int(t_tile);
  p.fuse_act = int(fuse_act != 0);
  if (batch == 0 || t == 0 || g == 0) return static_cast<int>(cudaSuccess);
  if (t_tile != 16 && t_tile != 32 && t_tile != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 32: return launch<32>(p, int(batch), s);
    case 64: return launch<64>(p, int(batch), s);
    case 128: return launch<128>(p, int(batch), s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
