// Time-tap convolution on Hopper tensor cores (the dw = 0 column of a 3x3
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
// 128) memory: 1.07 GB moved (320 us at 3.35 TB/s) against 206 GFLOP
// (208 us at 989 TFLOP/s), 192 flop per byte. The design keeps the bytes
// moved at that minimum and the loads in flight while the tensor cores
// run: each input row is read from device memory once and the weights
// once per block.
//
// Design (persistent, after the TPU kernel's resident weights and
// double-buffered halo DMA):
// - A block of two warpgroups holds all of w3 in shared memory, loaded
//   once (96 KB at C = 128), in wgmma's K-major B layout (the wrapper
//   packs it, sm90_pipe.cuh). The grid is as many blocks as fit on the
//   SMs at once.
// - Each warpgroup walks its own share of the work: a column is one batch
//   and a block of 64 g positions, a unit is t_tile time rows of a column,
//   and walker w of W takes units [w U / W, (w + 1) U / W), so every
//   warpgroup gets the same number of units to within one. It walks them
//   down T. Within a column it keeps rows t - 1 and t of the previous
//   step, so each input row is read from device memory once; only where
//   its range starts a column (at most twice per walker) does it read the
//   one halo row again. t_tile is thus the granularity of the split, no
//   longer a tile: the halo is re-read 2 / (rows per walker), not
//   2 / t_tile, and t_tile trades nothing but the balance.
// - A ring of four row slots per warpgroup (64 x C bf16, 16-byte chunks
//   XOR-swizzled for conflict-free ldmatrix and stmatrix): rows t - 1, t,
//   t + 1 are read by step t's products while row t + 2 arrives by
//   cp.async; row t + 3 is issued into row t - 1's slot once the step is
//   done with it.
// - The products are wgmma m64nCk16 with A from registers (ldmatrix at the
//   tap's row, the activation applied to the fragment in registers: an
//   element is activated once per tap, which costs less than a pass over
//   shared memory) and B from the resident weights, double-buffered by tap.
// - Epilogue: the float32 accumulators go to bf16 in row t - 1's slot by
//   stmatrix, then to device memory in 16-byte stores, each position's C
//   channels contiguous (each thread's 4-byte pairs straight from the
//   fragments write half-sectors, and were slower).
//
// What bounds it now (chip_smoke.py and the microbench on an H100, PERF.md
// PR 4): it runs at about three quarters of the bytes bound, level with
// cuDNN's (3, 1) conv. The resident weights leave shared memory for two
// warpgroups of four slots per SM, so each warpgroup keeps one or two rows
// in flight, its steps' serial phases (wait, products, epilogue) overlap
// only with the other's, and ldmatrix and wgmma's B reads share the SM's
// shared-memory bandwidth. Holding the weights in registers instead (the
// product transposed, activations as wgmma's B through a 128-byte-swizzled
// descriptor, a six-row ring) measured slower: its two warpgroups share
// each row and run in lockstep.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_pipe.cuh"
#include "tile_util.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;   // g positions of a warpgroup's tile (wgmma M)
constexpr int kWG = 2;      // warpgroups per block, sharing the weights
constexpr int kRing = 4;    // row slots per warpgroup
// the leaky slope 0.01 rounded to bf16, as the TPU kernel's 0.01 * x
constexpr float kNegSlopeBf16 = 0.010009765625f;

struct TimeTapArgs {
  const bf16* x;    // (B, T, G, C) contiguous
  const bf16* w;    // packed (3, C / 16, C / 8, 2, 8, 8), see sm90_pipe.cuh
  bf16* out;        // (B, T, G, C) contiguous
  int t, g, fuse_act;
  int gblocks;      // ceil(G / 64): columns per batch
  int unit_rows;    // t_tile
  int col_units;    // ceil(T / t_tile)
  int64_t units;    // B * gblocks * col_units
};

// the weights, shared by the block's warpgroups, and each one's ring
template <int C>
struct Smem {
  static constexpr int kW = 3 * C * C * 2;
  static constexpr int kSlot = kRows * C * 2;
  static constexpr int kBytes = kW + kWG * kRing * kSlot;
};

// max(v, bf16(0.01) * v) on a fragment of bf16 pairs: the product rounded
// to bf16 as in the plain version (bf16 x bf16 is exact in float32)
struct LeakyBf16 {
  bool on;
  __device__ __forceinline__ void operator()(uint32_t (&r)[4]) const {
    if (!on) return;
    const __nv_bfloat162 slope = __float2bfloat162_rn(kNegSlopeBf16);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&r[i]);
      v = __hmax2(v, __hmul2(v, slope));
      r[i] = *reinterpret_cast<uint32_t*>(&v);
    }
  }
};

template <int C>
__global__ void __launch_bounds__(kWG * 128)
    timetap_conv_kernel(TimeTapArgs p) {
  using S = Smem<C>;
  constexpr int CH = C / 8;       // 16-byte chunks of a position
  constexpr int PP = 128 / CH;    // positions one pass of a warpgroup covers
  constexpr int KP = kRows / PP;  // chunks a thread owns in a row
  constexpr int KK = C / 16;      // k16 steps per tap
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wg = threadIdx.x / 128;
  const int wt = threadIdx.x % 128;
  const int warp = wt / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t w_s = sm90::smem_u32(smem);
  const uint32_t ring_s = w_s + S::kW + wg * kRing * S::kSlot;

  // ---- the weights, once per block ---------------------------------------
  for (int i = threadIdx.x; i < S::kW / 16; i += blockDim.x)
    sm90::cp_async16(w_s + 16 * i, reinterpret_cast<const uint4*>(p.w) + i);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();
  __syncthreads();

  const int64_t walkers = int64_t(gridDim.x) * kWG;
  const int64_t walker = int64_t(blockIdx.x) * kWG + wg;
  int64_t u = walker * p.units / walkers;
  const int64_t u_end = (walker + 1) * p.units / walkers;

  // this thread's chunks (copies in, stores out): channel chunk ch of
  // positions p0 + k * PP, at byte chunk_off[k] of a slot
  const int ch = wt % CH;
  const int p0 = wt / CH;
  int chunk_off[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int pos = p0 + k * PP;
    chunk_off[k] = pos * (C * 2) + ((ch ^ sm90::swizzle_key(pos, CH)) * 16);
  }
  // this lane's ldmatrix / stmatrix row, and its swizzle
  const int lrow = warp * 16 + (lane & 15);
  const int lhi = lane >> 4;
  const int lkey = sm90::swizzle_key(lrow, CH);
  const int64_t row_elems = int64_t(p.g) * C;
  const int bar = 1 + wg;
  const LeakyBf16 act{p.fuse_act != 0};

  while (u < u_end) {
    const int64_t col = u / p.col_units;
    const int64_t col_end = (col + 1) * p.col_units;
    const int64_t u_stop = u_end < col_end ? u_end : col_end;
    const int t_s = int(u - col * p.col_units) * p.unit_rows;
    const int t_e = min(p.t, int(u_stop - col * p.col_units) * p.unit_rows);
    u = u_stop;
    const int bi = int(col / p.gblocks);
    const int g0 = int(col % p.gblocks) * kRows;
    const int64_t base = int64_t(bi) * p.t * row_elems + int64_t(g0) * C + ch * 8;
    const bf16* xb = p.x + base;
    bf16* ob = p.out + base;

    // copy row r if a step of this range reads it (rows outside [0, T)
    // and positions past G: zeros), and close a cp.async group
    auto issue = [&](int r) {
      if (r <= t_e) {
        const uint32_t slot = ring_s + (r & (kRing - 1)) * S::kSlot;
        const bool in_t = r >= 0 && r < p.t;
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          const int pos = p0 + k * PP;
          if (in_t && g0 + pos < p.g) {
            sm90::cp_async16(slot + chunk_off[k], xb + r * row_elems + pos * C);
          } else {
            sm90::st_shared_zero16(slot + chunk_off[k]);
          }
        }
      }
      sm90::cp_async_commit();
    };

    sm90::bar_sync(bar, 128);  // the previous range's reads are done
    for (int r = t_s - 1; r < t_s + kRing - 1; ++r) issue(r);

    for (int t = t_s; t < t_e; ++t) {
      sm90::cp_async_wait<kRing - 3>();  // this thread's row t + 1 landed
      sm90::bar_sync(bar, 128);  // every thread's copies of rows t - 1 .. t + 1

      float acc[C / 2];
      auto a_addr = [&](int dt, int kk) {
        return ring_s + ((t - 1 + dt) & (kRing - 1)) * S::kSlot +
               lrow * (C * 2) + (((2 * kk + lhi) ^ lkey) * 16);
      };
      sm90::mma_taps<C, KK, true, 3>(acc, KK, a_addr, act, w_s);

      // accumulators -> bf16 in row t - 1's slot -> device memory. The
      // products are done, so every warp's reads of row t - 1 are (a
      // wgmma completes only once all four warps have issued it, after
      // their ldmatrix). Each thread reads back exactly the chunks it
      // copies in next, so row t + kRing - 1 may follow without a barrier.
      const uint32_t stage = ring_s + ((t - 1) & (kRing - 1)) * S::kSlot;
      sm90::store_tile<C>(acc, stage, C * 2, lrow, lhi);
      sm90::bar_sync(bar, 128);
      bf16* orow = ob + int64_t(t) * row_elems;
      uint4 v[KP];
#pragma unroll
      for (int k = 0; k < KP; ++k)
        v[k] = *reinterpret_cast<const uint4*>(smem + (stage - w_s) +
                                               chunk_off[k]);
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int pos = p0 + k * PP;
        if (g0 + pos < p.g) *reinterpret_cast<uint4*>(orow + pos * C) = v[k];
      }
      issue(t + kRing - 1);
    }
  }
}

template <int C>
int launch(TimeTapArgs p, cudaStream_t stream) {
  constexpr int bytes = Smem<C>::kBytes;
  static_assert(bytes <= lass::kMaxSmem, "ring and weights exceed the SM");
  auto kernel = timetap_conv_kernel<C>;
  int err = lass::allow_smem(kernel, bytes);
  if (err != 0) return err;
  int resident = 0;
  err = lass::resident_blocks(kernel, kWG * 128, bytes, &resident);
  if (err != 0) return err;
  const int64_t want = (p.units + kWG - 1) / kWG;
  const int blocks = int(want < resident ? want : resident);
  kernel<<<blocks, kWG * 128, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point bound with ctypes. Pointers and the stream come as void*,
// sizes as int64. The caller guarantees: x and out contiguous (B, T, G, C)
// bf16, w the (3C, C) weights packed by lass_torch.ops._common.pack_b (taps
// 3, K = C, N = C), every pointer 16-byte aligned, C 32, 64 or 128, t_tile
// 16, 32 or 64. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lass_timetap_conv(const void* x, const void* w, void* out,
                                 int64_t batch, int64_t t, int64_t g,
                                 int64_t c, int64_t t_tile, int64_t fuse_act,
                                 void* stream) {
  if (batch == 0 || t == 0 || g == 0) return static_cast<int>(cudaSuccess);
  if (t_tile != 16 && t_tile != 32 && t_tile != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  TimeTapArgs p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.out = static_cast<bf16*>(out);
  p.t = int(t);
  p.g = int(g);
  p.fuse_act = int(fuse_act != 0);
  p.gblocks = int((g + kRows - 1) / kRows);
  p.unit_rows = int(t_tile);
  p.col_units = int((t + t_tile - 1) / t_tile);
  p.units = batch * p.gblocks * p.col_units;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 32: return launch<32>(p, s);
    case 64: return launch<64>(p, s);
    case 128: return launch<128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
