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
// 1.07 GB (x in, out; 320.5 us at 3.35 TB/s) for 309 GFLOP (312.8 us at
// the bf16 peak): the kernel sits on the ridge, so the loads of the next
// rows have to be in flight while the tensor cores run both convs. y1 and
// h2 never reach device memory.
//
// Design (persistent, on sm90_pipe.cuh, after act_conv.cu's row ring):
// - A block is two warpgroups sharing W1 and W2, loaded once into shared
//   memory in wgmma's K-major B layout (2 x 18 KB, packed by the wrapper
//   with pack_b); two blocks per SM. The grid is as many blocks as fit on
//   the SMs at once.
// - Strips: an output strip of 62 frequencies needs h2 at 64 positions
//   (f0 - 1 .. f0 + 62) and activated x at 66 (f0 - 2 .. f0 + 63), so
//   conv1 is exactly one m64 tile and conv2 one m64 tile of which 62 rows
//   are kept. At F = 512 that is 9 strips: 12.5% more products than the
//   outputs need and 6.5% more input reads (from L2, the halo columns).
// - A column is one batch and one strip; a unit is one time row of a
//   column; warpgroup w of W takes units [w U / W, (w + 1) U / W) and
//   walks them down T, so each input row is read from device memory once
//   (plus the halo rows where its range starts a column).
// - Per step r: row r + 1 of x lands in a four-slot cp.async ring (66
//   positions x 32 channels bf16, 16-byte chunks XOR-swizzled for
//   conflict-free ldmatrix) and is activated in place by the threads that
//   copied it (a1 x + b1 and the leaky in float32, rounded to bf16); conv1
//   (9 taps x 2 k16 wgmma with A from registers) makes h2 row r from x
//   rows r - 1 .. r + 1; leaky(a2 y1 + b2) is applied in registers on the
//   float32 accumulators, positions outside the tensor zeroed, and stored
//   by stmatrix into a three-slot h2 ring in the layout conv2 reads; row
//   r + 3 of x is issued into the slot of row r - 1; conv2 makes output
//   row r - 1 from h2 rows r - 2 .. r; its bf16 result goes to a stage by
//   stmatrix and leaves in 16-byte stores after the residual add, x's row
//   r - 1 read from L2 at the start of the step.
//
// What bounds it now (chip_smoke.py and python -m lass_torch.kernel_parts
// on an H100, PERF.md): about 1.15 ms, 28% of the bound. Taken out
// one at a time, the two 9-tap chains cost 0.30 ms each and the rest of
// the step (ring, activations, epilogue) 0.54 ms, and the three add up:
// the four warpgroups of an SM do not hide one another's phases. The
// loads cost 1%, the stores 8%, the x activation 10%. A step reads about
// 130 KB of shared memory (each tap reloads its A fragments by ldmatrix,
// and wgmma reads B), which at 128 bytes per clock is about half the
// kernel's time. Three other designs were tried and were slower: the
// three time taps side by side as one m64n96k16 product per input row
// (each row's A loaded once), alone, as a conv1 / conv2 pair of
// warpgroups with A read from shared memory, and with the products issued
// under the other work; ptxas serialized the wgmma of the first and last
// at their register counts (C7511, C7518).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_pipe.cuh"
#include "tile_util.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;          // conv1 and conv2 tile rows (wgmma M)
constexpr int kOut = kRows - 2;    // outputs of a strip
constexpr int kHalo = kRows + 2;   // positions of an x slot and h2 slot rows
constexpr int kWG = 2;             // warpgroups per block, sharing W1, W2
constexpr int kXRing = 4;          // x row slots per warpgroup
constexpr int kHRing = 3;          // h2 row slots per warpgroup

struct BlockArgs {
  const bf16* x;
  int64_t sb, st, sf;   // x's element strides (channels contiguous)
  const bf16* w;        // packed (18, U / 16, U / 8, 2, 8, 8): W1's taps, W2's
  const float* a1;      // (B, U)
  const float* b1;
  const float* a2;
  const float* b2;
  bf16* out;
  int64_t ob, ot, of;
  int t, f;
  int strips;           // ceil(F / 62): columns per batch
  int64_t units;        // B * strips * T
};

// W1 and W2, shared by the block; each warpgroup's x ring, h2 ring and
// output stage
template <int U>
struct Smem {
  static constexpr int kW1 = 9 * U * U * 2;
  static constexpr int kSlot = kHalo * U * 2;
  static constexpr int kStage = kRows * U * 2;
  static constexpr int kPerWG = (kXRing + kHRing) * kSlot + kStage;
  static constexpr int kBytes = 2 * kW1 + kWG * kPerWG;
};

struct NoOp {
  __device__ __forceinline__ void operator()(uint32_t (&)[4]) const {}
};

template <int U>
__global__ void __launch_bounds__(kWG * 128, 2)
    residual_conv_block_kernel(BlockArgs p) {
  using S = Smem<U>;
  constexpr int CH = U / 8;                   // 16-byte chunks of a position
  constexpr int PP = 128 / CH;                // positions per warpgroup pass
  constexpr int KJ = (kHalo + PP - 1) / PP;   // x chunks a thread owns
  constexpr int KK = U / 16;                  // k16 steps per tap
  constexpr int KO = (kOut * CH + 127) / 128; // output chunks per thread
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wg = threadIdx.x / 128;
  const int wt = threadIdx.x % 128;
  const int warp = wt / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t w_s = sm90::smem_u32(smem);
  const int base = 2 * S::kW1 + wg * S::kPerWG;
  unsigned char* xring = smem + base;
  const uint32_t xr_s = w_s + base;
  const uint32_t h2_s = xr_s + kXRing * S::kSlot;
  const uint32_t stage_s = h2_s + kHRing * S::kSlot;

  // ---- W1 and W2, once per block; h2 rows 64 and 65, read only by the
  // discarded conv2 rows 62 and 63, zeroed once -----------------------------
  for (int i = threadIdx.x; i < 2 * S::kW1 / 16; i += blockDim.x)
    sm90::cp_async16(w_s + 16 * i, reinterpret_cast<const uint4*>(p.w) + i);
  sm90::cp_async_commit();
  if (wt < kHRing * 2 * CH) {
    const int slot = wt / (2 * CH);
    const int row = kRows + (wt / CH) % 2;
    sm90::st_shared_zero16(h2_s + slot * S::kSlot + row * (U * 2) +
                           (wt % CH) * 16);
  }
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();
  __syncthreads();

  const int64_t walkers = int64_t(gridDim.x) * kWG;
  const int64_t walker = int64_t(blockIdx.x) * kWG + wg;
  int64_t u = walker * p.units / walkers;
  const int64_t u_end = (walker + 1) * p.units / walkers;

  // this thread's x chunks: channel chunk ch at slot positions j0 + k * PP;
  // in the epilogue the same chunk of strip rows j0 + k * PP
  const int ch = wt % CH;
  const int j0 = wt / CH;
  int chunk_off[KJ];
#pragma unroll
  for (int k = 0; k < KJ; ++k) {
    const int j = j0 + k * PP;
    chunk_off[k] = j * (U * 2) + ((ch ^ sm90::swizzle_key(j, CH)) * 16);
  }
  // this lane's ldmatrix rows (shift df = 0, 1, 2) and swizzles
  const int lrow = warp * 16 + (lane & 15);
  const int lhi = lane >> 4;
  int lkey[3];
#pragma unroll
  for (int df = 0; df < 3; ++df) lkey[df] = sm90::swizzle_key(lrow + df, CH);
  // this lane's accumulator rows m = arow + 8 i and columns 8 jj + acol + e
  const int arow = warp * 16 + lane / 4;
  const int acol = 2 * (lane % 4);
  const int bar = 1 + wg;

  while (u < u_end) {
    const int64_t col = u / p.t;
    const int64_t col_end = (col + 1) * p.t;
    const int64_t u_stop = u_end < col_end ? u_end : col_end;
    const int t_s = int(u - col * p.t);
    const int t_e = int(u_stop - col * p.t);
    u = u_stop;
    const int bi = int(col / p.strips);
    const int f0 = int(col % p.strips) * kOut;
    const bf16* xb = p.x + bi * p.sb + ch * 8;
    float va1[8], vb1[8], va2[2 * CH], vb2[2 * CH];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      va1[i] = p.a1[int64_t(bi) * U + ch * 8 + i];
      vb1[i] = p.b1[int64_t(bi) * U + ch * 8 + i];
    }
#pragma unroll
    for (int jj = 0; jj < CH; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        va2[2 * jj + e] = p.a2[int64_t(bi) * U + 8 * jj + acol + e];
        vb2[2 * jj + e] = p.b2[int64_t(bi) * U + 8 * jj + acol + e];
      }
    // which of this thread's x positions lie in the image
    unsigned inside = 0;
#pragma unroll
    for (int k = 0; k < KJ; ++k) {
      const int j = j0 + k * PP;
      const int fj = f0 - 2 + j;
      if (j < kHalo && fj >= 0 && fj < p.f) inside |= 1u << k;
    }
    // which of this lane's h2 rows (positions f0 - 1 + m) lie in the image
    bool h_in[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int fm = f0 - 1 + arow + 8 * i;
      h_in[i] = fm >= 0 && fm < p.f;
    }

    // copy x row r (positions f0 - 2 .. f0 + 63; outside the image zeros)
    // if a step of this range reads it, and close a cp.async group
    auto issue = [&](int r) {
      if (r <= t_e + 1) {
        const uint32_t slot = xr_s + (r & (kXRing - 1)) * S::kSlot;
        const bool in_t = r >= 0 && r < p.t;
#pragma unroll
        for (int k = 0; k < KJ; ++k) {
          const int j = j0 + k * PP;
          if (j >= kHalo) break;
          if (in_t && (inside >> k & 1)) {
            sm90::cp_async16(slot + chunk_off[k],
                             xb + r * p.st + (f0 - 2 + j) * p.sf);
          } else {
            sm90::st_shared_zero16(slot + chunk_off[k]);
          }
        }
      }
      sm90::cp_async_commit();
    };
    // activate this thread's in-image chunks of x row r in place: every
    // load first, then the arithmetic and the stores
    auto activate = [&](int r) {
      if (r < 0 || r >= p.t) return;
      unsigned char* slot = xring + (r & (kXRing - 1)) * S::kSlot;
      uint4 raw[KJ];
#pragma unroll
      for (int k = 0; k < KJ; ++k)
        if (inside >> k & 1)
          raw[k] = *reinterpret_cast<const uint4*>(slot + chunk_off[k]);
#pragma unroll
      for (int k = 0; k < KJ; ++k) {
        if (!(inside >> k & 1)) continue;
        float v[8];
        lass::unpack8(raw[k], v);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = lass::leaky(lass::affine(va1[i], v[i], vb1[i]));
        lass::store8(reinterpret_cast<bf16*>(slot + chunk_off[k]), v);
      }
    };

    sm90::bar_sync(bar, 128);  // the previous range's reads are done
    for (int r = t_s - 2; r < t_s + 2; ++r) issue(r);

    // step r: h2 row r by conv1, then output row r - 1 by conv2
    for (int r = t_s - 1; r <= t_e; ++r) {
      const int t_o = r - 1;  // this step's output row
      // x row t_o for the residual add, from L2, long before it is needed
      uint4 res[KO];
      if (t_o >= t_s) {
#pragma unroll
        for (int k = 0; k < KO; ++k) {
          const int m = j0 + k * PP;
          if (m < kOut && f0 + m < p.f)
            res[k] = *reinterpret_cast<const uint4*>(
                xb + t_o * p.st + (f0 + m) * p.sf);
        }
      }
      sm90::cp_async_wait<1>();  // this thread's x row r + 1 landed
      if (r == t_s - 1) {
        activate(r - 1);
        activate(r);
      }
      activate(r + 1);
      sm90::bar_sync(bar, 128);  // x rows r - 1 .. r + 1 are activated

      // conv1 -> h2 row r = leaky(a2 * y1 + b2) on the float32 sums, zero
      // outside the image
      float acc[U / 2];
      if (r >= 0 && r < p.t) {
        auto a1_addr = [&](int tap, int kk) {
          const int dt = tap / 3;
          const int df = tap - 3 * dt;
          return xr_s + ((r - 1 + dt) & (kXRing - 1)) * S::kSlot +
                 (lrow + df) * (U * 2) + (((2 * kk + lhi) ^ lkey[df]) * 16);
        };
        sm90::mma_taps<U, KK, true, 9>(acc, KK, a1_addr, NoOp(), w_s);
#pragma unroll
        for (int jj = 0; jj < CH; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& d = acc[4 * jj + 2 * i + e];
              d = h_in[i] ? lass::leaky(lass::affine(va2[2 * jj + e], d,
                                                     vb2[2 * jj + e]))
                          : 0.0f;
            }
      } else {
#pragma unroll
        for (int i = 0; i < U / 2; ++i) acc[i] = 0.0f;
      }
      sm90::store_tile<U>(acc, h2_s + ((r + kHRing) % kHRing) * S::kSlot,
                          U * 2, lrow, lhi);
      // h2 row r is written, and every read of x row r - 1 is done
      sm90::bar_sync(bar, 128);
      issue(r + 3);
      if (t_o < t_s) continue;

      // conv2 -> output row t_o from h2 rows t_o - 1 .. t_o + 1
      auto a2_addr = [&](int tap, int kk) {
        const int dt = tap / 3;
        const int df = tap - 3 * dt;
        return h2_s + ((t_o - 1 + dt + kHRing) % kHRing) * S::kSlot +
               (lrow + df) * (U * 2) + (((2 * kk + lhi) ^ lkey[df]) * 16);
      };
      sm90::mma_taps<U, KK, true, 9>(acc, KK, a2_addr, NoOp(),
                                     w_s + S::kW1);
      sm90::store_tile<U>(acc, stage_s, U * 2, lrow, lhi);
      sm90::bar_sync(bar, 128);  // the stage is written
      bf16* orow = p.out + bi * p.ob + t_o * p.ot + ch * 8;
#pragma unroll
      for (int k = 0; k < KO; ++k) {
        const int m = j0 + k * PP;
        if (m >= kOut || f0 + m >= p.f) continue;
        const uint4 y = *reinterpret_cast<const uint4*>(
            smem + (stage_s - w_s) + m * (U * 2) +
            ((ch ^ sm90::swizzle_key(m, CH)) * 16));
        float vx[8], vy[8];
        lass::unpack8(res[k], vx);
        lass::unpack8(y, vy);
#pragma unroll
        for (int i = 0; i < 8; ++i) vx[i] = __fadd_rn(vx[i], vy[i]);
        lass::store8(orow + (f0 + m) * p.of, vx);
      }
    }
  }
}

template <int U>
int launch(const BlockArgs& p, cudaStream_t stream) {
  constexpr int bytes = Smem<U>::kBytes;
  static_assert(bytes <= lass::kMaxSmem, "weights and rings exceed the SM");
  auto kernel = residual_conv_block_kernel<U>;
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

// C entry point bound with ctypes. x and out: bf16 (B, T, F, U) in memory
// with contiguous channels and 16-byte aligned positions (strides
// multiples of 8); w: the (18, U, U) taps of W1 then W2 (tap = 3 dt + df,
// input channel, output channel) packed by lass_torch.ops._common.pack_b;
// a1, b1, a2, b2: contiguous (B, U) float32; U = 32 (encoder_block1).
// Returns cudaGetLastError() after the launch.
extern "C" int lass_residual_conv_block(
    const void* x, int64_t sb, int64_t st, int64_t sf, const void* w,
    const void* a1, const void* b1, const void* a2, const void* b2,
    void* out, int64_t ob, int64_t ot, int64_t of, int64_t batch, int64_t t,
    int64_t f, int64_t u, void* stream) {
  BlockArgs p;
  p.x = static_cast<const bf16*>(x);
  p.sb = sb;
  p.st = st;
  p.sf = sf;
  p.w = static_cast<const bf16*>(w);
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
  p.strips = int((f + kOut - 1) / kOut);
  p.units = batch * p.strips * t;
  if (p.units == 0) return static_cast<int>(cudaSuccess);
  if (u != 32) return static_cast<int>(cudaErrorInvalidValue);
  return launch<32>(p, static_cast<cudaStream_t>(stream));
}
