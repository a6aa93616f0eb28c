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
// weight (C_in, C_out, 2, 2). Rounding points: the product, each sum and
// the leaky ReLU round to bf16 as the activation-dtype chain of the TPU
// kernel does, its slope bf16(0.01) too; float32 accumulation; the output
// rounded to bf16.
//
// What bounds it on an H100: memory. At the decoder's two launches
// (128 -> 64 at 16 x 256 x 128, 64 -> 32 at 16 x 512 x 256) a forward
// moves 1.21 GB (360.6 us at 3.35 TB/s), two thirds of it stores,
// against 69 GFLOP (70 us at the bf16 peak). The design reads each input
// element once, keeps the weights resident, keeps the next tiles' loads
// in flight while the tensor cores run, and writes each output row as one
// contiguous run in 16-byte stores while the other phase's products run.
//
// Design (persistent, on sm90_pipe.cuh):
// - A block is two warpgroups sharing the weights, loaded once into
//   shared memory in wgmma's K-major B layout as two operands, one per
//   time phase i, each C_in x (2 C_out) with column j * C_out + o (the
//   wrapper packs them with pack_b): 64 KB at 128 -> 64, 16 KB at
//   64 -> 32. The grid is as many blocks as fit on the SMs at once.
// - A unit is one input tile: 64 consecutive frequencies of one (batch,
//   time) row. Warpgroup w of W takes units [w U / W, (w + 1) U / W) in
//   memory order; tiles have no halo, so units are independent.
// - Each warpgroup has a ring of three tile slots (64 x C_in bf16, 16-byte
//   chunks XOR-swizzled for conflict-free ldmatrix): the tile of this step
//   and the next one's cp.async in flight, the one after issued into the
//   slot the previous step has finished with.
// - Each thread owns one 8-channel chunk (its inv, shift and beta values
//   stay in registers as bf16 pairs) at every (128 / (C_in / 8))-th
//   position, and after its own cp.async wait activates in place exactly
//   the chunks it copied, all its loads before its arithmetic, in packed
//   bf16 operations (one correctly rounded multiply or add per op, which
//   for bf16 operands is what PyTorch's float32-then-round gives).
// - Products: the tile's A fragments are loaded once by ldmatrix, then one
//   m64n(2 C_out)k16 chain per phase i. Its 64 x 2 C_out result is one
//   contiguous run of output memory: row (b, 2t + i), positions 2 f0 ..
//   2 f0 + 127, all channels, so the epilogue is a plain sweep of 16-byte
//   stores with no depth-to-space arithmetic. Phase 0's result goes to a
//   bf16 stage by stmatrix, phase 1's products are issued, and phase 0's
//   stores run while they do; then phase 1's stage and stores.
//
// What bounds it now (chip_smoke.py and python -m lass_torch.kernel_parts
// on an H100, PERF.md): memory, as designed. Both launches together
// take about 0.55 ms against the 360.6 us bound (66%). Taken out one at a
// time, the 64 -> 32 launch's stores are half its time and its loads a
// third, its activation and products nothing. The 128 -> 64 launch (about
// 60% of its bound) loses at most 10% to any one part: its 64 KB of
// weights and 213 registers a thread leave one block of two warpgroups
// per SM, too few loads and stores in flight.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_pipe.cuh"
#include "tile_util.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // positions of a tile (wgmma M)
constexpr int kWG = 2;     // warpgroups per block, sharing the weights
constexpr int kRing = 3;   // tile slots per warpgroup
// the leaky slope 0.01 rounded to bf16, as the TPU kernel's 0.01 * h
// with a bf16 h rounds it
constexpr float kNegSlopeBf16 = 0.010009765625f;

struct ConvTArgs {
  const bf16* x;        // (B, T, F, cin), channels contiguous
  int64_t sb, st, sf;   // x's element strides of batch, time, frequency
  const float* inv;     // (cin,) values already rounded to bf16
  const float* shift;   // (cin,)
  const float* beta;    // (B, cin)
  const bf16* w;        // packed (2, cin / 16, 2 cout / 8, 2, 8, 8)
  bf16* out;            // (B, 2T, 2F, cout), channels contiguous
  int64_t ob, ot, of;   // output strides
  int t, f;
  int fblocks;          // ceil(F / 64): tiles per row
  int64_t units;        // B * T * fblocks
};

// the two phases' weights, shared by the block, and each warpgroup's ring
// and its two output stages
template <int CIN, int COUT>
struct Smem {
  static constexpr int kN = 2 * COUT;
  static constexpr int kW = 2 * CIN * kN * 2;
  static constexpr int kSlot = kRows * CIN * 2;
  static constexpr int kStage = kRows * kN * 2;
  static constexpr int kPerWG = kRing * kSlot + 2 * kStage;
  static constexpr int kBytes = kW + kWG * kPerWG;
  // blocks per SM the shared memory allows (the register cap follows)
  static constexpr int kBlocks = 2 * (kBytes + 1024) <= 233472 ? 2 : 1;
};

// where a unit lies, advanced one unit at a time (no divisions per step)
struct Cursor {
  int bi, ti, fb;
  __device__ __forceinline__ void next(int t, int fblocks) {
    if (++fb == fblocks) {
      fb = 0;
      if (++ti == t) {
        ti = 0;
        ++bi;
      }
    }
  }
};

// bf16 pair arithmetic with an explicit rounding modifier: without one,
// ptxas may contract a multiply and the following add into one fma, which
// rounds once where PyTorch's separate ops round twice
__device__ __forceinline__ __nv_bfloat162 mul_rn(__nv_bfloat162 a,
                                                 __nv_bfloat162 b) {
  __nv_bfloat162 d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(*reinterpret_cast<uint32_t*>(&d))
      : "r"(*reinterpret_cast<uint32_t*>(&a)),
        "r"(*reinterpret_cast<uint32_t*>(&b)));
  return d;
}

__device__ __forceinline__ __nv_bfloat162 add_rn(__nv_bfloat162 a,
                                                 __nv_bfloat162 b) {
  __nv_bfloat162 d;
  asm("add.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(*reinterpret_cast<uint32_t*>(&d))
      : "r"(*reinterpret_cast<uint32_t*>(&a)),
        "r"(*reinterpret_cast<uint32_t*>(&b)));
  return d;
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(kWG * 128, Smem<CIN, COUT>::kBlocks)
    act_convt_kernel(ConvTArgs p) {
  using S = Smem<CIN, COUT>;
  constexpr int N = S::kN;
  constexpr int KK = CIN / 16;    // k16 steps
  constexpr int CH = CIN / 8;     // 16-byte chunks of an input position
  constexpr int PP = 128 / CH;    // positions one pass of a warpgroup covers
  constexpr int KP = kRows / PP;  // input chunks a thread owns in a tile
  constexpr int OC = N / 8;       // 16-byte chunks of a stage row
  constexpr int KO = kRows * OC / 128;  // output chunks per thread per phase
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wg = threadIdx.x / 128;
  const int wt = threadIdx.x % 128;
  const int warp = wt / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t w_s = sm90::smem_u32(smem);
  unsigned char* ring = smem + S::kW + wg * S::kPerWG;
  const uint32_t ring_s = w_s + S::kW + wg * S::kPerWG;
  const uint32_t stage_s = ring_s + kRing * S::kSlot;

  // ---- the weights, once per block ---------------------------------------
  for (int i = threadIdx.x; i < S::kW / 16; i += blockDim.x)
    sm90::cp_async16(w_s + 16 * i, reinterpret_cast<const uint4*>(p.w) + i);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();
  __syncthreads();

  const int64_t walkers = int64_t(gridDim.x) * kWG;
  const int64_t walker = int64_t(blockIdx.x) * kWG + wg;
  const int64_t u_begin = walker * p.units / walkers;
  const int64_t u_end = (walker + 1) * p.units / walkers;

  // this thread's input chunks: channel chunk ch of positions p0 + k * PP,
  // at byte chunk_off[k] of a slot
  const int ch = wt % CH;
  const int p0 = wt / CH;
  int chunk_off[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int pos = p0 + k * PP;
    chunk_off[k] = pos * (CIN * 2) + ((ch ^ sm90::swizzle_key(pos, CH)) * 16);
  }
  // this thread's channels' inv and shift as bf16 pairs (beta per batch)
  __nv_bfloat162 vi[4], vs[4], vb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    vi[i] = __floats2bfloat162_rn(p.inv[ch * 8 + 2 * i],
                                  p.inv[ch * 8 + 2 * i + 1]);
    vs[i] = __floats2bfloat162_rn(p.shift[ch * 8 + 2 * i],
                                  p.shift[ch * 8 + 2 * i + 1]);
  }
  const __nv_bfloat162 slope = __float2bfloat162_rn(kNegSlopeBf16);
  // this thread's output chunks: stage chunk oc (frequency tap j, channels
  // o .. o + 7) of rows r0 + k * 128 / OC
  const int oc = wt % OC;
  const int r0 = wt / OC;
  const int oj = oc * 8 / COUT;
  const int oo = oc * 8 - oj * COUT;
  // this lane's ldmatrix / stmatrix row, and its swizzle
  const int lrow = warp * 16 + (lane & 15);
  const int lhi = lane >> 4;
  const int lkey = sm90::swizzle_key(lrow, CH);
  const int bar = 1 + wg;

  // copy the tile at cursor c (unit u) if this range has it (positions
  // past F: zeros), and close a cp.async group
  auto issue = [&](int64_t u, const Cursor& c) {
    if (u < u_end) {
      const uint32_t slot = ring_s + int(u % kRing) * S::kSlot;
      const bf16* xr = p.x + c.bi * p.sb + c.ti * p.st + ch * 8;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int fj = c.fb * kRows + p0 + k * PP;
        if (fj < p.f) {
          sm90::cp_async16(slot + chunk_off[k], xr + fj * p.sf);
        } else {
          sm90::st_shared_zero16(slot + chunk_off[k]);
        }
      }
    }
    sm90::cp_async_commit();
  };
  // phase i's stage -> output row 2 ti + i in 16-byte stores
  auto sweep = [&](uint32_t stage, int bi, int ti, int f0, int i) {
    bf16* orow = p.out + bi * p.ob + (2 * ti + i) * p.ot + oo;
    uint4 v[KO];
#pragma unroll
    for (int k = 0; k < KO; ++k) {
      const int r = r0 + k * (128 / OC);
      v[k] = *reinterpret_cast<const uint4*>(
          smem + (stage - w_s) + r * (N * 2) +
          ((oc ^ sm90::swizzle_key(r, OC)) * 16));
    }
#pragma unroll
    for (int k = 0; k < KO; ++k) {
      const int r = r0 + k * (128 / OC);
      if (f0 + r < p.f)
        *reinterpret_cast<uint4*>(orow + (2 * (f0 + r) + oj) * p.of) = v[k];
    }
  };

  Cursor cur;
  {
    const int64_t row = u_begin / p.fblocks;
    cur.fb = int(u_begin - row * p.fblocks);
    cur.bi = int(row / p.t);
    cur.ti = int(row - int64_t(cur.bi) * p.t);
  }
  Cursor ahead = cur;  // the next unit to issue
  for (int k = 0; k < kRing - 1; ++k) {
    issue(u_begin + k, ahead);
    ahead.next(p.t, p.fblocks);
  }
  int cur_b = -1;
  for (int64_t u = u_begin; u < u_end; ++u, cur.next(p.t, p.fblocks)) {
    const int bi = cur.bi, ti = cur.ti, f0 = cur.fb * kRows;
    if (bi != cur_b) {
      cur_b = bi;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        vb[i] = __floats2bfloat162_rn(
            p.beta[int64_t(bi) * CIN + ch * 8 + 2 * i],
            p.beta[int64_t(bi) * CIN + ch * 8 + 2 * i + 1]);
    }
    const int slot_i = int(u % kRing);
    sm90::cp_async_wait<kRing - 2>();  // this thread's copies of unit u landed

    // activate this thread's in-range chunks in place, in bf16 pairs: each
    // product and sum correctly rounded to bf16, as PyTorch's bf16 ops
    // round their float32 results (for bf16 operands the two agree)
    unsigned char* slot = ring + slot_i * S::kSlot;
    uint4 raw[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k)
      if (f0 + p0 + k * PP < p.f)
        raw[k] = *reinterpret_cast<const uint4*>(slot + chunk_off[k]);
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      if (f0 + p0 + k * PP >= p.f) continue;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw[k]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 v =
            add_rn(add_rn(mul_rn(h[i], vi[i]), vs[i]), vb[i]);
        h[i] = __hmax2(v, mul_rn(v, slope));
      }
      *reinterpret_cast<uint4*>(slot + chunk_off[k]) = raw[k];
    }
    // every chunk of unit u is activated; every read of unit u - 1's slot
    // (the previous step's ldmatrix) is done
    sm90::bar_sync(bar, 128);
    issue(u + kRing - 1, ahead);
    ahead.next(p.t, p.fblocks);

    uint32_t fa[KK][4];  // the tile's A fragments, loaded once
    const uint32_t arow = ring_s + slot_i * S::kSlot + lrow * (CIN * 2);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      sm90::ldmatrix_x4(fa[kk], arow + (((2 * kk + lhi) ^ lkey) * 16));
    float acc[N / 2];
    sm90::mma_chain<N, KK>(acc, fa, w_s);  // phase i = 0
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::store_tile<N>(acc, stage_s, N * 2, lrow, lhi);
    sm90::mma_chain<N, KK>(acc, fa, w_s + CIN * N * 2);  // phase i = 1
    sm90::bar_sync(bar, 128);  // phase 0's stage is written
    sweep(stage_s, bi, ti, f0, 0);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::fence_frags(fa);
    sm90::store_tile<N>(acc, stage_s + S::kStage, N * 2, lrow, lhi);
    sm90::bar_sync(bar, 128);  // phase 1's stage is written
    sweep(stage_s + S::kStage, bi, ti, f0, 1);
  }
}

template <int CIN, int COUT>
int launch(const ConvTArgs& p, cudaStream_t stream) {
  constexpr int bytes = Smem<CIN, COUT>::kBytes;
  static_assert(bytes <= lass::kMaxSmem, "weights and rings exceed the SM");
  auto kernel = act_convt_kernel<CIN, COUT>;
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

// C entry point bound with ctypes. x: bf16 (B, T, F, cin) in memory with
// contiguous channels and 16-byte aligned positions (element strides sb,
// st, sf multiples of 8); inv, shift: (cin,) float32 holding bf16 values;
// beta: contiguous (B, cin) float32 holding bf16 values; w: the (2, cin,
// 2 cout) weights (phase i, channel c, column j * cout + o) packed by
// lass_torch.ops._common.pack_b; out: bf16 (B, 2T, 2F, cout) with
// contiguous channels, strides ob, ot, of multiples of 8. cin 64 or 128,
// cout 32 or 64. Returns cudaGetLastError() after the launch.
extern "C" int lass_act_convt(const void* x, int64_t sb, int64_t st,
                              int64_t sf, const void* inv, const void* shift,
                              const void* beta, const void* w, void* out,
                              int64_t ob, int64_t ot, int64_t of,
                              int64_t batch, int64_t t, int64_t f,
                              int64_t cin, int64_t cout, void* stream) {
  ConvTArgs p;
  p.x = static_cast<const bf16*>(x);
  p.sb = sb;
  p.st = st;
  p.sf = sf;
  p.inv = static_cast<const float*>(inv);
  p.shift = static_cast<const float*>(shift);
  p.beta = static_cast<const float*>(beta);
  p.w = static_cast<const bf16*>(w);
  p.out = static_cast<bf16*>(out);
  p.ob = ob;
  p.ot = ot;
  p.of = of;
  p.t = int(t);
  p.f = int(f);
  p.fblocks = int((f + kRows - 1) / kRows);
  p.units = batch * t * p.fblocks;
  if (p.units == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 128 && cout == 64) return launch<128, 64>(p, s);
  if (cin == 128 && cout == 32) return launch<128, 32>(p, s);
  if (cin == 64 && cout == 64) return launch<64, 64>(p, s);
  if (cin == 64 && cout == 32) return launch<64, 32>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
