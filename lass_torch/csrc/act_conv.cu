// Fused pre-activation + 3x3 SAME convolution on Hopper tensor cores:
//
//   y = conv3x3(leaky(a * x + b), W),   x = concat(src0, src1) on channels
//
// Replaces the Pallas TPU kernel lass_tpu/ops/pallas_folded_conv.py
// fused_act_folded_conv (on the logical layout: the TPU's frequency fold
// has no counterpart here). a and b are per-(batch, channel) float32
// vectors: the eval BatchNorm scale, and its shift plus the FiLM beta.
// Rounding points as in the TPU kernel: a * x + b and the leaky ReLU in
// float32, the activation rounded to bf16 before the product, float32
// accumulation, the output rounded to bf16. SAME padding pads the
// ACTIVATED tensor with zeros (leaky(a * 0 + b) != 0), so positions
// outside [0, T) x [0, F) are zeroed after the activation.
//
// Layout: activations NHWC in memory (torch.channels_last of a logical
// (B, C, T, F) tensor), channels contiguous, so the GEMM's K runs along
// contiguous memory. The input may be two source tensors (the decoder's
// [upsampled, skip] pair); K runs over source 0's channels, then source
// 1's, and the concatenation is never written to device memory.
//
// What bounds it on an H100: memory at the UNet's 32-channel level (32 ->
// 32 at 1024 x 512: 77 flop per byte moved against the card's 295 at its
// bf16 peak), operations at (64 + 64) -> 64 (313 us of operations against
// 240 us of bytes at 16 x 512 x 256), near the line at 64 -> 64. The
// design reads each input element from device memory once (plus a 2 / 64
// frequency halo), keeps the weights resident, keeps the next rows' loads
// in flight while the tensor cores run, and issues wgmma, the only route
// to the tensor cores' full rate.
//
// What bounds it now (chip_smoke.py phase 6 on an H100, PERF.md PR 4):
// the 32-channel launches run at 54-67% of their bytes bound, 64 -> 64 at
// 46%, (64 + 64) -> 64 at 38% of its operations bound. Each warpgroup's step is a chain
// of serial phases (wait for row t + 1, activate it, products, stage,
// stores) over a small tile (64 positions), and at (64 + 64) -> 64 one
// warpgroup per SM (its 147 KB of weights) leaves the phases nothing to
// overlap with.
// The next lever: two output rows per step (each A row loaded once for
// both, half the barriers).
//
// Design (persistent, after the TPU kernel's resident weights and
// double-buffered halo DMA; the same pipeline as timetap_conv.cu, with a
// frequency halo and the per-batch affine):
// - A block is one warpgroup. It holds all nine taps' weights in shared
//   memory, loaded once (18 KB at 32 -> 32, 147 KB at (64 + 64) -> 64), in
//   wgmma's K-major B layout (the wrapper packs them, sm90_pipe.cuh). The
//   grid is as many blocks as fit on the SMs at once: 1 per SM at
//   (64 + 64) -> 64, several at the narrow launches, each with its own copy
//   of the weights (two warpgroups sharing one copy, or a deeper ring,
//   measured no faster).
// - A column is one batch and a strip of 64 frequencies; a unit is one
//   time row of a column; block w of W takes units [w U / W, (w + 1) U /
//   W) and walks them down T, keeping the activated rows t - 1 and t of
//   the previous step, so each input row is read from device memory once
//   (a strip re-reads its two halo columns, and a block's range re-reads
//   one halo row where it starts a column).
// - A ring of four row slots of 66 positions x C_in bf16 (16-byte chunks
//   XOR-swizzled for conflict-free ldmatrix): rows t - 1, t, t + 1 are read
//   by step t's products while row t + 2 arrives by cp.async; row t + 3 is
//   issued into row t - 1's slot once the products are done. A 16-byte
//   chunk takes its source (src0 or src1) by its channel.
// - Each thread owns one 8-channel chunk (so its 8 a and 8 b values stay
//   in registers, reloaded per column) at every (128 / (C_in / 8))-th
//   position, and activates in place exactly the chunks it copied, right
//   after its own cp.async wait, all its loads before its arithmetic;
//   positions outside the image are written as zero and never activated.
// - The products are wgmma m64n{C_out}k16 with A from registers, loaded by
//   ldmatrix at the tap's row and frequency shift (a shift of one position
//   breaks the 8-row core-matrix alignment an A descriptor would need), B
//   from the resident weights, double-buffered by tap.
// - Epilogue: the float32 accumulators go to bf16 in an output stage by
//   stmatrix, then to device memory in 16-byte stores (each thread's 4-byte
//   pairs straight from the fragments write half-sectors, and were slower).
//
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_pipe.cuh"
#include "tile_util.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;          // frequencies of a strip (wgmma M)
constexpr int kHalo = kRows + 2;   // positions of a row slot

struct Source {
  const bf16* ptr;
  int64_t sb, st, sf;  // element strides of batch, time, frequency
  int c;               // channels (contiguous, stride 1)
};

struct ActConvArgs {
  Source src0, src1;    // src1.c == 0 when there is one source
  const float* a;       // (B, cin)
  const float* b;       // (B, cin)
  const bf16* w;        // packed (9, cin / 16, cout / 8, 2, 8, 8)
  bf16* out;
  int64_t ob, ot, of;   // output strides (channels contiguous)
  int t, f, cin;
  int strips;           // ceil(F / 64): columns per batch
  int64_t units;        // B * strips * T
};

constexpr int kRing = 4;  // row slots

// the nine taps' weights, the ring, and the output stage
inline int64_t smem_bytes(int cin, int cout) {
  return int64_t(9) * cin * cout * 2 + int64_t(kRing) * kHalo * cin * 2 +
         int64_t(kRows) * cout * 2;
}

struct NoOp {
  __device__ __forceinline__ void operator()(uint32_t (&)[4]) const {}
};

// N = C_out; KK = C_in / 16 (EXACT: the channel counts are compile-time
// constants) or its upper bound
template <int N, int KK, bool EXACT>
__global__ void __launch_bounds__(128) act_conv3x3_kernel(ActConvArgs p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cin = EXACT ? 16 * KK : p.cin;
  const int kk_n = cin / 16;
  const int wbytes = 9 * cin * N * 2;
  const int sbytes = kHalo * cin * 2;
  const int row_bytes = cin * 2;
  const uint32_t w_s = sm90::smem_u32(smem);
  unsigned char* ring = smem + wbytes;
  const uint32_t ring_s = w_s + wbytes;
  const uint32_t stage_s = ring_s + kRing * sbytes;

  // ---- the weights, once per block ---------------------------------------
  for (int i = tid; i < wbytes / 16; i += 128)
    sm90::cp_async16(w_s + 16 * i, reinterpret_cast<const uint4*>(p.w) + i);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();
  __syncthreads();

  int64_t u = int64_t(blockIdx.x) * p.units / gridDim.x;
  const int64_t u_end = int64_t(blockIdx.x + 1) * p.units / gridDim.x;

  // this thread's chunks: channel chunk ch at positions j0 + k * pp, at
  // byte chunk_off[k] of a slot (kJ: the most any thread owns)
  constexpr int kJ = (kHalo + 128 / (2 * KK) - 1) / (128 / (2 * KK));
  const int chunks = cin / 8;
  const int pp = 128 / chunks;
  const bool copier = tid < pp * chunks;
  const int ch = tid % chunks;
  const int j0 = tid / chunks;
  int chunk_off[kJ];
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    const int j = j0 + k * pp;
    chunk_off[k] = j * row_bytes + ((ch ^ sm90::swizzle_key(j, chunks)) * 16);
  }
  const bool second = ch * 8 >= p.src0.c;
  const Source src = second ? p.src1 : p.src0;
  const bf16* sp = src.ptr + (second ? ch * 8 - p.src0.c : ch * 8);
  // this thread's output chunks: channel chunk oc at rows r0 + k * 128 / OC
  constexpr int OC = N / 8;
  const int oc = tid % OC;
  const int r0 = tid / OC;
  // this lane's ldmatrix rows (frequency shift df = 0, 1, 2) and swizzles
  const int lrow = warp * 16 + (lane & 15);
  const int lhi = lane >> 4;
  int lkey[3];
#pragma unroll
  for (int df = 0; df < 3; ++df)
    lkey[df] = sm90::swizzle_key(lrow + df, chunks);

  while (u < u_end) {
    const int64_t col = u / p.t;
    const int64_t col_end = (col + 1) * p.t;
    const int64_t u_stop = u_end < col_end ? u_end : col_end;
    const int t_s = int(u - col * p.t);
    const int t_e = int(u_stop - col * p.t);
    u = u_stop;
    const int bi = int(col / p.strips);
    const int f0 = int(col % p.strips) * kRows;
    const bf16* xb = sp + bi * src.sb;
    float va[8], vb[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      va[i] = p.a[int64_t(bi) * cin + ch * 8 + i];
      vb[i] = p.b[int64_t(bi) * cin + ch * 8 + i];
    }

    // which of this thread's positions lie in the image (fj in [0, F))
    unsigned inside = 0;
#pragma unroll
    for (int k = 0; k < kJ; ++k) {
      const int j = j0 + k * pp;
      const int fj = f0 - 1 + j;
      if (copier && j < kHalo && fj >= 0 && fj < p.f) inside |= 1u << k;
    }

    // copy row r (positions f0 - 1 .. f0 + 64; outside the image zeros)
    // if a step of this range reads it, and close a cp.async group
    auto issue = [&](int r) {
      if (copier && r <= t_e) {
        const uint32_t slot = ring_s + (r & (kRing - 1)) * sbytes;
        const bool in_t = r >= 0 && r < p.t;
        const bf16* xr = xb + r * src.st;
#pragma unroll
        for (int k = 0; k < kJ; ++k) {
          const int j = j0 + k * pp;
          if (j >= kHalo) break;
          if (in_t && (inside >> k & 1)) {
            sm90::cp_async16(slot + chunk_off[k], xr + (f0 - 1 + j) * src.sf);
          } else {
            sm90::st_shared_zero16(slot + chunk_off[k]);
          }
        }
      }
      sm90::cp_async_commit();
    };
    // activate this thread's in-image chunks of row r in place: every
    // load first, then the arithmetic and the stores
    auto activate = [&](int r) {
      if (r < 0 || r >= p.t) return;
      unsigned char* slot = ring + (r & (kRing - 1)) * sbytes;
      uint4 raw[kJ];
#pragma unroll
      for (int k = 0; k < kJ; ++k)
        if (inside >> k & 1)
          raw[k] = *reinterpret_cast<const uint4*>(slot + chunk_off[k]);
#pragma unroll
      for (int k = 0; k < kJ; ++k) {
        if (!(inside >> k & 1)) continue;
        float v[8];
        lass::unpack8(raw[k], v);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = lass::leaky(lass::affine(va[i], v[i], vb[i]));
        lass::store8(reinterpret_cast<bf16*>(slot + chunk_off[k]), v);
      }
    };

    sm90::bar_sync(1, 128);  // the previous range's reads are done
    for (int r = t_s - 1; r < t_s + kRing - 1; ++r) issue(r);

    for (int t = t_s; t < t_e; ++t) {
      sm90::cp_async_wait<kRing - 3>();  // this thread's row t + 1 landed
      if (t == t_s) {
        activate(t - 1);
        activate(t);
      }
      activate(t + 1);
      sm90::bar_sync(1, 128);  // rows t - 1 .. t + 1 are ready

      float acc[N / 2];
      auto a_addr = [&](int tap, int kk) {
        const int dt = tap / 3;
        const int df = tap - 3 * dt;
        return ring_s + ((t - 1 + dt) & (kRing - 1)) * sbytes +
               (lrow + df) * row_bytes + (((2 * kk + lhi) ^ lkey[df]) * 16);
      };
      sm90::mma_taps<N, KK, EXACT, 9>(acc, kk_n, a_addr, NoOp(), w_s);

      // accumulators -> bf16 stage -> device memory in 16-byte stores
      sm90::store_tile<N>(acc, stage_s, N * 2, lrow, lhi);
      sm90::bar_sync(1, 128);  // the stage is written; row t - 1 is read
      issue(t + kRing - 1);
      bf16* orow = p.out + int64_t(bi) * p.ob + int64_t(t) * p.ot + oc * 8;
      constexpr int kOut = kRows * OC / 128;  // output chunks per thread
      uint4 v[kOut];
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const int r = r0 + k * (128 / OC);
        v[k] = *reinterpret_cast<const uint4*>(
            smem + (stage_s - w_s) + r * (N * 2) +
            ((oc ^ sm90::swizzle_key(r, OC)) * 16));
      }
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const int r = r0 + k * (128 / OC);
        if (f0 + r < p.f)
          *reinterpret_cast<uint4*>(orow + (f0 + r) * p.of) = v[k];
      }
    }
  }
}

template <int N, int KK, bool EXACT>
int launch(const ActConvArgs& p, cudaStream_t stream) {
  const int64_t bytes = smem_bytes(p.cin, N);
  if (bytes > lass::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = act_conv3x3_kernel<N, KK, EXACT>;
  int err = lass::allow_smem(kernel, bytes);
  if (err != 0) return err;
  int resident = 0;
  err = lass::resident_blocks(kernel, 128, bytes, &resident);
  if (err != 0) return err;
  const int blocks = int(p.units < resident ? p.units : resident);
  kernel<<<blocks, 128, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_n(const ActConvArgs& p, cudaStream_t stream) {
  switch (p.cin / 16) {  // the serving widths get exact instances
    case 2: return launch<N, 2, true>(p, stream);
    case 4: return launch<N, 4, true>(p, stream);
    case 8: return launch<N, 8, true>(p, stream);
    default: return launch<N, 8, false>(p, stream);
  }
}

}  // namespace

// C entry point bound with ctypes. Pointers and the stream come as void*,
// sizes and element strides as int64. The caller guarantees: bf16 tensors
// with contiguous channels and 16-byte aligned rows (channel counts and
// strides multiples of 8), c0 % 8 == 0, (c0 + c1) % 16 == 0 and at most
// 128, cout 32 or 64 (the UNet's two widest levels), a/b contiguous (B,
// c0 + c1) float32, w the (9, c0 + c1, cout) weights packed by
// lass_torch.ops._common.pack_b. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int lass_act_conv3x3(
    const void* src0, int64_t sb0, int64_t st0, int64_t sf0, int64_t c0,
    const void* src1, int64_t sb1, int64_t st1, int64_t sf1, int64_t c1,
    const void* a, const void* b, const void* w, void* out, int64_t ob,
    int64_t ot, int64_t of, int64_t batch, int64_t t, int64_t f,
    int64_t cout, void* stream) {
  ActConvArgs p;
  p.src0 = {static_cast<const bf16*>(src0), sb0, st0, sf0, int(c0)};
  p.src1 = {static_cast<const bf16*>(src1), sb1, st1, sf1, int(c1)};
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.w = static_cast<const bf16*>(w);
  p.out = static_cast<bf16*>(out);
  p.ob = ob;
  p.ot = ot;
  p.of = of;
  p.t = int(t);
  p.f = int(f);
  p.cin = int(c0 + c1);
  p.strips = int((f + kRows - 1) / kRows);
  p.units = batch * p.strips * t;
  if (batch == 0 || t == 0 || f == 0) return static_cast<int>(cudaSuccess);
  if (c0 % 8 || p.cin % 16 || p.cin == 0 || p.cin > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 32: return launch_n<32>(p, s);
    case 64: return launch_n<64>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
