// Fused pre-activation + 3x3 SAME convolution on bf16 tensor cores:
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
// What bounds it on an H100: at the UNet's widest levels memory, nearly
// (32 -> 32 channels at 1024 x 512: 77 flop per byte moved against the
// card's 295 at its bf16 peak); with 128 input channels operations.
//
// Design (simple first): one block of 8 warps computes an 8 x 32
// (time x frequency) output tile for all output channels. It loads the
// (8 + 2) x (32 + 2) x C_in input halo once from device memory, applies
// the affine + leaky in registers, and stores the bf16 activation to
// shared memory; then for each of the 9 taps it stages that tap's
// (C_in, C_out) weights in shared memory and runs 16x16x16 bf16 WMMA
// products with float32 accumulators. Each warp owns one output row (two
// 16-position m-tiles) and every n-tile of C_out. The accumulators go
// through shared memory to 16-byte bf16 stores. No TMA, wgmma or
// pipelining yet.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "tile_util.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kTT = 8;                // output rows (time) per block
constexpr int kTF = 32;               // output columns (frequency) per block
constexpr int kWarps = kTT;           // one output row per warp
constexpr int kRows = kTT + 2;        // input halo rows
constexpr int kCols = kTF + 2;        // input halo columns
constexpr int kMT = kTF / 16;         // m-tiles per warp

struct Source {
  const bf16* ptr;
  int64_t sb, st, sf;  // element strides of batch, time, frequency
  int c;               // channels (contiguous, stride 1)
};

struct ActConvArgs {
  Source src0, src1;    // src1.c == 0 when there is one source
  const float* a;       // (B, cin)
  const float* b;       // (B, cin)
  const bf16* w;        // (9, cin, cout), tap = 3 * dt + df
  bf16* out;
  int64_t ob, ot, of;   // output strides (channels contiguous)
  int t, f, cin, cout;
};

__host__ __device__ inline int lda_of(int cin) { return cin + 16; }
__host__ __device__ inline int ldb_of(int cout) { return cout + 16; }
__host__ __device__ inline int ldc_of(int cout) { return cout + 8; }

inline int64_t smem_bytes(int cin, int cout) {
  const int64_t operands =
      int64_t(kRows) * kCols * lda_of(cin) * 2 + int64_t(cin) * ldb_of(cout) * 2;
  const int64_t staging = int64_t(kTT) * kTF * ldc_of(cout) * 4;
  return operands > staging ? operands : staging;
}

template <int NT>  // n-tiles of 16 output channels
__global__ void __launch_bounds__(kWarps * 32)
    act_conv3x3_kernel(ActConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = lda_of(p.cin), ldb = ldb_of(p.cout), ldc = ldc_of(p.cout);
  bf16* tile = reinterpret_cast<bf16*>(smem);
  bf16* wt = tile + kRows * kCols * lda;
  float* stage = reinterpret_cast<float*>(smem);  // after the products

  const int bi = blockIdx.z;
  const int t0 = blockIdx.y * kTT;
  const int f0 = blockIdx.x * kTF;
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  // ---- activated input halo -> shared memory (bf16) -------------------
  const int c8 = p.cin / 8;
  const float* a = p.a + int64_t(bi) * p.cin;
  const float* b = p.b + int64_t(bi) * p.cin;
  for (int idx = tid; idx < kRows * kCols * c8; idx += blockDim.x) {
    const int pos = idx / c8;
    const int ch = (idx - pos * c8) * 8;
    const int r = pos / kCols;
    const int c = pos - r * kCols;
    const int gt = t0 - 1 + r;
    const int gf = f0 - 1 + c;
    bf16* dst = tile + pos * lda + ch;
    if (gt < 0 || gt >= p.t || gf < 0 || gf >= p.f) {
      lass::zero8(dst);
      continue;
    }
    const Source& s = ch < p.src0.c ? p.src0 : p.src1;
    const int sc = ch < p.src0.c ? ch : ch - p.src0.c;
    float v[8];
    lass::load8(s.ptr + bi * s.sb + gt * s.st + gf * s.sf + sc, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = lass::leaky(lass::affine(a[ch + i], v[i], b[ch + i]));
    }
    lass::store8(dst, v);
  }

  // ---- 9 taps x (cin / 16) k-steps of WMMA ----------------------------
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMT][NT];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) wmma::fill_fragment(acc[mi][ni], 0.0f);

  const int n8 = p.cout / 8;
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // the previous tap's weights are consumed
    const bf16* wsrc = p.w + int64_t(tap) * p.cin * p.cout;
    for (int idx = tid; idx < p.cin * n8; idx += blockDim.x) {
      const int k = idx / n8;
      const int n = (idx - k * n8) * 8;
      *reinterpret_cast<uint4*>(wt + k * ldb + n) =
          *reinterpret_cast<const uint4*>(wsrc + k * p.cout + n);
    }
    __syncthreads();
    const int dt = tap / 3;
    const int df = tap - 3 * dt;
    for (int k0 = 0; k0 < p.cin; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          af[kMT];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        wmma::load_matrix_sync(
            af[mi], tile + ((warp + dt) * kCols + mi * 16 + df) * lda + k0,
            lda);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, wt + k0 * ldb + ni * 16, ldb);
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
      wmma::store_matrix_sync(stage + (warp * kTF + mi * 16) * ldc + ni * 16,
                              acc[mi][ni], ldc, wmma::mem_row_major);
    }
  __syncthreads();
  for (int idx = tid; idx < kTT * kTF * n8; idx += blockDim.x) {
    const int pos = idx / n8;
    const int n = (idx - pos * n8) * 8;
    const int r = pos / kTF;
    const int c = pos - r * kTF;
    const int gt = t0 + r;
    const int gf = f0 + c;
    if (gt >= p.t || gf >= p.f) continue;
    lass::store8(p.out + bi * p.ob + gt * p.ot + gf * p.of + n,
                 stage + pos * ldc + n);
  }
}

template <int NT>
int launch(const ActConvArgs& p, int batch, cudaStream_t stream) {
  const int64_t bytes = smem_bytes(p.cin, p.cout);
  if (bytes > lass::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int err = lass::allow_smem(act_conv3x3_kernel<NT>, bytes);
  if (err != 0) return err;
  const dim3 grid((p.f + kTF - 1) / kTF, (p.t + kTT - 1) / kTT, batch);
  act_conv3x3_kernel<NT><<<grid, kWarps * 32, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point bound with ctypes. Pointers and the stream come as void*,
// sizes and element strides as int64. The caller guarantees: bf16 tensors
// with contiguous channels and 16-byte aligned rows (channel counts and
// strides multiples of 8), c0 % 8 == 0, (c0 + c1) % 16 == 0, cout 32 or
// 64 (the UNet's two widest levels), a/b contiguous (B, c0 + c1) float32, w (9, c0 + c1,
// cout) bf16. Returns cudaGetLastError() after the launch (0 on success).
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
  p.cout = int(cout);
  if (batch == 0 || t == 0 || f == 0) return static_cast<int>(cudaSuccess);
  if (c0 % 8 || p.cin % 16 || p.cin == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 32: return launch<2>(p, int(batch), s);
    case 64: return launch<4>(p, int(batch), s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
