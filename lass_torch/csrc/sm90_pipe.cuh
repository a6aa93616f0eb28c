// Hopper (sm_90a) building blocks shared by the persistent conv kernels
// (act_conv.cu, timetap_conv.cu), as inline PTX: 16-byte cp.async copies
// with commit/wait groups, ldmatrix and stmatrix, warpgroup named
// barriers, the wgmma fences and groups, wgmma.mma_async m64n{32,64,128}k16
// bf16 -> f32 with A from registers and B from shared memory, the
// no-swizzle shared memory descriptor of B, the tap loop that both kernels
// run, and the stmatrix epilogue. Plain PTX, no CuTe: the whole library
// builds in about 10 s on the card.
//
// Fragments (PTX ISA, wgmma register fragments): warp w of a warpgroup
// holds rows 16w .. 16w + 15 of the 64-row A tile in the layout of the
// mma.m16n8k16 A fragment, which ldmatrix.x4 gives when lane l points at
// row (l & 15) and column 8 * (l >> 4) of a 16 x 16 block. The f32
// accumulator d[4j + 2i + e] of lane l of warp w is row 16w + l / 4 + 8i,
// column 8j + 2 (l % 4) + e.
//
// B layout ("canonical K-major, no swizzle"): 8 x 8 core matrices of
// 8 N-rows x 16 bytes of K, each stored as 128 contiguous bytes. For one
// k16 step of an N-column B: core matrix (n / 8, k / 8) lies at byte
// (n / 8) * 256 + (k / 8) * 128, so the descriptor's leading byte offset
// (the K step between core matrices) is 128 and its stride byte offset
// (the N step) is 256. pack_b in the Python wrappers writes weights so.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async: 16-byte global -> shared copies in commit groups --------
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_zero16(uint32_t dst) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst),
               "r"(0)
               : "memory");
}

// make this thread's generic-proxy shared memory writes (cp.async, st)
// visible to the async proxy that wgmma reads B through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier over `count` threads (a warpgroup: 128) with id 1..15
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators are live across the asynchronous products: keep the
// compiler from moving their reads and writes over the fences and waits
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// no-swizzle descriptor of a K-major B operand at shared address `addr`
// (16-byte aligned): leading byte offset 128 (K), stride byte offset 256
// (N), layout type 0
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) |
         (uint64_t(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 32) wgmma_m64n32k16(d, a, b, scale_d);
  if constexpr (N == 64) wgmma_m64n64k16(d, a, b, scale_d);
  if constexpr (N == 128) wgmma_m64n128k16(d, a, b, scale_d);
}

// One 64-row output tile of the warpgroup: acc = sum over TAPS taps and
// kk_n k16 steps of A(tap, kk) @ B(tap, kk). a_addr(tap, kk) is this
// lane's ldmatrix.x4 address for that A block, a_op(regs) rewrites the
// loaded fragment in registers (an elementwise activation, or nothing);
// B block (tap, kk) lies at b_base + (tap * kk_n + kk) * N * 32 bytes in
// the layout above. KK is kk_n, or its upper bound when !EXACT. A is
// double-buffered in registers by tap: the loads of tap + 1 overlap the
// products of tap, with at most two wgmma groups in flight. The first
// product overwrites acc (scale_d = 0). Returns with every product done.
template <int N, int KK, bool EXACT, int TAPS, typename AAddr, typename AOp>
__device__ __forceinline__ void mma_taps(float (&acc)[N / 2], int kk_n,
                                         const AAddr& a_addr, const AOp& a_op,
                                         uint32_t b_base) {
  uint32_t fa[2][KK][4];
  const uint64_t d0 = desc_b(b_base);
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    if (EXACT || kk < kk_n) {
      ldmatrix_x4(fa[0][kk], a_addr(0, kk));
      a_op(fa[0][kk]);
    }
  }
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap) {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      if (EXACT || kk < kk_n) {
        const uint32_t off = uint32_t(tap * (EXACT ? KK : kk_n) + kk) * (N * 32);
        wgmma_rs<N>(acc, fa[tap & 1][kk], d0 + (off >> 4), tap | kk);
      }
    }
    wgmma_commit();
    fence_regs(acc);
    if (tap + 1 < TAPS) {
      wgmma_wait<1>();  // tap - 1 is done: its A registers are free
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        if (EXACT || kk < kk_n) {
          ldmatrix_x4(fa[(tap + 1) & 1][kk], a_addr(tap + 1, kk));
          a_op(fa[(tap + 1) & 1][kk]);
        }
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16-byte chunk c of row j of a shared tile with `chunks` chunks per row,
// XOR-swizzled so that ldmatrix's eight rows at one column hit eight
// different bank groups (rows of 32, 64 or >= 128 bytes; other widths
// keep the chunk inside its aligned power-of-two block of the row)
__device__ __forceinline__ int swizzle_key(int j, int chunks) {
  if ((chunks & 7) == 0) return j & 7;
  if (chunks == 4) return (j >> 1) & 3;
  if (chunks == 2) return (j >> 2) & 1;
  return j & ((chunks & -chunks) - 1);
}

// The warpgroup's 64 x N float32 accumulators, rounded to bf16, into a
// shared tile of 64 rows x N bf16 at `tile` (row r at r * row_bytes, its
// 16-byte chunk c at chunk c ^ swizzle_key(r, N / 8)), by stmatrix: the
// epilogue then leaves through 16-byte stores. lrow/lhi: this lane's
// ldmatrix row and half (warp * 16 + (lane & 15), lane >> 4).
template <int N>
__device__ __forceinline__ void store_tile(const float (&acc)[N / 2],
                                           uint32_t tile, int row_bytes,
                                           int lrow, int lhi) {
  const uint32_t row = tile + lrow * row_bytes;
  const int key = swizzle_key(lrow, N / 8);
#pragma unroll
  for (int q = 0; q < N / 16; ++q) {
    const float* d = acc + 8 * q;  // column blocks 2q and 2q + 1
    stmatrix_x4(row + (((2 * q + lhi) ^ key) * 16), pack_bf16(d[0], d[1]),
                pack_bf16(d[2], d[3]), pack_bf16(d[4], d[5]),
                pack_bf16(d[6], d[7]));
  }
}

}  // namespace sm90
