// Warpgroup tensor-core helpers (Hopper, sm_90a only) of the bf16 banded
// forward (window_attention_fwd.cu): shared-memory matrix descriptors for
// the swizzled tiles that tc::stage_rows writes, the fences of
// wgmma.mma_async, and its m64nNk16 products with bf16 inputs and float32
// accumulators, A from shared memory or from registers.
//
// Registers.  A warpgroup is 4 aligned warps (128 threads); warp w holds rows
// 16w .. 16w + 15 of the 64-row product.  Per warp, the float32 accumulator
// of m64nNk16 is mma.sync's C layout repeated over N / 8 n-tiles: d[nt][e]
// sits at row tc::slab_row(lane, e), column tc::slab_col(lane, nt, e).  An A
// operand in registers is mma.sync's A fragment of the warp's 16 rows, as
// tc::pack_slab packs it.
//
// Shared memory.  A [64][C] bf16 tile whose rows (C = 16, 32 or 64: 32, 64
// or 128 bytes) are permuted by tc::Swizzle<C> is wgmma's canonical 32-, 64-
// or 128-byte swizzled layout, provided the tile starts on a 1024-byte
// boundary: the hardware XORs the 16-byte chunk bits [4, 7) of an address
// with bits [7, 10), which for these row lengths is Swizzle<C>'s chunk ^
// f(row).  Rows are C * 2 bytes apart, so 8-row groups are 16 C bytes apart
// (the descriptor's stride offset).  Wider rows are stored as [64][64] slabs
// side by side, `lead` bytes apart.
//
//   K-major operand (the reduction axis runs along the rows: Q and K for
//     S = Q K^T): k-step kk (16 columns) starts 32 (kk % (C / 16)) bytes into
//     slab 16 kk / C; the hardware applies the swizzle to the advanced address.
//   N-major operand (B with the transpose flag: V for O += P V): k-step kk is
//     rows 16 kk .. 16 kk + 15 of every slab, two whole 8-row groups.
#pragma once

#include <cstdint>

#include "window_mma.cuh"

namespace wg {

using tc::bf16;

// The descriptor of a [64][C] swizzled tile (or slab) at `tile`, the next
// slab `lead` bytes on (used by an N-major operand wider than C).
template <int C>
__device__ __forceinline__ uint64_t smem_desc(const bf16* tile, uint32_t lead) {
  static_assert(C == 16 || C == 32 || C == 64, "32-, 64- or 128-byte rows");
  constexpr uint64_t kSwizzle = C == 64 ? 1 : C == 32 ? 2 : 3;  // 128-, 64-, 32-byte
  constexpr uint64_t kGroup = 8 * C * sizeof(bf16);              // bytes per 8 rows
  return static_cast<uint64_t>((tc::smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16) | ((kGroup >> 4) << 32) |
         (kSwizzle << 62);
}

// Before the first product that reads registers written since (the
// accumulators, a register A operand), all warps of the warpgroup.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Make this thread's writes to shared memory (cp.async's included, once
// waited for) visible to the tensor cores' reads (the async proxy).
__device__ __forceinline__ void fence_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of these registers across
// the fence / commit / wait that bracket the products using them.
template <int NT>
__device__ __forceinline__ void fence_regs(float (&d)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[nt][e])::"memory");
}
template <int KC>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[KC][4]) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[kc][e])::"memory");
}

// d (64 x 64, float32) = a b + (scale_d ? d : 0): a [64][16] and b [16][64]
// bf16, both K-major tiles in shared memory (descriptors).
__device__ __forceinline__ void mma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x N, float32) += a b: a [64][16] bf16 in registers (the warp's
// fragment, tc::pack_slab), b [16][N] bf16 N-major in shared memory (the
// descriptor; wgmma's transpose flag).  N = 16, 32, 64 or 128.
template <int N>
__device__ __forceinline__ void mma_rs_t(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void mma_rs_t<16>(float (&d)[2][4], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs_t<32>(float (&d)[4][4], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs_t<64>(float (&d)[8][4], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs_t<128>(float (&d)[16][4], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
}  // namespace wg
