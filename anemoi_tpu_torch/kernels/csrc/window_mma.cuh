// Tensor-core helpers of the bf16 banded kernels (window_attention_bwd.cu;
// window_attention_fwd.cu through window_wgmma.cuh): cp.async staging with
// zero-fill, a swizzled shared-memory tile layout, ldmatrix,
// mma.sync.m16n8k16 with bf16 inputs and float32 accumulators, and the
// warp-slab fragment helpers (packing, element positions, stores).
//
// Fragments of mma.sync.aligned.m16n8k16.row.col (lane = 4 * grp + tig):
//   A, 16 x 16, 4 x b32:  a0 (grp, 2tig..2tig+1)    a1 (grp + 8, 2tig..)
//                         a2 (grp, 2tig + 8..)      a3 (grp + 8, 2tig + 8..)
//   B, 16 x 8, 2 x b32:   b0 (k 2tig..2tig+1, n grp)   b1 (k 2tig + 8.., n grp)
//   C, 16 x 8, 4 x f32:   c0, c1 (grp, 2tig..2tig+1)   c2, c3 (grp + 8, 2tig..)
// So the accumulators of two neighbouring n-tiles (columns 16c .. 16c + 15),
// packed two by two to bf16 (pack_bf16), are the A fragment of k-chunk c of
// the next product as they stand: P and dS never leave registers.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "gt_common.cuh"

namespace tc {

using bf16 = __nv_bfloat16;

// A row-major tile of bf16 rows of D elements in shared memory.  The 16-byte
// chunks of each row are permuted by an XOR with a function of the row, so
// that the 8 row addresses of one ldmatrix 8 x 8 matrix (8 rows at the same
// logical chunk) fall in 8 different 16-byte bank groups for every D of 16,
// 32, 64 and 128 (rows of 2, 4, 8 and 16 chunks): no bank conflicts, with
// or without .trans, and none on the cp.async stores of whole rows.
template <int D>
struct Swizzle {
  static constexpr int kChunks = D / 8;                            // 16-byte chunks a row
  static constexpr int kRowsPer128 = kChunks < 8 ? 8 / kChunks : 1;  // rows per 128 bytes
  static constexpr int kMask = (kChunks < 8 ? kChunks : 8) - 1;
  // Element offset of chunk `chunk` (8 elements) of row `row`.
  __device__ static __forceinline__ int at(int row, int chunk) {
    return row * D + ((chunk ^ ((row / kRowsPer128) & kMask)) << 3);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 (or 4) bytes from device to shared memory, asynchronously.  With
// valid false the source is not read (src-size 0) and the hardware writes
// zeros; `src` must still be an address inside the tensor.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
using gt::cp_async_commit;
using gt::cp_async_wait;

// Stage rows [pos0, pos0 + ROWS) of a bf16 tensor whose row `pos` starts at
// src + pos * stride (16-byte aligned; n * stride < 2^31) into a swizzled
// [ROWS][D] tile; rows at or past n are zero-filled.  Every thread of the
// block calls it.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int pos0, int n,
                                           int stride) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / kChunks, c = idx % kChunks, pos = pos0 + r;
    const bf16* from = src + (pos < n ? pos : n - 1) * stride + c * 8;
    cp_async16(dst + Swizzle<D>::at(r, c), from, pos < n);
  }
}

// ldmatrix.x4: four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the row
// addresses of matrix i, whose fragment lands in r[i].  .trans transposes
// each matrix on the way.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The lane's ldmatrix address in a swizzled [rows][D] tile for
//   a_frag:  the A fragment of rows m0 .. m0 + 15, k-chunk kc (columns 16kc ..);
//   b_frag:  the B fragments (b0, b1) of two n-tiles, rows n0 .. n0 + 15 of
//            the tile as n, k-chunk kc: B[k][n] = tile[n0 + n][16kc + k];
//   bt_frag: with .trans, the B fragments of two n-tiles, columns 16nc .. of
//            the tile as n, k-chunk kc as rows: B[k][n] = tile[16kc + k][16nc + n].
// Each gives r[0], r[1] = (b0, b1) of the first n-tile, r[2], r[3] of the second
// (a_frag: a0 .. a3).
template <int D>
__device__ __forceinline__ const bf16* a_frag(const bf16* tile, int m0, int kc, int lane) {
  return tile + Swizzle<D>::at(m0 + (lane & 15), 2 * kc + (lane >> 4));
}
template <int D>
__device__ __forceinline__ const bf16* b_frag(const bf16* tile, int n0, int kc, int lane) {
  return tile + Swizzle<D>::at(n0 + (lane & 7) + ((lane >> 4) << 3), 2 * kc + ((lane >> 3) & 1));
}
template <int D>
__device__ __forceinline__ const bf16* bt_frag(const bf16* tile, int kc, int nc, int lane) {
  return tile + Swizzle<D>::at(16 * kc + (lane & 7) + (((lane >> 3) & 1) << 3),
                               2 * nc + (lane >> 4));
}

// c += a b on the tensor cores: a 16 x 16, b 16 x 8 (bf16), c 16 x 8 (float32).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values as one bf16x2 register, `lo` in the low half (the
// lower column), each rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A warp's 16 x COLS slab x (float32, accumulator layout) rounded to bf16 as
// the A fragments of the COLS / 16 k-chunks of its next product.  Packing
// the whole slab first lets its floats die before that product runs.
template <int COLS>
__device__ __forceinline__ void pack_slab(uint32_t (&xa)[COLS / 16][4],
                                          const float (&x)[COLS / 8][4]) {
#pragma unroll
  for (int kc = 0; kc < COLS / 16; ++kc) {
    xa[kc][0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
    xa[kc][1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
    xa[kc][2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    xa[kc][3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
  }
}

// Row r (0 .. 15) and column c (0 .. COLS - 1) of element e of n-tile nt of
// a warp's slab.
__device__ __forceinline__ int slab_row(int lane, int e) { return (lane >> 2) + ((e >> 1) << 3); }
__device__ __forceinline__ int slab_col(int lane, int nt, int e) {
  return 8 * nt + 2 * (lane & 3) + (e & 1);
}

// Store rows m0 + slab_row of a warp's 16 x D accumulator times `mul` as
// bf16 pairs at out + (pos0 + row) * stride, for positions below n.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 8][4], float mul,
                                           int pos0, int m0, int lane, int n, int stride) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = pos0 + m0 + slab_row(lane, 2 * i);
    if (pos >= n) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(out + pos * stride + slab_col(lane, nt, 0)) =
          __floats2bfloat162_rn(acc[nt][2 * i] * mul, acc[nt][2 * i + 1] * mul);
  }
}

}  // namespace tc
