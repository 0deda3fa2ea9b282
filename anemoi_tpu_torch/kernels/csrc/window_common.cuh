// Helpers shared by the banded window-attention kernels
// (window_attention_fwd.cu, window_attention_bwd.cu).
//
// Layout: q, k, v, out and their gradients are [B, N, H, D] (element (b, pos,
// h, c) at ((b * N + pos) * H + h) * D + c), read where they are -- no
// padding, no transposition; lse and delta are float32 [B, H, N].  A block of
// kThreads = 256 threads owns one (64-row tile, head, batch row); thread
// (ty, tx) = (threadIdx.x / 16, threadIdx.x % 16) owns rows ty*4 .. ty*4+3 of
// the tile, columns tx + 16*j (j < 4) of each 64 x 64 logit tile and columns
// tx + 16*j (j < D/16) of each 64 x D output tile.  Tiles are staged in
// shared memory as float32, rows padded to D + 1 (no bank conflicts on the
// column-wise reads of the logit products).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

#include "gt_common.cuh"

namespace band {

using gt::from_float;
using gt::to_float;

constexpr int kTile = 64;      // rows of a query or key tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdP = kTile + 1;  // row stride of a 64 x 64 tile in shared memory

struct Args {
  int n;          // sequence length
  int heads;      // H
  int w;          // window: |qpos - kpos| <= w
  float scale;    // 1 / sqrt(D)
  float softcap;  // 0: none
  const float* slopes;  // ALiBi slope per head [H], or null
};

// Element (b, pos, h, 0) of a [B, N, H, D] tensor.
template <typename T, int D>
__device__ __forceinline__ const T* row0(const T* x, int b, int h, const Args& a) {
  return x + (static_cast<size_t>(b) * a.n * a.heads + h) * D;
}

// Stage rows [pos0, pos0 + 64) of one (batch row, head) into dst [64][D + 1]
// as float32; rows at or past n are zeros.  `src` is row0(...).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int pos0, const Args& a) {
  const size_t stride = static_cast<size_t>(a.heads) * D;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int pos = pos0 + r;
    dst[r * (D + 1) + c] = pos < a.n ? to_float(src[pos * stride + c]) : 0.f;
  }
}

// The logit of (qpos, kpos) from the raw product s = q . k, as the JAX
// kernel forms it: scale, softcap, ALiBi.  `t` returns tanh(s * scale / cap)
// (0 without softcap) for the backward's softcap derivative 1 - t^2.
__device__ __forceinline__ float logit(float s, int qpos, int kpos, float slope, const Args& a,
                                       float& t) {
  float x = s * a.scale;
  t = 0.f;
  if (a.softcap > 0.f) {
    t = tanhf(x / a.softcap);
    x = a.softcap * t;
  }
  return x - slope * static_cast<float>(abs(qpos - kpos));
}

__device__ __forceinline__ bool in_band(int qpos, int kpos, const Args& a) {
  return qpos < a.n && kpos < a.n && abs(qpos - kpos) <= a.w;
}

// Max / sum over the 16 threads (one tx each) that share a row: lanes
// 0-15 or 16-31 of a warp.
__device__ __forceinline__ float row_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// First and one-past-last 64-aligned tile start whose rows meet the band of
// rows [p0, p0 + 64): positions [p0 - w, p0 + 63 + w] within [0, n).
__device__ __forceinline__ void band_tiles(int p0, const Args& a, int& first, int& last) {
  const int lo = max(0, p0 - a.w);
  const int hi = min(a.n - 1, p0 + kTile - 1 + a.w);
  first = (lo / kTile) * kTile;
  last = hi + 1;
}

// Raise the block's dynamic shared memory limit once per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

}  // namespace band
