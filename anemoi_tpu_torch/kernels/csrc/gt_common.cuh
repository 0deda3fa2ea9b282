// Helpers shared by the graph-transformer attention kernels
// (gt_attention_fwd.cu, gt_attention_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gt {

constexpr int kMaxEdgeFeatures = 8;  // the fused edge projection keeps W's column in registers
// One thread per channel (K1, K2, K4, K5): HD = 1024 (the Transformer
// preset's mappers) gives 1024-thread blocks, which launch only if a thread
// uses at most 64 registers.  The bound makes ptxas keep to that for every
// kernel that launches one thread per channel.  K3 has its own layout
// (gt_attention_bwd.cu: 256-thread blocks of destination groups).
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Sum of x over the d channels of the calling thread's head, returned to
// every thread of the head.  Every thread of the block must call it.
// `partial` holds one float per warp (used only when d > 32).
__device__ __forceinline__ float head_sum(float x, int d, float* partial) {
  if (d <= 32) {
    for (int off = d >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
  }
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's reads of `partial` are done
  if ((threadIdx.x & 31) == 0) partial[warp] = x;
  __syncthreads();
  const int warps_per_head = d >> 5;
  const int first = (warp / warps_per_head) * warps_per_head;
  float s = 0.f;
  for (int w = 0; w < warps_per_head; ++w) s += partial[first + w];
  return s;
}

// The thread's column of the edge projection: wc[t] = W[t, c], bc = bias[c]
// (W element (t, c) at t * w_sf + c * w_sc; zeros for inactive threads).
template <typename T>
__device__ __forceinline__ void load_edge_column(const T* w, const T* bias, int c, bool active,
                                                 int f, long long w_sf, long long w_sc,
                                                 float (&wc)[kMaxEdgeFeatures], float& bc) {
#pragma unroll
  for (int t = 0; t < kMaxEdgeFeatures; ++t)
    wc[t] = (active && t < f) ? to_float(w[t * w_sf + c * w_sc]) : 0.f;
  bc = active ? to_float(bias[c]) : 0.f;
}

// Channel c of edge j's feature: attr[j] . W[:, c] + bias[c] when FUSE_EDGE,
// else e[j, c] of the pre-projected [E, HD] edge tensor.
template <typename T, bool FUSE_EDGE>
__device__ __forceinline__ float edge_feature(const T* edge, int j, int c, bool active, int hd,
                                              int f, const float (&wc)[kMaxEdgeFeatures],
                                              float bc) {
  if (FUSE_EDGE) {
    float e = bc;
#pragma unroll
    for (int t = 0; t < kMaxEdgeFeatures; ++t)
      if (t < f) e += to_float(edge[static_cast<size_t>(j) * f + t]) * wc[t];
    return e;
  }
  return active ? to_float(edge[static_cast<size_t>(j) * hd + c]) : 0.f;
}

}  // namespace gt
