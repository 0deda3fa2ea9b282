// Helpers shared by the graph-transformer attention kernels
// (gt_attention_fwd.cu, gt_attention_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace gt {

constexpr int kMaxEdgeFeatures = 8;  // the fused edge projection's raw width F, at most

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

// 2^x by the special-function unit (ex2.approx.ftz: relative error below
// 2^-22; results below 2^-126 flush to 0, 2^-inf is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- groups of 16-byte lanes (K1-K5) ---------------------------------------

constexpr int kDstThreads = 256;  // a block: 256 / GS groups of GS lanes

// The launch shape of a group kernel (a group walks one destination, in K4
// and K5 one source) for HD, head size d and the type's element size: V
// channels a lane (16 bytes, or 4 or 1 when the head is smaller), GS lanes a group
// (HD / V rounded up to a power of two at most 32, or to a multiple of 32,
// so a group is a slice of one warp or whole warps), the head butterfly's
// width `seg` (the largest power of two dividing d / V, at most 32; a head
// wider than that exchanges partial sums through the group's shared memory)
// and the block's threads.
// Each kernel sizes its own shared memory.
struct DstLayout {
  int v, gs, seg, threads;
};

inline DstLayout dst_layout(int elt, int hd, int d) {
  DstLayout l;
  const int vmax = 16 / elt;
  l.v = d >= vmax ? vmax : (d >= 4 ? 4 : 1);
  const int lanes = hd / l.v;
  if (lanes <= 32) {
    l.gs = 1;
    while (l.gs < lanes) l.gs *= 2;
  } else {
    l.gs = (lanes + 31) / 32 * 32;
  }
  l.threads = l.gs <= kDstThreads ? l.gs * (kDstThreads / l.gs) : l.gs;
  const int lh = d / l.v;
  l.seg = lh & -lh;
  if (l.seg > 32) l.seg = 32;
  return l;
}

// The lanes of one group of a block and the group's collectives.  Lane
// lane_g owns channels [c0, c0 + V); lanes past HD / V (`active` false)
// take part in the shuffles and barriers and are masked out of loads and
// stores.  With kLiteralMask, a group of whole warps names the full shuffle
// mask as a constant, which spares the convergence checks a mask held in a
// register costs on every shuffle, and the head butterfly is unrolled.
// `scratch` is the group's share of the block's exchange buffers: two of
// N * gs floats, used in turn, for heads wider than `seg` (N: the sums
// exchanged at once, 1 or 2).
template <bool kLiteralMask>
struct Group {
  int gs, seg, lh;  // lanes of the group, the head butterfly's width, lanes of a head
  int id, lane_g;   // the group in its block, the lane in the group
  int base;         // warp lane of the group's first lane
  unsigned mask;    // the group's lanes of their warp
  int chunk, cl;    // edge indices read at once (one a lane), this lane's entry of them
  bool active;
  int c0;
  float* scratch;
  int parity;

  __device__ __forceinline__ Group(int v, int gs_, int seg_, int hd, int d, float* scratch_all,
                                   int n) {
    gs = gs_;
    seg = seg_;
    lh = d / v;
    id = threadIdx.x / gs;
    lane_g = threadIdx.x - id * gs;
    const int lane = threadIdx.x & 31;
    base = gs < 32 ? (lane & ~(gs - 1)) : 0;
    mask = gs < 32 ? ((1u << gs) - 1u) << base : 0xffffffffu;
    chunk = gs < 32 ? gs : 32;
    cl = lane - base;
    active = lane_g * v < hd;
    c0 = active ? lane_g * v : 0;
    scratch = scratch_all + 2 * n * gs * id;
    parity = 0;
  }
  __device__ __forceinline__ int shfl(int x, int from) const {
    if (kLiteralMask && gs >= 32) return __shfl_sync(0xffffffffu, x, from);
    return __shfl_sync(mask, x, from);
  }
  __device__ __forceinline__ float shfl(float x, int from) const {
    if (kLiteralMask && gs >= 32) return __shfl_sync(0xffffffffu, x, from);
    return __shfl_sync(mask, x, from);
  }
  __device__ __forceinline__ float shfl_xor(float x, int off) const {
    if (kLiteralMask && gs >= 32) return __shfl_xor_sync(0xffffffffu, x, off);
    return __shfl_xor_sync(mask, x, off);
  }
  // a barrier of the group's lanes: its warp's, or its own warps' (named
  // barrier 1 + id; barrier 0 is __syncthreads)
  __device__ __forceinline__ void sync() const {
    if (gs <= 32)
      __syncwarp(mask);
    else
      asm volatile("bar.sync %0, %1;" ::"r"(id + 1), "r"(gs) : "memory");
  }
  // x[0..N) each summed over the lh lanes of the calling lane's head: an
  // unrolled butterfly over `seg` lanes, then, for a head wider than that,
  // the segments' partials through `scratch` behind one barrier
  template <int N>
  __device__ __forceinline__ void head_sums(float (&x)[N]) {
    if constexpr (kLiteralMask) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        if (off < seg) {
#pragma unroll
          for (int n = 0; n < N; ++n) x[n] += shfl_xor(x[n], off);
        }
      }
    } else {
      for (int off = seg >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int n = 0; n < N; ++n) x[n] += shfl_xor(x[n], off);
      }
    }
    if (seg < lh) {
      float* buf = scratch + parity * N * gs;
      parity ^= 1;
      if ((lane_g & (seg - 1)) == 0) {
#pragma unroll
        for (int n = 0; n < N; ++n) buf[lane_g / seg * N + n] = x[n];
      }
      sync();
      const int per = lh / seg;
      const float* p = buf + (lane_g / lh) * per * N;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float s = 0.f;
        for (int t = 0; t < per; ++t) s += p[t * N + n];
        x[n] = s;
      }
    }
  }
};

// V consecutive elements of T as one aligned access of V * sizeof(T) bytes
// (16 at V = 16 / sizeof(T)), held as raw 32-bit words until first use, so
// that a load issued an edge ahead stalls nothing before its values are read.
template <typename T, int V>
struct Vec {
  static constexpr int kBytes = V * static_cast<int>(sizeof(T));
  static constexpr int kWords = (kBytes + 3) / 4;
  unsigned w[kWords];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int x = 0; x < kWords; ++x) w[x] = 0u;
  }
  // from device memory, through the read-only cache
  __device__ __forceinline__ void load(const T* p) { read<true>(p); }
  // from shared memory
  __device__ __forceinline__ void load_shared(const T* p) { read<false>(p); }
  template <bool kGlobal, typename P>
  __device__ static __forceinline__ P rd(const P* q) {
    if constexpr (kGlobal)
      return __ldg(q);
    else
      return *q;
  }
  template <bool kGlobal>
  __device__ __forceinline__ void read(const T* p) {
    if constexpr (kBytes == 16) {
      const uint4 r = rd<kGlobal>(reinterpret_cast<const uint4*>(p));
      w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
    } else if constexpr (kBytes == 8) {
      const uint2 r = rd<kGlobal>(reinterpret_cast<const uint2*>(p));
      w[0] = r.x, w[1] = r.y;
    } else if constexpr (kBytes == 4) {
      w[0] = rd<kGlobal>(reinterpret_cast<const unsigned*>(p));
    } else {
      w[0] = rd<kGlobal>(reinterpret_cast<const unsigned short*>(p));
    }
  }
  // element x as float32 (bf16: the low half of a word is the lower element)
  __device__ __forceinline__ float get(int x) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[x]);
    } else {
      const unsigned u = w[x >> 1];
      return __uint_as_float((x & 1) ? (u & 0xffff0000u) : (u << 16));
    }
  }
};

// V consecutive elements of T from device to shared memory, asynchronously
// (cp.async; 16, 8 or 4 bytes, both addresses aligned to that).  Two bytes
// (bf16 at V = 1) are below cp.async's smallest size and are copied in
// place.  The copying thread sees the data after cp_async_wait.
template <typename T, int V>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if constexpr (kBytes >= 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes)
                 : "memory");
  else
    *dst = *src;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V float32 values from p (shared or global), as float4 where V allows.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int c = 0; c < V; c += 4) {
      const float4 r = *reinterpret_cast<const float4*>(p + c);
      x[c] = r.x, x[c + 1] = r.y, x[c + 2] = r.z, x[c + 3] = r.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) x[c] = p[c];
  }
}

// x[0..V) rounded once to T and stored as one aligned access.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[V]) {
  Vec<T, V> o;
  o.zero();
#pragma unroll
  for (int c = 0; c < V; ++c) {
    if constexpr (sizeof(T) == 4) {
      o.w[c] = __float_as_uint(x[c]);
    } else {
      const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(x[c]));
      o.w[c >> 1] |= (c & 1) ? (h << 16) : h;
    }
  }
  if constexpr (Vec<T, V>::kBytes == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(o.w[0], o.w[1], o.w[2], o.w[3]);
  else if constexpr (Vec<T, V>::kBytes == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(o.w[0], o.w[1]);
  else if constexpr (Vec<T, V>::kBytes == 4)
    *reinterpret_cast<unsigned*>(p) = o.w[0];
  else
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(o.w[0]);
}

// ---- host side of the group kernels ----------------------------------------

// The instantiation of a group kernel that a launch takes: V = 16 bytes, 4
// or 1 (the layout's); FMAX = 1 without the fused projection, else 4 or 8
// (kernels/gt_attention.py:dst_instantiation names the same).
// `Of<T, V, FUSE_EDGE, FMAX>::get()` returns the kernel's instantiation.
template <template <typename, int, bool, int> class Of, typename T, int V>
auto group_kernel_v(bool fuse_edge, int f) {
  if (!fuse_edge) return Of<T, V, false, 1>::get();
  return f <= 4 ? Of<T, V, true, 4>::get() : Of<T, V, true, kMaxEdgeFeatures>::get();
}

template <template <typename, int, bool, int> class Of, typename T>
auto group_kernel(const DstLayout& l, bool fuse_edge, int f) {
  constexpr int kVmax = 16 / static_cast<int>(sizeof(T));
  if (l.v == kVmax) return group_kernel_v<Of, T, kVmax>(fuse_edge, f);
  if (l.v == 4) return group_kernel_v<Of, T, 4>(fuse_edge, f);
  return group_kernel_v<Of, T, 1>(fuse_edge, f);
}

// Allows a launch of `kernel` more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Blocks of `kernel` that fit on an SM at once with `threads` and `smem`.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  int n = 0;
  if (prepare_smem(kernel, smem) == cudaSuccess)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return n;
}

}  // namespace gt
