// Banded sliding-window flash attention, backward (kernel K7: two kernels).
//
// Replaces the TPU kernels of anemoi_tpu/ops/pallas/window_attention.py:
//   _flash_bwd_dq_kernel  -> K7_dq,  one block per query tile
//   _flash_bwd_dkv_kernel -> K7_dkv, one block per key tile
// (via _flash_window_backward).  With the forward's lse, g = dL/d out and
// delta_i = sum_c g_ic out_ic (float32 [B, H, N], formed by the caller), for
// each pair (i, j) of the band:
//
//     p_ij  = exp(s_ij - lse_i)                 (s_ij the forward's logit)
//     dp_ij = g_i . v_j
//     ds_ij = p_ij (dp_ij - delta_i) [* (1 - tanh^2(x_ij / cap))]   x_ij = q_i . k_j / sqrt(D)
//     dq_i += ds_ij k_j / sqrt(D)     dk_j += ds_ij q_i / sqrt(D)     dv_j += p_ij g_i
//
// Softcap is differentiated here (the factor 1 - tanh^2); the JAX package
// differentiates its XLA reference for that case instead.  ALiBi slopes are
// constants and get no gradient.
//
// What bounds them on the H100: bf16 operations.  dq costs 6D flops per pair
// (q.k, g.v, ds.k), dk/dv 8D (q.k, g.v, p.g, ds.q): 62.9 and 83.8 GFLOP at the
// Transformer preset (n = 10 242, w = 512, 16 heads of 64) against ~100 MB
// each, 600-800 flop per byte, above the card's ~295 flop/byte bf16 ridge.
//
// Which instantiation each type takes (the choice depends on the type only):
//   bfloat16 (D 16, 32, 64, 128): window_attention_bwd_{dq,dkv}_mma_kernel<D>,
//     the products on the tensor cores (mma.sync.m16n8k16, bf16 in, float32
//     accumulate; window_mma.cuh);
//   float32: window_attention_bwd_{dq,dkv}_kernel<float, D>, float32 FMAs on
//     CUDA cores (TF32 tensor cores keep ~10 bits, too few for the float32
//     gate of 1e-4).
//
// Rounding of the bf16 kernels: S, dP, the logit, P, dS and every
// accumulator are float32; P and dS are rounded to bf16 once each, as the A
// operand of their products (dV += P^T dO, dK += dS^T Q, dQ += dS K); dq, dk,
// dv are rounded once on their stores.  The JAX kernels round dS to the
// input type the same way (ds.astype(k.dtype)) but keep P in float32 for dV
// (p.astype(do.dtype) with dO widened to float32): P for dV is the one
// rounding that differs.  P is exp(x - lse) by the SFU (__expf: relative
// error ~1e-6 over the band's arguments, against bf16's 2^-9); the float32
// kernels keep expf.
//
// Design, both types.  Both kernels recompute P from lse, tile by tile.  The
// dq kernel owns a 64-query tile and walks the key tiles of its band; the
// dk/dv kernel owns a 64-key tile and walks the query tiles of its band from
// the other side (the band is symmetric).  Each block alone writes its rows:
// no atomics, deterministic.  Rows at or past n are never stored; pairs out
// of the band or with a key at or past n get P = 0 exactly, hence dS = 0.
//
// The float32 kernels use K6's thread layout (window_common.cuh): 256
// threads, float32 tiles in shared memory, a 4 x 4 patch of the logits per
// thread.  The bf16 kernels use 4 warps, each owning 16 rows of the block's
// tile (FlashAttention-2's layout): the tile it owns is staged once, the
// tiles it walks pass through a two-stage cp.async ring in shared memory
// (bf16, swizzled, zero-filled past n), so tile t + 1's copy overlaps tile
// t's products.  Per walked tile a warp computes its 16 x 64 slab of S and
// dP on the tensor cores (B operands by ldmatrix), forms P and dS in
// registers, packs them to bf16 A fragments and multiplies them into its
// 16 x D accumulators (B operands by ldmatrix.trans); K7_dkv takes the slab
// in two passes of 32 columns to keep its registers at 168 (3 blocks an SM).

#include <type_traits>

#include "window_common.cuh"
#include "window_mma.cuh"

namespace {

using band::Args;
using band::kLdP;
using band::kThreads;
using band::kTile;
using tc::bf16;

template <int D>
constexpr size_t dq_smem() {
  return (4 * kTile * (D + 1) + kTile * kLdP) * sizeof(float);
}

template <int D>
constexpr size_t dkv_smem() {
  return (4 * kTile * (D + 1) + 2 * kTile * kLdP + 2 * kTile) * sizeof(float);
}

// Raw products of a thread's 4 x 4 patch: s = A_r . B_c and dp = C_r . E_c,
// rows r = ty*4 + i of the [64][D+1] tiles A and C, columns c = tx + 16j of
// B and E.
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* B, const float* C,
                                             const float* E, int ty, int tx, float (&s)[4][4],
                                             float (&dp)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; ++dd) {
    float a[4], c[4], bb[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty * 4 + i) * LD + dd];
      c[i] = C[(ty * 4 + i) * LD + dd];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bb[j] = B[(tx + 16 * j) * LD + dd];
      e[j] = E[(tx + 16 * j) * LD + dd];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a[i] * bb[j];
        dp[i][j] += c[i] * e[j];
      }
  }
}

// dq for one 64-query tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    window_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const T* __restrict__ g,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta, T* __restrict__ dq, Args a) {
  constexpr int LD = D + 1, ND = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sg = sq + kTile * LD;
  float* sk = sg + kTile * LD;
  float* sv = sk + kTile * LD;
  float* sds = sv + kTile * LD;  // [64][65]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  const size_t stat = (static_cast<size_t>(b) * a.heads + h) * a.n;

  band::load_tile<T, D>(sq, band::row0<T, D>(q, b, h, a), q0, a);
  band::load_tile<T, D>(sg, band::row0<T, D>(g, b, h, a), q0, a);
  const T* kb = band::row0<T, D>(k, b, h, a);
  const T* vb = band::row0<T, D>(v, b, h, a);
  float row_lse[4], row_delta[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    row_lse[i] = qpos < a.n ? lse[stat + qpos] : 0.f;
    row_delta[i] = qpos < a.n ? delta[stat + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = 0.f;
  }

  int first, last;
  band::band_tiles(q0, a, first, last);
  for (int k0 = first; k0 < last; k0 += kTile) {
    __syncthreads();
    band::load_tile<T, D>(sk, kb, k0, a);
    band::load_tile<T, D>(sv, vb, k0, a);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<D>(sq, sk, sg, sv, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float t;
        const float x = band::logit(s[i][j], qpos, kpos, slope, a, t);
        const float p = band::in_band(qpos, kpos, a) ? expf(x - row_lse[i]) : 0.f;
        sds[r * kLdP + tx + 16 * j] = p * (dp[i][j] - row_delta[i]) * (1.f - t * t);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float kv[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c) kv[c] = sk[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sds[(ty * 4 + i) * kLdP + kk];
#pragma unroll
        for (int c = 0; c < ND; ++c) acc[i][c] += ds * kv[c];
      }
    }
  }

  const size_t stride = static_cast<size_t>(a.heads) * D;
  T* out = dq + (static_cast<size_t>(b) * a.n * a.heads + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= a.n) continue;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      out[qpos * stride + tx + 16 * c] = band::from_float<T>(acc[i][c] * a.scale);
  }
}

// dk and dv for one 64-key tile.  Thread rows are keys, columns queries.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    window_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, const T* __restrict__ g,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta, T* __restrict__ dk,
                                    T* __restrict__ dv, Args a) {
  constexpr int LD = D + 1, ND = D / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kTile * LD;
  float* sq = sv + kTile * LD;
  float* sg = sq + kTile * LD;
  float* sp = sg + kTile * LD;   // [64 keys][65] probabilities
  float* sds = sp + kTile * kLdP;  // [64 keys][65] logit gradients
  float* slse = sds + kTile * kLdP;  // [64] of the query tile
  float* sdelta = slse + kTile;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  const size_t stat = (static_cast<size_t>(b) * a.heads + h) * a.n;

  band::load_tile<T, D>(sk, band::row0<T, D>(k, b, h, a), k0, a);
  band::load_tile<T, D>(sv, band::row0<T, D>(v, b, h, a), k0, a);
  const T* qb = band::row0<T, D>(q, b, h, a);
  const T* gb = band::row0<T, D>(g, b, h, a);
  float acc_k[4][ND], acc_v[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < ND; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  int first, last;
  band::band_tiles(k0, a, first, last);
  for (int q0 = first; q0 < last; q0 += kTile) {
    __syncthreads();
    band::load_tile<T, D>(sq, qb, q0, a);
    band::load_tile<T, D>(sg, gb, q0, a);
    if (threadIdx.x < kTile) {
      const int qpos = q0 + threadIdx.x;
      slse[threadIdx.x] = qpos < a.n ? lse[stat + qpos] : 0.f;
      sdelta[threadIdx.x] = qpos < a.n ? delta[stat + qpos] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<D>(sk, sq, sv, sg, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, kpos = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cq = tx + 16 * j, qpos = q0 + cq;
        float t;
        const float x = band::logit(s[i][j], qpos, kpos, slope, a, t);
        const float p = band::in_band(qpos, kpos, a) ? expf(x - slse[cq]) : 0.f;
        sp[r * kLdP + cq] = p;
        sds[r * kLdP + cq] = p * (dp[i][j] - sdelta[cq]) * (1.f - t * t);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float gv[ND], qv[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        gv[c] = sg[qq * LD + tx + 16 * c];
        qv[c] = sq[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp[(ty * 4 + i) * kLdP + qq];
        const float ds = sds[(ty * 4 + i) * kLdP + qq];
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          acc_v[i][c] += p * gv[c];
          acc_k[i][c] += ds * qv[c];
        }
      }
    }
  }

  const size_t stride = static_cast<size_t>(a.heads) * D;
  const size_t base = (static_cast<size_t>(b) * a.n * a.heads + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= a.n) continue;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const size_t o = base + kpos * stride + tx + 16 * c;
      dk[o] = band::from_float<T>(acc_k[i][c] * a.scale);
      dv[o] = band::from_float<T>(acc_v[i][c]);
    }
  }
}

// ---- bf16 on the tensor cores ----

constexpr int kMmaWarps = 4;  // each owns 16 rows of the block's 64-row tile
constexpr int kMmaThreads = 32 * kMmaWarps;

template <int D>
__host__ __device__ constexpr size_t mma_tile_elems() {
  return static_cast<size_t>(kTile) * D;
}
// Both: the owned pair of tiles, then a two-stage ring of the walked pair.
template <int D>
constexpr size_t dq_mma_smem() {
  return 6 * mma_tile_elems<D>() * sizeof(bf16);
}
// dk/dv: also lse and delta of the walked query tile, per stage.
template <int D>
constexpr size_t dkv_mma_smem() {
  return 6 * mma_tile_elems<D>() * sizeof(bf16) + 2 * 2 * kTile * sizeof(float);
}

// A warp takes each walked tile in passes of COLS of its 64 columns (a
// multiple of 16): one pass is a 16 x COLS slab of S and dP, held in
// COLS / 8 n-tiles of the accumulator layout.  Fewer columns a pass means
// fewer live registers beside the output accumulators.

// The warp's 16 x COLS slabs s = X U^T and dp = Y W^T: rows m0 .. m0 + 15 of
// the tiles X, Y against rows c0 .. c0 + COLS - 1 of U, W (all swizzled
// [64][D]).
template <int D, int COLS>
__device__ __forceinline__ void two_products_mma(const bf16* X, const bf16* U, const bf16* Y,
                                                 const bf16* W, int m0, int c0, int lane,
                                                 float (&s)[COLS / 8][4],
                                                 float (&dp)[COLS / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < COLS / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t xa[4], ya[4];
    tc::ldsm_x4(xa, tc::a_frag<D>(X, m0, kc, lane));
    tc::ldsm_x4(ya, tc::a_frag<D>(Y, m0, kc, lane));
#pragma unroll
    for (int nc = 0; nc < COLS / 16; ++nc) {
      uint32_t ub[4], wb[4];
      tc::ldsm_x4(ub, tc::b_frag<D>(U, c0 + 16 * nc, kc, lane));
      tc::ldsm_x4(wb, tc::b_frag<D>(W, c0 + 16 * nc, kc, lane));
      tc::mma_bf16(s[2 * nc], xa, ub[0], ub[1]);
      tc::mma_bf16(s[2 * nc + 1], xa, ub[2], ub[3]);
      tc::mma_bf16(dp[2 * nc], ya, wb[0], wb[1]);
      tc::mma_bf16(dp[2 * nc + 1], ya, wb[2], wb[3]);
    }
  }
}

// acc (16 x D) += xa (16 x COLS, packed by tc::pack_slab) times rows c0 ..
// c0 + COLS - 1 of the swizzled [64][D] tile T.
template <int D, int COLS>
__device__ __forceinline__ void product_into(float (&acc)[D / 8][4],
                                             const uint32_t (&xa)[COLS / 16][4], const bf16* T,
                                             int c0, int lane) {
#pragma unroll
  for (int kc = 0; kc < COLS / 16; ++kc)
#pragma unroll
    for (int nc = 0; nc < D / 16; ++nc) {
      uint32_t tb[4];
      tc::ldsm_x4_trans(tb, tc::bt_frag<D>(T, c0 / 16 + kc, nc, lane));
      tc::mma_bf16(acc[2 * nc], xa[kc], tb[0], tb[1]);
      tc::mma_bf16(acc[2 * nc + 1], xa[kc], tb[2], tb[3]);
    }
}

// Occupancy: up to D = 64 both kernels keep to 168 registers a thread, so
// three blocks (12 warps) share an SM; ptxas would otherwise take ~210-240
// and fit two, which measured slower on the H100.  To stay in 168 without
// spills, dq keeps a whole 64-column slab a pass and dk/dv, which holds two
// output accumulators, half of it, one pass at a time.  D = 128 needs more:
// one block an SM is all that is asked.
__host__ __device__ constexpr int mma_blocks_per_sm(int d) { return d <= 64 ? 3 : 1; }
constexpr int kDqCols = 64;
constexpr int kDkvCols = 32;

// dq for one 64-query tile, bf16, on the tensor cores.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, mma_blocks_per_sm(D))
    window_attention_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta, bf16* __restrict__ dq,
                                       Args a) {
  constexpr size_t kT = mma_tile_elems<D>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sg = sq + kT;
  bf16* sk = sg + kT;      // [2 stages][64][D]
  bf16* sv = sk + 2 * kT;  // [2 stages][64][D]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  const size_t stat = (static_cast<size_t>(b) * a.heads + h) * a.n;
  const int stride = a.heads * D;  // n * H * D < 2^31 (the wrapper checks)
  const bf16* kb = band::row0<bf16, D>(k, b, h, a);
  const bf16* vb = band::row0<bf16, D>(v, b, h, a);
  int first, last;
  band::band_tiles(q0, a, first, last);

  tc::stage_rows<D, kTile, kMmaThreads>(sq, band::row0<bf16, D>(q, b, h, a), q0, a.n, stride);
  tc::stage_rows<D, kTile, kMmaThreads>(sg, band::row0<bf16, D>(g, b, h, a), q0, a.n, stride);
  tc::cp_async_commit();
  tc::stage_rows<D, kTile, kMmaThreads>(sk, kb, first, a.n, stride);
  tc::stage_rows<D, kTile, kMmaThreads>(sv, vb, first, a.n, stride);
  tc::cp_async_commit();

  float row_lse[2], row_delta[2], acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + m0 + tc::slab_row(lane, 2 * i);
    row_lse[i] = qpos < a.n ? lse[stat + qpos] : 0.f;
    row_delta[i] = qpos < a.n ? delta[stat + qpos] : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  int stage = 0;
  for (int k0 = first; k0 < last; k0 += kTile, stage ^= 1) {
    if (k0 + kTile < last) {  // the next key tile into the other stage
      tc::stage_rows<D, kTile, kMmaThreads>(sk + (stage ^ 1) * kT, kb, k0 + kTile, a.n, stride);
      tc::stage_rows<D, kTile, kMmaThreads>(sv + (stage ^ 1) * kT, vb, k0 + kTile, a.n, stride);
    }
    tc::cp_async_commit();  // empty on the last tile: the count stays uniform
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* tk = sk + stage * kT;
    const bf16* tv = sv + stage * kT;
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += kDqCols) {
      float s[kDqCols / 8][4], dp[kDqCols / 8][4];
      two_products_mma<D, kDqCols>(sq, tk, sg, tv, m0, c0, lane, s, dp);
#pragma unroll
      for (int nt = 0; nt < kDqCols / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + m0 + tc::slab_row(lane, e);
          const int kpos = k0 + c0 + tc::slab_col(lane, nt, e);
          float t;
          const float x = band::logit(s[nt][e], qpos, kpos, slope, a, t);
          const float p = band::in_band(qpos, kpos, a) ? __expf(x - row_lse[e >> 1]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - row_delta[e >> 1]) * (1.f - t * t);  // dS
        }
      uint32_t ds[kDqCols / 16][4];
      tc::pack_slab<kDqCols>(ds, s);
      product_into<D, kDqCols>(acc, ds, tk, c0, lane);
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

  bf16* out = dq + (static_cast<size_t>(b) * a.n * a.heads + h) * D;
  tc::store_rows<D>(out, acc, a.scale, q0, m0, lane, a.n, stride);
}

// dk and dv for one 64-key tile, bf16, on the tensor cores.  Slab rows are
// keys, columns queries: the warp computes S^T and dP^T.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, mma_blocks_per_sm(D))
    window_attention_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, bf16* __restrict__ dk,
                                        bf16* __restrict__ dv, Args a) {
  constexpr size_t kT = mma_tile_elems<D>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + kT;
  bf16* sq = sv + kT;      // [2 stages][64][D]
  bf16* sg = sq + 2 * kT;  // [2 stages][64][D]
  float* slse = reinterpret_cast<float*>(sg + 2 * kT);  // [2 stages][64]
  float* sdelta = slse + 2 * kTile;                      // [2 stages][64]
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  const size_t stat = (static_cast<size_t>(b) * a.heads + h) * a.n;
  const int stride = a.heads * D;  // n * H * D < 2^31 (the wrapper checks)
  const bf16* qb = band::row0<bf16, D>(q, b, h, a);
  const bf16* gb = band::row0<bf16, D>(g, b, h, a);
  int first, last;
  band::band_tiles(k0, a, first, last);

  // one stage of the walked query tile: Q, dO, and entry c of lse (threads
  // 0-63) or delta (64-127)
  const int c_stat = threadIdx.x & (kTile - 1);
  const float* stat_src = (threadIdx.x < kTile ? lse : delta) + stat;
  float* stat_dst = (threadIdx.x < kTile ? slse : sdelta) + c_stat;
  auto stage_queries = [&](int st, int q0) {
    tc::stage_rows<D, kTile, kMmaThreads>(sq + st * kT, qb, q0, a.n, stride);
    tc::stage_rows<D, kTile, kMmaThreads>(sg + st * kT, gb, q0, a.n, stride);
    const int qpos = q0 + c_stat;
    tc::cp_async4(stat_dst + st * kTile, stat_src + min(qpos, a.n - 1), qpos < a.n);
  };
  tc::stage_rows<D, kTile, kMmaThreads>(sk, band::row0<bf16, D>(k, b, h, a), k0, a.n, stride);
  tc::stage_rows<D, kTile, kMmaThreads>(sv, band::row0<bf16, D>(v, b, h, a), k0, a.n, stride);
  tc::cp_async_commit();
  stage_queries(0, first);
  tc::cp_async_commit();

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nt][e] = acc_v[nt][e] = 0.f;

  int stage = 0;
  for (int q0 = first; q0 < last; q0 += kTile, stage ^= 1) {
    if (q0 + kTile < last) stage_queries(stage ^ 1, q0 + kTile);
    tc::cp_async_commit();  // empty on the last tile: the count stays uniform
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* tq = sq + stage * kT;
    const bf16* tg = sg + stage * kT;
    const float* tl = slse + stage * kTile;
    const float* td = sdelta + stage * kTile;
#pragma unroll 1  // one pass at a time: unrolled, ptxas overlaps them and spills
    for (int c0 = 0; c0 < kTile; c0 += kDkvCols) {
      float s[kDkvCols / 8][4], dp[kDkvCols / 8][4];
      two_products_mma<D, kDkvCols>(sk, tq, sv, tg, m0, c0, lane, s, dp);
#pragma unroll
      for (int nt = 0; nt < kDkvCols / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + tc::slab_col(lane, nt, e), qpos = q0 + c;
          const int kpos = k0 + m0 + tc::slab_row(lane, e);
          float t;
          const float x = band::logit(s[nt][e], qpos, kpos, slope, a, t);
          const float p = band::in_band(qpos, kpos, a) ? __expf(x - tl[c]) : 0.f;
          s[nt][e] = p;                                          // P^T
          dp[nt][e] = p * (dp[nt][e] - td[c]) * (1.f - t * t);  // dS^T
        }
      uint32_t pa[kDkvCols / 16][4], dsa[kDkvCols / 16][4];
      tc::pack_slab<kDkvCols>(pa, s);
      tc::pack_slab<kDkvCols>(dsa, dp);
      product_into<D, kDkvCols>(acc_v, pa, tg, c0, lane);
      product_into<D, kDkvCols>(acc_k, dsa, tq, c0, lane);
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

  const size_t base = (static_cast<size_t>(b) * a.n * a.heads + h) * D;
  tc::store_rows<D>(dk + base, acc_k, a.scale, k0, m0, lane, a.n, stride);
  tc::store_rows<D>(dv + base, acc_v, 1.f, k0, m0, lane, a.n, stride);
}

struct Ptrs {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *dq, *dk, *dv;
};

// Raise the kernel's shared-memory limit (once) and launch it; returns the
// launch's cudaError_t.
template <typename... Params, typename... Values>
int start(void (*kernel)(Params...), size_t smem, bool& smem_set, dim3 grid, int threads,
          cudaStream_t stream, Values... values) {
  const cudaError_t err = band::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(values...);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 takes the tensor-core kernels, float32 the CUDA-core ones.
template <typename T, int D>
int launch(bool dkv, const Ptrs& p, int batch, const Args& a, cudaStream_t stream) {
  const dim3 grid((a.n + kTile - 1) / kTile, a.heads, batch);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* g = static_cast<const T*>(p.g);
  T* dq = static_cast<T*>(p.dq);
  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
  static bool smem_set[2] = {false, false};
  if constexpr (std::is_same<T, bf16>::value) {
    if (dkv)
      return start(window_attention_bwd_dkv_mma_kernel<D>, dkv_mma_smem<D>(), smem_set[1], grid,
                   kMmaThreads, stream, q, k, v, g, p.lse, p.delta, dk, dv, a);
    return start(window_attention_bwd_dq_mma_kernel<D>, dq_mma_smem<D>(), smem_set[0], grid,
                 kMmaThreads, stream, q, k, v, g, p.lse, p.delta, dq, a);
  } else {
    if (dkv)
      return start(window_attention_bwd_dkv_kernel<T, D>, dkv_smem<D>(), smem_set[1], grid,
                   kThreads, stream, q, k, v, g, p.lse, p.delta, dk, dv, a);
    return start(window_attention_bwd_dq_kernel<T, D>, dq_smem<D>(), smem_set[0], grid,
                 kThreads, stream, q, k, v, g, p.lse, p.delta, dq, a);
  }
}

template <typename T>
int dispatch(int d, bool dkv, const Ptrs& p, int batch, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(dkv, p, batch, a, stream);
    case 32: return launch<T, 32>(dkv, p, batch, a, stream);
    case 64: return launch<T, 64>(dkv, p, batch, a, stream);
    case 128: return launch<T, 128>(dkv, p, batch, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(int dtype, bool dkv, const Ptrs& p, const void* slopes, int batch, int n, int heads, int d,
        int w, float scale, float softcap, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const Args a{n, heads, w, scale, softcap, static_cast<const float*>(slopes)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(d, dkv, p, batch, a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(d, dkv, p, batch, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16;
// d: 16, 32, 64 or 128; softcap 0 = none; slopes: float32 [H] or null; lse and
// delta float32 [B, H, N].  Shapes and types are validated by the Python
// wrappers.  Each returns the cudaError_t of its launch (0 on success).
extern "C" int window_attention_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                       const void* g, const void* lse, const void* delta,
                                       void* dq, const void* slopes, int batch, int n, int heads,
                                       int d, int w, float scale, float softcap, void* stream) {
  const Ptrs p{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, nullptr};
  return run(dtype, false, p, slopes, batch, n, heads, d, w, scale, softcap, stream);
}

extern "C" int window_attention_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                        const void* g, const void* lse, const void* delta,
                                        void* dk, void* dv, const void* slopes, int batch, int n,
                                        int heads, int d, int w, float scale, float softcap,
                                        void* stream) {
  const Ptrs p{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
               nullptr, dk, dv};
  return run(dtype, true, p, slopes, batch, n, heads, d, w, scale, softcap, stream);
}
