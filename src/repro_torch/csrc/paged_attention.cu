// Multi-query paged attention over the paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// ::_mq_paged_kernel (pallas_call at paged_attention.py:250), both faces:
//   decode          (has_own=False): one query token per lane over the
//                   pooled cache, slots < cache_lens[b];
//   chunked prefill (has_own=True):  C query tokens over the pooled prefix
//                   (slots < prefix_lens[b]) plus the chunk's own exact
//                   K/V with a causal mask, num_valid padding and an
//                   optional sliding window.
// The pool is f32, bf16, int8 or fp8 (e4m3). A quantized pool (the JAX
// kernel's has_scales variant) comes with f32 scales [NB, page, KVH], one
// per slot and kv head. They are folded in per slot, not per element:
// s_j = k_scale_j * (q . code_j) * scale, and p'_j = p_j * v_scale_j
// before p' . code (l sums the unscaled p). That is the dense path's
// dequantize-then-attend up to f32 rounding order. The chunk's own K/V is
// exact and never scaled.
//
// What bounds it on the H100: bytes. Per (lane, kv head) the kernel reads
// its live K and V pages once and does 4*hd flops per (query row, key);
// with the G = 4 query heads of a kv head at decode that is about 4 flops
// per bf16 pool byte (8 per int8/fp8 byte, plus 4 scale bytes per slot),
// far below the ~295 flops per byte at which the tensor cores would be
// the limit. So the design keeps everything but the page reads on chip
// and puts as many page bytes in flight as it can.
//
// Decode (K1a, K1c decode), the layout of vLLM's PagedAttention:
//   grid (B*KVH, splits, ceil(G / NG)), 4 warps. The G query rows of the
//   kv head (NG of them per CTA) stay in registers as f32. The warps of a
//   CTA take interleaved pages of the lane; a warp reads a slot row with
//   16-byte loads (a 256-byte bf16 row is half a warp, a 128-byte int8/fp8
//   row a quarter). A row takes a power-of-two group of lanes, so that
//   the shuffle reductions stay inside it: where hd / (values per load) is
//   no power of two (hd 80: 10 bf16 loads) the group is padded (16 lanes)
//   and its last lanes load nothing and hold zeros. It reads rounds of a
//   16-slot page of K and V (at most 8 loads
//   of each per lane), issues the next round's loads (and reads the next
//   page's block id) before it computes the current one, computes the
//   per-slot scores with a shuffle reduction over the lanes of the row and
//   keeps its own online-softmax state (m, l, acc) in registers. The warps
//   merge once, at the end, through shared memory. Split-K: when B*KVH
//   CTAs would not fill the card and the block table is wide, the host
//   (split_count in kernels/paged_attention.py, from bp and B*KVH only,
//   never from the device lengths) cuts each lane's page range into
//   `splits` parts; each CTA writes an unnormalised partial (acc, m, l),
//   a part past the lane's length writes (0, -inf, 0), and merge_kernel
//   combines them by log-sum-exp (an all-empty row stays zero).
//
// Prefill with bf16 queries over a bf16/int8/fp8 pool (K1b, K1c prefill):
//   the tensor-core tile of K3 (attention_tile.cuh). grid (B, KVH,
//   ceil(C*G / 64)), 4 warps of 16 rows of the kv head's [C*G, hd] query
//   tile (row r = chunk token r / G, query head kvh*G + r % G), read and
//   written in place in the [B, C, H, hd] layout. Key tiles
//   of 64 slots are gathered through the block table, slot by slot, so
//   any page size works; the chunk's own K/V is the last, causal, tile.
//   bf16 rows land with cp.async; so do int8/fp8 codes, which are exact
//   in bf16 and are converted in shared memory once they have landed. The Q tile and the first
//   block-table line are requested before the lengths are read, and two
//   key tiles are in flight at once (at the serve shape: the prefix's tile
//   and the chunk's own). P is rounded to bf16 before P.V.
//
// Prefill with f32 queries or an f32 pool: on the CUDA cores, f32
//   throughout (the tensor cores would round the f32 operands). grid (B,
//   KVH, ceil(C*G / 16)), 128 threads; per live page
//   the [page, hd] K and V tiles are staged in shared memory as f32 (times
//   their slot's scale for a quantized pool), one thread per (row, key)
//   computes a score, one thread per row runs the online softmax.
//
// Every face: rows with no visible key emit zeros (acc / (l == 0 ? 1 :
// l)), the JAX kernel's safe_l convention. Head dims: 32, 64, 80 and 128
// (the tensor-core tile takes any multiple of 16; the int8/fp8 rows of
// hd 80 are five 16-byte chunks, so their tile copies run in ragged
// rounds).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using fp8 = __nv_fp8_e4m3;
constexpr float NEG_INF = tile::NEG_INF;   // the JAX kernel's masked fill

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(fp8 x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// the 16 / sizeof(T) values of one 16-byte load, as f32
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& r, float* f) {
  const T* x = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) f[i] = to_f32(x[i]);
}
template <>
__device__ __forceinline__ void unpack16<fp8>(const uint4& r, float* f) {
  const __nv_fp8x2_storage_t* x =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) {   // one cvt per pair
    const float2 v = __half22float2(
        __half2(__nv_cvt_fp8x2_to_halfraw2(x[i], __NV_E4M3)));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
template <>
__device__ __forceinline__ void unpack16<bf16>(const uint4& r, float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

struct Args {
  const void* q;       // [B, C, KVH*G, hd] (decode: C = 1)
  const void* k_pool;  // [NB, page, KVH, hd], one layer's pool
  const void* v_pool;
  const int* bt;       // [B, bp]
  const int* lens;     // [B] pooled slots visible (prefix length)
  const int* nvalid;   // [B] real chunk tokens, or null (decode)
  const void* own_k;   // [B, C, KVH, hd], or null (decode)
  const void* own_v;
  const float* k_scale;  // [NB, page, KVH] for an int8/fp8 pool, or null
  const float* v_scale;
  void* out;           // like q
  float* part_o;       // [splits, B*KVH*CG, hd] decode partials, or null
  float* part_ml;      // [2, splits, B*KVH*CG] their m and l
  int KVH, CG, C, G, bp, page;
  float scale;
  int window;          // sliding window in tokens, -1 for none
  int splits;          // decode: parts of each lane's page range
};

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

constexpr int D_WARPS = 4;
constexpr int D_NT = 32 * D_WARPS;

// Lanes per slot row at decode: hd / (pool values per 16-byte load),
// rounded up to a power of two.
template <int HD, typename KT>
__host__ __device__ constexpr int row_lanes() {
  constexpr int n = HD / (16 / (int)sizeof(KT));
  static_assert(n * (16 / (int)sizeof(KT)) == HD && n <= 32, "row split");
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;
}

// One round of a lane's loads: U slot rows of K and of V (16 bytes each)
// and, for an int8/fp8 pool, their scales.
template <int U>
struct Chunk {
  uint4 k[U], v[U];
  float ks[U], vs[U];
  bool ok[U];
};

// Load slots s0 + u*RPL + sub (u < U) of the page at slot position pos0,
// held in pool block `block`; slots past the page or the length, and the
// columns of a padding lane (e0 >= HD), are zero.
template <int HD, int U, typename KT>
__device__ __forceinline__ void load_chunk(const Args& a, Chunk<U>& c,
                                           size_t block, int pos0, int s0,
                                           int len, int h, int sub, int e0) {
  constexpr int RPL = 32 / row_lanes<HD, KT>();
  const KT* kp = (const KT*)a.k_pool;
  const KT* vp = (const KT*)a.v_pool;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = s0 + u * RPL + sub;
    c.ok[u] = j < a.page && pos0 + j < len;
    const size_t slot = (block * a.page + j) * a.KVH + h;
    c.k[u] = c.v[u] = make_uint4(0, 0, 0, 0);
    c.ks[u] = c.vs[u] = 1.f;
    if (c.ok[u]) {
      if (e0 < HD) {
        c.k[u] = __ldg(reinterpret_cast<const uint4*>(kp + slot * HD + e0));
        c.v[u] = __ldg(reinterpret_cast<const uint4*>(vp + slot * HD + e0));
      }
      if (sizeof(KT) == 1) {   // every lane of the row scales its score
        c.ks[u] = __ldg(a.k_scale + slot);
        c.vs[u] = __ldg(a.v_scale + slot);
      }
    }
  }
}

template <int HD, int NG, typename QT, typename KT>
__global__ void __launch_bounds__(D_NT) decode_kernel(Args a) {
  constexpr int E = 16 / (int)sizeof(KT);   // pool values per 16-byte load
  constexpr int LPR = row_lanes<HD, KT>();  // lanes per slot row
  constexpr int RPL = 32 / LPR;             // slot rows per warp-wide load
  // slot rows per lane per round: a 16-slot page of K and V (at most 8
  // loads of each); the next round's loads fly while this one computes
  constexpr int U = 16 / RPL < 1 ? 1 : 16 / RPL > 8 ? 8 : 16 / RPL;
  constexpr int CH = RPL * U;               // slots per round
  __shared__ float s_o[D_WARPS][NG][HD];
  __shared__ float s_m[D_WARPS][NG], s_l[D_WARPS][NG];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPR;            // which slot row of a load
  const int e0 = (lane % LPR) * E;       // first hd column (>= HD: padding)
  const int bh = blockIdx.x, b = bh / a.KVH, h = bh % a.KVH;
  const int split = blockIdx.y, row0 = blockIdx.z * NG;
  const int pps = (a.bp + a.splits - 1) / a.splits;   // pages per split
  const int first = split * pps + warp;   // this warp's pages: first + i*W
  // block ids of the warp's first two pages, read before the length
  const int* bt = a.bt + (size_t)b * a.bp;
  int blk = first < a.bp ? bt[first] : 0;
  int blk_next = first + D_WARPS < a.bp ? bt[first + D_WARPS] : 0;
  const int len = a.lens[b];
  const int p_end = min(split * pps + pps, (len + a.page - 1) / a.page);
  const int n_pages = first < p_end ? (p_end - first + D_WARPS - 1) / D_WARPS
                                    : 0;
  const int cpp = (a.page + CH - 1) / CH;   // rounds per page
  const int n_it = n_pages * cpp;

  float q[NG][E];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const QT* qr = (const QT*)a.q + ((size_t)bh * a.CG + row0 + g) * HD + e0;
    const bool ok = row0 + g < a.CG && e0 < HD;
#pragma unroll
    for (int i = 0; i < E; ++i) q[g][i] = ok ? to_f32(qr[i]) : 0.f;
  }
  float m[NG], l[NG], acc[NG][E];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[g][i] = 0.f;
  }

  Chunk<U> cur, nxt;
  if (n_it > 0)
    load_chunk<HD, U, KT>(a, cur, blk, first * a.page, 0, len, h, sub, e0);
  for (int it = 0; it < n_it; ++it) {   // warp-uniform
    const int pi = it / cpp;
    if (it + 1 < n_it) {   // the next round's loads fly during this one
      const int pi1 = (it + 1) / cpp;
      load_chunk<HD, U, KT>(a, nxt, pi1 == pi ? blk : blk_next,
                            (first + pi1 * D_WARPS) * a.page,
                            ((it + 1) % cpp) * CH, len, h, sub, e0);
    }
    float s[U][NG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
      unpack16<KT>(cur.k[u], kf);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) d += q[g][i] * kf[i];
#pragma unroll
        for (int off = LPR / 2; off >= 1; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u][g] = cur.ok[u] ? cur.ks[u] * d * a.scale : NEG_INF;
      }
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[g] - mx);
      m[g] = mx;
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pu = cur.ok[u] ? expf(s[u][g] - mx) : 0.f;
        s[u][g] = pu;
        ps += pu;
      }
      // the LPR lanes of a slot row hold the same p: sum over the rows
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[g] = l[g] * alpha + ps;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
      unpack16<KT>(cur.v[u], vf);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float pw = s[u][g] * cur.vs[u];
#pragma unroll
        for (int i = 0; i < E; ++i) acc[g][i] += pw * vf[i];
      }
    }
    if (it + 1 < n_it && (it + 1) / cpp != pi) {   // on to the next page
      blk = blk_next;
      const int p2 = first + (pi + 2) * D_WARPS;
      blk_next = p2 < a.bp ? bt[p2] : 0;
    }
    cur = nxt;
  }

  // the warp's rows of slots -> one accumulator per hd column
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
    }
    if (sub == 0 && e0 < HD) {
#pragma unroll
      for (int i = 0; i < E; ++i) s_o[warp][g][e0 + i] = acc[g][i];
    }
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  // merge the warps (a warp that saw no slot holds m = -1e30, l = 0)
  const int rows = gridDim.x * a.CG;   // B*KVH*CG
  for (int idx = threadIdx.x; idx < NG * HD; idx += D_NT) {
    const int g = idx / HD, d = idx % HD, r = row0 + g;
    if (r >= a.CG) continue;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < D_WARPS; ++w) M = fmaxf(M, s_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < D_WARPS; ++w) {
      const float f = expf(s_m[w][g] - M);
      L += f * s_l[w][g];
      O += f * s_o[w][g][d];
    }
    const size_t row = (size_t)bh * a.CG + r;
    if (a.splits == 1) {
      store((QT*)a.out + row * HD + d, O / (L == 0.f ? 1.f : L));
    } else {
      a.part_o[((size_t)split * rows + row) * HD + d] = O;
      if (d == 0) {
        a.part_ml[(size_t)split * rows + row] = L == 0.f ? -INFINITY : M;
        a.part_ml[((size_t)a.splits + split) * rows + row] = L;
      }
    }
  }
}

// combine the splits' partials of each (lane, kv head, row) by log-sum-exp
template <int HD, typename QT>
__global__ void __launch_bounds__(HD)
    merge_kernel(const float* __restrict__ part_o,
                 const float* __restrict__ part_ml, QT* __restrict__ out,
                 int rows, int splits) {
  const int row = blockIdx.x, d = threadIdx.x;
  const float* pm = part_ml;
  const float* pl = part_ml + (size_t)splits * rows;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, pm[(size_t)s * rows + row]);
  float L = 0.f, O = 0.f;
  if (M != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float ms = pm[(size_t)s * rows + row];
      if (ms == -INFINITY) continue;   // an empty part
      const float f = expf(ms - M);
      L += f * pl[(size_t)s * rows + row];
      O += f * part_o[((size_t)s * rows + row) * HD + d];
    }
  }
  store(out + (size_t)row * HD + d, O / (L == 0.f ? 1.f : L));
}

// ---------------------------------------------------------------------------
// prefill, bf16 queries: tensor cores
// ---------------------------------------------------------------------------

constexpr int P_WARPS = 4;
constexpr int P_ROWS = 16 * P_WARPS;
constexpr int P_NT = 32 * P_WARPS;
using tile::BK;

// Q, two stages of K, V and their scales, and for an int8/fp8 pool two
// stages of raw K and V codes
template <int HD, typename KT>
constexpr size_t prefill_tc_smem() {
  return sizeof(bf16) * tile::row_elems<HD>() * (P_ROWS + 4 * BK) +
         sizeof(float) * 4 * BK + (sizeof(KT) == 1 ? 4 * BK * HD : 0);
}

// 16 pool codes -> 16 bf16 values (exact for int8 and e4m3)
template <typename KT>
__device__ __forceinline__ void codes_to_bf16(const uint4& r, uint4& lo,
                                              uint4& hi) {
  float f[16];
  unpack16<KT>(r, f);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = tile::pack_bf16(f[2 * i], f[2 * i + 1]);
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

// Element offset of row r (of C*G) of kv head h's query tile in q / out
// [B, C, KVH*G, HD]: chunk token r / G, query head h*G + r % G.
template <int HD>
__device__ __forceinline__ size_t q_row(const Args& a, int b, int h, int r) {
  const int c = r / a.G, g = r % a.G;
  return (((size_t)b * a.C + c) * a.KVH * a.G + h * a.G + g) * HD;
}

// Element offset of pool slot `slot` (< the lane's length) of kv head h.
template <int HD>
__device__ __forceinline__ size_t pool_row(const Args& a, int b, int h,
                                           int slot) {
  const size_t block = (size_t)a.bt[b * a.bp + slot / a.page];
  return ((block * a.page + slot % a.page) * a.KVH + h) * HD;
}

// Copies of a tile of BK keys, CPR of 16 bytes per key: N rounds of the
// CTA's threads, the last one ragged where BK * CPR is no multiple of P_NT
// (int8/fp8 codes of hd 80).
template <int CPR>
__host__ __device__ constexpr int copy_rounds() {
  return (BK * CPR + P_NT - 1) / P_NT;
}

// Key j of a tile: own key t0 + j of the chunk, or pool slot t0 + j; its
// element offset in own_k/own_v or in the pools (0 past `limit`). Each
// thread reads every block-table entry it needs before it issues a copy,
// so the table reads are in flight together.
template <int HD, int CPR, int N>
__device__ __forceinline__ void key_offsets(const Args& a, int b, int h,
                                            bool own, int t0, int limit,
                                            size_t (&off)[N],
                                            bool (&valid)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int j = (threadIdx.x + n * P_NT) / CPR;
    valid[n] = j < BK && t0 + j < limit;
    off[n] = 0;
    if (valid[n])
      off[n] = own ? (((size_t)b * a.C + t0 + j) * a.KVH + h) * HD
                   : pool_row<HD>(a, b, h, t0 + j);
  }
}

// Stage a tile of bf16 keys (the chunk's own, or a bf16 pool's) with
// cp.async.
template <int HD>
__device__ __forceinline__ void stage_rows(const Args& a, int b, int h,
                                           bool own, int t0, int limit,
                                           bf16* k_s, bf16* v_s) {
  constexpr int CPR = HD / 8, N = copy_rounds<CPR>();
  static_assert(BK * CPR % P_NT == 0, "whole rounds of bf16 copies");
  const bf16* kb = (const bf16*)(own ? a.own_k : a.k_pool);
  const bf16* vb = (const bf16*)(own ? a.own_v : a.v_pool);
  size_t off[N];
  bool valid[N];
  key_offsets<HD, CPR, N>(a, b, h, own, t0, limit, off, valid);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = threadIdx.x + n * P_NT, j = i / CPR, c = i % CPR;
    tile::cp_async16(k_s + tile::swz<HD>(j, c), kb + off[n] + c * 8,
                     valid[n]);
    tile::cp_async16(v_s + tile::swz<HD>(j, c), vb + off[n] + c * 8,
                     valid[n]);
  }
}

// Stage a tile of an int8/fp8 pool: its raw codes land with cp.async in
// raw_k/raw_v (16 codes per copy, in key order) and its scales in
// ks_s/vs_s (0 past the limit); convert_codes() turns them into bf16 rows
// once they have landed.
template <int HD>
__device__ __forceinline__ void stage_codes(const Args& a, int b, int h,
                                            int t0, int limit,
                                            uint8_t* raw_k, uint8_t* raw_v,
                                            float* ks_s, float* vs_s) {
  constexpr int CPR = HD / 16, N = copy_rounds<CPR>();
  const uint8_t* kp = (const uint8_t*)a.k_pool;
  const uint8_t* vp = (const uint8_t*)a.v_pool;
  size_t off[N];
  bool valid[N];
  key_offsets<HD, CPR, N>(a, b, h, false, t0, limit, off, valid);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = threadIdx.x + n * P_NT, c = i % CPR;
    if (i >= BK * CPR) break;   // the ragged last round
    tile::cp_async16(raw_k + i * 16, kp + off[n] + c * 16, valid[n]);
    tile::cp_async16(raw_v + i * 16, vp + off[n] + c * 16, valid[n]);
  }
  const int j = threadIdx.x;
  if (j < BK) {
    const bool ok = t0 + j < limit;
    const size_t so = ok ? pool_row<1>(a, b, h, t0 + j) : 0;
    tile::cp_async4(ks_s + j, a.k_scale + so, ok);
    tile::cp_async4(vs_s + j, a.v_scale + so, ok);
  }
}

// The landed codes of a tile -> swizzled bf16 rows (exact for int8 and
// e4m3).
template <int HD, typename KT>
__device__ __forceinline__ void convert_codes(const uint8_t* raw_k,
                                              const uint8_t* raw_v,
                                              bf16* k_s, bf16* v_s) {
  constexpr int CPR = HD / 16, N = copy_rounds<CPR>();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = threadIdx.x + n * P_NT, j = i / CPR, c = i % CPR;
    if (i >= BK * CPR) break;   // the ragged last round
    uint4 lo, hi;
    codes_to_bf16<KT>(*reinterpret_cast<const uint4*>(raw_k + i * 16), lo,
                      hi);
    *reinterpret_cast<uint4*>(k_s + tile::swz<HD>(j, 2 * c)) = lo;
    *reinterpret_cast<uint4*>(k_s + tile::swz<HD>(j, 2 * c + 1)) = hi;
    codes_to_bf16<KT>(*reinterpret_cast<const uint4*>(raw_v + i * 16), lo,
                      hi);
    *reinterpret_cast<uint4*>(v_s + tile::swz<HD>(j, 2 * c)) = lo;
    *reinterpret_cast<uint4*>(v_s + tile::swz<HD>(j, 2 * c + 1)) = hi;
  }
}

// Stage key tile t0.. (own keys or pool slots, those < limit): bf16 rows
// into k_s/v_s, or an int8/fp8 pool's codes into raw_k/raw_v; the per-key
// scales into ks_s/vs_s (1 for a float pool or own keys).
template <int HD, typename KT>
__device__ __forceinline__ void stage_tile(const Args& a, int b, int h,
                                           bool own, int t0, int limit,
                                           bf16* k_s, bf16* v_s,
                                           uint8_t* raw_k, uint8_t* raw_v,
                                           float* ks_s, float* vs_s) {
  static_assert(BK <= P_NT, "one thread per key for the scales");
  if constexpr (sizeof(KT) == 1) {
    if (!own) {
      stage_codes<HD>(a, b, h, t0, limit, raw_k, raw_v, ks_s, vs_s);
      return;
    }
  }
  stage_rows<HD>(a, b, h, own, t0, limit, k_s, v_s);
  if (threadIdx.x < BK) ks_s[threadIdx.x] = vs_s[threadIdx.x] = 1.f;
}

template <int HD, typename KT>
__global__ void __launch_bounds__(P_NT) prefill_tc_kernel(Args a) {
  constexpr int RS = tile::row_elems<HD>();   // a shared-memory row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [P_ROWS, RS]
  bf16* k_s = q_s + P_ROWS * RS;                    // [2][BK, RS]
  bf16* v_s = k_s + 2 * BK * RS;                    // [2][BK, RS]
  float* ks_s = reinterpret_cast<float*>(v_s + 2 * BK * RS);   // [2][BK]
  float* vs_s = ks_s + 2 * BK;                                 // [2][BK]
  uint8_t* raw = reinterpret_cast<uint8_t*>(vs_s + 2 * BK);  // [2][2][BK*HD]

  const int b = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * P_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrows = min(P_ROWS, a.CG - r0);
  // the Q tile and the first block-table line need no device length: both
  // are in flight while the lengths are read
  {
    const bf16* qg = (const bf16*)a.q;
    for (int i = threadIdx.x; i < P_ROWS * HD / 8; i += P_NT) {
      const int r = i / (HD / 8), c = i % (HD / 8);
      const bool ok = r < nrows;
      tile::cp_async16(q_s + tile::swz<HD>(r, c),
                       qg + q_row<HD>(a, b, h, ok ? r0 + r : 0) + c * 8, ok);
    }
    tile::cp_async_commit();
    if (threadIdx.x == 0)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(a.bt + (size_t)b * a.bp));
  }
  const int plen = a.lens[b], nv = a.nvalid[b];
  const int c_first = r0 / a.G, c_last = (r0 + nrows - 1) / a.G;

  // pool tiles [pt_begin, pt_end) hold a slot visible to some row; then
  // the own tiles: keys past the last row's chunk token are masked for all
  int pt_begin = 0;
  if (a.window >= 0) pt_begin = max(0, plen + c_first - a.window + 1) / BK;
  const int pt_end = (plen + BK - 1) / BK;
  const int n_pool = max(0, pt_end - pt_begin);
  const int own_limit = min(min(nv, a.C), c_last + 1);
  const int n_tiles = n_pool + (own_limit + BK - 1) / BK;

  float o[1][HD / 8][4];   // one block of 16 rows per warp
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    o[0][n][0] = o[0][n][1] = o[0][n][2] = o[0][n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // tiles t and t + 1 are in flight at once (the chunk's own tile lands
  // with the prefix's): one commit group per staged tile
  auto stage = [&](int t) {
    const bool own = t >= n_pool;
    const int t0 = own ? (t - n_pool) * BK : (pt_begin + t) * BK;
    const int st = t & 1;
    stage_tile<HD, KT>(a, b, h, own, t0, own ? own_limit : plen,
                       k_s + st * BK * RS, v_s + st * BK * RS,
                       raw + 2 * st * BK * HD, raw + (2 * st + 1) * BK * HD,
                       ks_s + st * BK, vs_s + st * BK);
    tile::cp_async_commit();
  };
  for (int t = 0; t < 2 && t < n_tiles; ++t) stage(t);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) tile::cp_async_wait<1>();
    else tile::cp_async_wait<0>();
    __syncthreads();   // tile t (and Q) staged
    const bool own = t >= n_pool;
    if constexpr (sizeof(KT) == 1) {
      if (!own) {
        convert_codes<HD, KT>(raw + 2 * st * BK * HD,
                              raw + (2 * st + 1) * BK * HD,
                              k_s + st * BK * RS, v_s + st * BK * RS);
        __syncthreads();
      }
    }
    const int t0 = own ? (t - n_pool) * BK : (pt_begin + t) * BK;
    const float* ksc = ks_s + st * BK;
    const float* vsc = vs_s + st * BK;
    float s[1][BK / 8][4];
    tile::qk<HD, 1>(s, q_s, warp * 16, k_s + st * BK * RS);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + (lane >> 2) + (e >> 1) * 8;
        const int c = (r0 + r) / a.G;   // chunk token of this row
        const int j = n * 8 + (lane & 3) * 2 + (e & 1);
        const int key = t0 + j;
        bool vis = r < nrows && c < nv;
        if (own) {
          vis = vis && key <= c && key < nv &&
                (a.window < 0 || key > c - a.window);
        } else {
          vis = vis && key < plen &&
                (a.window < 0 || key > plen + c - a.window);
        }
        s[0][n][e] = vis ? ksc[j] * s[0][n][e] : NEG_INF;
      }
    }
    tile::online_softmax<HD>(s[0], o[0], m, l, a.scale * tile::LOG2E);
    if (sizeof(KT) == 1 && !own) {   // p' = p * v_scale, after l
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int j = n * 8 + (lane & 3) * 2;
        s[0][n][0] *= vsc[j];
        s[0][n][1] *= vsc[j + 1];
        s[0][n][2] *= vsc[j];
        s[0][n][3] *= vsc[j + 1];
      }
    }
    tile::pv<HD, 1>(o, s, v_s + st * BK * RS);
    if (t + 2 < n_tiles) {
      __syncthreads();   // every warp is done with this buffer
      stage(t + 2);
    }
  }
  if (n_tiles == 0) tile::cp_async_wait<0>();   // the Q tile's copies

  tile::finalize<HD>(o[0], l);
  tile::store_rows<HD>(o[0], [&](int r) -> bf16* {
    const int row = warp * 16 + r;
    return row < nrows ? (bf16*)a.out + q_row<HD>(a, b, h, r0 + row)
                       : nullptr;
  });
}

// ---------------------------------------------------------------------------
// prefill, f32 queries or an f32 pool: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_ROWS = 16;   // query rows per CTA
constexpr int F_NT = 128;    // threads per CTA

// Fold one staged tile of n keys (key index key0 + j) into the softmax
// state of the CTA's rows. `own` selects the chunk's own-KV masks.
template <int HD>
__device__ __forceinline__ void fold_tile(
    const Args& a, const float* q_s, const float* k_s, const float* v_s,
    float* s_s, float* m_s, float* l_s, float* al_s,
    float (&acc)[F_ROWS * HD / F_NT], int n, int key0, bool own, int r0,
    int nrows, int cache_len, int nv) {
  constexpr int KP = HD + 1;
  const int tid = threadIdx.x;
  // scores, one thread per (row, key); masked entries hold -inf
  for (int e = tid; e < F_ROWS * a.page; e += F_NT) {
    const int r = e / a.page, j = e % a.page;
    const int c = (r0 + r) / a.G;    // chunk token of this query row
    const int key = key0 + j;
    bool vis = r < nrows && j < n && c < nv;
    if (vis && !own) {
      vis = key < cache_len;
      if (a.window >= 0) vis = vis && key > cache_len + c - a.window;
    } else if (vis) {
      vis = key <= c && key < nv;
      if (a.window >= 0) vis = vis && key > c - a.window;
    }
    float s = -INFINITY;
    if (vis) {
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot += q_s[r * HD + d] * k_s[j * KP + d];
      s = dot * a.scale;
    }
    s_s[r * a.page + j] = s;
  }
  __syncthreads();
  // online softmax update, one thread per row; s_s becomes P
  if (tid < F_ROWS) {
    float* srow = s_s + tid * a.page;
    float mx = NEG_INF;
    for (int j = 0; j < a.page; ++j) mx = fmaxf(mx, srow[j]);
    const float m_prev = m_s[tid];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int j = 0; j < a.page; ++j) {
      const float p = srow[j] == -INFINITY ? 0.f : expf(srow[j] - m_new);
      srow[j] = p;
      sum += p;
    }
    const float alpha = expf(m_prev - m_new);
    al_s[tid] = alpha;
    l_s[tid] = alpha * l_s[tid] + sum;
    m_s[tid] = m_new;
  }
  __syncthreads();
  // acc = acc * alpha + P @ V, one (row, hd column) per accumulator
  int r = tid / HD, col = tid % HD;
#pragma unroll
  for (int i = 0; i < F_ROWS * HD / F_NT; ++i) {
    const float* prow = s_s + r * a.page;
    float o = 0.f;
    for (int j = 0; j < n; ++j) o += prow[j] * v_s[j * HD + col];
    acc[i] = acc[i] * al_s[r] + o;
    tile::next_elem<HD, F_NT>(r, col);
  }
  __syncthreads();
}

template <int HD>
size_t prefill_f32_smem(int page) {
  return sizeof(float) * (F_ROWS * HD + page * (HD + 1) + page * HD +
                          F_ROWS * page + 3 * F_ROWS);
}

template <int HD, typename QT, typename KT>
__global__ void __launch_bounds__(F_NT) prefill_f32_kernel(Args a) {
  constexpr int KP = HD + 1;  // padded K rows: the score loop is conflict-free
  extern __shared__ float smem[];
  float* q_s = smem;                   // [F_ROWS, HD]
  float* k_s = q_s + F_ROWS * HD;      // [page, KP]
  float* v_s = k_s + a.page * KP;      // [page, HD]
  float* s_s = v_s + a.page * HD;      // [F_ROWS, page]
  float* m_s = s_s + F_ROWS * a.page;  // [F_ROWS] running max
  float* l_s = m_s + F_ROWS;           // [F_ROWS] running denominator
  float* al_s = l_s + F_ROWS;          // [F_ROWS] rescale of this tile

  const int b = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * F_ROWS;
  const int tid = threadIdx.x;
  const int nrows = min(F_ROWS, a.CG - r0);
  const int cache_len = a.lens[b];
  const int nv = a.nvalid[b];
  const QT* q = (const QT*)a.q;
  for (int i = tid; i < F_ROWS * HD; i += F_NT) {
    const int r = i / HD;
    q_s[i] = r < nrows ? to_f32(q[q_row<HD>(a, b, h, r0 + r) + i % HD]) : 0.f;
  }
  if (tid < F_ROWS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[F_ROWS * HD / F_NT];
#pragma unroll
  for (int i = 0; i < F_ROWS * HD / F_NT; ++i) acc[i] = 0.f;
  __syncthreads();

  // ---- pooled pages: only those holding a visible slot -----------------
  const KT* kp = (const KT*)a.k_pool;
  const KT* vp = (const KT*)a.v_pool;
  const size_t slot_stride = (size_t)a.KVH * HD;
  for (int p = 0; p < a.bp; ++p) {
    const int page_start = p * a.page;
    bool live = page_start < cache_len;
    if (a.window >= 0)  // left of every query's window
      live = live && page_start + a.page > cache_len - a.window;
    if (!live) continue;  // uniform over the CTA
    const size_t block = (size_t)a.bt[b * a.bp + p];
    const size_t base = block * a.page * slot_stride + (size_t)h * HD;
    for (int e = tid; e < a.page * HD; e += F_NT) {
      const int j = e / HD, d = e % HD;
      const size_t off = base + j * slot_stride + d;
      float kx = to_f32(kp[off]), vx = to_f32(vp[off]);
      if (a.k_scale != nullptr) {  // in-loop dequantization, per slot
        const size_t so = (block * a.page + j) * a.KVH + h;
        kx *= a.k_scale[so];
        vx *= a.v_scale[so];
      }
      k_s[j * KP + d] = kx;
      v_s[j * HD + d] = vx;
    }
    __syncthreads();
    fold_tile<HD>(a, q_s, k_s, v_s, s_s, m_s, l_s, al_s, acc, a.page,
                  page_start, false, r0, nrows, cache_len, nv);
  }

  // ---- the chunk's own exact K/V ---------------------------------------
  const QT* ok = (const QT*)a.own_k;
  const QT* ov = (const QT*)a.own_v;
  // keys past the last row's chunk token are causally masked for all
  const int last_c = (r0 + nrows - 1) / a.G;
  const int limit = min(min(nv, a.C), last_c + 1);
  for (int t0 = 0; t0 < limit; t0 += a.page) {
    const int n = min(a.page, limit - t0);
    for (int e = tid; e < n * HD; e += F_NT) {
      const int j = e / HD, d = e % HD;
      const size_t off = (((size_t)b * a.C + t0 + j) * a.KVH + h) * HD + d;
      k_s[j * KP + d] = to_f32(ok[off]);
      v_s[j * HD + d] = to_f32(ov[off]);
    }
    __syncthreads();
    fold_tile<HD>(a, q_s, k_s, v_s, s_s, m_s, l_s, al_s, acc, n, t0, true,
                  r0, nrows, cache_len, nv);
  }

  // ---- finalize: rows with no visible key emit zeros -------------------
  int r = tid / HD, col = tid % HD;
#pragma unroll
  for (int i = 0; i < F_ROWS * HD / F_NT; ++i) {
    if (r < nrows) {
      const float l = l_s[r];
      store((QT*)a.out + q_row<HD>(a, b, h, r0 + r) + col,
            acc[i] / (l == 0.f ? 1.f : l));
    }
    tile::next_elem<HD, F_NT>(r, col);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int HD, typename QT, typename KT>
int launch_decode(const Args& a, int B, cudaStream_t stream) {
  const int BH = B * a.KVH;
  // query rows per CTA: the G heads of a kv head, in groups of at most 4
  const int ng = a.G <= 1 ? 1 : a.G == 2 ? 2 : 4;
  const dim3 grid(BH, a.splits, (a.CG + ng - 1) / ng);
  if (ng == 1) decode_kernel<HD, 1, QT, KT><<<grid, D_NT, 0, stream>>>(a);
  else if (ng == 2) decode_kernel<HD, 2, QT, KT><<<grid, D_NT, 0, stream>>>(a);
  else decode_kernel<HD, 4, QT, KT><<<grid, D_NT, 0, stream>>>(a);
  if (a.splits > 1) {
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    merge_kernel<HD, QT><<<BH * a.CG, HD, 0, stream>>>(
        a.part_o, a.part_ml, (QT*)a.out, BH * a.CG, a.splits);
  }
  return (int)cudaGetLastError();
}

template <int HD, typename QT, typename KT>
int launch_prefill(const Args& a, int B, cudaStream_t stream) {
  constexpr bool TC = std::is_same<QT, bf16>::value &&
                      !std::is_same<KT, float>::value;
  if constexpr (TC) {
    constexpr size_t smem = prefill_tc_smem<HD, KT>();
    cudaFuncSetAttribute(prefill_tc_kernel<HD, KT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    const dim3 grid(B, a.KVH, (a.CG + P_ROWS - 1) / P_ROWS);
    prefill_tc_kernel<HD, KT><<<grid, P_NT, smem, stream>>>(a);
  } else {
    const size_t smem = prefill_f32_smem<HD>(a.page);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(prefill_f32_kernel<HD, QT, KT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    const dim3 grid(B, a.KVH, (a.CG + F_ROWS - 1) / F_ROWS);
    prefill_f32_kernel<HD, QT, KT><<<grid, F_NT, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int HD, typename QT, typename KT>
int launch(const Args& a, int B, cudaStream_t stream) {
  return a.own_k == nullptr ? launch_decode<HD, QT, KT>(a, B, stream)
                            : launch_prefill<HD, QT, KT>(a, B, stream);
}

template <int HD, typename QT>
int dispatch_pool(const Args& a, int B, int kv_kind, cudaStream_t stream) {
  switch (kv_kind) {
    case 0: return launch<HD, QT, float>(a, B, stream);
    case 1: return launch<HD, QT, bf16>(a, B, stream);
    case 2: return launch<HD, QT, int8_t>(a, B, stream);
    case 3: return launch<HD, QT, fp8>(a, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int HD>
int dispatch_dtypes(const Args& a, int B, int q_bf16, int kv_kind,
                    cudaStream_t stream) {
  if (q_bf16) return dispatch_pool<HD, bf16>(a, B, kv_kind, stream);
  return dispatch_pool<HD, float>(a, B, kv_kind, stream);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success). q_bf16: 1 for bf16, 0 for f32 (queries, own K/V and the
// output share the query dtype). kv_kind: the pool type, 0 f32, 1 bf16,
// 2 int8, 3 fp8 e4m3; the two quantized kinds need k_scale/v_scale.
// nvalid/own_k/own_v null = decode. splits > 1 (decode only) needs the
// scratch part_o [splits, B*KVH*CG, hd] and part_ml [2, splits, B*KVH*CG]
// f32; a second small kernel merges them into out.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lens, const void* nvalid,
    const void* own_k, const void* own_v, const void* k_scale,
    const void* v_scale, void* out, void* part_o, void* part_ml, int B,
    int KVH, int CG, int C, int G, int bp, int page, int hd, int q_bf16,
    int kv_kind, float scale, int window, int splits, void* stream) {
  if ((kv_kind >= 2) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || (splits > 1 && (own_k != nullptr || part_o == nullptr ||
                                    part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{q, k_pool, v_pool, (const int*)block_tables, (const int*)lens,
         (const int*)nvalid, own_k, own_v, (const float*)k_scale,
         (const float*)v_scale, out, (float*)part_o, (float*)part_ml, KVH,
         CG, C, G, bp, page, scale, window, splits};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32: return dispatch_dtypes<32>(a, B, q_bf16, kv_kind, st);
    case 64: return dispatch_dtypes<64>(a, B, q_bf16, kv_kind, st);
    case 80: return dispatch_dtypes<80>(a, B, q_bf16, kv_kind, st);
    case 128: return dispatch_dtypes<128>(a, B, q_bf16, kv_kind, st);
  }
  return (int)cudaErrorInvalidValue;
}
