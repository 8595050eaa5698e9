// The decode face of the paged attention kernel for Hopper (sm_90a): one
// query token per lane over its pooled K/V pages, for bf16 queries over a
// bf16, int8 or fp8 (e4m3) pool at hd 64, 80 or 128 (K1a, K1c decode).
//
// Replaces the decode face of the TPU kernel
// src/repro/kernels/paged_attention.py::_mq_paged_kernel (pallas_call at
// paged_attention.py:250). f32 queries or pools, and hd 32, stay on
// decode_kernel in paged_attention.cu (kernels/paged_attention.py::
// decode_face routes by dtype and head dim alone).
//
// What bounds it on the H100: at the serve's shapes, latency. A lane's
// row is a few pages (15-143 slots of 512 bytes per kv head at qwen3's
// hd 128), so the bytes take ~2 us at 3.35 TB/s and the kernel's time is
// its chain of dependent trips to memory (the lengths and the block
// table, then the pages), its merges and its launch. Timed by phase on
// the card from a cold L2 at the serve's shape, a CTA has its length and
// block ids after ~1.0-1.3 us, its first page after ~3.1-3.3 us, the
// last of its chunks folded after ~4-6 us, and its rows stored after
// ~7.5 us. Over long rows (mixtral's 4.2k slots), bytes. What the design
// does about each:
//
//   * One cluster of S CTAs per (lane, kv head, group of up to 48 query
//     heads); S, and a ring of `stages` 16-slot chunks per CTA, come from
//     the host (decode_plan: block-table width, clusters and page size,
//     never the lengths, so a captured graph stays valid when they
//     change). Chunk c of a lane (slots 16c..16c+15) belongs to the CTA of
//     rank c % S: short rows and long rows alike spread over the cluster.
//   * A producer warp reads the lane's length and the block ids of its
//     next 32 chunks at once, then puts every chunk the ring holds in
//     flight (a CTA's whole share, or a ring of one stage per warp group
//     that wraps: chunk k lands in stage k % 4 and is folded by group
//     k % 4, so each group waits on its own stage's phases in order; two
//     stages per group measured slower, at 2 CTAs per SM and one more
//     wave where a cluster's CTAs did not fit a GPC):
//     one TMA box per page (per 64 columns of a bf16 row; 8 or 16 slots
//     of kv head h, 128-byte swizzle) of K and of V, completing on the
//     stage's mbarrier. The tensor maps over the pools are encoded on the
//     host at each call; a captured graph keeps them, which holds because
//     an engine's pools never move. One box per slot row (cp.async.bulk,
//     no map) measured slower: the TMA unit spends about the same time on
//     a 256-byte copy as on a 2 KB box. No box is issued for a page
//     wholly at or past the length; the V rows it would fill are zeroed
//     instead (0 * NaN would poison P.V). An int8/fp8 stage also carries
//     each slot's k and v scale (cp.async of 4 bytes, arriving on the
//     same mbarrier).
//   * All G query heads of the kv head are rows of one CTA (up to three
//     16-row tiles), so each page is read once. Consumer warp (tile t,
//     group w) folds the CTA's chunks k = w, w + 4, ..: S = Q K^T and
//     O += P V on the tensor cores (mma.sync m16n8k16, bf16 operands
//     from shared memory by ldmatrix, f32 accumulators), the online
//     softmax on the fragments (attention_tile.cuh). Over an int8/fp8 pool
//     the warps of a group first convert the stage's codes to bf16
//     (exact); the k scales multiply the scores, the v scales p before
//     it is rounded to bf16 (l sums the unscaled p), as the plain
//     version's dequantized pages give up to rounding.
//   * Merge without a second launch: the four groups of a tile merge
//     through shared memory ((0 with 2) with (1 with 3)); then each CTA
//     pushes the state of each query row to the CTA that owns the row
//     (row % S) by distributed shared memory, and after one cluster
//     barrier each CTA merges its rows over the cluster, in rank order,
//     and stores them (a cluster of one stores its rows at once). A CTA
//     announces that it runs with an early arrive on the same barrier,
//     so no CTA waits at the start.
//
// Numerics: f32 scores, softmax and accumulators; P rounded to bf16
// before P.V (as the prefill face and ref.py::mha_ref round it); a row no
// slot reaches (length 0) emits zeros. Pages: 8 slots or a multiple of 16.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "attention_wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using fp8 = __nv_fp8_e4m3;
using tile::NEG_INF;

constexpr int CH = 16;           // slots per chunk: one k-step of P.V
constexpr int GROUPS = 4;        // warp groups of a row tile
constexpr int MAX_CLUSTER = 8;   // kernels/paged_attention.py: MAX_CLUSTER
constexpr int MAX_STAGES = 4;    // ... MAX_STAGES: one per group
constexpr int MAX_ROWS = 48;     // ... CLUSTER_ROWS

constexpr int align128(int n) { return (n + 127) / 128 * 128; }
constexpr int align1024(int n) { return (n + 1023) / 1024 * 1024; }

struct Args {
  const bf16* q;        // [B, KVH*G, HD]
  const void* k_pool;   // [NB, page, KVH, HD]
  const void* v_pool;
  const int* bt;        // [B, bp]
  const int* lens;      // [B]
  const float* k_scale; // [NB, page, KVH] (int8/fp8 pool), else null
  const float* v_scale;
  bf16* out;            // like q
  int KVH, G, bp, page, cluster, stages;
  float scale_log2;     // softmax scale * log2(e)
};

// The tensor maps of the two pools, [NB, page, KVH, HD]: boxes of 64
// columns (bf16, 128-byte swizzle) or of the whole row (int8/fp8 codes)
// of one kv head over min(page, 16) slots of one block.
struct PoolMaps {
  CUtensorMap k, v;
};

// A K or V tile of the chunk's 16 slots in bf16, as TMA's 128-byte
// swizzle lays it out: one [16, 64] block of 128-byte rows per 64
// columns (2 KB each, 1024-byte aligned), the 16-byte piece `chunk` of
// row r at ((chunk % 8) ^ (r % 8)) within the row.
constexpr int TILE_BLOCK = CH * 128;
template <int HD>
constexpr int tile_bytes() { return (HD + 63) / 64 * TILE_BLOCK; }
template <typename T>   // bf16 or const bf16
__device__ __forceinline__ T* tile_at(T* t, int row, int chunk) {
  return t + (chunk >> 3) * (TILE_BLOCK / 2) + row * 64 +
         (((chunk & 7) ^ (row & 7)) << 3);
}

// Shared memory, in bytes from the base: the mbarriers (full, then
// empty), the query tile, the states the cluster's CTAs push to this one
// (its rows: row % S == rank; [sender][slot][OS] f32, o then m and l),
// the ring of stages (each the K and V tiles, and over an
// int8/fp8 pool the codes as TMA lands them, [16, HD] bytes each, and
// their scales), and over an int8/fp8 pool one bf16 K and V tile per
// warp group. The merge states of the warp groups (regions A and B)
// reuse the ring once every chunk is folded.
template <int HD, typename KT, int RT>
struct Lay {
  static constexpr bool QUANT = sizeof(KT) == 1;
  static constexpr int NT = 32 * (GROUPS * RT + 1);   // + the producer
  static constexpr int ROWS = 16 * RT;
  static constexpr int RS = HD + 8;   // bf16 elements per query-tile row
                                      // (odd 16-byte pieces: no ldmatrix
                                      // bank conflict)
  static constexpr int TILE = tile_bytes<HD>();
  static constexpr int CODES = CH * HD;   // one matrix's codes
  static constexpr int STAGE = QUANT ? align1024(2 * CODES + 2 * CH * 4)
                                     : 2 * TILE;
  static constexpr int SCR = QUANT ? 2 * TILE + align1024(2 * CH * 4) : 0;
  static constexpr int OS = HD + 4;   // f32 per merge-state row
  static constexpr int STATE = align128(ROWS * OS * 4 + 2 * ROWS * 4);
  static constexpr int BARS = align128(2 * MAX_STAGES * 8);
  static constexpr int QS = BARS;
  static constexpr int RECV = QS + align128(ROWS * RS * 2);
  static constexpr int RING =
      align1024(RECV + (ROWS + MAX_CLUSTER) * OS * 4);
  static constexpr int bytes(int stages) {
    return RING + (stages * STAGE + GROUPS * SCR > 2 * STATE
                       ? stages * STAGE + GROUPS * SCR
                       : 2 * STATE);
  }
};

// an arrive on `bar` once this thread's earlier cp.async copies land (the
// barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}
// order this thread's generic writes to shared memory before later
// asynchronous (bulk copy) writes to it
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the cluster's barrier, split: arrive (relaxed at the start: "this CTA
// runs"; release after the pushes) and wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 16 pool codes -> 16 bf16 values (exact for int8 and e4m3)
__device__ __forceinline__ void codes_to_bf16(int8_t, const uint4& r,
                                              uint4& lo, uint4& hi) {
  const int8_t* x = reinterpret_cast<const int8_t*>(&r);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = tile::pack_bf16((float)x[2 * i], (float)x[2 * i + 1]);
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}
__device__ __forceinline__ void codes_to_bf16(fp8, const uint4& r, uint4& lo,
                                              uint4& hi) {
  const __nv_fp8x2_storage_t* x =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&r);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {   // one cvt per pair
    const float2 v = __half22float2(
        __half2(__nv_cvt_fp8x2_to_halfraw2(x[i], __NV_E4M3)));
    w[i] = tile::pack_bf16(v.x, v.y);
  }
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

// One warp's softmax state (m raw, l summed over its columns, o) for its
// rows rt*16 + lane/4 (+ 8), stored to or merged from a region: o
// [ROWS][OS], then m [ROWS], then l [ROWS], f32.
template <int HD, int ROWS>
__device__ __forceinline__ void put_state(float* reg, int rt,
                                          const float (&o)[HD / 8][4],
                                          const float (&m)[2],
                                          const float (&l)[2]) {
  constexpr int OS = HD + 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int row = rt * 16 + (lane >> 2) + 8 * r2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(reg + row * OS + n * 8 + 2 * (lane & 3)) =
          make_float2(o[n][2 * r2], o[n][2 * r2 + 1]);
    if ((lane & 3) == 0) {
      reg[ROWS * OS + row] = m[r2];
      reg[ROWS * OS + ROWS + row] = l[r2];
    }
  }
}

template <int HD, int ROWS>
__device__ __forceinline__ void merge_state(const float* reg, int rt,
                                            float (&o)[HD / 8][4],
                                            float (&m)[2], float (&l)[2],
                                            float c) {
  constexpr int OS = HD + 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int row = rt * 16 + (lane >> 2) + 8 * r2;
    const float mo = reg[ROWS * OS + row], lo = reg[ROWS * OS + ROWS + row];
    const float M = fmaxf(m[r2], mo);
    const float es = exp2f((m[r2] - M) * c), eo = exp2f((mo - M) * c);
    m[r2] = M;
    l[r2] = es * l[r2] + eo * lo;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float2 x = *reinterpret_cast<const float2*>(
          reg + row * OS + n * 8 + 2 * (lane & 3));
      o[n][2 * r2] = es * o[n][2 * r2] + eo * x.x;
      o[n][2 * r2 + 1] = es * o[n][2 * r2 + 1] + eo * x.y;
    }
  }
}

template <int HD, typename KT, int RT>
__global__ void __launch_bounds__(Lay<HD, KT, RT>::NT, RT == 1 ? 3 : 1)
    decode_cluster_kernel(__grid_constant__ const PoolMaps maps, Args a) {
  using L = Lay<HD, KT, RT>;
  constexpr bool QUANT = L::QUANT;
  constexpr int RS = L::RS, NC = GROUPS * RT;   // consumer warps
  extern __shared__ __align__(1024) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = a.cluster, NS = a.stages;
  const int rank = blockIdx.x;   // the cluster spans grid x
  const int b = blockIdx.y / a.KVH, h = blockIdx.y % a.KVH;
  const int row0 = blockIdx.z * MAX_ROWS;
  const int nrows = min(L::ROWS, a.G - row0);
  const uint32_t bars = wg::smem_u32(smem);   // full[i], empty[i]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MAX_STAGES + s); };
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::QS);
  float* recv = reinterpret_cast<float*>(smem + L::RECV);
  uint8_t* ring = smem + L::RING;
  uint8_t* scratch = ring + NS * L::STAGE;

  // one trip to memory before the pages: the block ids (the producer's,
  // of chunks k0 + lane: two pages of 8 slots, or one page), the tensor
  // maps, the length and the query rows are all requested here
  const int* bt = a.bt + (size_t)b * a.bp;
  int blk_a = 0, blk_b = 0;
  auto fetch = [&](int k0) {
    const int p = (rank + (k0 + lane) * S) * CH / a.page;
    if (p < a.bp) {
      blk_a = bt[p];
      blk_b = a.page < CH && p + 1 < a.bp ? bt[p + 1] : blk_a;
    }
  };
  if (warp == NC) {
    fetch(0);
    if (lane == 0) {
      wg::prefetch_map(&maps.k);
      wg::prefetch_map(&maps.v);
    }
  }
  const int len = min(a.lens[b], a.bp * a.page);   // as the plain version
  constexpr int QV = (L::ROWS * HD / 8 + 32 * NC - 1) / (32 * NC);
  uint4 qv[QV];   // consumers: 16-byte pieces of the query tile
#pragma unroll
  for (int i = 0; i < QV; ++i) {
    const int idx = threadIdx.x + i * 32 * NC, r = idx / (HD / 8);
    qv[i] = make_uint4(0, 0, 0, 0);
    if (warp < NC && idx < L::ROWS * HD / 8 && r < nrows)
      qv[i] = *reinterpret_cast<const uint4*>(
          a.q + (((size_t)b * a.KVH + h) * a.G + row0 + r) * HD +
          (idx % (HD / 8)) * 8);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      wg::mbar_init(full(s), QUANT ? 2 + 32 : 2);
      wg::mbar_init(empty(s), RT);
    }
    wg::mbar_init_fence();
  }
  if (S > 1)   // this CTA runs: its shared memory may be written by the
    cluster_arrive_relaxed();   // others (who wait for it first)
  const int nch = (len + CH - 1) / CH;              // live chunks
  const int nk = nch > rank ? (nch - rank + S - 1) / S : 0;   // this CTA's
  __syncthreads();

  if (warp == NC) {
    // ---- producer: each chunk into its stage once the stage is free (the
    // block ids of 32 chunks at a time) ----------------------------------
    // boxes per chunk: pages of 8 slots give two, of 8 rows each
    const int rows = min(a.page, CH), halves = CH / rows;
    constexpr int NBLK = QUANT ? 1 : (HD + 63) / 64;   // boxes across a row
    const uint32_t box = rows * (QUANT ? HD : 128);   // bytes
    for (int k = 0; k < nk; ++k) {
      if (k > 0 && (k & 31) == 0) fetch(k);
      const int s = k % NS;
      if (k >= NS) wg::mbar_wait(empty(s), (k / NS - 1) & 1);
      const int c = rank + k * S;
      const int ba = __shfl_sync(0xffffffffu, blk_a, k & 31);
      const int bb = __shfl_sync(0xffffffffu, blk_b, k & 31);
      // a second half (pages of 8) wholly past the length has no page
      const int live = c * CH + rows < len ? halves : 1;
      uint8_t* st = ring + s * L::STAGE;
      if (lane == 0) {
        wg::mbar_expect(full(s), 2u * live * NBLK * box);
        for (int hf = 0; hf < live; ++hf) {
          const int blk = hf == 0 ? ba : bb;
          const int slot0 = (c * CH + hf * rows) % a.page;
#pragma unroll
          for (int x = 0; x < NBLK; ++x) {
            const int off = QUANT ? hf * rows * HD
                                  : x * TILE_BLOCK + hf * rows * 128;
            wg::tma_load(wg::smem_u32(st + off), &maps.k, full(s), x * 64,
                         h, slot0, blk);
            wg::tma_load(wg::smem_u32(st + (QUANT ? L::CODES : L::TILE) +
                                      off),
                         &maps.v, full(s), x * 64, h, slot0, blk);
          }
        }
      } else if (live < halves) {   // no page behind rows 8-15 of V: zeros
        uint8_t* v = st + (QUANT ? L::CODES : L::TILE);
        for (int i = lane - 1; i < NBLK * rows * (QUANT ? HD : 128) / 16;
             i += 31) {
          const int x = i / (rows * (QUANT ? HD : 128) / 16);
          const int r = i % (rows * (QUANT ? HD : 128) / 16);
          *reinterpret_cast<uint4*>(
              v + (QUANT ? rows * HD : x * TILE_BLOCK + rows * 128) +
              r * 16) = make_uint4(0, 0, 0, 0);
        }
        fence_async_smem();
      }
      if constexpr (QUANT) {   // lane j's slot: its k scale, or v (j >= 16)
        const int j = lane & (CH - 1);
        const float* pscale = lane >= CH ? a.v_scale : a.k_scale;
        const int slot = c * CH + j;
        const bool ok = slot < len;
        const size_t row = ((size_t)(j >= rows ? bb : ba) * a.page +
                            slot % a.page) * a.KVH + h;
        float* sd = reinterpret_cast<float*>(st + 2 * L::CODES) + lane;
        tile::cp_async4(sd, ok ? pscale + row : pscale, ok);
        cp_async_arrive(full(s));
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(full(s));
    }
    if (S > 1) cluster_wait();   // pairs with the early arrive
  } else {
    // ---- consumers: warp (row tile rt, group wg) ------------------------
    const int rt = warp / GROUPS, grp = warp % GROUPS;
#pragma unroll
    for (int i = 0; i < QV; ++i) {
      const int idx = threadIdx.x + i * 32 * NC;
      if (idx < L::ROWS * HD / 8)
        *reinterpret_cast<uint4*>(q_s + (idx / (HD / 8)) * RS +
                                  (idx % (HD / 8)) * 8) = qv[i];
    }
    named_bar(1, 32 * NC);

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    bf16* scr = reinterpret_cast<bf16*>(scratch + grp * L::SCR);

    for (int k = grp; k < nk; k += GROUPS) {
      const int s = k % NS, c = rank + k * S;
      uint8_t* st = ring + s * L::STAGE;
      wg::mbar_wait(full(s), (k / NS) & 1);
      const bf16 *kt, *vt;
      const float *ks = nullptr, *vs = nullptr;
      if constexpr (QUANT) {
        // the group's warps convert the codes (and copy the scales) into
        // the group's bf16 tile, then free the stage
        constexpr int CPR = HD / 16;   // 16-code pieces per row
        const int gt = rt * 32 + lane;
        named_bar(2 + grp, 32 * RT);   // the previous chunk is folded
        for (int i = gt; i < 2 * CH * CPR; i += 32 * RT) {
          const int mat = i / (CH * CPR), r = (i / CPR) % CH, ch = i % CPR;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              st + mat * L::CODES + r * HD + ch * 16);
          uint4 lo, hi;
          codes_to_bf16(KT{}, raw, lo, hi);
          bf16* t = scr + mat * (L::TILE / 2);
          *reinterpret_cast<uint4*>(tile_at(t, r, 2 * ch)) = lo;
          *reinterpret_cast<uint4*>(tile_at(t, r, 2 * ch + 1)) = hi;
        }
        float* sc_s = reinterpret_cast<float*>(scr + L::TILE);
        if (gt < 2 * CH)
          sc_s[gt] = reinterpret_cast<const float*>(st + 2 * L::CODES)[gt];
        named_bar(2 + grp, 32 * RT);
        if (lane == 0) wg::mbar_arrive(empty(s));
        kt = scr;
        vt = scr + L::TILE / 2;
        ks = sc_s;
        vs = sc_s + CH;
      } else {
        kt = reinterpret_cast<const bf16*>(st);
        vt = reinterpret_cast<const bf16*>(st + L::TILE);
      }

      // S = Q K^T over the chunk's 16 slots (raw dot products), the
      // k-steps in two chains of products, summed at the end
      float sc[2][4] = {}, sc2[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qa[4], kb[4];
        tile::ldsm_x4(qa, q_s + (rt * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * RS +
                              (kk * 2 + (lane >> 4)) * 8);
        tile::ldsm_x4(kb, tile_at(kt, (lane & 7) + (lane >> 4) * 8,
                                  kk * 2 + ((lane >> 3) & 1)));
        float (&d)[2][4] = kk & 1 ? sc2 : sc;
        tile::mma(d[0], qa, kb[0], kb[1]);
        tile::mma(d[1], qa, kb[2], kb[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * (lane & 3) + (e & 1);
          float x = sc[n][e] + sc2[n][e];
          if constexpr (QUANT) x *= ks[col];
          sc[n][e] = c * CH + col < len ? x : NEG_INF;
        }
      float alpha[2];
      tile::softmax_p<2>(sc, m, l, a.scale_log2, alpha);
      tile::rescale<HD>(o, alpha);
      if constexpr (QUANT) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[n][e] *= vs[n * 8 + 2 * (lane & 3) + (e & 1)];
      }
      // O += P V, P rounded to bf16
      const uint32_t pa[4] = {tile::pack_bf16(sc[0][0], sc[0][1]),
                              tile::pack_bf16(sc[0][2], sc[0][3]),
                              tile::pack_bf16(sc[1][0], sc[1][1]),
                              tile::pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int nn = 0; nn < HD / 16; ++nn) {
        uint32_t vb[4];
        tile::ldsm_x4_t(vb, tile_at(vt, (lane & 7) + ((lane >> 3) & 1) * 8,
                                    nn * 2 + (lane >> 4)));
        tile::mma(o[2 * nn], pa, vb[0], vb[1]);
        tile::mma(o[2 * nn + 1], pa, vb[2], vb[3]);
      }
      if constexpr (!QUANT) {
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(empty(s));
      }
    }

    // ---- the groups of a row tile: (0 with 2) with (1 with 3), in
    // regions A and B over the ring (every chunk is folded) -------------
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      l[r2] += __shfl_xor_sync(0xffffffffu, l[r2], 1);
      l[r2] += __shfl_xor_sync(0xffffffffu, l[r2], 2);
    }
    float* reg_a = reinterpret_cast<float*>(ring);
    float* reg_b = reinterpret_cast<float*>(ring + L::STATE);
    named_bar(1, 32 * NC);
    if (grp >= 2) put_state<HD, L::ROWS>(grp == 2 ? reg_a : reg_b, rt, o, m, l);
    named_bar(1, 32 * NC);
    if (grp < 2) {
      merge_state<HD, L::ROWS>(grp == 0 ? reg_a : reg_b, rt, o, m, l,
                               a.scale_log2);
      if (grp == 1) {
        __syncwarp();
        put_state<HD, L::ROWS>(reg_b, rt, o, m, l);
      }
    }
    named_bar(1, 32 * NC);
    if (grp == 0) merge_state<HD, L::ROWS>(reg_b, rt, o, m, l, a.scale_log2);
    if (S == 1) {   // the CTA's state is the row's: normalise, store
      if (grp == 0) {
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int row = rt * 16 + (lane >> 2) + 8 * r2;
          if (row >= nrows) continue;
          const float inv = 1.f / (l[r2] == 0.f ? 1.f : l[r2]);
          bf16* dst = a.out +
                      (((size_t)b * a.KVH + h) * a.G + row0 + row) * HD +
                      2 * (lane & 3);
#pragma unroll
          for (int n = 0; n < HD / 8; ++n)
            *reinterpret_cast<uint32_t*>(dst + n * 8) = tile::pack_bf16(
                o[n][2 * r2] * inv, o[n][2 * r2 + 1] * inv);
        }
      }
      return;
    }

    // ---- the cluster: group 0's warps push the CTA's state of each row
    // to the CTA that owns the row (row % S), by distributed shared
    // memory, once every CTA of the cluster runs -------------------------
    cluster_wait();
    if (grp == 0) {
      const int slots = (nrows + S - 1) / S;
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int row = rt * 16 + (lane >> 2) + 8 * r2;
        if (row >= nrows) continue;
        float* dst = cluster.map_shared_rank(recv, row % S) +
                     (rank * slots + row / S) * L::OS;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<float2*>(dst + n * 8 + 2 * (lane & 3)) =
              make_float2(o[n][2 * r2], o[n][2 * r2 + 1]);
        if ((lane & 3) == 0) {
          dst[HD] = m[r2];
          dst[HD + 1] = l[r2];
        }
      }
    }
  }

  if (S == 1) return;
  cluster_arrive();   // the pushes are done
  cluster_wait();

  // ---- this CTA's rows: merge the cluster's states, store ---------------
  const int slots = (nrows + S - 1) / S;
  for (int t = threadIdx.x; t < slots * (HD / 4); t += L::NT) {
    const int slot = t / (HD / 4), d = (t % (HD / 4)) * 4;
    const int row = rank + slot * S;
    if (row >= nrows) continue;
    float M = NEG_INF;
    for (int qr = 0; qr < S; ++qr)
      M = fmaxf(M, recv[(qr * slots + slot) * L::OS + HD]);
    float Lsum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int qr = 0; qr < S; ++qr) {
      const float* st = recv + (qr * slots + slot) * L::OS;
      const float e = exp2f((st[HD] - M) * a.scale_log2);
      const float4 x = *reinterpret_cast<const float4*>(st + d);
      Lsum += e * st[HD + 1];
      acc.x += e * x.x;
      acc.y += e * x.y;
      acc.z += e * x.z;
      acc.w += e * x.w;
    }
    const float inv = 1.f / (Lsum == 0.f ? 1.f : Lsum);
    *reinterpret_cast<uint2*>(
        a.out + (((size_t)b * a.KVH + h) * a.G + row0 + row) * HD + d) =
        make_uint2(tile::pack_bf16(acc.x * inv, acc.y * inv),
                   tile::pack_bf16(acc.z * inv, acc.w * inv));
  }
}

template <int HD, typename KT, int RT>
int launch(const PoolMaps& maps, const Args& a, int B, int groups,
           cudaStream_t stream) {
  using L = Lay<HD, KT, RT>;
  static bool smem_set = false;   // once per instance, at the ring's cap
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_cluster_kernel<HD, KT, RT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes(MAX_STAGES));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, B * a.KVH, groups);
  cfg.blockDim = dim3(L::NT);
  cfg.dynamicSmemBytes = L::bytes(a.stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, decode_cluster_kernel<HD, KT, RT>, maps, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The pools' tensor maps, then the launch at one or three row tiles.
template <int HD, typename KT>
int dispatch_rows(const Args& a, int B, int NB, cudaStream_t stream) {
  constexpr bool codes = sizeof(KT) == 1;
  const uint64_t KVH = a.KVH, page = a.page;
  const uint64_t dims[4] = {HD, KVH, page, (uint64_t)NB};
  const uint64_t strides[3] = {HD, KVH * HD, page * KVH * HD};
  const uint32_t box[4] = {codes ? HD : 64, 1, (uint32_t)min(a.page, CH),
                           1};
  PoolMaps maps;
  if (!wg::tensor_map(&maps.k, codes, a.k_pool, 4, dims, strides, box) ||
      !wg::tensor_map(&maps.v, codes, a.v_pool, 4, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  const int groups = (a.G + MAX_ROWS - 1) / MAX_ROWS;
  return a.G <= 16 ? launch<HD, KT, 1>(maps, a, B, groups, stream)
                   : launch<HD, KT, 3>(maps, a, B, groups, stream);
}

template <int HD>
int dispatch_pool(const Args& a, int B, int NB, int kv_kind,
                  cudaStream_t stream) {
  switch (kv_kind) {
    case 1: return dispatch_rows<HD, bf16>(a, B, NB, stream);
    case 2: return dispatch_rows<HD, int8_t>(a, B, NB, stream);
    case 3: return dispatch_rows<HD, fp8>(a, B, NB, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`; returns the launch's CUDA error (0 on success).
// kv_kind: the pool type, 1 bf16, 2 int8, 3 fp8 e4m3 (the two quantized
// kinds need k_scale/v_scale); queries and output bf16. cluster and
// stages: kernels/paged_attention.py::decode_plan; NB: the pool's blocks.
extern "C" int repro_paged_decode(const void* q, const void* k_pool,
                                  const void* v_pool,
                                  const void* block_tables,
                                  const void* lens, const void* k_scale,
                                  const void* v_scale, void* out, int B,
                                  int KVH, int G, int bp, int page, int hd,
                                  int kv_kind, float scale, int cluster,
                                  int stages, int NB, void* stream) {
  if ((kv_kind >= 2) != (k_scale != nullptr && v_scale != nullptr) ||
      cluster < 1 || cluster > MAX_CLUSTER || stages < 1 ||
      stages > MAX_STAGES || G < 1 || (page != 8 && page % CH != 0))
    return (int)cudaErrorInvalidValue;
  // a ring that wraps must give each stage to one warp group
  const int share = ((bp * page + CH - 1) / CH + cluster - 1) / cluster;
  if (stages < share && stages % GROUPS != 0)
    return (int)cudaErrorInvalidValue;
  Args a{(const bf16*)q, k_pool, v_pool, (const int*)block_tables,
         (const int*)lens, (const float*)k_scale, (const float*)v_scale,
         (bf16*)out, KVH, G, bp, page, cluster, stages,
         scale * tile::LOG2E};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64: return dispatch_pool<64>(a, B, NB, kv_kind, st);
    case 80: return dispatch_pool<80>(a, B, NB, kv_kind, st);
    case 128: return dispatch_pool<128>(a, B, NB, kv_kind, st);
  }
  return (int)cudaErrorInvalidValue;
}
