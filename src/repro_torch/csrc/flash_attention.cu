// Blockwise (flash) attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// ::_flash_kernel (pallas_call at flash_attention.py:125): q, k, v
// [B*H, S, hd] with the kv heads already broadcast, an optional causal
// mask and sliding window, f32 scores, softmax and P.V, the output in the
// input dtype. A row with no visible key emits zeros (safe_l).
//
// What bounds it on the H100: operations. Causal attention over S keys
// does about 2*hd*S flops per query row for every 2*hd bytes of its
// q and output (bf16), thousands of flops per byte at S = 2048, far above
// the ~295 flops per byte at which the tensor cores, not the memory, are
// the limit. In f32 the bound is the tensor cores' 3xTF32 rate (three
// TF32 products per f32 product: 495 / 3 TFLOP/s).
//
// Three faces; the host picks one from head dim and dtype alone
// (kernels/flash_attention.py::flash_face), and for the wgmma face the
// query rows per CTA from the shape (flash_rows):
//
// bf16 at hd 64, 80 and 128: flash_wgmma_kernel, the Hopper tile
//   (attention_wgmma.cuh). The products run on wgmma, the only way to the
//   tensor cores' full rate, the loads cost no thread instructions (TMA),
//   and a tile pays a mask only where the plan says so. A work item is 64
//   or 128 query rows of one (batch, head): one consumer warpgroup of 64
//   rows over key tiles of 64, or, where B*H*ceil(S / 128) fills the
//   card, two warpgroups over key tiles of 128, so that each K/V tile read
//   serves 128 rows and each S = Q K^T k-step is one m64n128 product. The
//   grid is persistent: one CTA per SM (two at 64 rows) walks its items,
//   the longest causal blocks first, in rounds of alternating direction
//   (so that the CTAs' sums of causal lengths are about equal), and its
//   loads run on from one item into the next, hiding each item's start.
//   One producer warp (its warpgroup gives up its registers with
//   setmaxnreg) loads each item's Q tile, once the consumers have read
//   the last into registers, and keeps a ring of K/V stages full (as many
//   as fit, up to 4), one TMA box per 64 columns (128-byte swizzle), K and
//   V each completing on its own mbarrier. K/V are contiguous, so a tile
//   is one box per column block, a ragged S is the box's zero fill
//   (masked), and hd 80 is two column blocks, the second zero past column
//   80. A consumer warpgroup holds its Q rows as A registers, computes
//   S = Q K^T (K K-major, hd / 16 k-steps: five at hd 80), the online
//   softmax in registers, and O += P V with P from registers (rounded to
//   bf16) and V read transposed (m64n{hd}k16). The products of one tile
//   overlap the softmax of the next: S of tile i+1 and P V of tile i are
//   issued together, the softmax of tile i+1 runs while P V is in flight,
//   and O is rescaled once it has landed. Two warpgroups take turns to
//   issue (named barriers), so that one's softmax runs under the other's
//   products. The tiles an item loads, and which of them each warpgroup
//   masks, follow Tiles (kernels/flash_attention.py::flash_plan): a key
//   tile is loaded iff some row of the item sees one of its keys, and
//   masked only on the causal diagonal, the window's left edge and the
//   end of a ragged S (for a warpgroup: where its own rows do not see it
//   whole); an interior tile takes no compare.
//
// bf16 at hd 32: flash_tc_kernel, the mma.sync tile (attention_tile.cuh):
//   a 32-column row is half of the 128-byte swizzle atom wgmma's K-major
//   k-steps are cut from. FlashAttention-2's layout: grid (B*H, ceil(S /
//   128)), 4 warps of 32 rows each (two blocks of 16, so each K and V
//   fragment read from shared memory feeds two products), a cp.async ring
//   of two 64-key tiles, the same skips and masks.
//
// f32: flash_f32_kernel, the tensor cores in 3xTF32 (tf32.cuh): each
//   f32 operand of Q K^T and of P V splits into a big TF32 part and a
//   small one, and a product takes a_small b_big + a_big b_small +
//   a_big b_big in f32 accumulators (mma.sync.m16n8k8), about f32's
//   accuracy where plain TF32 would miss the 1e-4 tolerance. grid (B*H,
//   ceil(S / 128)), 4 warps of 32 rows, Q and a cp.async ring of two
//   64-key K/V tiles in shared memory as f32 rows padded by 4 (each
//   fragment read hits 32 banks); the operands are split as they are read.
//   The S accumulator feeds P V's A fragments without a shuffle: the keys
//   of each 8-key step are taken in the order 0, 2, 4, 6, 1, 3, 5, 7, and
//   V's B fragments read the same order.
//
// Numerics (every face): f32 scores, the -1e30 fill, p = where(mask,
// exp(s - m), 0), l summed in f32 from the unrounded p; in bf16 P is
// rounded to bf16 before P.V, as the reference mha_ref rounds probs to
// v's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "attention_wgmma.cuh"
#include "tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tile::BK;
using tile::NEG_INF;

// ---------------------------------------------------------------------------
// the schedule, shared by every face
// ---------------------------------------------------------------------------

// The keys query row q sees: lo(q) <= key <= hi(q), none where lo > hi.
struct Mask {
  int S, causal, window;   // window < 0: none
  __device__ __forceinline__ int lo(int q) const {
    return window < 0 ? 0 : max(0, q - window + 1);
  }
  __device__ __forceinline__ int hi(int q) const {
    return causal ? min(q, S - 1) : S - 1;
  }
};

// The key tiles of kt keys that rows r0..r1 visit (the device's copy of
// kernels/flash_attention.py::flash_plan): [begin, end), each holding a
// key that some live row (< S) sees, and masked(t) unless every key of
// tile t is visible to every live row.
struct Tiles {
  int kt, begin = 0, end = 0;
  int lo_last = 0, hi_first = -1;   // the keys every live row sees
  __device__ __forceinline__ Tiles(const Mask& mk, int r0, int r1,
                                   int keys = BK)
      : kt(keys) {
    r1 = min(r1, mk.S - 1);
    if (r0 > r1) return;
    lo_last = mk.lo(r1);
    hi_first = mk.hi(r0);
    // lo and hi rise with the row: the rows that see a key are one run,
    // and so are the keys they see
    int a = r0, b = r1;
    if (mk.window >= 0) {
      if (mk.causal) {
        if (mk.window == 0) return;
      } else {
        b = min(b, mk.S + mk.window - 2);   // rows past it see nothing
      }
    }
    if (a > b) return;
    begin = mk.lo(a) / kt;
    end = mk.hi(b) / kt + 1;
  }
  __device__ __forceinline__ bool masked(int t) const {
    return !(t * kt >= lo_last && t * kt + kt - 1 <= hi_first);
  }
};

// s = NEG_INF where the key is not visible to the row: fragment rows
// (lane / 4, lane / 4 + 8) see keys lo[r] .. hi[r]; k0 is the tile's first
// key
template <int N8>
__device__ __forceinline__ void apply_mask(float (&s)[N8][4], int k0,
                                           const int (&lo)[2],
                                           const int (&hi)[2]) {
  const int col = k0 + (threadIdx.x & 3) * 2;
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = col + n * 8 + (e & 1);
      if (key < lo[e >> 1] || key > hi[e >> 1]) s[n][e] = NEG_INF;
    }
}

// this lane's two fragment rows of the 16 from row0: their visible keys
// (none for a row past S)
__device__ __forceinline__ void row_spans(const Mask& mk, int row0,
                                          int (&lo)[2], int (&hi)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + ((threadIdx.x & 31) >> 2) + 8 * r;
    lo[r] = mk.window < 0 ? 0 : q - mk.window + 1;
    hi[r] = q < mk.S ? mk.hi(q) : -1;
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 64, 80, 128: TMA and wgmma
// ---------------------------------------------------------------------------

struct FlashMaps {   // built on the host, passed by value (__grid_constant__)
  CUtensorMap q;     // [B*H, S, hd]: box 64 x rows x 1
  CUtensorMap k;     //               box 64 x 64 x 1
  CUtensorMap v;
};

struct FlashArgs {
  bf16* out;
  int S, causal, window;
  float scale_log2;
  int BH, blocks, items;   // heads, query blocks per head, BH * blocks
};

// NWG consumer warpgroups of 64 query rows each, then the producer
// warpgroup, whose first warp issues the TMA loads. A CTA of 128 rows
// takes key tiles of 128 (each S = Q K^T one m64n128 product per k-step),
// one of 64 rows tiles of 64, so that two such CTAs fit an SM.
template <int HD, int NWG>
struct Fw {
  static constexpr int R = 64 * NWG;                 // query rows per CTA
  static constexpr int KT = 64 * NWG;                // keys per tile
  static constexpr int NT = 128 * (NWG + 1);
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;
  static constexpr int BLOCKS = (HD + 63) / 64;      // 64-column blocks
  static constexpr uint32_t Q_BLOCK = R * 128;       // one block of Q
  static constexpr uint32_t KV_BLOCK = KT * 128;
  static constexpr uint32_t KV_BYTES = BLOCKS * KV_BLOCK;   // a K or V tile
  // as many stages (up to 4) as fit MIN_BLOCKS CTAs in one SM's 228 KB,
  // each CTA with its 1 KB reserved, its barriers and 1 KB of alignment
  static constexpr int BUDGET =
      (233472 / MIN_BLOCKS - 1024 < 232448 ? 233472 / MIN_BLOCKS - 1024
                                           : 232448) - 256;
  static constexpr int STAGES_FIT =
      (BUDGET - 1024 - BLOCKS * (int)Q_BLOCK) / (2 * (int)KV_BYTES);
  static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static constexpr size_t SMEM =   // + 1024: room to align the blocks
      1024 + BLOCKS * Q_BLOCK + 2 * STAGES * KV_BYTES;
  // Every thread's registers at entry: 65536 / (NT * MIN_BLOCKS), rounded
  // down to 8 (128, 168). The producer warpgroup gives back what the
  // consumers take; setmaxnreg.inc waits for ever if they would take more
  // than there is.
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = NWG == 1 ? 216 : 232;
  static_assert(128 * PRODUCER_REGS + 128 * NWG * CONSUMER_REGS <=
                    NT * (65536 / (NT * MIN_BLOCKS) / 8 * 8),
                "setmaxnreg: the consumers would take more than is given");
};

struct FlashBars {
  uint32_t q, qe;     // Q landed, Q read (into registers) by every warp
  uint32_t k, v, e;   // per stage: K landed, V landed, stage free
};

// shared-memory addresses: 1024-byte aligned Q blocks, then the K stages
// and the V stages
struct FlashSmem {
  uint32_t q, k, v;
  template <typename W>
  static __device__ __forceinline__ FlashSmem make(unsigned char* raw) {
    const uint32_t at = wg::smem_u32(raw);
    FlashSmem sm;
    sm.q = (at + 1023) & ~1023u;
    sm.k = sm.q + W::BLOCKS * W::Q_BLOCK;
    sm.v = sm.k + W::STAGES * W::KV_BYTES;
    return sm;
  }
};

// The work items of this CTA: a persistent CTA per SM (two at 64 rows)
// takes items blockIdx.x, then 2 G - 1 - blockIdx.x, 2 G + blockIdx.x, ...
// (G CTAs; rounds alternate in direction), so that each CTA's sum of
// causal lengths is about the mean. Item w is query block
// blocks - 1 - w / BH (the longest first) of head w % BH.
struct Item {
  int bh, q0;
  __device__ __forceinline__ static bool at(const FlashArgs& a, int round,
                                            int rows, Item& it) {
    const int G = gridDim.x, c = blockIdx.x;
    const int w = round * G + ((round & 1) ? G - 1 - c : c);
    if (w >= a.items) return false;
    it.bh = w % a.BH;
    it.q0 = (a.blocks - 1 - w / a.BH) * rows;
    return true;
  }
};

// The TMA thread: for each item its Q tile, once every consumer warp has
// read the last one into registers, then its tiles into the ring, a stage
// reloaded once every consumer warp has released it. The ring runs on
// across items, so an item's first tiles load while the last one ends.
template <typename W>
__device__ __forceinline__ void produce(const FlashMaps& maps,
                                        const FlashArgs& a,
                                        const FlashSmem& sm,
                                        const FlashBars& bar) {
  wg::prefetch_map(&maps.q);
  wg::prefetch_map(&maps.k);
  wg::prefetch_map(&maps.v);
  const Mask mk{a.S, a.causal, a.window};
  int ring = 0, loaded = 0;   // tiles and Q tiles loaded so far
  Item it;
  for (int round = 0; Item::at(a, round, W::R, it); ++round) {
    const Tiles cta(mk, it.q0, it.q0 + W::R - 1, W::KT);
    if (cta.begin == cta.end) continue;   // no row sees a key: no load
    wg::mbar_wait(bar.qe, (loaded & 1) ^ 1);
    wg::mbar_expect(bar.q, W::BLOCKS * W::Q_BLOCK);
#pragma unroll
    for (int j = 0; j < W::BLOCKS; ++j)
      wg::tma_load(sm.q + j * W::Q_BLOCK, &maps.q, bar.q, j * 64, it.q0,
                   it.bh);
    ++loaded;
    for (int t = cta.begin; t < cta.end; ++t, ++ring) {
      const int s = ring % W::STAGES;
      wg::mbar_wait(bar.e + 8 * s, ((ring / W::STAGES) & 1) ^ 1);
      wg::mbar_expect(bar.k + 8 * s, W::KV_BYTES);
#pragma unroll
      for (int j = 0; j < W::BLOCKS; ++j)
        wg::tma_load(sm.k + s * W::KV_BYTES + j * W::KV_BLOCK, &maps.k,
                     bar.k + 8 * s, j * 64, t * W::KT, it.bh);
      wg::mbar_expect(bar.v + 8 * s, W::KV_BYTES);
#pragma unroll
      for (int j = 0; j < W::BLOCKS; ++j)
        wg::tma_load(sm.v + s * W::KV_BYTES + j * W::KV_BLOCK, &maps.v,
                     bar.v + 8 * s, j * 64, t * W::KT, it.bh);
    }
  }
}

// P in bf16 as the A registers of P V: the S accumulator of 16 keys packs
// unchanged
template <int K16>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[K16][4],
                                       const float (&sc)[2 * K16][4]) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    pf[kk][0] = tile::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
    pf[kk][1] = tile::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
    pf[kk][2] = tile::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
    pf[kk][3] = tile::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
  }
}

// The A registers of S = Q K^T for this warp's 16 rows (row0 .. of the
// CTA's Q tile, 64-column blocks QB bytes apart), by ldmatrix from the
// swizzled tile: k-step kk is 16-byte chunks 2 kk and 2 kk + 1 of a row,
// chunk c of row r stored at (c ^ (r % 8)) * 16 in its block. Q in
// registers spares each S = Q K^T a second operand read from shared memory.
template <int HD, uint32_t QB>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[HD / 16][4],
                                             uint32_t q, int row0) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = 2 * kk + (lane >> 4);
    const uint32_t at =
        q + (c >> 3) * QB + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(qf[kk][0]), "=r"(qf[kk][1]), "=r"(qf[kk][2]), "=r"(qf[kk][3])
        : "r"(at));
  }
}

// The A registers of an asynchronous product stay its own until it has
// completed: called after wait<>(), this keeps them live (and unwritten)
// up to there.
template <int K16>
__device__ __forceinline__ void keep_regs(uint32_t (&r)[K16][4]) {
#pragma unroll
  for (int i = 0; i < K16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2): while one runs its softmax, the other's products keep
// the tensor cores busy.
__device__ __forceinline__ void turn_wait(int grp) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + grp) : "memory");
}
__device__ __forceinline__ void turn_pass(int grp) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - grp) : "memory");
}

// A consumer warpgroup, for each item: its 64 query rows, S = Q K^T and
// O += P V on the tensor cores per tile, the online softmax in registers,
// the mask only on the tiles its plan marks; P V of one tile in flight
// while the softmax of the next runs.
template <int HD, typename W>
__device__ __forceinline__ void consume(const FlashArgs& a,
                                        const FlashSmem& sm,
                                        const FlashBars& bar) {
  constexpr int KT = W::KT;
  constexpr bool PP = W::R == 128;   // two warpgroups take turns
  const int grp = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const Mask mk{a.S, a.causal, a.window};
  uint32_t qf[HD / 16][4];
  auto issue_qk = [&](float (&sc)[KT / 8][4], int pos) {
    const uint32_t kt = sm.k + (pos % W::STAGES) * W::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wg::mma_rs_k<KT>(sc, qf[kk], wg::desc_k(kt, kk, W::KV_BLOCK), kk > 0);
    wg::commit();
  };
  auto issue_pv = [&](float (&o)[HD / 8][4],
                      const uint32_t (&pf)[KT / 16][4], int pos) {
    const uint32_t vt = sm.v + (pos % W::STAGES) * W::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wg::mma_rs<HD>(o, pf[kk], wg::desc_mn(vt, kk, W::KV_BLOCK));
    wg::commit();
  };
  auto turn = [&](auto&& issue) {
    if constexpr (PP) turn_wait(grp);
    wg::fence();
    issue();
    if constexpr (PP) turn_pass(grp);
  };
  auto release = [&](int pos) {   // the stage's tiles are read
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(bar.e + 8 * (pos % W::STAGES));
  };
  auto landed = [&](uint32_t b, int pos) {
    wg::mbar_wait(b + 8 * (pos % W::STAGES), (pos / W::STAGES) & 1);
  };

  if constexpr (PP) {
    if (grp == 1) turn_pass(1);   // the first turn is warpgroup 0's
  }
  int ring = 0, read = 0;   // tiles and Q tiles consumed so far
  Item it;
  for (int round = 0; Item::at(a, round, W::R, it); ++round) {
    // Every warpgroup computes each of the item's tiles (ring position
    // ring + i is tile cta.begin + i), masking those its own rows do not
    // see whole: a tile none of them sees comes out as p = 0, and the
    // turns pair up.
    const Tiles cta(mk, it.q0, it.q0 + W::R - 1, KT);
    const int g0 = it.q0 + 64 * grp;         // the warpgroup's first row
    const Tiles own(mk, g0, g0 + 63, KT);
    int lo[2], hi[2];
    row_spans(mk, g0 + 16 * warp, lo, hi);
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const int n = cta.end - cta.begin;
    if (n > 0) {
      float sc[KT / 8][4], alpha[2];
      uint32_t pf[KT / 16][4];
      wg::mbar_wait(bar.q, read & 1);
      load_q_frags<HD, W::Q_BLOCK>(qf, sm.q, grp * 64 + 16 * warp);
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(bar.qe);   // Q may be reloaded
      ++read;
      landed(bar.k, ring);
      turn([&] { issue_qk(sc, ring); });
      wg::wait<0>();
      wg::fence_regs(sc);
      if (own.masked(cta.begin)) apply_mask(sc, cta.begin * KT, lo, hi);
      tile::softmax_p(sc, m, l, a.scale_log2, alpha);   // o is zero
      pack_p(pf, sc);
      for (int i = 1; i < n; ++i) {
        const int pos = ring + i;
        landed(bar.k, pos);
        landed(bar.v, pos - 1);
        turn([&] {
          issue_qk(sc, pos);
          issue_pv(o, pf, pos - 1);
        });
        wg::wait<1>();          // S of tile i; P V of tile i - 1 in flight
        wg::fence_regs(sc);
        if (own.masked(cta.begin + i))
          apply_mask(sc, (cta.begin + i) * KT, lo, hi);
        tile::softmax_p(sc, m, l, a.scale_log2, alpha);
        wg::wait<0>();
        wg::fence_regs(o);
        keep_regs(pf);   // P V read them until now
        release(pos - 1);
        tile::rescale<HD>(o, alpha);
        pack_p(pf, sc);
      }
      const int last = ring + n - 1;
      landed(bar.v, last);
      turn([&] { issue_pv(o, pf, last); });
      wg::wait<0>();
      wg::fence_regs(o);
      release(last);
      ring += n;
    }
    tile::finalize<HD>(o, l);
    const int row0 = g0 + 16 * warp;
    bf16* out = a.out + (size_t)it.bh * a.S * HD;
    tile::store_rows<HD>(o, [&](int r) -> bf16* {
      const int q = row0 + r;
      return q < a.S ? out + (size_t)q * HD : nullptr;
    });
  }
  if constexpr (PP) {
    if (grp == 0) turn_wait(0);   // warpgroup 1's last pass
  }
}

template <int HD, int NWG>
__global__ void __launch_bounds__(Fw<HD, NWG>::NT, Fw<HD, NWG>::MIN_BLOCKS)
    flash_wgmma_kernel(__grid_constant__ const FlashMaps maps,
                       const FlashArgs a) {
  using W = Fw<HD, NWG>;
  extern __shared__ __align__(1024) unsigned char fw_smem[];
  __shared__ __align__(8) uint64_t bars[2 + 3 * W::STAGES];
  const FlashSmem sm = FlashSmem::make<W>(fw_smem);
  const uint32_t b0 = wg::smem_u32(bars);
  const FlashBars bar{b0, b0 + 8, b0 + 16, b0 + 16 + 8 * W::STAGES,
                      b0 + 16 + 16 * W::STAGES};
  if (threadIdx.x == 0) {
    wg::mbar_init(bar.q, 1);
    wg::mbar_init(bar.qe, 4 * NWG);   // lane 0 of each consumer warp
    for (int s = 0; s < W::STAGES; ++s) {
      wg::mbar_init(bar.k + 8 * s, 1);
      wg::mbar_init(bar.v + 8 * s, 1);
      wg::mbar_init(bar.e + 8 * s, 4 * NWG);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  // one branch per role, to the end (setmaxnreg needs the roles apart)
  if (threadIdx.x >= 128 * NWG) {
    wg::regs_dec<W::PRODUCER_REGS>();
    if (threadIdx.x == 128 * NWG) produce<W>(maps, a, sm, bar);
  } else {
    wg::regs_inc<W::CONSUMER_REGS>();
    consume<HD, W>(a, sm, bar);
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 32: the mma.sync tile
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int MT = 2;                       // 16-row blocks per warp
constexpr int TC_ROWS = 16 * MT * TC_WARPS; // query rows per CTA
constexpr int TC_NT = 32 * TC_WARPS;
constexpr int STAGES = 2;                   // K/V tiles in the ring

template <int HD>
constexpr size_t tc_smem() {   // Q tile + the ring of K and V tiles
  return sizeof(bf16) * tile::row_elems<HD>() * (TC_ROWS + 2 * STAGES * BK);
}

// rows [row0, row0 + R) of one head's [S, HD] matrix -> swizzled tile
template <int HD, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int S) {
#pragma unroll
  for (int i = threadIdx.x; i < R * HD / 8; i += TC_NT) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    const bool ok = row0 + r < S;
    tile::cp_async16(dst + tile::swz<HD>(r, c),
                     src + (size_t)(ok ? row0 + r : 0) * HD + c * 8, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(TC_NT, 2)
    flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    int S, int causal, int window, float scale_log2) {
  constexpr int RS = tile::row_elems<HD>();   // a shared-memory row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [TC_ROWS, RS]
  bf16* k_s = q_s + TC_ROWS * RS;                   // [STAGES][BK, RS]
  bf16* v_s = k_s + STAGES * BK * RS;               // [STAGES][BK, RS]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // longest first
  const int warp = threadIdx.x >> 5;
  const size_t head = (size_t)bh * S * HD;
  const int wr0 = warp * 16 * MT;                 // the warp's first row
  const Mask mk{S, causal, window};
  const Tiles cta(mk, q0, q0 + TC_ROWS - 1);
  const Tiles own(mk, q0 + wr0, q0 + wr0 + 16 * MT - 1);
  int lo[MT][2], hi[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) row_spans(mk, q0 + wr0 + 16 * mt, lo[mt],
                                            hi[mt]);

  float o[MT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }

  // one commit group per tile (empty past the end), so that "tile kt has
  // landed" is always "at most STAGES - 2 groups pending"
  auto issue = [&](int kt) {
    if (kt < cta.end) {
      const int st = (kt - cta.begin) % STAGES;
      load_rows<HD, BK>(k_s + st * BK * RS, k + head, kt * BK, S);
      load_rows<HD, BK>(v_s + st * BK * RS, v + head, kt * BK, S);
    }
    tile::cp_async_commit();
  };
  if (cta.begin < cta.end) {
    load_rows<HD, TC_ROWS>(q_s, q + head, q0, S);
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) issue(cta.begin + i);
  }
  for (int kt = cta.begin; kt < cta.end; ++kt) {
    const int st = (kt - cta.begin) % STAGES;
    tile::cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    issue(kt + STAGES - 1);   // into the stage tile kt - 1 left
    if (kt < own.begin || kt >= own.end) continue;   // none of its rows
    float s[MT][BK / 8][4];
    tile::qk<HD, MT>(s, q_s, wr0, k_s + st * BK * RS);
    if (own.masked(kt)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        apply_mask(s[mt], kt * BK, lo[mt], hi[mt]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      tile::online_softmax<HD>(s[mt], o[mt], m[mt], l[mt], scale_log2);
    tile::pv<HD, MT>(o, s, v_s + st * BK * RS);
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    tile::finalize<HD>(o[mt], l[mt]);
    tile::store_rows<HD>(o[mt], [&](int r) -> bf16* {
      const int qp = q0 + wr0 + mt * 16 + r;
      return qp < S ? out + head + (size_t)qp * HD : nullptr;
    });
  }
}

// ---------------------------------------------------------------------------
// f32: the tensor cores in 3xTF32
// ---------------------------------------------------------------------------

constexpr int F_WARPS = 4;
constexpr int F_MT = 2;                        // 16-row blocks per warp
constexpr int F_ROWS = 16 * F_MT * F_WARPS;    // query rows per CTA
constexpr int F_NT = 32 * F_WARPS;
constexpr int F_STAGES = 2;

// a staged f32 row: hd + 4 floats, so that the 8 rows x 4 columns of a
// fragment read fall in 32 different banks (hd + 4 is 4 or 20 mod 32)
template <int HD>
__host__ __device__ constexpr int f_ld() {
  return HD + 4;
}

template <int HD>
constexpr size_t f32_smem() {
  return sizeof(float) * f_ld<HD>() * (F_ROWS + 2 * F_STAGES * BK);
}

// rows [row0, row0 + R) of one head's [S, HD] f32 matrix -> padded rows
template <int HD, int R>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int row0, int S) {
#pragma unroll 4
  for (int i = threadIdx.x; i < R * HD / 4; i += F_NT) {
    const int r = i / (HD / 4), c = i % (HD / 4);
    const bool ok = row0 + r < S;
    tile::cp_async16(dst + r * f_ld<HD>() + c * 4,
                     src + (size_t)(ok ? row0 + r : 0) * HD + c * 4, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(F_NT)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int S, int causal, int window, float scale_log2) {
  constexpr int LD = f_ld<HD>();
  extern __shared__ __align__(16) float f_smem[];
  float* q_s = f_smem;                  // [F_ROWS, LD]
  float* k_s = q_s + F_ROWS * LD;       // [F_STAGES][BK, LD]
  float* v_s = k_s + F_STAGES * BK * LD;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F_ROWS;   // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)bh * S * HD;
  const int wr0 = warp * 16 * F_MT;
  const Mask mk{S, causal, window};
  const Tiles cta(mk, q0, q0 + F_ROWS - 1);
  const Tiles own(mk, q0 + wr0, q0 + wr0 + 16 * F_MT - 1);
  int lo[F_MT][2], hi[F_MT][2];
#pragma unroll
  for (int mt = 0; mt < F_MT; ++mt)
    row_spans(mk, q0 + wr0 + 16 * mt, lo[mt], hi[mt]);

  float o[F_MT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < F_MT; ++mt)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  float m[F_MT][2], l[F_MT][2];
#pragma unroll
  for (int mt = 0; mt < F_MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }

  auto issue = [&](int kt) {
    if (kt < cta.end) {
      const int st = (kt - cta.begin) % F_STAGES;
      load_rows_f32<HD, BK>(k_s + st * BK * LD, k + head, kt * BK, S);
      load_rows_f32<HD, BK>(v_s + st * BK * LD, v + head, kt * BK, S);
    }
    tile::cp_async_commit();
  };
  if (cta.begin < cta.end) {
    load_rows_f32<HD, F_ROWS>(q_s, q + head, q0, S);
#pragma unroll
    for (int i = 0; i < F_STAGES - 1; ++i) issue(cta.begin + i);
  }
  for (int kt = cta.begin; kt < cta.end; ++kt) {
    const int st = (kt - cta.begin) % F_STAGES;
    tile::cp_async_wait<F_STAGES - 2>();
    __syncthreads();
    issue(kt + F_STAGES - 1);
    if (kt < own.begin || kt >= own.end) continue;
    const float* ks = k_s + st * BK * LD;
    const float* vs = v_s + st * BK * LD;
    // S = Q K^T: k-steps of 8 hd columns; each K fragment serves both
    // row blocks
    float s[F_MT][BK / 8][4];
#pragma unroll
    for (int mt = 0; mt < F_MT; ++mt)
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < HD / 8; ++kk) {
      unsigned ab[F_MT][4], as[F_MT][4];
#pragma unroll
      for (int mt = 0; mt < F_MT; ++mt) {
        const float* qr = q_s + (wr0 + 16 * mt + g) * LD + kk * 8 + t;
        tf32::split_tf32(qr[0], ab[mt][0], as[mt][0]);
        tf32::split_tf32(qr[8 * LD], ab[mt][1], as[mt][1]);
        tf32::split_tf32(qr[4], ab[mt][2], as[mt][2]);
        tf32::split_tf32(qr[8 * LD + 4], ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float* kr = ks + (n * 8 + g) * LD + kk * 8 + t;
        unsigned bb[2], bs[2];
        tf32::split_tf32(kr[0], bb[0], bs[0]);
        tf32::split_tf32(kr[4], bb[1], bs[1]);
#pragma unroll
        for (int mt = 0; mt < F_MT; ++mt)
          tf32::mma_3xtf32(s[mt][n], ab[mt], as[mt], bb, bs);
      }
    }
    if (own.masked(kt)) {
#pragma unroll
      for (int mt = 0; mt < F_MT; ++mt)
        apply_mask(s[mt], kt * BK, lo[mt], hi[mt]);
    }
#pragma unroll
    for (int mt = 0; mt < F_MT; ++mt)
      tile::online_softmax<HD>(s[mt], o[mt], m[mt], l[mt], scale_log2);
    // O += P V: 8-key steps; this lane holds p of keys 2t and 2t + 1 of
    // each step (the S layout), which are the A columns t and t + 4 when
    // the step's keys are taken in the order 0, 2, 4, 6, 1, 3, 5, 7
#pragma unroll 2
    for (int kk = 0; kk < BK / 8; ++kk) {
      unsigned ab[F_MT][4], as[F_MT][4];
#pragma unroll
      for (int mt = 0; mt < F_MT; ++mt) {
        tf32::split_tf32(s[mt][kk][0], ab[mt][0], as[mt][0]);
        tf32::split_tf32(s[mt][kk][2], ab[mt][1], as[mt][1]);
        tf32::split_tf32(s[mt][kk][1], ab[mt][2], as[mt][2]);
        tf32::split_tf32(s[mt][kk][3], ab[mt][3], as[mt][3]);
      }
      const float* vr = vs + (kk * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        unsigned bb[2], bs[2];
        tf32::split_tf32(vr[n * 8], bb[0], bs[0]);
        tf32::split_tf32(vr[LD + n * 8], bb[1], bs[1]);
#pragma unroll
        for (int mt = 0; mt < F_MT; ++mt)
          tf32::mma_3xtf32(o[mt][n], ab[mt], as[mt], bb, bs);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < F_MT; ++mt) {
    tile::finalize<HD>(o[mt], l[mt]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = q0 + wr0 + 16 * mt + g + 8 * r;
      if (qp >= S) continue;
      float* dst = out + head + (size_t)qp * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(o[mt][n][2 * r], o[mt][n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int HD, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int BH, int S, int causal, int window, float scale,
                 cudaStream_t stream) {
  using W = Fw<HD, NWG>;
  const uint64_t dims[3] = {HD, (uint64_t)S, (uint64_t)BH};
  const uint64_t strides[2] = {HD, (uint64_t)S * HD};
  const uint32_t qbox[3] = {64, (uint32_t)W::R, 1};
  const uint32_t kvbox[3] = {64, (uint32_t)W::KT, 1};
  FlashMaps maps;
  if (!wg::tensor_map(&maps.q, false, q, 3, dims, strides, qbox) ||
      !wg::tensor_map(&maps.k, false, k, 3, dims, strides, kvbox) ||
      !wg::tensor_map(&maps.v, false, v, 3, dims, strides, kvbox))
    return (int)cudaErrorInvalidValue;
  const int blocks = (S + W::R - 1) / W::R;
  const FlashArgs a{(bf16*)out, S,      causal,     window,
                    scale * tile::LOG2E, BH, blocks, BH * blocks};
  // one persistent CTA per SM (two at 64 rows), or one per item
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = a.items < sms * W::MIN_BLOCKS ? a.items
                                                 : sms * W::MIN_BLOCKS;
  cudaFuncSetAttribute(flash_wgmma_kernel<HD, NWG>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)W::SMEM);
  flash_wgmma_kernel<HD, NWG><<<grid, W::NT, W::SMEM, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tile_face(const void* q, const void* k, const void* v, void* out,
                     int BH, int S, int causal, int window, float scale,
                     cudaStream_t stream) {
  constexpr size_t smem = tc_smem<HD>();
  cudaFuncSetAttribute(flash_tc_kernel<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid(BH, (S + TC_ROWS - 1) / TC_ROWS);
  flash_tc_kernel<HD><<<grid, TC_NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, S, causal,
      window, scale * tile::LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32_face(const void* q, const void* k, const void* v, void* out,
                    int BH, int S, int causal, int window, float scale,
                    cudaStream_t stream) {
  constexpr size_t smem = f32_smem<HD>();
  cudaFuncSetAttribute(flash_f32_kernel<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid(BH, (S + F_ROWS - 1) / F_ROWS);
  flash_f32_kernel<HD><<<grid, F_NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S,
      causal, window, scale * tile::LOG2E);
  return (int)cudaGetLastError();
}

// The faces, by the host's route (kernels/flash_attention.py::flash_face
// and flash_rows, from head dim, dtype and shape only):
//   bf16, rows 64 or 128, hd 64/80/128: flash_wgmma_kernel;
//   bf16, rows 0, hd 32:                flash_tc_kernel (mma.sync);
//   f32, rows 0, every hd:              flash_f32_kernel (3xTF32).
// Any other combination is refused.
template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int BH,
              int S, int bf16_io, int causal, int window, float scale,
              int rows, cudaStream_t stream) {
  if (!bf16_io) {
    if (rows != 0) return (int)cudaErrorInvalidValue;
    return launch_f32_face<HD>(q, k, v, out, BH, S, causal, window, scale,
                               stream);
  }
  if constexpr (HD == 32) {
    if (rows != 0) return (int)cudaErrorInvalidValue;
    return launch_tile_face<HD>(q, k, v, out, BH, S, causal, window, scale,
                                stream);
  } else {
    if (rows == 128)
      return launch_wgmma<HD, 2>(q, k, v, out, BH, S, causal, window, scale,
                                 stream);
    if (rows == 64)
      return launch_wgmma<HD, 1>(q, k, v, out, BH, S, causal, window, scale,
                                 stream);
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success, or an error for a refused combination or tensor map). q, k, v,
// out [BH, S, hd], contiguous (bf16 ones 16-byte aligned for the tensor
// maps), all f32 (bf16 = 0) or all bf16 (bf16 = 1). window < 0: no sliding
// window. rows: the wgmma face's query rows per CTA, 64 or 128 (bf16 at hd
// 64, 80, 128), or 0 (the other faces).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int BH, int S,
                                     int hd, int bf16, int causal,
                                     int window, float scale, int rows,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch_hd<32>(q, k, v, out, BH, S, bf16, causal, window, scale,
                           rows, st);
    case 64:
      return launch_hd<64>(q, k, v, out, BH, S, bf16, causal, window, scale,
                           rows, st);
    case 80:
      return launch_hd<80>(q, k, v, out, BH, S, bf16, causal, window, scale,
                           rows, st);
    case 128:
      return launch_hd<128>(q, k, v, out, BH, S, bf16, causal, window, scale,
                            rows, st);
  }
  return (int)cudaErrorInvalidValue;
}
