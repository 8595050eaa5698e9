// Fused STEP step scorer: sigmoid(relu(h @ W1 + b1) @ W2 + b2) in f32, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/step_score.py::_scorer_kernel
// (pallas_call at step_score.py:55), which the engine fuses into every
// decode iteration of the kernel path. The Pallas kernel keeps all of W1
// in one core's VMEM; here W1 is spread over the whole card.
//
// What bounds it on the H100: bytes, and before them latency. The body is
// a [B, D] x [D, Hd] product with Hd = 512; at the serve phases' decode
// batch (B = 16, D = 2560) it does 2*B*D*Hd = 42 MFLOP over the 5.2 MB
// of f32 W1: 1.6 us to read W1 at 3.35 TB/s against 0.6 us of f32
// operations at 67 TFLOP/s. W1 is cold when the scorer runs (the model's
// weights stream through L2 between two calls), so the W1 read has to go
// at the card's rate, spread over the card, in one wave. Timed by phase
// from a cold L2 (%globaltimer stamps), every CTA's W1 and h land
// together near the end of the read (each CTA's requests queue behind
// all the others'), so the products cannot hide under it: on the CUDA
// cores in f32 they added 1.5 us after it. They run on the tensor cores
// (mma.sync) instead, at about f32's accuracy (plain TF32 or one bf16
// piece would round the scorer's inputs past the scores' 1e-5
// tolerance): a bf16 h is exact in bf16 and meets W1 in three bf16 pieces
// (hi + mid + lo = W1 to f32's precision), an f32 h takes 3xTF32
// (tf32.cuh).
//
// Design: one grid over the card and a one-CTA finish, deterministic (no
// float atomics: the scores decide which trace is pruned, so two calls,
// and a graph replay against an eager call, are bitwise equal).
// kernels/step_score.py::score_plan picks the grid from (B, D, Hd) and the
// clusters the card runs at once:
//   * A cluster of S CTAs owns one hidden tile of HT = 32 units; its CTAs
//     split D. Each CTA takes an SM of its own (at least ONE_PER_SM of
//     shared memory): an H100 places at most 15 clusters of 7 or 8 on
//     distinct SMs, so 16 tiles x 8 put 16 CTAs two to an SM, and those
//     finished ~1.4 us after the rest; 16 x 6 = 96 CTAs on distinct SMs
//     measured faster at every timed shape. At the serve shape each CTA
//     holds a [448, 32] f32 block of W1 (56 KB).
//   * W1 by TMA: each of a CTA's 8 warps owns `rows` consecutive rows of
//     its block, one box of a 2-D tensor map over W1 (zeros past D) on
//     the warp's own mbarrier; every box is put in flight at entry. More,
//     smaller boxes measured slower (the TMA unit spends about as long on
//     a 1 KB box as on a 5 KB one). Where a box would pass 256 rows or the
//     CTA 227 KB, it runs in `passes`, each warp reloading its box.
//   * Meanwhile each warp loads its rows of h as they are (all of its
//     loads in flight at once) and stores them lane-major ([lane][row], a
//     stride of 4 mod 8 words: no bank conflict).
//   * Products: per 16 rows (bf16 h) or 8 (f32 h), mma.sync with the
//     lanes as M (tiles of 16; lanes go through the CTA in lane tiles of
//     16, 32 or 64), the units as N with unit 4g + n at column g of n-tile
//     n, so that one float4 of a W1 row feeds four n-tiles and a thread's
//     accumulators hold 8 consecutive units.
//   * Partials merged on chip: the 8 warps' [BT, HT] partials are summed
//     in warp order through shared memory; then each CTA pushes its
//     partial of lane b to the CTA of rank b % S by distributed shared
//     memory, and after one cluster barrier each CTA sums its lanes over
//     the cluster in rank order, adds b1, applies the ReLU and takes the
//     dot with W2's slice (a warp per lane, a fixed shuffle tree): one
//     partial logit per (tile, lane), stored to a [tiles, B] workspace.
//   * The tiles' logits are summed in tile order, b2 added and the sigmoid
//     taken by a second, one-CTA launch, a programmatic dependent of the
//     first (griddepcontrol): it is scheduled while the first runs and
//     waits for it to finish before reading the logits. It needs no state
//     that outlives a call, so graph replays and calls on two streams
//     cannot meet. The last CTA of the first launch at an integer counter
//     measured no faster (within 0.0004 ms either way at every timed row)
//     and needed a zeroed counter per stream and per captured call.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_wgmma.cuh"
#include "tf32.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NW = 8;             // warps per CTA (kernels/step_score.py)
constexpr int NT = 32 * NW;
constexpr int HT = 32;            // hidden units per cluster
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_ROWS = 256;      // W1 rows per warp and pass: one box
constexpr int MAX_SMEM = 232448;   // 227 KB of dynamic shared memory
// at least this much, so that one CTA takes an SM: two CTAs of a cluster on
// one SM measured slower than clusters on distinct SMs
constexpr int ONE_PER_SM = 118784;

// A warp's h rows, per lane: whole product steps (16 rows in bf16, 8 in
// f32) of `esize`-byte values, at least HT words (the warp's partials
// overlay them), in 4-byte words of a stride 4 mod 8, so that the A
// fragments' 32 loads (lane g, word t) fall on 32 banks
__host__ __device__ constexpr int h_words(int rows, int esize) {
  const int step = esize == 2 ? 16 : 8;
  const int need = ((rows + step - 1) / step * step * esize + 3) / 4;
  const int n = need > HT ? need : HT;
  return n + (12 - n % 8) % 8;
}

// W1 rows a warp's box takes in shared memory: whole 1 KB swizzle atoms
// (8 rows of 128 bytes), so that every box starts on a 1024-byte boundary
__host__ __device__ constexpr int w1_rows(int rows) {
  return (rows + 7) / 8 * 8;
}

// Shared memory, in bytes from the base: the warps' mbarriers, the W1
// boxes ([NW][w1_rows][HT] f32, 128-byte swizzle), each warp's h rows
// ([BT][h_words] words, then its [BT][HT] f32 partials over them), the
// partials other CTAs push to this one ([S][ceil(BT / S)][HT]); at least
// ONE_PER_SM. kernels/step_score.py::score_smem is the same sum.
struct Smem {
  int w1, h, recv, bytes;
  __host__ __device__ Smem(int rows, int bt, int S, int esize) {
    w1 = 1024;
    h = w1 + NW * w1_rows(rows) * HT * 4;
    recv = h + NW * bt * h_words(rows, esize) * 4;
    const int end = recv + S * ((bt + S - 1) / S) * HT * 4;
    bytes = end > ONE_PER_SM ? end : ONE_PER_SM;
  }
};

struct Args {
  const void* h;        // [B, D] bf16 or f32
  const float* b1;      // [Hd]
  const float* w2;      // [Hd]
  float* logits;        // [tiles, B]: each tile's partial logits
  int B, D, rows, passes;
  int vec;              // h's rows may be read 16 bytes at a time
};

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// order this thread's generic accesses to shared memory before later
// asynchronous (TMA) writes to it
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// Units 4c .. 4c + 3 of row r of a warp's W1 box, as TMA's 128-byte
// swizzle lays it: the 16-byte chunk c of row r at c ^ (r % 8). The
// B fragments' quarter-warps (rows 2t + .., chunks 2q, 2q + 1) then fall
// on 8 distinct chunks; unswizzled they met 4 ways on 2.
__device__ __forceinline__ const float* w1_at(const float* w1w, int r,
                                              int c) {
  return w1w + r * HT + 4 * (c ^ (r & 7));
}

// 3 bf16 pieces of f32 pairs: hi + mid + lo = (x, y) to f32's precision
// (each remainder is exact in f32); x (row k) in the low half
__device__ __forceinline__ void split3(float x, float y, unsigned (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(p[i]) : "f"(y), "f"(x));
    x -= __uint_as_float(p[i] << 16);
    y -= __uint_as_float(p[i] & 0xffff0000u);
  }
}

// d += a b for one 16 x 8 x 16 tile of bf16 (mma.sync's fragments)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// One warp's h, as it is (bf16 or f32): h[b0 + b, d0 + i] ->
// hw[b * stride + i] for i below `rows` rounded up to a product step (in
// blocks of 8, zeros past B, D and rows). Lane items (b, 8-row block), IT
// of them in flight at once before any is stored.
template <typename T, int BT>
__device__ __forceinline__ void stage_h(const Args& a, T* hw, int stride,
                                        int b0, int d0, int rows, int lane) {
  constexpr int IT = 4, STEP = sizeof(T) == 2 ? 16 : 8;
  constexpr int Q = sizeof(T) / 2;   // 16-byte pieces of 8 values
  const T* h = static_cast<const T*>(a.h);
  const int items = BT * ((rows + STEP - 1) / STEP * STEP / 8);
  for (int base = 0; base < items; base += 32 * IT) {
    uint4 v[IT][Q];
#pragma unroll
    for (int u = 0; u < IT; ++u) {
      const int e = base + 32 * u + lane;
      const int b = e % BT, i0 = 8 * (e / BT), d = d0 + i0;
      const bool in = e < items && b0 + b < a.B;
      const T* src = h + (size_t)(b0 + b) * a.D + d;
      if (in && a.vec && i0 + 8 <= rows && d + 8 <= a.D) {
#pragma unroll
        for (int q = 0; q < Q; ++q)
          v[u][q] = __ldg(reinterpret_cast<const uint4*>(src) + q);
      } else {
        unsigned w[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          w[k] = in && i0 + k < rows && d + k < a.D ? bits(src[k]) : 0u;
        if constexpr (Q == 1) {
          v[u][0] = make_uint4(w[0] | w[1] << 16, w[2] | w[3] << 16,
                               w[4] | w[5] << 16, w[6] | w[7] << 16);
        } else {
#pragma unroll
          for (int q = 0; q < Q; ++q)
            v[u][q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2],
                                 w[4 * q + 3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < IT; ++u) {
      const int e = base + 32 * u + lane;
      if (e < items) {
        uint4* dst = reinterpret_cast<uint4*>(hw + (e % BT) * stride +
                                              8 * (e / BT));
#pragma unroll
        for (int q = 0; q < Q; ++q) dst[q] = v[u][q];
      }
    }
  }
}

template <typename T, int MT>   // MT m-tiles of 16 lanes per lane tile
__global__ void __launch_bounds__(NT, 1)
    score_kernel(const __grid_constant__ CUtensorMap w1map, const Args a) {
  constexpr int BT = 16 * MT;
  extern __shared__ __align__(1024) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x, rank = blockIdx.x;   // the cluster spans grid x
  const int tile = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // mma.sync's fragment coordinates
  constexpr bool BF16 = sizeof(T) == 2;
  const int rows = a.rows, span = NW * rows;
  const int hwords = h_words(rows, sizeof(T));   // per lane
  const Smem L(rows, BT, S, sizeof(T));
  const uint32_t bar = wg::smem_u32(smem) + 8 * warp;
  float* w1w =
      reinterpret_cast<float*>(smem + L.w1) + warp * w1_rows(rows) * HT;
  T* hw = reinterpret_cast<T*>(smem + L.h + warp * BT * hwords * 4);
  float* recv = reinterpret_cast<float*>(smem + L.recv);
  // the second launch may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  cluster_arrive_relaxed();   // "this CTA runs": the pushes wait for it
  const int cta0 = rank * a.passes * span, col0 = tile * HT;
  const int first = cta0 + warp * rows;   // this warp's first row
  auto load_box = [&](int r0) {   // lane 0: this warp's box from row r0
    wg::mbar_expect(bar, rows * HT * 4);
    tma_load_2d(wg::smem_u32(w1w), &w1map, bar, col0, r0);
  };
  if (lane == 0) {
    wg::prefetch_map(&w1map);
    wg::mbar_init(bar, 1);
    wg::mbar_init_fence();
    if (first < a.D) load_box(first);
  }
  __syncwarp();
  // what the owner step reads, fetched while W1 streams in: b1 and W2 of
  // unit col0 + lane
  const float b1v = a.b1[col0 + lane], w2v = a.w2[col0 + lane];
  const bool reload = a.passes > 1;
  // the passes whose rows start below D: the box's loads per lane tile
  const int loads =
      first < a.D ? min(a.passes, (a.D - first + span - 1) / span) : 0;
  const int nq = (BT + S - 1) / S;   // lanes each CTA owns per lane tile
  const int nlt = (a.B + BT - 1) / BT;
  for (int lt = 0; lt < nlt; ++lt) {
    const int b0 = lt * BT;
    float acc[MT][4][4] = {};   // [m-tile][n-tile][fragment]
    for (int p = 0; p < loads; ++p) {
      const int r0 = first + p * span;
      if (reload && lt + p > 0) {   // the warp is done with its W1 rows
        __syncwarp();
        if (lane == 0) {
          fence_async_smem();
          load_box(r0);
        }
      }
      stage_h<T, BT>(a, hw, hwords * 4 / sizeof(T), b0, r0, rows, lane);
      __syncwarp();
      // the k-th load of the box completes its barrier's phase k
      wg::mbar_wait(bar, reload ? (lt * loads + p) & 1 : 0);
      const int nr = min(rows, a.D - r0);
      const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (BF16) {
        // 16 rows a step: h (exact in bf16) times W1 in three bf16 pieces,
        // the small pieces first. B: W1 rows k0 + 2t (+1) and k0 + 2t + 8
        // (+1), units 4g .. 4g + 3 (n-tiles 0..3, column g); rows past nr
        // are another warp's or unset
        const unsigned* hu = reinterpret_cast<const unsigned*>(hw);
        for (int k0 = 0; k0 < nr; k0 += 16) {
          float wv[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = k0 + 2 * t + (i & 1) + 8 * (i >> 1);
            const float4 v = r < nr ? ld4(w1_at(w1w, r, g)) : z4;
            wv[i][0] = v.x, wv[i][1] = v.y, wv[i][2] = v.z, wv[i][3] = v.w;
          }
          unsigned bp[4][2][3];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            split3(wv[0][n], wv[1][n], bp[n][0]);
            split3(wv[2][n], wv[3][n], bp[n][1]);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            // A: lanes 16m + g (+ 8), rows k0 + 2t (+1) and k0 + 2t + 8 (+1)
            const unsigned* hr = hu + (16 * m + g) * hwords + k0 / 2 + t;
            const unsigned av[4] = {hr[0], hr[8 * hwords], hr[4],
                                    hr[8 * hwords + 4]};
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int i = 2; i >= 0; --i)
                mma_bf16(acc[m][n], av, bp[n][0][i], bp[n][1][i]);
          }
        }
      } else {
        // 8 rows a step in 3xTF32. B: W1 rows k0 + t and k0 + t + 4,
        // units 4g .. 4g + 3 (n-tiles 0..3, column g)
        for (int k0 = 0; k0 < nr; k0 += 8) {
          const float4 wa =
              k0 + t < nr ? ld4(w1_at(w1w, k0 + t, g)) : z4;
          const float4 wb =
              k0 + t + 4 < nr ? ld4(w1_at(w1w, k0 + t + 4, g)) : z4;
          const float wv[2][4] = {{wa.x, wa.y, wa.z, wa.w},
                                  {wb.x, wb.y, wb.z, wb.w}};
          unsigned bb[4][2], bs[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              tf32::split_tf32(wv[r][n], bb[n][r], bs[n][r]);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            // A: lanes 16m + g (+ 8), rows k0 + t (+ 4)
            const float* hr =
                reinterpret_cast<const float*>(hw) + (16 * m + g) * hwords +
                k0 + t;
            const float av[4] = {hr[0], hr[8 * hwords], hr[4],
                                 hr[8 * hwords + 4]};
            unsigned ab[4], as[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) tf32::split_tf32(av[i], ab[i], as[i]);
#pragma unroll
            for (int n = 0; n < 4; ++n)
              tf32::mma_3xtf32(acc[m][n], ab, as, bb[n], bs[n]);
          }
        }
      }
    }
    // the warp's partials over its h rows: a thread holds lanes
    // 16m + g (+ 8), units 8t + n (fragment 0, 2) and 8t + 4 + n (1, 3)
    __syncwarp();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* dst = reinterpret_cast<float*>(hw) + (16 * m + g + 8 * r) * HT +
                     8 * t;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[m][0][2 * r], acc[m][1][2 * r], acc[m][2][2 * r],
                        acc[m][3][2 * r]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[m][0][2 * r + 1], acc[m][1][2 * r + 1],
                        acc[m][2][2 * r + 1], acc[m][3][2 * r + 1]);
      }
    __syncthreads();
    cluster_wait();   // every CTA runs, and is done reading its recv
    // the CTA's partials, summed in warp order, pushed to their owners
    const float* red = reinterpret_cast<const float*>(smem + L.h);
    for (int e = threadIdx.x; e < BT * HT / 4; e += NT) {
      float4 s = ld4(red + 4 * e);
#pragma unroll
      for (int w = 1; w < NW; ++w) {
        const float4 v = ld4(red + w * BT * hwords + 4 * e);
        s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
      }
      const int b = 4 * e / HT, j = 4 * e % HT;
      float* dst = cluster.map_shared_rank(recv, b % S) +
                   (rank * nq + b / S) * HT + j;
      *reinterpret_cast<float4*>(dst) = s;
    }
    cluster_arrive();   // the pushes are done
    cluster_wait();
    // this CTA's lanes b = rank + S q: the cluster's partials in rank
    // order, b1, ReLU, the dot with W2's slice
    for (int q = warp; q < nq; q += NW) {
      const int b = rank + S * q;
      if (b >= BT) break;
      float part[MAX_CLUSTER];
#pragma unroll
      for (int s = 0; s < MAX_CLUSTER; ++s)
        part[s] = s < S ? recv[(s * nq + q) * HT + lane] : 0.f;
      float z = 0.f;
#pragma unroll
      for (int s = 0; s < MAX_CLUSTER; ++s) z += part[s];
      z = fmaxf(z + b1v, 0.f) * w2v;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
      if (lane == 0 && b0 + b < a.B) a.logits[tile * a.B + b0 + b] = z;
    }
    if (lt + 1 < nlt) cluster_arrive();   // done reading recv
  }
}

// The second launch: the tiles' logits summed in tile order, once the first
// launch has finished.
__global__ void __launch_bounds__(NT)
    finish_kernel(const float* __restrict__ logits,
                  const float* __restrict__ b2, float* __restrict__ out,
                  int B, int tiles) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float bias2 = b2[0];
  for (int b = threadIdx.x; b < B; b += NT) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += logits[t * B + b];
    out[b] = 1.f / (1.f + expf(-(s + bias2)));
  }
}

// Launch (or, with `max_clusters`, ask how many clusters of this shape the
// card holds at once: cudaOccupancyMaxActiveClusters)
template <typename T, int MT>
int launch(const CUtensorMap& map, const Args& a, int S, int tiles,
           cudaStream_t st, int* max_clusters) {
  const int smem = Smem(a.rows, 16 * MT, S, sizeof(T)).bytes;
  cudaFuncSetAttribute(score_kernel<T, MT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, tiles);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(max_clusters,
                                               score_kernel<T, MT>, &cfg);
  return (int)cudaLaunchKernelEx(&cfg, score_kernel<T, MT>, map, a);
}

template <typename T>
int launch_lanes(const CUtensorMap& map, const Args& a, int S, int tiles,
                 int lane_tile, cudaStream_t st, int* max_clusters) {
  if (lane_tile == 16) return launch<T, 1>(map, a, S, tiles, st, max_clusters);
  if (lane_tile == 32) return launch<T, 2>(map, a, S, tiles, st, max_clusters);
  return launch<T, 4>(map, a, S, tiles, st, max_clusters);
}

}  // namespace

// The kernel's dynamic shared memory in bytes for `rows` W1 rows per warp,
// lane tiles of `lane_tile` lanes and clusters of `cluster` CTAs
// (kernels/step_score.py::score_smem computes the same).
extern "C" int repro_step_score_smem(int rows, int lane_tile, int cluster,
                                     int h_bf16) {
  return Smem(rows, lane_tile, cluster, h_bf16 ? 2 : 4).bytes;
}

// How many clusters of that plan the card runs at once (bf16 hidden
// states), or -1 where the runtime cannot say: one wave holds every
// cluster of a call when this is at least hidden / 32.
extern "C" int repro_step_score_max_clusters(int rows, int lane_tile,
                                             int cluster) {
  Args a = {};
  a.rows = rows;
  CUtensorMap map = {};
  int n = -1;
  if (launch_lanes<__nv_bfloat16>(map, a, cluster, 1, lane_tile, nullptr,
                                  &n) != 0)
    return -1;
  return n;
}

// Launch the scorer on `stream`; returns 0 on success, else the CUDA error
// of the refused launch (cudaErrorInvalidValue for a shape or plan the
// kernel does not take, or a tensor map cuTensorMapEncodeTiled refuses).
// h [B, D] (h_bf16: 1 for bf16, 0 for f32); w1 [D, hidden] f32, 16-byte
// aligned; b1, w2 [hidden]; b2 [1]; out [B]; logits: the [hidden / 32, B]
// f32 workspace. hidden is a multiple of 32 in [32, 1024]. The plan
// (kernels/step_score.py::score_plan): clusters of `cluster` CTAs, each
// covering passes * 8 * rows rows of W1, lane tiles of `lane_tile` (16,
// 32 or 64). A second, programmatic dependent launch sums the tiles.
extern "C" int repro_step_score(const void* h, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                void* logits, int B, int D,
                                int hidden, int h_bf16, int cluster, int rows,
                                int passes, int lane_tile, void* stream) {
  if (hidden % HT != 0 || hidden < HT || hidden > 1024 || B < 1 || D < 1 ||
      (uintptr_t)w1 % 16 != 0 || cluster < 1 || cluster > MAX_CLUSTER ||
      rows < 1 || rows > MAX_ROWS || (rows > 8 && rows % 8) || passes < 1 ||
      (lane_tile != 16 && lane_tile != 32 && lane_tile != 64) ||
      (long long)cluster * passes * NW * rows < D ||
      Smem(rows, lane_tile, cluster, h_bf16 ? 2 : 4).bytes > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)hidden, (cuuint64_t)D};
  const cuuint64_t strides[1] = {(cuuint64_t)hidden * sizeof(float)};
  const cuuint32_t box[2] = {HT, (cuuint32_t)rows};
  const cuuint32_t es[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(w1),
             dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.h = h;
  a.b1 = (const float*)b1;
  a.w2 = (const float*)w2;
  a.logits = (float*)logits;
  a.B = B, a.D = D, a.rows = rows, a.passes = passes;
  a.vec = D % (h_bf16 ? 8 : 4) == 0 && (uintptr_t)h % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = hidden / HT;
  const int err =
      h_bf16 ? launch_lanes<__nv_bfloat16>(map, a, cluster, tiles, lane_tile,
                                           st, nullptr)
             : launch_lanes<float>(map, a, cluster, tiles, lane_tile, st,
                                   nullptr);
  if (err != 0) return err;
  // the second launch may start while the first runs (Hopper's
  // programmatic dependent launch); it waits for it before reading logits
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(NT);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, finish_kernel, (const float*)logits,
                                 (const float*)b2, (float*)out, B, tiles);
}
