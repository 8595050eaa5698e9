// Mamba2 SSD (state-space duality) chunked scan: the face for Hopper
// (sm_90a) at the zoo's full width, P = 64, N = 64 or 128, chunks of 64,
// 128, 192 or 256 positions. The five-pass mma.sync kernel of ssd_scan.cu
// stays as the "tile" face for every other shape (kernels/ssd_scan.py::
// ssd_face routes by shapes alone).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:40 ::_ssd_kernel
// (pallas_call at ssd_scan.py:137). x [B, S, H, P], dt [B, S, H], A [H],
// Bm/Cm [B, S, N] (ngroups = 1), all f32; y [B, S, H, P] and the final
// state [B, H, P, N] of h_t = h_{t-1} exp(dt_t A) + dt_t x_t B_t^T,
// y_t = h_t C_t, from a zero state, per chunk of l positions (cs = the
// in-chunk cumsum of dt A):
//   state     s[p, n] = sum_j x[j, p] w_j B[j, n],  w_j = dt_j exp(cs_l - cs_j)
//   passing   h_in[c + 1] = exp(cs_l[c]) h_in[c] + s[c],  h_in[0] = 0
//   carry-in  y[i, p] = exp(cs_i) sum_n C[i, n] h_in[p, n]
//   intra     y[i, p] += sum_{j <= i} L[i, j] x[j, p],
//             L[i, j] = (C B^T)[i, j] exp(cs_i - cs_j) dt_j
//
// What bounds it on the H100: operations. At mamba2's full width (B 1,
// S 2048, H 80, N 128, l 256) the products come to ~7.8 GFLOP against
// ~89 MB of operands. The reference is f32 and plain TF32 keeps three
// digits, so every product runs as three tf32 products on the tensor
// cores (3xTF32: a_small b_big + a_big b_small + a_big b_big, each
// operand split into big = tf32(v) and small = tf32(v - big), rounded to
// nearest as cvt.rna rounds but in integer operations, small terms
// first): 495 / 3 TFLOP/s, 0.047 ms. Around the products, the face's own
// work is per element: the splits, the transposes, the decays; and in
// the output launch shared memory's bandwidth binds before the tensor
// cores do (3xTF32 reads each B panel three times; see run_load).
//
// Design: three launches on one stream.
//   1. state_wg_kernel, one warpgroup per (b, chunk, head, 64 columns of
//      N), two CTAs an SM. The head's cs is one thread's sequential sum
//      (two prefixes of equal value round alike, so a padded step, dt = 0,
//      keeps its decay at exactly 1), written to a scratch for launches 2
//      and 3. The chunk state is [P, n] = (w x)^T B over 64-position
//      blocks: A, x^T scaled by w_j, is gathered from the TMA-loaded x
//      block into registers and split there; B, the B block transposed to
//      [n, j], is split into big and small tiles in shared memory. Blocks
//      arrive by TMA into a two-stage mbarrier ring.
//   2. pass_kernel (ssd_pass.cuh, the tile face's): the state passing in
//      chunk order, elementwise over [B, H, P, N], written over the chunk
//      states in place (the state after the last chunk is the returned
//      one). A chain of per-chunk flags inside launch 1 would serialise
//      one L2 round trip per chunk; the elementwise launch runs every
//      element's chain at once.
//   3. out_wg_kernel, one CTA per (b, chunk, group of G heads, 64-row
//      tile), dispatched longest tiles first, two warpgroups taking the
//      group's heads in turn, each with its own TMA landing area (one
//      load of two 32-column boxes ahead) and work tiles. C.B^T of the
//      tile's rows against the blocks up to the diagonal is computed once
//      for the group (the warpgroups take alternate blocks) and kept in
//      shared memory in the accumulator's own order; for each head: the
//      carry-in (A = C gathered from its TMA tile, B = h_in's rows split
//      in shared memory), the rows scaled by exp(cs_i), then the intra
//      blocks: A is L, formed in registers from the C.B^T strip, B is the
//      x block transposed to [p, j] and split. In the diagonal block the
//      decay exp(cs_i - cs_j) is formed per element and only where j <= i
//      (above the diagonal it overflows, and inf * 0 is NaN); left of it,
//      as exp(cs_i - cs_i0) exp(cs_i0 - cs_j) with i0 the tile's first
//      row, both factors <= 1 (cs falls: dt >= 0, A < 0): one exp per row
//      and one per position, none per element. The accumulator's columns
//      (2t, 2t + 1) serve as A's k columns (t, t + 4): the transposed x
//      stores each 8-position group as its even then its odd positions,
//      so the permutation cancels in the sum.
//   Products are wgmma m64n64k8 in tf32 (A from registers, B K-major in
//   128-byte-swizzled shared memory: a k-step of 8 tf32 is 32 bytes, as a
//   bf16 k-step is), 24 per 64-deep step (three per k-step). Every sum
//   runs in a fixed order: two calls agree bit for bit. The grid of
//   launch 3 and its head group are the host's plan
//   (kernels/ssd_scan.py::ssd_plan, from shapes and the SM count).
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_wgmma.cuh"
#include "ssd_pass.cuh"

namespace {

constexpr int P = 64;            // head dim: the face takes P = 64 only
constexpr int TB = 64;           // rows of a tile, positions of a block
constexpr int PANEL = TB * 128;  // bytes of a [64 rows][32 f32] panel
constexpr int MAXL = 256;
constexpr int NTH = 256;         // two warpgroups
constexpr float LOG2E = 1.4426950408889634f;

struct SsdMaps {       // built on the host, passed by value
  CUtensorMap x;       // [B*S, H, P]: box 32 x 1 x 64
  CUtensorMap b;       // [B*S, N]: box 32 x 64
  CUtensorMap c;       // [B*S, N]: box 32 x 64
  CUtensorMap st;      // [B*nc*H*P, N]: box 32 x 64
};

// Byte offset of element (r, col) of a tile of `rows` rows stored as
// panels of 32 f32 columns, each row 128 bytes with its 16-byte chunks
// XOR-ed with r % 8: the layout a TMA box with the 128-byte swizzle writes.
__device__ __forceinline__ uint32_t swz(int r, int col, int rows) {
  return (col >> 5) * rows * 128 + r * 128 +
         ((((col & 31) >> 2) ^ (r & 7)) << 4) + ((col & 3) << 2);
}

__device__ __forceinline__ float lds(const unsigned char* base,
                                     uint32_t off) {
  return *reinterpret_cast<const float*>(base + off);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// keep A's registers alive (untouched) until the products reading them
// have completed: call after wg::wait<>()
template <int K>
__device__ __forceinline__ void keep(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// v rounded to tf32 (10 mantissa bits) to nearest, ties away from zero:
// cvt.rna.tf32.f32's result, in two integer operations on the full-rate
// pipes (cvt.rna runs at a quarter of their rate, and the face splits
// every operand it stages or gathers)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// split 4 values into their big and small tf32 halves: big = tf32(v),
// small = tf32(v - big)
__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    big[e] = tf32_rna(v[e]);
    small[e] = tf32_rna(v[e] - __uint_as_float(big[e]));
  }
}

__device__ __forceinline__ void store4(unsigned char* p,
                                       const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

// 2^x on the special-function unit (2 ulp; 0 below 2^-126): the decays
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D += A B, m64n64k8 in tf32: A from registers (per warp, mma.sync's
// m16n8k8 A fragment), B K-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void mma_n64(float (&d)[8][4],
                                        const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B over the 4 k-steps of a K panel in 3xTF32, small terms first:
// A from registers, B's big and small panels at `slot` and `slot` + PANEL
// (K-major, 128-byte swizzle). Commits the products as one group.
__device__ __forceinline__ void mma_half(float (&d)[8][4],
                                         const uint32_t (&ab)[4][4],
                                         const uint32_t (&as)[4][4],
                                         uint32_t slot) {
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma_n64(d, as[kk], wg::desc_k(slot, kk, PANEL));
    mma_n64(d, ab[kk], wg::desc_k(slot + PANEL, kk, PANEL));
    mma_n64(d, ab[kk], wg::desc_k(slot, kk, PANEL));
  }
  wg::commit();
}

// Rows 32q .. 32q + 31 of a raw [64 r][64 col] block (the TMA layout: two
// 32-column panels) transposed into one K panel [64 col][32 r] of big and
// small tiles (r the k index), each 8-row group stored as its even rows
// then its odd rows (k-step order t, t + 4 <-> rows 2t, 2t + 1). A warp
// of the warpgroup moves a 32-column panel of an 8-row group: lane l
// holds column 32 cp + l (its loads one 128-byte row, its stores 32
// distinct rows: no bank conflict).
__device__ __forceinline__ void transpose_panel(const unsigned char* raw,
                                                unsigned char* big,
                                                unsigned char* small, int q,
                                                int warp) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int u = warp + 4 * m, cp = u >> 2, a = 4 * q + (u & 3);
    const int col = 32 * cp + lane;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = lds(raw, swz(8 * a + k, col, TB));
    const uint32_t row = col * 128;
    const uint32_t ce = ((2 * (a & 3)) ^ (col & 7)) << 4;
    const uint32_t co = ((2 * (a & 3) + 1) ^ (col & 7)) << 4;
    uint32_t eb[4], es[4], ob[4], os[4];
    const float ev[4] = {v[0], v[2], v[4], v[6]};
    const float ov[4] = {v[1], v[3], v[5], v[7]};
    split4(ev, eb, es);
    split4(ov, ob, os);
    store4(big + row + ce, eb);
    store4(small + row + ce, es);
    store4(big + row + co, ob);
    store4(small + row + co, os);
  }
}

// A raw 32-column panel (8 KB) split into big and small panels of the
// same (swizzled) layout, 16 bytes a thread and step
__device__ __forceinline__ void split_panel(const unsigned char* raw,
                                            unsigned char* big,
                                            unsigned char* small, int tid) {
#pragma unroll
  for (int m = 0; m < PANEL / 16 / 128; ++m) {
    const int o = 16 * (tid + 128 * m);
    const float4 v = *reinterpret_cast<const float4*>(raw + o);
    const float f[4] = {v.x, v.y, v.z, v.w};
    uint32_t b[4], s[4];
    split4(f, b, s);
    store4(big + o, b);
    store4(small + o, s);
  }
}

// ---------------------------------------------------------------------------
// 1. chunk states (and cs)
// ---------------------------------------------------------------------------

struct StateSmem {
  static constexpr int BRAW = 2 * PANEL;            // B block [64 j][64 n]
  static constexpr int XRAW = 2 * PANEL;            // x block [64 j][64 p]
  static constexpr int STAGE = BRAW + XRAW;
  static constexpr int BT = 2 * PANEL;              // B^T [64 n][64 j]
  static constexpr int ARR = 3 * MAXL * 4;          // dt, cs, w
  static constexpr int BYTES = 2 * STAGE + 2 * BT + ARR + 1024;
};

// One warpgroup per (b, chunk, head, 64 columns n0 of N): s[p, n0 + ..]
// of the head's chunk state, over the chunk's 64-position blocks. Two
// CTAs share an SM, so one's loads, cumsum and conversions run under the
// other's products.
__global__ void __launch_bounds__(128, 2)
    state_wg_kernel(const __grid_constant__ SsdMaps maps,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    float* __restrict__ cs_out, float* __restrict__ st, int S,
                    int H, int N, int l) {
  using M = StateSmem;
  extern __shared__ __align__(1024) unsigned char s_raw[];
  __shared__ __align__(8) uint64_t full[2];
  unsigned char* sm = s_raw + ((1024 - (wg::smem_u32(s_raw) & 1023)) & 1023);
  unsigned char* bt = sm + 2 * M::STAGE;   // slots: big, small, big, small
  float* dt_s = reinterpret_cast<float*>(bt + 2 * M::BT);
  float* cs_s = dt_s + MAXL;
  float* w_s = cs_s + MAXL;
  const int tid = threadIdx.x;
  const int n0 = 64 * blockIdx.x, h = blockIdx.y;
  const int nc = S / l, b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int nb = l / TB;
  const size_t row0 = (size_t)b * S + (size_t)c * l;
  // this thread's positions of dt, read first: their latency runs under
  // the barriers' setup
  const float d0 = tid < l ? dt[(row0 + tid) * H + h] : 0.f;
  const float d1 = tid + 128 < l ? dt[(row0 + tid + 128) * H + h] : 0.f;
  const uint32_t bar0 = wg::smem_u32(&full[0]);
  auto issue = [&](int jb) {
    const int s = jb & 1;
    const uint32_t bar = bar0 + 8 * s;
    const uint32_t dst = wg::smem_u32(sm + s * M::STAGE);
    const int r = (int)(row0 + (size_t)jb * TB);
    wg::mbar_expect(bar, M::STAGE);
    tma_load_2d(dst, &maps.b, bar, n0, r);
    tma_load_2d(dst + PANEL, &maps.b, bar, n0 + 32, r);
    wg::tma_load(dst + M::BRAW, &maps.x, bar, 0, h, r);
    wg::tma_load(dst + M::BRAW + PANEL, &maps.x, bar, 32, h, r);
  };
  if (tid == 0) {
    wg::prefetch_map(&maps.b);
    wg::prefetch_map(&maps.x);
    wg::mbar_init(bar0, 1);
    wg::mbar_init(bar0 + 8, 1);
    wg::mbar_init_fence();
  }
  dt_s[tid] = d0;
  if (tid + 128 < l) dt_s[tid + 128] = d1;
  __syncthreads();
  if (tid == 0) {
    issue(0);
    if (nb > 1) issue(1);
    // cs, in order: 16 positions read ahead of the dependent sums
    const float a = A[h];
    const float4* __restrict__ d4 = reinterpret_cast<const float4*>(dt_s);
    float4* __restrict__ c4 = reinterpret_cast<float4*>(cs_s);
    float s = 0.f;
    for (int q = 0; q < l / 4; q += 4) {
      float4 d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = d4[q + k];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float4 o;
        s += d[k].x * a, o.x = s;
        s += d[k].y * a, o.y = s;
        s += d[k].z * a, o.z = s;
        s += d[k].w * a, o.w = s;
        c4[q + k] = o;
      }
    }
  }
  __syncthreads();
  const float cs_last = cs_s[l - 1];
  float* cso = cs_out + (((size_t)b * nc + c) * H + h) * l;
  for (int j = tid; j < l; j += 128) {
    if (n0 == 0) cso[j] = cs_s[j];
    // <= dt_j: exp of a difference <= 0, formed as a difference first
    w_s[j] = dt_s[j] * ex2((cs_last - cs_s[j]) * LOG2E);
  }
  const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  // B^T's slot q (its K panel of positions 32q .. 32q + 31): big at
  // bt + 2q PANEL, small a panel further
  const uint32_t slot0 = wg::smem_u32(bt), slot1 = slot0 + 2 * PANEL;
  uint32_t a0b[4][4], a0s[4][4], a1b[4][4], a1s[4][4];
  // A[p, j] = x[j, p] w_j of half q: rows p = 16w + g (+8); B^T holds each
  // 8-row group as its evens then its odds, so A's k columns t and t + 4
  // are positions 2t and 2t + 1 of the group
  auto build = [&](const unsigned char* xr, int jb, int q,
                   uint32_t (&ab)[4][4], uint32_t (&as)[4][4]) {
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      const int j = 8 * (4 * q + k4) + 2 * t, p = 16 * w + g;
      const float2 wj = *reinterpret_cast<const float2*>(w_s + jb * TB + j);
      const float v[4] = {lds(xr, swz(j, p, TB)) * wj.x,
                          lds(xr, swz(j, p + 8, TB)) * wj.x,
                          lds(xr, swz(j + 1, p, TB)) * wj.y,
                          lds(xr, swz(j + 1, p + 8, TB)) * wj.y};
      split4(v, ab[k4], as[k4]);
    }
  };
  float acc[8][4] = {};
  for (int jb = 0; jb < nb; ++jb) {
    const int s = jb & 1;
    unsigned char* stage = sm + s * M::STAGE;
    const unsigned char* xr = stage + M::BRAW;
    wg::mbar_wait(bar0 + 8 * s, (jb >> 1) & 1);
    transpose_panel(stage, bt, bt + PANEL, 0, w);
    transpose_panel(stage, bt + 2 * PANEL, bt + 3 * PANEL, 1, w);
    proxy_fence();
    __syncthreads();
    build(xr, jb, 0, a0b, a0s);
    build(xr, jb, 1, a1b, a1s);
    mma_half(acc, a0b, a0s, slot0);
    mma_half(acc, a1b, a1s, slot1);
    wg::wait<0>();
    keep(a0b);
    keep(a0s);
    keep(a1b);
    keep(a1s);
    __syncthreads();  // stage s read by every thread
    if (tid == 0 && jb + 2 < nb) issue(jb + 2);
  }
  wg::fence_regs(acc);
  float* out = st + (((size_t)b * nc + c) * H + h) * P * N + n0;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 16 * w + g + 8 * r, n = 8 * ni + 2 * t;
      *reinterpret_cast<float2*>(out + p * N + n) =
          make_float2(acc[ni][2 * r], acc[ni][2 * r + 1]);
    }
}

// ---------------------------------------------------------------------------
// 3. chunk outputs: carry-in and intra, per (b, chunk, head group, tile)
// ---------------------------------------------------------------------------

template <int NN>
struct OutSmem {
  static constexpr int CRAW = NN / 32 * PANEL;   // C rows [64][NN]
  static constexpr int LAND = 2 * PANEL;         // one TMA load: 2 boxes
  static constexpr int WORK = 4 * PANEL;         // its big and small tiles
  static constexpr int PER_WG = LAND + WORK;
  static constexpr int CB_BLOCK = 8 * 128 * 16;  // [kk][thread] float4
  static constexpr int ARR = 2 * 2 * MAXL * 4;   // cs, dt per warpgroup
  static int bytes(int l) {
    return CRAW + 2 * PER_WG + l / TB * CB_BLOCK + ARR + 1024;
  }
};

template <int NN>
__global__ void __launch_bounds__(NTH, 1)
    out_wg_kernel(const __grid_constant__ SsdMaps maps,
                  const float* __restrict__ dt, const float* __restrict__ cs,
                  float* __restrict__ y, int Bn, int S, int H, int l, int G) {
  using M = OutSmem<NN>;
  extern __shared__ __align__(1024) unsigned char o_raw[];
  __shared__ __align__(8) uint64_t bars[3];  // C tile, each wg's landing
  unsigned char* sm = o_raw + ((1024 - (wg::smem_u32(o_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wgi = tid >> 7, wtid = tid & 127;
  const int w = wtid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int nc = S / l, HG = (H + G - 1) / G, per_tile = Bn * nc * HG;
  const int tile = l / TB - 1 - (int)blockIdx.x / per_tile;  // longest first
  const int rem = blockIdx.x % per_tile, hg = rem % HG;
  const int b = rem / HG / nc, c = rem / HG % nc;
  const int nblk = tile + 1, i0 = tile * TB, halves = NN / 64;
  const size_t row0 = (size_t)b * S + (size_t)c * l;
  unsigned char* craw = sm;
  unsigned char* land = sm + M::CRAW + wgi * M::PER_WG;
  unsigned char* work = land + M::LAND;  // slots: big, small, big, small
  float4* cbs = reinterpret_cast<float4*>(sm + M::CRAW + 2 * M::PER_WG);
  float* cs_s = reinterpret_cast<float*>(sm + M::CRAW + 2 * M::PER_WG +
                                         l / TB * M::CB_BLOCK) +
                wgi * 2 * MAXL;
  float* dt_s = cs_s + MAXL;
  const uint32_t cbar = wg::smem_u32(&bars[0]);
  const uint32_t lbar = wg::smem_u32(&bars[1 + wgi]);
  // this warpgroup's loads, in order: its C.B^T blocks (jb = wgi, wgi + 2,
  // ...) in 64-column halves of B, then per head of its share (k = wgi,
  // wgi + 2, ... of the group) h_in's halves (not for chunk 0, whose
  // state is zero) and the x blocks 0 .. tile
  const int cb_mine = (nblk - wgi + 1) / 2, n_cb = cb_mine * halves;
  int heads_mine = 0;
  for (int k = wgi; k < G && hg * G + k < H; k += 2) ++heads_mine;
  const int carry = c > 0 ? halves : 0, per_head = carry + nblk;
  const int n_loads = n_cb + heads_mine * per_head;
  auto issue = [&](int k) {
    const uint32_t dst = wg::smem_u32(land);
    wg::mbar_expect(lbar, M::LAND);
    if (k < n_cb) {
      const int r = (int)(row0 + (wgi + 2 * (k / halves)) * TB);
      const int n0 = 64 * (k % halves);
      tma_load_2d(dst, &maps.b, lbar, n0, r);
      tma_load_2d(dst + PANEL, &maps.b, lbar, n0 + 32, r);
      return;
    }
    k -= n_cb;
    const int h = hg * G + wgi + 2 * (k / per_head), part = k % per_head;
    if (part < carry) {
      const int r = (int)((((size_t)b * nc + c) * H + h) * P);
      tma_load_2d(dst, &maps.st, lbar, 64 * part, r);
      tma_load_2d(dst + PANEL, &maps.st, lbar, 64 * part + 32, r);
    } else {
      const int r = (int)(row0 + (part - carry) * TB);
      wg::tma_load(dst, &maps.x, lbar, 0, h, r);
      wg::tma_load(dst + PANEL, &maps.x, lbar, 32, h, r);
    }
  };
  if (tid == 0) {
    wg::prefetch_map(&maps.c);
    wg::mbar_init(cbar, 1);
    wg::mbar_init(cbar + 8, 1);
    wg::mbar_init(cbar + 16, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    wg::mbar_expect(cbar, M::CRAW);
    for (int q = 0; q < NN / 32; ++q)
      tma_load_2d(wg::smem_u32(craw) + q * PANEL, &maps.c, cbar, 32 * q,
                  (int)(row0 + i0));
  }
  if (wtid == 0 && n_loads > 0) issue(0);
  int ld = 0;  // loads of this warpgroup consumed
  // A of the two halves of a load (its 32-column K panels), untouched
  // until their products complete
  uint32_t a0b[4][4], a0s[4][4], a1b[4][4], a1s[4][4];
  const uint32_t slot0 = wg::smem_u32(work), slot1 = slot0 + 2 * PANEL;
  // One load: both halves converted into the work slots, the landing
  // area refilled, A built, the products issued and waited for. Two
  // overlapped schedules measured slower on the H100 (0.143 against
  // 0.119 ms for this launch): a half's products under the next half's
  // conversion, and a third warpgroup converting for both through
  // mbarriers. Shared memory's bandwidth, not issue slots, binds here:
  // a step's 24 products read 48 KB of B, its conversion moves 48 KB,
  // its A reads 16 KB of the C.B^T strip.
  auto run_load = [&](float (&d)[8][4], auto convert, auto build) {
    wg::mbar_wait(lbar, ld & 1);
    convert(0, work, work + PANEL);
    convert(1, work + 2 * PANEL, work + 3 * PANEL);
    proxy_fence();
    wg_bar(wgi);
    if (wtid == 0 && ld + 1 < n_loads) issue(ld + 1);
    ++ld;
    build(0, a0b, a0s);
    build(1, a1b, a1s);
    mma_half(d, a0b, a0s, slot0);
    mma_half(d, a1b, a1s, slot1);
    wg::wait<0>();
    keep(a0b);
    keep(a0s);
    keep(a1b);
    keep(a1s);
    wg::fence_regs(d);
    wg_bar(wgi);
  };
  // a [64][64] load's 32-column panel q, split in place of layout
  auto split_half = [&](int q, unsigned char* bg, unsigned char* sl) {
    split_panel(land + q * PANEL, bg, sl, wtid);
  };
  // A = C's rows 16w + g (+8), columns n0 + 8kk + t (+4) of half q
  auto gather_c = [&](int n0) {
    return [&, n0](int q, uint32_t (&ab)[4][4], uint32_t (&as)[4][4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int n = n0 + 32 * q + 8 * kk + t, i = 16 * w + g;
        const float v[4] = {lds(craw, swz(i, n, TB)),
                            lds(craw, swz(i + 8, n, TB)),
                            lds(craw, swz(i, n + 4, TB)),
                            lds(craw, swz(i + 8, n + 4, TB))};
        split4(v, ab[kk], as[kk]);
      }
    };
  };
  wg::mbar_wait(cbar, 0);
  // C.B^T of rows i0 .. i0 + 63 against key block jb: M = i, N = j, K = n
  for (int m = 0; m < cb_mine; ++m) {
    const int jb = wgi + 2 * m;
    float acc[8][4] = {};
    for (int q = 0; q < halves; ++q)
      run_load(acc, split_half, gather_c(64 * q));
    // each thread keeps its own fragment, in A's order for the intra
    // product: (row g, col 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      cbs[(jb * 8 + kk) * 128 + wtid] =
          make_float4(acc[kk][0], acc[kk][2], acc[kk][1], acc[kk][3]);
  }
  __syncthreads();  // the strip complete for both warpgroups
  const int ir0 = i0 + 16 * w + g, ir1 = ir0 + 8;
  // per head, positions wtid and wtid + 128 of cs and dt, and cs at the
  // tile's first row: loaded a head ahead
  float pre[5];
  auto fetch = [&](int hi) {
    const int h = hg * G + wgi + 2 * hi;
    const float* csh = cs + (((size_t)b * nc + c) * H + h) * l;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = wtid + 128 * k;
      const bool in = j < nblk * TB;
      pre[k] = in ? csh[j] : 0.f;
      pre[2 + k] = in ? dt[(row0 + j) * H + h] : 0.f;
    }
    pre[4] = csh[i0];
  };
  if (heads_mine > 0) fetch(0);
  for (int hi = 0; hi < heads_mine; ++hi) {
    const int h = hg * G + wgi + 2 * hi;
    // dt_s holds, left of the tile, K_j = exp(cs_i0 - cs_j) dt_j (<= dt_j):
    // an off-diagonal block's decay is exp(cs_i - cs_i0) K_j, both factors
    // <= 1, so only the diagonal block exponentiates per element
    const float ref = pre[4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = wtid + 128 * k;
      if (j < nblk * TB) {
        cs_s[j] = pre[k];
        dt_s[j] = j < i0 ? ex2((ref - pre[k]) * LOG2E) * pre[2 + k]
                         : pre[2 + k];
      }
    }
    if (hi + 1 < heads_mine) fetch(hi + 1);
    wg_bar(wgi);
    float acc[8][4] = {};
    if (carry) {
      // y[i, p] = sum_n C[i, n] h_in[p, n]: M = i, N = p, K = n
      for (int q = 0; q < halves; ++q)
        run_load(acc, split_half, gather_c(64 * q));
        const float e0 = expf(cs_s[ir0]), e1 = expf(cs_s[ir1]);  // <= 1
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        acc[ni][0] *= e0, acc[ni][1] *= e0;
        acc[ni][2] *= e1, acc[ni][3] *= e1;
      }
    }
    const float c0 = cs_s[ir0], c1 = cs_s[ir1];
    const float r0 = ex2((c0 - ref) * LOG2E), r1 = ex2((c1 - ref) * LOG2E);
    for (int jb = 0; jb < nblk; ++jb) {
      // B = x^T's positions 32q .. 32q + 31; A = L: C.B^T exp(cs_i - cs_j)
      // dt_j, formed only where j <= i
      auto transpose_half = [&](int q, unsigned char* bg, unsigned char* sl) {
        transpose_panel(land, bg, sl, q, w);
      };
      auto build_l = [&](int q, uint32_t (&ab)[4][4], uint32_t (&as)[4][4]) {
        if (jb < tile) {
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const int kk = 4 * q + k4;
            const float4 v = cbs[(jb * 8 + kk) * 128 + wtid];
            const float2 k = *reinterpret_cast<const float2*>(
                dt_s + jb * TB + 8 * kk + 2 * t);
            const float f[4] = {v.x * r0 * k.x, v.y * r1 * k.x,
                                v.z * r0 * k.y, v.w * r1 * k.y};
            split4(f, ab[k4], as[k4]);
          }
        } else {
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const int kk = 4 * q + k4;
            const float4 v = cbs[(jb * 8 + kk) * 128 + wtid];
            const int j0 = jb * TB + 8 * kk + 2 * t, j1 = j0 + 1;
            const float2 csj = *reinterpret_cast<const float2*>(cs_s + j0);
            const float2 dtj = *reinterpret_cast<const float2*>(dt_s + j0);
            const float f[4] = {
                j0 <= ir0 ? v.x * ex2((c0 - csj.x) * LOG2E) * dtj.x : 0.f,
                j0 <= ir1 ? v.y * ex2((c1 - csj.x) * LOG2E) * dtj.x : 0.f,
                j1 <= ir0 ? v.z * ex2((c0 - csj.y) * LOG2E) * dtj.y : 0.f,
                j1 <= ir1 ? v.w * ex2((c1 - csj.y) * LOG2E) * dtj.y : 0.f};
            split4(f, ab[k4], as[k4]);
          }
        }
      };
      run_load(acc, transpose_half, build_l);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = (r ? ir1 : ir0), p = 8 * ni + 2 * t;
        *reinterpret_cast<float2*>(y + ((row0 + i) * H + h) * P + p) =
            make_float2(acc[ni][2 * r], acc[ni][2 * r + 1]);
      }
  }
}

// f32 tensor map, 128-byte swizzle (boxes of 32 f32 inner), zeros out of
// bounds; dims and strides innermost first, strides in elements
bool f32_map(CUtensorMap* map, const void* base, int rank,
             const uint64_t* dims, const uint64_t* strides,
             const uint32_t* box) {
  const wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t gd[3], gs[2];
  cuuint32_t bd[3], es[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) gd[i] = dims[i], bd[i] = box[i];
  for (int i = 0; i + 1 < rank; ++i) gs[i] = strides[i] * sizeof(float);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                const_cast<void*>(base), gd, gs, bd, es,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NN>
int launch(const SsdMaps& maps, const float* dt, const float* A, float* y,
           float* h, float* cs, float* st, int B, int S, int H, int l, int G,
           cudaStream_t s) {
  const int nc = S / l;
  const int state_smem = StateSmem::BYTES;
  cudaFuncSetAttribute(state_wg_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       state_smem);
  state_wg_kernel<<<dim3(NN / 64, H, B * nc), 128, state_smem, s>>>(
      maps, dt, A, cs, st, S, H, NN, l);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  if (const cudaError_t e = launch_pass(cs, st, h, B, S, H, P, NN, l, s))
    return (int)e;
  cudaFuncSetAttribute(out_wg_kernel<NN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       OutSmem<NN>::bytes(MAXL));
  const int items = B * nc * ((H + G - 1) / G) * (l / TB);
  out_wg_kernel<NN><<<items, NTH, OutSmem<NN>::bytes(l), s>>>(
      maps, dt, cs, y, B, S, H, l, G);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch the three passes on `stream`; returns 0 on success, else the CUDA
// error of the first refused launch (cudaErrorInvalidValue for a shape the
// face does not take, or a tensor map cuTensorMapEncodeTiled refuses).
// x, y [B, S, H, 64]; dt [B, S, H]; A [H]; Bm, Cm [B, S, N]; h [B, H, 64,
// N]; scratch: cs [B, S / l, H, l], st [B, S / l, H, 64, N]; all f32,
// contiguous, 16-byte aligned. Needs N of 64 or 128, l a multiple of 64 up to 256, S % l == 0,
// G >= 1 heads per group of launch 3.
extern "C" int repro_ssd_wgmma(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* h, void* cs, void* st, int B, int S,
                               int H, int N, int l, int G, void* stream) {
  if ((N != 64 && N != 128) || l < TB || l > MAXL || l % TB || S % l ||
      G < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const int nc = S / l;
  SsdMaps maps;
  const uint64_t xd[3] = {P, (uint64_t)H, (uint64_t)B * S};
  const uint64_t xs[2] = {P, (uint64_t)H * P};
  const uint32_t xb[3] = {32, 1, TB};
  const uint64_t bd[2] = {(uint64_t)N, (uint64_t)B * S};
  const uint64_t sd[2] = {(uint64_t)N, (uint64_t)B * nc * H * P};
  const uint64_t ns[1] = {(uint64_t)N};
  const uint32_t box[2] = {32, TB};
  if (!f32_map(&maps.x, x, 3, xd, xs, xb) ||
      !f32_map(&maps.b, Bm, 2, bd, ns, box) ||
      !f32_map(&maps.c, Cm, 2, bd, ns, box) ||
      !f32_map(&maps.st, st, 2, sd, ns, box))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *dtf = (const float*)dt, *Af = (const float*)A;
  if (N == 128)
    return launch<128>(maps, dtf, Af, (float*)y, (float*)h, (float*)cs,
                       (float*)st, B, S, H, l, G, s);
  return launch<64>(maps, dtf, Af, (float*)y, (float*)h, (float*)cs,
                    (float*)st, B, S, H, l, G, s);
}
