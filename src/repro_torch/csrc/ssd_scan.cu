// Mamba2 SSD (state-space duality) chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:40 ::_ssd_kernel
// (pallas_call at ssd_scan.py:137). x [B, S, H, P], dt [B, S, H], A [H],
// Bm/Cm [B, S, N] (ngroups = 1: shared by every head), all f32. Outputs
// y [B, S, H, P] and the final state [B, H, P, N] of
//   h_t = h_{t-1} * exp(dt_t A) + dt_t x_t B_t^T,   y_t = h_t C_t,
// computed per chunk of l positions (cs = inclusive cumsum of dt*A):
//   intra     y_i += sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//   carry-in  y_i += exp(cs_i) h_in C_i
//   state     s = sum_j exp(cs_last - cs_j) dt_j x_j B_j^T
//   passing   h_in[c + 1] = exp(cs_last[c]) h_in[c] + s[c],  h_in[0] = 0
//
// What bounds it on the H100: operations. At the full-width shape (B = 1,
// S = 2048, H = 80, P = 64, N = 128, l = 256) the products come to about
// 7.8 GFLOP against about 89 MB of x, y, dt, Bm, Cm and the state: 0.116
// ms at f32's 67 TFLOP/s against 0.027 ms at 3.35 TB/s. The reference is
// f32 and plain TF32 keeps three digits, so the products run on the tensor
// cores in 3xTF32 (mma.sync.m16n8k8; three tf32 products per f32 product,
// about f32's accuracy); the rest (the decay, the state passing) is f32 on
// the CUDA cores. Between the kernel and its roof stand the per-tile work
// around the products (copies, the decay with one expf per element, three
// barriers a tile) and the fragments' conversions to big + small halves.
//
// Design: the SSD decomposition into five launches, each parallel over
// (batch row, chunk, head) or finer; only pass 4 runs in chunk order, and
// it is elementwise. One C call issues all five on one stream.
//   1. cs_kernel: cs per (b, chunk, head) into a [B, nc, H, l] scratch.
//      One thread sums one (b, chunk, head) in order: two prefixes of
//      equal value then round alike, so a padded step (dt = 0) keeps its
//      decay at exactly 1 (a parallel scan rounds them apart, and at
//      |cs| ~ 1e4 that is ~1e-3 in the exponent).
//   2. cb_kernel: C.B^T per (b, chunk), the same for every head, lower
//      triangle of 64 x 64 tiles, into a [B, nc, l, l] scratch (2 MB at
//      full width, read back from L2 by the 80 heads).
//   3. state_kernel: the chunk state s [P, N] per (b, chunk, head), a
//      [P, l] x [l, N] product, into a [B, nc, H, P, N] scratch (21 MB at
//      full width): 640 CTAs where one CTA per head walked the chunks.
//   4. pass_kernel (ssd_pass.cuh, shared with ssd_wgmma.cu): h_in per
//      chunk, elementwise over B*H*P*N and in chunk order, written over
//      the chunk states in place; the state after the last chunk is the
//      returned final state. Four elements a thread, chunk c + 1 read
//      while chunk c is updated.
//   5. out_kernel: y per (b, chunk, head, 64-row tile): the carry-in, a
//      [64, N] x [N, P] product, then the intra product over the key
//      tiles up to the diagonal. 2560 CTAs at full width, the tiles with
//      the most key tiles dispatched first.
// Tiles (passes 2, 3, 5) go to shared memory by cp.async, two stages deep:
// the next tile is in flight while this one is used. Four warps per CTA
// each take a 32 x 32 (passes 2, 5) or 32 x 64 (pass 3) quarter of the
// output tile as 16 x 8 mma tiles; a fragment is split into big + small
// once and used for two or more tiles. Staged rows are padded (68 floats
// where the reduced dimension is contiguous, 72 or 136 where it is the row
// index), so each fragment read hits 32 distinct banks. On the H100 this
// beat the same passes as f32 FMAs on 8 x 4 and 8 x 8 register tiles
// (PERF.md).
//
// cs falls steeply (A = -(1..80) at init, so cs can drop thousands below
// zero inside one chunk): the segment decay exp(cs_i - cs_j) is formed for
// j <= i only, never as exp(cs_i) * exp(-cs_j) and never above the
// diagonal (where it overflows and inf * 0 is NaN). exp(cs_i),
// exp(cs_last - cs_j) and exp(cs_last) are <= 1 and may underflow to 0,
// which is the right answer.
#include <cuda_runtime.h>
#include <math.h>

#include "ssd_pass.cuh"
#include "tf32.cuh"

namespace {

using tf32::mma_tf32;
using tf32::split_tf32;

constexpr int NT = 256;          // threads per CTA of pass 1
constexpr int TI = 64;           // output rows (and keys) per tile
constexpr int KT = 64;           // depth of a staged operand tile
constexpr int LDK = KT + 4;      // padded row of a staged tile (17 x 16 B)
constexpr int KS = 32;           // depth of pass 3's staged tiles
constexpr int CSH = 8;           // heads per CTA of pass 1
constexpr int MAXL = 256;
constexpr int MAXP = 64;
constexpr int MAXN = 128;
constexpr int TILE = TI * LDK;   // floats of one staged 64 x 64 tile
// Operands staged with their reduced dimension k as rows ("k-major") have
// rows of LDM floats, 8 more than a multiple of 32, so that the fragment
// reads below (lane (g, t) at row k + t, column c + g) hit 32 banks.
constexpr int LDX = MAXP + 8;    // x rows (pass 3's A, pass 5's B)
constexpr int LDB = MAXN + 8;    // B rows (pass 3's B)
constexpr int TILEB = TI * LDX;  // floats of one staged [64, 64] x tile
// Four warps per CTA of passes 2, 3 and 5, each on a 32 x 32 (passes 2,
// 5) or 32 x 64 (pass 3) quarter of the CTA's output tile.
constexpr int NTO = 128;         // threads per CTA of passes 2 and 5
constexpr int NTS = 128;         // threads per CTA of pass 3
// dynamic shared memory of passes 2, 3 and 5 (two stages of each operand)
constexpr int CB_SMEM = 4 * TILE * sizeof(float);
constexpr int STATE_SMEM = (2 * KS * (LDX + LDB) + MAXL) * sizeof(float);
constexpr int OUT_SMEM = (2 * TILE + 2 * TILEB + 2 * MAXL) * sizeof(float);

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copies to shared memory; where !ok the destination is
// zero-filled and src is not read.
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying an [R, C] tile: dst[r * LD + c] = src[r * ld + c] for
// r < rows, c < cols, zeros elsewhere. vec: ld and cols are multiples of
// 4 and src is 16-byte aligned, so the copies are 16 bytes each.
template <int NTH, int R, int C, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t ld, int rows, int cols,
                                          bool vec) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < R * C / 4 / NTH; ++k) {
      const int e = threadIdx.x + k * NTH;
      const int r = e / (C / 4), c = 4 * (e % (C / 4));
      const bool ok = r < rows && c < cols;
      cp16(dst + r * LD + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < R * C / NTH; ++k) {
      const int e = threadIdx.x + k * NTH, r = e / C, c = e % C;
      const bool ok = r < rows && c < cols;
      cp4(dst + r * LD + c, ok ? src + r * ld + c : src, ok);
    }
  }
}

// Element (k, c) of a staged operand: row k of k-major storage, or row c
// of storage with k contiguous.
template <bool KMAJOR, int LD>
__device__ __forceinline__ float at(const float* p, int k, int c) {
  return KMAJOR ? p[k * LD + c] : p[c * LD + k];
}

// One warp's acc[mt][nt] += A[m0 + 16 mt .., k] B[k, n0 + 8 nt ..] over
// k < DEPTH. acc[mt][nt][e] is row m0 + 16 mt + g + 8 (e / 2), column
// n0 + 8 nt + 2 t + e % 2, with g = lane / 4 and t = lane % 4.
template <int MT, int NT8, int DEPTH, bool AK, int LDA, bool BK, int LDBB>
__device__ __forceinline__ void warp_mma(const float* a, const float* b,
                                         int m0, int n0,
                                         float (&acc)[MT][NT8][4]) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll 2
  for (int k = 0; k < DEPTH; k += 8) {
    unsigned bb[NT8][2], bs[NT8][2];
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const int n = n0 + 8 * nt + g;
      split_tf32(at<BK, LDBB>(b, k + t, n), bb[nt][0], bs[nt][0]);
      split_tf32(at<BK, LDBB>(b, k + t + 4, n), bb[nt][1], bs[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = m0 + 16 * mt + g;
      unsigned ab[4], as[4];
      split_tf32(at<AK, LDA>(a, k + t, m), ab[0], as[0]);
      split_tf32(at<AK, LDA>(a, k + t, m + 8), ab[1], as[1]);
      split_tf32(at<AK, LDA>(a, k + t + 4, m), ab[2], as[2]);
      split_tf32(at<AK, LDA>(a, k + t + 4, m + 8), ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        mma_tf32(acc[mt][nt], as, bb[nt]);
        mma_tf32(acc[mt][nt], ab, bs[nt]);
        mma_tf32(acc[mt][nt], ab, bb[nt]);
      }
    }
  }
}

// 1. cs[b, c, h, j] = sum_{j' <= j} dt[b, c*l + j', h] * A[h], in order
__global__ void __launch_bounds__(NT)
    cs_kernel(const float* __restrict__ dt, const float* __restrict__ A,
              float* __restrict__ cs, int S, int H, int l) {
  __shared__ float d_s[MAXL * (CSH + 1)];  // [l, CSH + 1]
  const int nc = S / l, h0 = blockIdx.x * CSH;
  const int b = blockIdx.y / nc, c = blockIdx.y % nc;
  const int nh = min(CSH, H - h0);
  const size_t t0 = (size_t)b * S + (size_t)c * l;
#pragma unroll 8
  for (int k = 0; k < MAXL * CSH / NT; ++k) {
    const int e = threadIdx.x + k * NT, j = e / CSH, hh = e % CSH;
    if (j < l)
      d_s[j * (CSH + 1) + hh] = hh < nh ? dt[(t0 + j) * H + h0 + hh] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < nh) {
    const int hh = threadIdx.x;
    const float a = A[h0 + hh];
    float s = 0.f;
#pragma unroll 8
    for (int j = 0; j < l; ++j) {
      s += d_s[j * (CSH + 1) + hh] * a;
      d_s[j * (CSH + 1) + hh] = s;
    }
  }
  __syncthreads();
  float* out = cs + (((size_t)b * nc + c) * H + h0) * l;
  for (int e = threadIdx.x; e < nh * l; e += NT)
    out[e] = d_s[(e % l) * (CSH + 1) + e / l];
}

// 2. cb[b, c, i, j] = C[b, c*l + i] . B[b, c*l + j] for j <= i. Both
// depth tiles of N (<= 128) are copied at once.
__global__ void __launch_bounds__(NTO)
    cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int S, int N, int l) {
  const int i0 = blockIdx.x * TI, j0 = blockIdx.y * TI;
  if (j0 > i0) return;  // above the diagonal: never computed, never read
  extern __shared__ __align__(16) float smem[];  // a0, b0, a1, b1
  const int nc = S / l;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int rows = min(TI, l - i0), cols = min(TI, l - j0);
  const size_t base = ((size_t)b * S + (size_t)c * l) * N;
  const bool vec = N % 4 == 0;
  const int steps = (N + KT - 1) / KT;
  for (int s = 0; s < steps; ++s) {
    const int k0 = s * KT, nk = min(KT, N - k0);
    load_tile<NTO, TI, KT, LDK>(smem + 2 * s * TILE,
                                Cm + base + (size_t)i0 * N + k0, N, rows, nk,
                                vec);
    load_tile<NTO, TI, KT, LDK>(smem + (2 * s + 1) * TILE,
                                Bm + base + (size_t)j0 * N + k0, N, cols, nk,
                                vec);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  const int w = threadIdx.x / 32, m0 = w / 2 * 32, n0 = w % 2 * 32;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  float acc[2][4][4] = {};
  for (int s = 0; s < steps; ++s)
    warp_mma<2, 4, KT, false, LDK, false, LDK>(
        smem + 2 * s * TILE, smem + (2 * s + 1) * TILE, m0, n0, acc);
  float* out = cb + ((size_t)b * nc + c) * l * l;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m0 + 16 * mt + g + 8 * (e / 2);
        const int j = n0 + 8 * nt + 2 * t + e % 2;
        if (i < rows && j < cols && j0 + j <= i0 + i)
          out[(size_t)(i0 + i) * l + j0 + j] = acc[mt][nt][e];
      }
}

// 3. st[b, c, h] = sum_j exp(cs_last - cs_j) dt_j x_j B_j^T   ([P, N]);
// tiles of KS positions, the next one copied while this one is used
__global__ void __launch_bounds__(NTS)
    state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ Bm, const float* __restrict__ cs,
                 float* __restrict__ st, int S, int H, int P, int N, int l) {
  extern __shared__ __align__(16) float smem[];
  float* x_buf = smem;                    // [2][KS, LDX] x, then decayed
  float* b_buf = x_buf + 2 * KS * LDX;    // [2][KS, LDB]
  float* w_s = b_buf + 2 * KS * LDB;      // [l] dt_j exp(cs_last - cs_j)
  const int h = blockIdx.x, nc = S / l;
  const int b = blockIdx.y / nc, c = blockIdx.y % nc;
  const size_t t0 = (size_t)b * S + (size_t)c * l;
  const size_t bch = ((size_t)b * nc + c) * H + h;
  const bool vec_x = P % 4 == 0, vec_b = N % 4 == 0;
  const int steps = (l + KS - 1) / KS;
  auto issue = [&](int s) {
    const int j0 = s * KS, nj = min(KS, l - j0);
    load_tile<NTS, KS, MAXP, LDX>(x_buf + (s & 1) * KS * LDX,
                                  x + ((t0 + j0) * H + h) * P,
                                  (size_t)H * P, nj, P, vec_x);
    load_tile<NTS, KS, MAXN, LDB>(b_buf + (s & 1) * KS * LDB,
                                  Bm + (t0 + j0) * N, N, nj, N, vec_b);
    cp_commit();
  };
  issue(0);
  const float* csc = cs + bch * l;
  const float cs_last = csc[l - 1];
  for (int j = threadIdx.x; j < l; j += NTS)
    w_s[j] = dt[(t0 + j) * H + h] * expf(cs_last - csc[j]);  // <= dt_j
  // warp w: rows p of m0 .. m0 + 31, columns n of n0 .. n0 + 63
  const int w = threadIdx.x / 32, m0 = w / 2 * 32, n0 = w % 2 * 64;
  float acc[2][8][4] = {};
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile s (and w_s) in place for every thread
    float* xt = x_buf + (s & 1) * KS * LDX;
    const float* bt = b_buf + (s & 1) * KS * LDB;
    const int j0 = s * KS;
#pragma unroll
    for (int k = 0; k < KS * MAXP / NTS; ++k) {
      const int e = threadIdx.x + k * NTS, j = e / MAXP;
      float* v = xt + j * LDX + e % MAXP;
      *v = j0 + j < l ? *v * w_s[j0 + j] : 0.f;
    }
    __syncthreads();
    warp_mma<2, 8, KS, true, LDX, true, LDB>(xt, bt, m0, n0, acc);
    __syncthreads();  // tile s used up before stage s & 1 is refilled
  }
  float* out = st + bch * P * N;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = m0 + 16 * mt + g + 8 * (e / 2);
        const int n = n0 + 8 * nt + 2 * t + e % 2;
        if (p < P && n < N) out[(size_t)p * N + n] = acc[mt][nt][e];
      }
}

// 5. y of one 64-row tile of one (b, chunk, head): the carry-in's depth
// tiles over N, then the intra key tiles up to the diagonal, the next
// tile copied while this one is used
__global__ void __launch_bounds__(NTO)
    out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Cm, const float* __restrict__ cs,
               const float* __restrict__ cb, const float* __restrict__ st,
               float* __restrict__ y, int S, int H, int P, int N, int l) {
  extern __shared__ __align__(16) float smem[];
  float* a_buf = smem;             // [2] C rows, or C.B^T rows
  float* b_buf = smem + 2 * TILE;  // [2] h_in rows, or [j, p] x
  float* cs_s = b_buf + 2 * TILEB; // [l]
  float* dt_s = cs_s + MAXL;       // [l]
  const int h = blockIdx.x, nc = S / l;
  const int b = blockIdx.y / nc, c = blockIdx.y % nc;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * TI;  // longest tiles first
  const int rows = min(TI, l - i0);
  const size_t t0 = (size_t)b * S + (size_t)c * l;
  const size_t bch = ((size_t)b * nc + c) * H + h;
  const float* hin = st + bch * P * N;
  const float* cbc = cb + ((size_t)b * nc + c) * l * l;
  const int kend = i0 + rows;  // keys 0 .. kend - 1 reach this tile
  const int ncarry = c > 0 ? (N + KT - 1) / KT : 0;  // h_in[0] = 0
  const int steps = ncarry + (kend + KT - 1) / KT;
  auto issue = [&](int s) {
    float* a = a_buf + (s & 1) * TILE;
    float* bb = b_buf + (s & 1) * TILEB;
    if (s < ncarry) {
      const int k0 = s * KT, nk = min(KT, N - k0);
      load_tile<NTO, TI, KT, LDK>(a, Cm + (t0 + i0) * N + k0, N, rows, nk,
                                  N % 4 == 0);
      load_tile<NTO, TI, KT, LDK>(bb, hin + k0, N, P, nk, N % 4 == 0);
    } else {
      const int j0 = (s - ncarry) * KT, cols = min(KT, l - j0);
      load_tile<NTO, TI, KT, LDK>(a, cbc + (size_t)i0 * l + j0, l, rows,
                                  cols, l % 4 == 0);
      load_tile<NTO, KT, MAXP, LDX>(bb, x + ((t0 + j0) * H + h) * P,
                                    (size_t)H * P, cols, P, P % 4 == 0);
    }
    cp_commit();
  };
  issue(0);
  for (int j = threadIdx.x; j < kend; j += NTO) {
    cs_s[j] = cs[bch * l + j];
    dt_s[j] = dt[(t0 + j) * H + h];
  }
  // warp w: rows i of m0 .. m0 + 31, columns p of n0 .. n0 + 31
  const int w = threadIdx.x / 32, m0 = w / 2 * 32, n0 = w % 2 * 32;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  float acc[2][4][4] = {};
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile s (and cs_s, dt_s) in place for every thread
    float* a = a_buf + (s & 1) * TILE;
    const float* bb = b_buf + (s & 1) * TILEB;
    if (s < ncarry) {
      warp_mma<2, 4, KT, false, LDK, false, LDK>(a, bb, m0, n0, acc);
      if (s == ncarry - 1) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int i = m0 + 16 * mt + g + 8 * (e / 2);
            const float decay = i < rows ? expf(cs_s[i0 + i]) : 0.f;  // <= 1
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              acc[mt][nt][e] *= decay;
              acc[mt][nt][e + 1] *= decay;
            }
          }
      }
    } else {
      // C.B^T -> C.B^T exp(cs_i - cs_j) dt_j, formed only where j <= i
      // (<= dt_j there; it would overflow above the diagonal, where the
      // scratch also holds whatever was in memory)
      const int j0 = (s - ncarry) * KT;
#pragma unroll 8
      for (int k = 0; k < TI * KT / NTO; ++k) {
        const int e = threadIdx.x + k * NTO, i = e / KT, j = e % KT;
        const int ii = i0 + i, jj = j0 + j;
        float* v = a + i * LDK + j;
        *v = i < rows && jj <= ii
                 ? *v * expf(cs_s[ii] - cs_s[jj]) * dt_s[jj]
                 : 0.f;
      }
      __syncthreads();
      warp_mma<2, 4, KT, false, LDK, true, LDX>(a, bb, m0, n0, acc);
    }
    __syncthreads();  // tile s used up before stage s & 1 is refilled
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int i = m0 + 16 * mt + g + 8 * (e / 2);
      if (i >= rows) continue;
      float* yr = y + ((t0 + i0 + i) * H + h) * P;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = n0 + 8 * nt + 2 * t;
        if (P % 2 == 0) {
          if (p < P)
            *reinterpret_cast<float2*>(yr + p) =
                make_float2(acc[mt][nt][e], acc[mt][nt][e + 1]);
        } else {
          if (p < P) yr[p] = acc[mt][nt][e];
          if (p + 1 < P) yr[p + 1] = acc[mt][nt][e + 1];
        }
      }
    }
}

}  // namespace

// Launch the five passes on `stream`; returns 0 on success, else the CUDA
// error of the first refused launch (or cudaErrorInvalidValue for a shape
// the kernel does not take). x, y [B, S, H, P]; dt [B, S, H]; A [H];
// Bm, Cm [B, S, N]; h [B, H, P, N]; scratch: cs [B, S / l, H, l], cb
// [B, S / l, l, l], st [B, S / l, H, P, N]; all f32, contiguous. Needs
// S % l == 0, l <= 256, P and N dividing 256, P <= 64, N <= 128.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* h, void* cs, void* cb, void* st, int B,
                              int S, int H, int P, int N, int l,
                              void* stream) {
  if (l < 1 || l > MAXL || S % l || P < 1 || P > MAXP || NT % P || N < 1 ||
      N > MAXN || NT % N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = S / l, nt = (l + TI - 1) / TI;
  const float *xf = (const float*)x, *dtf = (const float*)dt;
  float *csf = (float*)cs, *cbf = (float*)cb, *stf = (float*)st;
  cs_kernel<<<dim3((H + CSH - 1) / CSH, B * nc), NT, 0, s>>>(
      dtf, (const float*)A, csf, S, H, l);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  cudaFuncSetAttribute(cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       CB_SMEM);
  cb_kernel<<<dim3(nt, nt, B * nc), NTO, CB_SMEM, s>>>(
      (const float*)Bm, (const float*)Cm, cbf, S, N, l);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  cudaFuncSetAttribute(state_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       STATE_SMEM);
  state_kernel<<<dim3(H, B * nc), NTS, STATE_SMEM, s>>>(
      xf, dtf, (const float*)Bm, csf, stf, S, H, P, N, l);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  if (const cudaError_t e =
          launch_pass(csf, stf, (float*)h, B, S, H, P, N, l, s))
    return (int)e;
  cudaFuncSetAttribute(out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       OUT_SMEM);
  out_kernel<<<dim3(H, B * nc, nt), NTO, OUT_SMEM, s>>>(
      xf, dtf, (const float*)Cm, csf, cbf, stf, (float*)y, S, H, P, N, l);
  return (int)cudaGetLastError();
}
