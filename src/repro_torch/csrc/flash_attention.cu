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
// the limit.
//
// bf16 (the path that matters): the FlashAttention-2 layout on the
// tensor cores, with mma.sync.m16n8k16 (bf16 in, f32 accumulate),
// ldmatrix and a cp.async ring of K/V tiles (attention_tile.cuh).
// mma.sync rather than wgmma + TMA: it needs no tensor-map descriptors or
// producer warp, keeps the mask and the online softmax on the same
// register fragments the product wrote, and one tile routine serves this
// kernel and the paged prefill, whose key tiles are gathered through a
// block table (no TMA box fits them). wgmma is the next step if the
// tile's shared-memory reads (each warp reads the whole K and V tile)
// turn out to bound it.
//   grid (B*H, ceil(S / 128)), 4 warps, two CTAs per SM; a CTA owns 128
//   query rows of one (batch, head), each warp 32 of them (two blocks of
//   16, so each K and V fragment it reads from shared memory feeds two
//   products) with their softmax state and [32, hd] f32 accumulator in
//   registers. The CTA walks the 64-key tiles of K and V, loading tile
//   i+1 with cp.async while it computes tile i (one __syncthreads per
//   tile). blockIdx.y runs the
//   query blocks from the last (the longest causal row block) to the
//   first, so the last wave holds the short blocks. Tiles wholly above
//   the causal diagonal or left of the window are never loaded; a warp
//   skips the products of a loaded tile that is masked for all of its 16
//   rows; only the edge tiles evaluate the mask per element. A ragged S
//   is zero-filled past its end and masked.
//   Numerics: f32 scores, the -1e30 fill, p = where(mask, exp(s - m), 0),
//   l summed in f32 from the unrounded p; P is rounded to bf16 before
//   P.V, as the reference mha_ref rounds probs to v's dtype.
//
// Head dims: 32, 64, 80 and 128 (the tile takes any multiple of 16; its
// shared-memory rows are padded where hd / 8 is not a multiple of 8). hd 80
// is five k-steps of 16 on the same mma.sync path.
//
// f32 (the test path): f32 on the CUDA cores, because TF32 would miss the
// 1e-4 f32 tolerance.
//   grid (B*H, ceil(S / 64)), 256 threads; per 64-key tile K and V are
//   staged in shared memory as f32, each thread computes the scores of one
//   key column for 16 rows, one thread per row runs the online softmax,
//   and each thread accumulates one hd column of P.V in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tile::BK;
using tile::next_elem;
using tile::NEG_INF;

// ---------------------------------------------------------------------------
// bf16: tensor cores
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = (size_t)bh * S * HD;
  const int q_last = min(q0 + TC_ROWS, S) - 1;
  const int wr0 = warp * 16 * MT;                 // the warp's first row
  const int wq0 = q0 + wr0, wq_last = wq0 + 16 * MT - 1;

  // the key tiles that hold a visible key for some row of the CTA
  const int n_tiles = (S + BK - 1) / BK;
  const int kt_end = causal ? q_last / BK + 1 : n_tiles;
  const int kt_begin = window >= 0 ? max(0, q0 - window + 1) / BK : 0;

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
    if (kt < kt_end) {
      const int st = (kt - kt_begin) % STAGES;
      load_rows<HD, BK>(k_s + st * BK * RS, k + head, kt * BK, S);
      load_rows<HD, BK>(v_s + st * BK * RS, v + head, kt * BK, S);
    }
    tile::cp_async_commit();
  };
  if (kt_begin < kt_end) {
    load_rows<HD, TC_ROWS>(q_s, q + head, q0, S);
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) issue(kt_begin + i);
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) % STAGES;
    tile::cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    issue(kt + STAGES - 1);   // into the stage tile kt - 1 left
    const int k0 = kt * BK;
    // tiles masked for all rows of this warp: no products
    if (wq0 >= S || (causal && k0 > wq_last) ||
        (window >= 0 && k0 + BK - 1 <= wq0 - window))
      continue;
    float s[MT][BK / 8][4];
    tile::qk<HD, MT>(s, q_s, wr0, k_s + st * BK * RS);
    // only the edge tiles (the diagonal, the window's edge, the end of a
    // ragged S) evaluate the mask per score
    const bool full = k0 + BK <= S && (!causal || k0 + BK - 1 <= wq0) &&
                      (window < 0 || k0 > wq_last - window);
    if (!full) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = wq0 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
            const int kp = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
            const bool vis = kp < S && (!causal || kp <= qp) &&
                             (window < 0 || kp > qp - window);
            if (!vis) s[mt][n][e] = NEG_INF;
          }
        }
      }
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
      const int qp = wq0 + mt * 16 + r;
      return qp < S ? out + head + (size_t)qp * HD : nullptr;
    });
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_ROWS = 64;   // query rows per CTA
constexpr int F_NT = 256;    // threads per CTA

template <int HD>
constexpr size_t f32_smem() {
  return sizeof(float) *
         (F_ROWS * HD + BK * (HD + 1) + BK * HD + F_ROWS * BK + 3 * F_ROWS);
}

template <int HD>
__global__ void __launch_bounds__(F_NT)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int S, int causal, int window, float scale) {
  constexpr int KP = HD + 1;              // padded K rows: conflict-free scores
  constexpr int PER = F_ROWS * HD / F_NT; // accumulator rows per thread
  constexpr int SR = F_ROWS * BK / F_NT;  // score rows per thread
  extern __shared__ float smem[];
  float* q_s = smem;                      // [F_ROWS, HD]
  float* k_s = q_s + F_ROWS * HD;         // [BK, KP]
  float* v_s = k_s + BK * KP;             // [BK, HD]
  float* s_s = v_s + BK * HD;             // [F_ROWS, BK]
  float* m_s = s_s + F_ROWS * BK;         // [F_ROWS] running max
  float* l_s = m_s + F_ROWS;              // [F_ROWS] running denominator
  float* al_s = l_s + F_ROWS;             // [F_ROWS] rescale of this tile

  const int bh = blockIdx.x, q0 = blockIdx.y * F_ROWS;
  const int tid = threadIdx.x;
  const int nrows = min(F_ROWS, S - q0);
  const size_t head = (size_t)bh * S * HD;

  for (int i = tid; i < F_ROWS * HD; i += F_NT)
    q_s[i] = i / HD < nrows ? q[head + (size_t)q0 * HD + i] : 0.f;
  if (tid < F_ROWS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  __syncthreads();

  const int q_last = q0 + nrows - 1;
  for (int k0 = 0; k0 < S; k0 += BK) {
    const int n = min(BK, S - k0);
    if (causal && k0 > q_last) break;                 // above the diagonal
    if (window >= 0 && k0 + n - 1 <= q0 - window) continue;  // left of it
    for (int e = tid; e < n * HD; e += F_NT) {
      const int j = e / HD, d = e % HD;
      const size_t off = head + (size_t)(k0 + j) * HD + d;
      k_s[j * KP + d] = k[off];
      v_s[j * HD + d] = v[off];
    }
    __syncthreads();
    // scores: thread (key j, row r0) owns rows r0, r0 + F_NT/BK, ... of
    // key column j, so each K element it reads serves SR rows (the query
    // reads are warp-wide broadcasts); masked entries hold -inf
    {
      const int j = tid % BK, r0 = tid / BK;
      float dot[SR];
#pragma unroll
      for (int i = 0; i < SR; ++i) dot[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float kd = k_s[j * KP + d];
#pragma unroll
        for (int i = 0; i < SR; ++i)
          dot[i] += q_s[(r0 + i * (F_NT / BK)) * HD + d] * kd;
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = r0 + i * (F_NT / BK);
        const int qp = q0 + r, kp = k0 + j;
        bool vis = r < nrows && j < n;
        if (causal) vis = vis && kp <= qp;
        if (window >= 0) vis = vis && kp > qp - window;
        s_s[r * BK + j] = vis ? dot[i] * scale : -INFINITY;
      }
    }
    __syncthreads();
    // online softmax update, one thread per row; s_s becomes P
    if (tid < F_ROWS) {
      float* srow = s_s + tid * BK;
      float mx = NEG_INF;
      for (int j = 0; j < BK; ++j) mx = fmaxf(mx, srow[j]);
      const float m_prev = m_s[tid];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < BK; ++j) {
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
    // acc = acc * alpha + P @ V; where HD divides the thread count each
    // V element is read once per thread
    {
      int r = tid / HD, c = tid % HD;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        acc[i] *= al_s[r];
        next_elem<HD, F_NT>(r, c);
      }
    }
    for (int j = 0; j < n; ++j) {
      int r = tid / HD, c = tid % HD;
      const float vj = v_s[j * HD + c];   // the column of every i
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        acc[i] += s_s[r * BK + j] * (F_NT % HD == 0 ? vj : v_s[j * HD + c]);
        next_elem<HD, F_NT>(r, c);
      }
    }
    __syncthreads();
  }

  // finalize: rows with no visible key emit zeros
  int r = tid / HD, c = tid % HD;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (r < nrows) {
      const float l = l_s[r];
      out[head + (size_t)(q0 + r) * HD + c] = acc[i] / (l == 0.f ? 1.f : l);
    }
    next_elem<HD, F_NT>(r, c);
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int BH,
              int S, int bf16_io, int causal, int window, float scale,
              cudaStream_t stream) {
  if (bf16_io) {
    constexpr size_t smem = tc_smem<HD>();
    cudaFuncSetAttribute(flash_tc_kernel<HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    const dim3 grid(BH, (S + TC_ROWS - 1) / TC_ROWS);
    flash_tc_kernel<HD><<<grid, TC_NT, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, S, causal,
        window, scale * tile::LOG2E);
  } else {
    constexpr size_t smem = f32_smem<HD>();
    cudaFuncSetAttribute(flash_f32_kernel<HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    const dim3 grid(BH, (S + F_ROWS - 1) / F_ROWS);
    flash_f32_kernel<HD><<<grid, F_NT, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, S,
        causal, window, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success). q, k, v, out [BH, S, hd], contiguous, all f32 (bf16 = 0) or
// all bf16 (bf16 = 1). window < 0: no sliding window.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int BH, int S,
                                     int hd, int bf16, int causal,
                                     int window, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch_hd<32>(q, k, v, out, BH, S, bf16, causal, window, scale,
                           st);
    case 64:
      return launch_hd<64>(q, k, v, out, BH, S, bf16, causal, window, scale,
                           st);
    case 80:
      return launch_hd<80>(q, k, v, out, BH, S, bf16, causal, window, scale,
                           st);
    case 128:
      return launch_hd<128>(q, k, v, out, BH, S, bf16, causal, window, scale,
                            st);
  }
  return (int)cudaErrorInvalidValue;
}
