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
// Float pools only (f32 or bf16); the quantized face (has_scales) is
// still to be ported.
//
// What bounds it on the H100: bytes. Per (lane, kv head) the kernel reads
// its live K and V pages once and does 4*hd flops per (query row, key);
// with the G = 4 query heads of a kv head at decode that is about 4 flops
// per pool byte, far below the ~295 flops per byte at which the tensor
// cores would be the limit. So the design keeps everything but the page
// reads on chip: the query tile, the scores, the softmax state and the
// accumulator never touch device memory, and pages past the visible
// prefix are never read.
//
// Design (right and simple first; no wgmma, TMA or warp specialisation):
//   grid (B, KVH, ceil(C*G / ROWS)), NT threads. A CTA owns up to ROWS
//   query rows of one (lane, kv head); row r of the flattened [C*G, hd]
//   tile is chunk token c = r / G, query head kvh*G + r % G. The CTA
//   reads its own block-table row and length (no scalar prefetch). Per
//   live page it stages the [page, hd] K and V tiles in shared memory as
//   f32, computes the [ROWS, page] scores with one thread per (row, key),
//   folds them into an f32 online softmax (one thread per row), and
//   accumulates P.V into an f32 [ROWS, hd] accumulator held in registers
//   (each thread owns one hd column of ROWS*hd/NT rows). The chunk's own
//   K/V is a last pass in page-sized tiles. Rows with no visible key emit
//   zeros (acc / (l == 0 ? 1 : l)), the JAX kernel's safe_l convention.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 16;             // query rows per CTA
constexpr int NT = 128;              // threads per CTA
constexpr float NEG_INF = -1e30f;    // the JAX kernel's masked-score fill

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* q;       // [B, KVH, CG, hd], the flattened query tile
  const void* k_pool;  // [NB, page, KVH, hd], one layer's pool
  const void* v_pool;
  const int* bt;       // [B, bp]
  const int* lens;     // [B] pooled slots visible (prefix length)
  const int* nvalid;   // [B] real chunk tokens, or null (decode)
  const void* own_k;   // [B, KVH, C, hd], or null (decode)
  const void* own_v;
  void* out;           // [B, KVH, CG, hd]
  int KVH, CG, C, G, bp, page;
  float scale;
  int window;          // sliding window in tokens, -1 for none
};

// Fold one staged tile of n keys (key index key0 + j) into the softmax
// state of the CTA's rows. `own` selects the chunk's own-KV masks.
template <int HD>
__device__ __forceinline__ void fold_tile(
    const Args& a, const float* q_s, const float* k_s, const float* v_s,
    float* s_s, float* m_s, float* l_s, float* al_s,
    float (&acc)[ROWS * HD / NT], int n, int key0, bool own, int r0,
    int nrows, int cache_len, int nv, bool has_own) {
  constexpr int KP = HD + 1;
  const int tid = threadIdx.x;
  // scores, one thread per (row, key); masked entries hold -inf
  for (int e = tid; e < ROWS * a.page; e += NT) {
    const int r = e / a.page, j = e % a.page;
    const int c = (r0 + r) / a.G;    // chunk token of this query row
    const int key = key0 + j;
    bool vis = r < nrows && j < n;
    if (vis && !own) {
      vis = key < cache_len;
      if (has_own) {
        vis = vis && c < nv;
        if (a.window >= 0) vis = vis && key > cache_len + c - a.window;
      }
    } else if (vis) {
      vis = key <= c && key < nv && c < nv;
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
  if (tid < ROWS) {
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
  // acc = acc * alpha + P @ V, one hd column per thread
  const int col = tid % HD;
#pragma unroll
  for (int i = 0; i < ROWS * HD / NT; ++i) {
    const int r = tid / HD + i * (NT / HD);
    const float* prow = s_s + r * a.page;
    float o = 0.f;
    for (int j = 0; j < n; ++j) o += prow[j] * v_s[j * HD + col];
    acc[i] = acc[i] * al_s[r] + o;
  }
  __syncthreads();
}

template <int HD, typename QT, typename KT>
__global__ void __launch_bounds__(NT) mq_paged_kernel(Args a) {
  constexpr int KP = HD + 1;  // padded K rows: the score loop is conflict-free
  extern __shared__ float smem[];
  float* q_s = smem;                   // [ROWS, HD]
  float* k_s = q_s + ROWS * HD;        // [page, KP]
  float* v_s = k_s + a.page * KP;      // [page, HD]
  float* s_s = v_s + a.page * HD;      // [ROWS, page]
  float* m_s = s_s + ROWS * a.page;    // [ROWS] running max
  float* l_s = m_s + ROWS;             // [ROWS] running denominator
  float* al_s = l_s + ROWS;            // [ROWS] rescale of this tile

  const int b = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * ROWS;
  const int tid = threadIdx.x;
  const int nrows = min(ROWS, a.CG - r0);
  const int cache_len = a.lens[b];
  const bool has_own = a.own_k != nullptr;
  const int nv = has_own ? a.nvalid[b] : 0;
  const size_t tile = ((size_t)(b * a.KVH + h) * a.CG + r0) * HD;

  const QT* q = (const QT*)a.q + tile;
  for (int i = tid; i < ROWS * HD; i += NT)
    q_s[i] = i / HD < nrows ? to_f32(q[i]) : 0.f;
  if (tid < ROWS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ROWS * HD / NT];
#pragma unroll
  for (int i = 0; i < ROWS * HD / NT; ++i) acc[i] = 0.f;
  __syncthreads();

  // ---- pooled pages: only those holding a visible slot -----------------
  const KT* kp = (const KT*)a.k_pool;
  const KT* vp = (const KT*)a.v_pool;
  const size_t slot_stride = (size_t)a.KVH * HD;
  for (int p = 0; p < a.bp; ++p) {
    const int page_start = p * a.page;
    bool live = page_start < cache_len;
    if (has_own && a.window >= 0)  // left of every query's window
      live = live && page_start + a.page > cache_len - a.window;
    if (!live) continue;  // uniform over the CTA
    const size_t base =
        (size_t)a.bt[b * a.bp + p] * a.page * slot_stride + (size_t)h * HD;
    for (int e = tid; e < a.page * HD; e += NT) {
      const int j = e / HD, d = e % HD;
      const size_t off = base + j * slot_stride + d;
      k_s[j * KP + d] = to_f32(kp[off]);
      v_s[j * HD + d] = to_f32(vp[off]);
    }
    __syncthreads();
    fold_tile<HD>(a, q_s, k_s, v_s, s_s, m_s, l_s, al_s, acc, a.page,
                  page_start, false, r0, nrows, cache_len, nv, has_own);
  }

  // ---- the chunk's own exact K/V (prefill face) ------------------------
  if (has_own) {
    const QT* ok = (const QT*)a.own_k + (size_t)(b * a.KVH + h) * a.C * HD;
    const QT* ov = (const QT*)a.own_v + (size_t)(b * a.KVH + h) * a.C * HD;
    // keys past the last row's chunk token are causally masked for all
    const int last_c = (r0 + nrows - 1) / a.G;
    const int limit = min(min(nv, a.C), last_c + 1);
    for (int t0 = 0; t0 < limit; t0 += a.page) {
      const int n = min(a.page, limit - t0);
      for (int e = tid; e < n * HD; e += NT) {
        const int j = e / HD, d = e % HD;
        k_s[j * KP + d] = to_f32(ok[(size_t)(t0 + j) * HD + d]);
        v_s[j * HD + d] = to_f32(ov[(size_t)(t0 + j) * HD + d]);
      }
      __syncthreads();
      fold_tile<HD>(a, q_s, k_s, v_s, s_s, m_s, l_s, al_s, acc, n, t0, true,
                    r0, nrows, cache_len, nv, has_own);
    }
  }

  // ---- finalize: rows with no visible key emit zeros -------------------
  QT* out = (QT*)a.out + tile;
  const int col = tid % HD;
#pragma unroll
  for (int i = 0; i < ROWS * HD / NT; ++i) {
    const int r = tid / HD + i * (NT / HD);
    if (r < nrows) {
      const float l = l_s[r];
      store(out + r * HD + col, acc[i] / (l == 0.f ? 1.f : l));
    }
  }
}

template <int HD, typename QT, typename KT>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (ROWS * HD + a.page * (HD + 1) +
                                       a.page * HD + ROWS * a.page + 3 * ROWS);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mq_paged_kernel<HD, QT, KT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dim3 grid(B, a.KVH, (a.CG + ROWS - 1) / ROWS);
  mq_paged_kernel<HD, QT, KT><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch_dtypes(const Args& a, int B, int q_bf16, int kv_bf16,
                    cudaStream_t stream) {
  if (q_bf16 && kv_bf16) return launch<HD, __nv_bfloat16, __nv_bfloat16>(a, B, stream);
  if (q_bf16) return launch<HD, __nv_bfloat16, float>(a, B, stream);
  if (kv_bf16) return launch<HD, float, __nv_bfloat16>(a, B, stream);
  return launch<HD, float, float>(a, B, stream);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success). q_bf16 / kv_bf16: 1 for bf16, 0 for f32 (queries, own K/V and
// the output share the query dtype). nvalid/own_k/own_v null = decode.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lens, const void* nvalid,
    const void* own_k, const void* own_v, void* out, int B, int KVH, int CG,
    int C, int G, int bp, int page, int hd, int q_bf16, int kv_bf16,
    float scale, int window, void* stream) {
  Args a{q, k_pool, v_pool, (const int*)block_tables, (const int*)lens,
         (const int*)nvalid, own_k, own_v, out, KVH, CG, C, G, bp, page,
         scale, window};
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64) return dispatch_dtypes<64>(a, B, q_bf16, kv_bf16, st);
  if (hd == 128) return dispatch_dtypes<128>(a, B, q_bf16, kv_bf16, st);
  return (int)cudaErrorInvalidValue;
}
