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
// the limit. This first kernel computes in f32 on the CUDA cores (no
// wgmma): it is right and simple, and stays far from the bf16 tensor-core
// bound; the levers are in PERF.md.
//
// Design:
//   grid (B*H, ceil(S / ROWS)), NT threads. The TPU grid carried the
//   online-softmax state across its sequential kv dimension; here one CTA
//   owns ROWS query rows of one (batch, head) and walks the kv tiles
//   itself. Per tile it stages BK keys of K and V in shared memory as f32,
//   computes the [ROWS, BK] scores (each thread one key column of
//   ROWS*BK/NT rows, so a K element read from shared memory serves all of
//   them), folds them into an f32 online softmax (one thread per row), and
//   accumulates P.V into an f32 [ROWS, hd] accumulator held in registers
//   (each thread owns one hd column of ROWS*hd/NT rows). Tiles wholly above the causal
//   diagonal or wholly left of the window are skipped, as pl.when did:
//   a fully masked tile changes nothing in the online softmax, so the skip
//   is exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;            // query rows per CTA
constexpr int BK = 64;              // keys per staged tile
constexpr int NT = 256;             // threads per CTA
constexpr float NEG_INF = -1e30f;   // the JAX kernel's masked-score fill

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD, typename T>
__global__ void __launch_bounds__(NT)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S,
                 int causal, int window, float scale) {
  constexpr int KP = HD + 1;            // padded K rows: conflict-free scores
  constexpr int PER = ROWS * HD / NT;   // accumulator rows per thread
  constexpr int SR = ROWS * BK / NT;    // score rows per thread
  extern __shared__ float smem[];
  float* q_s = smem;                    // [ROWS, HD]
  float* k_s = q_s + ROWS * HD;         // [BK, KP]
  float* v_s = k_s + BK * KP;           // [BK, HD]
  float* s_s = v_s + BK * HD;           // [ROWS, BK]
  float* m_s = s_s + ROWS * BK;         // [ROWS] running max
  float* l_s = m_s + ROWS;              // [ROWS] running denominator
  float* al_s = l_s + ROWS;             // [ROWS] rescale of this tile

  const int bh = blockIdx.x, q0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int nrows = min(ROWS, S - q0);
  const size_t head = (size_t)bh * S * HD;

  for (int i = tid; i < ROWS * HD; i += NT)
    q_s[i] = i / HD < nrows ? to_f32(q[head + (size_t)q0 * HD + i]) : 0.f;
  if (tid < ROWS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  const int col = tid % HD;
  __syncthreads();

  const int q_last = q0 + nrows - 1;
  for (int k0 = 0; k0 < S; k0 += BK) {
    const int n = min(BK, S - k0);
    if (causal && k0 > q_last) break;                 // above the diagonal
    if (window >= 0 && k0 + n - 1 <= q0 - window) continue;  // left of it
    for (int e = tid; e < n * HD; e += NT) {
      const int j = e / HD, d = e % HD;
      const size_t off = head + (size_t)(k0 + j) * HD + d;
      k_s[j * KP + d] = to_f32(k[off]);
      v_s[j * HD + d] = to_f32(v[off]);
    }
    __syncthreads();
    // scores: thread (key j, row r0) owns rows r0, r0 + NT/BK, ... of key
    // column j, so each K element it reads serves SR rows (the query reads
    // are warp-wide broadcasts); masked entries hold -inf
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
          dot[i] += q_s[(r0 + i * (NT / BK)) * HD + d] * kd;
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = r0 + i * (NT / BK);
        const int qp = q0 + r, kp = k0 + j;
        bool vis = r < nrows && j < n;
        if (causal) vis = vis && kp <= qp;
        if (window >= 0) vis = vis && kp > qp - window;
        s_s[r * BK + j] = vis ? dot[i] * scale : -INFINITY;
      }
    }
    __syncthreads();
    // online softmax update, one thread per row; s_s becomes P
    if (tid < ROWS) {
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
    // acc = acc * alpha + P @ V; each V element is read once per thread
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= al_s[tid / HD + i * (NT / HD)];
    for (int j = 0; j < n; ++j) {
      const float vj = v_s[j * HD + col];
#pragma unroll
      for (int i = 0; i < PER; ++i)
        acc[i] += s_s[(tid / HD + i * (NT / HD)) * BK + j] * vj;
    }
    __syncthreads();
  }

  // finalize: rows with no visible key emit zeros
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = tid / HD + i * (NT / HD);
    if (r < nrows) {
      const float l = l_s[r];
      store(out + head + (size_t)(q0 + r) * HD + col,
            acc[i] / (l == 0.f ? 1.f : l));
    }
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (ROWS * HD + BK * (HD + 1) + BK * HD +
                                       ROWS * BK + 3 * ROWS);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(flash_kernel<HD, T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dim3 grid(BH, (S + ROWS - 1) / ROWS);
  flash_kernel<HD, T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, causal, window,
      scale);
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
  if (hd == 64)
    return bf16 ? launch<64, __nv_bfloat16>(q, k, v, out, BH, S, causal,
                                            window, scale, st)
                : launch<64, float>(q, k, v, out, BH, S, causal, window,
                                    scale, st);
  if (hd == 128)
    return bf16 ? launch<128, __nv_bfloat16>(q, k, v, out, BH, S, causal,
                                             window, scale, st)
                : launch<128, float>(q, k, v, out, BH, S, causal, window,
                                     scale, st);
  return (int)cudaErrorInvalidValue;
}
