// The decode layer's elementwise glue, fused, for Hopper (sm_90a).
//
// No Pallas counterpart: inside the JAX package's jitted decode horizon XLA
// fuses the work between a layer's products (src/repro/models/layers.py:
// rms_norm, rope_cos_sin and apply_rope, the paged K/V write, the SwiGLU
// gate). The port's chain of PyTorch ops (src/repro_torch/models/layers.py)
// issues ~88 small kernels a layer for it; these three kernels do the same
// arithmetic in four launches a layer (kernels/decode_glue.py, whose
// *_plain functions are this arithmetic in PyTorch):
//
//   add_rms_norm_kernel   h' = h + delta (bf16), y = rms_norm(h', w)
//   attn_prologue_kernel  q and k: rms_norm over the head dim (qk-norm),
//                         then RoPE; q out, k and v into each lane's pool
//                         slot, and the lanes' attended lengths
//   silu_mul_kernel       silu(g) in f32 rounded to bf16, times u
//
// Each rounds where the chain rounds: bf16 after the residual add, after
// the qk-norm and after RoPE; each f32 product and sum on its own with a
// round-to-nearest intrinsic (the chain runs them as separate kernels, so
// nothing is contracted into an FMA); the norm's scale is torch's mean (the
// f32 sum of squares times an f32 1/N) plus eps under rsqrtf; RoPE's angles
// are f32 position times the f32 inverse frequency under cosf/sinf, which
// torch's cos/sin call. The one difference from the chain is the order of
// the norms' f32 sums.
//
// What bounds them on the H100: launches, not bytes. At qwen3-4b's decode
// (64 lanes, D 2560, 32/8 heads of 128, F 9728) add_rms_norm moves 1.3 MB
// (0.39 us at 3.35 TB/s), the prologue 1.6 MB (0.47 us), silu_mul 3.7 MB
// (1.1 us), each against the ~2-3 us a launch costs as a graph node; the
// chain made ~20 launches of each. Only mixtral's expert gate (8 experts x
// 64 rows x 14336) is large: 44 MB, 13 us, where the chain's four passes
// moved ~190 MB.
//
// Design: one CTA per row for the norm (16-byte loads; the sum of squares
// reduced by warp shuffles, then across the CTA's warps in warp order); one
// warp per head row for the prologue (each lane holds its pair (j, j + hd/2)
// of RoPE; the grid is lanes x groups of four rows); a grid-stride loop of
// 16-byte loads for silu_mul. Every kernel is deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NORM_THREADS = 256;
constexpr int PRO_WARPS = 4;     // head rows per prologue CTA, one per warp
constexpr int MAX_PAIRS = 2;     // RoPE pairs per lane: hd / 2 <= 64
constexpr int SILU_THREADS = 256;
constexpr int SILU_MAX_CTAS = 132 * 16;

__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }
// x rounded to bf16 and read back: where the chain stores a bf16 tensor
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ long long index_at(const void* p, long long i,
                                              int is64) {
  return is64 ? static_cast<const long long*>(p)[i]
              : static_cast<const int*>(p)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rms_norm's scale: torch's mean (the sum times its f32 factor 1/N), + eps,
// rsqrt
__device__ __forceinline__ float rms_scale(float sumsq, float inv_n,
                                           float eps) {
  return rsqrtf(__fadd_rn(__fmul_rn(sumsq, inv_n), eps));
}

// one normed element before its cast: (x * scale) * w, as the chain's two
// multiplies
__device__ __forceinline__ float normed(float x, float scale, float w) {
  return __fmul_rn(__fmul_rn(x, scale), w);
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* b2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) b2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// h + delta in bf16, as torch's bf16 add (an f32 sum rounded once); h alone
// where there is no delta
__device__ __forceinline__ void residual8(const bf16* h, const bf16* delta,
                                          size_t at, float* s) {
  load8(h + at, s);
  if (delta != nullptr) {
    float d[8];
    load8(delta + at, d);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = rbf(__fadd_rn(s[i], d[i]));
  }
}

// One CTA per row of [rows, D]. Pass 1 forms the row's h' eight values at a
// time, stores it (where asked) and sums its squares; the CTA reduces the
// sums in warp order; pass 2 forms h' again from the same inputs (now in
// L1/L2) and writes y.
__global__ void __launch_bounds__(NORM_THREADS)
    add_rms_norm_kernel(const bf16* __restrict__ h,
                        const bf16* __restrict__ delta,
                        bf16* __restrict__ h_out, const bf16* __restrict__ w,
                        bf16* __restrict__ y, int D, float inv_d, float eps) {
  __shared__ float part[NORM_THREADS / 32];
  const size_t row = (size_t)blockIdx.x * D;
  const int chunks = D / 8;
  float sumsq = 0.f;
  for (int c = threadIdx.x; c < chunks; c += NORM_THREADS) {
    float s[8];
    residual8(h, delta, row + 8 * c, s);
    if (h_out != nullptr) store8(h_out + row + 8 * c, s);
#pragma unroll
    for (int i = 0; i < 8; ++i) sumsq = __fadd_rn(sumsq, __fmul_rn(s[i], s[i]));
  }
  sumsq = warp_sum(sumsq);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = sumsq;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < NORM_THREADS / 32; ++i) total = __fadd_rn(total, part[i]);
  const float scale = rms_scale(total, inv_d, eps);
  for (int c = threadIdx.x; c < chunks; c += NORM_THREADS) {
    float s[8], wv[8];
    residual8(h, delta, row + 8 * c, s);
    load8(w + 8 * c, wv);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = normed(s[i], scale, wv[i]);
    store8(y + row + 8 * c, s);
  }
}

struct Prologue {
  const bf16* q;  // [B, H * hd] rows q_stride apart: the q product
  const bf16* k;  // [B, KVH * hd], k_stride
  const bf16* v;  // [B, KVH * hd], v_stride
  long long q_stride, k_stride, v_stride;
  const bf16* q_norm;  // [hd], or null: no qk-norm
  const bf16* k_norm;
  const void* positions;  // [B] int32 or int64 (pos64)
  const float* inv_freq;  // [hd / 2]
  const void* block_tables;  // [B, bp] int32 or int64 (bt64), rows bt_stride
  long long bt_stride;
  const void* writer;  // [B] int32 or int64 (writer64), or null
  bf16* q_out;         // [B, H, hd]
  bf16* k_pool;        // [N_blocks, bs, KVH, hd]
  bf16* v_pool;
  int* lens;  // [B] attended lengths out, or null
  int pos64, bt64, writer64;
  int H, KVH, hd, bs, bp, n_blocks, window_len;
  float eps, inv_hd;
};

// One warp per head row: rows [0, H) are q's heads, [H, H + KVH) k's, the
// rest v's. Lane l holds RoPE's pairs (j, j + hd/2) for j = l, l + 32.
__global__ void __launch_bounds__(PRO_WARPS * 32)
    attn_prologue_kernel(const Prologue p) {
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  const int r = blockIdx.y * PRO_WARPS + (threadIdx.x >> 5);
  const long long pos = index_at(p.positions, b, p.pos64);
  if (p.lens != nullptr && r == 0 && lane == 0)
    p.lens[b] = (int)(p.window_len > 0 ? min(pos + 1, (long long)p.window_len)
                                       : pos + 1);
  if (r >= p.H + 2 * p.KVH) return;
  const bool is_q = r < p.H;
  bf16* dst;
  if (is_q) {
    dst = p.q_out + ((size_t)b * p.H + r) * p.hd;
  } else {
    // under a writer, the slot is written by the last lane that shares it,
    // with its own K/V: the bytes of the chain's k[writer] written by all
    if (p.writer != nullptr && index_at(p.writer, b, p.writer64) != b) return;
    // the rolling window: the write slot wraps at the cache capacity
    const long long slot = p.window_len > 0 ? pos % p.window_len : pos;
    // a page past the table row, or a block id past the pool, faults the
    // launch, as the chain's gather and scatter fault on such an index
    const long long page = slot / p.bs;
    if (page < 0 || page >= p.bp) __trap();
    const long long blk = index_at(p.block_tables, b * p.bt_stride + page,
                                   p.bt64);
    if (blk < 0 || blk >= p.n_blocks) __trap();
    const long long target = blk * p.bs + slot % p.bs;
    const bool is_k = r < p.H + p.KVH;
    const int kvh = r - p.H - (is_k ? 0 : p.KVH);
    dst = (is_k ? p.k_pool : p.v_pool) + (target * p.KVH + kvh) * p.hd;
    if (!is_k) {  // v: copied as it is (the pool's dtype is the product's)
      const bf16* src = p.v + b * p.v_stride + (long long)kvh * p.hd;
      for (int j = lane; j < p.hd; j += 32) dst[j] = src[j];
      return;
    }
  }
  const bf16* src = is_q ? p.q + b * p.q_stride + (long long)r * p.hd
                         : p.k + b * p.k_stride + (long long)(r - p.H) * p.hd;
  const bf16* nw = is_q ? p.q_norm : p.k_norm;
  const int half = p.hd / 2;
  float x1[MAX_PAIRS], x2[MAX_PAIRS];
#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) {
    const int j = lane + 32 * i;
    x1[i] = j < half ? f32(src[j]) : 0.f;
    x2[i] = j < half ? f32(src[j + half]) : 0.f;
  }
  if (nw != nullptr) {  // qk-norm, rounded to bf16 before RoPE
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i)
      ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(x1[i], x1[i]),
                                   __fmul_rn(x2[i], x2[i])));
    const float scale = rms_scale(warp_sum(ss), p.inv_hd, p.eps);
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int j = lane + 32 * i;
      if (j < half) {
        x1[i] = rbf(normed(x1[i], scale, f32(nw[j])));
        x2[i] = rbf(normed(x2[i], scale, f32(nw[j + half])));
      }
    }
  }
  const float fpos = (float)pos;
#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) {
    const int j = lane + 32 * i;
    if (j < half) {
      const float angle = __fmul_rn(fpos, p.inv_freq[j]);
      const float c = cosf(angle), s = sinf(angle);
      dst[j] = __float2bfloat16_rn(
          __fsub_rn(__fmul_rn(x1[i], c), __fmul_rn(x2[i], s)));
      dst[j + half] = __float2bfloat16_rn(
          __fadd_rn(__fmul_rn(x2[i], c), __fmul_rn(x1[i], s)));
    }
  }
}

// torch's silu in f32 (x / (1 + exp(-x))), rounded to bf16, times u in f32
__device__ __forceinline__ float silu_mul1(float g, float u) {
  const float act = rbf(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))));
  return __fmul_rn(act, u);
}

__global__ void __launch_bounds__(SILU_THREADS)
    silu_mul_kernel(const bf16* __restrict__ g, const bf16* __restrict__ u,
                    bf16* __restrict__ out, long long n) {
  const long long n8 = n / 8;
  const long long step = (long long)gridDim.x * SILU_THREADS;
  const long long first = (long long)blockIdx.x * SILU_THREADS + threadIdx.x;
  for (long long i = first; i < n8; i += step) {
    float gv[8], uv[8];
    load8(g + 8 * i, gv);
    load8(u + 8 * i, uv);
#pragma unroll
    for (int k = 0; k < 8; ++k) gv[k] = silu_mul1(gv[k], uv[k]);
    store8(out + 8 * i, gv);
  }
  const long long tail = 8 * n8 + first;  // the last n % 8 elements
  if (tail < n)
    out[tail] = __float2bfloat16_rn(silu_mul1(f32(g[tail]), f32(u[tail])));
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// Each entry launches one kernel on `stream` and returns 0, or the CUDA
// error of a refused launch (cudaErrorInvalidValue for a shape it does not
// take). Tensors are bf16 unless named otherwise.

// h, delta (or null), h_out (null where delta is), y: [rows, D] contiguous,
// 16-byte aligned; w [D]; D a multiple of 8.
extern "C" int repro_add_rms_norm(const void* h, const void* delta,
                                  void* h_out, const void* w, void* y,
                                  int rows, int D, float inv_d, float eps,
                                  void* stream) {
  if (rows < 1 || D < 8 || D % 8 != 0 || !aligned16(h) || !aligned16(w) ||
      !aligned16(y) || (delta != nullptr && !aligned16(delta)) ||
      (h_out != nullptr && !aligned16(h_out)) ||
      ((delta == nullptr) != (h_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  add_rms_norm_kernel<<<rows, NORM_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)h, (const bf16*)delta, (bf16*)h_out, (const bf16*)w,
      (bf16*)y, D, inv_d, eps);
  return (int)cudaGetLastError();
}

// See Prologue for the operands; hd even and at most 128.
extern "C" int repro_attn_prologue(
    const void* q, long long q_stride, const void* k, long long k_stride,
    const void* v, long long v_stride, const void* q_norm, const void* k_norm,
    const void* positions, int pos64, const void* inv_freq,
    const void* block_tables, int bt64, long long bt_stride, int bp,
    const void* writer, int writer64, void* q_out, void* k_pool, void* v_pool,
    int n_blocks, int bs, void* lens, int B, int H, int KVH, int hd,
    int window_len, float inv_hd, float eps, void* stream) {
  if (B < 1 || H < 1 || KVH < 1 || hd < 2 || hd % 2 != 0 ||
      hd > 64 * MAX_PAIRS || bs < 1 || bp < 1 || n_blocks < 1 ||
      ((q_norm == nullptr) != (k_norm == nullptr)))
    return (int)cudaErrorInvalidValue;
  Prologue p;
  p.q = (const bf16*)q;
  p.k = (const bf16*)k;
  p.v = (const bf16*)v;
  p.q_stride = q_stride;
  p.k_stride = k_stride;
  p.v_stride = v_stride;
  p.q_norm = (const bf16*)q_norm;
  p.k_norm = (const bf16*)k_norm;
  p.positions = positions;
  p.inv_freq = (const float*)inv_freq;
  p.block_tables = block_tables;
  p.bt_stride = bt_stride;
  p.writer = writer;
  p.q_out = (bf16*)q_out;
  p.k_pool = (bf16*)k_pool;
  p.v_pool = (bf16*)v_pool;
  p.lens = (int*)lens;
  p.pos64 = pos64;
  p.bt64 = bt64;
  p.writer64 = writer64;
  p.H = H;
  p.KVH = KVH;
  p.hd = hd;
  p.bs = bs;
  p.bp = bp;
  p.n_blocks = n_blocks;
  p.window_len = window_len;
  p.eps = eps;
  p.inv_hd = inv_hd;
  const dim3 grid(B, (H + 2 * KVH + PRO_WARPS - 1) / PRO_WARPS);
  attn_prologue_kernel<<<grid, PRO_WARPS * 32, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// g, u, out: n elements each, contiguous, 16-byte aligned.
extern "C" int repro_silu_mul(const void* g, const void* u, void* out,
                              long long n, void* stream) {
  if (n < 1 || !aligned16(g) || !aligned16(u) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const long long want = (n / 8 + SILU_THREADS - 1) / SILU_THREADS;
  const int ctas = (int)(want < 1 ? 1 : (want > SILU_MAX_CTAS ? SILU_MAX_CTAS
                                                                : want));
  silu_mul_kernel<<<ctas, SILU_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)g, (const bf16*)u, (bf16*)out, n);
  return (int)cudaGetLastError();
}
