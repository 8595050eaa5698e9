// Tensor-core attention tile, shared by flash_attention.cu (K3: the
// mma.sync face at hd 32; the softmax pieces in every face) and the
// prefill face of paged_attention.cu (K1b, K1c prefill).
//
// One warp owns MT blocks of 16 query rows (MT = 2 in K3, as in
// FlashAttention-2: every K or V fragment it reads serves both blocks).
// Q and a tile of BK = 64 keys sit in shared memory as bf16 rows of HD
// (any multiple of 16), laid out so that the 8 row addresses of an
// ldmatrix fall in 8 different 16-byte bank groups: a row of a multiple
// of 8 chunks (hd 64, 128) is stored densely with its chunks
// XOR-swizzled by row % 8 inside each aligned group of 8; any other row
// (hd 32, 80, 96) is padded by one chunk, to an odd number of chunks,
// so that consecutive rows start 16 bytes apart modulo 128. Per tile:
//
//   qk()             S = Q K^T with mma.sync.m16n8k16 (bf16 in, f32 out);
//   online_softmax() (softmax_p() then rescale())
//                    the row max and row sum of the S fragments, reduced
//                    across the 4 lanes of a quad with shuffles (no
//                    shared-memory round trip), the rescale of the
//                    accumulator, and S replaced by p = exp(s - m) in f32;
//   pv()             O += P V, with P rounded to bf16 as it is packed
//                    into the A fragments (the reference mha_ref does the
//                    same: probs.astype(v.dtype)), V read with
//                    ldmatrix.trans.
//
// Numerics, the TPU kernels' contract: scores in f32, a masked score is
// the fill NEG_INF (-1e30) and its p is 0 whatever the max, l is summed
// in f32 from the unrounded p, and finalize() divides by l, or by 1 for
// a row that saw no key (its accumulator is zero, so it emits zeros).
// The softmax scale is applied inside the exponent (exp2 of an FFMA).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane L holds rows
// L / 4 and L / 4 + 8 of the 16, and columns 2 (L % 4) and 2 (L % 4) + 1
// of each 8-column block; c[n][0..1] is the first row, c[n][2..3] the
// second.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tile {

constexpr int BK = 64;                          // keys per tile
constexpr float NEG_INF = -1e30f;               // the masked-score fill
constexpr float LOG2E = 1.4426950408889634f;

// elements of one shared-memory row of a [rows, HD] tile
template <int HD>
__host__ __device__ constexpr int row_elems() {
  static_assert(HD % 16 == 0, "the tile's k-steps are 16 wide");
  return (HD / 8) % 8 == 0 ? HD : HD + 8;
}

// element offset of (row, 16-byte chunk) in a [rows, HD] tile; the chunk
// stays inside its row for every HD the tile takes
template <int HD>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr ((HD / 8) % 8 == 0)
    return row * HD + ((chunk ^ (row & 7)) << 3);
  else
    return row * row_elems<HD>() + (chunk << 3);
}

// The f32 paths' thread map (not the tensor-core tile): accumulator i of
// thread tid holds element tid + i * NT of a [rows, HD] output. Its (row,
// hd column) starts at (tid / HD, tid % HD) and steps from one i to the
// next here, without a division; where HD divides NT the column stays.
template <int HD, int NT>
__device__ __forceinline__ void next_elem(int& row, int& col) {
  row += NT / HD;
  col += NT % HD;
  if (NT % HD != 0 && col >= HD) {
    col -= HD;
    ++row;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
// (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's commit groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b, one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (relative error ~2^-22; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// s[mt] = Q K^T for the warp's MT row blocks of 16 (rows row0 + 16 mt
// .. of the swizzled Q tile qs) over the BK keys of the tile ks (raw dot
// products, f32). Each K fragment read from shared memory serves all MT
// blocks; the Q fragments are read per 16-column slice.
template <int HD, int MT>
__device__ __forceinline__ void qk(float (&s)[MT][BK / 8][4],
                                   const __nv_bfloat16* qs, int row0,
                                   const __nv_bfloat16* ks) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], qs + swz<HD>(row0 + mt * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8,
                                  kk * 2 + (lane >> 4)));
#pragma unroll
    for (int n16 = 0; n16 < BK / 16; ++n16) {
      uint32_t b[4];
      ldsm_x4(b, ks + swz<HD>(n16 * 16 + (lane & 7) + (lane >> 4) * 8,
                              kk * 2 + ((lane >> 3) & 1)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(s[mt][2 * n16], a[mt], b[0], b[1]);
        mma(s[mt][2 * n16 + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// Fold one block's tile of raw scores (f32 dot products, times a
// per-key factor where the caller has one; masked entries exactly
// NEG_INF) into its rows' running max m (raw units) and sum l (this
// lane's columns only; the quad's partial sums are added in finalize).
// p = exp2(s * c - m * c) with c = scale * log2 e: one FFMA and one MUFU
// exp2 per score. A masked score's p underflows to exactly 0, also in a
// row that has seen no key yet (its max is NEG_INF and its offset 0),
// which is p = where(mask, exp(scale * (s - m)), 0). On return s holds p
// in f32 and alpha the factor by which the rows' accumulator must be
// rescaled (rescale(); the wgmma face applies it once its P V product of
// the previous tile has landed).
// (N8 8-key column groups: a tile of 8 * N8 keys.)
template <int N8>
__device__ __forceinline__ void softmax_p(float (&s)[N8][4], float (&m)[2],
                                          float (&l)[2], float scale_log2,
                                          float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < N8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    base[r] = mx[r] == NEG_INF ? 0.f : mx[r] * scale_log2;
    alpha[r] = exp2_approx(m[r] * scale_log2 - base[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < N8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(s[n][e], scale_log2, -base[e >> 1]));
      s[n][e] = p;
      l[e >> 1] += p;
    }
  }
}

// o *= alpha per row; once the row maxima settle, alpha is exactly 1 for
// the whole warp and nothing is multiplied
template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 8][4],
                                        const float (&alpha)[2]) {
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
  }
}

// softmax_p, then the accumulator o rescaled at once
template <int HD>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 8][4],
                                               float (&o)[HD / 8][4],
                                               float (&m)[2], float (&l)[2],
                                               float scale_log2) {
  float alpha[2];
  softmax_p(s, m, l, scale_log2, alpha);
  rescale<HD>(o, alpha);
}

// o[mt] += P V for the tile vs and the warp's MT row blocks; P is
// rounded to bf16 here. Each V fragment serves all MT blocks.
template <int HD, int MT>
__device__ __forceinline__ void pv(float (&o)[MT][HD / 8][4],
                                   const float (&p)[MT][BK / 8][4],
                                   const __nv_bfloat16* vs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack_bf16(p[mt][2 * kk][0], p[mt][2 * kk][1]);
      a[mt][1] = pack_bf16(p[mt][2 * kk][2], p[mt][2 * kk][3]);
      a[mt][2] = pack_bf16(p[mt][2 * kk + 1][0], p[mt][2 * kk + 1][1]);
      a[mt][3] = pack_bf16(p[mt][2 * kk + 1][2], p[mt][2 * kk + 1][3]);
    }
#pragma unroll
    for (int nn = 0; nn < HD / 16; ++nn) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + swz<HD>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                nn * 2 + (lane >> 4)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(o[mt][2 * nn], a[mt], b[0], b[1]);
        mma(o[mt][2 * nn + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// o /= l (the quad's summed l; 1 for a row that saw no key)
template <int HD>
__device__ __forceinline__ void finalize(float (&o)[HD / 8][4],
                                         float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    o[n][0] *= l[0];
    o[n][1] *= l[0];
    o[n][2] *= l[1];
    o[n][3] *= l[1];
  }
}

// Store a block's 16 rows of o as bf16: row_ptr(r) is the output row r
// (0..15 of the block) or null for a row past the end.
template <int HD, typename RowPtr>
__device__ __forceinline__ void store_rows(const float (&o)[HD / 8][4],
                                           RowPtr row_ptr) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* dst = row_ptr((lane >> 2) + r * 8);
    if (dst == nullptr) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8 + (lane & 3) * 2) =
          pack_bf16(o[n][2 * r], o[n][2 * r + 1]);
  }
}

}  // namespace tile
