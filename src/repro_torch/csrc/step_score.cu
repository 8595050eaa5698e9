// Fused STEP step scorer: sigmoid(relu(h @ W1 + b1) @ W2 + b2) in f32, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/step_score.py::_scorer_kernel
// (pallas_call at step_score.py:55), which the engine fuses into every
// decode iteration of the kernel path.
//
// What bounds it on the H100: bytes, and before them latency. The body is
// a [B, D] x [D, Hd] product with Hd = 512; at the serve phases' decode
// batch (B = 16, D = 2560) it does 2*B*D*Hd = 42 MFLOP over the 5.2 MB
// of f32 W1: 1.6 us to read W1 at 3.35 TB/s against 0.6 us of f32
// operations at 67 TFLOP/s (no tensor cores: TF32 would round the
// scorer's inputs). W1 has to be spread over the whole card for the read
// to go at that rate.
//
// Design: two launches, deterministic (no float atomics: the scores decide
// which trace is pruned, so they must not change from run to run).
//   1. partial_kernel: the grid is (D-slices of DK = 64 rows) x (hidden
//      tiles of HT = 128 units) x (lane tiles of BT = 16 lanes), 40 x 4 x 1
//      = 160 CTAs at the serve batch. Each CTA reads its [DK, HT] W1 tile
//      once with 16-byte loads into shared memory, stages h's [BT, DK]
//      slice in f32, and writes the partial pre-activations
//      sum_{d in slice} h[b, d] W1[d, j] to a [slices, B, Hd] f32
//      workspace (1.3 MB at B = 16). Thread (u, g) owns units 4u..4u+3 for
//      lanes LPT g .. LPT g + LPT - 1: per row one float4 of W1
//      (consecutive threads on consecutive 16 B) and LPT broadcast h
//      values for 4 LPT FMAs.
//   2. finish_kernel: one CTA per lane sums the slices in a fixed order
//      (two halves of the slices, 16-byte loads, then the halves added),
//      adds b1, applies ReLU, takes the dot with W2 (warp shuffles, then
//      shared memory in warp order), adds b2 and applies the sigmoid. It
//      is launched as a programmatic dependent of pass 1: its CTAs start
//      and read b1, W2 and b2 while pass 1 runs, then wait for it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int DK = 64;    // W1 rows per slice
constexpr int HT = 128;   // hidden units per CTA of pass 1
constexpr int BT = 16;    // lanes per CTA of pass 1
constexpr int NT = 256;   // threads per CTA (both passes)
// pass 1: thread (u, g) owns units 4u..4u+3 of its tile for LPT lanes
constexpr int UT = HT / 4;          // unit threads
constexpr int LPT = BT / (NT / UT);  // lanes per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    partial_kernel(const T* __restrict__ h, const float* __restrict__ w1,
                   float* __restrict__ part, int B, int D, int Hd) {
  __shared__ __align__(16) float w_s[DK * HT];
  __shared__ float h_s[BT * (DK + 1)];
  // let the second launch start now: it reads its weights, then waits
  // for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int d0 = blockIdx.x * DK, j0 = blockIdx.y * HT, b0 = blockIdx.z * BT;
  const int nd = min(DK, D - d0), nj = min(HT, Hd - j0), nb = min(BT, B - b0);
  // the W1 tile, all of it in flight at once (16-byte asynchronous copies,
  // zero-filled outside W1; Hd is a multiple of 32, so a float4 of units
  // is all in or all out)
#pragma unroll
  for (int k = 0; k < DK * HT / 4 / NT; ++k) {
    const int e = threadIdx.x + k * NT;
    const int d = e / (HT / 4), j = 4 * (e % (HT / 4));
    const bool ok = d < nd && j < nj;
    const float* src = ok ? w1 + (size_t)(d0 + d) * Hd + j0 + j : w1;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"((unsigned)__cvta_generic_to_shared(w_s + d * HT + j)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < BT * DK / NT; ++k) {
    const int e = threadIdx.x + k * NT, bb = e / DK, d = e % DK;
    h_s[bb * (DK + 1) + d] =
        bb < nb && d < nd ? to_f32(h[(size_t)(b0 + bb) * D + d0 + d]) : 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int u = threadIdx.x % UT, g = threadIdx.x / UT;
  float acc[LPT][4] = {};
#pragma unroll 8
  for (int d = 0; d < DK; ++d) {
    const float4 w = ld4(w_s + d * HT + 4 * u);
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const float hv = h_s[(LPT * g + k) * (DK + 1) + d];
      acc[k][0] = fmaf(hv, w.x, acc[k][0]);
      acc[k][1] = fmaf(hv, w.y, acc[k][1]);
      acc[k][2] = fmaf(hv, w.z, acc[k][2]);
      acc[k][3] = fmaf(hv, w.w, acc[k][3]);
    }
  }
  if (4 * u >= nj) return;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int bb = LPT * g + k;
    if (bb < nb)
      *reinterpret_cast<float4*>(
          part + ((size_t)blockIdx.x * B + b0 + bb) * Hd + j0 + 4 * u) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  }
}

// Thread t sums units 4g..4g+3 (g = t % 128, then g + 128, ...) over one
// half of the slices (t / 128); the halves are added in order after.
__global__ void __launch_bounds__(NT)
    finish_kernel(const float* __restrict__ part, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  float* __restrict__ out, int B, int Hd, int slices) {
  __shared__ __align__(16) float half_s[2 * 1024];
  __shared__ float red[NT / 32];
  // b1, W2 and b2 do not depend on the first launch: read them before
  // waiting for it (programmatic dependent launch)
  float b1v[1024 / NT], w2v[1024 / NT];
#pragma unroll
  for (int k = 0; k < 1024 / NT; ++k) {
    const int j = threadIdx.x + k * NT;
    b1v[k] = j < Hd ? b1[j] : 0.f;
    w2v[k] = j < Hd ? w2[j] : 0.f;
  }
  const float bias2 = b2[0];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int b = blockIdx.x, half = threadIdx.x / 128;
  const int s0 = half ? (slices + 1) / 2 : 0;
  const int s1 = half ? slices : (slices + 1) / 2;
  for (int g = threadIdx.x % 128; g < Hd / 4; g += 128) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 10
    for (int s = s0; s < s1; ++s) {
      const float4 v = ld4(part + ((size_t)s * B + b) * Hd + 4 * g);
      a.x += v.x, a.y += v.y, a.z += v.z, a.w += v.w;
    }
    *reinterpret_cast<float4*>(half_s + half * 1024 + 4 * g) = a;
  }
  __syncthreads();
  float z = 0.f;
#pragma unroll
  for (int k = 0; k < 1024 / NT; ++k) {
    const int j = threadIdx.x + k * NT;
    if (j < Hd) z += fmaxf(half_s[j] + half_s[1024 + j] + b1v[k], 0.f) * w2v[k];
  }
  for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = z;
  __syncthreads();
  if (threadIdx.x == 0) {
    float logit = 0.f;
    for (int w = 0; w < NT / 32; ++w) logit += red[w];
    logit += bias2;
    out[b] = 1.f / (1.f + expf(-logit));
  }
}

}  // namespace

// W1 rows per slice: the first dimension of the workspace is
// ceil(D / repro_step_score_slice_rows()).
extern "C" int repro_step_score_slice_rows() { return DK; }

// Launch both passes on `stream`; returns 0 on success, else the CUDA
// error of the first refused launch (cudaErrorInvalidValue for a width the
// kernel does not take). h [B, D] (h_bf16: 1 for bf16, 0 for f32); w1
// [D, hidden] f32, 16-byte aligned; b1, w2 [hidden]; b2 [1]; out [B];
// part: the [ceil(D / 64), B, hidden] f32 workspace. hidden is a multiple
// of 32 in [32, 1024].
extern "C" int repro_step_score(const void* h, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                void* part, int B, int D, int hidden,
                                int h_bf16, void* stream) {
  if (hidden % 32 != 0 || hidden < 32 || hidden > 1024 || B < 1 || D < 1 ||
      (uintptr_t)w1 % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int slices = (D + DK - 1) / DK;
  const dim3 grid(slices, (hidden + HT - 1) / HT, (B + BT - 1) / BT);
  if (h_bf16) {
    partial_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        (const __nv_bfloat16*)h, (const float*)w1, (float*)part, B, D,
        hidden);
  } else {
    partial_kernel<float><<<grid, NT, 0, st>>>(
        (const float*)h, (const float*)w1, (float*)part, B, D, hidden);
  }
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  // the second launch may start while the first runs (Hopper's
  // programmatic dependent launch); it waits for it before reading `part`
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(NT);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, finish_kernel, (const float*)part,
                                 (const float*)b1, (const float*)w2,
                                 (const float*)b2, (float*)out, B, hidden,
                                 slices);
}
