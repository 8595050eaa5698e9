// Fused STEP step scorer: sigmoid(relu(h @ W1 + b1) @ W2 + b2) in f32, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/step_score.py::_scorer_kernel
// (pallas_call at step_score.py:55), which the engine fuses into every
// decode iteration of the kernel path.
//
// What bounds it on the H100: f32 operations, then bytes. The body is a
// [B, D] x [D, 512] product; at the decode batch (B = 64, D = 2560) it
// does 2*B*D*512 = 168 MFLOP over the 5.2 MB of f32 W1. In full f32 (no
// tensor cores: TF32 would round the scorer's inputs) that is 2.5 us at
// 67 TFLOP/s, against 1.6 us to read W1 at 3.35 TB/s. The design keeps
// the [B, 512] hidden activations on chip (ReLU, the W2 dot and the
// sigmoid happen in registers and shared memory), reuses each W1 element
// for 8 lanes from a register, and reads W1 row-major, neighbouring
// threads on neighbouring addresses.
//
// Design (right and simple first): one CTA per LANES = 8 lanes, one
// thread per hidden unit j (blockDim = 512). The lanes' hidden rows are
// staged in shared memory in D-chunks of DCHUNK, cast to f32; thread j
// accumulates sum_d h[b, d] * W1[d, j] for its 8 lanes in registers, then
// applies ReLU(+b1) and the W2[j] weight, and a block reduction (warp
// shuffles, then shared memory) gives each lane's logit. Every CTA reads
// all of W1, so at B = 64 the 8 CTAs read it 8 times (mostly from L2):
// splitting D across more CTAs is the obvious next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 8;      // batch rows per CTA
constexpr int DCHUNK = 256;   // hidden-row chunk staged in shared memory
constexpr int MAX_WARPS = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename HT>
__global__ void step_score_kernel(const HT* __restrict__ h,
                                  const float* __restrict__ w1,
                                  const float* __restrict__ b1,
                                  const float* __restrict__ w2,
                                  const float* __restrict__ b2,
                                  float* __restrict__ out, int B, int D) {
  __shared__ float h_s[LANES][DCHUNK];
  __shared__ float red[LANES][MAX_WARPS];
  const int j = threadIdx.x;          // hidden unit
  const int hidden = blockDim.x;
  const int b0 = blockIdx.x * LANES;
  const int nb = min(LANES, B - b0);

  float acc[LANES];
#pragma unroll
  for (int bb = 0; bb < LANES; ++bb) acc[bb] = 0.f;
  for (int d0 = 0; d0 < D; d0 += DCHUNK) {
    const int nd = min(DCHUNK, D - d0);
    for (int e = j; e < LANES * DCHUNK; e += hidden) {
      const int bb = e / DCHUNK, d = e % DCHUNK;
      h_s[bb][d] = bb < nb && d < nd
                       ? to_f32(h[(size_t)(b0 + bb) * D + d0 + d])
                       : 0.f;
    }
    __syncthreads();
    for (int d = 0; d < nd; ++d) {
      const float w = w1[(size_t)(d0 + d) * hidden + j];
#pragma unroll
      for (int bb = 0; bb < LANES; ++bb) acc[bb] += h_s[bb][d] * w;
    }
    __syncthreads();
  }

  const float bias = b1[j], w2j = w2[j];
  const int warp = j / 32, lane = j % 32;
#pragma unroll
  for (int bb = 0; bb < LANES; ++bb) {
    float z = fmaxf(acc[bb] + bias, 0.f) * w2j;
    for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
    if (lane == 0) red[bb][warp] = z;
  }
  __syncthreads();
  if (j < nb) {  // thread j finishes lane b0 + j
    float logit = 0.f;
    for (int w = 0; w < hidden / 32; ++w) logit += red[j][w];
    logit += b2[0];
    out[b0 + j] = 1.f / (1.f + expf(-logit));
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success). h_bf16: 1 for a bf16 hidden, 0 for f32. hidden (W1's second
// dim) is the block size: a multiple of 32, at most 1024.
extern "C" int repro_step_score(const void* h, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                int B, int D, int hidden, int h_bf16,
                                void* stream) {
  if (hidden % 32 != 0 || hidden > 32 * MAX_WARPS || hidden < LANES)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + LANES - 1) / LANES);
  cudaStream_t st = (cudaStream_t)stream;
  if (h_bf16) {
    step_score_kernel<__nv_bfloat16><<<grid, hidden, 0, st>>>(
        (const __nv_bfloat16*)h, (const float*)w1, (const float*)b1,
        (const float*)w2, (const float*)b2, (float*)out, B, D);
  } else {
    step_score_kernel<float><<<grid, hidden, 0, st>>>(
        (const float*)h, (const float*)w1, (const float*)b1,
        (const float*)w2, (const float*)b2, (float*)out, B, D);
  }
  return (int)cudaGetLastError();
}
