// Mamba2's one-token decode state update, fused, for Hopper (sm_90a).
//
// No Pallas counterpart: the JAX package leaves this update to XLA, which
// fuses it inside the jitted decode horizon (src/repro/models/layers.py,
// mamba2_mixer_decode). The port's plain version composes the same ops
// (kernels/ssm_decode.py, ssm_decode_plain). Per layer and decode
// iteration, in place:
//
//   conv  = causal_conv1d_step(conv_state, xbc)        [B, C], C = di + 2N
//   act   = silu(conv), rounded to xbc's dtype; split [x | B | C], x [H, P]
//   dt    = softplus(dt + dt_bias);  dA = exp(dt * -exp(A_log))      [B, H]
//   state = state * dA + (dt x) B^T                    [B, H, P, N] f32
//   y     = state C + x D                              [B, H, P] f32
//   conv_state <- conv_state shifted by one row, xbc appended (bf16)
//
// What bounds it on the H100: bytes. The state is the one large operand
// (16 lanes x 80 heads x 64 x 128 f32 = 41.9 MB per layer at mamba2-2.7b's
// full width): one read and one write of it take 0.025 ms at 3.35 TB/s,
// against 0.001 ms for its ~7 flop per element at 67 TFLOP/s.
//
// Design: two launches.
//   1. conv_kernel: one thread per (lane, channel) computes the depthwise
//      convolution, its bias and the SiLU, rounding where the plain version
//      rounds, into a [B, C] f32 scratch, and shifts that channel's conv
//      state. Only this thread touches the channel, so the in-place shift
//      cannot race. A grid over (lane, head) could not shift in place:
//      every head reads the B and C channels.
//   2. state_kernel: one CTA per (head, lane), launched as a programmatic
//      dependent of pass 1. It loads its [P, N] state tile into registers
//      (16-byte loads, N / 4 threads per row) before it waits for pass 1,
//      since the state does not depend on it. Then it reads x, B and C from
//      the scratch, updates the tile, writes it back once, and reduces y
//      over N with warp shuffles. Every lane's state is updated: the kernel
//      masks nothing (a stopped lane drifts, as in the reference).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per CTA (both passes)
constexpr int MAXW = 8;   // widest convolution window taken
constexpr int RPT = 8;    // state rows a thread holds in registers at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T's precision (the plain version's cast to the params' dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// torch's softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

template <typename T>
__global__ void __launch_bounds__(NT)
    conv_kernel(__nv_bfloat16* __restrict__ conv_state,
                const T* __restrict__ xbc, int xbc_stride,
                const T* __restrict__ w, const T* __restrict__ bias,
                float* __restrict__ act, int C, int W) {
  // let pass 2 start now: it loads its state tile, then waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.y, c = blockIdx.x * NT + threadIdx.x;
  if (c >= C) return;
  __nv_bfloat16* cs = conv_state + (size_t)b * (W - 1) * C + c;
  const float xin = to_f32(xbc[(size_t)b * xbc_stride + c]);
  float v[MAXW];
#pragma unroll
  for (int k = 0; k < MAXW; ++k)
    if (k < W - 1) v[k] = __bfloat162float(cs[(size_t)k * C]);
  // the window in order, the new input last; in the promoted dtype (bf16
  // products are exact in f32, so the sum rounds as the plain version's
  // f32-accumulated product does)
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < MAXW; ++k)
    if (k < W - 1) acc = fmaf(v[k], to_f32(w[(size_t)k * C + c]), acc);
  acc = fmaf(xin, to_f32(w[(size_t)(W - 1) * C + c]), acc);
  const float y = round_to<T>(round_to<T>(acc) + to_f32(bias[c]));
  act[(size_t)b * C + c] = round_to<T>(y / (1.f + expf(-y)));
#pragma unroll
  for (int k = 0; k < MAXW; ++k)
    if (k < W - 2) cs[(size_t)k * C] = __float2bfloat16(v[k + 1]);
  cs[(size_t)(W - 2) * C] = __float2bfloat16(xin);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    state_kernel(float* __restrict__ state, const float* __restrict__ act,
                 const T* __restrict__ dt, int dt_stride,
                 const float* __restrict__ dt_bias,
                 const float* __restrict__ A_log, const float* __restrict__ D,
                 float* __restrict__ y, int H, int P, int N, int C,
                 int lpr_log2) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int q = threadIdx.x & ((1 << lpr_log2) - 1);  // float4 of the row
  const int r0 = threadIdx.x >> lpr_log2, rstep = NT >> lpr_log2;
  float* st = state + ((size_t)b * H + h) * P * N + 4 * q;
  float4 s[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int p = r0 + k * rstep;
    if (p < P) s[k] = *reinterpret_cast<const float4*>(st + (size_t)p * N);
  }
  // dt and the params were written before pass 1 started
  const float dtv = softplus(to_f32(dt[(size_t)b * dt_stride + h]) +
                             dt_bias[h]);
  const float dA = expf(__fmul_rn(dtv, -expf(A_log[h])));
  const float Dh = D[h];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* a = act + (size_t)b * C;
  const float* xh = a + (size_t)h * P;
  const int di = H * P;
  float Bv[4], Cv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    Bv[j] = a[di + 4 * q + j];
    Cv[j] = a[di + N + 4 * q + j];
  }
  for (int p0 = 0; p0 < P; p0 += RPT * rstep) {
    if (p0 > 0) {
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int p = p0 + r0 + k * rstep;
        if (p < P)
          s[k] = *reinterpret_cast<const float4*>(st + (size_t)p * N);
      }
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int p = p0 + r0 + k * rstep;  // one row per aligned lane group
      float part = 0.f, xv = 0.f;
      if (p < P) {
        xv = xh[p];
        const float dx = __fmul_rn(dtv, xv);
        float4 n;
        n.x = __fadd_rn(__fmul_rn(s[k].x, dA), __fmul_rn(dx, Bv[0]));
        n.y = __fadd_rn(__fmul_rn(s[k].y, dA), __fmul_rn(dx, Bv[1]));
        n.z = __fadd_rn(__fmul_rn(s[k].z, dA), __fmul_rn(dx, Bv[2]));
        n.w = __fadd_rn(__fmul_rn(s[k].w, dA), __fmul_rn(dx, Bv[3]));
        *reinterpret_cast<float4*>(st + (size_t)p * N) = n;
        part = fmaf(n.w, Cv[3], fmaf(n.z, Cv[2],
                                     fmaf(n.y, Cv[1], n.x * Cv[0])));
      }
      // every lane shuffles (p is uniform within a row's lane group)
      for (int o = (1 << lpr_log2) >> 1; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (q == 0 && p < P)
        y[((size_t)b * H + h) * P + p] = __fadd_rn(part, __fmul_rn(xv, Dh));
    }
  }
}

template <typename T>
int launch(void* conv_state, void* ssm_state, const void* xbc, int xbc_stride,
           const void* dt, int dt_stride, const void* conv_w,
           const void* conv_b, const void* dt_bias, const void* A_log,
           const void* D, void* act, void* y, int B, int H, int P, int N,
           int W, int lpr_log2, cudaStream_t st) {
  const int C = H * P + 2 * N;
  conv_kernel<T><<<dim3((C + NT - 1) / NT, B), NT, 0, st>>>(
      (__nv_bfloat16*)conv_state, (const T*)xbc, xbc_stride, (const T*)conv_w,
      (const T*)conv_b, (float*)act, C, W);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  // pass 2 may start while pass 1 runs (Hopper's programmatic dependent
  // launch); it waits for pass 1 before reading the scratch
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(NT);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, state_kernel<T>, (float*)ssm_state, (const float*)act,
      (const T*)dt, dt_stride, (const float*)dt_bias, (const float*)A_log,
      (const float*)D, (float*)y, H, P, N, C, lpr_log2);
}

}  // namespace

// Launch both passes on `stream`; returns 0 on success, else the CUDA error
// of the first refused launch (cudaErrorInvalidValue for a shape the kernel
// does not take). conv_state [B, W-1, C] bf16 and ssm_state [B, H, P, N]
// f32, both contiguous, updated in place; xbc [B, C] and dt [B, H] rows
// `xbc_stride` / `dt_stride` elements apart, in bf16 (is_bf16 = 1) or f32,
// as conv_w [W, C] and conv_b [C]; dt_bias, A_log, D [H] f32; act: a [B, C]
// f32 scratch; y [B, H, P] f32. C = H P + 2 N; N / 4 a power of two <= 32;
// 2 <= W <= 8.
extern "C" int repro_ssm_decode(void* conv_state, void* ssm_state,
                                const void* xbc, int xbc_stride,
                                const void* dt, int dt_stride,
                                const void* conv_w, const void* conv_b,
                                const void* dt_bias, const void* A_log,
                                const void* D, void* act, void* y, int B,
                                int H, int P, int N, int W, int is_bf16,
                                void* stream) {
  int lpr_log2 = 0;
  while ((4 << lpr_log2) < N) ++lpr_log2;
  if (B < 1 || H < 1 || P < 1 || N < 4 || (4 << lpr_log2) != N ||
      lpr_log2 > 5 || W < 2 || W > MAXW ||
      (uintptr_t)ssm_state % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16
             ? launch<__nv_bfloat16>(conv_state, ssm_state, xbc, xbc_stride,
                                     dt, dt_stride, conv_w, conv_b, dt_bias,
                                     A_log, D, act, y, B, H, P, N, W,
                                     lpr_log2, st)
             : launch<float>(conv_state, ssm_state, xbc, xbc_stride, dt,
                             dt_stride, conv_w, conv_b, dt_bias, A_log, D,
                             act, y, B, H, P, N, W, lpr_log2, st);
}
