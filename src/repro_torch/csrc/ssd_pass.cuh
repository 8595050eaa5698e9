// The SSD scan's state passing, shared by both faces of K4 (ssd_scan.cu,
// the tile face, and ssd_wgmma.cu): in chunk order, st[b, c, h] <- h_in[c]
// (the state entering chunk c, h_in[0] = 0, h_in[c + 1] = exp(cs_last[c])
// h_in[c] + st[c]) and h_out <- the state after the last chunk. Each
// thread owns V consecutive elements of [B, H, P, N] and reads chunk
// c + 1 while it updates chunk c. Bound by bytes: the chunk states read
// and written once.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int PASS_NT = 256;  // threads per CTA

template <int V>
__global__ void __launch_bounds__(PASS_NT)
    pass_kernel(const float* __restrict__ cs, float* __restrict__ st,
                float* __restrict__ h_out, int B, int S, int H, int P, int N,
                int l) {
  const size_t PN = (size_t)P * N;
  const size_t idx = ((size_t)blockIdx.x * PASS_NT + threadIdx.x) * V;
  if (idx >= (size_t)B * H * PN) return;
  const int nc = S / l;
  const size_t bh = idx / PN, e = idx % PN;
  const size_t b = bh / H, h = bh % H;
  auto load = [&](int c, float (&v)[V]) {
    const float* p = st + ((b * nc + c) * H + h) * PN + e;
    if constexpr (V == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else {
      v[0] = *p;
    }
  };
  float run[V] = {}, cur[V], nxt[V];
  load(0, cur);
  for (int c = 0; c < nc; ++c) {
    const size_t bch = (b * nc + c) * H + h;
    if (c + 1 < nc) load(c + 1, nxt);
    const float decay = expf(cs[bch * l + l - 1]);  // exp(cs_last) <= 1
    float* p = st + bch * PN + e;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) =
          make_float4(run[0], run[1], run[2], run[3]);
    } else {
      *p = run[0];
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      run[k] = decay * run[k] + cur[k];
      cur[k] = nxt[k];
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) h_out[idx + k] = run[k];
}

// Launch the pass on `s` over [B, H, P, N] (four elements a thread where
// P N allows); returns the launch's CUDA error
inline cudaError_t launch_pass(const float* cs, float* st, float* h_out,
                               int B, int S, int H, int P, int N, int l,
                               cudaStream_t s) {
  const size_t elems = (size_t)B * H * P * N;
  if ((size_t)P * N % 4 == 0) {
    pass_kernel<4><<<(unsigned)((elems / 4 + PASS_NT - 1) / PASS_NT),
                     PASS_NT, 0, s>>>(cs, st, h_out, B, S, H, P, N, l);
  } else {
    pass_kernel<1><<<(unsigned)((elems + PASS_NT - 1) / PASS_NT), PASS_NT,
                     0, s>>>(cs, st, h_out, B, S, H, P, N, l);
  }
  return cudaGetLastError();
}

}  // namespace
