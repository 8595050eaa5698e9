"""CUDA kernels (sm_90a) for the serving hot spots the paper optimizes,
the counterparts of the JAX package's Pallas kernels.

  flash_attention         — one-shot prefill attention (tensor-core
                            tiles, online softmax, SWA)
  paged_attention         — decode attention over the paged KV pool
                            (pages over warps, split-K decode; what the
                            fused decode horizon calls)
  paged_attention_prefill — chunked prefill over pooled prefix + exact
                            own-chunk KV (the multi-query face)
  ssd_scan                — Mamba2 SSD chunked scan (mamba2/zamba2)
  step_score              — fused STEP scorer MLP over decode hiddens
  ssm_decode              — Mamba2's one-token state update (no Pallas
                            counterpart: the JAX package leaves it to XLA)
  add_rms_norm, attn_prologue, silu_mul
                          — the decode layer's elementwise glue between
                            its products (decode_glue; no Pallas
                            counterpart either: XLA fuses it)

``ops`` also exposes ``paged_attention[_prefill]_sharded`` — the
routes mesh engines use (a rank's lanes on "data", its pool KV heads on
"model").

``ops`` holds the wrappers (the plain PyTorch version on a CPU tensor,
the kernel on a CUDA tensor, built at first CUDA use), their launch
counts and their build; ``ref`` holds the oracles, under the JAX
package's names and layouts, that the tests assert against.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
