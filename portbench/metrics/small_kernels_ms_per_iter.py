"""small_kernels_ms_per_iter (ms): device milliseconds of the profiled
stretch's operations that are neither matrix products
(``products_ms_per_iter``'s pattern) nor the decode attention
(``k1a_roofline``'s) nor the step scorer (``k2_roofline``'s), over the
stretch's decode iterations. That is the glue between a layer's products
(norms, RoPE, the K/V write, SwiGLU's gate: PyTorch's elementwise, copy
and reduction kernels, or the fused ``csrc/decode_glue.cu``), the
sampler's sorts, the MoE's dispatch and the copies; a prefill inside the
stretch counts its own. Layer: model (``models/model.py``,
``models/layers.py``, ``kernels/decode_glue.py``)."""
from portbench.metrics.k1a_roofline import PATTERN as K1A
from portbench.metrics.k2_roofline import PATTERN as K2
from portbench.metrics.products_ms_per_iter import PATTERN as PRODUCTS


def read(rec: dict):
    prof = rec.get("profile")
    iters = sum(t["horizon"] for t in rec["ticks"] if t["profiled"])
    if not prof or not iters:
        return None
    t = sum(d for name, d in prof["ops"]
            if not any(p.search(name) for p in (PRODUCTS, K1A, K2)))
    return 1e3 * t / iters if t > 0 else None
