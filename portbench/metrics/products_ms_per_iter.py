"""products_ms_per_iter (ms): device milliseconds of the matrix products
(cuBLAS and CUTLASS kernels, by name) in the profiled stretch, over its
decode iterations; a prefill inside the stretch counts its products too.
Layer: model (``models/model.py``, ``models/layers.py``: dense products
and the MoE's expert products)."""
import re

from portbench.bounds import kernel_seconds

PATTERN = re.compile(r"gemm|gemv|xmma|cutlass|cublas|nvjet", re.I)


def read(rec: dict):
    prof = rec.get("profile")
    ticks = [t for t in rec["ticks"] if t["profiled"]]
    iters = sum(t["horizon"] for t in ticks)
    if not prof or not iters:
        return None
    t = kernel_seconds(prof, PATTERN)
    return 1e3 * t / iters if t > 0 else None
