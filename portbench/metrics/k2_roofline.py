"""k2_roofline (%): the fused step scorer's bound over the device time of
the kernels that score (``csrc/step_score.cu``: ``score_kernel`` and its
dependent ``finish_kernel``) in the profiled stretch. One call per decode
iteration over the whole batch (max_batch lanes): it reads W1 [D, 512],
b1, w2, b2 (f32) and the batch's hidden states (bf16) and writes one f32
score per lane; its products, in three bf16 pieces of W1, run at a third
of the 989 TFLOP/s bf16 peak. The bound is the larger of bytes over
3.35 TB/s and operations over that rate. Layer: kernels
(``kernels/step_score.py``)."""
import re

from portbench.bounds import (BF16, F32, HBM_BYTES_PER_S, PEAK_BF16_FLOPS,
                              kernel_seconds)

PATTERN = re.compile(r"(?<![A-Za-z_])score_kernel|(?<![A-Za-z_])finish_kernel")
SCORER_HIDDEN = 512


def bound_s(lanes: int, d: int, hidden: int = SCORER_HIDDEN) -> float:
    nbytes = F32 * (d * hidden + 2 * hidden + 1 + lanes) + BF16 * lanes * d
    flops = 2.0 * lanes * (d * hidden + hidden)
    return max(nbytes / HBM_BYTES_PER_S, flops / (PEAK_BF16_FLOPS / 3))


def read(rec: dict):
    prof = rec.get("profile")
    if not prof:
        return None
    iters = sum(t["horizon"] for t in rec["ticks"] if t["profiled"])
    t = kernel_seconds(prof, PATTERN)
    if not iters or t <= 0:
        return None
    lanes = rec["mix"]["engine"]["max_batch"]
    return 100.0 * iters * bound_s(lanes, rec["cfg"]["d_model"]) / t
