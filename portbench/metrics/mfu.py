"""mfu (%): the model's operations for the tokens processed before the
profiled stretch (each live lane's decode iteration and each prefill
token: two per weight it multiplies through, an MoE token its router and
its two experts, plus the attention over its context), over the seconds
from the first of those device calls' start to the last one's end on the
card, times the H100's 989 TFLOP/s in bf16. Frozen lanes, which the
decode batch still carries, do no useful work and count nothing.
Layer: the model step, whole."""
from portbench.bounds import PEAK_BF16_FLOPS, model_flops
from portbench.metrics._window import before_stretch


def read(rec: dict):
    ticks = before_stretch(rec, "ticks")
    pre = before_stretch(rec, "prefills")
    calls = ticks + pre
    if not ticks:
        return None
    seconds = (max(c["d1"] for c in calls) - min(c["d0"] for c in calls)) / 1e3
    tokens = sum(t["live"] for t in ticks) + sum(p["tokens"] for p in pre)
    ctx = sum(t["ctx"] for t in ticks) + sum(p["ctx"] for p in pre)
    if seconds <= 0 or not tokens:
        return None
    return 100.0 * model_flops(rec["cfg"], tokens, ctx) / (
        seconds * PEAK_BF16_FLOPS)
