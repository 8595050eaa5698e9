"""ttft_p90_s (s): 90th percentile of the time from a problem's scheduled
arrival to its first generated token (any trace), from the engine's
``RequestMetrics``; over the problems answered before the profiled
stretch began. Layer: entry (``serving/engine.py`` ``Engine.serve_batch``,
``serving/metrics.py``)."""
from portbench.bounds import percentile
from portbench.metrics._window import unprofiled


def read(rec: dict):
    return percentile([p["first_token_s"] - p["arrival_s"]
                       for p in unprofiled(rec)
                       if p["first_token_s"] is not None], 90)
