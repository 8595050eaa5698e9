"""queue_wait_p90_s (s): 90th percentile of the time from a problem's
scheduled arrival to the admission of its first trace, from the engine's
``RequestMetrics``; over the problems answered before the profiled
stretch began. Layer: scheduler (``serving/scheduler.py``, ``kv_manager.py``,
``prefix_cache.py``)."""
from portbench.bounds import percentile
from portbench.metrics._window import unprofiled


def read(rec: dict):
    return percentile([p["admitted_s"] - p["arrival_s"]
                       for p in unprofiled(rec)
                       if p["admitted_s"] is not None], 90)
