"""pruned_share (%): traces the STEP policy pruned over traces started,
from the window's ``RequestResult``s. Layer: scheduler / pruning
(``core/pruning.py`` ``StepPolicy``, the memory-aware trigger)."""


def read(rec: dict):
    traces = sum(p["traces"] for p in rec["problems"])
    if not traces:
        return None
    return 100.0 * sum(p["pruned"] for p in rec["problems"]) / traces
