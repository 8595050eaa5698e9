"""idle_gap_ms_per_iter (ms): the card's idle time per decode iteration,
from the program's own trace (``repro_torch.serving.tracing``): the gaps
between consecutive device calls of one serve (every call the engine
makes, each on CUDA events put on the host's clock), before the profiled
stretch, less the host's sleeps for arrivals (``await_arrival``), over
the window's decode iterations. ``_spans.idle_by_phase`` splits it by the
host's phase. Layer: device."""
from portbench.metrics._spans import idle_by_phase


def read(rec: dict):
    phases = idle_by_phase(rec)
    if phases is None:
        return None
    return sum(v for k, v in phases.items() if k != "await_arrival")
