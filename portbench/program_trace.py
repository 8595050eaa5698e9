"""The program's own tracer in a traced run: ``repro_torch.serving.tracing``
set on the engine before its warm-up (``attach``), and its export put into
the run's record under ``program_trace`` (``export``) for the readers of
``metrics/_spans.py``. The runner (``drive.py``) and ``run.py`` call
neither yet, and ``BENCHMARK.json`` names none of those readers: wiring
the two calls in and registering the readers is one change to the
benchmark. Until then the tests call them around the runner.

A program without the tracer (an older checkout) gets none: the record's
``program_trace`` is then None and those readers report nothing.

The benchmark's tracer enters no ``record_function`` ranges: the profiled
stretch's reduction (``profiling.py``) counts every range it does not
name as a device operation, since the profiler copies each range onto the
device's timeline.
"""
from __future__ import annotations

from typing import Optional


def attach(engine) -> bool:
    """Set a tracer on ``engine``; False if the program has none."""
    try:
        from repro_torch.serving.tracing import Tracer
    except ImportError:
        return False
    engine.tracer = Tracer(profiler_ranges=False)
    return True


def export(engine, origin_s: float) -> Optional[dict]:
    """The engine's trace, its times in microseconds after ``origin_s`` (a
    ``time.perf_counter()`` reading: the recorder's origin); None where no
    tracer recorded."""
    tracer = getattr(engine, "tracer", None)
    if not getattr(tracer, "enabled", False):
        return None
    return tracer.export(origin_s)
