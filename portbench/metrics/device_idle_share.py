"""device_idle_share (%): share of the window before the profiled
stretch in which the card (one H100) ran none of the engine's device
calls: CUDA events on the stream around each decode tick (one graph
replay) and each prefill give their spans on the card, and the idle
share is one minus their sum over the time from the first span's start
to the last one's end. Work the engine puts on the card outside them
(first-token sampling, the block copies) counts as idle. Layer: device."""
from portbench.metrics._window import before_stretch


def read(rec: dict):
    spans = sorted((t["d0"], t["d1"]) for key in ("ticks", "prefills")
                   for t in before_stretch(rec, key))
    if len(spans) < 2:
        return None
    window = spans[-1][1] - spans[0][0]
    busy = sum(b - a for a, b in spans)
    return 100.0 * (1.0 - busy / window) if window > 0 else None
