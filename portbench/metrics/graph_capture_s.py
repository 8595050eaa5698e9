"""graph_capture_s (s, host clock): the seconds the program spent
capturing its decode graphs in the run (its ``capture`` spans, one per
graph key; the warm-up captures them, and the window should add none),
from its own trace (``repro_torch.serving.tracing``). 0 where no graph is
captured (the CPU). Layer: steps (``serving/cuda_graph.py``)."""
from portbench.metrics._spans import spans


def read(rec: dict):
    sp = spans(rec)
    if sp is None:
        return None
    return sum(s[1] - s[0] for s in sp.host if s[2] == "capture") / 1e6
