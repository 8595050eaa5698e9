"""decode_wall_ms_per_iter (ms): host-clock milliseconds of the decode
ticks (each from the call into the engine's decode step to the end of
its device work) over their decode iterations (each tick's horizon),
with the profiler off. Layer: steps (``serving/engine.py``
``_build_steps``, ``serving/cuda_graph.py`` ``DecodeGraph``)."""


def read(rec: dict):
    ticks = [t for t in rec["ticks"] if not t["traced"]]
    iters = sum(t["horizon"] for t in ticks)
    if not iters:
        return None
    return 1e3 * sum(t["t1"] - t["t0"] for t in ticks) / iters
