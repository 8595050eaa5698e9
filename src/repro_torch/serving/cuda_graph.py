"""The fused decode horizon as one device call: a CUDA graph per
``(horizon, lanewise)`` key.

The JAX engine runs its K-iteration decode horizon as one jitted device
call (``repro/serving/engine.py``, ``make_decode``). Its counterpart
here captures the function ``Engine`` builds for a key once, as a
``torch.cuda.CUDAGraph``, and replays it once per scheduler tick.

A :class:`DecodeGraph` holds

  * the static inputs: tokens, positions, limits, block tables and, for
    the lane-wise sampler, the temperature / top-k / top-p arrays.
    :meth:`DecodeGraph.run` copies the caller's tensors into them before
    it replays, on the same stream, so a caller may hand the last tick's
    static outputs back as inputs;
  * the static outputs: the seven tensors the decode step returns besides
    the cache and the generator. Each replay overwrites them, so the
    caller consumes them before the next call;
  * the graph, captured over one set of params, pool (and recurrent
    state) tensors and generator. Every later call must pass the same
    ones (the engine keeps one pool for its lifetime); other ones raise.
    A hybrid (zamba2) cache holds both the pools and the recurrent state:
    the check covers every cache tensor.

The first call captures. A warm-up call on a side stream comes first
(cuBLAS handles and workspaces, the kernels' libraries), made free of
side effects: every lane's limit is 0, so each KV write lands in the
scratch block, whose contents it puts back afterwards (the hybrid's
frozen lanes read that block and carry it into their recurrent state);
the recurrent state is a zeroed stand-in; it draws from a throwaway
generator; and it counts no kernel launch. The capture, with Python's
cyclic collector paused (:func:`collector_paused`), then
registers the engine's generator, so that each replay advances its
Philox offset as the eager calls would. The kernel launches that the
wrappers count while the capture records them are kept, and each replay
adds them to ``kernels.ops``' counts (``decode_graph_captures`` and
``decode_graph_replays`` count the rest). A failed capture or replay
raises: nothing falls back to the eager horizon.

Graphs of one engine share one memory pool. That is safe because the
graphs replay one at a time on one stream and no static output is read
after another replay: the scheduler copies each burst to the host at
once, and the inputs are copied in before a replay starts.

On a CPU engine the same class stages inputs and outputs the same way but
calls the function itself: the CPU has no graph.

With the engine's tracer on (``serving/tracing.py``), a capture is a
``capture`` span (its seconds are ``capture_s``; its ``launches``, the
kernel launches it recorded, show which route the graph's decode glue
took: ``models/layers.py::glue_route``), and each call a
``launch`` span around the input copies and the replay, with the device's
``decode`` span inside it.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.serving.tracing import NULL_TRACER

# cache entries every lane's decode writes (the ssm and hybrid stacks'
# per-slot state); a stopped lane's KV writes go to the scratch block
RECURRENT = ("ssm_state", "conv_state")
N_OUTPUTS = 7   # tokens, confidences, scores, token_valid, score_valid,
#                 final_tokens, positions


@contextlib.contextmanager
def collector_paused():
    """Collect garbage now, then keep Python's cyclic collector off for the
    block: a collection that an allocation triggers during a capture can
    destroy an unreachable ``CUDAGraph``, whose reset is not permitted
    while a stream captures and invalidates the capture."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class DecodeGraph:
    """One decode-horizon function (the engine's ``batched_decode`` for a
    key) as one device call; call it as that function. ``tracer`` returns
    the tracer to record into (the engine's, read at each call)."""

    def __init__(self, fn: Callable, device: torch.device, pool=None,
                 scratch_block: int = 0, key: tuple = (),
                 tracer: Callable = lambda: NULL_TRACER):
        self.fn = fn
        self.key = key
        self.tracer = tracer
        self.device = device
        self.pool = pool
        self.scratch_block = scratch_block
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: Optional[tuple] = None
        self.outputs: Optional[tuple] = None
        self.launches: Dict[str, int] = {}   # kernel launches per replay
        self.capture_s = 0.0
        self._bound = None

    def run(self, params, cache, tokens, positions, limits, block_tables,
            rng, scorer_params, *samp):
        """Copy the inputs into the static buffers, replay (or, on the
        CPU, call), and return the decode step's nine-tuple: the static
        outputs, then ``cache`` and ``rng``."""
        args = (tokens, positions, limits, block_tables, *samp)
        bound = (params, rng, scorer_params,
                 {k: v.data_ptr() for k, v in cache.items()})
        if self.inputs is None:
            self._bound = bound
            self.inputs = tuple(a.clone() for a in args)
        elif not (all(a is b for a, b in zip(bound[:3], self._bound[:3]))
                  and bound[3] == self._bound[3]):
            raise RuntimeError(
                "decode graph called with other params, generator or pool "
                "tensors than the ones it was captured over")
        tracer = self.tracer()
        if self.device.type == "cuda" and self.graph is None:
            self._capture(params, cache, rng, scorer_params, tracer)
        with tracer.span("launch"), tracer.device("decode"):
            for dst, src in zip(self.inputs, args):
                dst.copy_(src)
            if self.graph is not None:
                self.graph.replay()
                kops.add_launches(self.launches)
                kops.GRAPHS["decode_graph_replays"] += 1
            else:
                out = self._call(params, cache, rng, scorer_params)
                if self.outputs is None:
                    self.outputs = tuple(torch.empty_like(t)
                                         for t in out[:N_OUTPUTS])
                for dst, src in zip(self.outputs, out[:N_OUTPUTS]):
                    dst.copy_(src)
        return (*self.outputs, cache, rng)

    __call__ = run

    def _call(self, params, cache, rng, scorer_params):
        tokens, positions, limits, block_tables, *samp = self.inputs
        return self.fn(params, cache, tokens, positions, limits,
                       block_tables, rng, scorer_params, *samp)

    def _capture(self, params, cache, rng, scorer_params, tracer) -> None:
        t0 = time.perf_counter_ns()
        stand_in = {k: torch.zeros_like(v) if k in RECURRENT else v
                    for k, v in cache.items()}
        scratch = {k: v[:, self.scratch_block].clone()
                   for k, v in cache.items() if k not in RECURRENT}
        self.inputs[2].zero_()   # limits: every lane stopped
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with kops.launches_withheld(), torch.cuda.stream(side):
            self._call(params, stand_in, torch.Generator(self.device),
                       scorer_params)
        current.wait_stream(side)
        for k, v in scratch.items():
            cache[k][:, self.scratch_block] = v
        del stand_in, scratch
        graph = torch.cuda.CUDAGraph()
        if rng is not None:
            graph.register_generator_state(rng)
        with collector_paused(), kops.launches_withheld() as made, \
                torch.cuda.graph(graph, pool=self.pool):
            out = self._call(params, cache, rng, scorer_params)
        self.graph, self.launches = graph, dict(made)
        self.outputs = tuple(out[:N_OUTPUTS])
        t1 = time.perf_counter_ns()
        self.capture_s = (t1 - t0) / 1e9
        tracer.add("capture", t0, t1, key=list(self.key),
                   launches=dict(made))
        kops.GRAPHS["decode_graph_captures"] += 1
