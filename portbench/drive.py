"""Drive the system under test, ``repro_torch.serving.Engine``, through a
cell's traffic, and record what the metrics read.

The benchmark's own spans and counters sit around its calls into the
engine and around the engine's calls into its steps (an ``Engine``
subclass wraps each decode tick and, in a traced run, each prefill):
ticks, decode iterations, live lane-iterations and the context each of
them attended over, prefill tokens, and the prune decisions of the STEP
policy. A traced run also profiles a bounded stretch of decode ticks
(``torch.profiler``, device and host activity) in the middle of the
window.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import List, Optional

import numpy as np
import torch

from portbench import traffic as T
from portbench.profiling import Profile


@dataclasses.dataclass
class Tick:
    t0: float
    t1: float
    horizon: int
    live: int = 0          # live lane-iterations
    ctx: int = 0           # sum of their attended lengths
    kv_slots: int = 0      # distinct pool slots they read, per iteration
    profiled: bool = False  # inside the profiled stretch
    traced: bool = False    # the profiler was on (the stretch's first
    #                         tick, which pays for its start, is not in it)
    d0: Optional[float] = None   # on the card: its start and end, ms after
    d1: Optional[float] = None   # the window's first mark


@dataclasses.dataclass
class Prefill:
    t0: float
    t1: float
    tokens: int
    ctx: int               # sum over its tokens of the attended length
    profiled: bool = False
    traced: bool = False
    d0: Optional[float] = None
    d1: Optional[float] = None


class Recorder:
    """What one run counts, and the profiled stretch of a traced run."""

    def __init__(self, trace: bool, cuda: bool, profile_ticks: int = 0):
        self.trace = trace
        self.cuda = cuda
        self.ticks: List[Tick] = []
        self.prefills: List[Prefill] = []
        self.prunes: List[tuple] = []        # (victim score, least, n)
        self.iterations = 0
        self.origin = time.perf_counter()
        # seconds after ``origin``; the window sets it (no stretch in the
        # warm-up)
        self.profile_at = math.inf
        self.profile_ticks = profile_ticks
        self.profile: Optional[Profile] = None
        self._profiled = 0
        self.origin_mark = None
        self.block_size = 16     # the pool's slots per block (Runner sets)

    def now(self) -> float:
        return time.perf_counter() - self.origin

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        """A CUDA event recorded now on the current stream (None on the
        CPU); the first one, :meth:`start_marks`, is the origin of the
        device times ``d0``/``d1``."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start_marks(self) -> None:
        self.origin_mark = self.mark()

    def device_ms(self, ev) -> Optional[float]:
        """ms from the origin mark to ``ev`` (both complete)."""
        if ev is None or self.origin_mark is None:
            return None
        return self.origin_mark.elapsed_time(ev)

    @property
    def profiling(self) -> bool:
        return self.profile is not None and self.profile.active

    @property
    def in_stretch(self) -> bool:
        """The profiler is on and past the stretch's first tick."""
        return self.profiling and self._profiled > 0

    def before_tick(self) -> None:
        if (self.trace and self.profile_ticks and self.profile is None
                and self.now() >= self.profile_at):
            self.sync()
            self.profile = Profile(self.cuda)
            self.profile.start(self.now())

    def after_tick(self) -> None:
        if self.profiling:
            self._profiled += 1
            if self._profiled > self.profile_ticks:
                self.sync()
                self.profile.stop(self.now())


class TickProbe:
    """One decode tick: the engine's decode step for a key, counted and,
    in a traced run, timed to the end of its device work."""

    def __init__(self, fn, horizon: int, rec: Recorder):
        self.fn, self.horizon, self.rec = fn, horizon, rec

    def __call__(self, *args):
        rec = self.rec
        rec.iterations += self.horizon
        if not rec.trace:
            return self.fn(*args)
        rec.before_tick()
        traced = rec.profiling
        t0 = rec.now()
        with _span("decode_tick", traced):
            e0 = rec.mark()
            out = self.fn(*args)
            e1 = rec.mark()
            rec.sync()
        tick = Tick(t0, rec.now(), self.horizon, traced=traced,
                    profiled=traced and rec._profiled > 0,
                    d0=rec.device_ms(e0), d1=rec.device_ms(e1))
        valid = out[3].to("cpu", torch.int64)            # token_valid [B, K]
        pos = args[3].to("cpu", torch.int64)             # write positions [B]
        n = valid.sum(dim=1)
        tick.live = int(n.sum())
        # lane b attends over pos_b + k + 1 slots at its iteration k
        tick.ctx = int((n * (pos + 1) + n * (n - 1) // 2).sum())
        tick.kv_slots = distinct_slots(args[5].cpu().numpy(), pos.numpy(),
                                       valid.numpy().astype(bool),
                                       rec.block_size)
        rec.ticks.append(tick)
        rec.after_tick()
        return out


def distinct_slots(tables: np.ndarray, pos: np.ndarray, valid: np.ndarray,
                   block: int) -> int:
    """Pool slots the live lanes attend over, summed over a tick's
    iterations, each physical block's slots counted once per iteration
    (lanes that share a prefix share its blocks): ``tables`` [B, pages]
    the lanes' block tables, ``pos`` [B] their write positions at the
    tick's start, ``valid`` [B, K] their live iterations."""
    total = 0
    page = np.arange(tables.shape[1])
    for k in range(valid.shape[1]):
        lanes = valid[:, k]
        if not lanes.any():
            continue
        length = pos[lanes] + k + 1
        slots = np.clip(length[:, None] - block * page[None, :], 0, block)
        ids, slots = tables[lanes][slots > 0], slots[slots > 0]
        most = np.zeros(int(tables.max()) + 1, dtype=np.int64)
        np.maximum.at(most, ids, slots)
        total += int(most.sum())
    return total


def _span(name: str, on: bool):
    if on:
        return torch.profiler.record_function(name)
    return _Null()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def instrumented(engine_cls, rec: Recorder):
    """``engine_cls`` with its decode ticks probed."""

    class Probed(engine_cls):
        def decode_fn(self, horizon, lanewise=False):
            return TickProbe(super().decode_fn(horizon, lanewise), horizon,
                             rec)

    return Probed


def probe_prefills(engine, rec: Recorder) -> None:
    """In a traced run, count and time the engine's prefill calls: the
    one-shot ``_prefill`` (tokens [1, S] from position 0) and the chunked
    ``_chunk_prefill`` (valid tokens of a chunk after its prefix)."""
    one, chunk = getattr(engine, "_prefill", None), \
        getattr(engine, "_chunk_prefill", None)

    def timed(fn, count):
        def call(*args):
            t0, traced = rec.now(), rec.profiling
            with _span("prefill", traced):
                e0 = rec.mark()
                out = fn(*args)
                e1 = rec.mark()
                rec.sync()
            tokens, ctx = count(*args)
            rec.prefills.append(Prefill(
                t0, rec.now(), tokens, ctx, rec.in_stretch, traced,
                rec.device_ms(e0), rec.device_ms(e1)))
            return out
        return call

    def count_one(params, tokens):
        S = int(tokens.shape[-1])
        return S, S * (S + 1) // 2

    def count_chunk(params, cache, tokens, positions, valid, block_tables):
        n = int(valid.sum())
        p0 = int(positions.reshape(-1)[0])
        return n, n * (p0 + 1) + n * (n - 1) // 2

    if one is not None:
        engine._prefill = timed(one, count_one)
    if chunk is not None:
        engine._chunk_prefill = timed(chunk, count_chunk)


def recording_policy(step_cls, rec: Recorder):
    """A STEP policy that keeps, for each prune, the victim's score, the
    least score among the candidates and their number."""

    class RecordingStep(step_cls):
        def on_memory_full(self, running, pressure=None):
            victim = super().on_memory_full(running, pressure)
            if victim is not None:
                cands = [t.score for t in running if t.alive]
                rec.prunes.append((victim.score, min(cands), len(cands)))
            return victim

    return RecordingStep()


class Runner:
    """One cell's engine, built once and driven through warm-up and the
    window."""

    def __init__(self, rt, cfg: dict, mix: dict, params: dict, scorer: dict,
                 seed: int, device, rec: Recorder):
        self.rt, self.cfg, self.mix, self.rec = rt, cfg, mix, rec
        E = rt.engine
        eng = mix["engine"]
        n_new = mix["max_new_tokens"]
        if n_new > cfg["max_new_tokens"]:
            raise ValueError(f"the mix asks {n_new} new tokens, the "
                             f"configuration at most {cfg['max_new_tokens']}")
        Sp = rt.sampling.SamplingParams
        self.sampling = Sp(max_new_tokens=n_new, **mix["sampling"])
        ecfg = E.EngineConfig(
            max_batch=eng["max_batch"], num_blocks=cfg["num_blocks"],
            capacity=eng["capacity"], max_new_tokens=n_new,
            sampling=self.sampling, use_kernel="auto", seed=seed,
            prefill_chunk_size=eng.get("prefill_chunk_size"),
            prefix_cache=bool(eng["prefix_cache"]
                              and cfg.get("prefix_cache", True)),
            decode_horizon=eng["decode_horizon"], faults=None,
            kv_dtype="bf16")
        self.engine = instrumented(E.Engine, rec)(
            params, rt.model_config(cfg), ecfg, self.policy(),
            scorer_params=scorer, device=device)
        rec.block_size = cfg.get("kv_block_size", 16)
        if rec.trace:
            probe_prefills(self.engine, rec)

    def policy(self):
        return recording_policy(self.rt.pruning.StepPolicy, self.rec)

    def request(self, p: T.Problem, rid: int, max_new: Optional[int] = None):
        return self.rt.engine.Request(
            request_id=rid, prompt_tokens=list(p.prompt),
            n_traces=p.n_traces, policy=self.policy(),
            arrival_time=p.arrival_s, sampling=self.sampling,
            max_new_tokens=max_new or p.max_new_tokens)

    def warm_up(self) -> None:
        """Serve two short problems of the mix, one after the other in
        the closed loop and together in the open loop (one prompt twice
        there): its prefill paths and its decode graphs."""
        plan = T.problems(self.mix, 0, 1.0 / self.mix.get("rate_per_s", 1.0))
        short = 2 * self.mix["engine"]["decode_horizon"] + 2
        reqs = [self.request(dataclasses.replace(p, arrival_s=0.0), -1 - i,
                             short) for i, p in enumerate((plan * 2)[:2])]
        if self.mix["loop"] == "closed":
            for r in reqs:
                self.engine.serve_batch([r])
        else:
            self.engine.serve_batch(reqs)
        self.rec.ticks.clear()
        self.rec.prefills.clear()
        self.rec.prunes.clear()
        self.rec.iterations = 0

    def window(self, plan: List[T.Problem], seconds: float) -> dict:
        """Serve ``plan``: closed loop until the problem in flight at
        ``seconds`` is answered, open loop every problem at its arrival.
        Returns the run's problems with their results and times (seconds
        from the window's start)."""
        rec = self.rec
        rec.profile_at = rec.now() + seconds * self.mix.get(
            "profile_from", 0.3)
        if rec.trace:
            rec.start_marks()
        t0 = time.perf_counter()
        served = []
        if self.mix["loop"] == "closed":
            for p in plan:
                ts = time.perf_counter() - t0
                res = self.engine.serve_batch([self.request(p, p.index)])[0]
                te = time.perf_counter() - t0
                served.append({"problem": p, "result": res,
                               "arrival_s": ts, "finished_s": te,
                               "start_s": ts})
                if te >= seconds:
                    break
            else:
                raise RuntimeError(f"the mix's {len(plan)} problems ran out "
                                   f"before {seconds} s")
        else:
            results = self.engine.serve_batch(
                [self.request(p, p.index) for p in plan])
            for p, res in zip(plan, results):
                m = res.metrics
                served.append({"problem": p, "result": res,
                               "arrival_s": p.arrival_s,
                               "finished_s": m.finished_s, "start_s": 0.0})
        window_s = time.perf_counter() - t0
        if rec.profile is not None:
            rec.sync()
            rec.profile.stop(rec.now())
        return {"served": served, "window_s": window_s,
                "origin_s": t0 - rec.origin}

    def close(self) -> None:
        self.engine = None
        gc.collect()
        if self.rec.cuda:
            torch.cuda.empty_cache()


def serve_once(rt, cfg: dict, mix: dict, params: dict, scorer: dict,
               seed: int, device, seconds: float) -> tuple:
    """Build the engine, warm it up, serve ``mix`` for ``seconds`` and
    free it (untraced): (the window, its recorder)."""
    rec = Recorder(False, device != "cpu")
    runner = Runner(rt, cfg, mix, params, scorer, seed, device, rec)
    runner.warm_up()
    out = runner.window(T.problems(mix, seed, seconds), seconds)
    runner.close()
    return out, rec
