"""The serving engine: vLLM-V1-style continuous batching, in PyTorch.

Ported from ``repro/serving/engine.py``; the host-side scheduling is the
same code (``serving/scheduler.py``), so everything its docstring says
about STEP pruning vs. baseline preemption, continuous batching, chunked
prefill, prefix sharing, the cross-request prefix cache, the decode
horizon and the Table-3 latency accounting holds here too.

What differs is the device side:

  * the steps are plain callables over torch tensors instead of jitted
    functions; the paged KV pool is updated in place where the JAX engine
    donated it to its jitted steps;
  * the engine runs on one device, CUDA unless the caller asks for the
    CPU (``device="cpu"``, as the tests do). With no card it raises; it
    never slides onto the CPU;
  * ``use_kernel`` routes the paged attention (decode and chunked
    prefill) and the fused step scorer through the port's CUDA kernels
    (``kernels/``); on a CPU engine the same wrappers run their plain
    PyTorch versions. ``"auto"`` picks the kernels on CUDA, dense on the
    CPU;
  * the ssm stack (mamba2) has no KV pool: its blocks are accounting
    only, and its device state is one recurrent state per decode slot
    (``ssm_state`` / ``conv_state``), written at admission, cleared at
    release and updated in place by every decode iteration, as the JAX
    engine does with its per-slot state. The hybrid (zamba2) has both:
    a paged pool for its shared-attention invocations and the per-slot
    state of its Mamba2 layers. Like the JAX engine, both fall back to
    one-shot prefill, switch the prefix cache off, and refuse an
    int8/fp8 pool;
  * the engine RNG is a ``torch.Generator`` on the engine's device;
  * on a CUDA engine each ``(horizon, lanewise)`` decode horizon is one
    device call, as the JAX engine's jitted horizon is: a CUDA graph,
    captured at its first tick and replayed at every later one
    (``serving/cuda_graph.py``). A CPU engine stages its inputs and
    outputs the same way and runs the horizon eagerly. The engine keeps
    one device pool (and recurrent state) for its lifetime, zeroed in
    place where the JAX engine makes a fresh one, so that the graphs
    keep reading the storage they were captured over.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pruning import DeepConfPolicy, PruningPolicy
from repro_torch.core.scorer import scorer_score
from repro_torch.core.trace import Trace, TraceStatus
from repro_torch.data.tokenizer import get_tokenizer
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import kv_quant
from repro_torch.models.model import (POOL_KEYS, copy_kv_block,
                                      forward_full,
                                      init_decode_cache, multi_decode_step,
                                      prefill_chunk_step,
                                      supports_chunked_prefill,
                                      write_pool_kv)
from repro_torch.serving.cuda_graph import DecodeGraph
from repro_torch.serving.faults import FaultPlan, FaultStats, RecoveryConfig
from repro_torch.serving.kv_manager import BlockManager
from repro_torch.serving.metrics import RequestMetrics
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampling import (SamplingParams, sample_logits,
                                          sample_logits_lanes)
from repro_torch.serving.scheduler import (SLO, ReqState, SchedulerCore,
                                           SchedulingPolicy,
                                           default_scheduler)


def _default_use_kernel():
    """``EngineConfig.use_kernel`` default from ``REPRO_USE_KERNEL``
    ("1"/"on"/"true" -> True, "auto" -> "auto", anything else -> False)."""
    val = os.environ.get("REPRO_USE_KERNEL", "").strip().lower()
    if val in ("1", "on", "true"):
        return True
    if val == "auto":
        return "auto"
    return False


def _default_prefix_cache():
    """``EngineConfig.prefix_cache`` default from ``REPRO_PREFIX_CACHE``
    ("0"/"off"/"false" -> off, anything else incl. unset -> on)."""
    val = os.environ.get("REPRO_PREFIX_CACHE", "").strip().lower()
    return val not in ("0", "off", "false")


def _default_faults():
    """``EngineConfig.faults`` default from ``REPRO_FAULTS`` (a fault-plan
    spec string, see ``serving/faults.py``; unset/empty -> none)."""
    val = os.environ.get("REPRO_FAULTS", "").strip()
    return val or None


def _default_kv_dtype():
    """``EngineConfig.kv_dtype`` default from ``REPRO_KV_DTYPE``
    (unset/empty -> "bf16")."""
    return os.environ.get("REPRO_KV_DTYPE", "").strip().lower() or "bf16"


def resolve_use_kernel(setting, device: torch.device) -> bool:
    """Resolve ``EngineConfig.use_kernel`` (False / True / "auto") to the
    bool the steps consume. "auto" picks the CUDA kernels on a CUDA
    engine and the dense path on a CPU engine (where the kernel wrappers
    would only run their plain versions); ``True`` on a CPU engine runs
    those plain versions, as interpret mode does for the JAX package."""
    if setting is False or setting is None:
        return False
    if setting not in (True, "auto"):
        raise ValueError(
            f"use_kernel must be True, False or 'auto', got {setting!r}")
    if setting == "auto":
        return device.type == "cuda"
    return True


@dataclasses.dataclass
class EngineConfig:
    """Static engine resources (the 'GPU')."""
    max_batch: int = 64            # decode slots (>= trace budget N)
    num_blocks: int = 128          # paged pool blocks incl. scratch
    capacity: int = 512            # per-sequence token capacity (window)
    max_new_tokens: int = 160
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # Kernel path for the paged attention (decode + chunked prefill) and
    # the fused step scorer. False = dense torch; True = always the
    # kernel wrappers; "auto" = kernels on CUDA, dense on the CPU.
    use_kernel: "bool | str" = dataclasses.field(
        default_factory=_default_use_kernel)
    seed: int = 0
    # Prefill the prompt once per request and fork its blocks into every
    # trace (COW on first trace-private write). False = per-trace prefill.
    share_prompt_prefix: bool = True
    # Chunked prefill chunk size; None = one-shot prefill.
    prefill_chunk_size: Optional[int] = None
    # Per-tick token budget shared by decode and prefill tokens.
    max_tokens_per_step: Optional[int] = None
    # Cross-request prefix cache (radix tree of parked KV blocks).
    prefix_cache: bool = dataclasses.field(
        default_factory=_default_prefix_cache)
    # Decode horizon: K decode iterations per device call / host sync.
    decode_horizon: int = 1
    # Deterministic fault injection plan (serving/faults.py grammar).
    faults: Optional[str] = dataclasses.field(default_factory=_default_faults)
    # Paged-pool storage dtype: "f32" | "bf16" | "int8" | "fp8". The
    # quantized pools keep one f32 scale per (layer, block, slot, kv head)
    # beside them (models/kv_quant.py); dense GQA models only.
    kv_dtype: str = dataclasses.field(default_factory=_default_kv_dtype)

    # env var -> (field, parser, minimum), as in the JAX package
    _ENV_FIELDS = {
        "REPRO_MAX_BATCH": ("max_batch", int, 1),
        "REPRO_NUM_BLOCKS": ("num_blocks", int, 2),
        "REPRO_CAPACITY": ("capacity", int, 1),
        "REPRO_MAX_NEW_TOKENS": ("max_new_tokens", int, 1),
        "REPRO_SEED": ("seed", int, 0),
        "REPRO_PREFILL_CHUNK": ("prefill_chunk_size", int, 1),
        "REPRO_MAX_TOKENS_PER_STEP": ("max_tokens_per_step", int, 1),
        "REPRO_DECODE_HORIZON": ("decode_horizon", int, 1),
    }

    @classmethod
    def from_env(cls, **overrides) -> "EngineConfig":
        """Build an ``EngineConfig`` from ``REPRO_*`` environment
        variables; explicit keyword ``overrides`` win over the
        environment, which wins over the dataclass defaults."""
        kwargs = {}
        for env_name, (field, parse, lo) in cls._ENV_FIELDS.items():
            raw = os.environ.get(env_name, "").strip()
            if not raw:
                continue
            try:
                val = parse(raw)
            except ValueError:
                raise ValueError(
                    f"{env_name}={raw!r}: expected an integer >= {lo}"
                ) from None
            if val < lo:
                raise ValueError(
                    f"{env_name}={raw!r}: expected an integer >= {lo}")
            kwargs[field] = val
        kwargs.update(overrides)
        return cls(**kwargs)


@dataclasses.dataclass
class Request:
    """One unit of work for the scheduler: a prompt and a trace budget
    (see ``repro/serving/engine.py::Request`` for every field)."""
    request_id: int
    prompt_tokens: List[int]
    n_traces: int
    policy: Optional[PruningPolicy] = None
    arrival_time: float = 0.0
    sampling: Optional[SamplingParams] = None
    max_new_tokens: Optional[int] = None
    tenant: str = "default"
    priority: int = 0
    slo: Optional[SLO] = None
    deadline: Optional[float] = None


@dataclasses.dataclass
class RequestResult:
    request_id: int
    answer: Optional[str]
    traces: List[Trace]
    latency_s: float
    total_tokens: int
    wait_s: float
    decode_s: float
    prefill_s: float
    num_pruned: int
    num_preemptions: int
    peak_blocks_used: int = 0
    metrics: Optional[RequestMetrics] = None
    # "completed" | "cancelled" | "deadline_exceeded" | "failed"
    status: str = "completed"


class Engine:
    """Continuous-batching engine over a queue of requests, each fanning
    out into N parallel traces (``serve`` for one problem, ``serve_batch``
    for cross-request contention and online arrivals).

    ``params`` / ``scorer_params`` are the port's dicts of tensors (see
    ``models.init`` / ``models.bridge``); they are moved to ``device``.
    ``mesh`` (multi-GPU serving) is ROADMAP A10 and raises.
    ``_eager_decode`` calls the decode horizon directly instead of through
    its :class:`DecodeGraph`: for tests that hold the graphs against the
    eager horizon, not for serving."""

    def __init__(self, params: dict, cfg: ModelConfig, ecfg: EngineConfig,
                 policy: PruningPolicy,
                 scorer_params: Optional[dict] = None,
                 mesh=None,
                 scheduler: Optional[SchedulingPolicy] = None,
                 device=None, _eager_decode: bool = False):
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is not ported to repro_torch yet (ROADMAP A10)")
        self.device = resolve_device(device)
        self.params = _tree_to(params, self.device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.policy = policy
        self.scorer_params = (None if scorer_params is None
                              else _tree_to(scorer_params, self.device))
        self.scheduler = (scheduler if scheduler is not None
                          else default_scheduler())
        self.tok = get_tokenizer()
        bs = cfg.kv_block_size
        self.blocks_per_seq = -(-ecfg.capacity // bs)
        self._chunk_supported = supports_chunked_prefill(cfg)
        kv_quant.resolve_kv_dtype(ecfg.kv_dtype, cfg, self._chunk_supported)
        self.kv_block_bytes = kv_quant.pool_block_bytes(cfg, ecfg.kv_dtype)
        self.block_mgr = BlockManager(ecfg.num_blocks, bs,
                                      bytes_per_block=self.kv_block_bytes)
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(ecfg.seed)
        self.prefix_cache: Optional[PrefixCache] = None
        if (ecfg.prefix_cache and ecfg.share_prompt_prefix
                and self._chunk_supported):
            self.prefix_cache = PrefixCache(self.block_mgr)
        # with the cache on, the device KV pool's contents outlive a
        # serve_batch call
        self._kv_cache = None
        self._pool: Optional[dict] = None   # the device pool, for life
        self._eager_decode = _eager_decode
        self.use_kernel = resolve_use_kernel(ecfg.use_kernel, self.device)
        if ecfg.decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        self.horizon_fallbacks = 0
        self.fault_plan: Optional[FaultPlan] = (
            FaultPlan.parse(ecfg.faults, seed=ecfg.seed)
            if ecfg.faults else None)
        self.recovery = RecoveryConfig()
        self.fault_stats = FaultStats()
        self.force_horizon1 = False
        self._cancel_requests: set = set()
        self.last_event_log: list = []
        self._build_steps()

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------
    def _build_steps(self):
        cfg, ecfg = self.cfg, self.ecfg
        has_scorer = self.scorer_params is not None
        sp = ecfg.sampling
        V = cfg.vocab_size  # mask vocab padding out of the sampler
        eos_id = self.tok.eos_id
        step_id = self.tok.step_id
        use_kernel = self.use_kernel
        # Fused step scorer: on the kernel path the scorer MLP runs as the
        # step_score kernel inside the decode burst.
        self.fused_scorer = bool(has_scorer and use_kernel)

        def mask_vocab(logits):
            logits[..., V:] = -torch.inf
            return logits

        def make_decode(horizon, lanewise=False):
            """Fused K-iteration decode for (horizon, lanewise); the
            lane-wise variant takes per-lane temperature/top-k/top-p."""

            @torch.no_grad()
            def batched_decode(params, cache, tokens, positions, limits,
                               block_tables, rng, scorer_params, *samp):
                if not has_scorer:
                    score_fn = None
                elif self.fused_scorer:
                    def score_fn(h):
                        return kops.step_score_params(h, scorer_params)
                else:
                    def score_fn(h):
                        return scorer_score(scorer_params, h)
                if lanewise:
                    temps, topks, topps = samp

                    def sample_fn(g, logits):
                        return sample_logits_lanes(g, mask_vocab(logits),
                                                   temps, topks, topps)
                else:
                    def sample_fn(g, logits):
                        return sample_logits(
                            g, mask_vocab(logits),
                            temperature=sp.temperature, top_k=sp.top_k,
                            top_p=sp.top_p)
                out = multi_decode_step(
                    params, cfg, tokens, positions, limits,
                    {**cache, "block_tables": block_tables},
                    window_len=ecfg.capacity, horizon=horizon, rng=rng,
                    sample_fn=sample_fn, eos_id=eos_id, step_id=step_id,
                    score_fn=score_fn,
                    scratch_block=self.block_mgr.scratch_block,
                    use_kernel=use_kernel)
                return (out["tokens"], out["confidences"], out["scores"],
                        out["token_valid"], out["score_valid"],
                        out["final_tokens"], out["positions"], out["cache"],
                        rng)

            return batched_decode

        self._make_decode = make_decode
        self._decode_fns: Dict[Tuple[int, bool], Callable] = {}
        # one memory pool for this build's decode graphs
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda"
                            and not self._eager_decode else None)

        @torch.no_grad()
        def prefill(params, tokens):
            out = forward_full(params, cfg, tokens, return_kv=True)
            return mask_vocab(out["logits"]), out["kvs"]

        self._prefill = prefill

        @torch.no_grad()
        def write_kv(sub_cache, kvs):
            return write_pool_kv(cfg, sub_cache, kvs)

        self._write_kv = write_kv

        if self._chunk_supported:
            @torch.no_grad()
            def chunk_prefill(params, cache, tokens, positions, valid,
                              block_tables):
                out = prefill_chunk_step(
                    params, cfg, tokens, positions, valid,
                    {**cache, "block_tables": block_tables},
                    window_len=ecfg.capacity, use_kernel=use_kernel)
                new_cache = out["cache"]
                new_cache.pop("block_tables", None)
                return mask_vocab(out["logits"]), new_cache

            self._chunk_prefill = chunk_prefill

        @torch.no_grad()
        def copy_block(cache, src, dst):
            return copy_kv_block(cfg, cache, src, dst)

        self._copy_block = copy_block

    def decode_fn(self, horizon: int, lanewise: bool = False) -> Callable:
        """The fused decode step for ``(horizon, lanewise)``: its
        :class:`DecodeGraph` (captured at its first call on a CUDA
        engine), or the function itself under ``_eager_decode``."""
        key = (horizon, lanewise)
        fn = self._decode_fns.get(key)
        if fn is None:
            fn = self._make_decode(horizon, lanewise)
            if not self._eager_decode:
                fn = DecodeGraph(fn, self.device, self._graph_pool,
                                 self.block_mgr.scratch_block)
            self._decode_fns[key] = fn
        return fn

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Upload a host array (a copy: the scheduler keeps mutating its
        numpy state after the upload)."""
        return torch.tensor(np.asarray(arr), device=self.device)

    # ------------------------------------------------------------------
    # host-side sampling (prefill first tokens)
    # ------------------------------------------------------------------
    def sample_host(self, logits, sp: SamplingParams):
        """Sample one token per row of ``logits`` with scalar params from
        the engine generator."""
        return sample_logits(self._rng, logits, temperature=sp.temperature,
                             top_k=sp.top_k, top_p=sp.top_p)

    def sample_host_lanes(self, logits, sps: Sequence[SamplingParams]):
        """Per-row sampling params (mixed-sampling admission waves)."""
        temps = torch.tensor([s.temperature for s in sps],
                             dtype=torch.float32, device=self.device)
        topks = torch.tensor([s.top_k for s in sps], dtype=torch.int32,
                             device=self.device)
        topps = torch.tensor([s.top_p for s in sps], dtype=torch.float32,
                             device=self.device)
        return sample_logits_lanes(self._rng, logits, temps, topks, topps)

    # ------------------------------------------------------------------
    # KV pool handoff (scheduler core <-> persistent prefix-cache pool)
    # ------------------------------------------------------------------
    def _take_kv_cache(self) -> dict:
        """Hand the device KV pool to a scheduler run (the pool persists
        across serve calls while the prefix cache is on)."""
        if self.prefix_cache is not None and self._kv_cache is not None:
            cache, self._kv_cache = self._kv_cache, None
            return cache
        return self._init_cache()

    def _stash_kv_cache(self, cache: dict) -> None:
        if self.prefix_cache is not None:
            self._kv_cache = cache

    # ------------------------------------------------------------------
    # pool accounting
    # ------------------------------------------------------------------
    @property
    def idle_free_blocks(self) -> int:
        cached = (self.prefix_cache.cached_blocks
                  if self.prefix_cache is not None else 0)
        return self.block_mgr.free_blocks + cached

    def pool_drained(self) -> bool:
        """True when no live request holds pool memory (every non-free
        block is parked in the prefix cache at refcount exactly 1)."""
        if self.prefix_cache is not None:
            self.prefix_cache.check_integrity()
            if any(self.block_mgr.ref_count(b) != 1
                   for b in self.prefix_cache.blocks()):
                return False
        return self.idle_free_blocks == self.block_mgr.num_blocks - 1

    # ------------------------------------------------------------------
    # fault tolerance
    # ------------------------------------------------------------------
    def cancel(self, request_id: int) -> None:
        """Flag a request for mid-flight cancellation."""
        self._cancel_requests.add(request_id)

    def degrade_to_dense(self) -> bool:
        """Fault-ladder rung for injected ``DeviceStepFault``s: drop the
        kernel path and rebuild the steps dense (the kernel path's decode
        graphs go with them; dense ones are captured at their first tick).
        A real exception from a kernel build or launch is not caught
        anywhere: it propagates. Returns False when already dense."""
        if not self.use_kernel:
            return False
        self.use_kernel = False
        self._build_steps()
        self.fault_stats.degraded_to_dense += 1
        return True

    def check_integrity(self, expect_open_reservations: int = 0) -> None:
        self.block_mgr.check_integrity(expect_open_reservations)
        if self.prefix_cache is not None:
            self.prefix_cache.check_integrity()
        self.fault_stats.integrity_audits += 1

    # ------------------------------------------------------------------
    # cache plumbing
    # ------------------------------------------------------------------
    def _init_cache(self):
        """Shared pool sized to the engine budget (not per-sequence), as
        ``init_decode_cache`` makes it: made at the first call, then the
        same tensors reset in place (zeros, unit scales), so that a
        captured decode graph keeps reading the storage it was captured
        over."""
        if self._pool is None:
            self._pool = init_decode_cache(
                self.cfg, self.ecfg.max_batch, self.ecfg.capacity,
                num_blocks=self.ecfg.num_blocks, kv_dtype=self.ecfg.kv_dtype,
                device=self.device)
            self._pool.pop("block_tables", None)
            return self._pool
        for key, t in self._pool.items():
            t.fill_(1.0 if key in ("k_scale", "v_scale") else 0.0)
        return self._pool

    def _split_prefill_kvs(self, kvs) -> Tuple[Optional[tuple],
                                               Optional[tuple]]:
        """forward_full(return_kv=True) output of a batch-1 prefill ->
        (paged attention KV | None, per-slot recurrent state | None). The
        hybrid has both: its state comes stacked [G, per, ...] and goes
        into the slot flat over its ``num_layers`` Mamba2 layers."""
        if self.cfg.arch_type == "ssm":
            ss, cs = kvs
            return None, (ss[:, 0], cs[:, 0])
        if self.cfg.arch_type == "hybrid":
            (ss, cs), (k, v) = kvs
            ssf = ss.reshape(-1, *ss.shape[2:])
            csf = cs.reshape(-1, *cs.shape[2:])
            return (k[:, :1], v[:, :1]), (ssf[:, 0], csf[:, 0])
        k, v = kvs
        return (k[:, :1], v[:, :1]), None

    def _write_prefix_kv(self, cache: dict, attn_kvs, block_row: np.ndarray,
                         seq_len: int) -> dict:
        """Write prompt KV into the paged pools ONCE for a block row."""
        if attn_kvs is None:
            return cache
        # a quantized pool's scales ride along with it
        sub = {k: v for k, v in cache.items() if k in POOL_KEYS}
        sub["block_tables"] = self.to_device(block_row[None, :])
        # slots past seq_len take the padding's K/V: attention masks them
        self._write_kv(sub, attn_kvs)
        return cache

    def _write_slot_state(self, cache: dict, slot_state, slot: int) -> dict:
        """Scatter a recurrent (ssm/conv) prefill end state into one decode
        slot, in place (cast to the cache's dtypes: conv_state stays
        bf16)."""
        if slot_state is None:
            return cache
        ss, cs = slot_state
        cache["ssm_state"][:, slot] = ss
        cache["conv_state"][:, slot] = cs
        return cache

    def _write_prefill(self, cache: dict, kvs, slot: int,
                       block_row: np.ndarray, seq_len: int) -> dict:
        """Scatter one trace's prefill KV/state into the shared pool."""
        attn_kvs, slot_state = self._split_prefill_kvs(kvs)
        cache = self._write_prefix_kv(cache, attn_kvs, block_row, seq_len)
        return self._write_slot_state(cache, slot_state, slot)

    def _clear_slot_state(self, cache: dict, slot: int) -> dict:
        """Zero a released slot's recurrent state, in place."""
        if "ssm_state" in cache:
            cache["ssm_state"][:, slot] = 0.0
            cache["conv_state"][:, slot] = 0.0
        return cache

    # ------------------------------------------------------------------
    # request serving
    # ------------------------------------------------------------------
    def serve(self, prompt_tokens: List[int], n_traces: int,
              request_id: int = 0) -> RequestResult:
        """Generate ``n_traces`` parallel traces for one prompt."""
        if n_traces > self.ecfg.max_batch:
            raise ValueError("engine sized per trace budget: n_traces "
                             f"{n_traces} > max_batch {self.ecfg.max_batch}")
        req = Request(request_id=request_id,
                      prompt_tokens=list(prompt_tokens),
                      n_traces=n_traces, policy=self.policy)
        return self.serve_batch([req])[0]

    def serve_batch(self, requests: Sequence[Request],
                    on_complete: Optional[Callable[[RequestResult], None]]
                    = None) -> List[RequestResult]:
        """Serve a queue of requests through one shared decode batch
        (requests join at their ``arrival_time``; ``on_complete`` streams
        each result as its last trace finishes). Results come back in
        submission order."""
        t_start = time.perf_counter()
        states: List[ReqState] = []
        for req in requests:
            if req.policy is not None:
                policy = req.policy
            elif len(requests) == 1:
                policy = self.policy
            else:
                # stateful policies must not leak between requests
                policy = copy.deepcopy(self.policy)
            if isinstance(policy, DeepConfPolicy):
                policy.threshold = None  # fresh threshold per request
            traces = [Trace(trace_id=i, request_id=req.request_id,
                            prompt_tokens=list(req.prompt_tokens))
                      for i in range(req.n_traces)]
            states.append(ReqState(
                req, policy, traces,
                sampling=(req.sampling if req.sampling is not None
                          else self.ecfg.sampling),
                max_new_tokens=(req.max_new_tokens
                                if req.max_new_tokens is not None
                                else self.ecfg.max_new_tokens)))

        if self.fault_plan is not None:
            self.fault_plan.reset()  # replay the identical plan per serve
        core = SchedulerCore(self, states, t_start, on_complete,
                             sched=self.scheduler)
        try:
            peak_blocks = core.run()
        except BaseException:
            # mid-serve crash: drain what the run still held, then re-raise
            core.emergency_drain()
            self.last_event_log = list(core.event_log)
            raise
        self.last_event_log = list(core.event_log)

        t_end = time.perf_counter()
        results = []
        for st in states:
            if st.result is None:  # defensive: finalize stragglers
                st.result = self._finalize(st, t_start, t_end, peak_blocks)
            results.append(st.result)
        return results

    def _finalize(self, st: ReqState, t_start: float, t_end: float,
                  peak_blocks: int) -> RequestResult:
        """Fold one finished request's traces into its RequestResult."""
        finished = [t for t in st.traces if t.status == TraceStatus.FINISHED]
        answer = st.policy.vote(finished) if finished else None
        done = st.t_done if st.t_done is not None else t_end
        total_tokens = sum(t.num_tokens for t in st.traces)
        num_pruned = sum(t.status == TraceStatus.PRUNED for t in st.traces)
        num_failed = sum(t.status == TraceStatus.FAILED for t in st.traces)
        num_preempt = sum(max(t.prefill_count - 1, 0) for t in st.traces)
        wait_s = sum(t.wait_time for t in st.traces)
        metrics = RequestMetrics(
            request_id=st.request_id,
            arrival_s=st.req.arrival_time,
            admitted_s=(st.admit_t - t_start
                        if st.admit_t is not None else None),
            first_token_s=(st.first_token_t - t_start
                           if st.first_token_t is not None else None),
            finished_s=done - t_start,
            prompt_tokens=len(st.req.prompt_tokens),
            output_tokens=total_tokens,
            n_traces=len(st.traces),
            num_pruned=num_pruned,
            num_preemptions=num_preempt,
            wait_s=wait_s, prefill_s=st.prefill_s, decode_s=st.decode_s,
            cached_tokens=st.cached_tokens,
            tenant=getattr(st.req, "tenant", "default"),
            priority=getattr(st.req, "priority", 0),
            degraded_traces=st.degraded_traces,
            slo_ttft_s=(st.req.slo.ttft_s if st.req.slo is not None
                        else None),
            slo_tpot_s=(st.req.slo.tpot_s if st.req.slo is not None
                        else None),
            status=st.final_status,
            failed_traces=num_failed)
        return RequestResult(
            request_id=st.request_id, answer=answer, traces=st.traces,
            latency_s=done - t_start,
            total_tokens=total_tokens,
            wait_s=wait_s,
            decode_s=st.decode_s, prefill_s=st.prefill_s,
            num_pruned=num_pruned,
            num_preemptions=num_preempt,
            peak_blocks_used=peak_blocks,
            metrics=metrics,
            status=st.final_status)


def _tree_to(tree: dict, device: torch.device) -> dict:
    return {k: (_tree_to(v, device) if isinstance(v, dict)
                else v.to(device))
            for k, v in tree.items()}
