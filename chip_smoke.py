#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device   — the card's name, count, and nvidia-smi's power limit;
  2. build    — nvcc builds every kernel from ``src/repro_torch/csrc``
                (in parallel) and reports registers and spills;
  3. kernels  — each kernel's wrapper against its plain PyTorch version
                on the card, at the main path's full-width shapes;
  4. serve    — STEP serving of qwen3-4b-thinking at full width (random
                seeded weights) under memory pressure through
                ``Engine.serve``, kernels on: launch counts, pruning, a
                drained pool; then the kernel engine against the dense
                engine at the smoke config (f32, greedy tokens identical);
  5. batched  — four requests through ``Engine.serve_batch`` with chunked
                prefill and the prefix cache: the prefill kernel face and
                a prefix-cache hit;
  6. times    — device time of each kernel, its plain version and the
                library yardstick (one CUDA-graph replay per timed call,
                cold L2), and each kernel's bound;
  7. step     — one full-width decode iteration: eager wall time against
                the device time of its CUDA-graph replay.

The line before the last is the kernel table as one JSON object, the last
line ``{"ok": true, "device": {...}}``. Any failed check raises: the
script exits non-zero and prints no result. Without a CUDA device it
exits 2 before doing anything.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense
BF16_TOL = dict(atol=1e-2, rtol=1e-2)   # one bf16 ulp of the output
F32_TOL = dict(atol=1e-4, rtol=1e-4)    # summation order only
SCORE_TOL = dict(atol=1e-5, rtol=1e-5)  # f32 throughout
SEED = 0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(torch.allclose(got, want, **tol),
          f"{name}: max abs err {err} outside {tol}")
    return err


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------

def decode_inputs(g, B, H, KVH, hd, bp, lens, dtype, page=16):
    dev = g.device
    NB = B * bp + 1
    q = torch.randn(B, H, hd, generator=g, device=dev).to(dtype)
    kp = torch.randn(NB, page, KVH, hd, generator=g, device=dev).to(dtype)
    vp = torch.randn(NB, page, KVH, hd, generator=g, device=dev).to(dtype)
    bt = (torch.randperm(NB - 1, generator=g, device=dev)[:B * bp] + 1) \
        .reshape(B, bp).to(torch.int32)
    return q, kp, vp, bt, torch.tensor(lens, dtype=torch.int32, device=dev)


def prefill_inputs(g, C, H, KVH, hd, bp, prefix, nvalid, dtype, page=16):
    dev = g.device
    q, kp, vp, bt, pl = decode_inputs(g, 1, H, KVH, hd, bp, [prefix], dtype,
                                      page)
    q = torch.randn(1, C, H, hd, generator=g, device=dev).to(dtype)
    ok = torch.randn(1, C, KVH, hd, generator=g, device=dev).to(dtype)
    ov = torch.randn(1, C, KVH, hd, generator=g, device=dev).to(dtype)
    nv = torch.tensor([nvalid], dtype=torch.int32, device=dev)
    return q, kp, vp, bt, pl, nv, ok, ov


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "capability": list(torch.cuda.get_device_capability(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("device", **info)
    return info


def phase_build(ops):
    t0 = time.perf_counter()
    logs = ops.build_kernels()
    seconds = time.perf_counter() - t0
    summary = {}
    for src, log in logs.items():
        # ptxas: "Compiling entry function '<mangled>'" ... "Used N registers"
        fns = re.findall(r"Function properties for (\S+)\n(.*?)\n.*?Used (\d+)"
                         r" registers", log, flags=re.S)
        summary[src] = [{"function": f, "spills": s.strip(),
                         "registers": int(r)} for f, s, r in fns]
    emit("build", seconds=round(seconds, 3), ptxas=summary)
    return seconds


def phase_kernels(pa, ss):
    g = torch.Generator(device="cuda").manual_seed(SEED)
    H, KVH, hd, bp = 32, 8, 128, 32
    scale = 1.0 / math.sqrt(hd)
    errs = {}
    # K1a: decode face, B = 64, ragged lengths incl. empty, one slot,
    # mid-page and a full 512-slot window
    lens = [0, 1, 7, 512, 200, 33] + [(37 * i) % 513 for i in range(58)]
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        args = decode_inputs(g, 64, H, KVH, hd, bp, lens, dtype)
        got = pa.paged_attention(*args, scale=scale)
        want = pa.paged_attention_plain(*args, scale)
        torch.cuda.synchronize()
        check(bool((got[0] == 0).all()), "K1a: empty-cache row not zero")
        errs[f"decode_{str(dtype)[6:]}"] = compare(
            f"K1a {dtype}", got, want, tol)
    # K1b: prefill face, B = 1, C in {16, 64}, ragged prefix, padding,
    # window in {None, 128}
    for C, prefix, nvalid in ((16, 37, 11), (64, 200, 64), (16, 0, 16),
                              (64, 448, 50)):
        for window in (None, 128):
            for dtype, tol in ((torch.bfloat16, BF16_TOL),
                               (torch.float32, F32_TOL)):
                args = prefill_inputs(g, C, H, KVH, hd, bp, prefix, nvalid,
                                      dtype)
                got = pa.paged_attention_prefill(*args, scale=scale,
                                                 window=window)
                want = pa.paged_attention_prefill_plain(*args, scale, window)
                torch.cuda.synchronize()
                key = f"prefill_{str(dtype)[6:]}"
                errs[key] = max(errs.get(key, 0.0), compare(
                    f"K1b C={C} prefix={prefix} window={window} {dtype}",
                    got, want, tol))
    # K2: B = 64, D = 2560, hidden in bf16 and f32
    D = 2560
    w1 = torch.randn(D, 512, generator=g, device="cuda") * (2.0 / D) ** 0.5
    b1 = torch.randn(512, generator=g, device="cuda") * 0.1
    w2 = torch.randn(512, 1, generator=g, device="cuda") * 512 ** -0.5
    b2 = torch.randn(1, generator=g, device="cuda") * 0.1
    for dtype in (torch.bfloat16, torch.float32):
        h = torch.randn(64, D, generator=g, device="cuda").to(dtype)
        got = ss.step_score(h, w1, b1, w2, b2)
        want = ss.step_score_plain(h, w1, b1, w2, b2)
        torch.cuda.synchronize()
        errs[f"score_{str(dtype)[6:]}"] = compare(f"K2 {dtype}", got, want,
                                                  SCORE_TOL)
    emit("kernels", max_abs_err=errs,
         tolerances={"bf16": BF16_TOL, "f32": F32_TOL, "score": SCORE_TOL})
    return errs


def full_model(rt):
    cfg = rt["registry"].get_config("qwen3-4b-thinking")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = rt["init"].init_params(cfg, g)
    scorer = rt["scorer"].init_scorer(g, cfg.d_model)
    torch.cuda.synchronize()
    n = rt["init"].count_params(params)
    return cfg, params, scorer, n, time.perf_counter() - t0


def to_f32(tree: dict) -> dict:
    return {k: to_f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def greedy(rt, max_new):
    return rt["sampling"].SamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                                         max_new_tokens=max_new)


def check_result(res, engine):
    for t in res.traces:
        check(all(math.isfinite(c) for c in t.token_confidences),
              "non-finite confidence")
        check(all(math.isfinite(s) and 0.0 <= s <= 1.0
                  for s in t.step_scores), "step score outside [0, 1]")
    check(engine.pool_drained(), "pool not drained")
    check(engine.fault_stats.degraded_to_dense == 0, "engine degraded")


def phase_serve(rt, ops, cfg, params, scorer):
    E = rt["engine"]
    tok = rt["tokenizer"].get_tokenizer()
    problem = rt["evaluate"].make_problems(1, seed=SEED)[0]
    prompt = tok.encode(rt["arithmetic"].make_prompt(problem), add_bos=True)
    ecfg = E.EngineConfig(max_batch=16, num_blocks=80, capacity=512,
                          max_new_tokens=128, sampling=greedy(rt, 128),
                          use_kernel="auto", decode_horizon=4,
                          prefix_cache=True, faults=None, kv_dtype="bf16")
    engine = E.Engine(params, cfg, ecfg, rt["pruning"].make_policy("step"),
                      scorer_params=scorer)
    check(engine.use_kernel and engine.fused_scorer,
          "engine not on the kernel path")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.serve(prompt, 16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check_result(res, engine)
    check(launches["paged_attention_decode"] > 0, "K1a never launched")
    check(launches["step_score"] > 0, "K2 never launched")
    check(res.num_pruned > 0, "STEP pruned nothing under pressure")
    check(res.num_preemptions == 0 and res.wait_s == 0.0,
          "STEP made a trace wait")
    iters = launches["step_score"]  # one fused scorer launch per iteration
    out = {"prompt_tokens": len(prompt), "traces": 16,
           "num_pruned": res.num_pruned, "total_tokens": res.total_tokens,
           "wall_s": wall, "decode_s": res.decode_s,
           "prefill_s": res.prefill_s,
           "tokens_per_s": res.total_tokens / wall,
           "decode_iterations": iters,
           "launches": launches,
           "k1a_launches_per_iteration": launches[
               "paged_attention_decode"] / max(iters, 1),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "pool_drained": True}
    emit("serve", **out)
    return out


def phase_smoke_reference(rt):
    """Kernel engine vs dense engine on a small input: smoke config, f32
    params and pools, greedy STEP under memory pressure — identical
    tokens, statuses and prunes, step scores within 1e-5."""
    E = rt["engine"]
    cfg = rt["registry"].serving_config()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = to_f32(rt["init"].init_params(cfg, g))
    scorer = rt["scorer"].init_scorer(g, cfg.d_model)
    tok = rt["tokenizer"].get_tokenizer()
    prompt = tok.encode("3+5-2=", add_bos=True)
    outs = {}
    for use_kernel in (True, False):
        ecfg = E.EngineConfig(max_batch=8, num_blocks=16, capacity=128,
                              max_new_tokens=40, sampling=greedy(rt, 40),
                              use_kernel=use_kernel, decode_horizon=4,
                              faults=None, kv_dtype="f32")
        engine = E.Engine(params, cfg, ecfg,
                          rt["pruning"].make_policy("step"),
                          scorer_params=scorer)
        res = engine.serve(prompt, 8)
        check_result(res, engine)
        outs[use_kernel] = res
    k, d = outs[True], outs[False]
    check([t.output_tokens for t in k.traces]
          == [t.output_tokens for t in d.traces], "kernel != dense tokens")
    check([t.status for t in k.traces] == [t.status for t in d.traces],
          "kernel != dense statuses")
    check(k.num_pruned > 0, "no pruning in the reference scenario")
    err = max((abs(a - b) for tk, td in zip(k.traces, d.traces)
               for a, b in zip(tk.step_scores, td.step_scores)), default=0.0)
    check(err <= 1e-5, f"kernel vs dense step scores differ by {err}")
    emit("reference", config=cfg.name, tokens_identical=True,
         num_pruned=k.num_pruned,
         step_scores=sum(len(t.step_scores) for t in k.traces),
         max_step_score_err=err)


def phase_batched(rt, ops, cfg, params, scorer):
    E = rt["engine"]
    tok = rt["tokenizer"].get_tokenizer()
    make_prompt = rt["arithmetic"].make_prompt
    probs = rt["evaluate"].make_problems(10, seed=SEED + 1)
    # one 48-80 token prompt shared by two requests: a single synthetic
    # prompt (<= 15 tokens) fills no 16-token block, so it is never parked
    shared = tok.encode("".join(make_prompt(p) for p in probs[4:10]),
                        add_bos=True)
    check(48 <= len(shared) <= 80, f"shared prompt {len(shared)} tokens")
    prompts = [shared, tok.encode(make_prompt(probs[0]), add_bos=True),
               tok.encode(make_prompt(probs[1]), add_bos=True), shared]
    ecfg = E.EngineConfig(max_batch=16, num_blocks=160, capacity=512,
                          max_new_tokens=64, sampling=greedy(rt, 64),
                          use_kernel="auto", decode_horizon=4,
                          prefill_chunk_size=16, prefix_cache=True,
                          faults=None, kv_dtype="bf16")
    engine = E.Engine(params, cfg, ecfg, rt["pruning"].make_policy("step"),
                      scorer_params=scorer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    # two waves of two concurrent requests on one engine: the second
    # wave's copy of the shared prompt finds the first wave's blocks
    # parked in the prefix cache
    results = []
    for wave in ((0, 1), (2, 3)):
        reqs = [E.Request(request_id=i, prompt_tokens=prompts[i], n_traces=8,
                          policy=rt["pruning"].make_policy("step"))
                for i in wave]
        results += engine.serve_batch(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    for res in results:
        check_result(res, engine)
    cached = [res.metrics.cached_tokens for res in results]
    check(launches["paged_attention_prefill"] > 0, "K1b never launched")
    check(cached[3] > 0, "no prefix-cache hit on the shared prompt")
    total = sum(res.total_tokens for res in results)
    out = {"requests": 4, "traces": 8, "prompt_tokens": [len(p) for p in
                                                         prompts],
           "cached_tokens": cached, "total_tokens": total, "wall_s": wall,
           "tokens_per_s": total / wall, "launches": launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit("batched", **out)
    return out


def time_cuda(fn, reps=30, warmup=3):
    """Mean device ms per call of ``fn``. The call is captured once in a
    CUDA graph and each replay is timed with CUDA events, so the time is
    the device's and not the host's (a wrapper's Python checks, or the
    plain version's op-by-op launches, would otherwise sit between the
    events while the device idles). The 50 MB L2 is flushed before each
    replay: the decode loop finds a layer's pages cold (35 other layers
    and the weights pass through L2 in between)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up off the default stream
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def phase_times(pa, ss):
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    H, KVH, hd, bp, page = 32, 8, 128, 32, 16
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    bf = torch.bfloat16
    rows = {}

    # K1a at the serve phase's decode shape: 16 lanes over 80-block
    # pool rows of 32 pages, lengths across the prompt + 128 tokens range
    B = 16
    lens = [15 + (128 * i) // (B - 1) for i in range(B)]
    q, kp, vp, bt, cl = decode_inputs(g, B, H, KVH, hd, bp, lens, bf)
    pages = sum(-(-n // page) for n in lens)
    nbytes = (2 * q.numel() * 2 + bt.numel() * 4 + cl.numel() * 4
              + 2 * pages * page * KVH * hd * 2)
    flops = 4 * hd * H * sum(lens)
    S = bp * page
    kd = pa.gather_pages(kp, bt).transpose(1, 2).contiguous()  # [B,KVH,S,hd]
    vd = pa.gather_pages(vp, bt).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :] < cl[:, None])[
        :, None, None, :]
    q4 = q[:, :, None, :]
    rows["paged_attention_decode"] = dict(
        ms=time_cuda(lambda: pa.paged_attention(q, kp, vp, bt, cl,
                                                scale=scale)),
        plain_ms=time_cuda(lambda: pa.paged_attention_plain(q, kp, vp, bt,
                                                            cl, scale)),
        library_ms=time_cuda(lambda: F.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True)),
        shape=f"B={B} H={H} KVH={KVH} hd={hd} bp={bp} lens={lens[0]}.."
              f"{lens[-1]} bf16",
        bytes=nbytes, flops=flops, dtype=bf)

    # K1b at the batched phase's chunk shape: C = 16 over a 64-token prefix
    C, prefix = 16, 64
    q, kp, vp, bt, pl, nv, ok, ov = prefill_inputs(g, C, H, KVH, hd, bp,
                                                   prefix, C, bf)
    pages = -(-prefix // page)
    nbytes = (2 * q.numel() * 2 + 2 * ok.numel() * 2 + bt.numel() * 4 + 8
              + 2 * pages * page * KVH * hd * 2)
    visible = sum(prefix + c + 1 for c in range(C))
    flops = 4 * hd * H * visible
    keys = torch.cat([pa.gather_pages(kp, bt)[:, :prefix], ok], 1)
    vals = torch.cat([pa.gather_pages(vp, bt)[:, :prefix], ov], 1)
    kd, vd = keys.transpose(1, 2).contiguous(), vals.transpose(1, 2) \
        .contiguous()
    pos = torch.arange(prefix + C, device="cuda")
    cmask = (pos[None, :] <= prefix + torch.arange(C, device="cuda")[:, None])
    qd = q.transpose(1, 2)
    rows["paged_attention_prefill"] = dict(
        ms=time_cuda(lambda: pa.paged_attention_prefill(
            q, kp, vp, bt, pl, nv, ok, ov, scale=scale)),
        plain_ms=time_cuda(lambda: pa.paged_attention_prefill_plain(
            q, kp, vp, bt, pl, nv, ok, ov, scale)),
        library_ms=time_cuda(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=cmask, scale=scale, enable_gqa=True)),
        shape=f"B=1 C={C} H={H} KVH={KVH} hd={hd} prefix={prefix} bf16",
        bytes=nbytes, flops=flops, dtype=bf)

    # K2 at the decode batch: 16 lanes, D = 2560, bf16 hidden
    D, Hd = 2560, 512
    h = torch.randn(B, D, generator=g, device="cuda").to(bf)
    w1 = torch.randn(D, Hd, generator=g, device="cuda") * (2.0 / D) ** 0.5
    b1 = torch.zeros(Hd, device="cuda")
    w2 = torch.randn(Hd, 1, generator=g, device="cuda") * Hd ** -0.5
    b2 = torch.zeros(1, device="cuda")
    rows["step_score"] = dict(
        ms=time_cuda(lambda: ss.step_score(h, w1, b1, w2, b2)),
        plain_ms=time_cuda(lambda: ss.step_score_plain(h, w1, b1, w2, b2)),
        library_ms=None,
        shape=f"B={B} D={D} hidden={Hd} bf16 hidden, f32 weights",
        bytes=h.numel() * 2 + (w1.numel() + 2 * Hd + 1 + B) * 4,
        flops=2 * B * D * Hd + 4 * B * Hd, dtype=torch.float32)

    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["flops"],
                                                r.pop("dtype"))
    emit("times", **rows)
    return rows


def phase_step(rt, cfg, params):
    """One full-width decode iteration (``decode_step``, kernels on) at the
    serve phase's shape: the host's wall time per eager call against the
    device time of the same work replayed from a CUDA graph. Their
    difference is what the host adds (op-by-op launches)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    B, capacity, nb = 16, 512, 80
    cache = rt["model"].init_decode_cache(cfg, B, capacity, num_blocks=nb,
                                          device="cuda")
    cache["block_tables"] = torch.randint(
        1, nb, cache["block_tables"].shape, generator=g, device="cuda",
        dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                           device="cuda", dtype=torch.int32)
    positions = torch.full((B,), 79, dtype=torch.int32, device="cuda")

    def step():
        return rt["model"].decode_step(params, cfg, tokens, positions, cache,
                                       window_len=capacity, use_kernel=True)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / reps * 1e3
    device_ms = time_cuda(step, reps=reps)
    weight_bytes = 2 * rt["init"].count_params(params)
    out = {"shape": f"B={B} lanes, positions 79, pool {nb} blocks",
           "eager_wall_ms": eager_ms, "graph_device_ms": device_ms,
           "host_share": 1.0 - device_ms / eager_ms,
           "weights_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3}
    emit("step", **out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import importlib
    names = {"registry": "configs.registry", "init": "models.init",
             "scorer": "core.scorer", "pruning": "core.pruning",
             "engine": "serving.engine", "evaluate": "serving.evaluate",
             "sampling": "serving.sampling", "tokenizer": "data.tokenizer",
             "arithmetic": "data.arithmetic", "model": "models.model"}
    rt = {k: importlib.import_module(f"repro_torch.{v}")
          for k, v in names.items()}
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import step_score as ss
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = phase_device()
    phase_build(ops)
    errs = phase_kernels(pa, ss)
    cfg, params, scorer, n_params, init_s = full_model(rt)
    emit("model", name=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         params=n_params, init_s=init_s)
    serve = phase_serve(rt, ops, cfg, params, scorer)
    phase_smoke_reference(rt)
    batched = phase_batched(rt, ops, cfg, params, scorer)
    times = phase_times(pa, ss)
    phase_step(rt, cfg, params)

    src = "src/repro_torch/csrc/"
    meta = {
        "paged_attention_decode": (src + "paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:62",
                                   "decode_bfloat16"),
        "paged_attention_prefill": (src + "paged_attention.cu",
                                    "src/repro/kernels/paged_attention.py:62",
                                    "prefill_bfloat16"),
        "step_score": (src + "step_score.cu",
                       "src/repro/kernels/step_score.py:30",
                       "score_bfloat16"),
    }
    kernels = []
    for name, (source, replaces, err_key) in meta.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": serve["launches"][name] + batched["launches"][name],
            "max_abs_err": errs[err_key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
