#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device   — the card's name, count, and nvidia-smi's power limit;
  2. build    — nvcc builds every kernel from ``src/repro_torch/csrc``
                (in parallel) and reports registers and spills (also in
                short per kernel for the scorer's and the SSD scan's
                passes), and the HMMA/HGMMA (tensor-core) instructions in
                each library's SASS where ``cuobjdump`` exists;
  3. kernels  — each kernel's wrapper against its plain PyTorch version
                on the card, at the main path's full-width shapes: the
                paged kernel over bf16/f32 pools (K1a, K1b) and over
                int8/fp8 pools (K1c), the scorer (K2), flash attention (K3),
                the SSD scan (K4: y and the final state, also over a
                padded sequence and with the init's steep decays);
  4. serve    — STEP serving of qwen3-4b-thinking at full width (random
                seeded weights) under memory pressure through
                ``Engine.serve``, kernels on: launch counts, pruning, a
                drained pool; then the kernel engine against the dense
                engine at the smoke config (f32, greedy tokens identical);
  5. batched  — four requests through ``Engine.serve_batch`` with chunked
                prefill and the prefix cache: the prefill kernel face and
                a prefix-cache hit;
  6. serve_int8, serve_fp8 — the serve phase over a quantized pool, with
                chunked prefill: both faces of K1c; then the int8 kernel
                engine against the int8 dense engine at the smoke config;
  7. forward_kernel — ``forward_full(use_kernel=True)`` at full width
                against the dense forward: one K3 launch per layer;
  8. train    — AdamW steps of ``make_train_step`` at full width, then
                ``build_step_scorer`` and a STEP serve with that scorer;
  9. times    — device time of each kernel, its plain version and the
                library yardstick (one CUDA-graph replay per timed call,
                cold L2), and each kernel's bound; also K1a over long
                rows (``paged_attention_decode_long``, 16 lanes of
                1024-4096 slots) and K2 at the kernels phase's 64 lanes
                (``step_score_b64``), on this line only, and the device
                time of each launch inside K2 and K4 (torch.profiler);
 10. step     — one full-width decode iteration: eager wall time against
                the device time of its CUDA-graph replay;
 11. serve_mamba2 — qwen3's params freed, STEP serving of mamba2-2.7b at
                full width (64 layers, random seeded weights, per-slot
                recurrent state, no KV pool) through ``Engine.serve``,
                kernels on: the fused scorer, pruning with no wait, a
                drained pool; then the kernel engine against the dense
                engine at the mamba2 smoke config;
 12. forward_ssd — ``forward_full(use_kernel=True)`` of mamba2 at full
                width against the dense forward: one K4 launch per layer;
 13. step_mamba2 — phase 10 for mamba2's decode iteration.

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
# the SSD scan against its sequential plain version: the chunked form
# exponentiates cumsum differences instead of multiplying per-step decays
# (tests/test_kernels.py holds the Pallas kernel to the recurrence so)
SSD_TOL = dict(atol=2e-3, rtol=2e-3)
QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
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


def quantize(kvq, kp, vp, kv_dtype):
    """Float pools -> (k codes, v codes, k scales, v scales)."""
    (kq, ks), (vq, vs) = (kvq.quantize_pages(x, QUANT[kv_dtype])
                          for x in (kp, vp))
    return kq, vq, ks, vs


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


def cuobjdump():
    """The CUDA toolkit's cuobjdump, or the copy Triton ships, or None."""
    import importlib.util
    import shutil
    found = shutil.which("cuobjdump")
    candidates = [found] if found else []
    candidates.append("/usr/local/cuda/bin/cuobjdump")
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        candidates.append(str(Path(spec.origin).parent / "backends"
                              / "nvidia" / "bin" / "cuobjdump"))
    return next((c for c in candidates if Path(c).exists()), None)


def tensor_core_instructions(build, names):
    """{source: {"HMMA": n, "HGMMA": n}} counted in each library's SASS,
    or "not available" without cuobjdump."""
    tool = cuobjdump()
    if tool is None:
        return "not available"
    counts = {}
    for name in names:
        sass = subprocess.run([tool, "-sass", str(build._target(name))],
                              capture_output=True, text=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\.", sass))
                        for op in ("HMMA", "HGMMA")}
    return counts


def registers_spills(fns):
    """ptxas entries of one source -> {kernel: {"registers": n,
    "spill_bytes": stores + loads}}, the kernel named short."""
    out = {}
    for f in fns:
        m = re.search(r"\d([a-z_]+_kernel)", f["function"])
        name = m.group(1) if m else f["function"]
        if "bfloat16" in f["function"]:
            name += "<bf16>"
        elif "IfE" in f["function"]:
            name += "<f32>"
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill",
                                             f["spills"])]
        out[name] = {"registers": f["registers"], "spill_bytes": sum(spills)}
    return out


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
    tc = tensor_core_instructions(ops.build, ops.SOURCES)
    emit("build", seconds=round(seconds, 3), ptxas=summary,
         registers_spills={src: registers_spills(summary.get(src, []))
                           for src in ("step_score", "ssd_scan")},
         tensor_core_instructions=tc)
    if tc != "not available":
        check(tc["flash_attention"]["HMMA"] + tc["flash_attention"]["HGMMA"]
              > 0, "K3 has no tensor-core instruction")
    return seconds


def ssd_inputs(g, S, stress, B=1, H=80, P=64, N=128):
    """K4's operands at mamba2's full width, f32 as the mixer hands them
    over. ``stress``: the init's A = -(1..H) with large steps, so the
    cumsum of dt*A falls thousands below zero inside a chunk."""
    x = torch.randn(B, S, H, P, generator=g, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device="cuda")
        + (1.0 if stress else 0.0))
    A = (-torch.arange(1, H + 1, device="cuda", dtype=torch.float32)
         if stress else -torch.exp(torch.randn(H, generator=g,
                                               device="cuda")))
    Bm = torch.randn(B, S, N, generator=g, device="cuda")
    Cm = torch.randn(B, S, N, generator=g, device="cuda")
    return x, dt, A, Bm, Cm


def phase_kernels(pa, ss, fa, sd, kvq):
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
    # K1c: both faces over int8 and fp8 pools (f32 scales per slot), the
    # same shapes and queries in bf16 and f32
    for kv_dtype in QUANT:
        for dtype, tol in ((torch.bfloat16, BF16_TOL),
                           (torch.float32, F32_TOL)):
            q, kp, vp, bt, cl = decode_inputs(g, 64, H, KVH, hd, bp, lens,
                                              torch.float32)
            kq, vq, ks, vs = quantize(kvq, kp, vp, kv_dtype)
            args = (q.to(dtype), kq, vq, bt, cl)
            got = pa.paged_attention(*args, scale=scale, k_scale=ks,
                                     v_scale=vs)
            want = pa.paged_attention_plain(*args, scale, ks, vs)
            torch.cuda.synchronize()
            check(bool((got[0] == 0).all()), "K1c: empty-cache row not zero")
            errs[f"decode_{kv_dtype}_{str(dtype)[6:]}"] = compare(
                f"K1c decode {kv_dtype} {dtype}", got, want, tol)
            for C, prefix, nvalid in ((16, 64, 16), (64, 200, 50)):
                for window in (None, 128):
                    q, kp, vp, bt, pl, nv, ok, ov = prefill_inputs(
                        g, C, H, KVH, hd, bp, prefix, nvalid, torch.float32)
                    kq, vq, ks, vs = quantize(kvq, kp, vp, kv_dtype)
                    args = (q.to(dtype), kq, vq, bt, pl, nv, ok.to(dtype),
                            ov.to(dtype))
                    got = pa.paged_attention_prefill(
                        *args, scale=scale, window=window, k_scale=ks,
                        v_scale=vs)
                    want = pa.paged_attention_prefill_plain(
                        *args, scale, window, ks, vs)
                    torch.cuda.synchronize()
                    key = f"prefill_{kv_dtype}_{str(dtype)[6:]}"
                    errs[key] = max(errs.get(key, 0.0), compare(
                        f"K1c prefill {kv_dtype} C={C} prefix={prefix} "
                        f"window={window} {dtype}", got, want, tol))
    # K3: B = 1, H = 32, S = 2048, hd = 128; causal, a window of 128, and
    # non-causal
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        qkv = [torch.randn(1, H, 2048, hd, generator=g, device="cuda")
               .to(dtype) for _ in range(3)]
        for causal, window in ((True, None), (True, 128), (False, None)):
            got = fa.flash_attention(*qkv, causal=causal, window=window)
            want = fa.flash_attention_plain(*qkv, causal, window)
            torch.cuda.synchronize()
            key = f"flash_{str(dtype)[6:]}"
            errs[key] = max(errs.get(key, 0.0), compare(
                f"K3 causal={causal} window={window} {dtype}", got, want,
                tol))
        del qkv
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
    # K4: mamba2's full-width scan (B = 1, S = 2048, H = 80, P = 64,
    # N = 128, chunk 256), the same with the init's decay rates and large
    # steps, and S = 1000 padded to 1024 with dt = 0 as the mixer pads
    for S, stress in ((2048, False), (2048, True), (1000, True)):
        x, dt, A, Bm, Cm = ssd_inputs(g, S, stress)
        pad = (-S) % 256
        padded = [torch.nn.functional.pad(t, [0, 0] * (t.dim() - 2)
                                          + [0, pad]) for t in (x, dt, Bm, Cm)]
        y, h = sd.ssd_scan(padded[0], padded[1], A, padded[2], padded[3],
                           chunk=256)
        yp, hp = sd.ssd_scan_plain(x, dt, A, Bm, Cm)
        torch.cuda.synchronize()
        errs["ssd_scan"] = max(
            errs.get("ssd_scan", 0.0),
            compare(f"K4 S={S} stress={stress} y", y[:, :S], yp, SSD_TOL),
            compare(f"K4 S={S} stress={stress} state", h, hp, SSD_TOL))
        del x, dt, Bm, Cm, padded, y, yp
    emit("kernels", max_abs_err=errs,
         tolerances={"bf16": BF16_TOL, "f32": F32_TOL, "score": SCORE_TOL,
                     "ssd": SSD_TOL})
    return errs


def full_model(rt, arch="qwen3-4b-thinking"):
    cfg = rt["registry"].get_config(arch)
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


def phase_serve(rt, ops, cfg, params, scorer, kv_dtype="bf16", chunk=None):
    """The STEP serve at full width over a ``kv_dtype`` pool: phase
    ``serve`` (bf16, one-shot prefill) or ``serve_<kv_dtype>`` (int8/fp8,
    chunked prefill, so both faces of the quantized kernel run)."""
    E = rt["engine"]
    name = "serve" if kv_dtype == "bf16" else f"serve_{kv_dtype}"
    quant = kv_dtype in QUANT
    decode = "paged_attention_decode" + ("_quant" if quant else "")
    tok = rt["tokenizer"].get_tokenizer()
    problem = rt["evaluate"].make_problems(1, seed=SEED)[0]
    prompt = tok.encode(rt["arithmetic"].make_prompt(problem), add_bos=True)
    ecfg = E.EngineConfig(max_batch=16, num_blocks=80, capacity=512,
                          max_new_tokens=128, sampling=greedy(rt, 128),
                          use_kernel="auto", decode_horizon=4,
                          prefill_chunk_size=chunk,
                          prefix_cache=True, faults=None, kv_dtype=kv_dtype)
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
    check(launches[decode] > 0, f"{decode} never launched")
    if quant:
        check(launches["paged_attention_prefill_quant"] > 0,
              "K1c prefill face never launched")
        check(launches["paged_attention_decode"] == 0
              and launches["paged_attention_prefill"] == 0,
              "a float-pool kernel ran on a quantized pool")
    check(launches["step_score"] > 0, "K2 never launched")
    check(res.num_pruned > 0, "STEP pruned nothing under pressure")
    check(res.num_preemptions == 0 and res.wait_s == 0.0,
          "STEP made a trace wait")
    iters = launches["step_score"]  # one fused scorer launch per iteration
    out = {"kv_dtype": kv_dtype, "prefill_chunk_size": chunk,
           "prompt_tokens": len(prompt), "traces": 16,
           "num_pruned": res.num_pruned, "total_tokens": res.total_tokens,
           "wall_s": wall, "decode_s": res.decode_s,
           "prefill_s": res.prefill_s,
           "tokens_per_s": res.total_tokens / wall,
           "decode_iterations": iters,
           "launches": launches,
           "decode_launches_per_iteration": launches[decode] / max(iters, 1),
           "kv_block_bytes": engine.kv_block_bytes,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "pool_drained": True}
    emit(name, **out)
    return out


def phase_smoke_reference(rt, kv_dtype="f32", chunk=None,
                          arch="qwen3-4b-thinking"):
    """Kernel engine vs dense engine on a small input: ``arch``'s smoke
    config, f32 params, greedy STEP under memory pressure over a
    ``kv_dtype`` pool — identical tokens, statuses and prunes, step
    scores within 1e-5 (both paths dequantize an int8/fp8 pool to the
    same f32 values; mamba2 has no pool)."""
    E = rt["engine"]
    cfg = rt["registry"].serving_config(arch)
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
                              prefill_chunk_size=chunk, faults=None,
                              kv_dtype=kv_dtype)
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
    name = "reference" if kv_dtype == "f32" else f"reference_{kv_dtype}"
    if arch != "qwen3-4b-thinking":
        name = f"reference_{arch.split('-')[0]}"
    emit(name, config=cfg.name, kv_dtype=kv_dtype, prefill_chunk_size=chunk,
         tokens_identical=True, num_pruned=k.num_pruned,
         step_scores=sum(len(t.step_scores) for t in k.traces),
         max_step_score_err=err)


def phase_serve_mamba2(rt, ops, cfg, params, scorer):
    """STEP serving of mamba2-2.7b at full width: 16 traces of one
    prompt, greedy, 128 new tokens, 80 blocks, horizon 4, kernels on. The
    ssm stack has no KV pool: the blocks are the engine's accounting of
    each trace's tokens, and its device state is the per-slot recurrent
    state (``ssm_state`` f32 and ``conv_state`` bf16 for 16 slots). The
    path runs the fused scorer (K2) every iteration; the one-shot prefill
    is dense, as in the JAX package, so K4 is not on it."""
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
    check(engine.kv_block_bytes == 0 and engine.prefix_cache is None,
          "an ssm stack has no KV pool to share")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.serve(prompt, 16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check_result(res, engine)
    check(launches["step_score"] > 0, "K2 never launched")
    check(res.num_pruned > 0, "STEP pruned nothing under pressure")
    check(res.num_preemptions == 0 and res.wait_s == 0.0,
          "STEP made a trace wait")
    state = 16 * cfg.num_layers * (
        cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state_size * 4
        + (cfg.ssm_conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_state_size)
        * 2)
    out = {"prompt_tokens": len(prompt), "traces": 16,
           "num_pruned": res.num_pruned, "total_tokens": res.total_tokens,
           "wall_s": wall, "decode_s": res.decode_s,
           "prefill_s": res.prefill_s,
           "tokens_per_s": res.total_tokens / wall,
           "decode_iterations": launches["step_score"],
           "launches": launches, "recurrent_state_bytes": state,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "pool_drained": True}
    emit("serve_mamba2", **out)
    return out


def phase_forward_ssd(rt, ops, cfg, params):
    """``forward_full(use_kernel=True)`` of mamba2 at full width, B = 1,
    S = 2048 (eight chunks of 256), against the dense chunked forward:
    one K4 launch per layer.

    In f32 (the params cast up) the two paths differ only in the scan's
    summation order: their logits are held within 1e-3 of the largest
    logit. In bf16, the serving dtype, each path rounds every layer's
    output at other places through 64 layers (a first bound of 5% of the
    largest logit, as ``forward_kernel`` holds qwen3's 36 layers, failed
    at 5.9%): the kernel path is held to be no farther from the f32
    forward than the dense path is (within a factor 1.5), and the greedy
    tokens of at least 80% of the positions to agree with the dense
    path's (random weights leave near ties among 50k logits)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=g,
                           device="cuda", dtype=torch.int32)
    V = cfg.vocab_size

    def logits(p, use_kernel):
        with torch.no_grad():
            out = rt["model"].forward_full(p, cfg, tokens,
                                           use_kernel=use_kernel)
        return out["logits"][..., :V].float()

    t0 = time.perf_counter()
    dense = logits(params, False)
    torch.cuda.synchronize()
    dense_wall = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = logits(params, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    p32 = to_f32(params)
    dense32, got32 = logits(p32, False), logits(p32, True)
    del p32
    torch.cuda.empty_cache()

    def err(a, b):
        return (a - b).abs().max().item()

    amax = dense32.abs().max().item()
    agree = (got.argmax(-1) == dense.argmax(-1)).float().mean().item()
    out = {"shape": "B=1 S=2048 chunk 256", "launches": launches,
           "f32_logits_max_abs_err": err(got32, dense32),
           "f32_logits_max_abs": amax,
           "f32_argmax_agreement": (got32.argmax(-1) == dense32.argmax(-1))
           .float().mean().item(),
           "bf16_logits_max_abs_err": err(got, dense),
           "bf16_kernel_err_vs_f32": err(got, dense32),
           "bf16_dense_err_vs_f32": err(dense, dense32),
           "argmax_agreement": agree, "wall_s": wall,
           "dense_wall_s": dense_wall}
    emit("forward_ssd", **out)
    for name, t in (("bf16", got), ("f32", got32)):
        check(bool(torch.isfinite(t).all()),
              f"K4 forward: non-finite {name} logits")
    check(launches["ssd_scan"] == cfg.num_layers,
          f"K4 launched {launches['ssd_scan']} times, not once per layer")
    check(out["f32_logits_max_abs_err"] <= 1e-3 * amax,
          f"K4 forward f32: logits err {out['f32_logits_max_abs_err']} vs "
          f"max {amax}")
    check(out["bf16_kernel_err_vs_f32"]
          <= 1.5 * out["bf16_dense_err_vs_f32"],
          "K4 forward bf16: the kernel path is farther from f32 than the "
          "dense path")
    check(agree >= 0.8, f"K4 forward: greedy tokens agree at {agree}")
    return out


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


def phase_forward_kernel(rt, ops, cfg, params):
    """``forward_full(use_kernel=True)`` at full width, B = 1, S = 1024,
    against the dense forward: one K3 launch per layer. Both round every
    activation to bf16, at other places, through 36 layers: the logits
    are held within 5% of their largest magnitude, and the greedy tokens
    of at least 80% of the positions agree (random weights leave near
    ties among 152k logits)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=g,
                           device="cuda", dtype=torch.int32)
    fwd = rt["model"].forward_full
    with torch.no_grad():
        dense = fwd(params, cfg, tokens)["logits"][..., :cfg.vocab_size]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = fwd(params, cfg, tokens, use_kernel=True)["logits"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    got = got[..., :cfg.vocab_size].float()
    dense = dense.float()
    err = (got - dense).abs().max().item()
    amax = dense.abs().max().item()
    agree = (got.argmax(-1) == dense.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(got).all()), "K3 forward: non-finite logits")
    check(launches["flash_attention"] == cfg.num_layers,
          f"K3 launched {launches['flash_attention']} times, not once per "
          f"layer")
    check(err <= 0.05 * amax, f"K3 forward: logits err {err} vs max {amax}")
    check(agree >= 0.8, f"K3 forward: greedy tokens agree at {agree}")
    out = {"shape": "B=1 S=1024 bf16", "launches": launches,
           "logits_max_abs_err": err, "logits_max_abs": amax,
           "argmax_agreement": agree, "wall_s": wall}
    emit("forward_kernel", **out)
    return out


def phase_train(rt, ops, cfg, params):
    """AdamW steps of ``make_train_step`` on the full-width params (bf16,
    updated in place; f32 moments), B = 2, seq 128, one batch repeated:
    the loss is finite and falls. Then ``build_step_scorer`` on the
    trained params and a short STEP serve with the scorer it built."""
    Tr, Opt = rt["trainer"], rt["optimizer"]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    opt = Opt.AdamW(learning_rate=1e-3)
    state = opt.init(params)
    with_moments = torch.cuda.memory_allocated()
    step = Tr.make_train_step(cfg, opt)
    batch = torch.from_numpy(next(rt["dataset"].lm_batches(128, 2,
                                                           seed=SEED)))
    batch = batch.cuda()
    losses, times = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch[:, :-1],
                                   batch[:, 1:])
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    del state
    for p in rt["tree"].leaves(params):
        p.requires_grad_(False)
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses), f"train loss {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")

    t0 = time.perf_counter()
    scorer, info = rt["pipeline"].build_step_scorer(
        params, cfg, n_problems=4, n_samples=4, per_class=16, seed=SEED,
        scfg=rt["scorer"].ScorerTrainConfig(max_epochs=5))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(scorer["w1"].device.type == "cuda", "scorer trained off the card")
    check(math.isfinite(info["best_val_loss"]), "scorer val loss")

    E = rt["engine"]
    tok = rt["tokenizer"].get_tokenizer()
    problem = rt["evaluate"].make_problems(1, seed=SEED + 5)[0]
    prompt = tok.encode(rt["arithmetic"].make_prompt(problem), add_bos=True)
    ecfg = E.EngineConfig(max_batch=8, num_blocks=40, capacity=256,
                          max_new_tokens=48, sampling=greedy(rt, 48),
                          use_kernel="auto", decode_horizon=4, faults=None,
                          kv_dtype="bf16")
    engine = E.Engine(params, cfg, ecfg, rt["pruning"].make_policy("step"),
                      scorer_params=scorer)
    ops.reset_launch_counts()
    res = engine.serve(prompt, 8)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_result(res, engine)
    check(launches["step_score"] > 0, "the built scorer never ran")
    n_scores = sum(len(t.step_scores) for t in res.traces)
    out = {"shape": "B=2 seq=128, AdamW lr 1e-3, f32 moments",
           "losses": losses, "step_s": times,
           "max_memory_allocated": peak,
           "memory_allocated_at_start": at_start,
           "memory_allocated_with_moments": with_moments,
           "scorer": {k: info[k] for k in ("num_steps", "pos_rate",
                                           "sampled_correct_rate",
                                           "fallback_rendered",
                                           "best_val_loss")},
           "scorer_epochs": len(info["history"]),
           "build_step_scorer_s": build_s,
           "serve": {"total_tokens": res.total_tokens,
                     "num_pruned": res.num_pruned, "step_scores": n_scores,
                     "launches": launches}}
    emit("train", **out)
    return out


def time_cuda(fn, reps=30, warmup=3):
    """Mean device ms per call of ``fn``. The call is captured once in a
    CUDA graph and each replay is timed with CUDA events, so the time is
    the device's and not the host's (a wrapper's Python checks, or the
    plain version's op-by-op launches, would otherwise sit between the
    events while the device idles). The 50 MB L2 is flushed before each
    replay: the decode loop finds a layer's pages cold (35 other layers
    and the weights pass through L2 in between). A spin kernel of about
    0.1 ms then keeps the device busy while the host enqueues the start
    event, the replay and the end event, so that the events do not also
    hold the host's submission of the replay (without it, a one-element
    add measured 0.014-0.016 ms)."""
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
        torch.cuda._sleep(200_000)   # GPU cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_split(fn):
    """Device ms of each CUDA kernel that one call of ``fn`` launches
    (``torch.profiler``; L2 flushed before the call, which runs eagerly),
    or "not measured" with the reason where the profiler records no
    device time. Diagnostic only: no check reads it."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    try:
        flush.zero_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0) or 0
            m = re.search(r"(\w+_kernel)", e.key)
            if t > 0 and m and "anonymous namespace" in e.key:
                rows[m.group(1)] = t / 1e3   # us -> ms
        return rows or "not measured: no device time recorded"
    except RuntimeError as err:
        return f"not measured: {err}"


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def phase_times(pa, ss, fa, sd, kvq):
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

    # K1a over long rows: 16 lanes of 1024-4096 slots (bp = 256, ~41k
    # live slots, ~168 MB of pages); SDPA over the gathered K/V
    Bl, bpl = 16, 256
    lens_l = [1024 + (3072 * i) // (Bl - 1) for i in range(Bl)]
    q, kp, vp, bt, cl = decode_inputs(g, Bl, H, KVH, hd, bpl, lens_l, bf)
    pages = sum(-(-n // page) for n in lens_l)
    Sl = bpl * page
    kd = pa.gather_pages(kp, bt).transpose(1, 2).contiguous()
    vd = pa.gather_pages(vp, bt).transpose(1, 2).contiguous()
    mask = (torch.arange(Sl, device="cuda")[None, :] < cl[:, None])[
        :, None, None, :]
    q4 = q[:, :, None, :]
    rows["paged_attention_decode_long"] = dict(
        ms=time_cuda(lambda: pa.paged_attention(q, kp, vp, bt, cl,
                                                scale=scale)),
        plain_ms=time_cuda(lambda: pa.paged_attention_plain(q, kp, vp, bt,
                                                            cl, scale)),
        library_ms=time_cuda(lambda: F.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True)),
        library="SDPA over K/V gathered beforehand",
        splits=pa.split_count(bpl, Bl * KVH),
        shape=f"B={Bl} H={H} KVH={KVH} hd={hd} bp={bpl} lens={lens_l[0]}.."
              f"{lens_l[-1]} bf16",
        bytes=(2 * q.numel() * 2 + bt.numel() * 4 + cl.numel() * 4
               + 2 * pages * page * KVH * hd * 2),
        flops=4 * hd * H * sum(lens_l), dtype=bf)
    del q, kp, vp, bt, cl, kd, vd, mask, q4
    torch.cuda.empty_cache()

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

    # K1c at the same decode and chunk shapes over int8 and fp8 pools. The
    # library yardstick is SDPA over K/V gathered and dequantized before
    # the timed call (the gather and dequantization are not timed).
    for kv_dtype in QUANT:
        q, kp, vp, bt, cl = decode_inputs(g, B, H, KVH, hd, bp, lens,
                                          torch.float32)
        kq, vq, ks, vs = quantize(kvq, kp, vp, kv_dtype)
        q = q.to(bf)
        pages = sum(-(-n // page) for n in lens)
        nbytes = (2 * q.numel() * 2 + bt.numel() * 4 + cl.numel() * 4
                  + 2 * pages * page * KVH * (hd + 4))
        kd = pa.gather_kv(kq, bt, ks).to(bf).transpose(1, 2).contiguous()
        vd = pa.gather_kv(vq, bt, vs).to(bf).transpose(1, 2).contiguous()
        mask = (torch.arange(S, device="cuda")[None, :] < cl[:, None])[
            :, None, None, :]
        q4 = q[:, :, None, :]
        rows[f"paged_attention_decode_{kv_dtype}"] = dict(
            ms=time_cuda(lambda: pa.paged_attention(
                q, kq, vq, bt, cl, scale=scale, k_scale=ks, v_scale=vs)),
            plain_ms=time_cuda(lambda: pa.paged_attention_plain(
                q, kq, vq, bt, cl, scale, ks, vs)),
            library_ms=time_cuda(lambda: F.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True)),
            library="SDPA over K/V gathered and dequantized beforehand",
            shape=f"B={B} H={H} KVH={KVH} hd={hd} bp={bp} lens={lens[0]}.."
                  f"{lens[-1]} bf16 q, {kv_dtype} pool",
            bytes=nbytes, flops=4 * hd * H * sum(lens), dtype=bf)

        q, kp, vp, bt, pl, nv, ok, ov = prefill_inputs(
            g, C, H, KVH, hd, bp, prefix, C, torch.float32)
        kq, vq, ks, vs = quantize(kvq, kp, vp, kv_dtype)
        q, ok, ov = q.to(bf), ok.to(bf), ov.to(bf)
        pages = -(-prefix // page)
        nbytes = (2 * q.numel() * 2 + 2 * ok.numel() * 2 + bt.numel() * 4
                  + 8 + 2 * pages * page * KVH * (hd + 4))
        keys = torch.cat([pa.gather_kv(kq, bt, ks)[:, :prefix].to(bf), ok],
                         1)
        vals = torch.cat([pa.gather_kv(vq, bt, vs)[:, :prefix].to(bf), ov],
                         1)
        kd = keys.transpose(1, 2).contiguous()
        vd = vals.transpose(1, 2).contiguous()
        qd = q.transpose(1, 2)
        rows[f"paged_attention_prefill_{kv_dtype}"] = dict(
            ms=time_cuda(lambda: pa.paged_attention_prefill(
                q, kq, vq, bt, pl, nv, ok, ov, scale=scale, k_scale=ks,
                v_scale=vs)),
            plain_ms=time_cuda(lambda: pa.paged_attention_prefill_plain(
                q, kq, vq, bt, pl, nv, ok, ov, scale, None, ks, vs)),
            library_ms=time_cuda(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=cmask, scale=scale, enable_gqa=True)),
            library="SDPA over K/V gathered and dequantized beforehand",
            shape=f"B=1 C={C} H={H} KVH={KVH} hd={hd} prefix={prefix} "
                  f"bf16 q, {kv_dtype} pool",
            bytes=nbytes, flops=4 * hd * H * visible, dtype=bf)

    # K3 at the kernels phase's shape: B = 1, H = 32, S = 2048, causal bf16
    Sf = 2048
    qf, kf, vf = (torch.randn(1, H, Sf, hd, generator=g, device="cuda")
                  .to(bf) for _ in range(3))
    rows["flash_attention"] = dict(
        ms=time_cuda(lambda: fa.flash_attention(qf, kf, vf, causal=True)),
        plain_ms=time_cuda(lambda: fa.flash_attention_plain(qf, kf, vf,
                                                            True)),
        library_ms=time_cuda(lambda: F.scaled_dot_product_attention(
            qf, kf, vf, is_causal=True)),
        library="SDPA, is_causal",
        shape=f"B=1 H={H} S={Sf} hd={hd} causal bf16",
        bytes=4 * qf.numel() * 2, flops=4 * hd * H * Sf * (Sf + 1) // 2,
        dtype=bf)

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
        launches_ms=device_split(lambda: ss.step_score(h, w1, b1, w2, b2)),
        shape=f"B={B} D={D} hidden={Hd} bf16 hidden, f32 weights",
        bytes=h.numel() * 2 + (w1.numel() + 2 * Hd + 1 + B) * 4,
        flops=2 * B * D * Hd + 4 * B * Hd, dtype=torch.float32)
    # the same at the kernels phase's 64 lanes (this line only)
    h64 = torch.randn(64, D, generator=g, device="cuda").to(bf)
    rows["step_score_b64"] = dict(
        ms=time_cuda(lambda: ss.step_score(h64, w1, b1, w2, b2)),
        plain_ms=time_cuda(lambda: ss.step_score_plain(h64, w1, b1, w2,
                                                       b2)),
        library_ms=None,
        shape=f"B=64 D={D} hidden={Hd} bf16 hidden, f32 weights",
        bytes=h64.numel() * 2 + (w1.numel() + 2 * Hd + 1 + 64) * 4,
        flops=2 * 64 * D * Hd + 4 * 64 * Hd, dtype=torch.float32)

    # K4 at forward_ssd's shape: B = 1, S = 2048, H = 80, P = 64, N = 128,
    # chunk 256, f32. Operations: C.B^T once per chunk (lower triangle),
    # the intra product over the causal half, the carry-in on every chunk
    # but the first (its state is zero), the state update everywhere.
    x, dt, A, Bm, Cm = ssd_inputs(g, 2048, False)
    Bs, Ss, Hs, Ps = x.shape
    Ns, ls = Bm.shape[-1], 256
    nc, tri = Ss // ls, ls * (ls + 1) // 2
    flops = (2 * Ns * tri * nc * Bs + 2 * Ps * tri * nc * Bs * Hs
             + 2 * Ps * Ns * (Ss - ls) * Bs * Hs + 2 * Ps * Ns * Ss * Bs * Hs)
    nbytes = 4 * (2 * x.numel() + dt.numel() + A.numel() + 2 * Bm.numel()
                  + Bs * Hs * Ps * Ns)
    rows["ssd_scan"] = dict(
        ms=time_cuda(lambda: sd.ssd_scan(x, dt, A, Bm, Cm, chunk=ls)),
        plain_ms=time_cuda(lambda: sd.ssd_scan_plain(x, dt, A, Bm, Cm),
                           reps=5, warmup=1),
        library_ms=None, library="none (no single call)",
        launches_ms=device_split(lambda: sd.ssd_scan(x, dt, A, Bm, Cm,
                                                     chunk=ls)),
        shape=f"B={Bs} S={Ss} H={Hs} P={Ps} N={Ns} chunk={ls} f32",
        bytes=nbytes, flops=flops, dtype=torch.float32)

    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["flops"],
                                                r.pop("dtype"))
        r["bound_share"] = r["bound_ms"] / r["ms"]
    emit("times", **rows)
    return rows


def phase_step(rt, cfg, params, name="step"):
    """One full-width decode iteration (``decode_step``, kernels on) at the
    serve phase's shape: the host's wall time per eager call against the
    device time of the same work replayed from a CUDA graph. Their
    difference is what the host adds (op-by-op launches). The ssm stack
    also reads and writes its whole recurrent state once per iteration
    (``state_bound_ms``)."""
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
    if "ssm_state" in cache:
        state_bytes = sum(cache[k].numel() * cache[k].element_size()
                          for k in ("ssm_state", "conv_state"))
        out["state_bound_ms"] = 2 * state_bytes / HBM_BYTES_PER_S * 1e3
    emit(name, **out)
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
             "arithmetic": "data.arithmetic", "model": "models.model",
             "kv_quant": "models.kv_quant", "trainer": "training.trainer",
             "optimizer": "training.optimizer", "tree": "training.tree",
             "dataset": "data.dataset", "pipeline": "core.pipeline"}
    rt = {k: importlib.import_module(f"repro_torch.{v}")
          for k, v in names.items()}
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as sd
    from repro_torch.kernels import step_score as ss
    kvq = rt["kv_quant"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = phase_device()
    phase_build(ops)
    errs = phase_kernels(pa, ss, fa, sd, kvq)
    cfg, params, scorer, n_params, init_s = full_model(rt)
    emit("model", name=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         params=n_params, init_s=init_s)
    serve = phase_serve(rt, ops, cfg, params, scorer)
    phase_smoke_reference(rt)
    batched = phase_batched(rt, ops, cfg, params, scorer)
    # chunks of 8: the 15-token prompt prefills in two chunks (the
    # scheduler prefills one-shot a prompt that fits in one chunk)
    quant = {kv_dtype: phase_serve(rt, ops, cfg, params, scorer, kv_dtype,
                                   chunk=8)
             for kv_dtype in QUANT}
    phase_smoke_reference(rt, "int8", chunk=4)
    forward = phase_forward_kernel(rt, ops, cfg, params)
    phase_train(rt, ops, cfg, params)
    times = phase_times(pa, ss, fa, sd, kvq)
    phase_step(rt, cfg, params)

    # mamba2 at full width, after qwen3's params are freed (the train phase
    # peaks at 74 GB of the 80)
    del params, scorer
    torch.cuda.empty_cache()
    mcfg, mparams, mscorer, n_params, init_s = full_model(rt, "mamba2-2.7b")
    emit("model", name=mcfg.name, layers=mcfg.num_layers,
         d_model=mcfg.d_model, params=n_params, init_s=init_s)
    serve_ssm = phase_serve_mamba2(rt, ops, mcfg, mparams, mscorer)
    phase_smoke_reference(rt, arch="mamba2-2.7b")
    forward_ssd = phase_forward_ssd(rt, ops, mcfg, mparams)
    phase_step(rt, mcfg, mparams, "step_mamba2")

    # (source, TPU kernel, error key, launches on the main path)
    src = "src/repro_torch/csrc/"
    paged = (src + "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:62")
    meta = {
        "paged_attention_decode": (*paged, "decode_bfloat16",
                                   serve["launches"]["paged_attention_decode"]
                                   + batched["launches"][
                                       "paged_attention_decode"]),
        "paged_attention_prefill": (*paged, "prefill_bfloat16",
                                    batched["launches"][
                                        "paged_attention_prefill"]),
        "step_score": (src + "step_score.cu",
                       "src/repro/kernels/step_score.py:30",
                       "score_bfloat16",
                       serve["launches"]["step_score"]
                       + batched["launches"]["step_score"]
                       + serve_ssm["launches"]["step_score"]),
        "flash_attention": (src + "flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:38",
                            "flash_bfloat16",
                            forward["launches"]["flash_attention"]),
        "ssd_scan": (src + "ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:40", "ssd_scan",
                     forward_ssd["launches"]["ssd_scan"]),
    }
    for kv_dtype, run in quant.items():
        for face in ("decode", "prefill"):
            meta[f"paged_attention_{face}_{kv_dtype}"] = (
                *paged, f"{face}_{kv_dtype}_bfloat16",
                run["launches"][f"paged_attention_{face}_quant"])
    kernels = []
    for name, (source, replaces, err_key, launches) in meta.items():
        t = times[name]
        check(launches > 0, f"{name}: no launch on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
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
