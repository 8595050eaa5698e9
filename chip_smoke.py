#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device   — the card's name, count, and nvidia-smi's power limit;
  2. build    — nvcc builds every kernel from ``src/repro_torch/csrc``
                (in parallel) and reports registers and spills per kernel
                instance (template arguments demangled where a demangler
                exists), the instances below hd 128 that spill more than
                their hd-128 twin, and the HMMA/HGMMA (tensor-core)
                instructions in each library's SASS where ``cuobjdump``
                exists (K3's library must hold HGMMA, its wgmma face, and
                HMMA, its mma.sync and 3xTF32 faces; the paged kernel's
                HGMMA: its wgmma prefill kernel; the cluster decode
                face's HMMA), and fails if a wgmma kernel (K1b's prefill,
                K3's bf16 face), an instance of the cluster decode face
                (``csrc/paged_decode.cu``) or of K2's main kernel
                (``score_kernel``) spills;
  3. kernels  — each kernel's wrapper against its plain PyTorch version
                on the card, at the main paths' full-width shapes: the
                paged kernel over bf16/f32 pools (K1a: bf16 queries over
                a bf16, int8 or fp8 pool at hd 64/80/128 take the cluster
                face, counted under ``paged_attention_decode_cluster`` /
                ``..._decode_quant_cluster``, the rest ``decode_kernel``,
                ``paged_attention_decode`` / ``..._decode_quant``: the
                ``kernels`` line's ``decode_launches`` shows all four
                moved; K1b: bf16 queries
                over a bf16 pool at hd 64/128 take its wgmma prefill
                kernel, counted under ``paged_attention_prefill_wgmma``,
                the other prefill cases ``paged_attention_prefill``; over
                an int8/fp8 pool ``..._prefill_quant_wgmma`` and
                ``..._prefill_quant``) and over
                int8/fp8 pools (K1c) at qwen3's heads (32 over 8, hd 128),
                zamba2's (32 over 32, hd 80) and granite-20b's (48 over 1,
                hd 128), the scorer (K2), flash attention (K3 at hd 128,
                80, 64 and 32, each in bf16 and f32: its ``kernels`` line's
                ``flash_launches`` shows that the wgmma, mma.sync tile and
                3xTF32 faces each ran), the SSD scan (K4's wgmma face at
                mamba2's state 128 and zamba2's 64: y and the final state,
                also over a padded sequence and with the init's steep
                decays; its tile face called directly at both), and
                Mamba2's decode state
                update (``ssm_decode`` at both states: 128 chained steps,
                every lane's state moving);
  4. serve    — STEP serving of qwen3-4b-thinking at full width (random
                seeded weights) under memory pressure through
                ``Engine.serve``, kernels on: launch counts (the cluster
                decode face once per attention layer and decode
                iteration, ``decode_kernel`` never; so in every bf16,
                int8 and fp8 serve phase), pruning, a
                drained pool; then the kernel engine against the dense
                engine at the smoke config (f32, greedy tokens identical).
                Every serve phase runs the engine as users do (each decode
                tick one CUDA-graph replay) three times, and once through
                the eager horizon (``_eager_decode``): its ``graph`` field
                holds both runs (wall, decode seconds, iterations, replays
                against ticks, captures and their seconds, peak memory,
                the device ms of one iteration) and the check that both
                give the same tokens, statuses and prunes;
  5. batched  — four requests through ``Engine.serve_batch`` with chunked
                prefill and the prefix cache: the prefill kernel face and
                a prefix-cache hit (a fresh engine for each graphed call);
  6. serve_int8, serve_fp8 — the serve phase over a quantized pool, with
                chunked prefill: both faces of K1c; then the int8 kernel
                engine against the int8 dense engine at the smoke config;
     serve_sampled — temperature 0.8 through the scalar sampler, then
                mixed per-request params through the lane-wise sampler,
                graphed against eager from one generator seed: the same
                tokens;
  7. forward_kernel — ``forward_full(use_kernel=True)`` at full width
                against the dense forward: one K3 launch per layer;
  8. train    — AdamW steps of ``make_train_step`` at full width, then
                ``build_step_scorer`` and a STEP serve with that scorer;
  9. times    — device time of each kernel, its plain version and the
                library yardstick (the median of 30 CUDA-graph replays,
                cold L2, the fastest and slowest beside it), the floor
                (``empty_kernel``: a launch that does nothing), K1a/K1c's
                decode rows also through ``decode_kernel`` on the same
                inputs (``split_ms``), and each kernel's bound, at the
                serve and
                forward phases' shapes (qwen3, and the ``_hd80``, ``_g48``
                and ``_zamba2`` instances of this slice's paths); also K1a
                over long rows (``paged_attention_decode_long``, 16 lanes
                of 1024-4096 slots), K2 at the kernels phase's 64 lanes
                (``step_score_b64``) and K3 at hd 80 in f32, on this line
                only, K4's tile face on the same inputs as its wgmma face
                (``tile_ms``), K2's plan, and the device time of each
                launch inside K2, K4 (both faces) and ``ssm_decode``
                (torch.profiler);
 10. step     — one full-width decode iteration: eager wall time against
                the device time of its CUDA-graph replay, and its kernels
                by device time (torch.profiler);
     launch_steps — the launchers' steps (``repro_torch.launch.steps``)
                at full width: a 2048-token prefill of 16 lanes, its K/V
                in contiguous caches laid out by ``kv_cache_specs``
                (decode_32k cut to 16 x 4096), 32 decode steps held to
                the teacher-forced forward;
     roofline_decode — ``launch.cost_analysis.op_cost`` over one
                ``make_decode_step`` call at launch_steps' shape (no
                mesh): its counted flops and bytes and the roofline terms
                they give at the H100's datasheet peaks, beside the same
                call's device ms (torch.profiler) and wall ms;
     launch_train — qwen3's params freed, ``launch.train.main`` at full
                width (B 8 in 4 microbatches, remat): losses, seconds per
                step, peak memory;
     launch_serve — ``launch.artifacts`` trains the serving artifacts on
                the card, then ``launch.serve.main`` runs SC and STEP
                under ``--blocks 12`` (STEP prunes and never waits, SC
                preempts and waits), an online chunked run and an int8
                run: K1a, K1b, K1c and K2 at the serving config's shapes,
                graph captures and their seconds;
     examples — ``examples/torch_quickstart.py``'s ``main`` as a user
                runs it, at its own scale (300 LM steps on the serving
                config, the scorer built from its samples, SC against STEP
                under a 12-block pool), kernels on ("auto") and prompts
                prefilled in chunks of 8: SC's and STEP's latency, wait,
                prunes and preemptions, and the K1a, K1b and K2 launches
                it made, each nonzero;
 11. serve_mamba2 — qwen3's params freed, STEP serving of mamba2-2.7b at
                full width (64 layers, random seeded weights, per-slot
                recurrent state, no KV pool) through ``Engine.serve``,
                kernels on: the fused scorer and ``ssm_decode``, pruning
                with no wait, a drained pool, graphed against eager; then
                the kernel engine against the dense engine at the mamba2
                smoke config;
 12. forward_ssd — ``forward_full(use_kernel=True)`` of mamba2 at full
                width against the dense forward: one K4 launch per layer,
                each on its wgmma face (the tile face never);
 13. step_mamba2 — phase 10 for mamba2's decode iteration.
 14. serve_zamba2, reference_zamba2, forward_zamba2, step_zamba2 —
                phases 11-13 for zamba2-2.7b at full width (54 Mamba2
                layers in 9 groups, each followed by the one shared
                attention block at hd 80): K1a once per shared-attention
                invocation and iteration, ``ssm_decode`` once per Mamba2
                layer, K2 once; the forward runs K4 per Mamba2 layer and
                K3 (hd 80) per invocation;
 15. dense_archs — qwen3-1.7b, internvl2-2b (the vlm, served as text),
                starcoder2-3b, phi4-mini-3.8b and granite-20b at full
                width, one at a time: a graphed STEP serve against the
                eager one (1 x 8 traces, 32 new tokens), then each arch's
                smoke-config kernel engine against its dense engine;
 16. serve_mixtral, reference_mixtral — mixtral-8x7b at full width, 16
                of its 32 layers (8 experts of 14336, top 2, capacity
                factor 1.25; 47 GB of bf16 weights): phase 4's serve,
                with the pairs and lanes that the expert capacity drops at
                the first decode iteration; then the smoke config's kernel
                engine against its dense engine under an 8-token window;
 17. batched_mixtral — a 4200-token prompt in chunks of 512 past the 4096
                window (K1b's window branch), 4 traces, the prefix cache
                on: graphed against eager, and the kernel engine against
                the dense engine (statuses and prunes equal, logits from
                one history and routing within 5%; where tokens part, both
                paths' logits there);
 18. forward_mixtral — ``forward_full(use_kernel=True)`` at S = 8192
                against the dense forward: one windowed K3 launch per
                layer, and again with the dense routing replayed; each
                token's first MoE routing flip within rounding's reach
                of a gate tie, or after an earlier flip in its window;
 19. step_mixtral — phase 10 for mixtral's decode iteration.
 20. serve_deepseek, reference_deepseek, mla_layer, step_deepseek —
                deepseek-v2-236b at full width, 8 of its 60 layers (MLA
                over a latent pool of 576 per token and layer; 160 routed
                experts top 6 plus 2 shared; 65.7 GB of bf16 weights), after
                mixtral's are freed: phase 4's serve, which the JAX engine
                runs dense (no kernel path for MLA): no K1 or K2 launch,
                graphed against eager, the pairs the capacity of 1 per
                expert drops at the first decode iteration; the smoke
                config's CUDA engine against the CPU engine (and
                ``use_kernel=True`` refused); one MLA layer's absorbed
                decode over a pool filled from the full forward's latent
                entries against the full forward's rows; phase 10;
 21. forward_seamless, decode_seamless — seamless-m4t-large-v2 at full
                depth (24 encoder and 24 decoder layers, hd 64, 16 heads
                over 16): ``forward_full(use_kernel=True)`` with the
                encoder over 1024 frame embeddings and the decoder over 512
                tokens, one K3 launch per decoder layer, against the dense
                forward; then 8 lanes with their cross caches, a 64-token
                prompt and 64 teacher-forced ``decode_step`` calls through
                K1a (24 per step) against the same calls dense.

Beside all of these, from the start, a child process runs the
production dry run on the host's CPU (``dryrun``: ``python -m
repro_torch.launch.dryrun --arch qwen3-4b-thinking --both-meshes``, then
``--arch granite-20b --shape train_4k --multi-pod``, one thread, on a
core of its own that the script's threads leave to it): every shape of
qwen3-4b-thinking over the 256- and 512-rank meshes of a fake process
group, and granite-20b's train_4k over the 512-rank mesh (whose
tracing time rests on ``launch.spmd``'s layout of its attention's P.V).
Its records are read at the end: each must be ``ok``;
their status, dominant roofline term, per-device GiB and trace seconds
are printed (counts at datasheet peaks, not measurements), with the
seconds the script waited for the child.

The kernels phase also checks K1a/K1c at batched_mixtral's decode (4
lanes over 288-page rows: each lane's pages in 9 parts, merged), K1b/K1c
under mixtral's window at its 512-token chunk, K3 at S = 8192 under the
window and K2 at D = 4096; the times phase times them
(``paged_attention_decode_mixtral``, ``paged_attention_prefill_swa``,
``flash_attention_swa``, ``step_score_d4096``; K1c's prefill face there
over int8 and fp8 pools, ``paged_attention_prefill_{int8,fp8}_swa``, and
K1b at the same chunk and prefix with no window,
``paged_attention_prefill_long``, on the times line only), each windowed bound
counting only the visible (query, key) pairs and the pages that hold
them. Both phases check and time K1a at decode_seamless's shape and K3 at
forward_seamless's (``paged_attention_decode_seamless``,
``flash_attention_seamless``), and K1a, K1b, K1c (int8) and K2 at
launch_serve's (the serving config: 4 query heads over 2 at hd 64, 16
lanes of 16-page rows, chunks of 8, D 256; the ``*_launch`` rows and
``step_score_d256``).

The line before the last is the kernel table as one JSON object, the last
line ``{"ok": true, "device": {...}}``. Any failed check raises: the
script exits non-zero and prints no result. Without a CUDA device it
exits 2 before doing anything.
"""
from __future__ import annotations

import atexit
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
TF32X3 = "3xtf32"
# dense peaks: bf16 tensor cores, f32 CUDA cores, and f32 products in
# 3xTF32 on the tensor cores (three TF32 products per f32 product, so a
# third of TF32's 495), the rate of the kernels that take them (K3's f32
# face, K4)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              TF32X3: 495e12 / 3}
BF16_TOL = dict(atol=1e-2, rtol=1e-2)   # one bf16 ulp of the output
F32_TOL = dict(atol=1e-4, rtol=1e-4)    # summation order only
SCORE_TOL = dict(atol=1e-5, rtol=1e-5)  # f32 throughout
# the SSD scan against its sequential plain version: the chunked form
# exponentiates cumsum differences instead of multiplying per-step decays
# (tests/test_kernels.py holds the Pallas kernel to the recurrence so)
SSD_TOL = dict(atol=2e-3, rtol=2e-3)
QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
SEED = 0
# K1b's launch counters: the wgmma prefill kernel (bf16 queries over a bf16
# pool at hd 64/128) and the other float-pool prefill kernels; K1c's prefill
# face over an int8/fp8 pool the same way
K1B = ("paged_attention_prefill_wgmma", "paged_attention_prefill")
K1C_PREFILL = ("paged_attention_prefill_quant_wgmma",
               "paged_attention_prefill_quant")


# K1a's decode launch counters: the cluster face (bf16 queries over a bf16,
# int8 or fp8 pool at hd 64/80/128) and decode_kernel, the split face (f32
# queries or pools, hd 32); K1c's decode face over an int8/fp8 pool the
# same way
K1A = ("paged_attention_decode_cluster", "paged_attention_decode")
K1C_DECODE = ("paged_attention_decode_quant_cluster",
              "paged_attention_decode_quant")
SPLIT_DECODE = ("paged_attention_decode", "paged_attention_decode_quant")


def k1b_launches(launches: dict, faces=K1B) -> int:
    return sum(launches[k] for k in faces)


def k1a_launches(launches: dict) -> int:
    """Decode launches of either face over any pool."""
    return sum(launches[k] for k in K1A + K1C_DECODE)


def check_decode_launches(name, cfg, launches, iters, quant=False):
    """A bf16, int8 or fp8 serve of the dense or MoE stack: the cluster
    decode face once per attention layer and decode iteration,
    ``decode_kernel`` never. The decode glue (``layers.glue_route``): over
    a bf16 pool two ``add_rms_norm`` per layer and iteration plus the
    final norm's and one ``attn_prologue`` per layer and iteration, over
    an int8/fp8 pool neither; ``silu_mul`` at least once per layer and
    iteration on both (the prefills add theirs)."""
    face = K1C_DECODE[0] if quant else K1A[0]
    layers = len(cfg.attention_layer_ids())
    check(launches[face] == iters * layers > 0,
          f"{name}: {face} launched {launches[face]} times over {iters} "
          f"decode iterations")
    check(all(launches[k] == 0 for k in SPLIT_DECODE),
          f"{name}: decode_kernel ran")
    want = {"add_rms_norm": 0 if quant else iters * (2 * layers + 1),
            "attn_prologue": 0 if quant else iters * layers}
    got = {k: launches[k] for k in want}
    check(got == want, f"{name}: decode glue launches {got}, not {want}")
    check(launches["silu_mul"] >= iters * layers,
          f"{name}: silu_mul launched {launches['silu_mul']} times over "
          f"{iters} decode iterations")


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


def demangle(names):
    """C++ names of mangled kernel symbols, short: the kernel and its
    template arguments (``decode_kernel<80, 1, bf16, bf16>``), or the
    mangled names where no demangler is installed."""
    import shutil
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.split("\n")
    short = []
    for full in out[:len(names)]:
        full = full.replace("(anonymous namespace)::", "").split("(")[0]
        for long, name in (("__nv_bfloat16", "bf16"), ("__nv_fp8_e4m3", "fp8"),
                           ("signed char", "int8"), ("float", "f32"),
                           ("void ", "")):
            full = full.replace(long, name)
        short.append(full.strip())
    return short


def registers_spills(fns):
    """ptxas entries of one source -> {kernel<template args>: {"registers":
    n, "spill_bytes": stores + loads}}."""
    out = {}
    for f, name in zip(fns, demangle([f["function"] for f in fns])):
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill",
                                             f["spills"])]
        out[name] = {"registers": f["registers"], "spill_bytes": sum(spills)}
    return out


def spills_beyond_hd128(table):
    """The head-dim-templated attention kernels (head dim first among
    their template arguments) whose instance at a head dim below 128
    spills more than the same instance at 128."""
    worse = []
    for name, row in table.items():
        m = re.match(r"(\w+)<(\d+)(.*)>$", name)
        if not m or int(m.group(2)) >= 128:
            continue
        ref = table.get(f"{m.group(1)}<128{m.group(3)}>")
        if ref is not None and row["spill_bytes"] > ref["spill_bytes"]:
            worse.append([name, row["spill_bytes"], ref["spill_bytes"]])
    return worse


# The instances that spill more than their head-dim-128 counterpart
# (ptxas of CUDA 12.8 for sm_90a), with their spill bytes: the 4-row decode
# instance at hd 80 over a bf16 pool, which no config reaches (zamba2's
# group is one query head per kv head). Any other instance, or more bytes,
# fails the build phase.
KNOWN_SPILLS_BEYOND_HD128 = {"decode_kernel<80, 4, f32, bf16>": 42,
                             "decode_kernel<80, 4, bf16, bf16>": 42}


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
    table = {src: registers_spills(summary.get(src, []))
             for src in ops.SOURCES}
    attention = {**table["paged_attention"], **table["paged_decode"],
                 **table["flash_attention"]}
    worse = spills_beyond_hd128(attention)
    emit("build", seconds=round(seconds, 3), ptxas=summary,
         registers_spills=table, spills_beyond_hd128=worse,
         tensor_core_instructions=tc)
    for name, spill, _ in worse:
        check(spill <= KNOWN_SPILLS_BEYOND_HD128.get(name, 0),
              f"{name} spills {spill} B, beyond its hd-128 instance")
    if tc != "not available":
        check(tc["flash_attention"]["HGMMA"] > 0,
              "K3's wgmma face has no HGMMA")
        check(tc["flash_attention"]["HMMA"] > 0,
              "K3's mma.sync and 3xTF32 faces have no HMMA")
        check(tc["paged_attention"]["HGMMA"] > 0,
              "K1b's wgmma prefill kernel has no HGMMA")
        check(tc["paged_decode"]["HMMA"] > 0,
              "K1a's cluster face has no HMMA")
        check(tc["ssd_wgmma"]["HGMMA"] > 0, "K4's wgmma face has no HGMMA")
    for src, kernel in (("paged_attention", "prefill_wgmma_kernel"),
                        ("paged_decode", "decode_cluster_kernel"),
                        ("flash_attention", "flash_wgmma_kernel"),
                        ("ssd_wgmma", ""), ("step_score", "score_kernel"),
                        ("decode_glue", "")):
        for name, row in table[src].items():
            if kernel in name:
                check(row["spill_bytes"] == 0,
                      f"{name} spills {row['spill_bytes']} B")
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


def ssm_decode_inputs(g, dtype, B=16, H=80, P=64, N=128, W=4):
    """``ssm_decode``'s operands at mamba2's full width: params as the init
    makes them (f32 dt_bias, A_log and D), a bf16 conv state and an f32
    ssm state."""
    C = H * P + 2 * N
    params = (torch.randn(W, C, generator=g, device="cuda").mul(0.5)
              .to(dtype),
              torch.randn(C, generator=g, device="cuda").mul(0.1).to(dtype),
              torch.log(torch.expm1(torch.rand(H, generator=g, device="cuda")
                                    * 0.09 + 0.01)),
              torch.log(torch.arange(1, H + 1, device="cuda",
                                     dtype=torch.float32)),
              torch.randn(H, generator=g, device="cuda"))
    ssm = torch.randn(B, H, P, N, generator=g, device="cuda")
    conv = torch.randn(B, W - 1, C, generator=g, device="cuda").to(
        torch.bfloat16)
    return params, ssm, conv


def ssm_projection(g, dtype, B=16, H=80, P=64, N=128):
    """xbc [B, C] and dt [B, H] as strided slices of one projection row, as
    the mixer hands them over (z in front)."""
    C = H * P + 2 * N
    proj = torch.randn(B, H * P + C + H, generator=g, device="cuda").to(dtype)
    return proj[:, H * P:H * P + C], proj[:, H * P + C:]


def check_ssm_decode(smd, g, errs, steps=128, N=128, key="ssm_decode"):
    """``ssm_decode`` against its plain version over ``steps`` chained
    decode steps at full width, each side feeding its own states on: the
    conv state exactly, y and the ssm state within the f32 (1e-4) or bf16
    (1e-2) tolerance. Lanes 0-3 are re-fed one fixed projection, as a
    stopped lane re-feeds its last token: their state must move at every
    step, as every lane's does (nothing is masked). ``N``: the state size
    (mamba2 128, zamba2 64)."""
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        params, ssm, conv = ssm_decode_inputs(g, dtype, N=N)
        ssm_p, conv_p = ssm.clone(), conv.clone()
        frozen = ssm_projection(g, dtype, N=N)
        err = 0.0
        for _ in range(steps):
            xbc, dt = ssm_projection(g, dtype, N=N)
            xbc[:4], dt[:4] = frozen[0][:4], frozen[1][:4]
            before = ssm.clone()
            y = smd.ssm_decode(conv, ssm, xbc, dt, *params)
            y_p, ssm_p, conv_p = smd.ssm_decode_plain(conv_p, ssm_p, xbc, dt,
                                                      *params)
            conv_p = conv_p.to(torch.bfloat16)
            torch.cuda.synchronize()
            check(torch.equal(conv, conv_p), "ssm_decode: conv state differs")
            check(bool((ssm != before).flatten(1).any(1).all()),
                  "ssm_decode: a lane's state did not move")
            err = max(err, compare(f"ssm_decode {dtype} state", ssm, ssm_p,
                                   tol),
                      compare(f"ssm_decode {dtype} y", y, y_p, tol))
        errs[f"{key}_{str(dtype)[6:]}"] = err
        del params, ssm, conv, ssm_p, conv_p


def check_paged(pa, kvq, g, errs, B, H, KVH, hd, bp, lens, chunks,
                quant_chunks, tag=""):
    """K1 against its plain version at one head shape, with queries in
    bf16 and f32: the decode face over B lanes of ``lens`` (a float pool,
    K1a; int8 and fp8 pools, K1c) and the prefill face over each (C,
    prefix, num_valid) of ``chunks`` (float pool, K1b) and
    ``quant_chunks`` (K1c), each without a window and with one of 128.
    A lane of length 0 must give a zero row. ``errs`` gains
    ``{face}[_{pool}]{tag}_{dtype}``."""
    scale = 1.0 / math.sqrt(hd)
    dtypes = ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL))
    for dtype, tol in dtypes:
        args = decode_inputs(g, B, H, KVH, hd, bp, lens, dtype)
        got = pa.paged_attention(*args, scale=scale)
        want = pa.paged_attention_plain(*args, scale)
        torch.cuda.synchronize()
        check(0 not in lens or bool((got[lens.index(0)] == 0).all()),
              "K1a: empty-cache row not zero")
        errs[f"decode{tag}_{str(dtype)[6:]}"] = compare(
            f"K1a{tag} {dtype}", got, want, tol)
    for (C, prefix, nvalid), window in ((c, w) for c in chunks
                                        for w in (None, 128)):
        for dtype, tol in dtypes:
            args = prefill_inputs(g, C, H, KVH, hd, bp, prefix, nvalid, dtype)
            got = pa.paged_attention_prefill(*args, scale=scale, window=window)
            want = pa.paged_attention_prefill_plain(*args, scale, window)
            torch.cuda.synchronize()
            key = f"prefill{tag}_{str(dtype)[6:]}"
            errs[key] = max(errs.get(key, 0.0), compare(
                f"K1b{tag} C={C} prefix={prefix} window={window} {dtype}",
                got, want, tol))
    # K1c: the same shapes over int8 and fp8 pools (f32 scales per slot)
    for kv_dtype in QUANT:
        for dtype, tol in dtypes:
            q, kp, vp, bt, cl = decode_inputs(g, B, H, KVH, hd, bp, lens,
                                              torch.float32)
            kq, vq, ks, vs = quantize(kvq, kp, vp, kv_dtype)
            args = (q.to(dtype), kq, vq, bt, cl)
            got = pa.paged_attention(*args, scale=scale, k_scale=ks,
                                     v_scale=vs)
            want = pa.paged_attention_plain(*args, scale, ks, vs)
            torch.cuda.synchronize()
            check(0 not in lens or bool((got[lens.index(0)] == 0).all()),
                  "K1c: empty-cache row not zero")
            errs[f"decode_{kv_dtype}{tag}_{str(dtype)[6:]}"] = compare(
                f"K1c{tag} decode {kv_dtype} {dtype}", got, want, tol)
            for (C, prefix, nvalid), window in ((c, w) for c in quant_chunks
                                                for w in (None, 128)):
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
                key = f"prefill_{kv_dtype}{tag}_{str(dtype)[6:]}"
                errs[key] = max(errs.get(key, 0.0), compare(
                    f"K1c{tag} prefill {kv_dtype} C={C} prefix={prefix} "
                    f"window={window} {dtype}", got, want, tol))


def check_flash(fa, g, errs, H, hd, tag="", S=2048):
    """K3 against its plain version at B = 1 over S tokens: causal, a
    window of 128 and non-causal, in bf16 and f32."""
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        qkv = [torch.randn(1, H, S, hd, generator=g, device="cuda")
               .to(dtype) for _ in range(3)]
        for causal, window in ((True, None), (True, 128), (False, None)):
            got = fa.flash_attention(*qkv, causal=causal, window=window)
            want = fa.flash_attention_plain(*qkv, causal, window)
            torch.cuda.synchronize()
            key = f"flash{tag}_{str(dtype)[6:]}"
            errs[key] = max(errs.get(key, 0.0), compare(
                f"K3{tag} causal={causal} window={window} {dtype}", got, want,
                tol))
        del qkv


# mixtral-8x7b's sliding window and its chunked prefill's chunk width;
# forward_mixtral's sequence, twice the window
SWA_WINDOW, SWA_CHUNK = 4096, 512
FORWARD_MIXTRAL_S = 8192
# kernel against dense engine logits computed from one history: within
# this share of their largest magnitude (forward_kernel's tolerance)
PATHS_LOGIT_TOL = 0.05
# batched_mixtral's capacity, its block-table width (pages of 16) and
# lane lengths from its first decode iteration (4201) to its last (4216)
MIXTRAL_CAPACITY = 4608
MIXTRAL_BP = MIXTRAL_CAPACITY // 16
MIXTRAL_LENS = (4201, 4206, 4211, 4216)
# seamless-m4t-large-v2's decode phase: lanes, decoder prompt, steps, the
# capacity that holds them (8 pages of 16), the lane lengths the kernels
# phase checks (an empty lane, then the steps' 65..128), and the forward
# phase's decoder length
SEAMLESS_B, SEAMLESS_PROMPT, SEAMLESS_STEPS = 8, 64, 64
SEAMLESS_CAPACITY = 128
SEAMLESS_LENS = [0] + [65 + (63 * i) // 6 for i in range(7)]
SEAMLESS_S = 512


def check_prefill_window(pa, kvq, g, errs):
    """K1b and K1c's prefill face at mixtral-8x7b's chunked prefill: a
    512-token chunk of 32 query heads over 8 (hd 128) under the 4096
    window, whose edge moves through the chunk's rows across 32 pages of
    the pooled prefix (prefix 4608), and the first chunk past the window
    (prefix 4096, 104 valid); bf16 and f32 queries over bf16/f32 pools,
    bf16 queries over int8/fp8 pools. ``errs`` gains ``prefill_swa_*``
    and ``prefill_{int8,fp8}_swa_*``."""
    H, KVH, hd, C, W = 32, 8, 128, SWA_CHUNK, SWA_WINDOW
    scale = 1.0 / math.sqrt(hd)
    for prefix, nvalid in ((4608, C), (4096, 104)):
        bp = prefix // 16 + 1
        for dtype, tol in ((torch.bfloat16, BF16_TOL),
                           (torch.float32, F32_TOL)):
            args = prefill_inputs(g, C, H, KVH, hd, bp, prefix, nvalid,
                                  dtype)
            n0 = pa.LAUNCHES["prefill_wgmma"]
            got = pa.paged_attention_prefill(*args, scale=scale, window=W)
            check(pa.LAUNCHES["prefill_wgmma"] - n0
                  == (dtype == torch.bfloat16),
                  f"K1b swa {dtype}: the wgmma prefill kernel ran "
                  f"{pa.LAUNCHES['prefill_wgmma'] - n0} times")
            want = pa.paged_attention_prefill_plain(*args, scale, W)
            torch.cuda.synchronize()
            key = f"prefill_swa_{str(dtype)[6:]}"
            errs[key] = max(errs.get(key, 0.0), compare(
                f"K1b swa prefix={prefix} nvalid={nvalid} {dtype}", got,
                want, tol))
            del args
        for kv_dtype in QUANT:
            q, kp, vp, bt, pl, nv, ok, ov = prefill_inputs(
                g, C, H, KVH, hd, bp, prefix, nvalid, torch.float32)
            kq, vq, ks, vs = quantize(kvq, kp, vp, kv_dtype)
            bf = torch.bfloat16
            args = (q.to(bf), kq, vq, bt, pl, nv, ok.to(bf), ov.to(bf))
            n0 = pa.LAUNCHES["prefill_quant_wgmma"]
            got = pa.paged_attention_prefill(*args, scale=scale, window=W,
                                             k_scale=ks, v_scale=vs)
            check(pa.LAUNCHES["prefill_quant_wgmma"] == n0 + 1,
                  f"K1c swa {kv_dtype}: not the wgmma prefill kernel")
            want = pa.paged_attention_prefill_plain(*args, scale, W, ks, vs)
            torch.cuda.synchronize()
            key = f"prefill_{kv_dtype}_swa_bfloat16"
            errs[key] = max(errs.get(key, 0.0), compare(
                f"K1c swa prefill {kv_dtype} prefix={prefix}", got, want,
                BF16_TOL))
            del args, q, kp, vp


def flash_plain_by_heads(fa, q, k, v, window, step=4):
    """K3's plain version over ``step`` heads at a time (the same
    function): at S = 8192 all 32 heads' f32 scores would take 8.6 GB per
    tensor."""
    return torch.cat([fa.flash_attention_plain(
        q[:, h:h + step], k[:, h:h + step], v[:, h:h + step], True, window)
        for h in range(0, q.shape[1], step)], dim=1)


def check_flash_window(fa, g, errs):
    """K3 at forward_mixtral's shape: B = 1, H = 32, S = 8192, hd 128,
    causal under the 4096 window, bf16 and f32."""
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        qkv = [torch.randn(1, 32, 8192, 128, generator=g, device="cuda")
               .to(dtype) for _ in range(3)]
        got = fa.flash_attention(*qkv, causal=True, window=SWA_WINDOW)
        want = flash_plain_by_heads(fa, *qkv, SWA_WINDOW)
        torch.cuda.synchronize()
        errs[f"flash_swa_{str(dtype)[6:]}"] = compare(
            f"K3 S=8192 window={SWA_WINDOW} {dtype}", got, want, tol)
        del qkv, got, want
        torch.cuda.empty_cache()


def check_ssd(sd, g, errs, N, shapes, key):
    """K4 at full width (B = 1, H = 80, P = 64, state ``N``, chunk 256)
    against its sequential plain version: y and the final state over each
    (S, stress) of ``shapes``; an S short of a chunk multiple is padded
    with dt = 0, as the mixer pads. The route sends these shapes to the
    wgmma face: each call launches it once and the tile face never; the
    tile face, called directly on the first shape, is held to the plain
    version too (the times phase's yardstick)."""
    for k, (S, stress) in enumerate(shapes):
        x, dt, A, Bm, Cm = ssd_inputs(g, S, stress, N=N)
        pad = (-S) % 256
        padded = [torch.nn.functional.pad(t, [0, 0] * (t.dim() - 2)
                                          + [0, pad]) for t in (x, dt, Bm, Cm)]
        before = dict(sd.LAUNCHES)
        y, h = sd.ssd_scan(padded[0], padded[1], A, padded[2], padded[3],
                           chunk=256)
        moved = {f: sd.LAUNCHES[f] - before[f] for f in before}
        check(moved == {"ssd_scan": 1, "ssd_scan_wgmma": 1,
                        "ssd_scan_tile": 0},
              f"K4 N={N} S={S}: launches {moved}, not one of the wgmma face")
        yp, hp = sd.ssd_scan_plain(x, dt, A, Bm, Cm)
        torch.cuda.synchronize()
        errs[key] = max(
            errs.get(key, 0.0),
            compare(f"K4 N={N} S={S} stress={stress} y", y[:, :S], yp,
                    SSD_TOL),
            compare(f"K4 N={N} S={S} stress={stress} state", h, hp, SSD_TOL))
        if k == 0:
            yt, ht = sd.ssd_scan_tile(padded[0], padded[1], A, padded[2],
                                      padded[3], chunk=256)
            torch.cuda.synchronize()
            errs[key + "_tile"] = max(
                compare(f"K4 tile N={N} S={S} y", yt[:, :S], yp, SSD_TOL),
                compare(f"K4 tile N={N} S={S} state", ht, hp, SSD_TOL))
            del yt, ht
        del x, dt, Bm, Cm, padded, y, yp


# the decode glue's kernels (csrc/decode_glue.cu) at the two STEP cells'
# decode shapes over 64 lanes: qwen3-4b-thinking (D 2560, 32 query heads
# over 8 of 128, qk-norm, SwiGLU over F 9728) and mixtral-8x7b (D 4096, no
# qk-norm, the MoE's writer, the expert gate over 8 experts x 64 slots x
# F 14336); RoPE theta 1e6 in both
GLUE = {"qwen3": dict(D=2560, H=32, KVH=8, qk_norm=True, writer=False,
                      gate=(64, 9728)),
        "mixtral": dict(D=4096, H=32, KVH=8, qk_norm=False, writer=True,
                        gate=(8, 64, 14336))}
GLUE_B, GLUE_HD, GLUE_PAGE, GLUE_WINDOW = 64, 128, 16, 512
GLUE_EPS, GLUE_THETA = 1e-6, 1e6


def bf16_ulps(a, b):
    """|a - b| in bf16 ulps: the steps between the two bit patterns."""
    def key(x):
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)   # order-preserving
    return (key(a) - key(b)).abs()


def rope_bound(want):
    """What a one-ulp difference in the qk-norm may become through RoPE:
    one bf16 ulp of the output plus one of each of the rotation's two
    inputs (whose pair has the outputs' length), for ``want`` [..., hd]."""
    w = want.float()
    half = w.shape[-1] // 2
    r = torch.sqrt(w[..., :half] ** 2 + w[..., half:] ** 2)
    return 2.0 ** -7 * (w.abs() + 2 * torch.cat([r, r], dim=-1))


def glue_inputs(g, layers, spec):
    """One decode layer's glue operands at a ``GLUE`` shape: the residual
    stream and its update, a norm weight, the q/k/v products' outputs,
    the qk-norm weights, positions 0..1099 over the 512-slot window (so
    most slots wrap), block tables over a shuffled pool of 64 x 32 pages
    with lanes 16..23 frozen on the scratch block 0, the MoE's writer,
    the RoPE table, and the gate's operands."""
    B, hd, bs = GLUE_B, GLUE_HD, GLUE_PAGE
    bp = GLUE_WINDOW // bs
    nb = B * bp + 1

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    bt = (torch.randperm(nb - 1, generator=g, device="cuda") + 1
          ).reshape(B, bp).to(torch.int32)
    bt[16:24] = 0
    pos = torch.randint(0, 1100, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    pos[0] = 0   # RoPE is the identity there
    D, H, KVH = spec["D"], spec["H"], spec["KVH"]
    return dict(
        h=rn(B, D), delta=rn(B, D, scale=0.5), w=rn(D, scale=0.1) + 1,
        q=rn(B, H * hd, scale=2), k=rn(B, KVH * hd, scale=2),
        v=rn(B, KVH * hd),
        norms=((rn(hd, scale=0.1) + 1, rn(hd, scale=0.1) + 1)
               if spec["qk_norm"] else (None, None)),
        positions=pos, block_tables=bt,
        pools=[rn(nb, bs, KVH, hd) for _ in range(2)],
        writer=(layers.last_writer(bt, pos, GLUE_WINDOW, bs)
                if spec["writer"] else None),
        table=None, gate=rn(*spec["gate"], scale=4), up=rn(*spec["gate"]))


def prologue_args(gl, x, pools, lens=None):
    """``attn_prologue``'s arguments for ``glue_inputs``' operands."""
    if x["table"] is None:
        x["table"] = gl.rope_table(GLUE_HD, GLUE_THETA, "cuda")
    return (x["q"], x["k"], x["v"], *x["norms"], GLUE_EPS, x["positions"],
            x["table"], x["block_tables"], GLUE_WINDOW, pools[0], pools[1],
            x["writer"], lens)


def check_glue(gl, layers, g, errs):
    """Each glue kernel against its plain version (``kernels/
    decode_glue.py``, the chain's own ops) at both ``GLUE`` shapes:
    ``silu_mul``, the residual sum, the attended lengths and the V write
    bit for bit, RoPE too without qk-norm; a normed value within one bf16
    ulp (the norm sums its squares in another order than torch), carried
    through RoPE within :func:`rope_bound`. Every kernel must launch.
    Returns the share of values apart, per kernel and shape."""
    before = dict(gl.LAUNCHES)
    shares = {}
    for name, spec in GLUE.items():
        x = glue_inputs(g, layers, spec)
        err, apart = 0.0, 0.0
        for delta in (x["delta"], None):   # None: layer 0's ln1
            h2, y = gl.add_rms_norm(x["h"], delta, x["w"], GLUE_EPS)
            wh, wy = gl.add_rms_norm_plain(x["h"], delta, x["w"], GLUE_EPS)
            torch.cuda.synchronize()
            ulps = bf16_ulps(y, wy)
            check(torch.equal(h2, wh), f"add_rms_norm {name}: the residual "
                  f"sum differs from h + delta")
            check(int(ulps.max()) <= 1, f"add_rms_norm {name}: the norm "
                  f"{int(ulps.max())} bf16 ulps from the plain version's")
            err = max(err, (y.float() - wy.float()).abs().max().item())
            apart = max(apart, (ulps > 0).float().mean().item())
        errs[f"add_rms_norm_{name}"] = err
        shares[f"add_rms_norm_{name}"] = apart

        pools = [p.clone() for p in x["pools"]]
        want = [p.clone() for p in x["pools"]]
        lens = torch.full((GLUE_B,), -1, dtype=torch.int32, device="cuda")
        want_lens = lens.clone()
        q = gl.attn_prologue(*prologue_args(gl, x, pools, lens))
        wq = gl.attn_prologue_plain(*prologue_args(gl, x, want, want_lens))
        torch.cuda.synchronize()
        # without a writer the frozen lanes race on the scratch block 0,
        # on either side: its slots are left out
        rows = slice(None) if spec["writer"] else slice(1, None)
        check(torch.equal(lens, want_lens),
              f"attn_prologue {name}: attended lengths differ")
        check(torch.equal(pools[1][rows], want[1][rows]),
              f"attn_prologue {name}: the V write differs")
        err, apart = 0.0, 0.0
        for what, got, ref in (("q", q, wq),
                               ("K", pools[0][rows], want[0][rows])):
            diff = (got.float() - ref.float()).abs()
            if spec["qk_norm"]:
                check(bool((diff <= rope_bound(ref)).all()),
                      f"attn_prologue {name}: {what} beyond one ulp of the "
                      f"norm carried through RoPE")
            else:
                check(torch.equal(got, ref), f"attn_prologue {name}: {what}"
                      f" differs (no qk-norm: bit for bit)")
            err = max(err, diff.max().item())
            apart = max(apart, (diff > 0).float().mean().item())
        errs[f"attn_prologue_{name}"] = err
        shares[f"attn_prologue_{name}"] = apart

        act = gl.silu_mul(x["gate"], x["up"])
        check(torch.equal(act, gl.silu_mul_plain(x["gate"], x["up"])),
              f"silu_mul {name}: differs from silu(g) * u")
        errs[f"silu_mul_{name}"] = 0.0
    moved = {k: gl.LAUNCHES[k] - before[k] for k in before}
    check(moved == {"add_rms_norm": 4, "attn_prologue": 2, "silu_mul": 2},
          f"kernels: glue launches {moved}")
    return shares


def phase_kernels(pa, ss, fa, sd, kvq, smd, gl, layers):
    g = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    before = dict(pa.LAUNCHES)
    # qwen3-4b-thinking (H 32, KVH 8, hd 128): K1a over B = 64 ragged
    # lengths incl. empty, one slot, mid-page and a full 512-slot window;
    # K1b at C in {16, 64} over ragged prefixes, with padding
    lens = [0, 1, 7, 512, 200, 33] + [(37 * i) % 513 for i in range(58)]
    check_paged(pa, kvq, g, errs, 64, 32, 8, 128, 32, lens,
                [(16, 37, 11), (64, 200, 64), (16, 0, 16), (64, 448, 50)],
                [(16, 64, 16), (64, 200, 50)])
    # zamba2's shared attention (H = KVH = 32, hd 80) over the serve
    # phase's 16 lanes, and granite-20b's 48 query heads over one kv head
    # (hd 128) over the dense_archs phase's 8 lanes
    lens16 = [0, 1] + [15 + (128 * i) // 13 for i in range(14)]
    check_paged(pa, kvq, g, errs, 16, 32, 32, 80, 32, lens16,
                [(16, 64, 16), (64, 200, 50)], [(16, 64, 16)], "_hd80")
    lens8 = [0] + [15 + (32 * i) // 6 for i in range(7)]
    check_paged(pa, kvq, g, errs, 8, 48, 1, 128, 32, lens8, [], [], "_g48")
    # a rank of serve_mesh's (1, 2) mesh at full width: qwen3's 16 of 32
    # query heads over 4 of its 8 kv heads, the serve's 16 lanes, chunks
    # of 8
    check_paged(pa, kvq, g, errs, 16, 16, 4, 128, 32, lens16,
                [(8, 0, 8), (8, 8, 7)], [], "_mesh")
    # the other dense archs' head groups (hd 128) over the same 8 lanes:
    # qwen3-1.7b 16 over 8 (G = 2), phi4-mini 24 over 8 (G = 3, a partly
    # filled group of rows), starcoder2 24 over 2 (G = 12)
    for H, KVH in ((16, 8), (24, 8), (24, 2)):
        check_paged(pa, kvq, g, errs, 8, H, KVH, 128, 32, lens8, [], [],
                    f"_h{H}kv{KVH}")
    # mixtral-8x7b's decode at batched_mixtral's shape: 4 lanes of
    # 4201-4216 slots over 288-page rows (capacity 4608), where the
    # decode cuts each lane's pages into 9 parts and merges them (the
    # other checks' 32-page rows run one part); then its chunked prefill
    # under its window (K1b, K1c)
    check(pa.split_count(MIXTRAL_BP, 4 * 8) > 1
          and pa.decode_plan(MIXTRAL_BP, 4 * 8, 16)["cluster"] > 1,
          "K1a mixtral: the decode check runs no split or cluster")
    check_paged(pa, kvq, g, errs, 4, 32, 8, 128, MIXTRAL_BP,
                list(MIXTRAL_LENS), [], [], "_mixtral")
    check_prefill_window(pa, kvq, g, errs)
    # seamless-m4t's decoder (16 query heads over 16, hd 64) at
    # decode_seamless's shape: 8 lanes of 65-128 slots over 8-page rows
    check_paged(pa, kvq, g, errs, SEAMLESS_B, 16, 16, 64,
                SEAMLESS_CAPACITY // 16, SEAMLESS_LENS, [], [], "_seamless")
    # the serving launcher's model (serving_config: H 4, KVH 2, hd 64) at
    # launch_serve's shapes: 16 lanes over 16-page rows (capacity 256),
    # chunks of 8
    lens_launch = [0, 1] + [20 + (236 * i) // 13 for i in range(14)]
    check_paged(pa, kvq, g, errs, 16, 4, 2, 64, 16, lens_launch,
                [(8, 8, 8), (8, 40, 3)], [(8, 8, 8), (8, 40, 3)],
                "_launch")
    # K3: B = 1, H = 32, S = 2048 at qwen3's hd 128 and zamba2's hd 80;
    # then forward_mixtral's S = 8192 under the 4096 window, and
    # forward_seamless's decoder (16 heads, hd 64, S = 512)
    flash_before = dict(fa.LAUNCHES)
    check_flash(fa, g, errs, 32, 128)
    check_flash(fa, g, errs, 32, 80, "_hd80")
    check_flash_window(fa, g, errs)
    check_flash(fa, g, errs, 16, 64, "_seamless", S=SEAMLESS_S)
    # hd 32 (no arch of the zoo; the mma.sync face)
    check_flash(fa, g, errs, 8, 32, "_hd32", S=512)
    # K2: B = 64, D = 2560 (qwen3-4b, mamba2, zamba2), hidden in bf16 and
    # f32; then the dense archs' widths over the dense_archs phase's 8
    # lanes: D = 2048 (qwen3-1.7b, internvl2-2b), 3072 (phi4-mini,
    # starcoder2) and 6144 (granite-20b); and mixtral-8x7b's D = 4096 over
    # the serve's 16 lanes; the serving launcher's D = 256 at 16 lanes
    for B, D in ((64, 2560), (8, 2048), (8, 3072), (8, 6144), (16, 4096),
                 (16, 256)):
        w1 = torch.randn(D, 512, generator=g, device="cuda") * (2.0 / D) ** .5
        b1 = torch.randn(512, generator=g, device="cuda") * 0.1
        w2 = torch.randn(512, 1, generator=g, device="cuda") * 512 ** -0.5
        b2 = torch.randn(1, generator=g, device="cuda") * 0.1
        tag = "" if D == 2560 else f"_d{D}"
        for dtype in (torch.bfloat16, torch.float32):
            h = torch.randn(B, D, generator=g, device="cuda").to(dtype)
            got = ss.step_score(h, w1, b1, w2, b2)
            want = ss.step_score_plain(h, w1, b1, w2, b2)
            torch.cuda.synchronize()
            errs[f"score{tag}_{str(dtype)[6:]}"] = compare(
                f"K2 B={B} D={D} {dtype}", got, want, SCORE_TOL)
            check(torch.equal(got, ss.step_score(h, w1, b1, w2, b2)),
                  f"K2 B={B} D={D} {dtype}: two calls differ")
    # K4: mamba2's full-width scan (N = 128), the same with the init's
    # decay rates and large steps, and S = 1000 padded to 1024; zamba2's
    # (N = 64) the same three
    check_ssd(sd, g, errs, 128, ((2048, False), (2048, True), (1000, True)),
              "ssd_scan")
    check_ssd(sd, g, errs, 64, ((2048, False), (2048, True), (1000, True)),
              "ssd_scan_zamba2")
    check_ssm_decode(smd, g, errs)
    check_ssm_decode(smd, g, errs, N=64, key="ssm_decode_zamba2")
    glue = check_glue(gl, layers, g, errs)
    # the prefill face's three kernels each ran: wgmma (bf16 queries at hd
    # 64/128), mma.sync (hd 80), f32; over float and int8/fp8 pools
    prefill = {k: pa.LAUNCHES[k] - before[k]
               for k in ("prefill_wgmma", "prefill_quant_wgmma", "prefill",
                         "prefill_quant")}
    check(all(n > 0 for n in prefill.values()),
          f"kernels: a prefill kernel never ran: {prefill}")
    # K3's three faces each ran: wgmma (bf16 at hd 64/80/128), the mma.sync
    # tile (bf16 at hd 32), 3xTF32 (f32)
    flash = {k: fa.LAUNCHES[k] - flash_before[k]
             for k in ("flash_wgmma", "flash_tile", "flash_f32_tc")}
    check(all(n > 0 for n in flash.values()),
          f"kernels: a flash face never ran: {flash}")
    # the decode face's two kernels each ran over float and int8/fp8 pools:
    # the cluster face (bf16 queries), decode_kernel (f32 queries)
    decode = {k: pa.LAUNCHES[k] - before[k]
              for k in ("decode_cluster", "decode_quant_cluster", "decode",
                        "decode_quant")}
    check(all(n > 0 for n in decode.values()),
          f"kernels: a decode kernel never ran: {decode}")
    emit("kernels", max_abs_err=errs, decode_launches=decode,
         prefill_launches=prefill, flash_launches=flash,
         glue_share_apart=glue,
         tolerances={"bf16": BF16_TOL, "f32": F32_TOL, "score": SCORE_TOL,
                     "ssd": SSD_TOL})
    return errs


def full_model(rt, arch="qwen3-4b-thinking", layers=None):
    """``arch`` at full width (``layers`` cuts its depth), random seeded
    weights and scorer: (cfg, params, scorer, params' count, init s)."""
    cfg = rt["registry"].get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
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


def tick_counting(E):
    """An ``Engine`` that counts its decode ticks (one ``decode_fn``
    lookup each: these phases inject no fault, so nothing retries) and
    the decode iterations they run."""
    class Engine(E.Engine):
        ticks = 0
        iterations = 0   # decode iterations: each tick's horizon

        def decode_fn(self, horizon, lanewise=False):
            self.ticks += 1
            self.iterations += horizon
            return super().decode_fn(horizon, lanewise)
    return Engine


def timed_run(ops, engine, run):
    """``run(engine)`` -> its results, with the counts zeroed just before
    and read just after, wall time, ticks and peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ticks, iters = engine.ticks, engine.iterations
    t0 = time.perf_counter()
    results = run(engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(r.total_tokens for r in results)
    return {"results": results, "wall_s": wall, "ticks": engine.ticks - ticks,
            "iterations": engine.iterations - iters,
            "launches": ops.launch_counts(),
            "decode_s": sum(r.decode_s for r in results),
            "total_tokens": tokens, "tokens_per_s": tokens / wall,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def graph_device_ms(engine, reps=10):
    """Device ms of one decode iteration: the engine's full-horizon graph
    replayed with every lane's limit at 0 (its KV writes land in the
    scratch block), CUDA events around ``reps`` replays, over the
    horizon. Diagnostic replays: they count no launch."""
    K = engine.ecfg.decode_horizon
    runner = next(f for (k, _), f in engine._decode_fns.items() if k == K)
    runner.inputs[2].zero_()
    runner.graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        runner.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps / K


def same_serves(name, want, got, score_tol):
    """Identical tokens, statuses, prunes and pruned traces; step scores
    within ``score_tol``. Returns the comparison's fields."""
    err = 0.0
    for w, r in zip(want, got):
        check([t.output_tokens for t in w.traces]
              == [t.output_tokens for t in r.traces],
              f"{name}: graphed tokens differ from eager")
        check([t.status for t in w.traces] == [t.status for t in r.traces],
              f"{name}: graphed statuses differ from eager")
        check(w.num_pruned == r.num_pruned and w.status == r.status,
              f"{name}: graphed prunes differ from eager")
        for tw, tr in zip(w.traces, r.traces):
            check(len(tw.step_scores) == len(tr.step_scores),
                  f"{name}: step score counts differ")
            err = max([err] + [abs(a - b) for a, b in
                               zip(tw.step_scores, tr.step_scores)])
    check(err <= score_tol, f"{name}: graphed vs eager step scores differ "
          f"by {err} > {score_tol}")
    return {"tokens_identical": True, "scores_bitwise": err == 0.0,
            "max_step_score_err": err}


def graphed_vs_eager(ops, make_engine, run, name, calls=3, fresh=False,
                     score_tol=SCORE_TOL["atol"]):
    """``run`` once on an engine with the eager horizon and ``calls`` times
    on graphed engines (one engine for all calls, or a ``fresh`` one each
    call). Checks that each graphed tick was one replay, that the first
    graphed call launched each kernel as often as the eager run, and that
    both gave the same serves. Returns (the first graphed run, the
    report for the phase's line). An engine refers to itself through its
    steps' closures, so each one is collected before the next run: its
    pool would otherwise count in the next run's peak."""
    def collect():
        gc.collect()
        torch.cuda.empty_cache()

    eager = timed_run(ops, make_engine(True), run)
    collect()
    graphed, capture_s, eng = [], 0.0, None
    for i in range(calls):
        if eng is None or fresh:
            if eng is not None:
                capture_s += sum(f.capture_s for f in eng._decode_fns.values())
                eng = None
                collect()
            eng = make_engine(False)
        graphed.append(timed_run(ops, eng, run))
    capture_s += sum(f.capture_s for f in eng._decode_fns.values())
    device_ms = graph_device_ms(eng)
    eng = None
    collect()
    first = graphed[0]
    kernels = [k for k in eager["launches"] if not k.startswith("decode_")]
    for g in graphed:
        check(g["launches"]["decode_graph_replays"] == g["ticks"] > 0,
              f"{name}: {g['ticks']} ticks but "
              f"{g['launches']['decode_graph_replays']} graph replays")
    check(eager["launches"]["decode_graph_replays"] == 0
          and eager["launches"]["decode_graph_captures"] == 0,
          f"{name}: the eager engine replayed a graph")
    check({k: first["launches"][k] for k in kernels}
          == {k: eager["launches"][k] for k in kernels},
          f"{name}: graphed kernel launches differ from eager")
    report = same_serves(name, eager["results"], first["results"], score_tol)
    for g in graphed[1:]:
        check([t.output_tokens for r in g["results"] for t in r.traces]
              == [t.output_tokens for r in first["results"]
                  for t in r.traces], f"{name}: graphed calls differ")
    iters = max(eager["iterations"], 1)
    best = min(g["wall_s"] for g in graphed)
    report.update({
        "eager": {k: eager[k] for k in ("wall_s", "decode_s", "ticks",
                                        "tokens_per_s",
                                        "max_memory_allocated")},
        "graphed": {k: [g[k] for g in graphed]
                    for k in ("wall_s", "decode_s", "ticks", "tokens_per_s",
                              "max_memory_allocated")},
        "decode_iterations": iters,
        "replays": [g["launches"]["decode_graph_replays"] for g in graphed],
        "captures": [g["launches"]["decode_graph_captures"]
                     for g in graphed],
        "capture_s": capture_s,
        "eager_wall_ms_per_iteration": eager["wall_s"] / iters * 1e3,
        "graphed_wall_ms_per_iteration": [g["wall_s"] / iters * 1e3
                                          for g in graphed],
        "host_ms_per_iteration": (eager["wall_s"] - best) / iters * 1e3,
        "device_ms_per_iteration": device_ms})
    return first, report


def phase_serve(rt, ops, cfg, params, scorer, kv_dtype="bf16", chunk=None,
                name=None):
    """The STEP serve at full width over a ``kv_dtype`` pool: phase
    ``serve`` (bf16, one-shot prefill) or ``serve_<kv_dtype>`` (int8/fp8,
    chunked prefill, so both faces of the quantized kernel run), or
    ``name``. An MoE model's line also gives, per layer, the (lane, k)
    pairs and the lanes that the expert capacity drops at the first decode
    iteration of the eager run. An MLA model (deepseek-v2) takes no
    kernel, as in the JAX engine: "auto" resolves dense, the scorer is
    the plain one, and the serve must launch neither K1 nor K2."""
    E = rt["engine"]
    if name is None:
        name = "serve" if kv_dtype == "bf16" else f"serve_{kv_dtype}"
    quant = kv_dtype in QUANT
    decode = K1C_DECODE[0] if quant else K1A[0]   # the cluster face
    tok = rt["tokenizer"].get_tokenizer()
    problem = rt["evaluate"].make_problems(1, seed=SEED)[0]
    prompt = tok.encode(rt["arithmetic"].make_prompt(problem), add_bos=True)
    # With the prefix cache on, the pool outlives a serve, the scratch
    # block that frozen lanes read included: an MoE routes those lanes
    # beside the live ones, so under the capacity a later serve's tokens
    # differ from the first's (ROADMAP C, as in the JAX engine). The
    # serve's 15-token prompt fills no block to cache, so an MoE model's
    # calls run with the cache off, each from a zeroed pool.
    ecfg = E.EngineConfig(max_batch=16, num_blocks=80, capacity=512,
                          max_new_tokens=128, sampling=greedy(rt, 128),
                          use_kernel="auto", decode_horizon=4,
                          prefill_chunk_size=chunk,
                          prefix_cache=not cfg.uses_moe, faults=None,
                          kv_dtype=kv_dtype)

    drops = None
    if cfg.uses_moe:   # the prefill's tokens must not pass for 16 lanes
        check(len(prompt) != 16, f"{name}: a 16-token prompt")
        drops, restore = record_moe_drops(rt["layers"], 16, cfg.num_layers)

    def make_engine(eager):
        engine = tick_counting(E)(params, cfg, ecfg,
                                  rt["pruning"].make_policy("step"),
                                  scorer_params=scorer, _eager_decode=eager)
        check(engine.use_kernel == engine.fused_scorer == (not cfg.use_mla),
              f"{name}: engine not on the kernel path, or MLA on it")
        return engine

    def run(engine):
        res = engine.serve(prompt, 16)
        check_result(res, engine)
        return [res]

    try:
        first, report = graphed_vs_eager(ops, make_engine, run, name)
    finally:
        if drops is not None:
            restore()
    res, launches = first["results"][0], first["launches"]
    iters = first["iterations"]
    if cfg.use_mla:
        check(all(n == 0 for k, n in launches.items()
                  if not k.startswith("decode_graph")),
              f"{name}: a kernel launched on the MLA path: {launches}")
    else:
        check_decode_launches(name, cfg, launches, iters, quant)
        check(launches["step_score"] == iters,
              "K2 did not launch once per decode iteration")
    if quant:
        check(launches["paged_attention_prefill_quant_wgmma"] > 0
              and launches["paged_attention_prefill_quant"] == 0,
              "K1c's prefill face did not run its wgmma kernel")
        check(launches[K1A[0]] == 0 and k1b_launches(launches) == 0,
              "a float-pool kernel ran on a quantized pool")
    check(res.num_pruned > 0, "STEP pruned nothing under pressure")
    check(res.num_preemptions == 0 and res.wait_s == 0.0,
          "STEP made a trace wait")
    out = {"kv_dtype": kv_dtype, "prefill_chunk_size": chunk,
           "prompt_tokens": len(prompt), "traces": 16,
           "num_pruned": res.num_pruned, "total_tokens": res.total_tokens,
           "wall_s": first["wall_s"], "decode_s": res.decode_s,
           "prefill_s": res.prefill_s,
           "tokens_per_s": res.total_tokens / first["wall_s"],
           "decode_iterations": iters,
           "launches": launches,
           "decode_launches_per_iteration": launches[decode] / max(iters, 1),
           "graph_replays_per_iteration":
               launches["decode_graph_replays"] / max(iters, 1),
           "kv_block_bytes": E.kv_quant.pool_block_bytes(cfg, kv_dtype),
           "max_memory_allocated": first["max_memory_allocated"],
           "pool_drained": True, "graph": report}
    if drops is not None:
        check(len(drops) == cfg.num_layers,
              f"{name}: recorded {len(drops)} MoE layers of the first "
              f"decode iteration")
        out["first_iteration_moe_drops"] = {
            "capacity": int(drops[0][1]),
            "pairs_dropped_per_layer": [int((~k).sum()) for k, _ in drops],
            "lanes_without_moe_output_per_layer":
                [int((~k).all(dim=-1).sum()) for k, _ in drops]}
    emit(name, **out)
    return out


def record_moe_drops(L, lanes, layers):
    """Wrap ``layers._moe_groups`` so that its first ``layers`` calls over
    ``lanes`` tokens (the first decode iteration of the first engine that
    runs) keep (which (lane, k) pairs the capacity keeps [lanes, K], the
    capacity), with no host sync and nothing recorded inside a capture.
    Returns (the records, a function that undoes the wrap)."""
    records, inner = [], L._moe_groups

    def recording(pe, xg, sel, w, E, capacity, **kw):
        if (len(records) < layers and sel.shape[0] * sel.shape[1] == lanes
                and not torch.cuda.is_current_stream_capturing()):
            keep = L.moe_queue(sel, E, capacity)[2]
            records.append((keep.reshape(lanes, -1), capacity))
        return inner(pe, xg, sel, w, E, capacity, **kw)

    L._moe_groups = recording
    return records, lambda: setattr(L, "_moe_groups", inner)


def phase_serve_sampled(rt, ops, cfg, params, scorer):
    """Sampled STEP serves at full width, graphed against eager from one
    generator seed: 8 traces at temperature 0.8 (top-k 20, top-p 0.95)
    through the scalar sampler; then the same request beside one at
    temperature 0.6 (top-k 0, top-p 0.9), which takes the lane-wise
    sampler. The capture registers the engine's generator, so each replay
    draws what the eager horizon draws: the tokens must match."""
    E = rt["engine"]
    Sp = rt["sampling"].SamplingParams
    hot = Sp(temperature=0.8, top_k=20, top_p=0.95, max_new_tokens=64)
    warm = Sp(temperature=0.6, top_k=0, top_p=0.9, max_new_tokens=64)
    tok = rt["tokenizer"].get_tokenizer()
    probs = rt["evaluate"].make_problems(2, seed=SEED + 7)
    prompts = [tok.encode(rt["arithmetic"].make_prompt(p), add_bos=True)
               for p in probs]
    out = {}
    for sampler, reqs in (("scalar", [(0, None)]),
                          ("lanewise", [(0, None), (1, warm)])):
        ecfg = E.EngineConfig(max_batch=16, num_blocks=80, capacity=512,
                              max_new_tokens=64, sampling=hot,
                              use_kernel="auto", decode_horizon=4,
                              prefix_cache=True, faults=None,
                              kv_dtype="bf16", seed=SEED + 7)

        def make_engine(eager, ecfg=ecfg):
            return tick_counting(E)(params, cfg, ecfg,
                                    rt["pruning"].make_policy("step"),
                                    scorer_params=scorer,
                                    _eager_decode=eager)

        def run(engine, reqs=reqs, sampler=sampler):
            results = engine.serve_batch([
                E.Request(request_id=i, prompt_tokens=prompts[p],
                          n_traces=8, sampling=sp,
                          policy=rt["pruning"].make_policy("step"))
                for i, (p, sp) in enumerate(reqs)])
            for res in results:
                check_result(res, engine)
            check({lw for _, lw in engine._decode_fns}
                  == {sampler == "lanewise"}, f"{sampler}: other sampler")
            return results

        first, report = graphed_vs_eager(ops, make_engine, run,
                                         f"serve_sampled {sampler}",
                                         calls=1, fresh=True)
        out[sampler] = {"total_tokens": first["total_tokens"],
                        "num_pruned": [r.num_pruned
                                       for r in first["results"]],
                        "launches": first["launches"], "graph": report}
    emit("serve_sampled", **out)
    return out


def no_eos(params, cfg, eos_id):
    """Zero the output projection's EOS row, in place: EOS's logit is then
    0, below the largest logit of the other tokens (random weights), so a
    greedy trace never ends before its token budget."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"].T
    w[eos_id] = 0
    return params


def phase_smoke_reference(rt, kv_dtype="f32", chunk=None,
                          arch="qwen3-4b-thinking", window=None,
                          prompt="3+5-2="):
    """Kernel engine vs dense engine on a small input: ``arch``'s smoke
    config (its sliding window replaced by ``window``), f32 params with
    EOS suppressed (:func:`no_eos`: every trace decodes its 40 tokens, so
    8 traces fill the 16-block pool and STEP prunes), greedy STEP over a
    ``kv_dtype`` pool — identical tokens, statuses and prunes, step
    scores within 1e-5 (both paths dequantize an int8/fp8 pool to the
    same f32 values; mamba2 has no pool)."""
    E = rt["engine"]
    cfg = rt["registry"].serving_config(arch)
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    tok = rt["tokenizer"].get_tokenizer()
    params = no_eos(to_f32(rt["init"].init_params(cfg, g)), cfg, tok.eos_id)
    scorer = rt["scorer"].init_scorer(g, cfg.d_model)
    prompt = tok.encode(prompt, add_bos=True)
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
        ops = rt["ops"]
        ops.reset_launch_counts()
        res = engine.serve(prompt, 8)
        check_result(res, engine)
        outs[use_kernel] = res
        if use_kernel:
            launches = ops.launch_counts()
    k, d = outs[True], outs[False]
    check([t.output_tokens for t in k.traces]
          == [t.output_tokens for t in d.traces], "kernel != dense tokens")
    check([t.status for t in k.traces] == [t.status for t in d.traces],
          "kernel != dense statuses")
    check(k.num_pruned == d.num_pruned, "kernel != dense prunes")
    check(k.num_pruned > 0, "no pruning in the reference scenario")
    err = max((abs(a - b) for tk, td in zip(k.traces, d.traces)
               for a, b in zip(tk.step_scores, td.step_scores)), default=0.0)
    check(err <= 1e-5, f"kernel vs dense step scores differ by {err}")
    name = "reference" if kv_dtype == "f32" else f"reference_{kv_dtype}"
    if arch != "qwen3-4b-thinking":
        name = f"reference_{arch.split('-')[0]}"
    emit(name, config=cfg.name, kv_dtype=kv_dtype, prefill_chunk_size=chunk,
         sliding_window=cfg.sliding_window, prompt_tokens=len(prompt),
         launches=launches, tokens_identical=True, num_pruned=k.num_pruned,
         tokens_compared=sum(len(t.output_tokens) for t in k.traces),
         step_scores=sum(len(t.step_scores) for t in k.traces),
         max_step_score_err=err)


def recurrent_traffic(rt, **over):
    """The recurrent serve phases' prompt and engine config (fields in
    ``over`` replaced)."""
    E = rt["engine"]
    tok = rt["tokenizer"].get_tokenizer()
    problem = rt["evaluate"].make_problems(1, seed=SEED)[0]
    prompt = tok.encode(rt["arithmetic"].make_prompt(problem), add_bos=True)
    fields = dict(max_batch=16, num_blocks=80, capacity=512,
                  max_new_tokens=128, sampling=greedy(rt, 128),
                  use_kernel="auto", decode_horizon=4, prefix_cache=True,
                  faults=None, kv_dtype="bf16")
    fields.update(over)
    return prompt, E.EngineConfig(**fields)


def phase_serve_recurrent(rt, ops, cfg, params, scorer, name):
    """STEP serving of mamba2-2.7b (``serve_mamba2``) or zamba2-2.7b
    (``serve_zamba2``) at full width: 16 traces of one prompt, greedy,
    128 new tokens, 80 blocks, horizon 4, kernels on. The device state is
    the per-slot recurrent state (``ssm_state`` f32 and ``conv_state``
    bf16 for 16 slots). mamba2 has no KV pool: the blocks are the
    engine's accounting of each trace's tokens. zamba2 also pages the K/V
    of its 9 shared-attention invocations (hd 80): K1a runs once per
    invocation and iteration. Every iteration runs ``ssm_decode`` once
    per Mamba2 layer and the fused scorer (K2) once; the one-shot prefill
    is dense, as in the JAX package, so K3 and K4 are not on the path."""
    hybrid = cfg.arch_type == "hybrid"
    E = rt["engine"]
    prompt, ecfg = recurrent_traffic(rt)

    def make_engine(eager):
        engine = tick_counting(E)(params, cfg, ecfg,
                                  rt["pruning"].make_policy("step"),
                                  scorer_params=scorer, _eager_decode=eager)
        check(engine.use_kernel and engine.fused_scorer,
              "engine not on the kernel path")
        check((engine.kv_block_bytes > 0) == hybrid
              and engine.prefix_cache is None,
              "a recurrent stack shares no prefix, and only the hybrid "
              "pages K/V")
        return engine

    def run(engine):
        res = engine.serve(prompt, 16)
        check_result(res, engine)
        return [res]

    first, report = graphed_vs_eager(ops, make_engine, run, name)
    res, launches, wall = (first["results"][0], first["launches"],
                           first["wall_s"])
    iters = launches["step_score"]   # one fused scorer launch per iteration
    check(iters > 0, "K2 never launched")
    check(launches["ssm_decode"] == iters * cfg.num_layers,
          "ssm_decode did not run once per layer and iteration")
    n_attn = len(cfg.attention_layer_ids())
    check(launches[K1A[0]] == iters * n_attn
          and launches["paged_attention_decode"] == 0,
          "K1a's cluster face did not run once per shared-attention "
          "invocation and iteration, or decode_kernel ran")
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
           "decode_iterations": iters,
           "launches": launches,
           "launches_per_iteration": {
               k: launches[k] / iters for k in
               (K1A[0], "ssm_decode", "step_score")},
           "recurrent_state_bytes": state,
           "kv_block_bytes": E.kv_quant.pool_block_bytes(cfg, "bf16"),
           "max_memory_allocated": first["max_memory_allocated"],
           "pool_drained": True, "graph": report}
    emit(name, **out)
    return out


def phase_kernel_vs_dense(rt, ops, cfg, params, scorer, name):
    """``serve_zamba2``'s traffic at full width through the kernel engine
    and the dense engine, both with eager horizons, in f32 (the params
    cast up, EOS suppressed by :func:`no_eos` so that every trace decodes
    until STEP prunes it or its budget ends, an f32 pool) and in bf16
    (the weights and pool ``serve_zamba2`` ran).

    The decode path is not f32 throughout even with f32 params: the conv
    state is bf16 (as in the JAX package), so each step rounds the last
    three conv inputs of every Mamba2 layer to bf16, and a difference of
    one f32 ulp between the paths can flip a rounding. Greedy serves of
    random weights then part at near ties. So the serves are held to the
    same statuses and prunes, and where they part the line gives the
    first output token at which they do and the two largest logits there
    of the dense and the kernel forward over the common prefix. The
    paths' tokens are compared with the forward teacher-forced: each
    path decodes the kernel serve's first trace from an empty cache (one
    lane), and its logits (EOS's left out) are held against the f32
    forward of the same tokens; the kernel path must be no farther from
    it than twice the dense path's distance."""
    E = rt["engine"]
    M = rt["model"]
    V = cfg.vocab_size
    eos = rt["tokenizer"].get_tokenizer().eos_id
    keep = torch.ones(V, dtype=torch.bool, device="cuda")
    keep[eos] = False

    def serve(p, use_kernel, kv_dtype):
        prompt, ecfg = recurrent_traffic(rt, use_kernel=use_kernel,
                                         kv_dtype=kv_dtype)
        engine = E.Engine(p, cfg, ecfg, rt["pruning"].make_policy("step"),
                          scorer_params=scorer, _eager_decode=True)
        check(engine.use_kernel == use_kernel, f"{name}: engine path")
        ops.reset_launch_counts()
        res = engine.serve(prompt, 16)
        launches = ops.launch_counts()
        check_result(res, engine)
        check((launches["ssm_decode"] > 0) == use_kernel
              and (k1a_launches(launches) > 0) == use_kernel,
              f"{name}: kernel launches do not follow use_kernel")
        del engine
        gc.collect()
        return prompt, res

    def forward(p, seq, use_kernel=False):
        with torch.no_grad():
            lg = M.forward_full(p, cfg, torch.tensor(
                [seq], device="cuda", dtype=torch.int32),
                use_kernel=use_kernel)["logits"]
        return lg[0, :, :V].float()

    def forced(p, seq, use_kernel, kv_dtype):
        """Logits [T, V] of one lane decoding ``seq`` from an empty cache."""
        cache = M.init_decode_cache(cfg, 1, 512, kv_dtype=kv_dtype,
                                    device="cuda")
        out = []
        with torch.no_grad():
            for t, tok in enumerate(seq):
                r = M.decode_step(
                    p, cfg, torch.tensor([[tok]], device="cuda",
                                         dtype=torch.int32),
                    torch.tensor([t], device="cuda", dtype=torch.int32),
                    cache, window_len=512, use_kernel=use_kernel)
                out.append(r["logits"][0, :V].float())
        return torch.stack(out)

    def compare(p, kv_dtype, prompt, k, d, ref):
        """The two serves, and the teacher-forced decodes against ``ref``
        (the f32 forward's logits of the kernel serve's first trace)."""
        tk = [t.output_tokens for t in k.traces]
        td = [t.output_tokens for t in d.traces]
        out = {"tokens_identical": tk == td,
               "statuses_identical": [t.status for t in k.traces]
               == [t.status for t in d.traces],
               "total_tokens": [k.total_tokens, d.total_tokens],
               "num_pruned": [k.num_pruned, d.num_pruned],
               "step_scores": sum(len(t.step_scores) for t in k.traces),
               "max_step_score_err": max(
                   (abs(a - b) for a_, b_ in zip(k.traces, d.traces)
                    for a, b in zip(a_.step_scores, b_.step_scores)),
                   default=0.0)}
        parts = [(j, i) for i, (a, b) in enumerate(zip(tk, td))
                 for j in range(min(len(a), len(b))) if a[j] != b[j]]
        out["traces_parted"] = len({i for _, i in parts})
        if parts:
            j, i = min(parts)
            seq = prompt + tk[i][:j]
            top = {}
            for use_kernel in (False, True):
                t = forward(p, seq, use_kernel)[-1].topk(2)
                top["kernel" if use_kernel else "dense"] = [
                    t.indices.tolist(), t.values.tolist()]
            out.update({"first_parting": {"trace": i, "output_index": j},
                        "kernel_token": tk[i][j], "dense_token": td[i][j],
                        "forward_top2": top})
        seq = prompt + tk[0]
        dec = {uk: forced(p, seq, uk, kv_dtype)[:, keep]
               for uk in (True, False)}
        err = {uk: (dec[uk] - ref).abs().max(dim=1).values
               for uk in (True, False)}
        out["forced"] = {
            "tokens": len(seq),
            "kernel_err_vs_f32_forward": err[True].max().item(),
            "dense_err_vs_f32_forward": err[False].max().item(),
            "kernel_vs_dense_err": (dec[True] - dec[False]).abs().max()
            .item(),
            "dense_err_by_step": [round(x, 6) for x in
                                  err[False][::8].tolist()],
            "argmax_agreement": (dec[True].argmax(-1) == dec[False]
                                 .argmax(-1)).float().mean().item()}
        return out

    p32 = no_eos(to_f32(params), cfg, eos)
    prompt, k32 = serve(p32, True, "f32")
    _, d32 = serve(p32, False, "f32")
    ref = forward(p32, prompt + k32.traces[0].output_tokens)[:, keep]
    f32 = compare(p32, "f32", prompt, k32, d32, ref)
    _, kb = serve(params, True, "bf16")
    _, db = serve(params, False, "bf16")
    ref = forward(p32, prompt + kb.traces[0].output_tokens)[:, keep]
    bf16 = compare(params, "bf16", prompt, kb, db, ref)
    del p32, ref
    gc.collect()
    torch.cuda.empty_cache()
    emit(name, traffic="1 request x 16 traces, greedy, 128 new tokens, "
         "80 blocks, horizon 4, eager", f32=f32, bf16=bf16)
    for dt, r in (("f32", f32), ("bf16", bf16)):
        check(r["statuses_identical"] and r["num_pruned"][0]
              == r["num_pruned"][1] > 0,
              f"{name}: {dt} kernel and dense statuses or prunes differ")
        f = r["forced"]
        check(f["kernel_err_vs_f32_forward"]
              <= 2 * f["dense_err_vs_f32_forward"],
              f"{name}: {dt} kernel decode farther from the f32 forward "
              f"({f['kernel_err_vs_f32_forward']}) than twice the dense "
              f"decode ({f['dense_err_vs_f32_forward']})")
    return {"f32": f32, "bf16": bf16}


def phase_forward_recurrent(rt, ops, cfg, params, name):
    """``forward_full(use_kernel=True)`` of mamba2 (``forward_ssd``) or
    zamba2 (``forward_zamba2``) at full width, B = 1, S = 2048 (eight
    chunks of 256), against the dense forward: one K4 launch per Mamba2
    layer, and for zamba2 one K3 launch (hd 80) per shared-attention
    invocation.

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
           "params_dtype": "bf16, and f32 for the f32 fields",
           "f32_logits_max_abs_err": err(got32, dense32),
           "f32_logits_max_abs": amax,
           "f32_argmax_agreement": (got32.argmax(-1) == dense32.argmax(-1))
           .float().mean().item(),
           "bf16_logits_max_abs_err": err(got, dense),
           "bf16_kernel_err_vs_f32": err(got, dense32),
           "bf16_dense_err_vs_f32": err(dense, dense32),
           "argmax_agreement": agree, "wall_s": wall,
           "dense_wall_s": dense_wall}
    emit(name, **out)
    for dt, t in (("bf16", got), ("f32", got32)):
        check(bool(torch.isfinite(t).all()),
              f"K4 forward: non-finite {dt} logits")
    check(launches["ssd_scan"] == cfg.num_layers,
          f"K4 launched {launches['ssd_scan']} times, not once per layer")
    check(launches["ssd_scan_wgmma"] == cfg.num_layers
          and launches["ssd_scan_tile"] == 0,
          f"K4 faces: wgmma {launches['ssd_scan_wgmma']}, tile "
          f"{launches['ssd_scan_tile']}, not one wgmma launch per layer")
    check(launches["flash_attention"] == len(cfg.attention_layer_ids()),
          f"K3 launched {launches['flash_attention']} times, not once per "
          f"attention layer")
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

    def make_engine(eager):
        return tick_counting(E)(params, cfg, ecfg,
                                rt["pruning"].make_policy("step"),
                                scorer_params=scorer, _eager_decode=eager)

    def run(engine):
        # two waves of two concurrent requests on one engine: the second
        # wave's copy of the shared prompt finds the first wave's blocks
        # parked in the prefix cache
        results = []
        for wave in ((0, 1), (2, 3)):
            reqs = [E.Request(request_id=i, prompt_tokens=prompts[i],
                              n_traces=8,
                              policy=rt["pruning"].make_policy("step"))
                    for i in wave]
            results += engine.serve_batch(reqs)
        for res in results:
            check_result(res, engine)
        return results

    first, report = graphed_vs_eager(ops, make_engine, run, "batched",
                                     fresh=True)
    results, launches, wall = (first["results"], first["launches"],
                               first["wall_s"])
    cached = [res.metrics.cached_tokens for res in results]
    check(launches["paged_attention_prefill_wgmma"] > 0
          and launches["paged_attention_prefill"] == 0,
          "K1b did not run its wgmma prefill kernel")
    check_decode_launches("batched", cfg, launches, first["iterations"])
    check(cached[3] > 0, "no prefix-cache hit on the shared prompt")
    total = sum(res.total_tokens for res in results)
    out = {"requests": 4, "traces": 8, "prompt_tokens": [len(p) for p in
                                                         prompts],
           "cached_tokens": cached, "total_tokens": total, "wall_s": wall,
           "tokens_per_s": total / wall, "launches": launches,
           "max_memory_allocated": first["max_memory_allocated"],
           "graph": report}
    emit("batched", **out)
    return out


def long_prompt(rt, n):
    """An ``n``-token prompt: synthetic problems one after another."""
    tok = rt["tokenizer"].get_tokenizer()
    probs = rt["evaluate"].make_problems(n // 8, seed=SEED + 9)
    ids = tok.encode("".join(rt["arithmetic"].make_prompt(p) for p in probs),
                     add_bos=True)
    check(len(ids) >= n, f"long prompt of {len(ids)} < {n} tokens")
    return ids[:n]


def phase_batched_mixtral(rt, ops, cfg, params, scorer):
    """mixtral at full width (16 layers) where its 4096-token window bites:
    1 request x 4 traces of a 4200-token prompt, chunked prefill in chunks
    of 512 (the last chunk's queries 4096-4199 see no key left of their
    window: K1b's window branch), the prefix cache on, capacity 4608,
    greedy, 16 new tokens, kernels on. The graphed engine is held to the
    eager one bit for bit; the eager kernel engine is held against the
    eager dense engine: the same statuses and prunes, and every logit row
    that the two paths compute from the same history (each lane's rows up
    to the first output at which its tokens part; logits recorded at each
    decode iteration of the two eager runs) within ``PATHS_LOGIT_TOL`` of
    the rows' largest magnitude, where that iteration's MoE layers routed
    every lane alike in both paths. The rows of an iteration that routed
    some lane otherwise are counted apart, with the routing flips' dense
    gate margins. Where tokens part, the line gives the first output at
    which they do, with both paths' logits there: the dense path's margin
    between its two best tokens, which must not exceed the paths'
    distance on that row (a near tie). The decode attends the whole
    capacity (ROADMAP C: the decode window is the engine's capacity, as
    in the JAX package)."""
    E = rt["engine"]
    lanes, new = 4, 16
    prompt = long_prompt(rt, 4200)
    ecfg = E.EngineConfig(max_batch=lanes, num_blocks=320,
                          capacity=MIXTRAL_CAPACITY,
                          max_new_tokens=new, sampling=greedy(rt, new),
                          use_kernel="auto", decode_horizon=4,
                          prefill_chunk_size=SWA_CHUNK, prefix_cache=True,
                          faults=None, kv_dtype="bf16")
    rows = {"on": None, "kernel": [], "dense": []}
    routes, restore = route_recorder(rt["layers"])
    recorded = {}
    inner = E.sample_logits

    def recording(rng, logits, **kw):
        if rows["on"] and logits.shape[0] == lanes:   # a decode iteration
            rows[rows["on"]].append(logits.float().clone())
        return inner(rng, logits, **kw)

    def make_engine(eager, use_kernel="auto"):
        rows["on"] = ("kernel" if use_kernel else "dense") if eager else None
        routes["mode"] = "record" if eager else None
        if eager:   # this path's expert choices and gates, call by call
            routes["calls"], routes["gates"] = [], []
            recorded[rows["on"]] = (routes["calls"], routes["gates"])
        engine = tick_counting(E)(
            params, cfg, dataclasses.replace(ecfg, use_kernel=use_kernel),
            rt["pruning"].make_policy("step"), scorer_params=scorer,
            _eager_decode=eager)
        check(engine.use_kernel == bool(use_kernel)
              and engine.prefix_cache is not None
              and engine._chunk_supported, "batched_mixtral: engine path")
        return engine

    def run(engine):
        res = engine.serve(prompt, lanes)
        check_result(res, engine)
        return [res]

    E.sample_logits = recording
    try:
        first, report = graphed_vs_eager(ops, make_engine, run,
                                         "batched_mixtral", calls=1,
                                         fresh=True)
        dense = timed_run(ops, make_engine(True, use_kernel=False), run)
    finally:
        E.sample_logits = inner
        rows["on"] = None
        restore()
    launches = first["launches"]
    check(launches["paged_attention_prefill_wgmma"] > 0
          and launches["paged_attention_prefill"] == 0,
          "K1b did not run its wgmma prefill kernel")
    check_decode_launches("batched_mixtral", cfg, launches,
                          first["iterations"])
    check(k1b_launches(dense["launches"]) == 0,
          "the dense engine launched K1b")
    k, d = first["results"][0], dense["results"][0]
    tk = [t.output_tokens for t in k.traces]
    td = [t.output_tokens for t in d.traces]
    # trace i decodes in lane i; the recorded rows are the 4 first tokens
    # (sampled at once from the prefill's logits) and then one row per
    # decode iteration: output j is row j of lane i
    for name, toks in (("kernel", tk), ("dense", td)):
        for i, t in enumerate(toks):
            got = [int(rows[name][j][i].argmax()) for j in range(len(t))]
            check(got == t, f"batched_mixtral: {name} lane {i}'s recorded "
                  f"logits give {got}, its tokens are {t}")
    # the decode iterations' routings (T = the lanes; the prefill chunks
    # route 512 tokens): iteration j (output j) is calls L(j-1)..Lj-1
    decode = {name: [(c, x) for c, x in zip(*recorded[name])
                     if c.shape[0] == lanes] for name in recorded}
    check(len(decode["kernel"]) == len(decode["dense"])
          == cfg.num_layers * (len(rows["kernel"]) - 1),
          "batched_mixtral: not one routing per layer and decode iteration")
    # iteration j's routings per layer and lane: where they differ, and
    # the dense gate margins; up to the last output (the horizon's later
    # iterations feed only frozen lanes, whose rows nothing reads)
    L_, n = cfg.num_layers, max(len(t) for t in tk + td)
    flips = [torch.stack([route_flips(ck, cd) for (ck, _), (cd, _) in zip(
        decode["kernel"][L_ * (j - 1):L_ * j],
        decode["dense"][L_ * (j - 1):L_ * j])])
        for j in range(1, n)]                                  # [L, lanes]
    margins = [torch.stack([gate_margin(x, cfg.num_experts_per_tok)
                            for _, x in decode["dense"][L_ * (j - 1):L_ * j]])
               for j in range(1, n)]
    # each lane's rows up to its first parting share one history; a row
    # whose decode iteration routed any lane otherwise in the two paths
    # (the lanes share each expert's capacity) differs by an expert's
    # output, not by rounding: it is counted apart
    parted_at = [next((j for j in range(min(len(a), len(b))) if a[j] != b[j]),
                      min(len(a), len(b)) - 1) for a, b in zip(tk, td)]
    same, rerouted = [], []
    for i, p in enumerate(parted_at):
        for j in range(p + 1):
            diff = (rows["kernel"][j][i] - rows["dense"][j][i]).abs().max()
            (rerouted if j and bool(flips[j - 1].any()) else same).append(
                diff.item())
    amax = max(r.abs().max().item() for r in rows["dense"][:n])
    out = {"prompt_tokens": len(prompt), "traces": lanes,
           "chunk": SWA_CHUNK, "window": cfg.sliding_window,
           "capacity": ecfg.capacity,
           "cached_tokens": k.metrics.cached_tokens,
           "total_tokens": [k.total_tokens, d.total_tokens],
           "num_pruned": [k.num_pruned, d.num_pruned],
           "statuses_identical": [t.status for t in k.traces]
           == [t.status for t in d.traces],
           "tokens_identical": tk == td,
           "logits_max_abs": amax,
           "same_history_rows": len(same),
           "same_history_max_abs_diff": max(same),
           "same_history_tol": PATHS_LOGIT_TOL * amax,
           "rerouted_rows": len(rerouted),
           "rerouted_max_abs_diff": max(rerouted, default=0.0),
           "routing_flips_per_iteration": [int(f.sum()) for f in flips],
           "routing_flip_max_margin": max(
               (m[f].max().item() for f, m in zip(flips, margins)
                if f.any()), default=None),
           "wall_s": first["wall_s"], "dense_wall_s": dense["wall_s"],
           "prefill_s": k.prefill_s, "launches": launches,
           "dense_launches": dense["launches"],
           "max_memory_allocated": first["max_memory_allocated"],
           "graph": report}
    parts = [(j, i) for i, (a, b) in enumerate(zip(tk, td))
             for j in range(min(len(a), len(b))) if a[j] != b[j]]
    out["traces_parted"] = len({i for _, i in parts})
    if parts:
        j, i = min(parts)
        lk, ld = rows["kernel"][j][i], rows["dense"][j][i]
        top_d, top_k = ld.topk(2), lk.topk(2)
        before = [(rows["kernel"][c][i] - rows["dense"][c][i]).abs().max()
                  .item() for c in range(j)]
        part = {"trace": i, "output_index": j, "kernel_token": tk[i][j],
                "dense_token": td[i][j],
                "dense_top2": [top_d.indices.tolist(), top_d.values.tolist()],
                "kernel_top2": [top_k.indices.tolist(), top_k.values.tolist()],
                "dense_margin": (top_d.values[0] - top_d.values[1]).item(),
                "paths_max_abs_diff": (lk - ld).abs().max().item(),
                "paths_max_abs_diff_before": max(before, default=0.0)}
        part["near_tie"] = part["dense_margin"] <= part["paths_max_abs_diff"]
        if j > 0:   # the routings of the decode iteration that gave row j
            part["routing_flips"] = int(flips[j - 1].sum())
            part["routing_flips_in_lane"] = int(flips[j - 1][:, i].sum())
        out["first_parting"] = part
    emit("batched_mixtral", **out)
    check(out["statuses_identical"] and k.num_pruned == d.num_pruned,
          "batched_mixtral: kernel and dense statuses or prunes differ")
    check(out["same_history_max_abs_diff"] <= out["same_history_tol"],
          f"batched_mixtral: kernel and dense logits from one history and "
          f"routing lie {out['same_history_max_abs_diff']} apart, beyond "
          f"{out['same_history_tol']}")
    check(not parts or out["first_parting"]["near_tie"],
          "batched_mixtral: kernel and dense tokens part where the dense "
          "margin exceeds the paths' logit distance")
    return out


def route_recorder(L):
    """Wrap ``layers._top_k`` (the MoE router's expert choice). While a
    mode is set, each call's router gates [T, E] are kept in ``gates``;
    in mode "record" its chosen experts [T, K] are kept in ``calls``; in
    mode "replay" the calls of ``replay`` are returned in order, with the
    weights the caller's own gates give them. Returns (state, a function
    that undoes the wrap)."""
    inner = L._top_k
    state = {"mode": None, "calls": [], "replay": [], "gates": []}

    def top_k(x, k):
        if state["mode"] is not None:
            state["gates"].append(x.detach().clone())
        if state["mode"] == "replay":
            idx = state["replay"].pop(0)
            return x.gather(-1, idx), idx
        vals, idx = inner(x, k)
        if state["mode"] == "record":
            state["calls"].append(idx)
        return vals, idx

    L._top_k = top_k
    return state, lambda: setattr(L, "_top_k", inner)


def route_flips(a, b):
    """[T] whether the expert sets of two routings [T, K] differ."""
    return (a.sort(-1).values != b.sort(-1).values).any(-1)


def gate_margin(gates, k):
    """[T] the gap between the k-th and (k+1)-th largest router gates:
    how far a token's routing lies from a tie that would change it."""
    v = gates.sort(-1, descending=True).values
    return v[:, k - 1] - v[:, k]


def phase_forward_mixtral(rt, ops, cfg, params):
    """``forward_full(use_kernel=True)`` of mixtral at full width (16
    layers), B = 1, S = 8192, twice the 4096 window: one windowed K3
    launch per layer, against the dense forward (its chunked
    online-softmax attention under the same window).

    Both paths round every activation to bf16 at other places, and a
    token whose router gates lie within that rounding of a tie takes
    another expert in the other path (and may take or lose a place in an
    expert's capacity of 320 per group of 1024): its logits then differ
    by more than rounding. So the kernel forward is run once more with
    the dense forward's expert choices replayed (its own gate weights):
    with the routing fixed, the hidden states part by rounding alone, and
    the logits are held within 5% of their largest magnitude at every
    position (``forward_kernel``'s tolerance). That replay also measures
    rounding's reach on the router: at each layer, twice the largest
    gate displacement between the replay and the dense forward. A token
    whose first routing flip in the free kernel forward lies at a dense
    gate margin (k-th to (k+1)-th gate) within that layer's reach needs
    no cause but rounding. One beyond it differs from the replay at that
    layer only through attention to tokens that changed experts earlier,
    so each such token must have one within its window that flipped at
    an earlier layer. Later flips of a token follow from its first. The
    free forwards are held to greedy tokens that agree at 80% of the
    positions (random weights leave near ties)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    S, K = FORWARD_MIXTRAL_S, cfg.num_experts_per_tok
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=g,
                           device="cuda", dtype=torch.int32)
    fwd = rt["model"].forward_full
    V = cfg.vocab_size
    routes, restore = route_recorder(rt["layers"])
    try:
        with torch.no_grad():
            routes["mode"] = "record"
            t0 = time.perf_counter()
            dense = fwd(params, cfg, tokens)["logits"][0, :, :V].float()
            torch.cuda.synchronize()
            dense_wall = time.perf_counter() - t0
            dense_routes, routes["calls"] = routes["calls"], []
            dense_gates, routes["gates"] = routes["gates"], []
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = fwd(params, cfg, tokens, use_kernel=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            got = out["logits"][0, :, :V].float()
            kernel_routes, routes["gates"] = routes["calls"], []
            routes.update(mode="replay", replay=list(dense_routes))
            fixed = fwd(params, cfg, tokens, use_kernel=True)["logits"][
                0, :, :V].float()
            fixed_gates = routes["gates"]
    finally:
        restore()
    check(len(dense_routes) == len(kernel_routes) == len(fixed_gates)
          == cfg.num_layers, "forward_mixtral: not one routing per layer")
    flips = torch.stack([route_flips(a, b)
                         for a, b in zip(dense_routes, kernel_routes)])
    margin = torch.stack([gate_margin(x, K) for x in dense_gates])  # [L, S]
    reach = torch.stack([2 * (f - d).abs().max()
                         for f, d in zip(fixed_gates, dense_gates)])  # [L]
    flipped = flips.any(0)
    first_at = torch.where(flipped, flips.float().argmax(0), cfg.num_layers)
    first = first_at[flipped]                         # each token's layer
    first_margin = margin[first, flipped.nonzero()[:, 0]]
    beyond = (flipped.nonzero()[:, 0][first_margin > reach[first]]).tolist()
    W = cfg.sliding_window
    uncaused = [t for t in beyond
                if not bool((first_at[max(0, t - W + 1):t]
                             < first_at[t]).any())]
    # the flips rounding alone makes: the replay's own top-k at each layer
    # against the dense routing it was given
    replay_flips = torch.stack([
        route_flips(rt["layers"]._top_k(f, K)[1], d)
        for f, d in zip(fixed_gates, dense_routes)])
    amax = dense.abs().max().item()
    row_err = (got - dense).abs().max(dim=-1).values
    fixed_err = (fixed - dense).abs().max(dim=-1).values
    agree = (got.argmax(-1) == dense.argmax(-1)).float().mean().item()
    out = {"shape": f"B=1 S={S} window={cfg.sliding_window} bf16",
           "launches": launches, "logits_max_abs": amax,
           "logits_max_abs_err": row_err.max().item(),
           "logits_median_row_err": row_err.median().item(),
           "rows_within_5pct": (row_err <= 0.05 * amax).float().mean()
           .item(),
           "argmax_agreement": agree,
           "routing_flip_share": flips.float().mean().item(),
           "tokens_with_a_flip": flipped.float().mean().item(),
           "rounding_reach_per_layer": reach.tolist(),
           "first_flips": int(first.numel()),
           "first_flip_layers": torch.bincount(
               first, minlength=cfg.num_layers).tolist(),
           "first_flip_max_margin": first_margin.max().item()
           if first.numel() else 0.0,
           "first_flips_within_reach":
               int((first_margin <= reach[first]).sum()),
           "first_flips_beyond_reach": len(beyond),
           "beyond_reach_without_an_earlier_flip_in_window": len(uncaused),
           "rounding_only_flip_share": replay_flips.float().mean().item(),
           "flip_max_margin": margin[flips].max().item()
           if flips.any() else 0.0,
           "margin_median": margin.median().item(),
           "share_within_reach": (margin <= reach[:, None]).float().mean()
           .item(),
           "fixed_routing_logits_max_abs_err": fixed_err.max().item(),
           "fixed_routing_argmax_agreement":
               (fixed.argmax(-1) == dense.argmax(-1)).float().mean().item(),
           "aux_loss": out["aux_loss"].item(),
           "wall_s": wall, "dense_wall_s": dense_wall}
    emit("forward_mixtral", **out)
    check(bool(torch.isfinite(got).all()), "K3 swa forward: non-finite logits")
    check(launches["flash_attention"] == cfg.num_layers,
          f"K3 launched {launches['flash_attention']} times, not once per "
          f"layer")
    check(agree >= 0.8, f"K3 swa forward: greedy tokens agree at {agree}")
    check(out["fixed_routing_logits_max_abs_err"] <= 0.05 * amax,
          f"K3 swa forward with the dense routing: logits err "
          f"{out['fixed_routing_logits_max_abs_err']} vs max {amax}")
    check(not uncaused,
          f"forward_mixtral: {len(uncaused)} tokens first change experts at "
          f"a gate margin beyond rounding's reach with no earlier flip in "
          f"their window")
    return out


def phase_forward_kernel(rt, ops, cfg, params, name="forward_kernel",
                         S=1024, **inputs):
    """``forward_full(use_kernel=True)`` at full width, B = 1, over S
    tokens (and ``inputs``: an encoder-decoder's ``encoder_embeds``),
    against the dense forward: one K3 launch per (decoder) layer. Both
    round every activation to bf16, at other places, through every
    layer: the logits are held within 5% of their largest magnitude, and
    the greedy tokens of at least 80% of the positions agree (random
    weights leave near ties among 100k or more logits)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=g,
                           device="cuda", dtype=torch.int32)
    fwd = rt["model"].forward_full
    with torch.no_grad():
        dense = fwd(params, cfg, tokens, **inputs)["logits"]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = fwd(params, cfg, tokens, use_kernel=True, **inputs)["logits"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    got = got[..., :cfg.vocab_size].float()
    dense = dense[..., :cfg.vocab_size].float()
    err = (got - dense).abs().max().item()
    amax = dense.abs().max().item()
    agree = (got.argmax(-1) == dense.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite logits")
    check(launches["flash_attention"] == cfg.num_layers,
          f"{name}: K3 launched {launches['flash_attention']} times, not "
          f"once per layer")
    check(err <= PATHS_LOGIT_TOL * amax,
          f"{name}: logits err {err} vs max {amax}")
    check(agree >= 0.8, f"{name}: greedy tokens agree at {agree}")
    shape = f"B=1 S={S} bf16"
    if "encoder_embeds" in inputs:
        shape += f", encoder T={inputs['encoder_embeds'].shape[1]}"
    out = {"shape": shape, "launches": launches,
           "logits_max_abs_err": err, "logits_max_abs": amax,
           "argmax_agreement": agree, "wall_s": wall}
    emit(name, **out)
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


class Timing(float):
    """A median device ms, with the fastest and slowest replay beside it
    (``lo``, ``hi``)."""

    def __new__(cls, times):
        times = sorted(times)
        self = super().__new__(cls, times[len(times) // 2])
        self.lo, self.hi = times[0], times[-1]
        return self


def time_cuda(fn, reps=30, warmup=3):
    """Median device ms per call of ``fn`` (a :class:`Timing`: the
    fastest and slowest of the ``reps`` replays beside it; a median drops
    the replay that a host stall lengthens). The call is captured once in a
    CUDA graph and each replay is timed with CUDA events, so the time is
    the device's and not the host's (a wrapper's Python checks, or the
    plain version's op-by-op launches, would otherwise sit between the
    events while the device idles). The 50 MB L2 is flushed before each
    replay: the decode loop finds a layer's pages cold (35 other layers
    and the weights pass through L2 in between). A spin kernel of about
    0.1 ms then keeps the device busy while the host enqueues the start
    event, the replay and the end event, so that the events do not also
    hold the host's submission of the replay (without it, a one-element
    add measured 0.014-0.016 ms). The capture runs with Python's cyclic
    collector off, as the engine's decode graphs do
    (``serving/cuda_graph.py``: a collection during a capture can destroy
    another graph and invalidate the capture)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up off the default stream
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    from repro_torch.serving.cuda_graph import collector_paused
    graph = torch.cuda.CUDAGraph()
    with collector_paused(), torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(200_000)   # GPU cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return Timing(times)


def time_empty():
    """The floor of every timed row: one CTA that does nothing (PyTorch's
    spin kernel asked for 0 cycles), timed as :func:`time_cuda` times a
    kernel."""
    return dict(ms=time_cuda(lambda: torch.cuda._sleep(0)), plain_ms=None,
                library_ms=None, library="none",
                shape="one CTA of one thread, no work", bytes=0, flops=0,
                dtype=torch.bfloat16)


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


def kernel_breakdown(fn, top=8):
    """Where one eager call of ``fn`` spends device time, from
    ``torch.profiler``: the kernels it launches, their summed device ms,
    that sum split into the port's own kernels, matrix products and
    PyTorch's other kernels, and the ``top`` kernels by device time.
    Diagnostic only: no check reads it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as err:
        return f"not measured: {err}"
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if (getattr(e, "device_time_total", 0) or 0) > 0]
    if not rows:
        return "not measured: no device time recorded"
    groups = {"port_kernels": 0.0, "matmul": 0.0, "other": 0.0}
    for key, ms, _ in rows:
        if "anonymous namespace" in key:
            groups["port_kernels"] += ms
        elif re.search(r"gemm|gemv|xmma|cutlass|cublas|nvjet", key,
                       flags=re.I):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    rows.sort(key=lambda r: -r[1])
    return {"kernels": sum(c for _, _, c in rows),
            "device_ms": sum(ms for _, ms, _ in rows), "by_group_ms": groups,
            "top": [[k[:80], ms, c] for k, ms, c in rows[:top]]}


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def time_decode(pa, kvq, g, B, H, KVH, hd, bp, lens, kv_dtype="bf16"):
    """K1a (bf16 pool) or K1c (int8/fp8 pool) with bf16 queries over B
    lanes of ``lens``: the face the route takes (``ms``) and the split
    face, ``decode_kernel``, on the same inputs (``split_ms``); the
    library yardstick is SDPA over K/V gathered
    (and dequantized) before the timed call. Bytes: the queries and the
    output, the block tables and lengths, and each live page of K and V
    once (codes plus their f32 scale per slot and kv head)."""
    import torch.nn.functional as F
    bf, page = torch.bfloat16, 16
    scale = 1.0 / math.sqrt(hd)
    quant = kv_dtype in QUANT
    q, kp, vp, bt, cl = decode_inputs(g, B, H, KVH, hd, bp, lens,
                                      torch.float32 if quant else bf)
    scales = {}
    if quant:
        kp, vp, ks, vs = quantize(kvq, kp, vp, kv_dtype)
        scales = dict(k_scale=ks, v_scale=vs)
        q = q.to(bf)
    kd = pa.gather_kv(kp, bt, scales.get("k_scale")).to(bf).transpose(1, 2) \
        .contiguous()                                    # [B, KVH, S, hd]
    vd = pa.gather_kv(vp, bt, scales.get("v_scale")).to(bf).transpose(1, 2) \
        .contiguous()
    S = bp * page
    mask = (torch.arange(S, device="cuda")[None, :] < cl[:, None])[
        :, None, None, :]
    q4 = q[:, :, None, :]
    pages = sum(-(-n // page) for n in lens)
    slot_bytes = hd + 4 if quant else 2 * hd
    G = H // KVH
    row = dict(
        ms=time_cuda(lambda: pa.paged_attention(q, kp, vp, bt, cl,
                                                scale=scale, **scales)),
        split_ms=time_cuda(lambda: pa.paged_attention_split(
            q, kp, vp, bt, cl, scale=scale, **scales)),
        plain_ms=time_cuda(lambda: pa.paged_attention_plain(
            q, kp, vp, bt, cl, scale, scales.get("k_scale"),
            scales.get("v_scale"))),
        library_ms=time_cuda(lambda: F.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True)),
        library="SDPA over K/V gathered"
                + (" and dequantized" if quant else "") + " beforehand",
        face=pa.decode_face(q.dtype, kp.dtype, hd, page),
        plan=pa.decode_plan(bp, B * KVH * -(-G // pa.CLUSTER_ROWS), page),
        splits=pa.split_count(bp, B * KVH),
        shape=f"B={B} H={H} KVH={KVH} hd={hd} bp={bp} lens={lens[0]}.."
              f"{lens[-1]} bf16 q, {kv_dtype} pool",
        bytes=(2 * q.numel() * 2 + bt.numel() * 4 + cl.numel() * 4
               + 2 * pages * page * KVH * slot_bytes),
        flops=4 * hd * H * sum(lens), dtype=bf)
    return row


def time_prefill(pa, kvq, g, H, KVH, hd, bp, kv_dtype="bf16", C=16,
                 prefix=64, window=None):
    """K1b (bf16 pool) or K1c prefill (int8/fp8 pool): a chunk of C bf16
    queries over a ``prefix``-token pooled prefix plus its own K/V, under
    an optional sliding ``window``; the yardstick is SDPA with the same
    causal (and window) mask over K/V gathered (and dequantized)
    beforehand. Bytes count the pages that hold a visible slot, the
    operations the visible (query, key) pairs."""
    import torch.nn.functional as F
    bf, page = torch.bfloat16, 16
    scale = 1.0 / math.sqrt(hd)
    quant = kv_dtype in QUANT
    q, kp, vp, bt, pl, nv, ok, ov = prefill_inputs(
        g, C, H, KVH, hd, bp, prefix, C, torch.float32 if quant else bf)
    ks = vs = None
    if quant:
        kp, vp, ks, vs = quantize(kvq, kp, vp, kv_dtype)
        q, ok, ov = q.to(bf), ok.to(bf), ov.to(bf)
    keys = torch.cat([pa.gather_kv(kp, bt, ks)[:, :prefix].to(bf), ok], 1)
    vals = torch.cat([pa.gather_kv(vp, bt, vs)[:, :prefix].to(bf), ov], 1)
    kd, vd = (t.transpose(1, 2).contiguous() for t in (keys, vals))
    pos = torch.arange(prefix + C, device="cuda")
    q_pos = prefix + torch.arange(C, device="cuda")[:, None]
    cmask = pos[None, :] <= q_pos
    if window is not None:
        cmask &= pos[None, :] > q_pos - window
    qd = q.transpose(1, 2)
    first = 0 if window is None else max(0, prefix - window + 1)
    pages = max(0, -(-prefix // page) - first // page)
    slot_bytes = hd + 4 if quant else 2 * hd
    visible = int(cmask.sum())
    return dict(
        ms=time_cuda(lambda: pa.paged_attention_prefill(
            q, kp, vp, bt, pl, nv, ok, ov, scale=scale, window=window,
            k_scale=ks, v_scale=vs)),
        plain_ms=time_cuda(lambda: pa.paged_attention_prefill_plain(
            q, kp, vp, bt, pl, nv, ok, ov, scale, window, ks, vs)),
        library_ms=time_cuda(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=cmask, scale=scale, enable_gqa=True)),
        library="SDPA, masked, over K/V gathered"
                + (" and dequantized" if quant else "") + " beforehand",
        shape=f"B=1 C={C} H={H} KVH={KVH} hd={hd} prefix={prefix} "
              f"window={window} bf16 q, {kv_dtype} pool",
        bytes=(2 * q.numel() * 2 + 2 * ok.numel() * 2 + bt.numel() * 4 + 8
               + 2 * pages * page * KVH * slot_bytes),
        flops=4 * hd * H * visible, dtype=bf)


def time_flash(fa, g, H, hd, dtype, S=2048, window=None):
    """K3, B = 1, causal (under an optional sliding ``window``), against
    SDPA with ``is_causal`` (with the window: SDPA with the same boolean
    mask). Operations count the visible (query, key) pairs: S(S+1)/2
    causal, S*W - W(W-1)/2 under a window W <= S."""
    import torch.nn.functional as F
    qf, kf, vf = (torch.randn(1, H, S, hd, generator=g, device="cuda")
                  .to(dtype) for _ in range(3))
    if window is None:
        visible = S * (S + 1) // 2

        def library():
            return F.scaled_dot_product_attention(qf, kf, vf, is_causal=True)
    else:
        visible = S * window - window * (window - 1) // 2
        mask = fa.attention_mask(S, True, window, "cuda")

        def library():
            return F.scaled_dot_product_attention(qf, kf, vf,
                                                  attn_mask=mask)
    return dict(
        ms=time_cuda(lambda: fa.flash_attention(qf, kf, vf, causal=True,
                                                window=window)),
        plain_ms=time_cuda(
            (lambda: fa.flash_attention_plain(qf, kf, vf, True, window))
            if S <= 2048 else
            (lambda: flash_plain_by_heads(fa, qf, kf, vf, window))),
        library_ms=time_cuda(library),
        library="SDPA, is_causal" if window is None
                else "SDPA, causal and window mask",
        shape=f"B=1 H={H} S={S} hd={hd} causal window={window} "
              f"{str(dtype)[6:]}",
        bytes=4 * qf.numel() * qf.element_size(),
        flops=4 * hd * H * visible,
        dtype=dtype if dtype == torch.bfloat16 else TF32X3)


def time_ssd(sd, g, N):
    """K4 at B = 1, S = 2048, H = 80, P = 64, state N, chunk 256, f32:
    the routed face (``ms``, the wgmma face at this shape, with its plan)
    and the tile face called directly on the same inputs (``tile_ms``),
    each launch's device ms of both. Operations: C.B^T once per chunk
    (lower triangle), the intra product over the causal half, the
    carry-in on every chunk but the first (its state is zero), the state
    update everywhere."""
    x, dt, A, Bm, Cm = ssd_inputs(g, 2048, False, N=N)
    Bs, Ss, Hs, Ps = x.shape
    ls = 256
    nc, tri = Ss // ls, ls * (ls + 1) // 2
    flops = (2 * N * tri * nc * Bs + 2 * Ps * tri * nc * Bs * Hs
             + 2 * Ps * N * (Ss - ls) * Bs * Hs + 2 * Ps * N * Ss * Bs * Hs)
    return dict(
        ms=time_cuda(lambda: sd.ssd_scan(x, dt, A, Bm, Cm, chunk=ls)),
        face=sd.ssd_face(Ps, N, ls),
        plan=sd.ssd_plan(Bs, Ss, Hs, N, ls,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count),
        tile_ms=time_cuda(lambda: sd.ssd_scan_tile(x, dt, A, Bm, Cm,
                                                   chunk=ls)),
        plain_ms=time_cuda(lambda: sd.ssd_scan_plain(x, dt, A, Bm, Cm),
                           reps=5, warmup=1),
        library_ms=None, library="none (no single call)",
        launches_ms=device_split(lambda: sd.ssd_scan(x, dt, A, Bm, Cm,
                                                     chunk=ls)),
        tile_launches_ms=device_split(lambda: sd.ssd_scan_tile(
            x, dt, A, Bm, Cm, chunk=ls)),
        shape=f"B={Bs} S={Ss} H={Hs} P={Ps} N={N} chunk={ls} f32",
        bytes=4 * (2 * x.numel() + dt.numel() + A.numel() + 2 * Bm.numel()
                   + Bs * Hs * Ps * N),
        flops=flops, dtype=TF32X3)


def time_ssm_decode(smd, g, N):
    """``ssm_decode`` over 16 lanes, H = 80, P = 64, state N, bf16
    projection and conv state, f32 ssm state. Bytes: the ssm state and
    the conv state read and written once, the projection slices, the
    params and y; operations: per state element the decay, the input
    term, their sum and the y product (5 flop), and the conv."""
    bf = torch.bfloat16
    params, ssm, conv = ssm_decode_inputs(g, bf, N=N)
    xbc, dt = ssm_projection(g, bf, N=N)
    Bd, Hd, Pd, Nd = ssm.shape
    Wd, Cd = params[0].shape
    return dict(
        ms=time_cuda(lambda: smd.ssm_decode(conv, ssm, xbc, dt, *params)),
        plain_ms=time_cuda(lambda: smd.ssm_decode_plain(conv, ssm, xbc, dt,
                                                        *params)),
        library_ms=None, library="none (no single call)",
        launches_ms=device_split(lambda: smd.ssm_decode(conv, ssm, xbc, dt,
                                                        *params)),
        shape=f"B={Bd} H={Hd} P={Pd} N={Nd} C={Cd} W={Wd} bf16 "
              f"projection and conv state, f32 ssm state",
        bytes=(2 * ssm.numel() * 4 + 2 * conv.numel() * 2 + xbc.numel() * 2
               + dt.numel() * 2 + (Wd + 1) * Cd * 2 + 3 * Hd * 4
               + Bd * Hd * Pd * 4),
        flops=5 * ssm.numel() + 2 * Wd * Bd * Cd, dtype=torch.float32)


def time_score(ss, g, B, D):
    """K2 over B lanes of bf16 hidden states of width D, f32 weights
    (hidden width 512): the kernel, the device time of each of its two
    launches (torch.profiler) and the plan it ran."""
    Hd = 512
    h = torch.randn(B, D, generator=g, device="cuda").to(torch.bfloat16)
    w1 = torch.randn(D, Hd, generator=g, device="cuda") * (2.0 / D) ** 0.5
    b1 = torch.zeros(Hd, device="cuda")
    w2 = torch.randn(Hd, 1, generator=g, device="cuda") * Hd ** -0.5
    b2 = torch.zeros(1, device="cuda")
    return dict(
        ms=time_cuda(lambda: ss.step_score(h, w1, b1, w2, b2)),
        plain_ms=time_cuda(lambda: ss.step_score_plain(h, w1, b1, w2, b2)),
        library_ms=None,
        launches_ms=device_split(lambda: ss.step_score(h, w1, b1, w2, b2)),
        plan=ss.score_plan(B, D, Hd, ss.card_fits(h.device)),
        shape=f"B={B} D={D} hidden={Hd} bf16 hidden, f32 weights",
        bytes=h.numel() * 2 + (w1.numel() + 2 * Hd + 1 + B) * 4,
        flops=2 * B * D * Hd + 4 * B * Hd, dtype=torch.float32)


def time_glue(gl, layers, g, name, kernel):
    """A glue kernel at a ``GLUE`` shape, beside its plain version (the
    chain's ops, launch by launch). Bytes: each operand read and each
    output written once (the prologue's K/V writes counted for every
    lane, its tables, positions, writer and lengths at 4 bytes a lane)."""
    spec = GLUE[name]
    x = glue_inputs(g, layers, spec)
    B, D, hd = GLUE_B, spec["D"], GLUE_HD
    H, KVH = spec["H"], spec["KVH"]
    lens = torch.empty((B,), dtype=torch.int32, device="cuda")
    if kernel == "add_rms_norm":
        run = (lambda: gl.add_rms_norm(x["h"], x["delta"], x["w"], GLUE_EPS),
               lambda: gl.add_rms_norm_plain(x["h"], x["delta"], x["w"],
                                             GLUE_EPS))
        shape = f"B={B} D={D}, the residual add and the norm"
        nbytes, flops = (4 * B * D + D) * 2, 5 * B * D
    elif kernel == "attn_prologue":
        run = (lambda: gl.attn_prologue(*prologue_args(gl, x, x["pools"],
                                                       lens)),
               lambda: gl.attn_prologue_plain(*prologue_args(
                   gl, x, x["pools"], lens)))
        shape = (f"B={B} H={H} KVH={KVH} hd={hd} qk_norm={spec['qk_norm']} "
                 f"writer={spec['writer']} window={GLUE_WINDOW}")
        nbytes = (2 * B * (2 * H + 4 * KVH) * hd + 4 * hd + 2 * hd
                  + 4 * B * (3 + spec["writer"]))
        flops = 16 * B * (H + KVH) * hd
    else:
        run = (lambda: gl.silu_mul(x["gate"], x["up"]),
               lambda: gl.silu_mul_plain(x["gate"], x["up"]))
        n = x["gate"].numel()
        shape = "x".join(map(str, spec["gate"])) + ", silu(g) * u"
        nbytes, flops = 3 * 2 * n, 5 * n
    return dict(ms=time_cuda(run[0]), plain_ms=time_cuda(run[1]),
                library_ms=None, shape=shape, bytes=nbytes, flops=flops,
                dtype=torch.bfloat16)


def phase_times(pa, ss, fa, sd, kvq, smd, gl, layers):
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    bf = torch.bfloat16
    # the floor every row reads against: a launch that does nothing
    rows = {"empty_kernel": time_empty()}
    # K1 at the serve phases' decode shape: 16 lanes over 80-block pool
    # rows of 32 pages, lengths across the prompt + 128 tokens range;
    # qwen3 (H 32, KVH 8, hd 128) and zamba2 (H = KVH = 32, hd 80)
    B = 16
    lens = [15 + (128 * i) // (B - 1) for i in range(B)]
    for tag, H, KVH, hd in (("", 32, 8, 128), ("_hd80", 32, 32, 80)):
        rows[f"paged_attention_decode{tag}"] = time_decode(
            pa, kvq, g, B, H, KVH, hd, 32, lens)
        if not tag:
            # K1a over long rows: 16 lanes of 1024-4096 slots (bp = 256,
            # ~41k live slots, ~168 MB of pages)
            lens_l = [1024 + (3072 * i) // (B - 1) for i in range(B)]
            rows["paged_attention_decode_long"] = time_decode(
                pa, kvq, g, B, H, KVH, hd, 256, lens_l)
            torch.cuda.empty_cache()
        # K1b at the batched phase's chunk shape: C = 16 over a 64-token
        # prefix; K1c at the same decode and chunk shapes over int8/fp8
        rows[f"paged_attention_prefill{tag}"] = time_prefill(
            pa, kvq, g, H, KVH, hd, 32)
        for kv_dtype in QUANT:
            rows[f"paged_attention_decode_{kv_dtype}{tag}"] = time_decode(
                pa, kvq, g, B, H, KVH, hd, 32, lens, kv_dtype)
            rows[f"paged_attention_prefill_{kv_dtype}{tag}"] = time_prefill(
                pa, kvq, g, H, KVH, hd, 32, kv_dtype)
    # K1a at granite-20b's shape: 48 query heads over one kv head, hd 128,
    # the dense_archs phase's 8 lanes (prompt + 32 tokens)
    lens8 = [15 + (32 * i) // 7 for i in range(8)]
    rows["paged_attention_decode_g48"] = time_decode(pa, kvq, g, 8, 48, 1,
                                                     128, 32, lens8)
    # a rank of serve_mesh's (1, 2) mesh: 16 query heads over 4 kv heads,
    # 16 lanes; the chunk of 8 over the prompt's first 8 tokens
    rows["paged_attention_decode_mesh"] = time_decode(pa, kvq, g, B, 16, 4,
                                                      128, 32, lens)
    rows["paged_attention_prefill_mesh"] = time_prefill(
        pa, kvq, g, 16, 4, 128, 32, C=8, prefix=8)

    # K3 at the kernels phase's shape: B = 1, H = 32, S = 2048, causal;
    # qwen3's hd 128 in bf16, zamba2's hd 80 in bf16 and f32
    rows["flash_attention"] = time_flash(fa, g, 32, 128, bf)
    rows["flash_attention_hd80"] = time_flash(fa, g, 32, 80, bf)
    rows["flash_attention_hd80_f32"] = time_flash(fa, g, 32, 80,
                                                  torch.float32)
    torch.cuda.empty_cache()
    # mixtral-8x7b's windowed paths: K3 at forward_mixtral's S = 8192
    # under the 4096 window, and K1b at a 512-token chunk over a 4608-token
    # prefix (the window's edge 513-1024 slots in)
    rows["flash_attention_swa"] = time_flash(fa, g, 32, 128, bf, S=8192,
                                             window=SWA_WINDOW)
    torch.cuda.empty_cache()
    rows["paged_attention_prefill_swa"] = time_prefill(
        pa, kvq, g, 32, 8, 128, 4608 // 16 + 1, C=SWA_CHUNK, prefix=4608,
        window=SWA_WINDOW)
    # K1c's prefill face at the same chunk over int8 and fp8 pools, and
    # K1b there with no window: a long prompt's chunked prefill on a model
    # without one (this line only)
    for kv_dtype in QUANT:
        rows[f"paged_attention_prefill_{kv_dtype}_swa"] = time_prefill(
            pa, kvq, g, 32, 8, 128, 4608 // 16 + 1, kv_dtype, C=SWA_CHUNK,
            prefix=4608, window=SWA_WINDOW)
    rows["paged_attention_prefill_long"] = time_prefill(
        pa, kvq, g, 32, 8, 128, 4608 // 16 + 1, C=SWA_CHUNK, prefix=4608)
    torch.cuda.empty_cache()
    # K1a at batched_mixtral's decode: 4 lanes of 4201-4216 slots over
    # 288-page rows, 9 parts per lane merged
    rows["paged_attention_decode_mixtral"] = time_decode(
        pa, kvq, g, 4, 32, 8, 128, MIXTRAL_BP, list(MIXTRAL_LENS))
    torch.cuda.empty_cache()
    # seamless-m4t's decoder: K1a at decode_seamless's 8 lanes (the
    # steps' 65..128 slots), K3 at forward_seamless's S = 512 (16 heads,
    # hd 64)
    rows["paged_attention_decode_seamless"] = time_decode(
        pa, kvq, g, SEAMLESS_B, 16, 16, 64, SEAMLESS_CAPACITY // 16,
        SEAMLESS_LENS[1:] + [SEAMLESS_CAPACITY])
    rows["flash_attention_seamless"] = time_flash(fa, g, 16, 64, bf,
                                                  S=SEAMLESS_S)
    # the serving launcher's model (H 4, KVH 2, hd 64): K1a/K1c over the
    # tight-pool runs' 16 lanes of 16-page rows (prompt + up to 96 new
    # tokens), K1b/K1c's prefill face at a chunk of 8 over 16 tokens
    lens_launch = [24 + (96 * i) // (B - 1) for i in range(B)]
    for kv_dtype in ("bf16", "int8"):
        tag = "" if kv_dtype == "bf16" else "_int8"
        rows[f"paged_attention_decode{tag}_launch"] = time_decode(
            pa, kvq, g, B, 4, 2, 64, 16, lens_launch, kv_dtype)
        rows[f"paged_attention_prefill{tag}_launch"] = time_prefill(
            pa, kvq, g, 4, 2, 64, 16, kv_dtype, C=8, prefix=16)

    # K2 at the decode batch: 16 lanes, D = 2560 (qwen3, mamba2, zamba2),
    # 4096 (mixtral) and 256 (the serving launcher's model); D = 2560 at
    # the kernels phase's 64 lanes (this line only)
    rows["step_score"] = time_score(ss, g, B, 2560)
    rows["step_score_d4096"] = time_score(ss, g, B, 4096)
    rows["step_score_d256"] = time_score(ss, g, B, 256)
    rows["step_score_b64"] = time_score(ss, g, 64, 2560)

    # K4 and ssm_decode at mamba2's state (N = 128) and zamba2's (N = 64):
    # the forward phases' scan and the serve phases' decode batch
    rows["ssd_scan"] = time_ssd(sd, g, 128)
    rows["ssd_scan_zamba2"] = time_ssd(sd, g, 64)
    rows["ssm_decode"] = time_ssm_decode(smd, g, 128)
    rows["ssm_decode_zamba2"] = time_ssm_decode(smd, g, 64)

    # the decode glue at both STEP cells' shapes: qwen3's rows, then
    # mixtral's (its prologue under the writer) and its expert gate
    for kernel in ("add_rms_norm", "attn_prologue", "silu_mul"):
        rows[kernel] = time_glue(gl, layers, g, "qwen3", kernel)
        tag = "expert" if kernel == "silu_mul" else "mixtral"
        rows[f"{kernel}_{tag}"] = time_glue(gl, layers, g, "mixtral",
                                            kernel)
    torch.cuda.empty_cache()

    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["flops"],
                                                r.pop("dtype"))
        r["bound_share"] = r["bound_ms"] / r["ms"]
        for k in ("ms", "split_ms", "plain_ms", "library_ms"):
            if isinstance(r.get(k), Timing):   # the fastest and slowest
                r[k + "_range"] = [r[k].lo, r[k].hi]
    emit("times", **rows)
    return rows


DENSE_ARCHS = ("qwen3-1.7b", "internvl2-2b", "starcoder2-3b",
               "phi4-mini-3.8b", "granite-20b")
# mixtral-8x7b's depth on one 80 GB card (its 32 layers take 93 GB)
MIXTRAL_LAYERS = 16
# a prompt longer than the smoke window (8) of reference_mixtral
WINDOW_PROMPT = "12+34-5=41;6+7=13;8-2+9="


def phase_dense_archs(rt, ops):
    """The four dense GQA archs beside qwen3-4b-thinking and the vlm
    internvl2-2b (served as text, as both packages' engines serve it) at
    full width (random seeded weights), one at a time, each freed before
    the next (granite-20b, 28 B params and 56 GB in bf16, last): a
    graphed STEP serve of 1 request x 8 traces, greedy, 32 new tokens,
    kernels on,
    against the eager kernel engine (identical tokens, statuses, prunes,
    bitwise step scores); then the kernel engine against the dense
    engine at the arch's smoke config, as ``reference`` does for qwen3."""
    E = rt["engine"]
    tok = rt["tokenizer"].get_tokenizer()
    problem = rt["evaluate"].make_problems(1, seed=SEED + 8)[0]
    prompt = tok.encode(rt["arithmetic"].make_prompt(problem), add_bos=True)
    ecfg = E.EngineConfig(max_batch=8, num_blocks=80, capacity=512,
                          max_new_tokens=32, sampling=greedy(rt, 32),
                          use_kernel="auto", decode_horizon=4,
                          prefix_cache=True, faults=None, kv_dtype="bf16")
    out = {}
    for arch in DENSE_ARCHS:
        cfg, params, scorer, n_params, init_s = full_model(rt, arch)

        def make_engine(eager, cfg=cfg, params=params, scorer=scorer):
            engine = tick_counting(E)(params, cfg, ecfg,
                                      rt["pruning"].make_policy("step"),
                                      scorer_params=scorer,
                                      _eager_decode=eager)
            check(engine.use_kernel and engine.fused_scorer,
                  "engine not on the kernel path")
            return engine

        def run(engine):
            res = engine.serve(prompt, 8)
            check_result(res, engine)
            return [res]

        first, report = graphed_vs_eager(ops, make_engine, run,
                                         f"dense_archs {arch}", calls=1)
        launches = first["launches"]
        iters = launches["step_score"]
        check(iters > 0 and launches[K1A[0]] == iters * cfg.num_layers
              and launches["paged_attention_decode"] == 0,
              f"{arch}: K1a's cluster face did not run once per layer and "
              f"iteration, or decode_kernel ran")
        out[arch] = {
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
            "params": n_params, "init_s": init_s,
            "total_tokens": first["total_tokens"],
            "num_pruned": first["results"][0].num_pruned,
            "decode_iterations": iters, "launches": launches,
            "max_memory_allocated": first["max_memory_allocated"],
            "graph": report}
        del params, scorer, first, make_engine
        gc.collect()
        torch.cuda.empty_cache()
        phase_smoke_reference(rt, arch=arch)
    emit("dense_archs", **out)
    return out

# deepseek-v2-236b's depth on one 80 GB card: 8 of its 60 layers (65.7 GB
# of bf16 weights; all 60 would take 472 GB)
DEEPSEEK_LAYERS = 8


def phase_reference_deepseek(rt):
    """deepseek's smoke config, f32 params with EOS suppressed: the CUDA
    engine against the port's CPU engine, greedy STEP over 8 traces of one
    prompt in the 16-block pool (so STEP prunes). MLA takes no kernel,
    as in the JAX engine: ``use_kernel=True`` must raise, and "auto"
    serves dense with the plain scorer on both devices. Tokens, statuses
    and prunes identical; step scores within 1e-4 (the devices sum in
    other orders)."""
    E, ops = rt["engine"], rt["ops"]
    cfg = rt["registry"].serving_config("deepseek-v2-236b")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    tok = rt["tokenizer"].get_tokenizer()
    params = no_eos(to_f32(rt["init"].init_params(cfg, g)), cfg, tok.eos_id)
    scorer = rt["scorer"].init_scorer(g, cfg.d_model)
    prompt = tok.encode("3+5-2=", add_bos=True)

    def ecfg(use_kernel):
        return E.EngineConfig(max_batch=8, num_blocks=16, capacity=128,
                              max_new_tokens=40, sampling=greedy(rt, 40),
                              use_kernel=use_kernel, decode_horizon=4,
                              faults=None, kv_dtype="f32")

    try:
        E.Engine(params, cfg, ecfg(True), rt["pruning"].make_policy("step"),
                 scorer_params=scorer)
        raised = None
    except NotImplementedError as err:
        raised = str(err)
    check(raised is not None, "use_kernel=True did not raise for MLA")
    outs = {}
    for device in ("cuda", "cpu"):
        engine = E.Engine(params, cfg, ecfg("auto"),
                          rt["pruning"].make_policy("step"),
                          scorer_params=scorer, device=device)
        check(not engine.use_kernel and not engine.fused_scorer,
              f"the {device} MLA engine took a kernel")
        ops.reset_launch_counts()
        res = engine.serve(prompt, 8)
        torch.cuda.synchronize()
        check_result(res, engine)
        outs[device] = (res, ops.launch_counts())
    (c, launches), (h, _) = outs["cuda"], outs["cpu"]
    check(all(n == 0 for k, n in launches.items()
              if not k.startswith("decode_graph")),
          f"reference_deepseek: a kernel launched: {launches}")
    check([t.output_tokens for t in c.traces]
          == [t.output_tokens for t in h.traces], "CUDA != CPU tokens")
    check([t.status for t in c.traces] == [t.status for t in h.traces],
          "CUDA != CPU statuses")
    check(c.num_pruned == h.num_pruned > 0,
          "CUDA != CPU prunes, or no pruning")
    err = max((abs(a - b) for tc, th in zip(c.traces, h.traces)
               for a, b in zip(tc.step_scores, th.step_scores)), default=0.0)
    check(err <= 1e-4, f"CUDA vs CPU step scores differ by {err}")
    emit("reference_deepseek", config=cfg.name, kv_dtype="f32",
         use_kernel_true_raises=raised, launches=launches,
         tokens_identical=True, num_pruned=c.num_pruned,
         tokens_compared=sum(len(t.output_tokens) for t in c.traces),
         step_scores=sum(len(t.step_scores) for t in c.traces),
         max_step_score_err=err)


def phase_mla_layer(rt, cfg, params):
    """Layer 0's MLA attention at full width (128 heads, kv_lora 512,
    rope 64), B = 4, S = 256: ``mla_attention_full(return_kv=True)``'s
    latent entries of the first 240 tokens fill a paged pool, then the
    absorbed decode (``mla_attention_decode``) runs the last 16 tokens one
    at a time. Each decoded row against the full forward's row at that
    position: in bf16 (the served params) within the bf16 tolerance, and
    on the same weights in f32 within the f32 one. The two paths round
    at other places (the decode folds ``wk_b`` into q and ``wv_b`` into
    the output)."""
    M, L = rt["model"], rt["layers"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    B, S, S0, bs = 4, 256, 240, cfg.kv_block_size
    bp = S // bs
    bt = (1 + torch.arange(B * bp, device="cuda", dtype=torch.int32)) \
        .reshape(B, bp)
    pos = torch.arange(S, device="cuda", dtype=torch.int32)[None] \
        .expand(B, S)
    x0 = torch.randn(B, S, cfg.d_model, generator=g, device="cuda")
    out = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        lp = {k: v[0].to(dtype) for k, v in params["layers"]["attn"].items()}
        x = x0.to(dtype)
        with torch.no_grad():
            full, entries = L.mla_attention_full(lp, cfg, x, pos,
                                                 return_kv=True)
            pool = torch.zeros((1, B * bp + 1, bs, entries.shape[-1]),
                               dtype=dtype, device="cuda")
            M.write_pool_kv(cfg, {"kv_pool": pool, "block_tables": bt},
                            entries[None, :, :S0])
            rows = []
            for t in range(S0, S):
                rows.append(L.mla_attention_decode(
                    lp, cfg, x[:, t:t + 1], pos[:, t].contiguous(),
                    {"kv_pool": pool[0], "block_tables": bt,
                     "window_len": S})[:, 0])
        got = torch.stack(rows, dim=1)
        want = full[:, S0:]
        key = str(dtype)[6:]
        out[key] = {"max_abs_err": compare(f"mla_layer {key}", got, want,
                                           tol),
                    "max_abs": want.float().abs().max().item()}
        # the decode wrote the last 16 tokens' entries where the full
        # forward's would go
        out[key]["entries_max_abs_err"] = (
            M.write_pool_kv(cfg, {"kv_pool": pool.clone(),
                                  "block_tables": bt},
                            entries[None])["kv_pool"]
            - pool).abs().max().item()
    emit("mla_layer", shape=f"B={B} S={S}, decode of the last {S - S0}",
         heads=cfg.num_heads, kv_lora=cfg.kv_lora_rank,
         rope=cfg.qk_rope_head_dim, tolerances={"bf16": BF16_TOL,
                                                "f32": F32_TOL}, **out)
    return out


def phase_forward_seamless(rt, ops, cfg, params):
    """seamless-m4t at full depth: the encoder over 1024 frame embeddings
    (the stub frontend's, 0.02 N(0, 1)), the decoder over 512 tokens,
    each decoder layer's self-attention through K3 (hd 64, 16 heads; the
    encoder stays dense, as in the JAX package), held as
    :func:`phase_forward_kernel` holds its forward."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    enc = (0.02 * torch.randn(1, cfg.encoder_seq_len, cfg.d_model,
                              generator=g, device="cuda")).to(torch.bfloat16)
    return phase_forward_kernel(rt, ops, cfg, params, "forward_seamless",
                                S=SEAMLESS_S, encoder_embeds=enc)


def phase_decode_seamless(rt, ops, cfg, params):
    """seamless-m4t's decoder as a server would run it, at full depth:
    8 lanes, each over the encoder output of its own 1024 frames
    (``build_cross_cache``), a 64-token decoder prompt prefilled one-shot,
    then 64 teacher-forced ``decode_step`` calls through K1a (one launch
    per decoder layer and step: hd 64, 16 query heads over 16) against
    the same calls dense, each path over its own pool. On the same
    weights in f32 the logits of every step agree within the f32
    tolerance. On the bf16 params the kernel and the plain decode agree
    to a few 1e-7 (``kernels``), but each logit is a bf16 value of up to
    ~5, whose ulp is 0.03: a rare one-ulp difference in an attention
    output moves some logits by two ulps, past the bf16 tolerance. So
    each bf16 step is held as ``forward_kernel``'s logits are (within 5%
    of their largest magnitude, greedy tokens agreeing at 80% or more),
    and the share of logits within the bf16 tolerance is reported."""
    M = rt["model"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    B, P, n = SEAMLESS_B, SEAMLESS_PROMPT, SEAMLESS_STEPS
    T, V = cfg.encoder_seq_len, cfg.vocab_size
    enc0 = 0.02 * torch.randn(B, T, cfg.d_model, generator=g, device="cuda")
    tokens = torch.randint(0, V, (B, P + n), generator=g, device="cuda",
                           dtype=torch.int32)
    launches = dict.fromkeys(K1A, 0)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        p = params if dtype == torch.bfloat16 else to_f32(params)
        enc = enc0.to(dtype)
        key = str(dtype)[6:]
        errs, within, agree, kernel_s, amax = [], 0, 0, 0.0, 0.0
        with torch.no_grad():
            t0 = time.perf_counter()
            pre = M.forward_full(p, cfg, tokens[:, :P], encoder_embeds=enc,
                                 return_kv=True)
            cross = M.build_cross_cache(p, cfg, M.encode(p, cfg, enc))
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            caches = {}
            for use_kernel in (False, True):
                c = M.init_decode_cache(cfg, B, SEAMLESS_CAPACITY,
                                        encoder_len=T,
                                        kv_dtype="bf16" if key == "bfloat16"
                                        else "f32", device="cuda")
                M.write_prefill_kv(cfg, c, pre["kvs"],
                                   torch.full((B,), P, dtype=torch.int32,
                                              device="cuda"))
                c["cross_k"], c["cross_v"] = cross
                caches[use_kernel] = c
            for i in range(n):
                pos = torch.full((B,), P + i, dtype=torch.int32,
                                 device="cuda")
                step = tokens[:, P + i:P + i + 1]
                want = M.decode_step(p, cfg, step, pos, caches[False],
                                     window_len=SEAMLESS_CAPACITY)["logits"]
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                got = M.decode_step(p, cfg, step, pos, caches[True],
                                    window_len=SEAMLESS_CAPACITY,
                                    use_kernel=True)["logits"]
                torch.cuda.synchronize()
                kernel_s += time.perf_counter() - t0
                # bf16 takes the cluster face, f32 decode_kernel
                face = K1A[0] if dtype == torch.bfloat16 else K1A[1]
                k1a = ops.launch_counts()[face]
                check(k1a == k1a_launches(ops.launch_counts())
                      == cfg.num_layers,
                      f"decode_seamless {key} step {i}: {k1a} {face} "
                      f"launches")
                launches[face] += k1a
                got, want = (x[:, :V].float() for x in (got, want))
                check(bool(torch.isfinite(got).all()),
                      f"decode_seamless {key} step {i}: non-finite")
                err = (got - want).abs().max().item()
                step_max = want.abs().max().item()
                amax = max(amax, step_max)
                errs.append(err)
                if dtype == torch.float32:
                    compare(f"decode_seamless f32 step {i}", got, want,
                            F32_TOL)
                else:
                    check(err <= PATHS_LOGIT_TOL * step_max,
                          f"decode_seamless bf16 step {i}: logits err "
                          f"{err} vs max {step_max}")
                within += int(torch.isclose(got, want, **BF16_TOL).sum())
                agree += int((got.argmax(-1) == want.argmax(-1)).sum())
        check(agree >= 0.8 * B * n,
              f"decode_seamless {key}: greedy tokens agree at "
              f"{agree / (B * n)}")
        out[key] = {"prefill_s": prefill_s,
                    "kernel_decode_ms_per_step": kernel_s / n * 1e3,
                    "logits_max_abs_err": max(errs),
                    "logits_max_abs_err_by_step": errs[::8],
                    "logits_max_abs": amax,
                    "share_within_bf16_tolerance": within / (B * n * V),
                    "argmax_agreement": agree / (B * n)}
        del p, pre, cross, caches
    out = {"lanes": B, "encoder_frames": T, "prompt_tokens": P, "steps": n,
           "launches": launches,
           "tolerances": {"f32": F32_TOL, "bf16": "within "
                          f"{PATHS_LOGIT_TOL} of the step's largest logit"},
           **out}
    emit("decode_seamless", **out)
    return out


def phase_step(rt, cfg, params, name="step"):
    """One full-width decode iteration (``decode_step``, kernels on where
    the arch has them) at the serve phase's shape: the host's wall time
    per eager call against the device time of the same work replayed
    from a CUDA graph. Their
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

    def step():   # MLA has no kernel path: it decodes dense
        return rt["model"].decode_step(params, cfg, tokens, positions, cache,
                                       window_len=capacity,
                                       use_kernel=not cfg.use_mla)

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
           "weights_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "breakdown": kernel_breakdown(step)}
    if "ssm_state" in cache:
        state_bytes = sum(cache[k].numel() * cache[k].element_size()
                          for k in ("ssm_state", "conv_state"))
        out["state_bound_ms"] = 2 * state_bytes / HBM_BYTES_PER_S * 1e3
    emit(name, **out)
    return out


# ---------------------------------------------------------------------------
# the launchers (repro_torch.launch)
# ---------------------------------------------------------------------------

# the decode_32k shape cut to one card: B 128 x 32768 slots take 618 GB of
# K/V at qwen3's 36 layers, B 16 x 4096 take 9.66 GB
LAUNCH_B, LAUNCH_CAPACITY, LAUNCH_PROMPT, LAUNCH_STEPS = 16, 4096, 2048, 32
# the serving launcher's LM training steps (REPRO_TRAIN_STEPS): the
# default 4000 took 102-150 s on the card's host (host-bound small
# launches), more than the launcher phases' share of the time limit
LAUNCH_TRAIN_STEPS = 2000
ROOFLINE_REPS = 5
# the dry run takes about 2.5 minutes of one CPU core; the card's phases
# take longer, so it is waited for only past them, and only until this
# many seconds after the script's start
DRYRUN_DEADLINE_S = 1000
# the serving launcher's runs: the paper's memory-pressure pair (16
# traces over 11 free blocks of 16 slots), online serving with chunked
# prefill, and an int8 pool
LAUNCH_RUNS = (
    ("sc", ["--method", "sc", "--blocks", "12", "--problems", "4",
            "--traces", "16"]),
    ("step", ["--method", "step", "--blocks", "12", "--problems", "4",
              "--traces", "16"]),
    ("step_online", ["--method", "step", "--batched", "--arrival-rate",
                     "2.0", "--chunk", "8", "--max-tokens-per-step", "32",
                     "--stream"]),
    ("step_int8", ["--method", "step", "--kv-dtype", "int8", "--chunk",
                   "8"]),
)


class CaptureTimer:
    """Sums the seconds of every decode-graph capture made inside the
    ``with`` block (engines built inside a call, as ``evaluate_method``
    builds one per problem)."""

    def __init__(self, cuda_graph):
        self.cls, self.seconds = cuda_graph.DecodeGraph, 0.0

    def __enter__(self):
        orig = self.orig = self.cls._capture

        def timed(graph, *args):
            orig(graph, *args)
            self.seconds += graph.capture_s
        self.cls._capture = timed
        return self

    def __exit__(self, *exc):
        self.cls._capture = self.orig


def phase_launch_serve(rt, ops):
    """The serving launcher as a user runs it: ``launch.artifacts`` trains
    the reasoning LM (``LAUNCH_TRAIN_STEPS``) and builds its step scorer
    on the card, then ``launch.serve.main`` runs each of ``LAUNCH_RUNS``
    in-process on those artifacts (one engine per problem offline, one
    for all online), kernels on ("auto"). Under the tight pool STEP
    prunes and waits 0 s while SC preempts and waits; the STEP runs
    launch K1a and K2, the chunked run K1b, the int8 run K1c."""
    from repro_torch.launch import artifacts, serve
    from repro_torch.serving import cuda_graph
    os.environ["REPRO_TRAIN_STEPS"] = str(LAUNCH_TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    info = artifacts.build_artifacts(verbose=False)
    torch.cuda.synchronize()
    out = {"train_steps": info["train_steps"], "build_s":
           time.perf_counter() - t0, "train_s": info["train_s"],
           "train_final_loss": info["train_final_loss"],
           "build_scorer_s": info["build_scorer_s"],
           "sampled_correct_rate": info["scorer_info"][
               "sampled_correct_rate"],
           "scorer_info": info["scorer_info"],
           "build_max_memory_allocated": torch.cuda.max_memory_allocated()}
    check(math.isfinite(info["train_final_loss"]), "artifacts: train loss")
    runs, total = {}, {}
    for name, argv in LAUNCH_RUNS:
        gc.collect()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with CaptureTimer(cuda_graph) as cap:
            t0 = time.perf_counter()
            res = serve.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        runs[name] = {
            "argv": " ".join(argv), "acc": res.accuracy,
            "avg_tokens": res.avg_tokens,
            "avg_latency_s": res.avg_latency_s, "wait_s": res.total_wait_s,
            "pruned": res.num_pruned, "preemptions": res.num_preemptions,
            "wall_s": wall, "launches": launches,
            "captures": launches["decode_graph_captures"],
            "replays": launches["decode_graph_replays"],
            "capture_s": cap.seconds}
        if res.serving is not None:
            runs[name]["serving"] = {k: res.serving[k] for k in (
                "ttft_s", "tpot_s", "e2e_s", "throughput_tok_per_s")}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        check(launches["decode_graph_replays"] > 0
              and launches["decode_graph_captures"] > 0,
              f"launch_serve {name}: no decode graph replayed")
        if name != "sc":
            check(launches[K1C_DECODE[0] if name == "step_int8"
                           else K1A[0]] > 0
                  and all(launches[k] == 0 for k in SPLIT_DECODE)
                  and launches["step_score"] > 0,
                  f"launch_serve {name}: K1a's cluster face or K2 never "
                  f"launched, or decode_kernel ran")
    sc, step = runs["sc"], runs["step"]
    check(sc["preemptions"] > 0 and sc["wait_s"] > 0,
          f"launch_serve sc: preempt {sc['preemptions']} wait "
          f"{sc['wait_s']}")
    check(step["wait_s"] == 0.0 and step["pruned"] > 0
          and step["preemptions"] == 0,
          f"launch_serve step: wait {step['wait_s']} pruned "
          f"{step['pruned']} preempt {step['preemptions']}")
    check(k1b_launches(runs["step_online"]["launches"]) > 0,
          "launch_serve step_online: K1b never launched")
    check(k1b_launches(runs["step_int8"]["launches"], K1C_PREFILL) > 0,
          "launch_serve step_int8: K1c's prefill face never launched")
    out.update(runs=runs, launches=total)
    emit("launch_serve", **out)
    return out


# the quickstart's flags: its own scale and defaults (kernels "auto": on
# the card), with prompts prefilled in chunks of 8 so that K1b runs too
EXAMPLE_ARGV = ["--chunk", "8"]


def phase_examples(ops):
    """``examples/torch_quickstart.py``'s ``main`` on the card at its own
    scale (``EXAMPLE_ARGV``): it trains the tiny LM (300 steps), builds
    the step scorer and serves one problem with SC and with STEP under
    the 12-block pool. Checks that each method served its 8 traces and
    that K1a, K1b and K2 launched; reports each method's answer,
    latency, wait, prunes and preemptions, the launches and the wall
    seconds."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    gc.collect()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = quickstart.main(EXAMPLE_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    out = {"argv": " ".join(EXAMPLE_ARGV), "wall_s": wall,
           "launches": {k: launches[k] for k in (
               *K1A, *K1B, "step_score",
               "decode_graph_captures", "decode_graph_replays")}}
    for method in ("sc", "step"):
        r = res[method]
        check(r.latency_s > 0 and len(r.traces) == 8,
              f"examples {method}: latency {r.latency_s}, "
              f"{len(r.traces)} traces")
        out[method] = {"answer": r.answer, "latency_s": r.latency_s,
                       "wait_s": r.wait_s, "pruned": r.num_pruned,
                       "preemptions": r.num_preemptions}
    for name in (K1A[0], "step_score"):
        check(launches[name] > 0, f"examples: {name} never launched")
    check(k1b_launches(launches) > 0, "examples: K1b never launched")
    emit("examples", **out)
    return out


def phase_launch_steps(rt, ops, cfg, params):
    """``launch.steps`` at full width: ``make_prefill_step`` over a
    ``LAUNCH_PROMPT``-token prompt in each of ``LAUNCH_B`` lanes, its K/V
    written into contiguous caches laid out as ``kv_cache_specs``'s
    decode_32k cut to ``LAUNCH_B`` x ``LAUNCH_CAPACITY``, then
    ``LAUNCH_STEPS`` teacher-forced ``make_decode_step`` calls (dense, as
    in the JAX package: no kernel reads a contiguous cache). Each step's
    logits are held to the teacher-forced ``forward_full`` as
    ``forward_kernel``'s are (within 5% of the step's largest logit: both
    paths round every activation to bf16, at other places), and the
    greedy tokens agree wherever the reference's top two logits lie
    further apart than twice the step's largest error."""
    from repro_torch.launch import steps
    Reg, M = rt["registry"], rt["model"]
    B, cap, P, n = LAUNCH_B, LAUNCH_CAPACITY, LAUNCH_PROMPT, LAUNCH_STEPS
    specs = Reg.kv_cache_specs(cfg, "decode_32k")
    tok_spec = Reg.input_specs(cfg, "decode_32k")["tokens"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    # the teacher-forced reference runs past the decoded positions to a
    # multiple of the chunked attention's 512 (causal: later tokens leave
    # earlier logits alone)
    ref_len = -(-(P + n) // 512) * 512
    tokens = torch.randint(0, cfg.vocab_size, (B, ref_len), generator=g,
                           device="cuda", dtype=tok_spec.dtype)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = {k: torch.zeros((s.shape[0], B, cap, *s.shape[3:]),
                            dtype=s.dtype, device="cuda")
             for k, s in specs.items()}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pre = steps.make_prefill_step(cfg)(params, {"tokens": tokens[:, :P]})
    M.write_contiguous_kv(cfg, cache, pre["kvs"])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first = pre["next_logits"]
    del pre
    decode = steps.make_decode_step(cfg)
    logits, step_s = [], []
    for i in range(n):
        batch = {"tokens": tokens[:, P + i:P + i + 1],
                 "positions": torch.full((B,), P + i, dtype=torch.int32,
                                         device="cuda")}
        t0 = time.perf_counter()
        out = decode(params, batch, cache)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        check(out["next_token"].dtype == torch.int32
              and out["hidden"].shape == (B, cfg.d_model),
              "launch_steps: decode outputs")
        logits.append(out["logits"])
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    del cache
    with torch.no_grad():
        ref = M.forward_full(params, cfg, tokens)["logits"]
    V = cfg.vocab_size
    errs, within, agree, near_ties = [], 0, 0, 0
    for i, got in enumerate([first] + logits):
        got = got[:, :V].float()
        want = ref[:, P - 1 + i, :V].float()
        check(bool(torch.isfinite(got).all()), f"launch_steps step {i}: "
              "non-finite logits")
        err = (got - want).abs().max().item()
        amax = want.abs().max().item()
        check(err <= PATHS_LOGIT_TOL * amax,
              f"launch_steps step {i}: logits err {err} vs max {amax}")
        errs.append(err)
        top2 = want.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * err
        same = got.argmax(-1) == want.argmax(-1)
        check(bool(same[clear].all()),
              f"launch_steps step {i}: greedy token differs off a near tie")
        agree += int(same.sum())
        near_ties += int((~clear).sum())
        within += int(torch.isclose(got, want, **BF16_TOL).sum())
    del ref
    weight_bytes = 2 * rt["init"].count_params(params)
    # each step reads the weights once and each lane's live K/V slots,
    # and writes one slot per layer and lane
    kv_slot = 2 * cfg.num_kv_heads * cfg.head_dim * 2 * cfg.num_layers
    live = [B * (P + i + 1) * kv_slot for i in range(n)]
    bound = [(weight_bytes + b) / HBM_BYTES_PER_S * 1e3 for b in live]
    ms = [s * 1e3 for s in step_s]
    out = {"shape": f"B={B} capacity={cap} (decode_32k cut from "
                    f"B={specs['k_cache'].shape[1]} x "
                    f"{specs['k_cache'].shape[2]}), prompt {P}, {n} steps, "
                    f"bf16",
           "cache_bytes": cache_bytes, "prefill_s": prefill_s,
           "decode_ms_per_step": sum(ms[1:]) / (n - 1),
           "decode_ms_first": ms[0], "bound_ms_per_step": sum(bound) / n,
           "bound_share": sum(bound[1:]) / sum(ms[1:]),
           "launches": {k: v for k, v in launches.items() if v},
           "max_memory_allocated": peak,
           "logits_max_abs_err": max(errs),
           "logits_max_abs_err_by_step": errs[::8],
           "share_within_bf16_tolerance": within / (B * (n + 1) * V),
           "argmax_agreement": agree / (B * (n + 1)),
           "near_ties": near_ties}
    emit("launch_steps", **out)
    return out


def phase_roofline_decode(rt, cfg, params):
    """One ``make_decode_step`` call at launch_steps' shape (B
    ``LAUNCH_B``, a ``LAUNCH_CAPACITY``-slot contiguous cache, at position
    ``LAUNCH_PROMPT``; no mesh), counted by ``launch.cost_analysis``: its
    flops, the bytes of its eager ops and the roofline terms at the
    H100's datasheet peaks (counts, not measurements), beside the same
    call's device ms (torch.profiler, L2 warm) and wall ms (synchronised,
    mean of ``ROOFLINE_REPS``). Their gap says how much of the step the
    host takes."""
    from repro_torch.launch import cost_analysis as ca
    from repro_torch.launch import steps
    Reg = rt["registry"]
    B, cap = LAUNCH_B, LAUNCH_CAPACITY
    specs = Reg.kv_cache_specs(cfg, "decode_32k")
    cache = {k: torch.zeros((s.shape[0], B, cap, *s.shape[3:]),
                            dtype=s.dtype, device="cuda")
             for k, s in specs.items()}
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                                     device="cuda", dtype=torch.int32),
             "positions": torch.full((B,), LAUNCH_PROMPT, dtype=torch.int32,
                                     device="cuda")}
    decode = steps.make_decode_step(cfg)

    def call():
        return decode(params, batch, cache)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cost = ca.op_cost(call)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    terms = ca.roofline_terms(cost["flops"], cost["bytes"],
                              cost["collective_bytes"])
    t0 = time.perf_counter()
    for _ in range(ROOFLINE_REPS):
        call()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / ROOFLINE_REPS * 1e3
    split = kernel_breakdown(call)
    device_ms = split["device_ms"] if isinstance(split, dict) else None
    weight_bytes = 2 * rt["init"].count_params(params)
    kv_slot = 2 * cfg.num_kv_heads * cfg.head_dim * 2 * cfg.num_layers
    bound = (weight_bytes + B * (LAUNCH_PROMPT + 1) * kv_slot) \
        / HBM_BYTES_PER_S * 1e3
    check(cost["flops"] > 0 and cost["bytes"] > 0,
          "roofline_decode: nothing counted")
    out = {"shape": f"B={B} capacity={cap} position {LAUNCH_PROMPT}, bf16",
           "counted": {"flops": cost["flops"], "bytes": cost["bytes"],
                       "ops": cost["ops"],
                       "peak_live_bytes": cost["peak_live_bytes"],
                       "count_s": count_s},
           "roofline_ms": {"compute": terms["t_compute_s"] * 1e3,
                           "memory": terms["t_memory_s"] * 1e3,
                           "dominant": terms["dominant"]},
           "bound_ms": bound, "device_ms": device_ms, "wall_ms": wall_ms,
           "host_share": (1 - device_ms / wall_ms) if device_ms else None,
           "breakdown": split}
    del cache
    emit("roofline_decode", **out)
    return out


DRYRUN_RECORDS = [("qwen3-4b-thinking", shape, mesh)
                  for mesh in ("pod16x16", "pod2x16x16")
                  for shape in ("train_4k", "prefill_32k", "decode_32k",
                                "long_500k")] \
    + [("granite-20b", "train_4k", "pod2x16x16")]
# the child's two runs of the dry-run CLI
DRYRUN_ARGV = (["--arch", "qwen3-4b-thinking", "--both-meshes"],
               ["--arch", "granite-20b", "--shape", "train_4k",
                "--multi-pod"])


def dryrun_record(arch, shape, mesh) -> Path:
    from repro_torch.launch import dryrun
    return Path(dryrun.OUT_DIR) / f"{arch}__{shape}__{mesh}.json"


def stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def start_dryrun():
    """Start the production dry run (``DRYRUN_ARGV``, one CLI run after
    the other) in a child process on the host's CPU (one thread; no
    card), beside the phases on the card, its earlier records deleted
    first. Returns the process; it is killed at exit if it still runs."""
    for rec in DRYRUN_RECORDS:
        dryrun_record(*rec).unlink(missing_ok=True)
    out_dir = dryrun_record(*DRYRUN_RECORDS[0]).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    runs = " | ".join(f"dryrun.main({argv!r})" for argv in DRYRUN_ARGV)
    with open(out_dir / "dryrun.log", "w") as log:   # DTensor's warnings
        proc = subprocess.Popen(
            [sys.executable, "-c", "import sys\n"
             "from repro_torch.launch import dryrun\n"
             f"sys.exit({runs})"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=log, text=True)
    atexit.register(stop, proc)
    pin_apart(proc)
    return proc


def pin_apart(proc) -> None:
    """Keep the child off the cores that this process's timed host work
    runs on: the child gets the last core this process may use, and
    every thread of this process (and what it starts later: nvcc, the
    serving ranks) the others."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 2:
        return
    os.sched_setaffinity(proc.pid, {cores[-1]})
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), set(cores[:-1]))
        except OSError:     # a thread that has ended
            pass


def phase_dryrun(proc):
    """Wait for the dry run (``start_dryrun``; until ``DRYRUN_DEADLINE_S``
    after the script's start at most) and check its records: each (arch,
    shape, mesh) of ``DRYRUN_RECORDS`` is ``ok``. Prints each record's
    status, dominant term, per-device GiB and trace seconds, both runs'
    summary lines and the seconds waited."""
    t0 = time.perf_counter()
    try:
        out, _ = proc.communicate(
            timeout=max(10.0, START + DRYRUN_DEADLINE_S - t0))
    finally:
        stop(proc)
    waited = time.perf_counter() - t0
    records = []
    for arch, shape, mesh in DRYRUN_RECORDS:
        path = dryrun_record(arch, shape, mesh)
        check(path.exists(), f"dryrun: no record for {arch} {shape} {mesh}")
        rec = json.loads(path.read_text())
        check(rec["status"] == "ok", f"dryrun {arch} {shape} {mesh}: "
              f"{rec['status']} {rec.get('reason')}")
        records.append({k: rec.get(k) for k in (
            "arch", "shape", "mesh", "status", "dominant",
            "per_device_hbm_gib",
            "trace_s", "hlo_flops_per_dev", "hlo_bytes_per_dev",
            "collective_bytes_per_dev", "t_compute_s", "t_memory_s",
            "t_collective_s", "useful_flops_ratio")})
    check(proc.returncode == 0, f"dryrun: exit code {proc.returncode}")
    emit("dryrun", records=records,
         summary=[line for line in out.splitlines()
                  if line.startswith("dry-run:")], waited_s=waited)
    return records


def phase_launch_train(rt):
    """``launch.train.main`` at full width (qwen3-4b-thinking, 36 layers),
    B 8 of 128 tokens in 4 microbatches of 2, every layer checkpointed:
    its own bf16 params, f32 moments and f32 gradient accumulator (64 GB
    before activations), with no other model resident. The losses are
    finite and the params are left without ``requires_grad``."""
    from repro_torch.launch import train
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    hist = train.main(["--arch", "qwen3-4b-thinking", "--steps", "3",
                       "--batch", "8", "--seq", "128", "--microbatches",
                       "4"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses),
          f"launch_train losses {losses}")
    gc.collect()
    torch.cuda.empty_cache()
    out = {"shape": "B=8 seq=128 in 4 microbatches, remat, AdamW lr 1e-3, "
                    "f32 moments and accumulator",
           "losses": losses, "step_s": [h["step_s"] for h in hist],
           "wall_s": wall, "max_memory_allocated": peak,
           "memory_allocated_at_start": at_start,
           "memory_allocated_after": torch.cuda.memory_allocated()}
    emit("launch_train", **out)
    return out


# ---------------------------------------------------------------------------
# serve_mesh: the mesh engine, its ranks sharing the one card
# ---------------------------------------------------------------------------

# (backend, (data, model)): NCCL takes one rank per card, so two ranks on
# the one card go over gloo (which carries CUDA tensors through the host)
MESH_RUNS = (("nccl", (1, 1)), ("gloo", (1, 2)), ("gloo", (2, 1)))
MESH_JOBS = {
    # the smoke config in f32, EOS suppressed (the pool fills, STEP prunes)
    "smoke": dict(traces=8, max_new=40, chunk=4, blocks=16, capacity=128,
                  kv_dtype="f32"),
    # qwen3 at full width in bf16
    "full": dict(traces=16, max_new=64, chunk=8, blocks=80, capacity=512,
                 kv_dtype="bf16"),
}
MESH_DEVICE = "cuda:0"
# two ranks against one device: f32 step scores, and the first decode
# iteration's bf16 logits relative to their largest magnitude
MESH_SCORE_TOL = 1e-4
MESH_LOGIT_TOL = PATHS_LOGIT_TOL


def runtime() -> dict:
    """The port's modules the phases drive, by short name."""
    import importlib
    names = {"registry": "configs.registry", "init": "models.init",
             "scorer": "core.scorer", "pruning": "core.pruning",
             "engine": "serving.engine", "evaluate": "serving.evaluate",
             "sampling": "serving.sampling", "tokenizer": "data.tokenizer",
             "arithmetic": "data.arithmetic", "model": "models.model",
             "kv_quant": "models.kv_quant", "trainer": "training.trainer",
             "optimizer": "training.optimizer", "tree": "training.tree",
             "dataset": "data.dataset", "pipeline": "core.pipeline",
             "layers": "models.layers", "ops": "kernels.ops",
             "mesh": "launch.mesh"}
    return {k: importlib.import_module(f"repro_torch.{v}")
            for k, v in names.items()}


def mesh_serve(rt, job: str, mesh=None) -> dict:
    """One greedy STEP serve of ``job`` on the card through the kernels:
    the single-device engine (``mesh`` None) or this rank's mesh engine.
    Both run the eager horizon and the dense scorer (as a mesh engine
    does), so the (1, 1) mesh can be held to the single engine bit for
    bit. Records the first decode iteration's logits, the launches, the
    wall per decode iteration and the peak memory."""
    E, spec = rt["engine"], MESH_JOBS[job]
    tok = rt["tokenizer"].get_tokenizer()
    if job == "smoke":
        cfg = rt["registry"].serving_config()
        g = torch.Generator(device="cuda").manual_seed(SEED)
        params = no_eos(to_f32(rt["init"].init_params(cfg, g)), cfg,
                        tok.eos_id)
        scorer = rt["scorer"].init_scorer(g, cfg.d_model)
        prompt = tok.encode("3+5-2=", add_bos=True)
    else:
        cfg, params, scorer, _, _ = full_model(rt)
        problem = rt["evaluate"].make_problems(1, seed=SEED)[0]
        prompt = tok.encode(rt["arithmetic"].make_prompt(problem),
                            add_bos=True)
    B = spec["traces"]
    ecfg = E.EngineConfig(max_batch=B, num_blocks=spec["blocks"],
                          capacity=spec["capacity"],
                          max_new_tokens=spec["max_new"],
                          sampling=greedy(rt, spec["max_new"]),
                          use_kernel=True, decode_horizon=4,
                          prefill_chunk_size=spec["chunk"], faults=None,
                          kv_dtype=spec["kv_dtype"])
    engine = E.Engine(params, cfg, ecfg, rt["pruning"].make_policy("step"),
                      scorer_params=scorer, mesh=mesh, device=MESH_DEVICE,
                      _eager_decode=True)
    engine.fused_scorer = False
    del params
    gc.collect()
    torch.cuda.empty_cache()
    seen = {"iterations": 0, "host": False}
    sample, host = E.sample_logits, engine.sample_host

    def recording(g, logits, **kw):   # each decode iteration samples once
        if not seen["host"]:
            seen["iterations"] += 1
            seen.setdefault("logits", logits.float().cpu())
        return sample(g, logits, **kw)

    def host_sampling(logits, sp):    # a prefill's first tokens
        seen["host"] = True
        try:
            return host(logits, sp)
        finally:
            seen["host"] = False

    engine.sample_host = host_sampling

    ops = rt["ops"]
    E.sample_logits = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = engine.serve(prompt, B)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        E.sample_logits = sample
    check_result(res, engine)
    iters = max(seen["iterations"], 1)
    return {"tokens": [t.output_tokens for t in res.traces],
            "scores": [t.step_scores for t in res.traces],
            "statuses": [str(t.status) for t in res.traces],
            "num_pruned": res.num_pruned, "logits": seen["logits"],
            "launches": launches, "use_kernel": engine.use_kernel,
            "decode_iterations": iters, "wall_s": wall,
            "wall_ms_per_iteration": wall / iters * 1e3,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def mesh_rank(rank: int, world: int, backend: str, shape: tuple,
              path: str) -> None:
    """One rank of a ``shape`` mesh over ``backend`` (a file store in
    ``path``): every job of ``MESH_JOBS``, written to ``rank<r>.pt``."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a rank left waiting in a collective fails after 5 minutes, not never
    dist.init_process_group(
        backend, init_method=f"file://{path}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300),
        device_id=torch.device("cuda", 0) if backend == "nccl" else None)
    try:
        rt = runtime()
        mesh = rt["mesh"].make_host_mesh(*shape)
        out = {job: mesh_serve(rt, job, mesh) for job in MESH_JOBS}
        torch.save(out, os.path.join(path, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def leading_agreement(a: list, b: list) -> int:
    """How many leading tokens two traces share."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def phase_serve_mesh(rt):
    """The mesh engine on the card: a (1, 1) mesh over NCCL held to the
    single-device engine bit for bit, then two ranks over gloo at (1, 2)
    and (2, 1), both at the smoke config in f32 (tokens, statuses and
    prunes identical, step scores within ``MESH_SCORE_TOL``) and at full
    width in bf16 (the first decode iteration's logits within
    ``MESH_LOGIT_TOL`` of their largest magnitude; token agreement
    reported). Every rank must launch K1a, and K1b for the chunked
    prefills, and capture no graph. The ranks share one card and gloo
    stages through the host: the walls and peaks are no speed figures."""
    import shutil
    import torch.multiprocessing as mp
    base = ROOT / "build" / "serve_mesh"
    shutil.rmtree(base, ignore_errors=True)
    single = {job: mesh_serve(rt, job) for job in MESH_JOBS}
    gc.collect()
    torch.cuda.empty_cache()
    out = {"single": {job: {k: r[k] for k in (
        "decode_iterations", "wall_ms_per_iteration",
        "max_memory_allocated", "num_pruned")}
        for job, r in single.items()}, "meshes": {}}
    decode_mesh = prefill_mesh = 0
    for backend, shape in MESH_RUNS:
        key = f"{shape[0]}x{shape[1]}"
        world = shape[0] * shape[1]
        path = base / key
        path.mkdir(parents=True)
        t0 = time.perf_counter()
        mp.spawn(mesh_rank, args=(world, backend, shape, str(path)),
                 nprocs=world, join=True)
        entry = {"backend": backend, "spawn_s": time.perf_counter() - t0}
        ranks = [torch.load(path / f"rank{r}.pt", weights_only=False)
                 for r in range(world)]
        for job, spec in MESH_JOBS.items():
            want = single[job]
            live = torch.isfinite(want["logits"])   # the vocab, not its pad
            amax = want["logits"][live].abs().max().item()
            rows = []
            for r, got in enumerate(r_[job] for r_ in ranks):
                name = f"serve_mesh {key} {job} rank {r}"
                lt = got["launches"]
                check(got["use_kernel"], f"{name}: not on the kernel path")
                check(k1a_launches(lt) > 0, f"{name}: K1a never launched")
                check(k1b_launches(lt) > 0,
                      f"{name}: K1b never launched in the chunked prefill")
                check(lt["decode_graph_captures"] == 0
                      and lt["step_score"] == 0,
                      f"{name}: a graph or the fused scorer on a mesh")
                # the fused glue on one rank in bf16 (as the single
                # engine), the chain where ranks split the work or in f32
                glue = lt["add_rms_norm"] + lt["attn_prologue"]
                check((glue > 0) == (world == 1 and job == "full"),
                      f"{name}: decode glue launches {glue} on the wrong "
                      f"route")
                check(torch.equal(torch.isfinite(got["logits"]), live),
                      f"{name}: non-finite logits")
                logit_err = (got["logits"] - want["logits"])[live].abs() \
                    .max().item()
                score_err = max((abs(a - b) for sg, sw in
                                 zip(got["scores"], want["scores"])
                                 for a, b in zip(sg, sw)), default=0.0)
                same = (got["tokens"] == want["tokens"]
                        and got["statuses"] == want["statuses"]
                        and got["num_pruned"] == want["num_pruned"])
                bitwise = (same and got["scores"] == want["scores"]
                           and logit_err == 0.0)
                if world == 1:
                    check(bitwise, f"{name}: differs from the single-device "
                          f"engine (logits {logit_err}, scores {score_err})")
                elif job == "smoke":
                    check(same, f"{name}: tokens, statuses or prunes differ "
                          f"from the single-device engine")
                    check(score_err <= MESH_SCORE_TOL,
                          f"{name}: step scores differ by {score_err}")
                else:
                    check(logit_err <= MESH_LOGIT_TOL * amax,
                          f"{name}: first-iteration logits differ by "
                          f"{logit_err} (largest |logit| {amax})")
                agree = [leading_agreement(a, b) for a, b in
                         zip(got["tokens"], want["tokens"])]
                rows.append({
                    "launches": {k: v for k, v in lt.items() if v},
                    "bitwise": bitwise,
                    "tokens_statuses_prunes_identical": same,
                    "max_first_logit_err": logit_err,
                    "max_step_score_err": score_err,
                    "traces_identical": sum(a == b for a, b in
                                            zip(got["tokens"],
                                                want["tokens"])),
                    "leading_tokens_agreeing": sum(agree),
                    "tokens": sum(len(t) for t in want["tokens"]),
                    "num_pruned": got["num_pruned"],
                    "decode_iterations": got["decode_iterations"],
                    "wall_ms_per_iteration": got["wall_ms_per_iteration"],
                    "max_memory_allocated": got["max_memory_allocated"]})
                if key == "1x2" and job == "full":
                    decode_mesh += lt[K1A[0]]
                    prefill_mesh += lt["paged_attention_prefill_wgmma"]
            entry[job] = {"largest_first_logit": amax, "ranks": rows}
        out["meshes"][key] = entry
    out["tolerances"] = {"score_two_ranks": MESH_SCORE_TOL,
                         "first_logits_two_ranks_relative": MESH_LOGIT_TOL,
                         "one_rank": "bitwise"}
    emit("serve_mesh", **out)
    return {K1A[0]: decode_mesh,
            "paged_attention_prefill_wgmma": prefill_mesh}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    rt = runtime()
    from repro_torch.kernels import decode_glue as gl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as sd
    from repro_torch.kernels import ssm_decode as smd
    from repro_torch.kernels import step_score as ss
    kvq = rt["kv_quant"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = phase_device()
    dryrun_proc = start_dryrun()
    phase_build(ops)
    errs = phase_kernels(pa, ss, fa, sd, kvq, smd, gl, rt["layers"])
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
    phase_serve_sampled(rt, ops, cfg, params, scorer)
    forward = phase_forward_kernel(rt, ops, cfg, params)
    phase_train(rt, ops, cfg, params)
    times = phase_times(pa, ss, fa, sd, kvq, smd, gl, rt["layers"])
    phase_step(rt, cfg, params)
    phase_launch_steps(rt, ops, cfg, params)
    phase_roofline_decode(rt, cfg, params)

    # the training launcher at full width once qwen3's params are freed
    # (its own params, moments and accumulator take 64 GB), then the
    # serving launcher; then mamba2 (the train phase peaks at 74 GB of the
    # 80)
    del params, scorer
    gc.collect()
    torch.cuda.empty_cache()
    mesh_run = phase_serve_mesh(rt)
    phase_launch_train(rt)
    launch = phase_launch_serve(rt, ops)
    phase_examples(ops)
    recurrent = {}
    for arch, tag in (("mamba2-2.7b", "mamba2"), ("zamba2-2.7b", "zamba2")):
        mcfg, mparams, mscorer, n_params, init_s = full_model(rt, arch)
        emit("model", name=mcfg.name, layers=mcfg.num_layers,
             d_model=mcfg.d_model, params=n_params, init_s=init_s)
        serve_run = phase_serve_recurrent(rt, ops, mcfg, mparams, mscorer,
                                          f"serve_{tag}")
        phase_smoke_reference(rt, arch=arch)
        if tag == "zamba2":
            phase_kernel_vs_dense(rt, ops, mcfg, mparams, mscorer,
                                  "kernel_vs_dense_zamba2")
        forward_run = phase_forward_recurrent(
            rt, ops, mcfg, mparams,
            "forward_ssd" if tag == "mamba2" else "forward_zamba2")
        phase_step(rt, mcfg, mparams, f"step_{tag}")
        recurrent[tag] = (serve_run, forward_run)
        del mparams, mscorer
        gc.collect()
        torch.cuda.empty_cache()
    serve_ssm, forward_ssd = recurrent["mamba2"]
    serve_hyb, forward_hyb = recurrent["zamba2"]
    dense = phase_dense_archs(rt, ops)

    # mixtral-8x7b at full width, 16 of its 32 layers (47 GB of bf16
    # weights; all 32 would take 93 GB)
    xcfg, xparams, xscorer, n_params, init_s = full_model(
        rt, "mixtral-8x7b", layers=MIXTRAL_LAYERS)
    emit("model", name=xcfg.name, layers=xcfg.num_layers,
         d_model=xcfg.d_model, params=n_params, init_s=init_s)
    serve_moe = phase_serve(rt, ops, xcfg, xparams, xscorer,
                            name="serve_mixtral")
    phase_smoke_reference(rt, arch="mixtral-8x7b", window=8, chunk=4,
                          prompt=WINDOW_PROMPT)
    batched_moe = phase_batched_mixtral(rt, ops, xcfg, xparams, xscorer)
    forward_moe = phase_forward_mixtral(rt, ops, xcfg, xparams)
    phase_step(rt, xcfg, xparams, "step_mixtral")
    del xparams, xscorer
    gc.collect()
    torch.cuda.empty_cache()

    # deepseek-v2-236b at full width, 8 of its 60 layers (65.7 GB of bf16
    # weights), after mixtral's are freed
    dcfg, dparams, dscorer, n_params, init_s = full_model(
        rt, "deepseek-v2-236b", layers=DEEPSEEK_LAYERS)
    emit("model", name=dcfg.name, layers=dcfg.num_layers,
         d_model=dcfg.d_model, params=n_params, init_s=init_s)
    phase_serve(rt, ops, dcfg, dparams, dscorer, name="serve_deepseek")
    phase_reference_deepseek(rt)
    phase_mla_layer(rt, dcfg, dparams)
    phase_step(rt, dcfg, dparams, "step_deepseek")
    del dparams, dscorer
    gc.collect()
    torch.cuda.empty_cache()

    # seamless-m4t-large-v2 at full depth (24 encoder and 24 decoder
    # layers, 4.07 GB of bf16 weights)
    scfg, sparams, _, n_params, init_s = full_model(
        rt, "seamless-m4t-large-v2")
    emit("model", name=scfg.name, layers=scfg.num_layers,
         encoder_layers=scfg.num_encoder_layers, d_model=scfg.d_model,
         params=n_params, init_s=init_s)
    forward_s2s = phase_forward_seamless(rt, ops, scfg, sparams)
    decode_s2s = phase_decode_seamless(rt, ops, scfg, sparams)
    del sparams
    gc.collect()
    torch.cuda.empty_cache()
    phase_dryrun(dryrun_proc)

    # (source, TPU kernel, error key, launches on the main path)
    src = "src/repro_torch/csrc/"
    paged = (src + "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:62")
    # K1a/K1c's decode rows: the cluster face, the main paths' decode
    cluster = (src + "paged_decode.cu",
               "src/repro/kernels/paged_attention.py:62")
    meta = {
        "paged_attention_decode": (*cluster, "decode_bfloat16",
                                   serve["launches"][K1A[0]]
                                   + batched["launches"][K1A[0]]),
        "paged_attention_prefill": (*paged, "prefill_bfloat16",
                                    batched["launches"][
                                        "paged_attention_prefill_wgmma"]),
        "step_score": (src + "step_score.cu",
                       "src/repro/kernels/step_score.py:30",
                       "score_bfloat16",
                       serve["launches"]["step_score"]
                       + batched["launches"]["step_score"]
                       + serve_ssm["launches"]["step_score"]
                       + serve_hyb["launches"]["step_score"]),
        # mixtral-8x7b's decode (timed and checked at batched_mixtral's
        # 288-page rows), windowed paths and width
        "paged_attention_decode_mixtral": (
            *cluster, "decode_mixtral_bfloat16",
            serve_moe["launches"][K1A[0]]
            + batched_moe["launches"][K1A[0]]),
        "paged_attention_prefill_swa": (
            *paged, "prefill_swa_bfloat16",
            batched_moe["launches"]["paged_attention_prefill_wgmma"]),
        "flash_attention_swa": (src + "flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:38",
                                "flash_swa_bfloat16",
                                forward_moe["launches"]["flash_attention"]),
        # seamless-m4t's decoder: 16 query heads over 16 at hd 64
        "paged_attention_decode_seamless": (
            *cluster, "decode_seamless_bfloat16",
            decode_s2s["launches"][K1A[0]]),
        "flash_attention_seamless": (src + "flash_attention.cu",
                                     "src/repro/kernels/flash_attention.py:38",
                                     "flash_seamless_bfloat16",
                                     forward_s2s["launches"][
                                         "flash_attention"]),
        "step_score_d4096": (src + "step_score.cu",
                             "src/repro/kernels/step_score.py:30",
                             "score_d4096_bfloat16",
                             serve_moe["launches"]["step_score"]
                             + batched_moe["launches"]["step_score"]),
        "flash_attention": (src + "flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:38",
                            "flash_bfloat16",
                            forward["launches"]["flash_attention"]),
        "ssd_scan": (src + "ssd_wgmma.cu",
                     "src/repro/kernels/ssd_scan.py:40", "ssd_scan",
                     forward_ssd["launches"]["ssd_scan_wgmma"]),
        # no Pallas counterpart: the reference leaves this step to XLA's
        # fusion inside its jitted decode horizon
        "ssm_decode": (src + "ssm_decode.cu",
                       "none (XLA fusion of src/repro/models/layers.py:1120)",
                       "ssm_decode_bfloat16",
                       serve_ssm["launches"]["ssm_decode"]),
        # the instances of this slice's paths: zamba2 (hd 80, N = 64) and
        # granite-20b (48 query heads over one kv head)
        "paged_attention_decode_hd80": (
            *cluster, "decode_hd80_bfloat16",
            serve_hyb["launches"][K1A[0]]),
        "paged_attention_decode_g48": (
            *cluster, "decode_g48_bfloat16",
            dense["granite-20b"]["launches"][K1A[0]]),
        # a rank of serve_mesh's (1, 2) mesh (half of qwen3's heads), its
        # launches on both ranks at full width
        "paged_attention_decode_mesh": (
            *cluster, "decode_mesh_bfloat16",
            mesh_run[K1A[0]]),
        "paged_attention_prefill_mesh": (
            *paged, "prefill_mesh_bfloat16",
            mesh_run["paged_attention_prefill_wgmma"]),
        "flash_attention_hd80": (src + "flash_attention.cu",
                                 "src/repro/kernels/flash_attention.py:38",
                                 "flash_hd80_bfloat16",
                                 forward_hyb["launches"]["flash_attention"]),
        "ssd_scan_zamba2": (src + "ssd_wgmma.cu",
                            "src/repro/kernels/ssd_scan.py:40",
                            "ssd_scan_zamba2",
                            forward_hyb["launches"]["ssd_scan_wgmma"]),
        "ssm_decode_zamba2": (
            src + "ssm_decode.cu",
            "none (XLA fusion of src/repro/models/layers.py:1120)",
            "ssm_decode_zamba2_bfloat16", serve_hyb["launches"]["ssm_decode"]),
    }
    # the decode glue: no Pallas counterpart either (XLA fuses the norms,
    # RoPE, the paged K/V write and the gate inside the jitted horizon);
    # qwen3's launches on serve and batched, mixtral's on its two phases
    glue_src = src + "decode_glue.cu"
    for kernel, replaces in (
            ("add_rms_norm", "none (XLA fusion of the residual adds and "
                             "src/repro/models/layers.py:23)"),
            ("attn_prologue", "none (XLA fusion in "
                              "src/repro/models/layers.py:352)"),
            ("silu_mul", "none (XLA fusion of "
                         "src/repro/models/layers.py:68 and :930)")):
        moe = "silu_mul_expert" if kernel == "silu_mul" else \
            f"{kernel}_mixtral"
        meta[kernel] = (glue_src, replaces, f"{kernel}_qwen3",
                        serve["launches"][kernel]
                        + batched["launches"][kernel])
        meta[moe] = (glue_src, replaces, f"{kernel}_mixtral",
                     serve_moe["launches"][kernel]
                     + batched_moe["launches"][kernel])
    # the serving launcher's model (H 4, KVH 2, hd 64, D 256) on
    # launch_serve's runs
    lt = launch["launches"]
    for face, count in (("decode", K1A[0]),
                        ("prefill", "paged_attention_prefill_wgmma"),
                        ("decode_int8", K1C_DECODE[0]),
                        ("prefill_int8",
                         "paged_attention_prefill_quant_wgmma")):
        meta[f"paged_attention_{face}_launch"] = (
            *(cluster if face.startswith("decode") else paged),
            f"{face}_launch_bfloat16", lt[count])
    meta["step_score_d256"] = (src + "step_score.cu",
                               "src/repro/kernels/step_score.py:30",
                               "score_d256_bfloat16", lt["step_score"])
    for kv_dtype, run in quant.items():
        for face, count in (("decode", "decode_quant_cluster"),
                            ("prefill", "prefill_quant_wgmma")):
            meta[f"paged_attention_{face}_{kv_dtype}"] = (
                *(cluster if face == "decode" else paged),
                f"{face}_{kv_dtype}_bfloat16",
                run["launches"][f"paged_attention_{count}"])
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
