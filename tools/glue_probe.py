"""The decode layer's glue on the card, chain against fused: build
``csrc/decode_glue.cu`` and print its registers and spills; hold each
kernel to the chain of PyTorch ops it replaces at the two STEP cells'
shapes (qwen3-4b-thinking: 64 lanes, D 2560, 32/8 heads of 128,
qk-norm, F 9728; mixtral-8x7b: D 4096, no qk-norm, the MoE's writer,
the expert gate over 8 x 64 x 14336); time each kernel beside its plain
version and its byte bound (``chip_smoke.py``'s ``time_cuda``: one graph
replay, cold L2); time one layer's glue as the chain and as the fused
kernels, with the kernels each makes; then capture a whole decode
horizon of 4 at full depth (qwen3's 36 layers, mixtral's 16) with the
cells' sampler (temperature 0.6, top-k 20, top-p 0.95) and the step
scorer, on both routes, and give each graph's kernels and device ms per
iteration.

    python3 tools/glue_probe.py              # everything (~3 min)
    python3 tools/glue_probe.py --no-horizon # the kernels and one layer

on a machine with one CUDA card, from the root of a checkout. It prints
the card, then one JSON line per check and per timed row, and exits 1 if
a kernel parts from the chain by more than the card tests allow
(``tests/test_torch_cuda_glue.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.scorer import init_scorer  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import decode_glue as G  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.serving.sampling import sample_logits  # noqa: E402
from torch_glue_cases import (BF16, EPS, SHAPES, bits_apart,  # noqa: E402
                              prologue_args, prologue_case, prologue_chain,
                              randn, rotated_within, within_one_ulp)

HBM = 3.35e12
B = 64
# cell -> (glue shape name, F, the expert gate's shape or None, config,
# layers in the cell)
CELLS = {"qwen3-4b.step-n64": ("qwen3", 9728, None, "qwen3-4b-thinking", 36),
         "mixtral-8x7b.step-n64": ("mixtral", 14336, (8, 64, 14336),
                                   "mixtral-8x7b", 16)}
FAILED = []


def emit(kind: str, **fields) -> None:
    print(json.dumps({"probe": kind, **fields}), flush=True)


def ms(t) -> dict:
    return {"ms": round(float(t), 5), "lo": round(t.lo, 5),
            "hi": round(t.hi, 5)}


def graph_kernels(fn) -> int:
    """Device operations in one replay of ``fn`` captured as a graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        graph.replay()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    return sum(e.device_type() == torch.autograd.DeviceType.CUDA
               for e in events)


def phase_build() -> None:
    log = build.build_all(["decode_glue"])["decode_glue"]
    regs = re.findall(r"Function properties for (\S+)\n(.*?)\n.*?Used (\d+)"
                      r" registers", log, flags=re.S)
    emit("build", kernels=[{"function": f, "spills": s.strip(),
                            "registers": int(r)} for f, s, r in regs])


def check(name: str, ok: bool, **fields) -> None:
    emit("check", case=name, ok=ok, **fields)
    if not ok:
        FAILED.append(name)


def phase_checks() -> None:
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in ((B, 9728), (8, 64, 14336), (5, 33)):
        gt, ut = randn(g, *shape, scale=4), randn(g, *shape)
        check(f"silu_mul {shape}", torch.equal(
            ops.silu_mul(gt, ut), F.silu(gt.float()).to(BF16) * ut))
    for name in ("qwen3", "mixtral"):
        D = SHAPES[name][3]
        h, d, w = randn(g, B, D), randn(g, B, D), randn(g, D, scale=0.1) + 1
        h2, y = ops.add_rms_norm(h, d, w, EPS)
        apart = bits_apart(y, L.rms_norm(h + d, w, EPS))
        check(f"add_rms_norm {name}", torch.equal(h2, h + d)
              and int(apart.max()) <= 1,
              one_ulp_share=float((apart > 0).float().mean()))
        for case in ("origin", "frozen", "wrap", "writer"):
            c = prologue_case(name, case, g)
            want = [p.clone() for p in c["pools"]]
            want_q, want_lens = prologue_chain(c, want)
            lens = torch.empty_like(want_lens)
            q = ops.attn_prologue(*prologue_args(c, c["pools"], lens))
            rows = slice(1, None) if case == "frozen" else slice(None)
            close = within_one_ulp if case == "origin" else rotated_within
            try:
                shares = (close(q, want_q, 1.0),
                          close(c["pools"][0][rows], want[0][rows], 1.0))
                ok = (torch.equal(lens, want_lens) and torch.equal(
                    c["pools"][1][rows], want[1][rows]))
            except AssertionError as e:
                shares, ok = (str(e), None), False
            check(f"attn_prologue {name} {case}", ok, q_apart=shares[0],
                  k_apart=shares[1])


def layer_glue(name: str, F_: int, expert_shape, g):
    """One decode layer's glue at a cell's shape as (chain, fused): the
    residual add and ln1, the prologue, the residual add and ln2, the
    SwiGLU gate (the expert gate's shape for the MoE). The products'
    outputs are fixed random tensors, the pool a shuffled one of 64 x 17
    pages."""
    H, KVH, hd, D, qk_norm, theta = SHAPES[name]
    c = prologue_case(name, "writer" if expert_shape else "plain", g)
    h, d1, d2 = (randn(g, B, D) for _ in range(3))
    ln1, ln2 = randn(g, D, scale=0.1) + 1, randn(g, D, scale=0.1) + 1
    gate_shape = expert_shape or (B, F_)
    gt, ut = randn(g, *gate_shape), randn(g, *gate_shape)
    table = G.rope_table(hd, theta, "cuda")
    lens = torch.empty((B,), dtype=torch.int32, device="cuda")

    def chain():
        h1 = h + d1
        L.rms_norm(h1, ln1, EPS)
        prologue_chain(c, c["pools"])
        L.rms_norm(h1 + d2, ln2, EPS)
        return F.silu(gt.float()).to(BF16) * ut

    def fused():
        h1, _ = ops.add_rms_norm(h, d1, ln1, EPS)
        ops.attn_prologue(*prologue_args(c, c["pools"], lens, table))
        ops.add_rms_norm(h1, d2, ln2, EPS)
        return ops.silu_mul(gt, ut)

    rows = {
        "add_rms_norm": (lambda: ops.add_rms_norm(h, d1, ln1, EPS),
                         lambda: G.add_rms_norm_plain(h, d1, ln1, EPS),
                         (4 * B * D + D) * 2),
        "attn_prologue": (
            lambda: ops.attn_prologue(*prologue_args(c, c["pools"], lens,
                                                     table)),
            lambda: G.attn_prologue_plain(*prologue_args(c, c["pools"], lens,
                                                         table)),
            2 * B * (2 * H + 4 * KVH) * hd + 4 * hd + 12 * B),
        "silu_mul": (lambda: ops.silu_mul(gt, ut),
                     lambda: G.silu_mul_plain(gt, ut),
                     3 * 2 * gt.numel()),
    }
    return chain, fused, rows


def phase_times() -> None:
    g = torch.Generator(device="cuda").manual_seed(1)
    for cell, (name, F_, expert, _, layers) in CELLS.items():
        chain, fused, rows = layer_glue(name, F_, expert, g)
        for kernel, (kfn, plain, nbytes) in rows.items():
            emit("kernel", cell=cell, name=kernel,
                 bound_ms=round(1e3 * nbytes / HBM, 5),
                 kernel=ms(cs.time_cuda(kfn)),
                 plain=ms(cs.time_cuda(plain)))
        emit("layer_glue", cell=cell, chain=ms(cs.time_cuda(chain)),
             fused=ms(cs.time_cuda(fused)),
             chain_kernels=graph_kernels(chain),
             fused_kernels=graph_kernels(fused))


def horizon(cfg, params, scorer, routes: dict) -> None:
    """A captured horizon of 4 at 64 lanes on each route: its kernels and
    device ms per iteration."""
    cap, bs, hz = 528, cfg.kv_block_size, 4
    bp = -(-cap // bs)
    g = torch.Generator(device="cuda").manual_seed(2)
    cache = tm.init_decode_cache(cfg, B, cap, num_blocks=B * bp + 1,
                                 device="cuda")
    for key in ("k_pool", "v_pool"):
        for layer in cache[key]:
            layer.copy_(randn(g, *layer.shape))
    cache["block_tables"] = (torch.randperm(B * bp, generator=g,
                                            device="cuda") + 1
                             ).reshape(B, bp).to(torch.int32)
    toks = torch.randint(3, cfg.vocab_size, (B,), generator=g,
                         device="cuda", dtype=torch.int32)
    pos = torch.randint(16, cap - 2 * hz, (B,), generator=g,
                        device="cuda", dtype=torch.int32)
    limits = torch.full((B,), hz, dtype=torch.int32, device="cuda")
    V = cfg.vocab_size

    def sample(rng, logits):
        logits[:, V:] = -torch.inf
        return sample_logits(rng, logits, temperature=0.6, top_k=20,
                             top_p=0.95)

    def run():
        return tm.multi_decode_step(
            params, cfg, toks, pos, limits, cache, window_len=cap,
            horizon=hz, rng=None, sample_fn=sample, eos_id=2, step_id=5,
            score_fn=lambda hid: ops.step_score_params(hid, scorer),
            scratch_block=0, use_kernel=True)

    for route, fn in routes.items():
        real = L.glue_route
        if fn is not None:
            L.glue_route = fn
        try:
            kernels = graph_kernels(run)
            t = cs.time_cuda(run, reps=10)
            with ops.launches_withheld() as made:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    run()
        finally:
            L.glue_route = real
        emit("horizon", arch=cfg.name, layers=cfg.num_layers, route=route,
             kernels_per_iteration=kernels / hz,
             device_ms_per_iteration=round(float(t) / hz, 4),
             lo=round(t.lo / hz, 4), hi=round(t.hi / hz, 4),
             glue_launches_per_iteration={
                 k: made.get(k, 0) / hz for k in G.LAUNCHES})
        del graph


def phase_horizons() -> None:
    for cell, (_, _, _, arch, layers) in CELLS.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        if cfg.uses_moe:     # the cell's capacity: E/K, no pair dropped
            cfg = dataclasses.replace(cfg, moe_capacity_factor=4.0)
        g = torch.Generator(device="cuda").manual_seed(3)
        params = init_params(cfg, g)
        scorer = init_scorer(g, cfg.d_model)
        horizon(cfg, params, scorer,
                {"fused": None, "chain": lambda *a, **k: "chain"})
        del params
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-horizon", action="store_true",
                    help="leave out the full-depth horizons")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit("card", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__)
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    phase_checks()
    phase_times()
    if not args.no_horizon:
        phase_horizons()
    emit("done", failed=FAILED)
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
