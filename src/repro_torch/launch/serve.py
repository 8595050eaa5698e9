"""Serving launcher of the PyTorch port (``repro/launch/serve.py``): run
the STEP engine (or a baseline) over a batch of synthetic reasoning
requests with the trained artifacts (``launch.artifacts``; built on
first use).

    PYTHONPATH=src python -m repro_torch.launch.serve --method step \
        --problems 8 --traces 16 [--blocks 64] [--device cpu]

Online serving (continuous batching): replay a Poisson arrival trace,
stream per-request completions, and print the TTFT/TPOT/e2e summary:

    python -m repro_torch.launch.serve --method step --batched \
        --arrival-rate 2.0 --chunk 32 --max-tokens-per-step 64 --stream

The engine runs on the CUDA card unless ``--device`` names another
device.

Serving over a ``(data, model)`` mesh of devices takes one process per
device, each running this launcher with the same flags:

    torchrun --nproc-per-node=4 -m repro_torch.launch.serve \
        --method step --mesh 2,2

``--mesh auto`` puts every rank on "data". Each rank serves on
``cuda:<LOCAL_RANK>`` (NCCL), or with ``--device cpu`` on the host
(gloo); rank 0 prints the summary lines.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.artifacts import load_artifacts
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.evaluate import (EvalResult, evaluate_method,
                                          evaluate_method_batched,
                                          make_problems, poisson_arrivals)
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import (SLO, TenantScheduler,
                                           parse_tenant_weights)


def parse_mesh(spec: Optional[str], device=None):
    """``None``/"none" -> no mesh; "auto" -> every rank on "data";
    "D,M" -> (data=D, model=M), validated against the ranks. The mesh
    spans the default process group, which a launcher such as torchrun
    starts: initialized here from torchrun's environment (gloo for a CPU
    ``device``, else NCCL), or already initialized by the caller.
    Without either it exits with a message, before anything loads."""
    if spec is None or spec.lower() == "none":
        return None
    from repro_torch.launch.mesh import make_host_mesh
    sizes = (None, None)
    if spec.lower() != "auto":
        try:
            data_s, model_s = spec.split(",")
            sizes = (int(data_s), int(model_s))
        except ValueError:
            raise SystemExit(f"--mesh expects 'auto' or 'DATA,MODEL' "
                             f"(e.g. 2,2), got {spec!r}")
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise SystemExit(
                f"--mesh {spec}: serving over a mesh runs one process per "
                f"device: start them with torchrun --nproc-per-node=<N> "
                f"(no torch.distributed process group is initialized)")
        if device is not None and torch.device(device).type == "cpu":
            dist.init_process_group("gloo")
        else:
            local = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                            "0")))
            torch.cuda.set_device(local)
            dist.init_process_group("nccl", device_id=local)
    try:
        return make_host_mesh(*sizes)
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e}")


def main(argv: Optional[List[str]] = None) -> EvalResult:
    """Parse ``argv`` (default: the command line), serve, print the
    summary lines, and return the evaluation result."""
    ap = argparse.ArgumentParser(
        description="Serve synthetic reasoning requests with STEP or a "
                    "baseline (PyTorch port).")
    ap.add_argument("--method", default="step",
                    choices=["cot", "sc", "slimsc", "deepconf", "step"])
    ap.add_argument("--problems", type=int, default=4)
    ap.add_argument("--traces", type=int, default=16)
    ap.add_argument("--blocks", type=int, default=48,
                    help="paged KV pool size (the 'GPU memory')")
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--difficulty", type=int, nargs=2, default=(5, 8),
                    metavar=("MIN", "MAX"), help="ops per problem")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--batched", action="store_true",
                    help="submit all problems to ONE engine as a "
                         "request queue (cross-request contention)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrival rate (req/s); 0 = everything "
                         "at t=0 (offline batch). Implies --batched.")
    ap.add_argument("--chunk", type=int, default=0,
                    help="prefill chunk size in tokens (0 = one-shot "
                         "prefill)")
    ap.add_argument("--max-tokens-per-step", type=int, default=0,
                    help="per-tick token budget shared by decode and "
                         "prefill (0 = unlimited)")
    ap.add_argument("--decode-horizon", type=int, default=1,
                    help="fused decode horizon: K decode iterations per "
                         "device call (one CUDA graph replay on the card; "
                         "1 = one token per tick)")
    ap.add_argument("--use-kernel", default="auto",
                    choices=["auto", "on", "off"],
                    help="CUDA kernel path for decode + chunked prefill "
                         "and the fused step scorer: 'auto' launches the "
                         "CUDA kernels on the card and keeps the dense "
                         "PyTorch path on the CPU; 'on' forces the kernel "
                         "wrappers (their plain PyTorch versions on the "
                         "CPU: a correctness harness, not a fast path "
                         "there); 'off' is the dense path everywhere")
    ap.add_argument("--kv-dtype", default=None,
                    choices=["f32", "bf16", "int8", "fp8"],
                    help="paged KV pool storage dtype: bf16 (default) "
                         "or f32 float pools, or int8/fp8 quantized "
                         "pools with per-slot scales, dequantized inside "
                         "the attention kernel (default: bf16, or the "
                         "REPRO_KV_DTYPE env override)")
    ap.add_argument("--prefix-cache", default=None,
                    choices=["on", "off"],
                    help="cross-request prefix caching: park completed "
                         "prompts' KV blocks in a radix tree and serve "
                         "matching prefixes of later requests with zero "
                         "recompute (default: on, or the "
                         "REPRO_PREFIX_CACHE env override)")
    ap.add_argument("--tenant-weights", default=None,
                    metavar="NAME:W,NAME:W",
                    help="multi-tenant serving: run the weighted-fair "
                         "TenantScheduler with these per-tenant weights "
                         "(e.g. 'premium:3,batch:1') and assign requests "
                         "to the named tenants round-robin. Implies "
                         "--batched. Default: single-tenant FIFO (or the "
                         "REPRO_SCHED env override).")
    ap.add_argument("--slo", default=None, metavar="TTFT[,TPOT]",
                    help="attach a per-request SLO (seconds): TTFT "
                         "target, optional TPOT target. The tenant "
                         "scheduler degrades a request's n_traces when "
                         "its projected TTFT would miss the target.")
    ap.add_argument("--deadline", type=float, default=None,
                    metavar="SECONDS",
                    help="per-request completion deadline (seconds from "
                         "serve start, same clock as arrivals): a "
                         "request still running past its deadline is "
                         "cancelled and reported with status "
                         "'deadline_exceeded'. Implies --batched.")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="deterministic fault-injection plan, e.g. "
                         "'step@2x3,alloc@5,nan@7:slot=1' — simulated "
                         "device-step failures (retried with backoff, "
                         "then degraded), allocation stalls, and NaN "
                         "logit poisoning (lane quarantined). Overrides "
                         "the REPRO_FAULTS env var. Implies --batched.")
    ap.add_argument("--stream", action="store_true",
                    help="print each request's result as it completes")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve over a device mesh, one process per "
                         "device (torchrun --nproc-per-node=N): 'auto' "
                         "(every rank on data) or sizes like '2,2'; "
                         "default: one device")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: cuda; "
                         "'cpu' serves on the host)")
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh, args.device)
    rank0 = mesh is None or dist.get_rank() == 0
    device = args.device
    if mesh is not None and device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"

    # on a mesh rank 0 loads first: it builds missing artifacts alone
    if not rank0:
        dist.barrier()
    params, scorer, cfg = load_artifacts(device=device)
    if mesh is not None and rank0:
        dist.barrier()

    # CLI flags override REPRO_* env vars, which override the dataclass
    # defaults (EngineConfig.from_env resolves env < explicit overrides).
    ecfg = EngineConfig.from_env(
        max_batch=args.traces, num_blocks=args.blocks, capacity=256,
        max_new_tokens=args.max_new,
        sampling=SamplingParams(max_new_tokens=args.max_new),
        prefill_chunk_size=args.chunk or None,
        max_tokens_per_step=args.max_tokens_per_step or None,
        decode_horizon=args.decode_horizon,
        use_kernel={"auto": "auto", "on": True, "off": False}[
            args.use_kernel],
        **({} if args.prefix_cache is None
           else {"prefix_cache": args.prefix_cache == "on"}),
        **({} if args.kv_dtype is None else {"kv_dtype": args.kv_dtype}),
        **({} if args.faults is None else {"faults": args.faults}))
    problems = make_problems(args.problems, seed=args.seed,
                             n_steps=tuple(args.difficulty))
    pkw = {"warmup": max(2, args.traces // 4)} \
        if args.method == "deepconf" else {}

    slo = None
    if args.slo is not None:
        parts = [float(x) for x in args.slo.split(",")]
        slo = SLO(ttft_s=parts[0],
                  tpot_s=parts[1] if len(parts) > 1 else None)
    scheduler = None
    overrides = None
    if args.tenant_weights is not None:
        weights = parse_tenant_weights(args.tenant_weights)
        scheduler = TenantScheduler(weights=weights)
        tenants = list(weights)
        overrides = [{"tenant": tenants[i % len(tenants)], "slo": slo}
                     for i in range(len(problems))]
    elif slo is not None:
        overrides = [{"slo": slo}] * len(problems)
    if args.deadline is not None:
        if overrides is None:
            overrides = [{} for _ in problems]
        overrides = [dict(o, deadline=args.deadline) for o in overrides]

    batched = args.batched or args.arrival_rate > 0 \
        or args.tenant_weights is not None \
        or args.deadline is not None or args.faults is not None
    if batched:
        arrivals = poisson_arrivals(len(problems), args.arrival_rate,
                                    seed=args.seed)

        def on_result(r):
            if not args.stream or not rank0:
                return
            m = r.metrics
            if r.status != "completed" or m.ttft_s is None:
                # cancelled / deadline_exceeded / failed requests may
                # never have produced a first token
                print(f"  << q{r.request_id} {r.status}: "
                      f"tok={r.total_tokens}")
                return
            print(f"  << q{r.request_id} done: ans={r.answer} "
                  f"ttft={m.ttft_s:.2f}s tpot={m.tpot_s * 1e3:.0f}ms "
                  f"e2e={m.e2e_s:.2f}s tok={r.total_tokens}")

        res = evaluate_method_batched(
            args.method, params, cfg, problems, args.traces, ecfg,
            scorer_params=scorer, policy_kwargs=pkw,
            arrival_times=arrivals, on_result=on_result,
            scheduler=scheduler, request_overrides=overrides,
            verbose=rank0 and not args.stream, mesh=mesh, device=device)
    else:
        res = evaluate_method(args.method, params, cfg, problems,
                              args.traces, ecfg, scorer_params=scorer,
                              policy_kwargs=pkw, verbose=rank0, mesh=mesh,
                              device=device)
    if rank0:
        print_summary(args.method, res)
    return res


def print_summary(method: str, res: EvalResult) -> None:
    """The JAX launcher's summary lines."""
    print(f"\n[{method}] acc={res.accuracy:.2f} "
          f"tokens={res.avg_tokens:.0f} latency={res.avg_latency_s:.2f}s "
          f"wait={res.total_wait_s:.2f}s pruned={res.num_pruned} "
          f"preempt={res.num_preemptions}")
    if res.serving is not None:
        s = res.serving
        ended_early = (s["num_cancelled"] + s["num_deadline_exceeded"]
                       + s["num_failed"])
        if ended_early:
            print(f"[faults] cancelled={s['num_cancelled']} "
                  f"deadline_exceeded={s['num_deadline_exceeded']} "
                  f"failed={s['num_failed']} "
                  f"failed_traces={s['failed_traces']}")
    if res.serving is not None and res.serving["ttft_s"]["p50"] is not None:
        s = res.serving
        print(f"[serving] ttft p50={s['ttft_s']['p50']:.2f}s "
              f"p99={s['ttft_s']['p99']:.2f}s | "
              f"tpot p50={s['tpot_s']['p50'] * 1e3:.0f}ms | "
              f"e2e p50={s['e2e_s']['p50']:.2f}s "
              f"p99={s['e2e_s']['p99']:.2f}s | "
              f"throughput={s['throughput_tok_per_s']:.1f} tok/s")
        if s.get("slo", {}).get("requests_with_slo"):
            slo_s = s["slo"]
            att = {k: ("n/a" if slo_s[k] is None else f"{slo_s[k]:.2f}")
                   for k in ("ttft_attainment", "tpot_attainment")}
            print(f"[slo] requests={slo_s['requests_with_slo']} "
                  f"ttft_attainment={att['ttft_attainment']} "
                  f"tpot_attainment={att['tpot_attainment']} "
                  f"degraded_traces={s['degraded_traces']}")


if __name__ == "__main__":
    main()
