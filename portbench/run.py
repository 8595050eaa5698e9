"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration (``portbench/configs/``) and traffic mix
(``portbench/traffic/``); its metrics are read by the files of
``portbench/metrics/``. Set-up makes the weights on the card from the
seed, builds the engine (``repro_torch.serving.Engine``) and warms up the
mix's prefill and decode paths; the window serves the mix for
``--seconds``; then the program's state is freed and a sample of what it
served is compared with the plain reference (``portbench/reference/``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` the profiled stretch's ``breakdown``, and last
``compared``: each number of the comparison beside its limit, which the
last lines of standard error repeat. With no CUDA card, too few cards, or
the JAX package loaded, it prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types
from pathlib import Path
from typing import Optional

STARTED = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - STARTED


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX package's, JAX's or
    Flax's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port's kernels build under ``build/repro_torch/`` by themselves."""
    base = root / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def runtime() -> types.SimpleNamespace:
    """The system under test: the port's engine and what it takes."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import dataclasses

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import pruning
    from repro_torch.kernels import ops
    from repro_torch.serving import engine, sampling

    fields = {f.name for f in dataclasses.fields(ModelConfig)}

    def model_config(cfg: dict) -> ModelConfig:
        return ModelConfig(**{k: v for k, v in cfg.items() if k in fields})

    return types.SimpleNamespace(engine=engine, sampling=sampling,
                                 pruning=pruning, ops=ops,
                                 model_config=model_config)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", manifest=None, config_override=None,
             mix_override=None, limits: Optional[dict] = None) -> dict:
    """One run of ``workload``. Returns the result line's object and the
    compared numbers. ``device="cpu"`` and the overrides are for the CPU
    tests (a tiny configuration, a short mix)."""
    import torch

    from portbench import drive, manifest as M, traffic, weights
    from portbench.reference import compare as C

    man = manifest or M.Manifest(ROOT)
    cell = man.cell(workload)
    cfg = dict(man.config(cell["config"]), **(config_override or {}))
    mix = dict(man.traffic(cell["traffic"]), **(mix_override or {}))
    if limits is None:
        limits = json.loads((man.dir / "limits" / f"{workload}.json")
                            .read_text())
    cuda = device != "cpu"
    rt = runtime()
    params, scorer = weights.make(cfg, seed, device)
    rec = drive.Recorder(trace, cuda,
                         profile_ticks=mix.get("profile_ticks", 0))
    runner = drive.Runner(rt, cfg, mix, params, scorer, seed, device, rec)
    runner.warm_up()
    plan = traffic.problems(mix, seed, seconds)
    if cuda:
        torch.cuda.synchronize()
    setup_s = process_age()
    captures = rt.ops.GRAPHS["decode_graph_captures"]
    out = runner.window(plan, seconds)
    captures = rt.ops.GRAPHS["decode_graph_captures"] - captures
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded in the run: {found}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    runner.close()

    served = out["served"]
    record = {
        "loop": mix["loop"], "seconds": seconds, "window_s": out["window_s"],
        "setup_s": setup_s, "cfg": cfg, "mix": mix,
        "problems": [problem_record(s) for s in served],
        "ticks": [t.__dict__ for t in rec.ticks],
        "prefills": [p.__dict__ for p in rec.prefills],
        "profile": rec.profile.reduce() if rec.profile else None,
        "origin_s": out["origin_s"]}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in man.metrics(workload, kind):
        value = man.reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    probes = C.sample(served, seed, mix["check"])
    numbers = C.compare(cfg, params, scorer, probes)
    numbers.update(C.decisions(served, rec.prunes))
    compared = {k: {"value": numbers[k], "limit": limits[k]}
                for k in C.NUMBERS if k in limits}
    result = {
        "correct": all(v["value"] <= v["limit"] for v in compared.values()),
        "attempted": len(served),
        "failed": sum(s["result"].status != "completed" for s in served),
        "metrics": metrics,
        "device": device_record(cuda, peak, record["profile"])}
    if trace and record["profile"]:
        result["breakdown"] = {k: record["profile"][k]
                               for k in ("device_ops", "idle_gaps")}
    result["compared"] = compared
    result["probes"] = len(probes)
    result["notes"] = dict(notes(record, served, rec, probes),
                           captures_in_window=captures, numbers=numbers)
    if record["profile"]:
        result["notes"]["profiled_from_s"] = (record["profile"]["host_s"][0]
                                              - record["origin_s"])
    return result


def notes(record: dict, served: list, rec, probes: list) -> dict:
    """What the run served, for its standard error: the step-boundary
    tokens' share of the served tokens, the step scores and answers the
    traces carry, ticks, iterations and captures."""
    from portbench import frozen
    traces = [t for s in served for t in s["result"].traces]
    tokens = sum(t.num_tokens for t in traces)
    return {
        "problems": len(served), "traces": len(traces), "tokens": tokens,
        "step_token_share": (sum(t.output_tokens.count(frozen.STEP_ID)
                                 for t in traces) / max(tokens, 1)),
        "step_scores": sum(len(t.step_scores) for t in traces),
        "answered_problems": sum(s["result"].answer is not None
                                 for s in served),
        "prunes": len(rec.prunes), "iterations": rec.iterations,
        "probes": len(probes),
        "probe_tokens": sum(len(p["out"]) for p in probes),
        "window_s": record["window_s"], "setup_s": record["setup_s"]}


def problem_record(s: dict) -> dict:
    res, p = s["result"], s["problem"]
    m = res.metrics
    rel = s["start_s"]   # the engine's times count from its serve's start
    return {"index": p.index, "arrival_s": s["arrival_s"], "finished_s": s["finished_s"],
            "first_token_s": (None if m.first_token_s is None
                              else rel + m.first_token_s),
            "admitted_s": None if m.admitted_s is None else rel + m.admitted_s,
            "tokens": res.total_tokens, "traces": len(res.traces),
            "pruned": res.num_pruned, "preemptions": res.num_preemptions,
            "status": res.status}


def device_record(cuda: bool, peak: int, profile: Optional[dict]) -> dict:
    import torch
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if profile:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    import torch

    from portbench import manifest as M
    man = M.Manifest(ROOT)
    chips = man.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), manifest=man)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in the run: {found}", file=sys.stderr)
        return 3
    result.pop("probes")
    print("notes " + json.dumps(result.pop("notes")), file=sys.stderr)
    for name, v in result["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
