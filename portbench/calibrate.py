"""Readings from which a cell's limits are set (``portbench/limits/``):
the program's numbers over many seeds and the control's (the reference in
fp8 put in the program's place) on the same probes, in one process.

    python3 -m portbench.calibrate --workload <name> --seeds <a,b,...> --seconds <s>

Each seed makes its own weights, serves the cell's traffic for a short
window at the cell's load (long enough to answer its longest problems)
and compares as many probes as a run does. One JSON line per seed: for
each series (``logprob``, ``score``) its median, 90th and 99th
percentiles and widest, for the program and for the control, and the
compared numbers of both (the exact decision checks: the program's), and
for an MoE the prompt routing decisions that the comparison resolved the
other way (``compare.settle``: layer, position, margin).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

from portbench import run


def quantiles(x) -> dict:
    import torch
    if not x.numel():
        return {}
    x = x.double()
    return {"n": int(x.numel()), "p50": float(x.median()),
            "p90": float(torch.quantile(x, 0.9)),
            "p99": float(torch.quantile(x, 0.99)), "max": float(x.max())}


def routing_look(probes: list, s: dict) -> dict:
    """Where the log-probability differences of an MoE lie: at the served
    tokens whose position routes on a near tie in the reference (the
    least margin over the layers between a token's last chosen expert and
    the next, in router logits, under ``NEAR_TIE``) and elsewhere."""
    import torch

    from portbench.reference.compare import NEAR_TIE
    near = torch.cat([m[len(p["prompt"]) - 1:len(p["prompt"]) - 1
                        + len(p["out"])] < NEAR_TIE
                      for p, m in zip(probes, s["margins"])])
    err = s["logprob"]
    return {"near_tie_share": float(near.double().mean()),
            "near_tie": quantiles(err[near]), "clear": quantiles(err[~near])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.cache_dirs(run.ROOT)
    import torch

    from portbench import drive, manifest as M, weights
    from portbench.reference import compare as C

    man = M.Manifest(run.ROOT)
    cell = man.cell(args.workload)
    cfg, mix = man.config(cell["config"]), man.traffic(cell["traffic"])
    rt = run.runtime()
    for seed in (int(x) for x in args.seeds.split(",")):
        params, scorer = weights.make(cfg, seed, "cuda")
        out, rec = drive.serve_once(rt, cfg, mix, params, scorer, seed,
                                    "cuda", args.seconds)
        served = out["served"]
        probes = C.sample(served, seed, mix["check"])
        line = {"seed": seed, "problems": len(served), "probes": len(probes),
                "program": {}, "control": {}}
        for side, control in (("program", False), ("control", True)):
            trail = []
            s = C.series(cfg, params, scorer, probes, control, trail=trail)
            if s["margins"]:
                line[side]["routing"] = routing_look(probes, s)
                line[side]["flips_kept"] = [
                    [x["layer"], x["pos"], x["margin"]]
                    for x in trail if x["kept"]]
            line[side] = dict(line.get(side, {}), **{
                k: quantiles(s[k]) for k in ("logprob", "logprob_clear",
                                             "logprob_settled", "score")})
            line[side]["numbers"] = C.summarize(s)
        line["program"]["numbers"].update(C.decisions(served, rec.prunes))
        print(json.dumps(line), flush=True)
        del params, scorer, served, probes, out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
