"""The knee of an open-loop mix: the highest arrival rate the system
serves without a growing backlog, found by a sweep.

    python3 -m portbench.sweep --workload <name> --rates 1.5,2,2.5 --seconds 20 --seed <n>

For each rate one engine serves the cell's mix at that rate for
``--seconds`` of arrivals. One JSON line per rate: problems, the rate
completed (problems over the time to the last answer), latency from
scheduled arrival (median, 90th percentile, and the median of the first
and of the last third of arrivals: a backlog that grows shows as a last
third slower than the first) and the drain after the last arrival. The
cell's traffic file then takes four fifths of the knee as its rate.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

from portbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    run.cache_dirs(run.ROOT)
    import torch

    from portbench import drive, manifest as M, weights
    from portbench.bounds import percentile

    man = M.Manifest(run.ROOT)
    cell = man.cell(args.workload)
    cfg, base = man.config(cell["config"]), man.traffic(cell["traffic"])
    rt = run.runtime()
    params, scorer = weights.make(cfg, args.seed, "cuda")
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(base, rate_per_s=rate)
        out, _ = drive.serve_once(rt, cfg, mix, params, scorer, args.seed,
                                  "cuda", args.seconds)
        last = out["served"][-1]["problem"].arrival_s
        lat = [s["finished_s"] - s["arrival_s"] for s in out["served"]]
        third = max(1, len(lat) // 3)
        print(json.dumps({
            "rate": rate, "problems": len(lat),
            "completed_per_s": len(lat) / out["window_s"],
            "latency_p50_s": percentile(lat, 50),
            "latency_p90_s": percentile(lat, 90),
            "first_third_p50_s": percentile(lat[:third], 50),
            "last_third_p50_s": percentile(lat[-third:], 50),
            "drain_s": out["window_s"] - last,
            "tokens_per_s": sum(s["result"].total_tokens
                                for s in out["served"]) / out["window_s"]}),
            flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
