"""One production dry-run record at a cut depth, with what DTensor
computed anew while tracing it: where the dry run's time goes on a
mesh, and the per-device counts to hold against another tree's.

    PYTHONPATH=src python tools/dryrun_cut.py granite-20b train_4k \\
        --layers 2 [--multi-pod]

Prints one JSON line: the record's status, ``trace_s`` and counted
fields, DTensor's layout searches (each miss of its sharding cache,
which it logs: every layout of every mesh dim weighed) and its
redistribution plans (misses of the planner's cache). Runs on the CPU;
no card.
"""
import argparse
import dataclasses
import json
import logging

from torch.distributed.tensor import _redistribute

from repro_torch.launch import dryrun

COUNTED = ("hlo_flops_per_dev", "hlo_bytes_per_dev", "collective_breakdown",
           "argument_size_in_bytes", "temp_size_in_bytes",
           "output_size_in_bytes", "score_bytes_per_dev")


class Misses(logging.Handler):
    """Counts the sharding-cache misses that DTensor's dispatcher logs at
    DEBUG."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.count = 0

    def emit(self, record):
        if "sharding_prop MISS" in record.msg:
            self.count += 1


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the arch to this many layers (0: all)")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    full = dryrun.get_config
    if args.layers:
        dryrun.get_config = lambda arch: dataclasses.replace(
            full(arch), num_layers=args.layers)
    logger = logging.getLogger("torch.distributed.tensor._dispatch")
    misses = Misses()
    logger.addHandler(misses)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False    # count the misses, print none
    _redistribute._gen_transform_infos.cache_clear()
    try:
        rec = dryrun.run_one(args.arch, args.shape, args.multi_pod,
                             save=False)
    finally:
        logger.removeHandler(misses)
        logger.propagate = True
    out = {"arch": args.arch, "shape": args.shape, "mesh": rec["mesh"],
           "layers": args.layers or None, "status": rec["status"],
           "trace_s": rec.get("trace_s"), "layout_searches": misses.count,
           "redistribution_plans":
               _redistribute._gen_transform_infos.cache_info().misses,
           **{k: rec.get(k) for k in COUNTED}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
