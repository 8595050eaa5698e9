"""The paged kernel's decode face on the card, quickly: build
``csrc/paged_decode.cu`` (the cluster face) and ``csrc/paged_attention.cu``
(``decode_kernel``, the split face), print the cluster face's registers
and spills per instance, hold the routed face to the plain version over
the main paths' decode shapes and the edges (bf16, int8 and fp8 pools;
lengths 0, 1 and page edges; pages of 8, 16 and 32; G 1, 2, 3, 4, 12 and
48; hd 64, 80 and 128; 288- and 256-page rows), show which launch
counter each call moved, and time the K1a/K1c decode rows with
``chip_smoke.py``'s ``time_decode`` (the cluster face, ``decode_kernel``
on the same inputs, SDPA, the bound) beside the empty-kernel floor.

    python3 tools/decode_probe.py                 # build, check, time
    python3 tools/decode_probe.py --cluster 2,4,8 # also time other sizes

on a machine with one CUDA card, from the root of a checkout; about two
minutes, the build included. ``--cluster`` times the rows again with the
cluster size forced (the ring and the rest of ``decode_plan`` as they
are), to choose the plan's target. It prints the card, one JSON line per
case and per timed row, and exits 1 if a case disagrees with the plain
version (bf16 1e-2).
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import kv_quant as kvq  # noqa: E402

SERVE_LENS = [15 + (128 * i) // 15 for i in range(16)]
EDGES = [0, 1, 15, 16, 17, 33, 255, 256, 511, 512]
# (B, H, KVH, hd, page, bp, lens); each over a bf16, an int8 and an fp8
# pool
CASES = [
    (16, 32, 8, 128, 16, 32, SERVE_LENS),          # the serve
    (10, 32, 8, 128, 16, 32, EDGES),
    (10, 32, 8, 128, 8, 64, EDGES),
    (10, 32, 8, 128, 32, 16, EDGES),
    (16, 16, 4, 128, 16, 32, SERVE_LENS),          # a (1, 2) mesh rank
    (16, 32, 32, 80, 16, 32, SERVE_LENS),          # zamba2
    (10, 32, 32, 80, 8, 64, EDGES),
    (8, 48, 1, 128, 16, 32, [0] + [15 + (32 * i) // 6 for i in range(7)]),
    (10, 48, 1, 128, 32, 16, EDGES),               # granite-20b
    (8, 16, 8, 128, 16, 32, EDGES[:8]),            # qwen3-1.7b (G 2)
    (8, 24, 8, 128, 16, 32, EDGES[:8]),            # phi4-mini (G 3)
    (8, 24, 2, 128, 16, 32, EDGES[:8]),            # starcoder2 (G 12)
    (8, 16, 16, 64, 16, 8, [0, 65, 76, 86, 97, 107, 118, 128]),  # seamless
    (16, 4, 2, 64, 16, 16, [0, 1] + [20 + (236 * i) // 13
                                     for i in range(14)]),   # launcher
    (8, 4, 2, 64, 8, 32, EDGES[:8]),
    (4, 32, 8, 128, 16, 288, [4201, 4206, 4211, 4216]),      # mixtral
    (6, 32, 8, 128, 16, 256, [0, 1, 16, 49, 4096, 4091]),    # long rows
    (3, 96, 1, 64, 16, 4, [0, 30, 64]),            # G 96: two head groups
]
# (row, time_decode arguments): the kernel table's K1a/K1c decode rows
TIMED = [
    ("decode", dict(B=16, H=32, KVH=8, hd=128, bp=32, lens=SERVE_LENS)),
    ("decode_int8", dict(B=16, H=32, KVH=8, hd=128, bp=32, lens=SERVE_LENS,
                         kv_dtype="int8")),
    ("decode_fp8", dict(B=16, H=32, KVH=8, hd=128, bp=32, lens=SERVE_LENS,
                        kv_dtype="fp8")),
    ("decode_hd80", dict(B=16, H=32, KVH=32, hd=80, bp=32, lens=SERVE_LENS)),
    ("decode_g48", dict(B=8, H=48, KVH=1, hd=128, bp=32,
                        lens=[15 + (32 * i) // 7 for i in range(8)])),
    ("decode_mesh", dict(B=16, H=16, KVH=4, hd=128, bp=32, lens=SERVE_LENS)),
    ("decode_mixtral", dict(B=4, H=32, KVH=8, hd=128, bp=288,
                            lens=[4201, 4206, 4211, 4216])),
    ("decode_long", dict(B=16, H=32, KVH=8, hd=128, bp=256,
                         lens=[1024 + (3072 * i) // 15 for i in range(16)])),
    ("decode_seamless", dict(B=8, H=16, KVH=16, hd=64, bp=8,
                             lens=[65, 76, 86, 97, 107, 118, 128, 128])),
    ("decode_launch", dict(B=16, H=4, KVH=2, hd=64, bp=16,
                           lens=[24 + (96 * i) // 15 for i in range(16)])),
    ("decode_int8_launch", dict(B=16, H=4, KVH=2, hd=64, bp=16,
                                lens=[24 + (96 * i) // 15 for i in range(16)],
                                kv_dtype="int8")),
]


def check(g, B, H, KVH, hd, page, bp, lens, pool) -> bool:
    scales = {}
    if pool == "bf16":
        args = cs.decode_inputs(g, B, H, KVH, hd, bp, lens, torch.bfloat16,
                                page)
    else:
        q, kp, vp, bt, cl = cs.decode_inputs(g, B, H, KVH, hd, bp, lens,
                                             torch.float32, page)
        kq, vq, ks, vs = cs.quantize(kvq, kp, vp, pool)
        args = (q.to(torch.bfloat16), kq, vq, bt, cl)
        scales = dict(k_scale=ks, v_scale=vs)
    scale = 1.0 / math.sqrt(hd)
    before = dict(pa.LAUNCHES)
    got = pa.paged_attention(*args, scale=scale, **scales)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(*args, scale, scales.get("k_scale"),
                                    scales.get("v_scale"))
    empty = [i for i, n in enumerate(lens) if n == 0]
    ok = (torch.allclose(got.float(), want.float(), **cs.BF16_TOL)
          and bool((got[empty] == 0).all()))
    print(json.dumps(dict(
        B=B, H=H, KVH=KVH, hd=hd, page=page, bp=bp, pool=pool,
        lens=f"{min(lens)}..{max(lens)}",
        plan=pa.decode_plan(bp, B * KVH * -(-(H // KVH) // pa.CLUSTER_ROWS),
                            page),
        err=(got.float() - want.float()).abs().max().item(), ok=ok,
        moved={k: pa.LAUNCHES[k] - before[k] for k in before
               if pa.LAUNCHES[k] != before[k]})), flush=True)
    return ok


def time_rows(g, tag=""):
    for name, kw in TIMED:
        r = cs.time_decode(pa, kvq, g, **kw)
        r["bound_ms"], r["bound_by"] = cs.bound_ms(r["bytes"], r["flops"],
                                                   r.pop("dtype"))
        print(json.dumps({"row": name + tag, **{k: r[k] for k in (
            "ms", "split_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "plan", "shape")},
            "ms_range": [r["ms"].lo, r["ms"].hi]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster", default="",
                    help="comma-separated cluster sizes to time as well")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    logs = build.build_all(["paged_decode", "paged_attention"])
    for fn, props, regs in re.findall(
            r"Function properties for (\S*decode_cluster\S*)\n(.*?)Used (\d+)"
            r" registers", logs["paged_decode"], flags=re.S):
        print(json.dumps({"kernel": cs.demangle([fn])[0],
                          "registers": int(regs), "spill_bytes": sum(
                              int(n) for n in re.findall(
                                  r"(\d+) bytes spill", props))}),
              flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    bad = sum(not check(g, *case, pool) for pool in ("bf16", "int8", "fp8")
              for case in CASES)
    print(json.dumps({"cases_failed": bad}), flush=True)
    if bad:
        return 1
    floor = cs.time_empty()["ms"]
    print(json.dumps({"row": "empty_kernel", "ms": floor,
                      "ms_range": [floor.lo, floor.hi]}), flush=True)
    time_rows(g)
    plan = pa.decode_plan
    for S in (int(x) for x in args.cluster.split(",") if x):
        def forced(*a, S=S):
            n = plan(*a)["chunks"]
            c = min(S, n)
            return {"cluster": c, "chunks": n,
                    "stages": min(pa.MAX_STAGES, -(-n // c))}
        pa.decode_plan = forced
        time_rows(g, f"_S{S}")
    pa.decode_plan = plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
