"""The paged kernel's chunked-prefill face on the card, quickly: build
``csrc/paged_attention.cu``, hold the prefill face to its plain version
over the main paths' shapes (bf16, int8 and fp8 pools; pages of 8 to 128;
hd 64 and 128; mixtral's windowed chunk; granite's and phi4-mini's head
groups), show which launch counter each call moved, and time the K1b and
K1c rows with ``chip_smoke.py``'s ``time_prefill`` (the same inputs,
bound and SDPA yardstick as its ``times`` phase).

    python3 tools/prefill_probe.py

on a machine with one CUDA card, from the root of a checkout; about
two minutes, the build included. It prints the card, the wgmma prefill
kernel's registers and spills, one JSON line per case and per timed row,
and exits 1 if a case disagrees with the plain version (bf16 1e-2).
"""
from __future__ import annotations

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

# (C, H, KVH, hd, prefix, num_valid, window, page); each over a bf16, an
# int8 and an fp8 pool
CASES = [
    (16, 32, 8, 128, 64, 16, None, 16),      # the serve's chunk
    (16, 32, 8, 128, 37, 11, None, 16),
    (64, 32, 8, 128, 200, 64, 128, 16),
    (8, 4, 2, 64, 40, 3, None, 16),          # the serving launcher's
    (1, 32, 8, 128, 300, 1, 128, 32),
    (64, 32, 8, 64, 200, 50, 128, 8),
    (16, 32, 8, 128, 300, 13, 128, 128),
    (512, 32, 8, 128, 4608, 512, 4096, 16),  # mixtral's chunk
    (512, 32, 8, 128, 4096, 104, 4096, 16),
    (512, 32, 8, 128, 600, 512, 300, 16),
    (3, 48, 1, 128, 37, 3, None, 16),        # granite's group
    (64, 24, 8, 128, 130, 64, None, 16),     # phi4-mini's
]
# (row, time_prefill keywords): the kernel table's K1b/K1c prefill rows
TIMED = [
    ("serve", dict(H=32, KVH=8, hd=128, bp=32)),
    ("serve_int8", dict(H=32, KVH=8, hd=128, bp=32, kv_dtype="int8")),
    ("serve_fp8", dict(H=32, KVH=8, hd=128, bp=32, kv_dtype="fp8")),
    ("swa", dict(H=32, KVH=8, hd=128, bp=289, C=512, prefix=4608,
                 window=4096)),
    ("swa_int8", dict(H=32, KVH=8, hd=128, bp=289, C=512, prefix=4608,
                      window=4096, kv_dtype="int8")),
    ("swa_fp8", dict(H=32, KVH=8, hd=128, bp=289, C=512, prefix=4608,
                     window=4096, kv_dtype="fp8")),
    ("long", dict(H=32, KVH=8, hd=128, bp=289, C=512, prefix=4608)),
    ("launch", dict(H=4, KVH=2, hd=64, bp=16, C=8, prefix=16)),
    ("launch_int8", dict(H=4, KVH=2, hd=64, bp=16, C=8, prefix=16,
                         kv_dtype="int8")),
]


def check(g, C, H, KVH, hd, prefix, nvalid, window, page, pool) -> bool:
    bp = max(1, -(-prefix // page)) + 1
    scales = {}
    if pool == "bf16":
        args = cs.prefill_inputs(g, C, H, KVH, hd, bp, prefix, nvalid,
                                 torch.bfloat16, page)
    else:
        q, kp, vp, bt, pl, nv, ok, ov = cs.prefill_inputs(
            g, C, H, KVH, hd, bp, prefix, nvalid, torch.float32, page)
        kq, vq, ks, vs = cs.quantize(kvq, kp, vp, pool)
        bf = torch.bfloat16
        args = (q.to(bf), kq, vq, bt, pl, nv, ok.to(bf), ov.to(bf))
        scales = dict(k_scale=ks, v_scale=vs)
    scale = 1.0 / math.sqrt(hd)
    before = dict(pa.LAUNCHES)
    got = pa.paged_attention_prefill(*args, scale=scale, window=window,
                                     **scales)
    torch.cuda.synchronize()
    want = pa.paged_attention_prefill_plain(
        *args, scale, window, scales.get("k_scale"), scales.get("v_scale"))
    ok = (torch.allclose(got.float(), want.float(), **cs.BF16_TOL)
          and bool((got[0, nvalid:] == 0).all()))
    print(json.dumps(dict(
        C=C, H=H, KVH=KVH, hd=hd, prefix=prefix, nvalid=nvalid,
        window=window, page=page, pool=pool,
        rows=pa.prefill_rows(C, H // KVH, hd, page, torch.bfloat16,
                             args[1].dtype),
        err=(got.float() - want.float()).abs().max().item(), ok=ok,
        moved={k: pa.LAUNCHES[k] - before[k] for k in before
               if pa.LAUNCHES[k] != before[k]})), flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("prefill_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    log = build.build_all(["paged_attention"])["paged_attention"]
    for fn, props, regs in re.findall(
            r"Function properties for (\S*prefill_wgmma\S*)\n(.*?)Used (\d+)"
            r" registers", log, flags=re.S):
        print(json.dumps({"kernel": cs.demangle([fn])[0],
                          "registers": int(regs),
                          "spills": props.strip().splitlines()[-1]}),
              flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    bad = sum(not check(g, *case, pool) for pool in ("bf16", "int8", "fp8")
              for case in CASES)
    print(json.dumps({"cases_failed": bad}), flush=True)
    if bad:
        return 1
    for name, kw in TIMED:
        r = cs.time_prefill(pa, kvq, g, **kw)
        r["bound_ms"], r["bound_by"] = cs.bound_ms(r["bytes"], r["flops"],
                                                   r.pop("dtype"))
        print(json.dumps({"row": name, **{k: r[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "shape")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
