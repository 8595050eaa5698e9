"""The flash kernel (K3) on the card, quickly: build
``csrc/flash_attention.cu``, print each instance's registers and spills
(and any note of ptxas on the wgmma pipeline), hold every face to the
plain version over the main paths' shapes and the edges (causal, windowed,
no mask; S 64, 512, 2048 and a ragged S; both row counts of the wgmma
face; f32 at every head dim), show which launch counters each call moved,
and time the K3 rows with ``chip_smoke.py``'s ``time_flash`` (the same
inputs, bound and SDPA yardstick as its ``times`` phase).

    python3 tools/flash_probe.py                  # build, check, time
    python3 tools/flash_probe.py --time-only --root <checkout>

on a machine with one CUDA card, from the root of a checkout; about two
minutes, the build included. ``--root`` times the kernel of another
checkout (an unpacked parent commit, say) with this one's timing code,
so that two versions can be compared within one call. It prints the
card, one JSON line per case and per timed row, and exits 1 if a case
disagrees with the plain version (bf16 1e-2, f32 1e-4).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (B, H, S, hd, dtype, causal, window): H picks the wgmma face's rows per
# CTA through flash_rows (64 where B*H*ceil(S/128) < 132, else 128)
MASKS = [(True, None), (True, 128), (False, None), (False, 50)]
SHAPES = [
    (1, 2, 64, "rows64"), (1, 140, 64, "rows128"),
    (1, 4, 512, "rows64"), (1, 40, 512, "rows128"),
    (1, 2, 2048, "rows64"), (1, 9, 2048, "rows128"),
    (2, 1, 100, "rows64"), (1, 140, 100, "rows128"),   # ragged S
]
# (row, time_flash arguments): the kernel table's K3 rows
TIMED = [
    ("flash_attention", dict(H=32, hd=128, dtype="bf16")),
    ("flash_attention_hd80", dict(H=32, hd=80, dtype="bf16")),
    ("flash_attention_hd80_f32", dict(H=32, hd=80, dtype="f32")),
    ("flash_attention_swa", dict(H=32, hd=128, dtype="bf16", S=8192,
                                 window=4096)),
    ("flash_attention_seamless", dict(H=16, hd=64, dtype="bf16", S=512)),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose kernel is built and timed")
    ap.add_argument("--time-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    log = build.build_all(["flash_attention"])["flash_attention"]
    for fn, props, regs in re.findall(
            r"Function properties for (\S+)\n(.*?)Used (\d+) registers", log,
            flags=re.S):
        print(json.dumps({"kernel": cs.demangle([fn])[0],
                          "registers": int(regs),
                          "spills": re.findall(r"\d+ bytes spill \w+",
                                               props)}), flush=True)
    for line in log.splitlines():
        if "warning" in line.lower() or "serializ" in line.lower():
            print(json.dumps({"ptxas": line.strip()}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    bad = 0
    if not args.time_only:
        cases = [(B, H, S, hd, torch.bfloat16, c, w, tag)
                 for hd in (64, 80, 128) for B, H, S, tag in SHAPES
                 for c, w in MASKS]
        cases += [(B, H, S, 32, torch.bfloat16, c, w, "tile")
                  for B, H, S, _ in SHAPES[:4] for c, w in MASKS]
        cases += [(2, 3, S, hd, torch.float32, c, w, "f32")
                  for hd in (32, 64, 80, 128) for S in (64, 100, 512)
                  for c, w in MASKS]
        cases += [(1, 32, 2048, 80, torch.float32, True, None, "zamba2")]
        for B, H, S, hd, dtype, causal, window, tag in cases:
            q, k, v = (torch.randn(B, H, S, hd, generator=g, device="cuda")
                       .to(dtype) for _ in range(3))
            before = dict(fa.LAUNCHES)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, causal, window)
            tol = cs.BF16_TOL if dtype == torch.bfloat16 else cs.F32_TOL
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), **tol)
            bad += not ok
            print(json.dumps(dict(
                B=B, H=H, S=S, hd=hd, dtype=str(dtype)[6:], causal=causal,
                window=window, tag=tag,
                rows=fa.flash_rows(B * H, S, hd, dtype), err=err, ok=ok,
                moved={k: fa.LAUNCHES[k] - before[k] for k in before
                       if fa.LAUNCHES[k] != before[k]})), flush=True)
        print(json.dumps({"cases": len(cases), "cases_failed": bad}),
              flush=True)
        if bad:
            return 1
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for name, kw in TIMED:
        kw = dict(kw, dtype=dtypes[kw["dtype"]])
        r = cs.time_flash(fa, g, **kw)
        r["bound_ms"], r["bound_by"] = cs.bound_ms(r["bytes"], r["flops"],
                                                   r.pop("dtype"))
        print(json.dumps({"row": name, "root": args.root, **{k: r[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "shape")}}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
