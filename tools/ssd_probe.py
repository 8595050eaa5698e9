"""K4, the SSD scan, on the card, quickly: build ``csrc/ssd_wgmma.cu``
(the wgmma face) and ``csrc/ssd_scan.cu`` (the tile face), print each
wgmma-face instance's registers and spills and the library's HGMMA
count, hold the routed face to the plain version over the zoo's
full-width shapes (N 128 and 64; chunks 64, 128, 192 and 256; the init's
steep decays; 16 chunks; two batch rows; a sequence padded with dt = 0)
and the JAX tests' shapes (the tile face), check that two calls agree bit
for bit, show which launch counter each call moved, and time both faces
on mamba2's and zamba2's rows with ``chip_smoke.py``'s ``time_ssd`` (the
routed face, the tile face on the same inputs, each launch's device ms,
the bound) beside the empty-kernel floor.

    python3 tools/ssd_probe.py                # build, check, time
    python3 tools/ssd_probe.py --groups 4,8,20  # also time other head groups

on a machine with one CUDA card, from the root of a checkout; about a
minute, the build included. ``--groups`` times the rows again with the
output launch's head group forced, to check ``ssd_plan``'s choice. It
prints the card, one JSON line per case and per timed row, and exits 1 if
a case disagrees with the plain version (2e-3).
"""
from __future__ import annotations

import argparse
import json
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
from repro_torch.kernels import ssd_scan as sd  # noqa: E402

# (B, S, H, P, N, chunk, stress, pad): pad positions of dt = 0 at the end
CASES = [
    (1, 2048, 80, 64, 128, 256, False, 0),    # mamba2's forward
    (1, 2048, 80, 64, 128, 256, True, 0),
    (1, 2048, 80, 64, 64, 256, False, 0),     # zamba2's
    (1, 2048, 80, 64, 64, 256, True, 0),
    (1, 1024, 80, 64, 128, 256, True, 24),    # 1000 positions padded
    (1, 4096, 80, 64, 128, 256, True, 0),     # 16 chunks
    (2, 512, 80, 64, 128, 256, False, 0),     # two batch rows
    (1, 1024, 80, 64, 128, 128, True, 0),     # the wrapper's chunk
    (1, 1024, 80, 64, 64, 128, False, 0),
    (2, 384, 8, 64, 128, 192, True, 0),
    (1, 256, 3, 64, 64, 64, True, 0),         # an odd head count
    (1, 64, 2, 8, 16, 16, False, 0),          # the JAX tests' shapes
    (2, 128, 6, 16, 32, 32, False, 0),
    (1, 256, 4, 32, 64, 128, False, 0),
    (2, 33, 8, 32, 16, 64, False, 0),
]


def check(g, B, S, H, P, N, chunk, stress, pad) -> bool:
    x, dt, A, Bm, Cm = cs.ssd_inputs(g, S, stress, B=B, H=H, P=P, N=N)
    if pad:
        dt[:, S - pad:] = 0.0
    before = dict(sd.LAUNCHES)
    y, h = sd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    moved = {k: sd.LAUNCHES[k] - before[k] for k in before
             if sd.LAUNCHES[k] != before[k]}
    y2, h2 = sd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    yp, hp = sd.ssd_scan_plain(x[:, :S - pad], dt[:, :S - pad], A,
                               Bm[:, :S - pad], Cm[:, :S - pad])
    torch.cuda.synchronize()
    face = sd.ssd_face(P, N, min(chunk, S))
    ok = (bool(torch.isfinite(y).all() and torch.isfinite(h).all())
          and torch.allclose(y[:, :S - pad], yp, **cs.SSD_TOL)
          and torch.allclose(h, hp, **cs.SSD_TOL)
          and torch.equal(y, y2) and torch.equal(h, h2)
          and moved == {"ssd_scan": 1, f"ssd_scan_{face}": 1})
    print(json.dumps(dict(
        B=B, S=S, H=H, P=P, N=N, chunk=chunk, stress=stress, pad=pad,
        face=face, y_err=(y[:, :S - pad] - yp).abs().max().item(),
        h_err=(h - hp).abs().max().item(), y_max=yp.abs().max().item(),
        bitwise=torch.equal(y, y2) and torch.equal(h, h2), moved=moved,
        ok=ok)), flush=True)
    return ok


def time_rows(g, tag=""):
    for name, N in (("ssd_scan", 128), ("ssd_scan_zamba2", 64)):
        r = cs.time_ssd(sd, g, N)
        r["bound_ms"], r["bound_by"] = cs.bound_ms(r["bytes"], r["flops"],
                                                   r.pop("dtype"))
        print(json.dumps({"row": name + tag, **{k: r[k] for k in (
            "ms", "tile_ms", "plain_ms", "bound_ms", "bound_by", "face",
            "plan", "launches_ms", "tile_launches_ms", "shape")},
            "ms_range": [r["ms"].lo, r["ms"].hi],
            "tile_ms_range": [r["tile_ms"].lo, r["tile_ms"].hi]}),
            flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", default="",
                    help="comma-separated head groups to time as well")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    logs = build.build_all(["ssd_wgmma", "ssd_scan"])
    for fn, props, regs in re.findall(
            r"Function properties for (\S+)\n(.*?)Used (\d+) registers",
            logs["ssd_wgmma"], flags=re.S):
        print(json.dumps({"kernel": cs.demangle([fn])[0],
                          "registers": int(regs), "spill_bytes": sum(
                              int(n) for n in re.findall(
                                  r"(\d+) bytes spill", props))}),
              flush=True)
    print(json.dumps({"tensor_core_instructions": cs.tensor_core_instructions(
        build, ["ssd_wgmma", "ssd_scan"])}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    bad = sum(not check(g, *case) for case in CASES)
    print(json.dumps({"cases_failed": bad}), flush=True)
    if bad:
        return 1
    floor = cs.time_empty()["ms"]
    print(json.dumps({"row": "empty_kernel", "ms": floor,
                      "ms_range": [floor.lo, floor.hi]}), flush=True)
    time_rows(g)
    plan = sd.ssd_plan
    for G in (int(v) for v in args.groups.split(",") if v):
        def forced(*a, G=G):
            return {**plan(*a), "G": G}
        sd.ssd_plan = forced
        time_rows(g, f"_G{G}")
    sd.ssd_plan = plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
