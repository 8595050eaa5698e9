"""The step scorer (K2) on the card, quickly: build ``csrc/step_score.cu``,
print each instance's registers and spills, check that the kernel's
shared-memory sum agrees with ``score_plan``'s, hold the kernel to the
plain version (and to ``step_score_face_plain``, its sum order) over the
main paths' shapes and the edges (B 1 to 130, D 1 to 6144, hidden 32 to
1024, bf16 and f32 hidden states, a W1 that is not 16-byte aligned, plans
of several passes and lane tiles), check that two calls, a graph replay and
the eager call, and two calls in flight on two streams all agree bit for
bit, and time the K2 rows with ``chip_smoke.py``'s ``time_cuda`` beside
the empty-kernel floor: each row's kernel and each launch's device ms
(``torch.profiler``).

    python3 tools/score_probe.py                  # build, check, time
    python3 tools/score_probe.py --time-only --root <checkout>

on a machine with one CUDA card, from the root of a checkout; about a
minute, the build included. ``--root`` times the scorer of another
checkout (an unpacked parent commit, say) with this one's timing code, so
that two versions can be compared within one call. It prints the card,
one JSON line per case and per timed row, and exits 1 if a check fails
(scores within 1e-5 of the plain version).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (B, D, Hd): the main paths' shapes, then the edges
CASES = [
    (16, 2560, 512), (64, 2560, 512), (16, 4096, 512), (4, 4096, 512),
    (16, 256, 512), (8, 2048, 512), (8, 3072, 512), (8, 6144, 512),
    (1, 256, 512), (13, 256, 512), (130, 1000, 512), (13, 1000, 32),
    (13, 1000, 1024), (1, 1, 512), (16, 1, 32), (5, 1001, 64),
    (64, 6144, 512), (130, 6144, 1024), (33, 20000, 128),
]
# (row, B, D): the kernel table's K2 rows (hidden width 512)
TIMED = [("step_score", 16, 2560), ("step_score_d4096", 16, 4096),
         ("step_score_d256", 16, 256), ("step_score_b64", 64, 2560),
         ("step_score_d2048", 8, 2048), ("step_score_d3072", 8, 3072),
         ("step_score_d6144", 8, 6144)]


def inputs(torch, g, B, D, Hd, dtype):
    h = torch.randn(B, D, generator=g, device="cuda").to(dtype)
    w1 = torch.randn(D, Hd, generator=g, device="cuda") * D ** -0.5
    b1 = torch.randn(Hd, generator=g, device="cuda") * 0.1
    w2 = torch.randn(Hd, 1, generator=g, device="cuda") * Hd ** -0.5
    b2 = torch.randn(1, generator=g, device="cuda") * 0.1
    return h, w1, b1, w2, b2


def checks(torch, cs, ss, g) -> int:
    bad = 0
    lib = ss._library()
    for rows in (1, 4, 40, 96, 136, 256):
        for lt in ss.LANE_TILES:
            for cl in (1, 2, 4, 8):
                for bf16 in (0, 1):
                    if lib.repro_step_score_smem(rows, lt, cl, bf16) != \
                            ss.score_smem(rows, lt, cl, 2 if bf16 else 4):
                        print(json.dumps({"smem_disagrees":
                                          [rows, lt, cl, bf16]}))
                        bad += 1
    for B, D, Hd in CASES:
        for dtype in (torch.bfloat16, torch.float32):
            args = inputs(torch, g, B, D, Hd, dtype)
            got = ss.step_score(*args)
            again = ss.step_score(*args)
            want = ss.step_score_plain(*args)
            face = ss.step_score_face_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = (bool(torch.isfinite(got).all())
                  and torch.allclose(got, want, **cs.SCORE_TOL)
                  and torch.equal(got, again))
            bad += not ok
            print(json.dumps(dict(
                B=B, D=D, Hd=Hd, dtype=str(dtype)[6:], err=err,
                face_err=(got - face).abs().max().item(), ok=ok,
                plan=ss.score_plan(B, D, Hd,
                                   ss.card_fits(torch.device("cuda"))))),
                flush=True)
    # a W1 that is not 16-byte aligned: the wrapper clones it
    h, w1, b1, w2, b2 = inputs(torch, g, 16, 2560, 512, torch.bfloat16)
    w1_odd = torch.empty(w1.numel() + 1, device="cuda")[1:].view_as(w1)
    w1_odd.copy_(w1)
    ok = torch.equal(ss.step_score(h, w1_odd, b1, w2, b2),
                     ss.step_score(h, w1, b1, w2, b2))
    bad += not ok
    print(json.dumps({"w1_unaligned_equal": ok}), flush=True)
    # a graph replay against the eager call; then new hiddens
    eager = ss.step_score(h, w1, b1, w2, b2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss.step_score(h, w1, b1, w2, b2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ss.step_score(h, w1, b1, w2, b2)
    replays = []
    for _ in range(3):
        graph.replay()
        replays.append(out.clone())
    torch.cuda.synchronize()
    ok = all(torch.equal(r, eager) for r in replays)
    h.copy_(torch.randn(h.shape, generator=g, device="cuda"))
    graph.replay()
    ok = ok and torch.equal(out, ss.step_score(h, w1, b1, w2, b2))
    bad += not ok
    print(json.dumps({"graph_replay_equal": ok}), flush=True)
    # two calls in flight on two streams, many times over
    streams = [torch.cuda.Stream() for _ in range(2)]
    sets = [inputs(torch, g, 16, 2560, 512, torch.bfloat16)
            for _ in range(2)]
    want = [ss.step_score(*s) for s in sets]
    torch.cuda.synchronize()
    ok = True
    for _ in range(20):
        outs = []
        for st, s in zip(streams, sets):
            with torch.cuda.stream(st):
                outs.append(ss.step_score(*s))
        torch.cuda.synchronize()
        ok = ok and all(torch.equal(o, w) for o, w in zip(outs, want))
    bad += not ok
    print(json.dumps({"two_streams_equal": ok}), flush=True)
    return bad


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
    from repro_torch.kernels import step_score as ss

    if not torch.cuda.is_available():
        print("score_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    log = build.build_all(["step_score"])["step_score"]
    for fn, props, regs in re.findall(
            r"Function properties for (\S+)\n(.*?)Used (\d+) registers", log,
            flags=re.S):
        print(json.dumps({"kernel": cs.demangle([fn])[0],
                          "registers": int(regs),
                          "spills": re.findall(r"\d+ bytes spill \w+",
                                               props)}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    if hasattr(ss, "card_fits"):
        print(json.dumps({"fits": ss.card_fits(torch.device("cuda"))}),
              flush=True)
    if not args.time_only:
        bad = checks(torch, cs, ss, g)
        print(json.dumps({"cases": len(CASES) * 2, "checks_failed": bad}),
              flush=True)
        if bad:
            return 1
    floor = cs.time_empty()["ms"]
    print(json.dumps({"row": "empty_kernel", "root": args.root, "ms": floor,
                      "ms_range": [floor.lo, floor.hi]}), flush=True)
    for name, B, D in TIMED:
        h, w1, b1, w2, b2 = inputs(torch, g, B, D, 512, torch.bfloat16)
        ms = cs.time_cuda(lambda: ss.step_score(h, w1, b1, w2, b2))
        row = {"row": name, "root": args.root, "ms": ms,
               "ms_range": [ms.lo, ms.hi],
               "launches_ms": cs.device_split(
                   lambda: ss.step_score(h, w1, b1, w2, b2))}
        if hasattr(ss, "card_fits"):
            row["plan"] = ss.score_plan(B, D, 512,
                                        ss.card_fits(torch.device("cuda")))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
