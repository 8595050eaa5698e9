"""The engine's tracer (``serving/tracing.py``) on the CPU: the span tree a
serve leaves is well formed, its counts agree with the serve's results, a
traced serve gives exactly the untraced one's tokens, scores, prunes and
answers, the export is valid Chrome trace JSON, and the benchmark's
readers of the trace (``portbench/metrics/``) read it."""
import json

import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

from repro_torch.configs.registry import serving_config  # noqa: E402
from repro_torch.core.pruning import make_policy  # noqa: E402
from repro_torch.core.scorer import init_scorer  # noqa: E402
from repro_torch.data.tokenizer import get_tokenizer  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.serving import engine as te  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from repro_torch.serving.tracing import NULL_TRACER, Tracer  # noqa: E402

SAMPLED = SamplingParams(temperature=0.8, top_k=20, top_p=0.95,
                         max_new_tokens=40)
GREEDY = SamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                        max_new_tokens=40)

# case -> (EngineConfig overrides, (prompt, traces, arrival, sampling)...)
CASES = {
    # a short pool: one-shot prefills, COW copies, memory-full prunes
    "pressure": (dict(num_blocks=14),
                 [(0, 4, 0.0, None), (1, 4, 0.002, None),
                  (2, 4, 0.004, None)]),
    # chunked prefills over the prefix cache, arrivals while lanes decode
    "chunked": (dict(num_blocks=40, prefill_chunk_size=8),
                [(2, 3, 0.0, None), (2, 3, 0.01, None),
                 (0, 2, 0.02, None)]),
    # per-request sampling: the lane-wise decode key
    "lanewise": (dict(num_blocks=24),
                 [(0, 4, 0.0, SAMPLED), (1, 4, 0.0, GREEDY)]),
}


@pytest.fixture(scope="module")
def model():
    cfg = serving_config("qwen3-4b-thinking")
    g = torch.Generator().manual_seed(0)
    return cfg, init_params(cfg, g), init_scorer(g, cfg.d_model)


def _prompts():
    tok = get_tokenizer()
    texts = ["3+5-2=", "12-4+7=1", "6-1+2-3=" * 4 + "1+1="]
    return [tok.encode(t, add_bos=True) for t in texts]


def _serve(model, case, tracer=None):
    cfg, params, scorer = model
    over, reqs = CASES[case]
    kw = dict(max_batch=8, capacity=128, max_new_tokens=40,
              sampling=SAMPLED, use_kernel=True, decode_horizon=4,
              faults=None, kv_dtype="f32", seed=3)
    kw.update(over)
    eng = te.Engine(params, cfg, te.EngineConfig(**kw), make_policy("step"),
                    scorer_params=scorer, device="cpu")
    if tracer is not None:
        eng.tracer = tracer
    prompts = _prompts()
    results = eng.serve_batch([
        te.Request(request_id=i, prompt_tokens=list(prompts[p]),
                   n_traces=n, policy=make_policy("step"), arrival_time=t,
                   sampling=sp)
        for i, (p, n, t, sp) in enumerate(reqs)])
    return eng, results


@pytest.fixture(scope="module")
def traced(model):
    out = {}
    for case in CASES:
        eng, results = _serve(model, case, Tracer())
        out[case] = (eng, results, eng.tracer.export())
    return out


def _events(trace, ph, cat=None):
    return [e for e in trace["traceEvents"] if e["ph"] == ph
            and (cat is None or e.get("cat") == cat)]


def _named(trace, name, ph="X", cat="host"):
    return [e for e in _events(trace, ph, cat) if e["name"] == name]


@pytest.mark.parametrize("case", list(CASES))
def test_span_tree_is_well_formed(traced, case):
    _, _, trace = traced[case]
    host = {e["args"]["id"]: e for e in _events(trace, "X", "host")}
    assert len(_named(trace, "serve")) == 1
    for e in host.values():
        parent = e["args"]["parent"]
        if parent is None:
            assert e["name"] == "serve"
            continue
        p = host[parent]
        assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
    for d in _events(trace, "X", "device"):   # CPU: inside the host's call
        h = host[d["args"]["host"]]
        assert h["ts"] <= d["ts"] and d["ts"] + d["dur"] <= h["ts"] + h["dur"]
    replenish = _named(trace, "BudgetReplenish", "i", None)
    bursts = _named(trace, "BurstDone", "i", None)
    assert len(_named(trace, "round")) == len(replenish) > 0
    assert len(_named(trace, "decode")) == len(_named(trace, "sync")) \
        == len(_named(trace, "launch")) == len(bursts) > 0
    assert len(_named(trace, "decode", cat="device")) == len(bursts)
    for name in ("decode", "sync", "fold", "upload", "write_blocks"):
        for e in _named(trace, name):
            assert host[e["args"]["parent"]]["name"] == "round"
    chunks = sorted(e["args"]["rid"] for e in _named(trace, "prefill_chunk"))
    done = sorted(e["args"]["request_id"]
                  for e in _named(trace, "ChunkDone", "i", None))
    assert chunks == done
    if case == "chunked":
        assert chunks
        assert len(_named(trace, "prefill_chunk", cat="device")) == len(done)


@pytest.mark.parametrize("case", list(CASES))
def test_counts_agree_with_the_results(traced, case):
    eng, results, trace = traced[case]
    prunes = _named(trace, "prune", "i", None)
    assert len(prunes) == sum(r.num_pruned for r in results)
    if case == "pressure":
        assert prunes
        assert all(e["args"]["least"] <= e["args"]["score"] for e in prunes
                   if e["args"]["at"] in ("admission", "decode"))
    live = sum(e["args"]["live"] for e in _named(trace, "decode"))
    emitted = sum(e["args"]["tokens"]
                  for e in _named(trace, "BurstDone", "i", None))
    assert live == emitted == sum(
        e["args"]["tokens"] for e in _events(trace, "C")
        if e["name"] == "burst") > 0
    pool = [e["args"] for e in _events(trace, "C") if e["name"] == "pool"]
    assert pool
    n = eng.ecfg.num_blocks
    for row in pool:
        assert all(0 <= v <= n for v in row.values())
        assert sum(row.values()) == n - 1
    queue = [e["args"] for e in _events(trace, "C") if e["name"] == "queue"]
    assert all(q["running"] <= eng.ecfg.max_batch for q in queue)


@pytest.mark.parametrize("case", list(CASES))
def test_tracing_changes_nothing_served(model, traced, case):
    eng, want = _serve(model, case)
    assert eng.tracer is NULL_TRACER
    _, got, _ = traced[case]
    for a, b in zip(want, got):
        assert (a.answer, a.num_pruned, a.status) == \
            (b.answer, b.num_pruned, b.status)
        for ta, tb in zip(a.traces, b.traces):
            assert ta.output_tokens == tb.output_tokens
            assert ta.step_scores == tb.step_scores
            assert ta.token_confidences == tb.token_confidences
            assert ta.status == tb.status
    off = eng.tracer.export()
    assert [e["ph"] for e in off["traceEvents"]] == ["M"] * 3


@pytest.mark.parametrize("case", list(CASES))
def test_export_is_chrome_trace_json(traced, case):
    _, _, trace = traced[case]
    back = json.loads(json.dumps(trace, allow_nan=False))
    assert back == trace
    assert back["displayTimeUnit"] == "ms"
    for e in back["traceEvents"]:
        assert e["ph"] in ("X", "i", "C", "M") and e["pid"] == 1
        assert isinstance(e["name"], str)
        if e["ph"] == "M":
            continue
        assert isinstance(e["ts"], float)
        if e["ph"] == "X":
            assert e["dur"] >= 0 and e["tid"] in (1, 2)
        elif e["ph"] == "i":
            assert e["s"] == "t" and e["tid"] == 1
        else:
            assert all(isinstance(v, int) for v in e["args"].values())
    ts = [e["ts"] for e in back["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts)


def test_export_times_count_from_the_origin(traced):
    eng = traced["pressure"][0]
    t0 = eng.tracer.spans[-1].t0 / 1e9     # the serve span's start
    trace = eng.tracer.export(origin_s=t0)
    assert _named(trace, "serve")[0]["ts"] == pytest.approx(0.0, abs=1e-3)


def test_profiler_ranges_carry_the_phase_names(model):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(model, "lanewise", Tracer())
    names = {e.key for e in prof.key_averages()}
    assert {"serve", "round", "decode", "launch", "sync", "fold"} <= names
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(model, "lanewise", Tracer(profiler_ranges=False))
    assert "round" not in {e.key for e in prof.key_averages()}


def test_span_ended_twice_or_left_open():
    tr = Tracer()
    outer = tr.span("serve")
    round_ = tr.span("round")
    tr.span("admit")                   # left open, as an exception would
    tr.end(round_)                     # ends the open child with it
    tr.end(round_)                     # a second end does nothing
    tr.end(outer)
    names = [(s.name, s.parent) for s in tr.spans]
    assert names == [("admit", 1), ("round", 0), ("serve", None)]
    assert all(s.t1 >= s.t0 for s in tr.spans)


# --- the benchmark's readers of the trace ------------------------------

def _record(trace, origin_s=0.0):
    return {"program_trace": trace, "origin_s": origin_s, "profile": None}


@pytest.mark.parametrize("case", list(CASES))
def test_readers_split_the_idle_by_phase(traced, case):
    from portbench.manifest import Manifest
    from portbench.metrics._spans import idle_by_phase
    man = Manifest()
    _, _, trace = traced[case]
    rec = _record(trace)
    idle = man.reader("idle_gap_ms_per_iter").read(rec)
    host = man.reader("host_ms_per_iter").read(rec)
    phases = idle_by_phase(rec)
    assert idle > 0 and host > 0
    assert idle == pytest.approx(
        sum(v for k, v in phases.items() if k != "await_arrival"))
    serve = _named(trace, "serve")[0]
    iters = sum(e["args"]["horizon"] for e in _named(trace, "decode"))
    assert idle <= serve["dur"] / 1e3 / iters
    assert man.reader("graph_capture_s").read(rec) == 0.0   # no graph
    late = _record(trace, origin_s=(serve["ts"] + serve["dur"]) / 1e6)
    assert man.reader("host_ms_per_iter").read(late) is None


def test_readers_are_silent_without_the_trace(monkeypatch):
    import sys

    from portbench import program_trace
    from portbench.manifest import Manifest
    man = Manifest()
    for name in ("host_ms_per_iter", "idle_gap_ms_per_iter",
                 "graph_capture_s"):
        assert man.reader(name).read(_record(None)) is None
    monkeypatch.setitem(sys.modules, "repro_torch.serving.tracing", None)

    class Old:
        pass
    eng = Old()
    assert program_trace.attach(eng) is False
    assert program_trace.export(eng, 0.0) is None


CELLS = ["qwen3-4b.step-n64", "mixtral-8x7b.step-n64",
         "qwen3-4b.fewshot-open"]
NEW_METRICS = ("host_ms_per_iter", "idle_gap_ms_per_iter", "graph_capture_s")
TINY_RUNS = """
import json, sys
from portbench import drive, program_trace
from portbench.manifest import Manifest
from portbench.tests._tiny import run_tiny
tracers = []


class Traced(drive.Runner):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        assert program_trace.attach(self.engine)
        tracers.append(self.engine.tracer)


drive.Runner = Traced
man = Manifest()
out = {}
for cell in sys.argv[1:]:
    res = run_tiny(cell, seconds=2.0, trace=True)
    trace = tracers[-1].export(0.0)
    rec = {"program_trace": trace, "origin_s": 0.0, "profile": None}
    suffix = ".open" if "open" in cell else ""
    read = {m: man.reader(m if m == "graph_capture_s" else m + suffix)
            .read(rec) for m in %r}
    serves = [e for e in trace["traceEvents"]
              if e["ph"] == "X" and e["name"] == "serve"]
    decodes = [e for e in trace["traceEvents"] if e["ph"] == "X"
               and e["cat"] == "host" and e["name"] == "decode"]
    out[cell] = {"correct": res["correct"], "metrics": sorted(res["metrics"]),
                 "read": read,
                 "serve_ms": sum(e["dur"] for e in serves) / 1e3,
                 "iterations": sum(e["args"]["horizon"] for e in decodes)}
print(json.dumps(out))
""" % (NEW_METRICS,)


@pytest.fixture(scope="module")
def tiny_runs():
    """Tiny traced runs of the cells through the benchmark's own runner,
    with the program's tracer attached by ``portbench.program_trace``, in
    a process of their own: the benchmark refuses to run beside the JAX
    package, which other test modules load."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), str(root)]), OMP_NUM_THREADS="1")
    done = subprocess.run([sys.executable, "-c", TINY_RUNS, *CELLS],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_tiny_run_reads_the_program_trace(tiny_runs, cell):
    """The benchmark's traced run serves as before with the tracer on
    (the staged readers are in no cell's metrics yet), and the readers
    read the tracer's export of it."""
    res = tiny_runs[cell]
    assert res["correct"]
    assert not [m for m in res["metrics"] if m.startswith(NEW_METRICS)]
    idle, host = (res["read"][m] for m in NEW_METRICS[:2])
    assert res["read"]["graph_capture_s"] == 0.0
    assert 0 < idle <= res["serve_ms"] / res["iterations"]
    assert host > 0
