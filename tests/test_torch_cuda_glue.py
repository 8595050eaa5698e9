"""The decode layer's fused glue on a card (``csrc/decode_glue.cu``): each
kernel against the chain of PyTorch ops it replaces, run on the card;
the kernels inside a CUDA graph capture; and a decode horizon on the
fused route against the same horizon on the chain. Every test needs a
CUDA card (and ``nvcc`` for the first build) and skips without one; the
file imports no jax:

    python -m pytest -q -s -m cuda tests/test_torch_cuda_glue.py

(``-s`` shows each norm's share of values one bf16 ulp from the chain's.)

Tolerances: ``silu_mul``, the residual sum and the V write are equal to
the chain bit for bit, and so is RoPE without qk-norm; a normed value
lies within one bf16 ulp of the chain's (the norms sum their squares in
another order than torch's reduction). A horizon carries such an ulp
into the next layer: its logits and pool slots are held at bf16's 1e-2.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import decode_glue as G  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from torch_glue_cases import (BF16, CASES, EPS, SHAPES, prologue_args,  # noqa: E402
                              prologue_case, prologue_chain, randn,
                              rotated_within, within_one_ulp)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _counted(name: str, fn):
    before = ops.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    return out


@pytest.mark.parametrize("shape", [(64, 9728), (8, 64, 14336), (3, 37),
                                   (1, 1)],
                         ids=["qwen3", "mixtral_experts", "ragged", "one"])
def test_silu_mul_kernel_equals_chain(gen, shape):
    g, u = randn(gen, *shape, scale=4), randn(gen, *shape)
    got = _counted("silu_mul", lambda: ops.silu_mul(g, u))
    assert torch.equal(got, F.silu(g.float()).to(BF16) * u)
    assert torch.equal(L.silu_gate(g, u, use_kernel=True), got)
    assert torch.equal(L.silu_gate(g, u), got)   # the ops, kernel off


@pytest.mark.parametrize("with_delta", [True, False])
@pytest.mark.parametrize("name", ["qwen3", "mixtral", "hd64"])
def test_add_rms_norm_kernel_within_one_ulp(gen, name, with_delta):
    D = SHAPES[name][3]
    h, w = randn(gen, 64, D), randn(gen, D, scale=0.1) + 1
    delta = randn(gen, 64, D, scale=0.5) if with_delta else None
    h2, y = _counted("add_rms_norm",
                     lambda: ops.add_rms_norm(h, delta, w, EPS))
    want_h = h + delta if with_delta else h
    assert torch.equal(h2, want_h)
    off = within_one_ulp(y, L.rms_norm(want_h, w, EPS))
    print(f"add_rms_norm {name} delta={with_delta}: {off:.4%} one ulp off")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_attn_prologue_kernel_matches_chain(gen, name, case):
    c = prologue_case(name, case, gen)
    want_pools = [p.clone() for p in c["pools"]]
    want_q, want_lens = prologue_chain(c, want_pools)
    lens = torch.full_like(want_lens, -1)
    q = _counted("attn_prologue",
                 lambda: ops.attn_prologue(*prologue_args(c, c["pools"],
                                                          lens)))
    assert torch.equal(lens, want_lens)
    # without a writer, frozen lanes race on the scratch block 0 in both
    rows = slice(1, None) if case == "frozen" else slice(None)
    (k_got, v_got), (k_want, v_want) = ([p[rows] for p in ps]
                                        for ps in (c["pools"], want_pools))
    assert torch.equal(v_got, v_want)       # the V write is a copy
    if c["q_norm"] is None:                 # no norm: RoPE is bit-equal
        assert torch.equal(q, want_q) and torch.equal(k_got, k_want)
    else:   # the norm within one ulp, and that ulp carried through RoPE
        close = within_one_ulp if case == "origin" else rotated_within
        off = (close(q, want_q), close(k_got, k_want))
        print(f"attn_prologue {name} {case}: q {off[0]:.4%}, "
              f"K {off[1]:.4%} apart")


def test_glue_kernels_replay_in_a_cuda_graph(gen):
    """All three kernels captured once, replayed over new inputs copied
    into the captured ones: the eager results, and the launches the
    capture recorded (one each)."""
    c = prologue_case("qwen3", "writer", gen)
    D = SHAPES["qwen3"][3]
    h, d, w = randn(gen, 64, D), randn(gen, 64, D), randn(gen, D)
    g, u = randn(gen, 64, 9728), randn(gen, 64, 9728)
    pools = [p.clone() for p in c["pools"]]
    lens = torch.empty((64,), dtype=torch.int32, device="cuda")
    table = G.rope_table(128, 1e6, "cuda")

    def step():
        return (ops.add_rms_norm(h, d, w, EPS),
                ops.attn_prologue(*prologue_args(c, pools, lens, table)),
                ops.silu_mul(g, u))

    step()                                  # the library loads outside
    torch.cuda.synchronize()
    base = [p.clone() for p in pools]       # the pools the replay starts on
    graph = torch.cuda.CUDAGraph()
    with ops.launches_withheld() as made, torch.cuda.graph(graph):
        (h2, y), q, act = step()
    assert made == {"add_rms_norm": 1, "attn_prologue": 1, "silu_mul": 1}
    for t in (h, d, g, c["q"], c["k"], c["v"]):
        t.copy_(randn(gen, *t.shape))
    c["positions"].add_(3)
    graph.replay()
    torch.cuda.synchronize()
    eager_pools = [p.clone() for p in base]
    (h3, y3), q3, act3 = (ops.add_rms_norm(h, d, w, EPS),
                          ops.attn_prologue(*prologue_args(c, eager_pools)),
                          ops.silu_mul(g, u))
    for got, want in ((h2, h3), (y, y3), (q, q3), (act, act3),
                      (pools[0], eager_pools[0]), (pools[1], eager_pools[1])):
        assert torch.equal(got, want)


# an out-of-range index faults the launch (the CUDA context is lost, so each
# case runs in a process of its own); "none" is the same script in range
_FAULT_SCRIPT = """
import sys
import torch
from repro_torch.kernels import ops
from torch_glue_cases import prologue_args, prologue_case
c = prologue_case("qwen3", "plain", torch.Generator("cuda").manual_seed(0))
fault = sys.argv[1]
if fault == "block_id":     # a table entry past the pool
    c["block_tables"][5, :] = c["pools"][0].shape[0]
elif fault == "page":       # a slot past the table row (no window)
    c["window_len"] = 0
    c["positions"][5] = c["block_tables"].shape[1] * 16
ops.attn_prologue(*prologue_args(c, c["pools"]))
torch.cuda.synchronize()
print("ran")
"""


@pytest.mark.parametrize("fault", ["none", "block_id", "page"])
def test_attn_prologue_faults_out_of_range(gen, fault):
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), str(root / "tests")]))
    run = subprocess.run([sys.executable, "-c", _FAULT_SCRIPT, fault],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    if fault == "none":
        assert run.returncode == 0 and "ran" in run.stdout, run.stderr
    else:
        assert run.returncode != 0 and "ran" not in run.stdout
        assert "CUDA" in run.stderr or "cuda" in run.stderr, run.stderr[-2000:]


# ---------------------------------------------------------------------------
# a decode horizon, fused against the chain
# ---------------------------------------------------------------------------

def _model(arch: str, layers: int, gen):
    """``arch`` at published widths, cut to ``layers`` layers, with norms
    other than ones. An MoE takes a zero router, so every token routes to
    experts 0 and 1 on both routes (a router near a tie could otherwise
    part them by the norms' last ulp), and capacity E/K, which drops no
    pair."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if cfg.uses_moe:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=float(
            cfg.num_experts // cfg.num_experts_per_tok))
    params = init_params(cfg, gen)
    if cfg.uses_moe:
        params["layers"]["moe"]["router"].zero_()
    for key in ("ln1", "ln2"):
        w = params["layers"][key]
        w.copy_(randn(gen, *w.shape, scale=0.1) + 1)
    for key in ("q_norm", "k_norm"):
        if key in params["layers"]["attn"]:
            w = params["layers"]["attn"][key]
            w.copy_(randn(gen, *w.shape, scale=0.1) + 1)
    return cfg, params


def _horizon(cfg, params, use_kernel=True, kv_dtype="bf16", seed=7,
             count=False):
    """A horizon of 4 at 64 lanes over a pool of random K/V (block 0
    scratch): lanes 8..11 dead, lanes 12..15 stopping after one
    iteration. Tokens are fed from a fixed table, so both routes decode
    the same inputs; each iteration's confidence is the sampled token's
    softmax weight. Returns the horizon's outputs, one more decode step's
    (logits and hidden), the pools after the horizon and the slots it
    wrote.
    ``count``: capture the horizon and return the kernel launches the
    capture recorded instead."""
    B, cap, horizon = 64, 256, 4
    bs = cfg.kv_block_size
    bp = cap // bs
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = tm.init_decode_cache(cfg, B, cap, num_blocks=B * bp + 1,
                                 kv_dtype=kv_dtype, device="cuda")
    for key in ("k_pool", "v_pool"):
        if cache[key].dtype == BF16:
            cache[key].copy_(randn(g, *cache[key].shape))
    cache["block_tables"] = (torch.randperm(B * bp, generator=g,
                                            device="cuda") + 1
                             ).reshape(B, bp).to(torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (B,), generator=g,
                         device="cuda", dtype=torch.int32)
    pos = torch.randint(0, cap - horizon, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    limits = torch.full((B,), horizon, dtype=torch.int32, device="cuda")
    limits[8:12], limits[12:16] = 0, 1
    feed = torch.randint(3, cfg.vocab_size, (horizon, B), generator=g,
                         device="cuda", dtype=torch.int32)
    step = iter(range(horizon))

    def sample(rng, logits):
        tok = feed[next(step)]
        conf = torch.softmax(logits.float(), -1).gather(1, tok.long()[:, None])
        return tok, conf[:, 0]

    def run():
        return tm.multi_decode_step(
            params, cfg, toks, pos, limits, cache, window_len=cap,
            horizon=horizon, rng=None, sample_fn=sample, eos_id=2,
            step_id=5, scratch_block=0, use_kernel=use_kernel)

    if count:
        with ops.launches_withheld():       # the libraries load outside
            run()
        step = iter(range(horizon))
        graph = torch.cuda.CUDAGraph()
        with ops.launches_withheld() as made, torch.cuda.graph(graph):
            run()
        return made
    before = {k: cache[k].clone() for k in ("k_pool", "v_pool")}
    out = run()
    pools = {k: cache[k].clone() for k in before}
    written = {k: (pools[k] != v).flatten(-2).any(-1)
               for k, v in before.items()}
    step = tm.decode_step(params, cfg, out["final_tokens"][:, None],
                          out["positions"], cache, window_len=cap,
                          use_kernel=use_kernel)
    torch.cuda.synchronize()
    return out, step, pools, written


@pytest.mark.parametrize("arch,layers", [("qwen3-4b-thinking", 2),
                                         ("mixtral-8x7b", 2)])
def test_fused_horizon_matches_chain(gen, monkeypatch, arch, layers):
    """The fused glue against the chain, both over the kernel attention.
    ``use_kernel=False`` would swap the attention for the dense path too
    (which parts most logits from the kernel's by an ulp or two), so the
    chain's side is this test's route patch: the port's program before
    the glue was fused."""
    cfg, params = _model(arch, layers, gen)
    fused, fused_step, fused_cache, fused_w = _horizon(cfg, params)
    with monkeypatch.context() as patch:
        patch.setattr(L, "glue_route", lambda *a, **k: "chain")
        chain, chain_step, chain_cache, chain_w = _horizon(cfg, params)
    for key in ("tokens", "token_valid", "final_tokens", "positions"):
        assert torch.equal(fused[key], chain[key]), key
    # lanes 8..15 stop: they read the scratch block, which their racing
    # writes fill with any one lane's K/V on either route
    live = torch.ones(64, dtype=torch.bool, device="cuda")
    live[8:16] = False
    # each within 1e-2 of its largest magnitude: a bf16 logit of 2-5 is
    # 1-2 ulps (0.016-0.031) from its neighbours
    got, want = (st["logits"][live].float()
                 for st in (fused_step, chain_step))
    vocab = torch.isfinite(want)
    close_to_scale(f"{arch} logits", got[vocab], want[vocab])
    close_to_scale(f"{arch} hidden", fused_step["hidden"][live],
                   chain_step["hidden"][live])
    close_to_scale(f"{arch} confidences", fused["confidences"][live],
                   chain["confidences"][live])
    for key in ("k_pool", "v_pool"):
        # block 0 is scratch: the dense stack's frozen lanes race on it
        assert torch.equal(fused_w[key][:, 1:], chain_w[key][:, 1:])
        close_to_scale(f"{arch} {key}", fused_cache[key][:, 1:],
                       chain_cache[key][:, 1:])


def close_to_scale(what: str, got: torch.Tensor, want: torch.Tensor,
                   tol: float = 1e-2) -> None:
    """``got`` within ``tol`` of ``want``'s largest magnitude; prints the
    share of values apart and the largest distance."""
    got, want = got.float(), want.float()
    apart = (got - want).abs()
    scale = float(want.abs().max())
    print(f"{what}: {float((apart > 0).float().mean()):.4%} apart, at most "
          f"{float(apart.max()):.3g} (largest |value| {scale:.3g})")
    assert float(apart.max()) <= tol * scale


@pytest.mark.parametrize("arch,kv_dtype,want", [
    ("qwen3-4b-thinking", "bf16", "fused"),
    ("mixtral-8x7b", "bf16", "fused"),
    ("qwen3-4b-thinking", "int8", "chain"),
    ("qwen3-4b-thinking", "bf16", "off"),
    ("mixtral-8x7b", "bf16", "off"),
])
def test_captured_horizon_counts_the_fused_route(gen, arch, kv_dtype, want):
    """A captured horizon of 4 records, per iteration and layer, two
    ``add_rms_norm`` (plus the final norm), one ``attn_prologue`` and one
    ``silu_mul`` (the MoE's expert gate, or SwiGLU's); over an int8 pool
    the route is the chain and only the gate takes its kernel; with
    ``use_kernel`` off ("off") no glue kernel runs at all."""
    layers = 3
    cfg, params = _model(arch, layers, gen)
    made = _horizon(cfg, params, use_kernel=want != "off",
                    kv_dtype=kv_dtype, count=True)
    fused = want == "fused"
    assert made.get("add_rms_norm", 0) == (4 * (2 * layers + 1) if fused
                                           else 0)
    assert made.get("attn_prologue", 0) == (4 * layers if fused else 0)
    assert made.get("silu_mul", 0) == (0 if want == "off" else 4 * layers)


def test_f32_horizon_takes_no_glue_kernel(gen):
    cfg, params = _model("qwen3-4b-thinking", 2, gen)
    f32 = torch.utils._pytree.tree_map(lambda t: t.float(), params)
    made = _horizon(cfg, f32, kv_dtype="f32", count=True)
    assert not any(made.get(k, 0) for k in G.LAUNCHES)


@pytest.mark.parametrize("kv_dtype,fused", [("bf16", True), ("int8", False)])
def test_engine_capture_span_shows_the_glue_route(gen, kv_dtype, fused):
    """A graphed bf16 engine at the smoke config, traced: its decode graph's
    ``capture`` span carries the launches the capture recorded, the fused
    glue's among them (per iteration: 2 L + 1 ``add_rms_norm``, L
    ``attn_prologue``, L ``silu_mul``); over an int8 pool none of the
    route's, and each replay adds the recorded launches to the counts."""
    from repro_torch.configs.registry import serving_config
    from repro_torch.core.pruning import make_policy
    from repro_torch.data.tokenizer import get_tokenizer
    from repro_torch.serving import engine as te
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.tracing import Tracer
    cfg = serving_config()
    greedy = SamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                            max_new_tokens=12)
    ecfg = te.EngineConfig(max_batch=4, num_blocks=16, capacity=64,
                           max_new_tokens=12, sampling=greedy,
                           use_kernel=True, decode_horizon=4,
                           kv_dtype=kv_dtype)
    eng = te.Engine(init_params(cfg, gen), cfg, ecfg, make_policy("step"),
                    device="cuda")
    eng.tracer = Tracer()
    ops.reset_launch_counts()
    eng.serve(get_tokenizer().encode("3+5-2=", add_bos=True), 4)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    captures = [s for s in eng.tracer.spans if s.name == "capture"]
    assert captures and counts["decode_graph_replays"] > 0
    L_ = cfg.num_layers
    for span in captures:
        made, hz = span.args["launches"], span.args["key"][0]
        assert made.get("add_rms_norm", 0) == (hz * (2 * L_ + 1) if fused
                                               else 0)
        assert made.get("attn_prologue", 0) == (hz * L_ if fused else 0)
        assert made.get("silu_mul", 0) == hz * L_
    assert (counts["attn_prologue"] > 0) == fused
    assert counts["attn_prologue"] % L_ == 0
