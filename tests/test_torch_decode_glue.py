"""The decode layer's fused glue (``kernels/decode_glue.py``) on the CPU:
each plain version, which is its CUDA kernel's arithmetic, against the
chain of ops it replaces (``models/layers.py``), at qwen3-4b's and
mixtral's decode shapes and at head dims 64 and 80; the route
(``layers.glue_route``); and the whole fused decode stack, its route
forced on the CPU, against the chain. The kernels themselves are held
on the card: ``tests/test_torch_cuda_glue.py``.

Tolerances: the plain versions are the chain's own ops (one RMSNorm,
``decode_glue.rms_norm``), so on the CPU each equals the chain bit for bit.
The fused stack forced on the CPU runs the same plain versions in another
order of ops: logits and pools at the bf16 tolerance of
``test_torch_model.py``.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import get_config, serving_config  # noqa: E402
from repro_torch.kernels import decode_glue as G  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402

from torch_glue_cases import (BF16, CASES, EPS, SHAPES, prologue_args,  # noqa: E402
                              prologue_case, prologue_chain, randn)


# ---------------------------------------------------------------------------
# add_rms_norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_delta", [True, False])
@pytest.mark.parametrize("name", ["qwen3", "mixtral", "hd64"])
def test_add_rms_norm_plain_matches_chain(name, with_delta):
    D = SHAPES[name][3]
    g = torch.Generator().manual_seed(1)
    h, w = randn(g, 64, D), randn(g, D, scale=0.1) + 1
    delta = randn(g, 64, D, scale=0.5) if with_delta else None
    h2, y = G.add_rms_norm_plain(h, delta, w, EPS)
    want_h = h + delta if with_delta else h
    assert torch.equal(h2, want_h)
    assert torch.equal(y, L.rms_norm(want_h, w, EPS))
    # the wrapper runs the plain version on a CPU tensor, counting nothing
    ops.reset_launch_counts()
    h3, y3 = ops.add_rms_norm(h, delta, w, EPS)
    assert torch.equal(h3, h2) and torch.equal(y3, y)
    assert ops.launch_counts()["add_rms_norm"] == 0


# ---------------------------------------------------------------------------
# the attention prologue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_attn_prologue_plain_matches_chain(name, case):
    c = prologue_case(name, case, torch.Generator().manual_seed(0))
    want_pools = [p.clone() for p in c["pools"]]
    want_q, want_lens = prologue_chain(c, want_pools)
    lens = torch.empty_like(want_lens)
    q = ops.attn_prologue(*prologue_args(c, c["pools"], lens))
    assert q.shape == want_q.shape and torch.equal(lens, want_lens)
    # without a writer the scratch block takes some frozen lane's K/V (the
    # chain's scatter keeps any one of them): left out
    rows = slice(1, None) if case == "frozen" else slice(None)
    (k_got, v_got), (k_want, v_want) = ([p[rows] for p in ps]
                                        for ps in (c["pools"], want_pools))
    assert torch.equal(v_got, v_want)       # the V write is a copy
    assert torch.equal(q, want_q) and torch.equal(k_got, k_want)


@pytest.mark.parametrize("fault", ["block_id", "page"])
def test_attn_prologue_plain_raises_out_of_range(fault):
    """A table entry past the pool, or a slot past its table row, raises
    (the kernel faults on the card, as the chain's gather does)."""
    c = prologue_case("qwen3", "plain", torch.Generator().manual_seed(0))
    if fault == "block_id":
        c["block_tables"][5, :] = c["pools"][0].shape[0]
    else:
        c["window_len"] = 0
        c["positions"][5] = c["block_tables"].shape[1] * 16
    with pytest.raises((IndexError, RuntimeError)):
        ops.attn_prologue(*prologue_args(c, c["pools"]))


def test_rope_table_is_rope_cos_sins_and_kept():
    t = G.rope_table(128, 1e6, "cpu")
    assert t is G.rope_table(128, 1e6, torch.device("cpu"))
    pos = torch.arange(600, dtype=torch.int32)
    cos, sin = L.rope_cos_sin(pos, 128, 1e6)
    angles = pos.float()[:, None] * t
    assert torch.equal(torch.cos(angles), cos)
    assert torch.equal(torch.sin(angles), sin)


# ---------------------------------------------------------------------------
# the SwiGLU gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 9728), (8, 64, 14336), (3, 37)],
                         ids=["qwen3", "mixtral_experts", "ragged"])
def test_silu_mul_plain_matches_chain(shape):
    g = torch.Generator().manual_seed(2)
    gate, up = randn(g, *shape, scale=3), randn(g, *shape)
    want = F.silu(gate.float()).to(BF16) * up
    assert torch.equal(G.silu_mul_plain(gate, up), want)
    assert torch.equal(L.silu_gate(gate, up), want)
    assert torch.equal(L.silu_gate(gate, up, use_kernel=True), want)
    assert torch.equal(ops.silu_mul(gate, up), want)
    # no kernel on the CPU, under autograd, or across dtypes
    assert not G.silu_mul_fits(gate, up)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def _card_batch(dtype=BF16):
    """A stand-in for a decode batch on a card: the route reads only where
    the batch lives and its dtype."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype)


def _route_cache(kv_dtype="bf16", cfg=None):
    cfg = cfg or serving_config()
    return tm.init_decode_cache(cfg, 2, 32, kv_dtype=kv_dtype, device="cpu")


@pytest.mark.parametrize("case", [
    "fused", "cpu", "f32_batch", "int8_pool", "fp8_pool", "f32_pool", "mesh",
    "hybrid", "encoder_decoder", "mla", "ssm", "hd32", "mixtral", "hd80",
    "kernel_off", "data_mesh", "one_rank_mesh"])
def test_glue_route(case):
    cfg, x, kv, tp = serving_config(), _card_batch(), "bf16", None
    use_kernel = case != "kernel_off"
    want = "chain"
    if case in ("fused", "mixtral", "hd80", "one_rank_mesh"):
        want = "fused"
    if case == "cpu":
        x = torch.zeros((2, 1, cfg.d_model), dtype=BF16)
    elif case == "f32_batch":
        x = _card_batch(torch.float32)
    elif case in ("int8_pool", "fp8_pool", "f32_pool"):
        kv = case[:-5]
    elif case in ("mesh", "data_mesh", "one_rank_mesh"):
        # a rank's view of a (data, model) mesh: split over ranks, or one
        # rank whose gathers are no-ops
        data_n, model_n = {"mesh": (1, 2), "data_mesh": (2, 1),
                           "one_rank_mesh": (1, 1)}[case]
        tp = types.SimpleNamespace(data_n=data_n, model_n=model_n)
    elif case == "hybrid":
        cfg = get_config("zamba2-2.7b", smoke=True)
    elif case == "encoder_decoder":
        cfg = get_config("seamless-m4t-large-v2", smoke=True)
    elif case == "mla":
        cfg = get_config("deepseek-v2-236b", smoke=True)
    elif case == "ssm":
        cfg = get_config("mamba2-2.7b", smoke=True)
    elif case == "hd32":
        cfg = dataclasses.replace(cfg, head_dim=32)
    elif case == "mixtral":
        cfg = serving_config("mixtral-8x7b")
    elif case == "hd80":
        cfg = dataclasses.replace(cfg, head_dim=80)
    cache = _route_cache(kv, cfg)
    assert L.glue_route(cfg, x, cache, use_kernel, tp) == want


# ---------------------------------------------------------------------------
# the fused decode stack, its route forced on the CPU
# ---------------------------------------------------------------------------

def _stack(arch: str, hd: int):
    cfg = dataclasses.replace(serving_config(arch), head_dim=hd)
    params = init_params(cfg, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    for key in ("ln1", "ln2"):     # norms other than ones
        w = params["layers"][key]
        w.copy_(randn(g, *w.shape, scale=0.1) + 1)
    params["final_norm"].copy_(randn(g, cfg.d_model, scale=0.1) + 1)
    return cfg, params


def _horizon(cfg, params, route, monkeypatch, B=6, horizon=4):
    """A greedy horizon over a fresh pool (block 0 scratch), lanes 2 and 4
    frozen early, under the given route: "chain" is the CPU's own, "fused"
    is forced (the route never takes it off a card)."""
    if route == "fused":
        monkeypatch.setattr(L, "glue_route", lambda *a, **k: route)
    cap, bs = 64, cfg.kv_block_size
    bp = cap // bs
    cache = tm.init_decode_cache(cfg, B, cap, num_blocks=B * bp + 1,
                                 device="cpu")
    g = torch.Generator().manual_seed(5)
    for key in ("k_pool", "v_pool"):
        cache[key].copy_(randn(g, *cache[key].shape))
    cache["block_tables"] = torch.arange(1, B * bp + 1,
                                         dtype=torch.int32).reshape(B, bp)
    toks = torch.tensor([5, 7, 11, 5, 9, 3], dtype=torch.int32)[:B]
    pos = torch.tensor([9, 30, 2, 40, 63, 17], dtype=torch.int32)[:B]
    limits = torch.tensor([horizon, 2, horizon, horizon, 1, horizon],
                          dtype=torch.int32)[:B]
    V = cfg.vocab_size

    def sample(rng, logits):
        logits[:, V:] = -torch.inf
        conf, tok = torch.softmax(logits.float(), -1).max(-1)
        return tok.to(torch.int32), conf

    before = {k: cache[k].clone() for k in ("k_pool", "v_pool")}
    out = tm.multi_decode_step(
        params, cfg, toks, pos, limits, cache, window_len=cap,
        horizon=horizon, rng=None, sample_fn=sample, eos_id=2, step_id=5,
        scratch_block=0)
    logits = tm.decode_step(params, cfg, toks[:, None], pos, cache,
                            window_len=cap)["logits"]
    written = {k: (cache[k] != v).flatten(-2).any(-1)
               for k, v in before.items()}
    return out, logits, written


@pytest.mark.parametrize("arch,hd", [("qwen3-4b-thinking", 64),
                                     ("qwen3-4b-thinking", 128),
                                     ("mixtral-8x7b", 64),
                                     ("mixtral-8x7b", 80)])
def test_fused_decode_stack_matches_chain(arch, hd, monkeypatch):
    cfg, params = _stack(arch, hd)
    chain, chain_logits, chain_written = _horizon(cfg, params, "chain",
                                                  monkeypatch)
    fused, fused_logits, fused_written = _horizon(cfg, params, "fused",
                                                  monkeypatch)
    for key in ("tokens", "token_valid", "final_tokens", "positions"):
        assert torch.equal(fused[key], chain[key]), key
    torch.testing.assert_close(fused_logits.float(), chain_logits.float(),
                               rtol=0, atol=5e-2)
    for key in ("k_pool", "v_pool"):
        # block 0 is scratch: the dense stack's frozen lanes race on it
        got, want = fused["cache"][key][:, 1:], chain["cache"][key][:, 1:]
        torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                                   atol=3e-2)
        # the same slots written, the rest untouched
        assert torch.equal(fused_written[key][:, 1:],
                           chain_written[key][:, 1:])


def test_kernel_names_escape_the_benchmarks_patterns():
    """The glue's kernels count as neither products nor K1a nor K2 in the
    benchmark's readers, which find kernels by name."""
    import re
    from pathlib import Path

    from portbench.manifest import Manifest
    src = (Path(G.__file__).parent.parent / "csrc" / "decode_glue.cu")
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+"
                       r"(\w+)\(", src.read_text())
    assert sorted(names) == ["add_rms_norm_kernel", "attn_prologue_kernel",
                             "silu_mul_kernel"]
    man = Manifest()
    for metric in ("products_ms_per_iter", "k1a_roofline", "k2_roofline"):
        pattern = man.reader(metric).PATTERN
        assert not any(pattern.search(f"(anonymous namespace)::{n}(Prologue)")
                       for n in names), metric


def test_small_kernels_reader_counts_what_no_other_reader_names():
    """``small_kernels_ms_per_iter`` sums the profiled operations that
    neither the products', K1a's nor K2's reader counts, per decode
    iteration of the stretch; nothing to read gives no value."""
    from portbench.manifest import Manifest
    read = Manifest().reader("small_kernels_ms_per_iter").read
    ops_ = [("nvjet_tst_96x64_64x8_4x1_v_bz_NNN", 0.004),
            ("void (anonymous namespace)::decode_cluster_kernel<128>", 0.002),
            ("void (anonymous namespace)::score_kernel", 0.001),
            ("void (anonymous namespace)::add_rms_norm_kernel", 0.0005),
            ("void at::native::elementwise_kernel<128, 2>", 0.0015),
            ("Memcpy HtoD (Pageable -> Device)", 0.0002)]
    rec = {"profile": {"ops": ops_},
           "ticks": [{"profiled": True, "horizon": 4},
                     {"profiled": False, "horizon": 4}]}
    assert read(rec) == pytest.approx(1e3 * 0.0022 / 4)
    assert read({"profile": None, "ticks": rec["ticks"]}) is None
    assert read({"profile": {"ops": ops_[:3]}, "ticks": rec["ticks"]}) is None
