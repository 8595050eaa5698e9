"""The port's CUDA kernels on a card: each wrapper against its plain
PyTorch version, and the CUDA engine's kernel path against its dense
path. Every test here needs a CUDA card (and ``nvcc`` for the first
build) and skips without one. The file imports no jax, so it runs where
only the port's dependencies are installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 at 1e-4 (summation order); bf16 outputs at 1e-2 absolute
plus 1e-2 relative (both sides accumulate in f32, the output is rounded
to bf16, one ulp is 2^-8 relative; on the tensor cores the flash kernel
and the bf16 prefill face also round P to bf16 before P.V, as
``ref.py::mha_ref`` does, where the plain versions keep P in f32); scores
at 1e-5 (f32 throughout). The int8/fp8 pools take the same tolerances:
the kernel folds the per-slot scales into the scores and into p, the
plain versions dequantize the codes, the same values up to f32 rounding
order. The
SSD scan at 2e-3 absolute plus relative, as tests/test_kernels.py holds
the Pallas kernel to the sequential recurrence (the chunked form
exponentiates cumsum differences instead of multiplying per-step decays;
outputs reach ~5e2 at full width).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import serving_config  # noqa: E402
from repro_torch.core.pruning import make_policy  # noqa: E402
from repro_torch.core.scorer import init_scorer  # noqa: E402
from repro_torch.data.tokenizer import get_tokenizer  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssd_scan as sd  # noqa: E402
from repro_torch.kernels import ssm_decode as smd  # noqa: E402
from repro_torch.kernels import step_score as ss  # noqa: E402
from repro_torch.models import kv_quant  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.serving import engine as te  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _pools(g, B, bp, KVH, hd, dtype, page=16):
    NB = B * bp + 1
    kp = torch.randn(NB, page, KVH, hd, generator=g, device="cuda")
    vp = torch.randn(NB, page, KVH, hd, generator=g, device="cuda")
    bt = torch.randperm(NB - 1, generator=g, device="cuda")[:B * bp] + 1
    return kp.to(dtype), vp.to(dtype), bt.reshape(B, bp).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,KVH,G", [(128, 8, 4), (64, 2, 2), (64, 4, 1)])
def test_decode_kernel_matches_plain(gen, dtype, hd, KVH, G):
    B, bp = 6, 4
    lens = torch.tensor([0, 1, 15, 16, 37, 64], dtype=torch.int32,
                        device="cuda")
    q = torch.randn(B, KVH * G, hd, generator=gen, device="cuda").to(dtype)
    kp, vp, bt = _pools(gen, B, bp, KVH, hd, dtype)
    scale = 1.0 / math.sqrt(hd)
    got = pa.paged_attention(q, kp, vp, bt, lens, scale=scale)
    want = pa.paged_attention_plain(q, kp, vp, bt, lens, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool((got[0] == 0).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,prefix,nvalid,window", [
    (16, 37, 11, None), (16, 0, 16, None), (64, 200, 64, 128),
    (64, 100, 50, 128), (5, 19, 4, 9)])
def test_prefill_kernel_matches_plain(gen, dtype, C, prefix, nvalid, window):
    KVH, G, hd, bp = 8, 4, 128, 16
    q = torch.randn(1, C, KVH * G, hd, generator=gen, device="cuda")
    own = [torch.randn(1, C, KVH, hd, generator=gen, device="cuda")
           .to(dtype) for _ in range(2)]
    kp, vp, bt = _pools(gen, 1, bp, KVH, hd, dtype)
    pl = torch.tensor([prefix], dtype=torch.int32, device="cuda")
    nv = torch.tensor([nvalid], dtype=torch.int32, device="cuda")
    args = (q.to(dtype), kp, vp, bt, pl, nv, *own)
    got = pa.paged_attention_prefill(*args, scale=0.1, window=window)
    want = pa.paged_attention_prefill_plain(*args, 0.1, window)
    torch.cuda.synchronize()
    assert bool((got[0, nvalid:] == 0).all())   # padded queries: zeros
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _scorer_inputs(g, B, D, Hd, dtype):
    h = torch.randn(B, D, generator=g, device="cuda").to(dtype)
    w1 = torch.randn(D, Hd, generator=g, device="cuda") * D ** -0.5
    b1 = torch.randn(Hd, generator=g, device="cuda") * 0.1
    w2 = torch.randn(Hd, 1, generator=g, device="cuda") * Hd ** -0.5
    b2 = torch.randn(1, generator=g, device="cuda") * 0.1
    return h, w1, b1, w2, b2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,D", [(1, 256), (13, 256), (64, 2560), (16, 2560),
                                 (130, 1000)])
def test_step_score_kernel_matches_plain(gen, dtype, B, D):
    """(16, 2560) is the serve batch; (130, 1000) has a D that no slice
    of 64 rows divides and lanes across a tile edge."""
    args = _scorer_inputs(gen, B, D, 512, dtype)
    got = ss.step_score(*args)
    torch.testing.assert_close(got, ss.step_score_plain(*args),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Hd", [32, 1024])
def test_step_score_kernel_hidden_widths(gen, dtype, Hd):
    """The narrowest and widest hidden layer the kernel takes: one
    partial hidden tile, and eight."""
    args = _scorer_inputs(gen, 13, 1000, Hd, dtype)
    torch.testing.assert_close(ss.step_score(*args),
                               ss.step_score_plain(*args), rtol=1e-5,
                               atol=1e-5)


def test_step_score_kernel_deterministic(gen):
    """No float atomics: the same inputs give bitwise the same scores."""
    args = _scorer_inputs(gen, 64, 2560, 512, torch.bfloat16)
    first = ss.step_score(*args)
    assert torch.equal(first, ss.step_score(*args))


def test_step_score_kernel_in_cuda_graph(gen):
    """Both launches capture: a replay matches the eager call bitwise, and
    a replay after new hiddens are copied in scores the new hiddens."""
    h, w1, b1, w2, b2 = _scorer_inputs(gen, 16, 2560, 512, torch.bfloat16)
    eager = ss.step_score(h, w1, b1, w2, b2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss.step_score(h, w1, b1, w2, b2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ss.step_score(h, w1, b1, w2, b2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    h.copy_(torch.randn(h.shape, generator=gen, device="cuda"))
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ss.step_score_plain(h, w1, b1, w2, b2),
                               rtol=1e-5, atol=1e-5)


def test_wrappers_count_launches_and_reject_bad_operands(gen):
    ops.reset_launch_counts()
    q = torch.randn(2, 8, 64, generator=gen, device="cuda")
    kp, vp, bt = _pools(gen, 2, 2, 2, 64, torch.float32)
    lens = torch.tensor([3, 20], dtype=torch.int32, device="cuda")
    ops.paged_attention(q, kp, vp, bt, lens, scale=0.1)
    with pytest.raises(ValueError, match="lengths"):
        ops.paged_attention(q, kp, vp, bt, lens.long(), scale=0.1)
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_attention(q[..., :48].contiguous(), kp[..., :48]
                            .contiguous(), vp[..., :48].contiguous(), bt,
                            lens, scale=0.1)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"paged_attention_decode": 1,
                                   "paged_attention_prefill": 0,
                                   "paged_attention_decode_quant": 0,
                                   "paged_attention_prefill_quant": 0,
                                   "step_score": 0, "flash_attention": 0,
                                   "ssd_scan": 0, "ssm_decode": 0,
                                   "decode_graph_replays": 0,
                                   "decode_graph_captures": 0}


QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _quant_pools(g, B, bp, KVH, hd, kv_dtype, page=16):
    """Pools of int8/fp8 codes with their per-slot scales."""
    kp, vp, bt = _pools(g, B, bp, KVH, hd, torch.float32, page)
    (kq, ks), (vq, vs) = (kv_quant.quantize_pages(x, QUANT[kv_dtype])
                          for x in (kp, vp))
    return kq, vq, bt, ks, vs


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,KVH,G", [(128, 8, 4), (64, 2, 2)])
def test_decode_quant_kernel_matches_plain(gen, kv_dtype, dtype, hd, KVH,
                                           G):
    B, bp = 6, 4
    lens = torch.tensor([0, 1, 15, 16, 37, 64], dtype=torch.int32,
                        device="cuda")
    q = torch.randn(B, KVH * G, hd, generator=gen, device="cuda").to(dtype)
    kq, vq, bt, ks, vs = _quant_pools(gen, B, bp, KVH, hd, kv_dtype)
    scale = 1.0 / math.sqrt(hd)
    ops.reset_launch_counts()
    got = pa.paged_attention(q, kq, vq, bt, lens, scale=scale, k_scale=ks,
                             v_scale=vs)
    want = pa.paged_attention_plain(q, kq, vq, bt, lens, scale, ks, vs)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_attention_decode_quant"] == 1
    assert got.dtype == dtype and bool((got[0] == 0).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,prefix,nvalid,window", [
    (16, 37, 11, None), (64, 200, 64, 128), (5, 19, 4, 9)])
def test_prefill_quant_kernel_matches_plain(gen, kv_dtype, dtype, C, prefix,
                                            nvalid, window):
    KVH, G, hd, bp = 8, 4, 128, 16
    q = torch.randn(1, C, KVH * G, hd, generator=gen, device="cuda")
    own = [torch.randn(1, C, KVH, hd, generator=gen, device="cuda")
           .to(dtype) for _ in range(2)]
    kq, vq, bt, ks, vs = _quant_pools(gen, 1, bp, KVH, hd, kv_dtype)
    pl = torch.tensor([prefix], dtype=torch.int32, device="cuda")
    nv = torch.tensor([nvalid], dtype=torch.int32, device="cuda")
    args = (q.to(dtype), kq, vq, bt, pl, nv, *own)
    got = pa.paged_attention_prefill(*args, scale=0.1, window=window,
                                     k_scale=ks, v_scale=vs)
    want = pa.paged_attention_prefill_plain(*args, 0.1, window, ks, vs)
    torch.cuda.synchronize()
    assert bool((got[0, nvalid:] == 0).all())   # padded queries: zeros
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


POOLS = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
         "fp8": torch.float8_e4m3fn}


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("hd,KVH,G", [(128, 2, 4), (64, 4, 2)])
def test_decode_kernel_long_rows_split_pages(gen, pool, page, hd, KVH, G):
    """Decode over 256-page block-table rows: lengths 0, 1, a page
    boundary, a full row and up to 4096 slots, so the page range of each
    lane is cut into parts (split-K) and merged."""
    B, bp = 6, 256
    full = bp * page
    lens = torch.tensor([0, 1, page, 3 * page + 1, full, min(4096, full)
                         - 5], dtype=torch.int32, device="cuda")
    assert pa.split_count(bp, B * KVH) > 1
    dtype = torch.float32 if pool == "f32" else torch.bfloat16
    q = torch.randn(B, KVH * G, hd, generator=gen, device="cuda").to(dtype)
    scales = {}
    if pool in QUANT:
        kp, vp, bt, ks, vs = _quant_pools(gen, B, bp, KVH, hd, pool, page)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp, bt = _pools(gen, B, bp, KVH, hd, POOLS[pool], page)
    scale = 1.0 / math.sqrt(hd)
    ops.reset_launch_counts()
    got = pa.paged_attention(q, kp, vp, bt, lens, scale=scale, **scales)
    want = pa.paged_attention_plain(q, kp, vp, bt, lens, scale,
                                    scales.get("k_scale"),
                                    scales.get("v_scale"))
    torch.cuda.synchronize()
    face = "decode_quant" if scales else "decode"
    assert ops.launch_counts()[f"paged_attention_{face}"] == 1
    assert bool((got[0] == 0).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("C,prefix,nvalid", [(1, 300, 1), (16, 300, 13),
                                             (64, 200, 64)])
def test_prefill_tensor_core_face(gen, pool, C, prefix, nvalid):
    """bf16 queries over a bf16/int8/fp8 pool take the tensor-core face:
    C in {1, 16, 64} over a prefix longer than the window of 128, so the
    window's edge crosses the pooled tiles."""
    KVH, G, hd, bp = 8, 4, 128, 32
    q = torch.randn(1, C, KVH * G, hd, generator=gen, device="cuda")
    own = [torch.randn(1, C, KVH, hd, generator=gen, device="cuda")
           .to(torch.bfloat16) for _ in range(2)]
    scales = {}
    if pool in QUANT:
        kp, vp, bt, ks, vs = _quant_pools(gen, 1, bp, KVH, hd, pool)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp, bt = _pools(gen, 1, bp, KVH, hd, torch.bfloat16)
    pl = torch.tensor([prefix], dtype=torch.int32, device="cuda")
    nv = torch.tensor([nvalid], dtype=torch.int32, device="cuda")
    args = (q.to(torch.bfloat16), kp, vp, bt, pl, nv, *own)
    ops.reset_launch_counts()
    got = pa.paged_attention_prefill(*args, scale=0.1, window=128, **scales)
    want = pa.paged_attention_prefill_plain(*args, 0.1, 128,
                                            scales.get("k_scale"),
                                            scales.get("v_scale"))
    torch.cuda.synchronize()
    face = "prefill_quant" if scales else "prefill"
    assert ops.launch_counts()[f"paged_attention_{face}"] == 1
    assert bool((got[0, nvalid:] == 0).all())
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


def test_quant_wrapper_rejects_missing_scales(gen):
    kq, vq, bt, ks, vs = _quant_pools(gen, 2, 2, 2, 64, "int8")
    q = torch.randn(2, 4, 64, generator=gen, device="cuda")
    lens = torch.tensor([3, 20], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="scales"):
        pa.paged_attention(q, kq, vq, bt, lens, scale=0.1)
    with pytest.raises(ValueError, match="scales"):
        pa.paged_attention(q, kq, vq, bt, lens, scale=0.1, k_scale=ks[:1],
                           v_scale=vs[:1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 128),
                                           (False, None), (False, 50)])
@pytest.mark.parametrize("B,H,S,hd", [(1, 4, 256, 128), (2, 3, 40, 64),
                                      (1, 2, 384, 64)])
def test_flash_kernel_matches_plain(gen, dtype, causal, window, B, H, S, hd):
    q, k, v = (torch.randn(B, H, S, hd, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    ops.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("window", [None, 128])
def test_flash_kernel_long_sequence(gen, window):
    """The main path's sequence length on the tensor cores: S = 2048,
    hd 128, bf16, causal, with and without a window."""
    q, k, v = (torch.randn(1, 8, 2048, 128, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    ops.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = fa.flash_attention_plain(q, k, v, True, window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


def test_flash_kernel_has_no_backward(gen):
    q, k, v = (torch.randn(1, 2, 64, 64, generator=gen, device="cuda")
               for _ in range(3))
    out = fa.flash_attention(q.requires_grad_(True), k, v)
    with pytest.raises(NotImplementedError, match="no backward"):
        out.sum().backward()


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_engine_quant_kernel_path_matches_dense_on_card(gen, kv_dtype):
    """As below, over a quantized pool with chunked prefill: both faces of
    the quantized kernel run, and the tokens and statuses equal the dense
    engine's."""
    cfg = serving_config()
    params = _f32(init_params(cfg, gen))
    scorer = init_scorer(gen, cfg.d_model)
    prompt = get_tokenizer().encode("3+5-2=1+4=", add_bos=True)
    results = {}
    for use_kernel in (True, False):
        ecfg = te.EngineConfig(
            max_batch=8, num_blocks=16, capacity=128, max_new_tokens=40,
            sampling=SamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                                    max_new_tokens=40),
            use_kernel=use_kernel, decode_horizon=4, faults=None,
            prefill_chunk_size=4, kv_dtype=kv_dtype)
        eng = te.Engine(params, cfg, ecfg, make_policy("step"),
                        scorer_params=scorer)
        ops.reset_launch_counts()
        results[use_kernel] = eng.serve(prompt, 8)
        counts = ops.launch_counts()
        for face in ("decode_quant", "prefill_quant"):
            assert (counts[f"paged_attention_{face}"] > 0) == use_kernel
        assert eng.pool_drained()
    k, d = results[True], results[False]
    assert k.num_pruned == d.num_pruned
    for tk, td in zip(k.traces, d.traces):
        assert tk.output_tokens == td.output_tokens
        assert tk.status == td.status


def test_engine_kernel_path_matches_dense_on_card(gen):
    """The smoke config on the card, f32 weights and pool, greedy STEP
    under memory pressure: the kernel engine and the dense engine give
    identical tokens and statuses, step scores within 1e-5."""
    cfg = serving_config()
    params = _f32(init_params(cfg, gen))
    scorer = init_scorer(gen, cfg.d_model)
    prompt = get_tokenizer().encode("3+5-2=", add_bos=True)
    results = {}
    for use_kernel in (True, False):
        ecfg = te.EngineConfig(
            max_batch=8, num_blocks=16, capacity=128, max_new_tokens=40,
            sampling=SamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                                    max_new_tokens=40),
            use_kernel=use_kernel, decode_horizon=4, faults=None,
            kv_dtype="f32")
        eng = te.Engine(params, cfg, ecfg, make_policy("step"),
                        scorer_params=scorer)
        assert eng.device.type == "cuda" and eng.use_kernel == use_kernel
        ops.reset_launch_counts()
        results[use_kernel] = eng.serve(prompt, 8)
        counts = ops.launch_counts()
        assert (counts["paged_attention_decode"] > 0) == use_kernel
        assert (counts["step_score"] > 0) == use_kernel
        assert eng.pool_drained()
    k, d = results[True], results[False]
    assert k.num_pruned == d.num_pruned > 0
    for tk, td in zip(k.traces, d.traces):
        assert tk.output_tokens == td.output_tokens
        assert tk.status == td.status
        assert len(tk.step_scores) == len(td.step_scores)
        for a, b in zip(tk.step_scores, td.step_scores):
            assert abs(a - b) <= 1e-5


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def _ssd_inputs(g, B, S, H, P, N, stress=False):
    """x, dt, A, Bm, Cm in f32. ``stress``: the init's A = -(1..H) with
    large steps, so cs falls thousands below zero inside a chunk."""
    x = torch.randn(B, S, H, P, generator=g, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device="cuda") + (1.0 if stress
                                                            else 0.0))
    A = (-torch.arange(1, H + 1, device="cuda", dtype=torch.float32)
         if stress else -torch.exp(torch.randn(H, generator=g,
                                               device="cuda")))
    Bm = torch.randn(B, S, N, generator=g, device="cuda")
    Cm = torch.randn(B, S, N, generator=g, device="cuda")
    return x, dt, A, Bm, Cm


SSD_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B,S,H,P,N,chunk,stress", [
    (1, 64, 2, 8, 16, 16, False), (2, 128, 6, 16, 32, 32, False),
    (1, 256, 4, 32, 64, 128, False), (2, 96, 5, 16, 32, 32, False),
    (2, 33, 8, 32, 16, 64, False), (1, 512, 80, 64, 128, 256, True),
    (2, 64, 8, 32, 16, 32, True), (1, 4096, 80, 64, 128, 256, True),
    (2, 512, 80, 64, 128, 256, False), (1, 2048, 80, 64, 64, 256, True),
    (2, 96, 8, 32, 16, 32, True)])
def test_ssd_kernel_matches_plain(gen, B, S, H, P, N, chunk, stress):
    """The JAX test shapes (one with a head group that does not divide
    H), a chunk of 33 (S under the chunk), the full-width heads with the
    init's steep decays, 16 chunks of state passing, and two batch rows
    at full heads."""
    args = _ssd_inputs(gen, B, S, H, P, N, stress)
    ops.reset_launch_counts()
    y, h = sd.ssd_scan(*args, chunk=chunk, head_group=4)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == 1
    yp, hp = sd.ssd_scan_plain(*args)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    torch.testing.assert_close(y, yp, **SSD_TOL)
    torch.testing.assert_close(h, hp, **SSD_TOL)


def test_ssd_kernel_padded_sequence(gen):
    """S = 1000 padded to 1024 with dt = 0, as the mixer pads, with the
    init's steep decays (|cs| reaches ~1e4 in a chunk): the kernel's y on
    the real positions and its final state equal the plain recurrence
    over the unpadded sequence."""
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 1000, 80, 64, 128, stress=True)
    pad = [torch.nn.functional.pad(t, [0, 0] * (t.dim() - 2) + [0, 24])
           for t in (x, dt, Bm, Cm)]
    y, h = sd.ssd_scan(pad[0], pad[1], A, pad[2], pad[3], chunk=256)
    yp, hp = sd.ssd_scan_plain(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y[:, :1000], yp, **SSD_TOL)
    torch.testing.assert_close(h, hp, **SSD_TOL)
    assert not y[:, 1000:].any()


def test_ssd_kernel_deterministic(gen):
    """Every pass sums in a fixed order: two calls agree bitwise."""
    args = _ssd_inputs(gen, 1, 1024, 80, 64, 128, stress=True)
    y, h = sd.ssd_scan(*args, chunk=256)
    y2, h2 = sd.ssd_scan(*args, chunk=256)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_ssd_kernel_refusals_and_no_backward(gen):
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 64, 2, 8, 16)
    with pytest.raises(ValueError, match="f32"):
        sd.ssd_scan(x.bfloat16(), dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="chunk"):
        sd.ssd_scan(*_ssd_inputs(gen, 1, 1024, 2, 8, 16), chunk=512)
    y, _ = sd.ssd_scan(x.requires_grad_(True), dt, A, Bm, Cm, chunk=32)
    with pytest.raises(NotImplementedError, match="no backward"):
        y.sum().backward()


def test_mamba2_forward_kernel_matches_dense_on_card(gen):
    """``forward_full(use_kernel=True)`` of the mamba2 smoke config, f32
    params: one K4 launch per layer, logits and end state within 1e-4 of
    the dense chunked forward."""
    cfg = serving_config("mamba2-2.7b")
    params = _f32(init_params(cfg, gen))
    toks = torch.randint(0, cfg.vocab_size, (2, 75), generator=gen,
                         device="cuda", dtype=torch.int32)
    with torch.no_grad():
        dense = tm.forward_full(params, cfg, toks, return_kv=True)
        ops.reset_launch_counts()
        got = tm.forward_full(params, cfg, toks, return_kv=True,
                              use_kernel=True)
        torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == cfg.num_layers
    torch.testing.assert_close(got["logits"], dense["logits"], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(got["kvs"][0], dense["kvs"][0], rtol=1e-4,
                               atol=1e-4)


def test_mamba2_engine_kernel_path_matches_dense_on_card(gen):
    """mamba2 smoke on the card, f32 params, greedy STEP under memory
    pressure: the kernel engine (the fused scorer) and the dense engine
    give identical tokens and statuses, step scores within 1e-5."""
    cfg = serving_config("mamba2-2.7b")
    params = _f32(init_params(cfg, gen))
    scorer = init_scorer(gen, cfg.d_model)
    prompt = get_tokenizer().encode("3+5-2=", add_bos=True)
    results = {}
    for use_kernel in (True, False):
        ecfg = te.EngineConfig(
            max_batch=8, num_blocks=16, capacity=128, max_new_tokens=40,
            sampling=SamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                                    max_new_tokens=40),
            use_kernel=use_kernel, decode_horizon=4, faults=None)
        eng = te.Engine(params, cfg, ecfg, make_policy("step"),
                        scorer_params=scorer)
        ops.reset_launch_counts()
        results[use_kernel] = eng.serve(prompt, 8)
        assert (ops.launch_counts()["step_score"] > 0) == use_kernel
        assert eng.pool_drained()
    k, d = results[True], results[False]
    assert k.num_pruned == d.num_pruned > 0
    for tk, td in zip(k.traces, d.traces):
        assert tk.output_tokens == td.output_tokens
        assert tk.status == td.status
        for a, b in zip(tk.step_scores, td.step_scores):
            assert abs(a - b) <= 1e-5


# ---------------------------------------------------------------------------
# Mamba2's decode state update (csrc/ssm_decode.cu)
# ---------------------------------------------------------------------------

def _ssm_decode_inputs(g, B, H, P, N, W, dtype):
    """Params as the init makes them (f32 dt_bias, A_log and D), states,
    and a [B, pad + C + H] projection whose xbc and dt slices are handed
    over as strided views, as the mixer does."""
    C = H * P + 2 * N
    dev = "cuda"
    params = (torch.randn(W, C, generator=g, device=dev).mul(0.5).to(dtype),
              torch.randn(C, generator=g, device=dev).mul(0.1).to(dtype),
              torch.log(torch.expm1(torch.rand(H, generator=g, device=dev)
                                    * 0.09 + 0.01)),
              torch.log(torch.arange(1, H + 1, device=dev,
                                     dtype=torch.float32)),
              torch.randn(H, generator=g, device=dev))
    ss = torch.randn(B, H, P, N, generator=g, device=dev)
    cs = torch.randn(B, W - 1, C, generator=g, device=dev).to(torch.bfloat16)
    return params, ss, cs


def _ssm_projection(g, B, H, P, N, dtype, pad=8):
    C = H * P + 2 * N
    proj = torch.randn(B, pad + C + H, generator=g, device="cuda").to(dtype)
    return proj[:, pad:pad + C], proj[:, pad + C:]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,P,N,W", [(16, 80, 64, 128, 4), (3, 5, 24, 16, 4),
                                       (2, 3, 100, 4, 2), (1, 7, 8, 64, 8),
                                       (16, 80, 64, 64, 4), (8, 8, 32, 16, 4)])
def test_ssm_decode_kernel_matches_plain(gen, dtype, B, H, P, N, W):
    """Chained steps (each side feeds its own states on): the conv state
    exactly (it only shifts the inputs), y and the ssm state at f32's 1e-4
    or bf16's 1e-2 (the SiLU output rounds to bf16 in both, and an f32
    summation-order difference can cross a bf16 rounding boundary).
    Every lane moves: nothing is masked."""
    params, ss, cs = _ssm_decode_inputs(gen, B, H, P, N, W, dtype)
    ss_p, cs_p = ss.clone(), cs.clone()
    for _ in range(8):
        xbc, dt = _ssm_projection(gen, B, H, P, N, dtype)
        before = ss.clone()
        y = ops.ssm_decode(cs, ss, xbc, dt, *params)
        y_p, ss_p, cs_p = smd.ssm_decode_plain(cs_p, ss_p, xbc, dt, *params)
        cs_p = cs_p.to(torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(cs, cs_p)
        torch.testing.assert_close(ss, ss_p, **TOL[dtype])
        torch.testing.assert_close(y, y_p, **TOL[dtype])
        assert bool((ss != before).flatten(1).any(1).all())


def test_ssm_decode_kernel_refusals_and_count(gen):
    params, ss, cs = _ssm_decode_inputs(gen, 2, 3, 8, 16, 4, torch.float32)
    xbc, dt = _ssm_projection(gen, 2, 3, 8, 16, torch.float32)
    ops.reset_launch_counts()
    ops.ssm_decode(cs, ss, xbc, dt, *params)
    assert ops.launch_counts()["ssm_decode"] == 1
    with pytest.raises(ValueError, match="conv_state"):
        ops.ssm_decode(cs.float(), ss, xbc, dt, *params)
    with pytest.raises(ValueError, match="share a dtype"):
        ops.ssm_decode(cs, ss, xbc.bfloat16(), dt, *params)
    p12, ss12, cs12 = _ssm_decode_inputs(gen, 2, 3, 8, 12, 4, torch.float32)
    x12, d12 = _ssm_projection(gen, 2, 3, 8, 12, torch.float32)
    with pytest.raises(ValueError, match="state size"):
        ops.ssm_decode(cs12, ss12, x12, d12, *p12)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssm_decode"] == 1


# ---------------------------------------------------------------------------
# the decode horizon as one CUDA graph (serving/cuda_graph.py)
# ---------------------------------------------------------------------------

class TickCountingEngine(te.Engine):
    """Counts the scheduler's decode ticks (one ``decode_fn`` lookup each
    when no fault is injected)."""

    ticks = 0

    def decode_fn(self, horizon, lanewise=False):
        self.ticks += 1
        return super().decode_fn(horizon, lanewise)


def _no_eos(params, cfg):
    """Zero the output projection's EOS row, in place: EOS's logit is then
    0, below the largest logit of the other tokens (random weights), so a
    greedy trace decodes its whole budget and 8 traces fill the 16-block
    pool."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"].T
    w[get_tokenizer().eos_id] = 0
    return params


def _graph_serve(arch, params, scorer, eager, sampled, faults=None):
    cfg = serving_config(arch)
    greedy = SamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                            max_new_tokens=40)
    hot = SamplingParams(temperature=0.8, top_k=20, top_p=0.95,
                         max_new_tokens=40)
    ecfg = te.EngineConfig(max_batch=8, num_blocks=16, capacity=128,
                           max_new_tokens=40, sampling=greedy,
                           use_kernel=True, decode_horizon=4, faults=faults,
                           kv_dtype="f32" if arch.startswith("qwen3")
                           else "bf16", seed=3)
    eng = TickCountingEngine(params, cfg, ecfg, make_policy("step"),
                             scorer_params=scorer, _eager_decode=eager)
    tok = get_tokenizer()
    # greedy: 8 traces of one prompt, which the 16-block pool prunes;
    # sampled: 4 traces at temperature 0.8 beside 4 greedy ones
    jobs = ([("3+5-2=", 4, hot), ("7-1+4=", 4, greedy)] if sampled
            else [("3+5-2=", 8, greedy)])
    reqs = [te.Request(request_id=i, n_traces=n,
                       prompt_tokens=tok.encode(p, add_bos=True),
                       policy=make_policy("step"), sampling=sp)
            for i, (p, n, sp) in enumerate(jobs)]
    ops.reset_launch_counts()
    res = eng.serve_batch(reqs)
    torch.cuda.synchronize()
    assert eng.pool_drained()
    return eng, res, ops.launch_counts()


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-4b-thinking", "mamba2-2.7b",
                                  "zamba2-2.7b"])
def test_graphed_engine_matches_eager_engine(gen, arch, sampled):
    """The smoke config on the card, f32 params without EOS (so greedy
    traces fill the pool and STEP prunes), STEP: one replay per tick,
    the eager engine's kernel launches, identical tokens, statuses and
    prunes, scores within 1e-5. ``sampled`` serves one request at
    temperature 0.8 beside a greedy one (the lane-wise sampler) from the
    same generator seed: the graph advances the registered generator's
    Philox offset as the eager draws do."""
    cfg = serving_config(arch)
    params = _no_eos(_f32(init_params(cfg, gen)), cfg)
    scorer = init_scorer(gen, cfg.d_model)
    e_eng, e_res, e_counts = _graph_serve(arch, params, scorer, True,
                                          sampled)
    g_eng, g_res, g_counts = _graph_serve(arch, params, scorer, False,
                                          sampled)
    assert g_counts["decode_graph_replays"] == g_eng.ticks == e_eng.ticks
    assert g_counts["decode_graph_captures"] == len(g_eng._decode_fns)
    assert e_counts["decode_graph_replays"] == 0
    kernels = [k for k in e_counts if not k.startswith("decode_graph")]
    assert {k: g_counts[k] for k in kernels} == \
        {k: e_counts[k] for k in kernels}
    assert g_counts["step_score"] > 0
    if arch != "qwen3-4b-thinking":
        assert g_counts["ssm_decode"] == \
            g_counts["step_score"] * cfg.num_layers
    if arch == "zamba2-2.7b":   # one decode per shared-attention invocation
        assert g_counts["paged_attention_decode"] == \
            g_counts["step_score"] * len(cfg.attention_layer_ids())
    for g, e in zip(g_res, e_res):
        assert (g.num_pruned, g.status) == (e.num_pruned, e.status)
        for tg, te_ in zip(g.traces, e.traces):
            assert tg.output_tokens == te_.output_tokens
            assert tg.status == te_.status
            for a, b in zip(tg.step_scores, te_.step_scores):
                assert abs(a - b) <= 1e-5
    if not sampled:
        assert g_res[0].num_pruned > 0


def test_degrade_to_dense_drops_the_kernel_graphs(gen):
    """Injected step faults past the retry limit take the kernel->dense
    rung mid-serve: the kernel path's graphs go, dense ones are captured,
    and the tokens equal the eager engine's under the same plan."""
    cfg = serving_config()
    params = _f32(init_params(cfg, gen))
    scorer = init_scorer(gen, cfg.d_model)
    runs = {eager: _graph_serve("qwen3-4b-thinking", params, scorer, eager,
                                False, faults="step@3x4")
            for eager in (True, False)}
    (e_eng, e_res, _), (g_eng, g_res, g_counts) = runs[True], runs[False]
    for eng in (e_eng, g_eng):
        assert eng.fault_stats.degraded_to_dense == 1 and not eng.use_kernel
    # kernel graphs first, then dense ones, which launch no kernel
    assert g_counts["decode_graph_captures"] > len(g_eng._decode_fns)
    assert all(not f.launches for f in g_eng._decode_fns.values())
    for g, e in zip(g_res, e_res):
        for tg, te_ in zip(g.traces, e.traces):
            assert tg.output_tokens == te_.output_tokens


# ---------------------------------------------------------------------------
# head dims beyond 64 and 128 (zamba2: 80, its smoke config: 32), granite's
# 48 query heads over one kv head, the hybrid and the dense archs
# ---------------------------------------------------------------------------

def _any_pools(g, B, bp, KVH, hd, pool, page=16):
    """(k, v, block tables, scale kwargs) over a float or int8/fp8 pool."""
    if pool in QUANT:
        kq, vq, bt, ks, vs = _quant_pools(g, B, bp, KVH, hd, pool, page)
        return kq, vq, bt, dict(k_scale=ks, v_scale=vs)
    kp, vp, bt = _pools(g, B, bp, KVH, hd, POOLS[pool], page)
    return kp, vp, bt, {}


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [32, 80])
def test_decode_kernel_head_dims(gen, pool, dtype, hd):
    """Decode at hd 32 and 80 over every pool dtype (hd 80 pads a bf16
    row to 16 lanes, an f32 row to 32, an int8/fp8 row to 8): a 64-page
    table, so each lane's pages split in two and merge."""
    B, KVH, G, bp = 6, 4, 2, 64
    lens = torch.tensor([0, 1, 15, 16, 333, 1000], dtype=torch.int32,
                        device="cuda")
    assert pa.split_count(bp, B * KVH) > 1
    q = torch.randn(B, KVH * G, hd, generator=gen, device="cuda").to(dtype)
    kp, vp, bt, scales = _any_pools(gen, B, bp, KVH, hd, pool)
    scale = 1.0 / math.sqrt(hd)
    ops.reset_launch_counts()
    got = pa.paged_attention(q, kp, vp, bt, lens, scale=scale, **scales)
    want = pa.paged_attention_plain(q, kp, vp, bt, lens, scale,
                                    scales.get("k_scale"),
                                    scales.get("v_scale"))
    torch.cuda.synchronize()
    face = "decode_quant" if scales else "decode"
    assert ops.launch_counts()[f"paged_attention_{face}"] == 1
    assert bool((got[0] == 0).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("pool", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_mqa_group(gen, pool, dtype):
    """granite-20b's shape: 48 query heads over one kv head at hd 128, so
    the grid holds 12 row groups of 4 per lane."""
    B, KVH, G, hd, bp = 8, 1, 48, 128, 16
    lens = torch.tensor([0, 1, 16, 17, 100, 200, 255, 256],
                        dtype=torch.int32, device="cuda")
    q = torch.randn(B, KVH * G, hd, generator=gen, device="cuda").to(dtype)
    kp, vp, bt, scales = _any_pools(gen, B, bp, KVH, hd, pool)
    got = pa.paged_attention(q, kp, vp, bt, lens, scale=hd ** -0.5,
                             **scales)
    want = pa.paged_attention_plain(q, kp, vp, bt, lens, hd ** -0.5,
                                    scales.get("k_scale"),
                                    scales.get("v_scale"))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,KVH", [(16, 8), (24, 8), (24, 2)])
def test_decode_kernel_dense_arch_groups(gen, pool, dtype, H, KVH):
    """The other dense archs' head groups at hd 128 over 8 lanes:
    qwen3-1.7b (G = 2), phi4-mini (G = 3, a partly filled row group) and
    starcoder2 (G = 12)."""
    B, hd, bp = 8, 128, 16
    lens = torch.tensor([0, 1, 16, 17, 100, 200, 255, 256],
                        dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dtype)
    kp, vp, bt, scales = _any_pools(gen, B, bp, KVH, hd, pool)
    got = pa.paged_attention(q, kp, vp, bt, lens, scale=hd ** -0.5,
                             **scales)
    want = pa.paged_attention_plain(q, kp, vp, bt, lens, hd ** -0.5,
                                    scales.get("k_scale"),
                                    scales.get("v_scale"))
    torch.cuda.synchronize()
    assert bool((got[0] == 0).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [32, 80])
@pytest.mark.parametrize("C,prefix,nvalid,window", [(16, 37, 11, None),
                                                    (64, 200, 50, 128)])
def test_prefill_kernel_head_dims(gen, pool, dtype, hd, C, prefix, nvalid,
                                  window):
    """The chunked-prefill face at hd 32 and 80: bf16 queries over a
    bf16/int8/fp8 pool take the tensor-core tile (padded shared-memory
    rows; hd 80's int8/fp8 codes copy in ragged rounds), the rest the
    f32 face."""
    KVH, G, bp = 4, 2, 16
    q = torch.randn(1, C, KVH * G, hd, generator=gen, device="cuda")
    own = [torch.randn(1, C, KVH, hd, generator=gen, device="cuda")
           .to(dtype) for _ in range(2)]
    kp, vp, bt, scales = _any_pools(gen, 1, bp, KVH, hd, pool)
    pl = torch.tensor([prefix], dtype=torch.int32, device="cuda")
    nv = torch.tensor([nvalid], dtype=torch.int32, device="cuda")
    args = (q.to(dtype), kp, vp, bt, pl, nv, *own)
    ops.reset_launch_counts()
    got = pa.paged_attention_prefill(*args, scale=0.1, window=window,
                                     **scales)
    want = pa.paged_attention_prefill_plain(*args, 0.1, window,
                                            scales.get("k_scale"),
                                            scales.get("v_scale"))
    torch.cuda.synchronize()
    face = "prefill_quant" if scales else "prefill"
    assert ops.launch_counts()[f"paged_attention_{face}"] == 1
    assert bool((got[0, nvalid:] == 0).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 128),
                                           (False, None), (False, 50)])
@pytest.mark.parametrize("hd,S", [(32, 256), (80, 384)])
def test_flash_kernel_head_dims(gen, dtype, causal, window, hd, S):
    q, k, v = (torch.randn(2, 3, S, hd, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    ops.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_zamba2_shape(gen, dtype):
    """zamba2's forward: B = 1, H = 32, S = 2048, hd 80, causal."""
    q, k, v = (torch.randn(1, 32, 2048, 80, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_head_dims_outside_the_built_set_raise(gen):
    """hd 48 is a multiple of 16 but not built: both wrappers raise and
    name the head dims they take; nothing falls back to a plain version."""
    q = torch.randn(2, 4, 48, generator=gen, device="cuda")
    kp, vp, bt = _pools(gen, 2, 2, 2, 48, torch.bfloat16)
    lens = torch.tensor([3, 20], dtype=torch.int32, device="cuda")
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=r"\(32, 64, 80, 128\)"):
        pa.paged_attention(q.bfloat16(), kp, vp, bt, lens, scale=0.1)
    x = torch.randn(1, 2, 128, 48, generator=gen, device="cuda")
    with pytest.raises(ValueError, match=r"\(32, 64, 80, 128\)"):
        fa.flash_attention(x, x, x)
    assert sum(ops.launch_counts().values()) == 0


def _smoke_engines(gen, arch, **kw):
    """Greedy STEP on ``arch``'s smoke config, f32 params without EOS
    (every trace decodes its 40 tokens, so 8 traces fill the 16-block
    pool): the kernel engine's and the dense engine's results and launch
    counts."""
    cfg = serving_config(arch)
    params = _no_eos(_f32(init_params(cfg, gen)), cfg)
    scorer = init_scorer(gen, cfg.d_model)
    prompt = get_tokenizer().encode("3+5-2=", add_bos=True)
    out = {}
    for use_kernel in (True, False):
        ecfg = te.EngineConfig(
            max_batch=8, num_blocks=16, capacity=128, max_new_tokens=40,
            sampling=SamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                                    max_new_tokens=40),
            use_kernel=use_kernel, decode_horizon=4, faults=None, **kw)
        eng = te.Engine(params, cfg, ecfg, make_policy("step"),
                        scorer_params=scorer)
        ops.reset_launch_counts()
        res = eng.serve(prompt, 8)
        torch.cuda.synchronize()
        assert eng.pool_drained()
        out[use_kernel] = (res, ops.launch_counts())
    return cfg, params, out


def _same_greedy(k, d):
    assert k.num_pruned == d.num_pruned > 0
    for tk, td in zip(k.traces, d.traces):
        assert tk.output_tokens == td.output_tokens
        assert tk.status == td.status
        assert len(tk.step_scores) == len(td.step_scores)
        for a, b in zip(tk.step_scores, td.step_scores):
            assert abs(a - b) <= 1e-5


def test_zamba2_kernel_paths_match_dense_on_card(gen):
    """zamba2's smoke config, f32 params: ``forward_full(use_kernel=True)``
    (K4 per Mamba2 layer, K3 at hd 32 per shared-attention invocation)
    against the dense forward at 1e-4, and the kernel engine (K1 at hd 32,
    ``ssm_decode``, K2) against the dense engine: identical greedy tokens
    and statuses, step scores within 1e-5."""
    cfg, params, runs = _smoke_engines(gen, "zamba2-2.7b", kv_dtype="f32")
    (k, kc), (d, dc) = runs[True], runs[False]
    _same_greedy(k, d)
    G = len(cfg.attention_layer_ids())
    assert kc["paged_attention_decode"] == kc["step_score"] * G > 0
    assert kc["ssm_decode"] == kc["step_score"] * cfg.num_layers
    assert dc["paged_attention_decode"] == dc["ssm_decode"] == 0
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                           device="cuda", dtype=torch.int32)
    ops.reset_launch_counts()
    got = tm.forward_full(params, cfg, tokens, use_kernel=True)
    counts = ops.launch_counts()
    want = tm.forward_full(params, cfg, tokens)
    torch.cuda.synchronize()
    assert counts["ssd_scan"] == cfg.num_layers
    assert counts["flash_attention"] == G
    torch.testing.assert_close(got["logits"], want["logits"],
                               **TOL[torch.float32])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-20b",
                                  "phi4-mini-3.8b", "starcoder2-3b"])
def test_dense_arch_engine_kernel_path_matches_dense_on_card(gen, arch):
    """Each dense arch's smoke config (granite: 4 query heads over one kv
    head; granite and starcoder2 untied, without qk-norm) through K1 and
    K2 against the dense engine, f32 params and pool."""
    _, _, runs = _smoke_engines(gen, arch, kv_dtype="f32")
    (k, kc), (d, _) = runs[True], runs[False]
    assert kc["paged_attention_decode"] > 0 and kc["step_score"] > 0
    _same_greedy(k, d)
