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
import dataclasses
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
from repro_torch.training import tree as T  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _decode_count(q, pool, quant):
    """The launch counter of the decode kernel that ``decode_face`` picks:
    the cluster face for bf16 queries over a bf16/int8/fp8 pool at hd
    64/80/128 with pages of 8 or a multiple of 16, else
    ``decode_kernel``."""
    face = "decode_quant" if quant else "decode"
    if pa.decode_face(q.dtype, pool.dtype, q.shape[-1],
                      pool.shape[1]) == "cluster":
        face += "_cluster"
    return f"paged_attention_{face}"


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
                                 (130, 1000), (16, 4096), (4, 4096), (1, 1),
                                 (8, 6144), (130, 2560), (33, 20000)])
def test_step_score_kernel_matches_plain(gen, dtype, B, D):
    """(16, 2560) is the serve batch; 130 lanes go through three lane
    tiles of 64, the last ragged; D = 4096 is mixtral-8x7b's width at the
    serve's 16 lanes and the batched phase's 4; D = 1 one row; D = 6144
    granite-20b's width; D = 20000 seven passes of each warp's box."""
    args = _scorer_inputs(gen, B, D, 512, dtype)
    got = ss.step_score(*args)
    torch.testing.assert_close(got, ss.step_score_plain(*args),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Hd", [32, 1024])
def test_step_score_kernel_hidden_widths(gen, dtype, Hd):
    """The narrowest and widest hidden layer the kernel takes: one
    hidden tile, and 32."""
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
    """Both launches capture: replays match the eager call bitwise, and a
    replay after new hiddens are copied in scores the new hiddens."""
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
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    h.copy_(torch.randn(h.shape, generator=gen, device="cuda"))
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ss.step_score_plain(h, w1, b1, w2, b2),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(out, ss.step_score(h, w1, b1, w2, b2))


def test_step_score_kernel_captured_cold(gen):
    """A first call inside a capture, at a shape not run before and with
    the card's cluster counts not yet asked, captures and replays to the
    eager scores."""
    h, w1, b1, w2, b2 = _scorer_inputs(gen, 5, 777, 96, torch.float32)
    ss._fits.clear()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ss.step_score(h, w1, b1, w2, b2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ss.step_score(h, w1, b1, w2, b2))


def test_step_score_kernel_unaligned_w1(gen):
    """A W1 that is not 16-byte aligned (TMA needs it): the wrapper clones
    it, and the scores are those of the aligned copy."""
    h, w1, b1, w2, b2 = _scorer_inputs(gen, 16, 2560, 512, torch.bfloat16)
    odd = torch.empty(w1.numel() + 1, device="cuda")[1:].view_as(w1)
    odd.copy_(w1)
    assert odd.data_ptr() % 16
    assert torch.equal(ss.step_score(h, odd, b1, w2, b2),
                       ss.step_score(h, w1, b1, w2, b2))


def test_step_score_kernel_two_streams_in_flight(gen):
    """Two calls in flight at once on two streams, each with its own
    logits workspace and finish launch: every pair gives the scores of a
    call alone."""
    sets = [_scorer_inputs(gen, 16, 2560, 512, torch.bfloat16)
            for _ in range(2)]
    want = [ss.step_score(*s) for s in sets]
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    for _ in range(20):
        outs = []
        for st, s in zip(streams, sets):
            with torch.cuda.stream(st):
                outs.append(ss.step_score(*s))
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, want))


@pytest.mark.parametrize("B,D,Hd", [(16, 2560, 512), (16, 4096, 512),
                                    (16, 256, 512), (64, 2560, 512),
                                    (8, 6144, 512), (13, 1000, 1024)])
def test_step_score_plan_on_the_card(gen, B, D, Hd):
    """score_plan's shared memory is the kernel's, and the card holds all
    of a call's clusters at once (one wave, one CTA per SM)."""
    plan = ss.score_plan(B, D, Hd, ss.card_fits(torch.device("cuda")))
    lib = ss._library()
    for bf16 in (0, 1):
        assert lib.repro_step_score_smem(
            plan["rows"], plan["lane_tile"], plan["cluster"], bf16) == \
            ss.score_smem(plan["rows"], plan["lane_tile"], plan["cluster"],
                          2 if bf16 else 4)
    assert ss.score_smem(plan["rows"], plan["lane_tile"],
                         plan["cluster"]) == plan["smem"]
    assert lib.repro_step_score_max_clusters(
        plan["rows"], plan["lane_tile"], plan["cluster"]) >= plan["tiles"]


def test_decode_graph_capture_survives_a_dead_graph(gen):
    """A reference cycle holding a captured CUDAGraph becomes garbage while
    a DecodeGraph captures, with the collector's thresholds at their
    lowest: the capture must not run the collection that would destroy
    that graph (its reset is not permitted while a stream captures, and
    invalidates the capture)."""
    import gc

    from repro_torch.serving.cuda_graph import DecodeGraph
    x = torch.zeros(1024, device="cuda")
    torch.cuda.synchronize()
    old = torch.cuda.CUDAGraph()
    with torch.cuda.graph(old):
        y = x * 2
    box = [(old, y)]
    del old, y

    def fn(params, cache, tokens, positions, limits, block_tables, rng,
           scorer_params):
        if torch.cuda.is_current_stream_capturing():
            cycle = {"graph": box.pop()}
            cycle["self"] = cycle    # a cycle: only the collector frees it
            del cycle                # young garbage from here on
            for _ in range(100):     # allocations that start collections
                [[] for _ in range(20)]
        out = [tokens * 2, tokens.float(), tokens.float() + 1, tokens > 0,
               tokens > 1, tokens + 1, positions + 1]
        return (*out, cache, rng)

    dev = torch.device("cuda")
    tokens = torch.arange(8, device=dev, dtype=torch.int32)
    args = (tokens, tokens.clone(), torch.full_like(tokens, 4),
            torch.zeros(8, 2, device=dev, dtype=torch.int32))
    params, cache = {}, {}
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        graph = DecodeGraph(fn, dev)
        out = graph.run(params, cache, *args, None, None)
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*thresholds)
    assert graph.graph is not None and not box
    assert torch.equal(out[0], tokens * 2)
    out = graph.run(params, cache, tokens + 3, *args[1:], None, None)
    torch.cuda.synchronize()
    assert torch.equal(out[0], (tokens + 3) * 2)
    gc.collect()


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
                                   "paged_attention_prefill_wgmma": 0,
                                   "paged_attention_prefill_quant_wgmma": 0,
                                   "paged_attention_decode_cluster": 0,
                                   "paged_attention_decode_quant_cluster": 0,
                                   "step_score": 0, "flash_attention": 0,
                                   "flash_attention_wgmma": 0,
                                   "flash_attention_tile": 0,
                                   "flash_attention_f32_tc": 0,
                                   "ssd_scan": 0, "ssd_scan_wgmma": 0,
                                   "ssd_scan_tile": 0, "ssm_decode": 0,
                                   "add_rms_norm": 0, "attn_prologue": 0,
                                   "silu_mul": 0,
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
    assert ops.launch_counts()[_decode_count(q, kq, True)] == 1
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
    lane is cut into parts (split-K, or the CTAs of a cluster) and
    merged."""
    B, bp = 6, 256
    full = bp * page
    lens = torch.tensor([0, 1, page, 3 * page + 1, full, min(4096, full)
                         - 5], dtype=torch.int32, device="cuda")
    assert pa.split_count(bp, B * KVH) > 1
    assert pa.decode_plan(bp, B * KVH, page)["cluster"] > 1
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
    assert ops.launch_counts()[_decode_count(q, kp, bool(scales))] == 1
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
    face = "prefill_quant_wgmma" if scales else "prefill_wgmma"
    assert ops.launch_counts()[f"paged_attention_{face}"] == 1
    assert bool((got[0, nvalid:] == 0).all())
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


def _wgmma_prefill(gen, C, KVH, G, hd, prefix, nvalid, window, page=16,
                   pool="bf16"):
    """bf16 queries over a bf16 (int8, fp8) pool through the wgmma
    prefill kernel: its output, the plain version's, and the launch
    counts it moved."""
    bp = -(-max(prefix, 1) // page) + 1
    q = torch.randn(1, C, KVH * G, hd, generator=gen, device="cuda")
    own = [torch.randn(1, C, KVH, hd, generator=gen, device="cuda")
           .to(torch.bfloat16) for _ in range(2)]
    kp, vp, bt, scales = _any_pools(gen, 1, bp, KVH, hd, pool, page)
    pl = torch.tensor([prefix], dtype=torch.int32, device="cuda")
    nv = torch.tensor([nvalid], dtype=torch.int32, device="cuda")
    args = (q.to(torch.bfloat16), kp, vp, bt, pl, nv, *own)
    scale = hd ** -0.5
    assert pa.prefill_rows(C, G, hd, page, torch.bfloat16, kp.dtype) > 0
    ops.reset_launch_counts()
    got = pa.paged_attention_prefill(*args, scale=scale, window=window,
                                     **scales)
    torch.cuda.synchronize()
    moved = {k: n for k, n in ops.launch_counts().items() if n}
    want = pa.paged_attention_prefill_plain(*args, scale, window,
                                            scales.get("k_scale"),
                                            scales.get("v_scale"))
    assert bool((got[0, nvalid:] == 0).all())   # padded queries: zeros
    return got, want, moved


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("C,prefix,nvalid,window", [
    (1, 300, 1, 128), (16, 300, 13, 128), (16, 64, 16, None),
    (64, 200, 64, 128), (64, 0, 50, None), (64, 131, 64, 40)])
def test_prefill_wgmma_kernel_matches_plain(gen, hd, page, C, prefix,
                                            nvalid, window):
    """The wgmma prefill kernel at C 1, 16 and 64 (64 and 128 rows per
    CTA), pages of 8, 16 and 32 slots, hd 64 and 128, with and without a
    window (its edge in the pool, or inside the chunk at window 40): only
    its counter moves."""
    got, want, moved = _wgmma_prefill(gen, C, 8, 4, hd, prefix, nvalid,
                                      window, page)
    assert moved == {"paged_attention_prefill_wgmma": 1}
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("prefix,nvalid,window", [
    (600, 512, 300), (4608, 512, 4096), (4096, 104, 4096)])
def test_prefill_wgmma_kernel_window_edge_inside_a_wide_chunk(
        gen, prefix, nvalid, window):
    """mixtral-8x7b's 512-token chunk (32 query heads over 8, hd 128)
    through the wgmma kernel, the window's edge at the three positions of
    ``test_prefill_kernel_window_edge_inside_a_wide_chunk``."""
    got, want, moved = _wgmma_prefill(gen, 512, 8, 4, 128, prefix, nvalid,
                                      window)
    assert moved == {"paged_attention_prefill_wgmma": 1}
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("C,KVH,G,hd,prefix,nvalid,window,page", [
    (3, 1, 48, 128, 37, 3, None, 16),     # granite: one token per CTA row
    (16, 1, 48, 128, 100, 11, 64, 16),    # two tokens per CTA
    (40, 4, 6, 128, 70, 33, 30, 16),      # G 6: 21 tokens of 128 rows
    (64, 8, 3, 128, 130, 64, None, 16),   # G 3
    (8, 2, 2, 64, 16, 8, None, 16),       # the serving launcher's chunk
    (16, 8, 4, 128, 300, 13, 128, 128),   # 64-slot pieces of a page
    (512, 8, 4, 128, 4608, 512, None, 16),   # a long prompt, no window
])
def test_prefill_wgmma_kernel_groups_and_pages(gen, C, KVH, G, hd, prefix,
                                               nvalid, window, page):
    got, want, moved = _wgmma_prefill(gen, C, KVH, G, hd, prefix, nvalid,
                                      window, page)
    assert moved == {"paged_attention_prefill_wgmma": 1}
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("pool", ["int8", "fp8"])
@pytest.mark.parametrize("C,KVH,G,hd,prefix,nvalid,window,page", [
    (16, 8, 4, 128, 300, 13, 128, 16),
    (1, 8, 4, 128, 300, 1, 128, 32),
    (64, 8, 4, 64, 200, 64, 40, 8),
    (8, 2, 2, 64, 40, 3, None, 16),       # the serving launcher's chunk
    (512, 8, 4, 128, 4608, 512, 4096, 16),   # mixtral's chunk
    (512, 8, 4, 128, 600, 512, 300, 16),
])
def test_prefill_wgmma_kernel_quant_pools(gen, pool, C, KVH, G, hd, prefix,
                                          nvalid, window, page):
    """K1c's prefill face on the wgmma kernel: int8/fp8 codes landed by
    TMA and converted to bf16 in shared memory, the per-slot scales folded
    in per key; only its counter moves."""
    got, want, moved = _wgmma_prefill(gen, C, KVH, G, hd, prefix, nvalid,
                                      window, page, pool)
    assert moved == {"paged_attention_prefill_quant_wgmma": 1}
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


FACES = ("flash_attention_wgmma", "flash_attention_tile",
         "flash_attention_f32_tc")
# (H, S, rows): B = 1; flash_rows takes 64 rows per CTA where
# H * ceil(S / 128) < 132, else 128
WGMMA_SHAPES = [(2, 64, 64), (140, 64, 128), (4, 512, 64), (40, 512, 128),
                (2, 2048, 64), (9, 2048, 128), (2, 100, 64),
                (140, 100, 128)]
FLASH_MASKS = [(True, None), (True, 128), (False, None), (False, 50)]


def _flash_face(gen, H, S, hd, dtype, causal, window):
    """One flash call against its plain version; returns (got, want,
    {face counter: launches})."""
    q, k, v = (torch.randn(1, H, S, hd, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    ops.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    return got, want, {f: counts[f] for f in FACES if counts[f]}


@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
@pytest.mark.parametrize("H,S,rows", WGMMA_SHAPES)
def test_flash_wgmma_face_matches_plain(gen, hd, causal, window, H, S, rows):
    """bf16 at hd 64/80/128 runs the wgmma face, at both row counts (the
    route from the shape), S 64, 512, 2048 and a ragged S (100)."""
    assert fa.flash_rows(H, S, hd, torch.bfloat16) == rows
    got, want, moved = _flash_face(gen, H, S, hd, torch.bfloat16, causal,
                                   window)
    assert moved == {"flash_attention_wgmma": 1}
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("hd", [32, 64, 80, 128])
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
@pytest.mark.parametrize("S", [64, 100, 512])
def test_flash_f32_face_matches_plain(gen, hd, causal, window, S):
    """f32 runs the 3xTF32 tensor-core face at every head dim, within the
    f32 tolerance (1e-4)."""
    got, want, moved = _flash_face(gen, 3, S, hd, torch.float32, causal,
                                   window)
    assert moved == {"flash_attention_f32_tc": 1}
    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.parametrize("causal,window", FLASH_MASKS)
@pytest.mark.parametrize("S", [64, 100, 512])
def test_flash_tile_face_at_hd32(gen, causal, window, S):
    """bf16 at hd 32 runs the mma.sync tile."""
    got, want, moved = _flash_face(gen, 3, S, 32, torch.bfloat16, causal,
                                   window)
    assert moved == {"flash_attention_tile": 1}
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


def test_flash_wgmma_face_takes_unaligned_operands(gen):
    """The wgmma face's tensor maps need 16-byte aligned rows: operands
    that start 2 bytes into their storage are copied, not refused."""
    base = torch.randn(3 * 2 * 256 * 64 + 1, generator=gen, device="cuda")
    base = base.to(torch.bfloat16)
    q, k, v = base[1:].view(3, 1, 2, 256, 64).unbind(0)
    assert q.data_ptr() % 16 != 0
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, True)
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
    (2, 96, 8, 32, 16, 32, True), (1, 2048, 80, 64, 128, 256, False),
    (1, 2048, 80, 64, 128, 128, True), (1, 1024, 80, 64, 64, 128, False),
    (2, 384, 8, 64, 128, 192, True), (1, 256, 3, 64, 64, 64, True),
    (1, 96, 4, 64, 128, 32, False)])
def test_ssd_kernel_matches_plain(gen, B, S, H, P, N, chunk, stress):
    """The JAX test shapes (one with a head group that does not divide
    H), a chunk of 33 (S under the chunk), the full-width heads with the
    init's steep decays, 16 chunks of state passing, two batch rows at
    full heads, the wrapper's chunk of 128 and chunks of 192 and 64 at
    full width, an odd head count, and a chunk of 32 at full width. The
    full-width shapes (P 64, N 128 or 64, chunks of 64-256 in steps of
    64) run the wgmma face, the others the tile face: one launch of the
    face ``ssd_face`` picks, none of the other."""
    args = _ssd_inputs(gen, B, S, H, P, N, stress)
    face = sd.ssd_face(P, N, min(chunk, S))
    assert face == ("wgmma" if P == 64 and chunk >= 64 else "tile")
    ops.reset_launch_counts()
    y, h = sd.ssd_scan(*args, chunk=chunk, head_group=4)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ssd_scan"] == 1
    assert counts["ssd_scan_" + face] == 1
    assert counts["ssd_scan_wgmma"] + counts["ssd_scan_tile"] == 1
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


def test_ssd_wgmma_face_padded_and_deterministic_at_n64(gen):
    """zamba2's state (N 64) on the wgmma face, as the two tests above
    hold N 128: S = 1000 padded to 1024 with dt = 0 under the init's
    decays gives the plain recurrence's y on the real positions and its
    final state, zero padded rows, and a second call agrees bit for
    bit."""
    N = 64
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 1000, 80, 64, N, stress=True)
    pad = [torch.nn.functional.pad(t, [0, 0] * (t.dim() - 2) + [0, 24])
           for t in (x, dt, Bm, Cm)]
    ops.reset_launch_counts()
    y, h = sd.ssd_scan(pad[0], pad[1], A, pad[2], pad[3], chunk=256)
    y2, h2 = sd.ssd_scan(pad[0], pad[1], A, pad[2], pad[3], chunk=256)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan_wgmma"] == 2
    yp, hp = sd.ssd_scan_plain(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y[:, :1000], yp, **SSD_TOL)
    torch.testing.assert_close(h, hp, **SSD_TOL)
    assert not y[:, 1000:].any()
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_ssd_tile_face_called_directly(gen):
    """``ssd_scan_tile`` runs the tile face at a full-width shape (the
    times phase holds the two faces side by side): only its counter
    moves, and it agrees with the wgmma face within the tolerance."""
    args = _ssd_inputs(gen, 1, 1024, 80, 64, 128, stress=True)
    ops.reset_launch_counts()
    yt, ht = sd.ssd_scan_tile(*args, chunk=256)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["ssd_scan"], counts["ssd_scan_wgmma"],
            counts["ssd_scan_tile"]) == (0, 0, 1)
    y, h = sd.ssd_scan(*args, chunk=256)
    torch.testing.assert_close(yt, y, **SSD_TOL)
    torch.testing.assert_close(ht, h, **SSD_TOL)


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
                                  "zamba2-2.7b", "mixtral-8x7b",
                                  "internvl2-2b"])
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
    if cfg.arch_type in ("ssm", "hybrid"):
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
    """Decode at hd 32 and 80 over every pool dtype (``decode_kernel``
    pads an hd-80 bf16 row to 16 lanes, an f32 row to 32, an int8/fp8 row
    to 8; bf16 queries at hd 80 over a bf16/int8/fp8 pool take the
    cluster face): a 64-page table, so each lane's pages split in two and
    merge."""
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
    assert ops.launch_counts()[_decode_count(q, kp, bool(scales))] == 1
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


SERVE_LENS = [0] + [15 + (128 * i) // 14 for i in range(15)]
# every served decode shape: (B, H, KVH, hd, page, bp, lens)
SERVED_DECODE = {
    "serve": (16, 32, 8, 128, 16, 32, SERVE_LENS),
    "mesh_rank": (16, 16, 4, 128, 16, 32, SERVE_LENS),
    "zamba2": (16, 32, 32, 80, 16, 32, SERVE_LENS),
    "granite": (8, 48, 1, 128, 16, 32, [0] + [15 + (32 * i) // 6
                                              for i in range(7)]),
    "qwen3_1_7b": (8, 16, 8, 128, 16, 32, [0, 1, 15, 16, 17, 47, 48, 512]),
    "phi4_mini": (8, 24, 8, 128, 16, 32, [0, 1, 15, 16, 17, 47, 48, 512]),
    "starcoder2": (8, 24, 2, 128, 16, 32, [0, 1, 15, 16, 17, 47, 48, 512]),
    "mixtral": (4, 32, 8, 128, 16, 288, [0, 4206, 4211, 4216]),
    "long_rows": (16, 32, 8, 128, 16, 256, [0] + [1024 + (3072 * i) // 14
                                                  for i in range(15)]),
    "seamless": (8, 16, 16, 64, 16, 8, [0, 65, 76, 86, 97, 107, 118, 128]),
    "launcher": (16, 4, 2, 64, 16, 16, [0, 1] + [20 + (236 * i) // 13
                                                 for i in range(14)]),
    "page8": (8, 32, 8, 128, 8, 64, [0, 1, 7, 8, 9, 16, 17, 512]),
    "page32": (8, 32, 8, 128, 32, 16, [0, 1, 31, 32, 33, 16, 17, 512]),
}


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("shape", list(SERVED_DECODE))
def test_cluster_face_at_served_shapes(gen, shape, pool):
    """bf16 queries at every served decode shape (and pages of 8 and 32)
    take the cluster face, one launch that moves only its counter, and
    agree with the plain version at 1e-2; a lane of length 0 emits
    zeros."""
    B, H, KVH, hd, page, bp, lens = SERVED_DECODE[shape]
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, hd, generator=gen, device="cuda").bfloat16()
    if pool in QUANT:
        kp, vp, bt, ks, vs = _quant_pools(gen, B, bp, KVH, hd, pool, page)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp, bt = _pools(gen, B, bp, KVH, hd, torch.bfloat16, page)
        scales = {}
    ops.reset_launch_counts()
    got = pa.paged_attention(q, kp, vp, bt, lens_t, scale=hd ** -0.5,
                             **scales)
    want = pa.paged_attention_plain(q, kp, vp, bt, lens_t, hd ** -0.5,
                                    scales.get("k_scale"),
                                    scales.get("v_scale"))
    torch.cuda.synchronize()
    face = ("paged_attention_decode_quant_cluster" if scales
            else "paged_attention_decode_cluster")
    assert {k: n for k, n in ops.launch_counts().items() if n} == {face: 1}
    assert bool((got[lens.index(0)] == 0).all())
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("pool", ["bf16", "fp8"])
def test_cluster_face_graph_replays_new_lengths(gen, pool):
    """The cluster face captured in a CUDA graph, as the engine's decode
    horizon captures it: replayed after the lengths, the block tables and
    the queries change on the device (the pools stay where they are), it
    computes the new inputs' attention; every lane emptied, zeros."""
    B, H, KVH, hd, page, bp, lens = SERVED_DECODE["serve"]
    q = torch.randn(B, H, hd, generator=gen, device="cuda").bfloat16()
    if pool in QUANT:
        kp, vp, bt, ks, vs = _quant_pools(gen, B, bp, KVH, hd, pool, page)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp, bt = _pools(gen, B, bp, KVH, hd, torch.bfloat16, page)
        scales = {}
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")

    def call():
        return pa.paged_attention(q, kp, vp, bt, cl, scale=hd ** -0.5,
                                  **scales)

    def plain():
        return pa.paged_attention_plain(q, kp, vp, bt, cl, hd ** -0.5,
                                        scales.get("k_scale"),
                                        scales.get("v_scale"))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for new_lens in ([512 - 31 * i for i in range(B)], [0] * B):
        cl.copy_(torch.tensor(new_lens, dtype=torch.int32))
        bt.copy_(bt.flip(0))
        q.copy_(torch.randn(q.shape, generator=gen, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), plain().float(),
                                   **TOL[torch.bfloat16])
    assert bool((out == 0).all())


def test_split_face_called_directly_runs_decode_kernel(gen):
    """``paged_attention_split`` launches ``decode_kernel`` on the inputs
    the route gives the cluster face (the times phase holds the two faces
    side by side): its counter moves, and the two agree within bf16
    rounding."""
    B, H, KVH, hd, page, bp, lens = SERVED_DECODE["serve"]
    q = torch.randn(B, H, hd, generator=gen, device="cuda").bfloat16()
    kp, vp, bt = _pools(gen, B, bp, KVH, hd, torch.bfloat16, page)
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ops.reset_launch_counts()
    cluster = pa.paged_attention(q, kp, vp, bt, cl, scale=0.1)
    split = pa.paged_attention_split(q, kp, vp, bt, cl, scale=0.1)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["paged_attention_decode_cluster"] == 1
    assert counts["paged_attention_decode"] == 1
    torch.testing.assert_close(cluster.float(), split.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("page", [4, 24])
def test_decode_any_page_size(gen, pool, page):
    """Pages the cluster face does not take (not 8 and not a multiple of
    16; the JAX kernel takes any page, and the reference's tests use
    pages of 4) decode on the split face: bf16 queries at hd 128 over a
    bf16, int8 or fp8 pool agree with the plain version, one launch of
    ``decode_kernel`` and nothing else."""
    B, KVH, G, hd, bp = 6, 8, 4, 128, 32
    full = page * bp
    lens = torch.tensor([0, 1, page - 1, page + 1, full // 2, full],
                        dtype=torch.int32, device="cuda")
    q = torch.randn(B, KVH * G, hd, generator=gen,
                    device="cuda").bfloat16()
    kp, vp, bt, scales = _any_pools(gen, B, bp, KVH, hd, pool, page)
    assert pa.decode_face(q.dtype, kp.dtype, hd, page) == "split"
    ops.reset_launch_counts()
    got = pa.paged_attention(q, kp, vp, bt, lens, scale=hd ** -0.5,
                             **scales)
    want = pa.paged_attention_plain(q, kp, vp, bt, lens, hd ** -0.5,
                                    scales.get("k_scale"),
                                    scales.get("v_scale"))
    torch.cuda.synchronize()
    face = ("paged_attention_decode_quant" if scales
            else "paged_attention_decode")
    assert {k: n for k, n in ops.launch_counts().items() if n} == {face: 1}
    assert bool((got[0] == 0).all())
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("page", [4, 24])
def test_prefill_any_page_size(gen, pool, page):
    """The chunked-prefill face at the same pages (the mma.sync tile:
    ``prefill_rows`` gives the wgmma kernel none of them) agrees with its
    plain version."""
    KVH, G, hd, C, prefix, nvalid = 8, 4, 128, 16, 3 * page + 5, 13
    bp = -(-prefix // page) + 1
    q = torch.randn(1, C, KVH * G, hd, generator=gen,
                    device="cuda").bfloat16()
    own = [torch.randn(1, C, KVH, hd, generator=gen, device="cuda")
           .bfloat16() for _ in range(2)]
    kp, vp, bt, scales = _any_pools(gen, 1, bp, KVH, hd, pool, page)
    assert pa.prefill_rows(C, G, hd, page, q.dtype, kp.dtype) == 0
    pl = torch.tensor([prefix], dtype=torch.int32, device="cuda")
    nv = torch.tensor([nvalid], dtype=torch.int32, device="cuda")
    args = (q, kp, vp, bt, pl, nv, *own)
    ops.reset_launch_counts()
    got = pa.paged_attention_prefill(*args, scale=hd ** -0.5, **scales)
    want = pa.paged_attention_prefill_plain(*args, hd ** -0.5, None,
                                            scales.get("k_scale"),
                                            scales.get("v_scale"))
    torch.cuda.synchronize()
    face = ("paged_attention_prefill_quant" if scales
            else "paged_attention_prefill")
    assert {k: n for k, n in ops.launch_counts().items() if n} == {face: 1}
    assert bool((got[0, nvalid:] == 0).all())
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


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


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("prefix,nvalid,window", [
    (600, 512, 300), (4608, 512, 4096), (4096, 104, 4096)])
def test_prefill_kernel_window_edge_inside_a_wide_chunk(gen, pool, dtype,
                                                        prefix, nvalid,
                                                        window):
    """mixtral-8x7b's chunked prefill: 512-token chunks at 32 query heads
    over 8 (hd 128) under a sliding window whose edge moves through the
    chunk's rows: inside the chunk's own K/V (prefix 600, window 300),
    across 32 pages of the pooled prefix (prefix 4608, window 4096), and
    at the first chunk past the window (4096 + 104 tokens)."""
    KVH, G, hd, C = 8, 4, 128, 512
    bp = prefix // 16 + 1
    q = torch.randn(1, C, KVH * G, hd, generator=gen, device="cuda")
    own = [torch.randn(1, C, KVH, hd, generator=gen, device="cuda")
           .to(dtype) for _ in range(2)]
    kp, vp, bt, scales = _any_pools(gen, 1, bp, KVH, hd, pool)
    pl = torch.tensor([prefix], dtype=torch.int32, device="cuda")
    nv = torch.tensor([nvalid], dtype=torch.int32, device="cuda")
    args = (q.to(dtype), kp, vp, bt, pl, nv, *own)
    scale = hd ** -0.5
    got = pa.paged_attention_prefill(*args, scale=scale, window=window,
                                     **scales)
    want = pa.paged_attention_prefill_plain(*args, scale, window,
                                            scales.get("k_scale"),
                                            scales.get("v_scale"))
    wide = pa.paged_attention_prefill_plain(*args, scale, None,
                                            scales.get("k_scale"),
                                            scales.get("v_scale"))
    torch.cuda.synchronize()
    assert bool((got[0, nvalid:] == 0).all())
    assert (want - wide).abs().max().item() > 1e-3   # the window bites
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


def _smoke_engines(gen, arch, cfg=None, prompt="3+5-2=", **kw):
    """Greedy STEP on ``arch``'s smoke config (or ``cfg``), f32 params
    without EOS (every trace decodes its 40 tokens, so 8 traces fill the
    16-block pool): the kernel engine's and the dense engine's results
    and launch counts."""
    cfg = cfg or serving_config(arch)
    params = _no_eos(_f32(init_params(cfg, gen)), cfg)
    scorer = init_scorer(gen, cfg.d_model)
    prompt = get_tokenizer().encode(prompt, add_bos=True)
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


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "internvl2-2b"])
def test_moe_and_vlm_engine_kernel_path_matches_dense_on_card(gen, arch):
    """mixtral's smoke config with an 8-token window and internvl2's,
    f32 params and pool, a 25-token prompt prefilled in chunks of 4: the
    kernel engine (K1b under the window, K1a, K2) against the dense
    engine, identical greedy tokens and statuses, step scores within
    1e-5; then ``forward_full(use_kernel=True)`` (K3, windowed for
    mixtral) against the dense forward at 1e-4."""
    cfg = serving_config(arch)
    if cfg.sliding_window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=8)
    cfg, params, runs = _smoke_engines(gen, arch, cfg=cfg,
                                       prompt="12+34-5=41;6+7=13;8-2+9=",
                                       kv_dtype="f32", prefill_chunk_size=4)
    (k, kc), (d, dc) = runs[True], runs[False]
    assert kc["paged_attention_prefill"] > 0
    assert kc["paged_attention_decode"] == \
        kc["step_score"] * cfg.num_layers > 0
    assert dc["paged_attention_decode"] == dc["paged_attention_prefill"] == 0
    _same_greedy(k, d)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                           device="cuda", dtype=torch.int32)
    ops.reset_launch_counts()
    got = tm.forward_full(params, cfg, tokens, use_kernel=True)
    counts = ops.launch_counts()
    want = tm.forward_full(params, cfg, tokens)
    torch.cuda.synchronize()
    assert counts["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(got["logits"], want["logits"],
                               **TOL[torch.float32])
    torch.testing.assert_close(got["aux_loss"], want["aux_loss"],
                               **TOL[torch.float32])


# ---------------------------------------------------------------------------
# deepseek-v2 (MLA latent pool, MoE with shared experts) and seamless-m4t
# (encoder-decoder: K1a and K3 at hd 64 with 16 query heads over 16)
# ---------------------------------------------------------------------------

def _mla_serve(cfg, params, scorer, device, eager=False):
    """Greedy STEP over 8 traces of one prompt at deepseek's smoke config
    ("auto": dense, the plain scorer), the 16-block pool pruning."""
    ecfg = te.EngineConfig(
        max_batch=8, num_blocks=16, capacity=128, max_new_tokens=40,
        sampling=SamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                                max_new_tokens=40),
        use_kernel="auto", decode_horizon=4, faults=None, kv_dtype="f32")
    eng = TickCountingEngine(params, cfg, ecfg, make_policy("step"),
                             scorer_params=scorer, device=device,
                             _eager_decode=eager)
    ops.reset_launch_counts()
    res = eng.serve(get_tokenizer().encode("3+5-2=", add_bos=True), 8)
    if device == "cuda":
        torch.cuda.synchronize()
    assert eng.pool_drained() and not eng.use_kernel
    assert not eng.fused_scorer
    return eng, res, ops.launch_counts()


def test_deepseek_graphed_engine_matches_eager_engine(gen):
    """deepseek's smoke config on the card, f32 params without EOS: the
    graphed engine (one replay per tick) gives the eager engine's tokens,
    statuses, prunes and step scores, and neither launches K1 or K2 (MLA
    has no kernel path, so the scorer is the plain one)."""
    cfg = serving_config("deepseek-v2-236b")
    params = _no_eos(_f32(init_params(cfg, gen)), cfg)
    scorer = init_scorer(gen, cfg.d_model)
    e_eng, e_res, e_counts = _mla_serve(cfg, params, scorer, "cuda", True)
    g_eng, g_res, g_counts = _mla_serve(cfg, params, scorer, "cuda")
    assert g_counts["decode_graph_replays"] == g_eng.ticks == e_eng.ticks > 0
    for counts in (e_counts, g_counts):
        assert all(n == 0 for k, n in counts.items()
                   if not k.startswith("decode_graph"))
    _same_greedy(g_res, e_res)
    for tg, te_ in zip(g_res.traces, e_res.traces):
        assert tg.step_scores == te_.step_scores


def test_deepseek_cuda_engine_matches_cpu_engine(gen):
    """The same serve on the CPU engine and on the card from the same f32
    params: identical greedy tokens, statuses and prunes, step scores
    within 1e-4 (the two devices sum in other orders)."""
    cfg = serving_config("deepseek-v2-236b")
    params = _no_eos(_f32(init_params(cfg, gen)), cfg)
    scorer = init_scorer(gen, cfg.d_model)
    _, c_res, _ = _mla_serve(cfg, params, scorer, "cpu")
    _, g_res, _ = _mla_serve(cfg, params, scorer, "cuda")
    assert g_res.num_pruned == c_res.num_pruned > 0
    for tg, tc in zip(g_res.traces, c_res.traces):
        assert tg.output_tokens == tc.output_tokens
        assert tg.status == tc.status
        for a, b in zip(tg.step_scores, tc.step_scores):
            assert abs(a - b) <= 1e-4


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_seamless_shape(gen, pool, dtype):
    """seamless-m4t's decoder: 16 query heads over 16 kv heads (group 1)
    at hd 64, 8 lanes of 65-128 slots over 8-page rows, every pool
    dtype."""
    B, KVH, hd, bp = 8, 16, 64, 8
    lens = torch.tensor([0, 1, 65, 80, 96, 100, 127, 128],
                        dtype=torch.int32, device="cuda")
    q = torch.randn(B, KVH, hd, generator=gen, device="cuda").to(dtype)
    kp, vp, bt, scales = _any_pools(gen, B, bp, KVH, hd, pool)
    got = pa.paged_attention(q, kp, vp, bt, lens, scale=hd ** -0.5,
                             **scales)
    want = pa.paged_attention_plain(q, kp, vp, bt, lens, hd ** -0.5,
                                    scales.get("k_scale"),
                                    scales.get("v_scale"))
    torch.cuda.synchronize()
    assert bool((got[0] == 0).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_seamless_kernel_paths_match_dense_on_card(gen):
    """seamless-m4t's smoke config, f32 params, encoder embeddings of its
    32 frames: ``forward_full(use_kernel=True)`` (K3 per decoder layer,
    the encoder dense) against the dense forward at 1e-4; then a 12-token
    prefill, ``build_cross_cache`` and 6 decode steps through K1a (one
    per decoder layer and step) against dense decode steps, logits at
    1e-4 at every step."""
    cfg = serving_config("seamless-m4t-large-v2")
    params = _f32(init_params(cfg, gen))
    B, S = 2, 12
    enc = 0.5 * torch.randn(B, cfg.encoder_seq_len, cfg.d_model,
                            generator=gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 6), generator=gen,
                           device="cuda", dtype=torch.int32)
    ops.reset_launch_counts()
    got = tm.forward_full(params, cfg, tokens, encoder_embeds=enc,
                          use_kernel=True)
    counts = ops.launch_counts()
    want = tm.forward_full(params, cfg, tokens, encoder_embeds=enc)
    assert counts["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(got["logits"], want["logits"],
                               **TOL[torch.float32])
    out = tm.forward_full(params, cfg, tokens[:, :S], encoder_embeds=enc,
                          return_kv=True)
    cross = tm.build_cross_cache(params, cfg, tm.encode(params, cfg, enc))
    caches = {}
    for use_kernel in (False, True):
        c = tm.write_prefill_kv(cfg, tm.init_decode_cache(
            cfg, B, 64, kv_dtype="f32", device="cuda"), out["kvs"],
            torch.full((B,), S, dtype=torch.int32, device="cuda"))
        c["cross_k"], c["cross_v"] = cross
        caches[use_kernel] = c
    for i in range(6):
        pos = torch.full((B,), S + i, dtype=torch.int32, device="cuda")
        ops.reset_launch_counts()
        logits = {k: tm.decode_step(params, cfg, tokens[:, S + i:S + i + 1],
                                    pos, caches[k], window_len=64,
                                    use_kernel=k)["logits"]
                  for k in (False, True)}
        assert ops.launch_counts()["paged_attention_decode"] == \
            cfg.num_layers
        torch.testing.assert_close(logits[True], logits[False],
                                   **TOL[torch.float32])


@pytest.mark.parametrize("arch", ["qwen3-4b-thinking", "zamba2-2.7b",
                                  "deepseek-v2-236b"])
def test_serve_decode_step_on_card_matches_cpu(gen, arch):
    """The launchers' contiguous-cache decode (``serve_decode_step``,
    dense) on the card against the same calls on the CPU, at a smoke
    config in f32: a 12-token prefill seeds each side's caches
    (``write_contiguous_kv``), then 6 decode steps past the 16-slot
    ring's wrap; logits and hidden at 1e-4, greedy tokens equal."""
    from repro_torch.launch import steps
    cfg = serving_config(arch)
    params = {"cuda": _f32(init_params(cfg, gen))}
    params["cpu"] = T.map_tree(lambda x: x.cpu(), params["cuda"])
    B, S, cap = 2, 12, 16
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 6), generator=gen,
                           device="cuda", dtype=torch.int32)
    caches, decode = {}, steps.make_decode_step(cfg)
    for dev in ("cuda", "cpu"):
        pre = steps.make_prefill_step(cfg)(params[dev],
                                           {"tokens": tokens[:, :S].to(dev)})
        la = len(cfg.attention_layer_ids())
        c = {}
        if cfg.use_mla:
            c["kv_cache"] = torch.zeros(
                la, B, cap, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                device=dev)
        else:
            for key in ("k_cache", "v_cache"):
                c[key] = torch.zeros(la, B, cap, cfg.num_kv_heads,
                                     cfg.head_dim, device=dev)
        if cfg.arch_type == "hybrid":
            c["ssm_state"] = torch.zeros(
                cfg.num_layers, B, cfg.ssm_heads, cfg.ssm_head_dim,
                cfg.ssm_state_size, device=dev)
            c["conv_state"] = torch.zeros(
                cfg.num_layers, B, cfg.ssm_conv_width - 1,
                cfg.d_inner + 2 * cfg.ssm_state_size, device=dev)
        caches[dev] = tm.write_contiguous_kv(cfg, c, pre["kvs"])
    for i in range(6):
        out = {}
        for dev in ("cuda", "cpu"):
            batch = {"tokens": tokens[:, S + i:S + i + 1].to(dev),
                     "positions": torch.full((B,), S + i, dtype=torch.int32,
                                             device=dev)}
            out[dev] = decode(params[dev], batch, caches[dev])
        for key in ("logits", "hidden"):
            torch.testing.assert_close(out["cuda"][key].cpu(),
                                       out["cpu"][key],
                                       **TOL[torch.float32])
        assert torch.equal(out["cuda"]["next_token"].cpu(),
                           out["cpu"]["next_token"])


def test_mesh_engine_on_card_matches_single_device(gen, tmp_path):
    """Two gloo ranks sharing the card as a (1, 2) mesh (each holds half
    the heads; gloo stages its gathers through the host), f32 smoke
    config, greedy, chunked, through the kernels: the single-device CUDA
    engine's tokens, statuses and prunes, step scores within 1e-4 (cuBLAS
    may pick another algorithm for a rank's narrower products), and K1a
    and K1b launched on both ranks."""
    import torch_mesh_ranks as R
    ops.build_kernels()            # once, before the ranks load them
    cfg = serving_config()
    g = torch.Generator().manual_seed(0)
    params = T.map_tree(lambda x: x.float(), init_params(cfg, g))
    scorer = init_scorer(g, cfg.d_model)
    torch.save({"params": params, "scorer": scorer}, tmp_path / "params.pt")
    tok = get_tokenizer()
    want = R.run_scenario("kernel_greedy", params, cfg, scorer, tok,
                          device="cuda")
    ranks = R.spawn(2, str(tmp_path / "mesh"), "mesh_scenarios",
                    str(tmp_path / "params.pt"),
                    {"1x2": ((1, 2), ("kernel_greedy",))}, "cuda:0")
    for out in ranks:
        got = out["1x2"]["kernel_greedy"]
        assert got["use_kernel"] is True
        for wg, ww in zip(got["waves"], want["waves"]):
            for rg, rw in zip(wg, ww):
                assert rg["num_pruned"] == rw["num_pruned"]
                for tg, tw in zip(rg["traces"], rw["traces"]):
                    assert tg[0] == tw[0] and tg[3] == tw[3]
                    assert len(tg[1]) == len(tw[1])
                    assert all(abs(a - b) <= 1e-4
                               for a, b in zip(tg[1], tw[1]))
        assert got["launches"]["paged_attention_decode"] > 0
        assert got["launches"]["paged_attention_prefill"] > 0
        assert got["launches"]["decode_graph_captures"] == 0
