"""The port's CUDA kernels on a card: each wrapper against its plain
PyTorch version, and the CUDA engine's kernel path against its dense
path. Every test here needs a CUDA card (and ``nvcc`` for the first
build) and skips without one. The file imports no jax, so it runs where
only the port's dependencies are installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 at 1e-4 (summation order); bf16 outputs at 1e-2 absolute
plus 1e-2 relative (both sides accumulate in f32, the output is rounded
to bf16, one ulp is 2^-8 relative); scores at 1e-5 (f32 throughout).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import serving_config  # noqa: E402
from repro_torch.core.pruning import make_policy  # noqa: E402
from repro_torch.core.scorer import init_scorer  # noqa: E402
from repro_torch.data.tokenizer import get_tokenizer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import step_score as ss  # noqa: E402
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,D", [(1, 256), (13, 256), (64, 2560)])
def test_step_score_kernel_matches_plain(gen, dtype, B, D):
    h = torch.randn(B, D, generator=gen, device="cuda").to(dtype)
    w1 = torch.randn(D, 512, generator=gen, device="cuda") * D ** -0.5
    b1 = torch.randn(512, generator=gen, device="cuda") * 0.1
    w2 = torch.randn(512, 1, generator=gen, device="cuda") * 512 ** -0.5
    b2 = torch.randn(1, generator=gen, device="cuda") * 0.1
    got = ss.step_score(h, w1, b1, w2, b2)
    torch.testing.assert_close(got, ss.step_score_plain(h, w1, b1, w2, b2),
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
        ops.paged_attention(q[..., :32].contiguous(), kp[..., :32]
                            .contiguous(), vp[..., :32].contiguous(), bt,
                            lens, scale=0.1)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"paged_attention_decode": 1,
                                   "paged_attention_prefill": 0,
                                   "step_score": 0}


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
