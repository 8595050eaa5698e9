"""Serving ``mamba2-2.7b`` (the ssm stack: per-slot recurrent state, no
KV pool) through ``Engine.serve`` in the port against the JAX engine,
and the engine's slot-state plumbing.

The parity runs use the JAX package's default bf16 params: with f32
params the JAX engine fails (its fused horizon's ``lax.scan`` takes
``conv_state`` in as bf16, the cache's dtype, and gets it back as f32
from ``causal_conv1d_step``). Greedy tokens, statuses, prune and preempt
counts must be identical; step scores and confidences within 1e-2, as
``test_torch_engine_paths.py::test_bf16_step_matches_jax`` holds bf16.
"""
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.registry import serving_config as j_serving_config  # noqa: E402
from repro.core.scorer import init_scorer as j_init_scorer  # noqa: E402
from repro.data.arithmetic import make_prompt  # noqa: E402
from repro.data.tokenizer import get_tokenizer  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro.serving.evaluate import make_problems  # noqa: E402
from repro_torch.configs.registry import serving_config  # noqa: E402
from repro_torch.core.pruning import make_policy  # noqa: E402
from repro_torch.core.trace import TraceStatus  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, scorer_from_numpy  # noqa: E402
from repro_torch.serving import engine as te  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from test_torch_engine import assert_same_results, serve_jax, serve_torch  # noqa: E402

ARCH = "mamba2-2.7b"


@pytest.fixture(scope="module")
def setup():
    jcfg = j_serving_config(ARCH)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    js = j_init_scorer(jax.random.PRNGKey(1), jcfg.d_model)
    tok = get_tokenizer()
    prompts = [tok.encode(make_prompt(p), add_bos=True)
               for p in make_problems(3, seed=11)]
    return {"jcfg": jcfg, "cfg": serving_config(ARCH), "jp": jp, "js": js,
            "tp": params_from_numpy(jax.device_get(jp), device="cpu"),
            "ts": scorer_from_numpy(jax.device_get(js), device="cpu"),
            "prompts": prompts}


def _kw(**kw):
    base = dict(max_batch=8, num_blocks=16, capacity=128, max_new_tokens=40,
                use_kernel=False, faults=None, prefix_cache=True,
                decode_horizon=4)
    base.update(kw)
    return base


@pytest.mark.parametrize("method", ["step", "sc"])
def test_greedy_serve_matches_jax(setup, method):
    """8 traces of one prompt in a 16-block pool: STEP prunes, SC
    preempts and re-prefills; the port (through its kernel wrappers, the
    fused scorer's plain version here) equals the JAX engine."""
    _, jres = serve_jax(setup, method, setup["prompts"][:1], 8, **_kw())
    eng, tres = serve_torch(setup, method, setup["prompts"][:1], 8,
                            **_kw(use_kernel=True))
    assert eng.fused_scorer == (method == "step")
    assert_same_results(jres, tres, tol=1e-2)
    res = tres[0]
    if method == "step":
        assert res.num_pruned > 0 and res.num_preemptions == 0
        assert res.wait_s == 0.0
    else:
        assert res.num_preemptions > 0 and res.num_pruned == 0


class RecordingEngine(te.Engine):
    """Checks every slot-state write and clear as it happens."""

    def __init__(self, *args, **kw):
        self.events = []
        super().__init__(*args, **kw)

    def _write_prefill(self, cache, kvs, slot, block_row, seq_len):
        self.events.append(("prefill", slot, seq_len))
        return super()._write_prefill(cache, kvs, slot, block_row, seq_len)

    def _write_slot_state(self, cache, slot_state, slot):
        out = super()._write_slot_state(cache, slot_state, slot)
        ss, cs = slot_state
        assert torch.equal(out["ssm_state"][:, slot], ss)
        assert torch.equal(out["conv_state"][:, slot], cs.to(torch.bfloat16))
        self.events.append(("write", slot, ss.clone()))
        return out

    def _clear_slot_state(self, cache, slot):
        out = super()._clear_slot_state(cache, slot)
        assert not out["ssm_state"][:, slot].any()
        assert not out["conv_state"][:, slot].any()
        self.events.append(("clear", slot))
        return out


def _recorded(setup, method):
    """One greedy serve of 8 traces at horizon 1, where the traces of one
    prompt are prefixes of one sequence (see the last test)."""
    s = setup
    ecfg = te.EngineConfig(
        sampling=SamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                                max_new_tokens=40), **_kw(decode_horizon=1))
    eng = RecordingEngine(s["tp"], s["cfg"], ecfg, make_policy(method),
                          scorer_params=s["ts"], device="cpu")
    return eng, eng.serve(s["prompts"][0], 8)


def _end_state(setup, ids):
    out = tm.forward_full(setup["tp"], setup["cfg"],
                          torch.tensor([ids], dtype=torch.int32),
                          return_kv=True)
    return out["kvs"][0][:, 0]


def test_forked_traces_get_the_prompt_state_and_released_slots_clear(setup):
    """STEP: the prompt prefills once, and each of the 8 forked traces
    starts from its end state; every pruned or finished trace's slot is
    zeroed when it is released. (A dead slot then keeps decoding with the
    batch, as in the JAX package, so its state does not stay zero; the
    next admission overwrites all of it.)"""
    eng, res = _recorded(setup, "step")
    writes = [e for e in eng.events if e[0] == "write"]
    assert len(writes) == 8 and len({e[1] for e in writes}) == 8
    want = _end_state(setup, setup["prompts"][0])
    for _, _, ss in writes:
        torch.testing.assert_close(ss, want, rtol=0, atol=0)
    released = [t for t in res.traces
                if t.status in (TraceStatus.PRUNED, TraceStatus.FINISHED)]
    assert len(released) == 8 and res.num_pruned > 0
    assert len([e for e in eng.events if e[0] == "clear"]) == 8


def test_preempted_traces_recompute_their_state(setup):
    """SC under pressure: a preempted trace's slot is zeroed, and when it
    comes back its state is recomputed from a prefill of its prompt plus
    the tokens it had emitted."""
    eng, res = _recorded(setup, "sc")
    assert res.num_preemptions > 0
    prompt = setup["prompts"][0]
    longest = max((t.output_tokens for t in res.traces), key=len)
    recomputed = [i for i, e in enumerate(eng.events)
                  if e[0] == "prefill" and e[2] > len(prompt)]
    assert recomputed
    for i in recomputed:
        _, slot, seq_len = eng.events[i]
        assert eng.events[i + 1][:2] == ("write", slot)
        ids = prompt + longest[:seq_len - len(prompt)]
        torch.testing.assert_close(eng.events[i + 1][2],
                                   _end_state(setup, ids), rtol=0, atol=0)
    assert len([e for e in eng.events if e[0] == "clear"]) == \
        8 + res.num_preemptions


def test_decode_horizon_drifts_stopped_lanes_in_both_packages(setup):
    """Under a tight pool (12 blocks) a short free list shortens some
    lanes' limits inside a horizon; their recurrent state keeps taking
    the re-fed last token (test_torch_mamba2.py shows it on one lane).
    Greedy traces of one prompt are identical until they stop, so at
    horizon 1 every trace is a prefix of one sequence; at horizon 4 the
    stopped-and-resumed traces leave it. Both packages agree at each
    horizon."""
    traces = {}
    for horizon in (1, 4):
        kw = _kw(num_blocks=12, decode_horizon=horizon)
        _, jres = serve_jax(setup, "step", setup["prompts"][:1], 8, **kw)
        _, tres = serve_torch(setup, "step", setup["prompts"][:1], 8, **kw)
        assert_same_results(jres, tres, tol=1e-2)
        traces[horizon] = [t.output_tokens for t in tres[0].traces]

    def one_sequence(outs):
        longest = max(outs, key=len)
        return all(o == longest[:len(o)] for o in outs)

    assert one_sequence(traces[1])
    assert not one_sequence(traces[4])


def test_entry_points_default_to_the_card(setup, monkeypatch):
    """The bridge, the cache and the engine run on CUDA unless the caller
    names the CPU, and raise without a card. On the CPU a mamba2 engine
    has no KV pool (0 bytes a block), no chunked prefill and no prefix
    cache, and refuses a quantized pool, as the JAX engine does."""
    cfg, policy = setup["cfg"], make_policy("step")
    ecfg = te.EngineConfig(faults=None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = jax.device_get(setup["jp"])
    for call in (lambda: params_from_numpy(tree),
                 lambda: scorer_from_numpy(jax.device_get(setup["js"])),
                 lambda: tm.init_decode_cache(cfg, 2, 64),
                 lambda: te.Engine(setup["tp"], cfg, ecfg, policy)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    eng = te.Engine(setup["tp"], cfg, ecfg, policy, device="cpu")
    assert eng.kv_block_bytes == 0 and eng.prefix_cache is None
    assert not eng._chunk_supported
    with pytest.raises(NotImplementedError, match="dense GQA"):
        te.Engine(setup["tp"], cfg, te.EngineConfig(faults=None,
                                                    kv_dtype="int8"),
                  policy, device="cpu")
