"""The port's mesh engine (``Engine(mesh=...)``) on the CPU: four gloo
ranks, one process each, as a (2, 2) mesh, f32 params bridged from the
JAX package's init, one intra-op thread per rank
(``tests/test_torch_sharded_axes.py`` takes the (4, 1) and (1, 4)
meshes).

Every scenario of ``tests/torch_mesh_ranks.py`` (horizons 1 and 4,
one-shot and chunked prefill, greedy and temperature 0.8, the tight pool
where STEP prunes and SC preempts, two requests served twice with the
prefix cache, an int8 pool, the kernel route, an online run with
arrivals, bf16 params) gives on every rank exactly the single-device
engine's tokens, step scores, confidences, statuses, prunes and
preemptions: every collective is an all-gather, the ranks sample alike
from the gathered logits, and on one CPU thread each rank's products are
bit for bit slices of the single-device ones. bf16 is identical too in
the tested case (no tolerance is needed). One greedy serve is held
against the JAX single-device engine on the same weights. The gates,
the shards a rank keeps and the rank-agreement check run in the same
ranks (``mesh_checks``), one spawn shared by the file's cases.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402,F401

import torch_mesh_ranks as R  # noqa: E402
from repro.core.pruning import make_policy as j_make_policy  # noqa: E402
from repro.serving import engine as je  # noqa: E402
from repro.serving.sampling import SamplingParams as JSamplingParams  # noqa: E402
from torch_parity import mesh_setup  # noqa: E402

# every scenario but the card's own (kernel_greedy: the kernel route and
# chunked greedy are each here already)
NAMES = tuple(n for n in R.SCENARIOS if n != "kernel_greedy")
SHAPES = {"2x2": ((2, 2), NAMES)}
TOL = 1e-4   # against the JAX engine: step scores and confidences, f32


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    return mesh_setup(tmp_path_factory.mktemp("mesh"), NAMES)


@pytest.fixture(scope="module")
def ranks(state):
    """Each rank's results, from one spawn."""
    out = R.spawn(4, str(state["path"] / "ranks"), "mesh_scenarios",
                  str(state["path"] / "params.pt"), SHAPES)
    return [o["2x2"] for o in out]


@pytest.mark.parametrize("name", NAMES)
def test_mesh_serve_equals_single_device(state, ranks, name):
    R.assert_like_single(state["single"][name], ranks, name)


def test_mesh_greedy_matches_jax_engine(state, ranks):
    """The mesh's greedy serve against the JAX single-device engine on the
    same weights: identical tokens and statuses, step scores and
    confidences within 1e-4 (the frameworks' summation orders)."""
    sc = R.SCENARIOS["k1_greedy"]
    ecfg = je.EngineConfig(
        max_batch=R.BATCH, num_blocks=sc.num_blocks, capacity=128,
        max_new_tokens=sc.max_new,
        sampling=JSamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                                 max_new_tokens=sc.max_new),
        decode_horizon=sc.K, use_kernel=False, kv_dtype="f32", faults=None,
        prefix_cache=True)
    eng = je.Engine(state["jp"], state["jcfg"], ecfg, j_make_policy("step"),
                    scorer_params=state["js"])
    res = eng.serve_batch([je.Request(
        request_id=0, prompt_tokens=R.prompt_tokens(0, state["tok"]),
        n_traces=sc.n_traces, policy=j_make_policy("step"))])
    got = ranks[0]["k1_greedy"]["waves"][0][0]
    assert got["num_pruned"] == res[0].num_pruned
    for (toks, scores, confs, status), jt in zip(got["traces"],
                                                 res[0].traces):
        assert toks == jt.output_tokens
        assert status == str(jt.status)
        assert len(scores) == len(jt.step_scores)
        assert max([abs(a - b) for a, b in zip(scores, jt.step_scores)]
                   + [0.0]) <= TOL
        assert max(abs(a - b) for a, b in zip(confs, jt.token_confidences)) \
            <= TOL


def test_mesh_rank_keeps_its_shards_and_checks_agreement(ranks):
    R.assert_shards(ranks, model=2)


@pytest.mark.parametrize("gate,match", [
    ("batch_6", "ValueError: max_batch=6 must be a multiple"),
    ("refuse_ssm", "NotImplementedError: mesh serving covers the dense "
                   "paged-attention archs"),
    ("refuse_hybrid", "NotImplementedError: mesh serving covers the dense "
                      "paged-attention archs"),
    ("refuse_encdec", "NotImplementedError: mesh serving covers the dense "
                      "paged-attention archs"),
    ("refuse_mla", "NotImplementedError: mesh serving's exactness layout "
                   "does not cover MLA/MoE"),
    ("refuse_moe", "NotImplementedError: mesh serving's exactness layout "
                   "does not cover MLA/MoE"),
])
def test_mesh_gates_as_the_jax_engine(ranks, gate, match):
    for out in ranks:
        assert out["_checks"][gate].startswith(match)
