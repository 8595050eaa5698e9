"""The port's mesh engine on the CPU over the pure axes: four gloo ranks
as a (4, 1) mesh (data parallel: one decode lane pair each) and as a
(1, 4) mesh (tensor parallel: 4 query heads over 2 kv heads do not
divide 4 ranks, so the projections are gathered whole, attention runs on
every head of each rank, and the pool is whole on every rank), one
spawn for both, f32 params bridged from the JAX package's init.

The horizon of 4, chunked prefill, the tight pool (STEP prunes, SC
preempts), the int8 pool, the kernel route (at (4, 1)) and an online run
give on every rank exactly the single-device engine's tokens, step
scores, confidences, statuses, prunes and preemptions
(``tests/test_torch_sharded_engine.py`` has the (2, 2) mesh and why
this holds). At (1, 4) ``use_kernel=True`` is refused and "auto" serves
dense, as in the JAX engine.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_mesh_ranks as R  # noqa: E402
from torch_parity import mesh_setup  # noqa: E402

AXES = ("k4_sampled", "chunk8_k4_greedy", "tight_step", "tight_sc", "int8",
        "online")
SHAPES = {"4x1": ((4, 1), AXES + ("kernel",)), "1x4": ((1, 4), AXES)}
CASES = [(key, name) for key, (_, names) in SHAPES.items() for name in names]


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    return mesh_setup(tmp_path_factory.mktemp("mesh"), AXES + ("kernel",))


@pytest.fixture(scope="module")
def runs(state):
    """shape key -> each rank's results, from one spawn."""
    out = R.spawn(4, str(state["path"] / "ranks"), "mesh_scenarios",
                  str(state["path"] / "params.pt"), SHAPES)
    return {key: [o[key] for o in out] for key in SHAPES}


@pytest.mark.parametrize("key,name", CASES,
                         ids=[f"{k}-{n}" for k, n in CASES])
def test_mesh_serve_equals_single_device(state, runs, key, name):
    R.assert_like_single(state["single"][name], runs[key], name)


@pytest.mark.parametrize("key", list(SHAPES))
def test_mesh_rank_keeps_its_shards_and_checks_agreement(runs, key):
    R.assert_shards(runs[key], model=SHAPES[key][0][1])


def test_mesh_kernel_route_needs_aligned_heads(runs):
    """(1, 4): ``use_kernel=True`` raises at construction, "auto" serves
    dense."""
    for out in runs["1x4"]:
        c = out["_checks"]
        assert c["kernel_true"].startswith("NotImplementedError: "
                                           "use_kernel=True: kernel-on-mesh")
        assert c["kernel_auto"] is False
