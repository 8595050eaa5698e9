"""Calibrate the port's op counter (``repro_torch.launch.cost_analysis``)
against programs of known cost, as ``tests/test_hlo_analysis.py`` does
the JAX package's HLO walker: a product's flops, a loop counted trip by
trip, a batched dot, an elementwise op's bytes, the roofline terms at
the H100's peaks (and the reference's arithmetic at the reference's
constants), a collective's bytes, one device's share of a product
split over a mesh, and a whole forward against 2*N*T."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial,  # noqa: E402
                                      Replicate, Shard)

from repro.launch import hlo_analysis as j_hlo  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import cost_analysis as ca  # noqa: E402
from repro_torch.launch.mesh import (fake_process_group,  # noqa: E402
                                     make_host_mesh)
from repro_torch.models.init import (count_params, init_params,  # noqa: E402
                                     padded_vocab)
from repro_torch.models.model import forward_full  # noqa: E402


def test_single_matmul_flops():
    x, w = torch.zeros(128, 256), torch.zeros(256, 512)
    cost = ca.op_cost(lambda a, b: a @ b, x, w)
    assert cost["flops"] == 2 * 128 * 256 * 512
    assert cost["collective_bytes"] == 0.0


def test_loop_counts_each_trip():
    """What the reference weights by trip count, a Python loop runs: a
    10-trip loop of a 128^3 product counts 10 products."""
    def f(x, w):
        for _ in range(10):
            x = x @ w
        return x
    cost = ca.op_cost(f, torch.zeros(128, 128), torch.zeros(128, 128))
    assert cost["flops"] == 10 * 2 * 128 ** 3


def test_batched_dot_flops():
    a, b = torch.zeros(4, 32, 64), torch.zeros(4, 64, 16)
    cost = ca.op_cost(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b), a, b)
    assert cost["flops"] == 2 * 4 * 32 * 64 * 16


def test_elementwise_bytes_read_and_write():
    x = torch.zeros(1024, 1024)
    cost = ca.op_cost(lambda a: a * 2.0 + 1.0, x)
    assert cost["bytes"] >= 2 * x.numel() * 4
    assert cost["flops"] == 0.0


def test_views_move_nothing_and_live_bytes_peak():
    x = torch.zeros(64, 64)
    cost = ca.op_cost(lambda a: a.view(4096).t().reshape(64, 64), x)
    assert cost["bytes"] == 0.0 and cost["peak_live_bytes"] == 0
    cost = ca.op_cost(lambda a: (a + 1.0) + 1.0, x)
    # two results of 16 KiB, the first freed after the second is made
    assert cost["peak_live_bytes"] == 2 * 64 * 64 * 4


def test_score_bytes_are_those_of_score_shaped_ops():
    q, k = torch.zeros(2, 64, 16), torch.zeros(2, 32, 16)
    cost = ca.op_cost(lambda q, k: torch.softmax(q @ k.transpose(1, 2), -1),
                      q, k, score_seq_len=64)
    assert 0 < cost["score_bytes"] <= cost["bytes"]
    # [..., S, c] with c <= S is score shaped; [..., 16, 64] is not
    assert ca.op_cost(lambda x: x * 2.0, torch.zeros(2, 16, 64),
                      score_seq_len=64)["score_bytes"] == 0.0


def test_roofline_terms_dominance_at_h100_peaks():
    t = ca.roofline_terms(flops=989e12, hbm_bytes=0, coll_bytes=0, chips=1)
    assert t["dominant"] == "compute" and abs(t["t_compute_s"] - 1) < 1e-12
    t = ca.roofline_terms(flops=0, hbm_bytes=3.35e12, coll_bytes=1, chips=1)
    assert t["dominant"] == "memory" and abs(t["t_memory_s"] - 1) < 1e-12
    t = ca.roofline_terms(flops=0, hbm_bytes=0, coll_bytes=50e9, chips=1)
    assert t["dominant"] == "collective"
    assert abs(t["t_collective_s"] - 1) < 1e-12


@pytest.mark.parametrize("args", [
    (197e12, 0.0, 0.0, 1), (0.0, 819e9, 1.0, 1), (0.0, 0.0, 50e9, 1),
    (3e15, 2e12, 7e10, 4), (1.0, 1.0, 1.0, 256),
])
def test_roofline_arithmetic_is_the_references(monkeypatch, args):
    """At the reference's constants the port's terms are the
    reference's, float for float; only the peaks differ."""
    monkeypatch.setattr(ca, "PEAK_FLOPS", j_hlo.PEAK_FLOPS)
    monkeypatch.setattr(ca, "HBM_BW", j_hlo.HBM_BW)
    monkeypatch.setattr(ca, "LINK_BW", j_hlo.ICI_BW)
    assert ca.roofline_terms(*args) == j_hlo.roofline_terms(*args)


# ---------------------------------------------------------------------------
# over DTensors on a fake (2, 2) group: one device's share
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh():
    with fake_process_group(4):
        yield make_host_mesh(2, 2)
    assert not dist.is_initialized()


def _dt(mesh, local_shape, placements):
    return DTensor.from_local(torch.empty(local_shape, device="meta"), mesh,
                              placements, run_check=False)


def test_all_reduce_detected_with_its_bytes(mesh):
    """A partial sum reduced over "model" is one all-reduce of its
    result bytes (rank 0's [4, 8] f32 shard)."""
    x = _dt(mesh, (4, 8), [Shard(0), Partial()])
    cost = ca.op_cost(lambda t: t.redistribute(mesh,
                                               [Shard(0), Replicate()]), x)
    assert cost["collective_breakdown"] == {"all-reduce": 4 * 8 * 4}
    assert cost["collective_bytes"] == 4 * 8 * 4


def test_all_gather_detected_with_its_bytes(mesh):
    x = _dt(mesh, (4, 8), [Shard(0), Shard(1)])
    cost = ca.op_cost(lambda t: t.redistribute(mesh,
                                               [Shard(0), Replicate()]), x)
    assert cost["collective_breakdown"] == {"all-gather": 4 * 16 * 4}


def test_all_to_all_fallback_is_counted_as_all_to_all(mesh):
    """On a cpu mesh DTensor moves a split from one dim to another with
    an all-gather and a chunk; the counter counts the all-to-all it
    stands for, at the input's bytes, and says so."""
    x = _dt(mesh, (4, 8), [Replicate(), Shard(0)])
    cost = ca.op_cost(lambda t: t.redistribute(mesh,
                                               [Replicate(), Shard(1)]), x)
    assert cost["collective_breakdown"] == {"all-to-all": 4 * 8 * 4}
    assert cost["all_to_all_from_all_gather"] == 1


def test_product_split_over_both_mesh_dims_counts_a_quarter(mesh):
    """[64, 32] @ [32, 48] with the rows over "data" and the columns over
    "model": each device does a quarter of the global 2*M*K*N."""
    x = _dt(mesh, (32, 32), [Shard(0), Replicate()])
    w = _dt(mesh, (32, 24), [Replicate(), Shard(1)])
    cost = ca.op_cost(lambda a, b: a @ b, x, w)
    assert cost["flops"] == 2 * 64 * 32 * 48 / 4
    assert cost["collective_bytes"] == 0.0


def test_replicated_product_counts_all_of_it(mesh):
    x = _dt(mesh, (64, 32), [Replicate(), Replicate()])
    w = _dt(mesh, (32, 48), [Replicate(), Replicate()])
    assert ca.op_cost(lambda a, b: a @ b, x, w)["flops"] \
        == 2 * 64 * 32 * 48


def test_model_forward_flops_sane():
    """A whole forward of the smoke qwen3-1.7b: the counted flops within
    0.5-3x of 2*N*T, as the reference's check."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((2, 64), dtype=torch.int32)
    cost = ca.op_cost(lambda p, t: forward_full(p, cfg, t)["logits"],
                      params, toks)
    n = count_params(params) - padded_vocab(cfg) * cfg.d_model
    analytic = 2 * n * 2 * 64
    assert 0.5 < cost["flops"] / analytic < 3.0, (cost["flops"], analytic)


def test_no_process_group_left_open():
    assert not dist.is_initialized()
