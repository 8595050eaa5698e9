"""The dry run's partitioning rules (``repro_torch.launch.spmd``), one
at a time on a (data 2, model 2) mesh: on a fake group over ``meta``
shards, each rule's result layout, rank 0's flops and the collective
bytes it issues against the per-rank share worked out by hand; and on
four gloo ranks, each rule's values against the plain op on the whole
tensors. f32 throughout: 4 bytes an element."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (Partial, Replicate, Shard,  # noqa: E402
                                      distribute_tensor)
from torch.distributed.tensor.experimental import (  # noqa: E402
    implicit_replication)

import torch_mesh_ranks as R  # noqa: E402
from repro_torch.launch.cost_analysis import op_cost  # noqa: E402
from repro_torch.launch.mesh import (fake_process_group,  # noqa: E402
                                     make_host_mesh)
from repro_torch.launch.spmd import SpmdRules  # noqa: E402
from repro_torch.models.layers import contiguous_kv_update  # noqa: E402

R_, S0, S1, S2, P = Replicate(), Shard(0), Shard(1), Shard(2), Partial()


@pytest.fixture
def mesh():
    with fake_process_group(4):
        yield make_host_mesh(2, 2)
    assert not dist.is_initialized()


def _meta(mesh, shape, *placements, dtype=torch.float32):
    return distribute_tensor(torch.empty(*shape, dtype=dtype, device="meta"),
                             mesh, list(placements))


def _run(fn):
    """(fn's result, rank 0's cost) with the rules on."""
    out = []
    with implicit_replication(), SpmdRules():
        cost = op_cost(lambda: out.append(fn()))
    return out[0], cost


def _check(cost, flops, collectives):
    assert cost["flops"] == flops
    assert cost["collective_breakdown"] == collectives


# x [4, 8, K] split (data, model) on (B, K) as the training residual; the
# local product is [2, 8, 16] @ [16, 16]: 2 * 2 * 8 * 16 * 16 flops
PRODUCT_FLOPS = 2 * 2 * 8 * 16 * 16


def test_column_parallel_product_gathers_the_activation(mesh):
    """w [16, 32] split over "model" on N: x's K is gathered over "model"
    (rank 0's [2, 8, 16]), the weight stays, the output splits N."""
    out, cost = _run(lambda: _meta(mesh, (4, 8, 16), S0, S2)
                     @ _meta(mesh, (16, 32), R_, S1))
    assert out.placements == (S0, S2) and out.shape == (4, 8, 32)
    _check(cost, PRODUCT_FLOPS, {"all-gather": 2 * 8 * 16 * 4})


def test_row_parallel_product_leaves_a_partial_sum(mesh):
    """w [32, 16] split over "model" on K, x split alike: no collective,
    a partial sum over "model" out (reduced where it is next read)."""
    out, cost = _run(lambda: _meta(mesh, (4, 8, 32), S0, S2)
                     @ _meta(mesh, (32, 16), R_, S0))
    assert out.placements == (S0, P)
    _check(cost, PRODUCT_FLOPS, {})


def test_fsdp_product_gathers_the_weight(mesh):
    """w [16, 32] split over "data" on K (FSDP) and "model" on N, x whole
    on K: the weight is gathered over "data" (rank 0's [16, 16])."""
    out, cost = _run(lambda: _meta(mesh, (4, 8, 16), S0, R_)
                     @ _meta(mesh, (16, 32), S0, S1))
    assert out.placements == (S0, S2)
    _check(cost, PRODUCT_FLOPS, {"all-gather": 16 * 16 * 4})


def test_stacked_product_splits_the_activation_as_the_experts(mesh):
    """Experts' weights [2, 16, 32] split over "model" on E: the whole x
    [2, 8, 16] is cut along E on each rank (no collective)."""
    out, cost = _run(lambda: _meta(mesh, (2, 8, 16), R_, R_)
                     @ _meta(mesh, (2, 16, 32), R_, S0))
    assert out.placements == (R_, S0)
    _check(cost, 2 * 1 * 8 * 16 * 32, {})


def test_einsum_over_split_batch_dims_runs_locally(mesh):
    """Attention's scores over q, k [4, 4, 8, 16] split on (batch, heads):
    rank 0 computes its [2, 2] of the [4, 4] (batch, head) pairs."""
    out, cost = _run(lambda: torch.einsum(
        "bhqd,bhkd->bhqk", _meta(mesh, (4, 4, 8, 16), S0, S1),
        _meta(mesh, (4, 4, 8, 16), S0, S1)))
    assert out.placements == (S0, S1) and out.shape == (4, 4, 8, 8)
    _check(cost, 2 * 4 * 8 * 8 * 16, {})


def test_einsum_with_other_split_letters_follows_the_larger(mesh):
    """A multi-query P.V: the weights [4, 4, 16, 8] split on (batch,
    heads), the values [4, 4, 8, 4] on (batch, head_dim). The larger
    operand keeps its split: the values move to the heads over "model"
    (an all-to-all of rank 0's [2, 4, 8, 2]), and rank 0 computes its
    [2, 2] (batch, head) pairs. No strided split arises, so DTensor's
    exhaustive redistribution planner is never asked."""
    out, cost = _run(lambda: torch.einsum(
        "bhqk,bhkd->bhqd", _meta(mesh, (4, 4, 16, 8), S0, S1),
        _meta(mesh, (4, 4, 8, 4), S0, Shard(3))))
    assert out.placements == (S0, S1) and out.shape == (4, 4, 16, 4)
    _check(cost, 2 * 2 * 2 * 16 * 8 * 4, {"all-to-all": 2 * 4 * 8 * 2 * 4})


@pytest.mark.parametrize("table_pl, gathered", [
    ((R_, S0), 0),                  # vocab rows over "model"
    ((S1, S0), 16 * 16 * 4),        # and D over "data" (FSDP): gathered
])
def test_lookup_of_split_rows_is_a_masked_partial_sum(mesh, table_pl,
                                                      gathered):
    """``table[tokens]`` with the rows split over "model": each rank looks
    up its own rows, a partial sum over "model" out."""
    out, cost = _run(lambda: _meta(mesh, (32, 16), *table_pl)[
        _meta(mesh, (4, 8), S0, R_, dtype=torch.int64)])
    assert out.placements == (S0, P) and out.shape == (4, 8, 16)
    _check(cost, 0, {"all-gather": gathered} if gathered else {})


def test_gather_along_a_split_dim_is_a_masked_partial_sum(mesh):
    out, cost = _run(lambda: torch.gather(
        _meta(mesh, (4, 32), S0, S1), 1,
        _meta(mesh, (4, 1), S0, R_, dtype=torch.int64)))
    assert out.placements == (S0, P) and out.shape == (4, 1)
    _check(cost, 0, {})


def test_logsumexp_along_a_split_dim_reduces_two_scalars_a_row(mesh):
    """Rank 0's [2, 16] of [4, 32]: the all-reduces of its [2, 1] maxima
    and of its [2, 1] sums, not a gather of the rows."""
    out, cost = _run(lambda: torch.logsumexp(_meta(mesh, (4, 32), S0, S1),
                                             -1))
    assert out.placements == (S0, R_) and out.shape == (4,)
    _check(cost, 0, {"all-reduce": 2 * (2 * 1 * 4)})


def test_argmax_along_a_split_dim_gathers_each_ranks_pair(mesh):
    """Rank 0's [2, 16] of [4, 32]: each row's (max, index) pair gathered
    over the 2 ranks of "model": [2, 2] f32 and [2, 2] int64."""
    out, cost = _run(lambda: torch.argmax(_meta(mesh, (4, 32), S0, S1), -1))
    assert out.placements == (S0, R_) and out.shape == (4,)
    _check(cost, 0, {"all-gather": 2 * 2 * 4 + 2 * 2 * 8})


@pytest.mark.parametrize("shape, want_pl, gathered", [
    ((4, 8, 4, 16), (S0, S2), 0),             # 4 heads over 2 ranks
    ((4, 8, 3, 16), (S0, R_), 2 * 8 * 48 * 4),  # 3 heads: gathered
])
def test_reshape_keeps_a_split_lead_or_gathers(mesh, shape, want_pl,
                                               gathered):
    d = shape[-2] * shape[-1]
    out, cost = _run(lambda: _meta(mesh, (4, 8, d), S0, S2).reshape(shape))
    assert out.placements == want_pl and out.shape == shape
    _check(cost, 0, {"all-gather": gathered} if gathered else {})


@pytest.mark.parametrize("scale_pl, want_pl, gathered", [
    ((R_, R_), (S0, S2), 0),      # cut as the activation's D
    ((R_, S0), (S0, R_), 16 * 4),   # activation whole on D: gathered
])
def test_small_operand_follows_the_activation(mesh, scale_pl, want_pl,
                                              gathered):
    x_pl = (S0, S2) if want_pl == (S0, S2) else (S0, R_)
    out, cost = _run(lambda: _meta(mesh, (4, 8, 16), *x_pl)
                     * _meta(mesh, (16,), *scale_pl))
    assert out.placements == want_pl
    _check(cost, 0, {"all-gather": gathered} if gathered else {})


def test_indexed_write_gathers_the_entries(mesh):
    """A decode write into a ring [4, 8, 2, 16] split on (rows, slots):
    the new rows [4, 2, 16] and the slots [4] are gathered whole over
    "data" (rank 0 holds [2, 2, 16] and [2]); the cache keeps its
    layout."""
    cache = _meta(mesh, (4, 8, 2, 16), S0, S1)
    out, cost = _run(lambda: contiguous_kv_update(
        cache, _meta(mesh, (4,), S0, R_, dtype=torch.int64),
        _meta(mesh, (4, 2, 16), S0, R_)))
    assert out is cache and out.placements == (S0, S1)
    _check(cost, 0, {"all-gather": 4 * 2 * 16 * 4 + 4 * 8})


# the results of :func:`torch_mesh_ranks.spmd_rule_values`' cases
LAYOUTS = {
    "product_column_parallel": (S0, S2),
    "product_row_parallel": (S0, P),
    "product_fsdp": (S0, S2),
    "product_experts": (R_, S0),
    "einsum_batch_heads": (S0, S1),
    "einsum_split_letters": (S0, S1),
    "lookup_vocab_rows": (S0, P),
    "lookup_fsdp": (S0, P),
    "gather_vocab": (S0, P),
    "logsumexp_vocab": (S0, R_),
    "argmax_vocab": (S0, R_),
    "argmax_batch_of_one": (R_, R_),
    "reshape_heads": (S0, S2),
    "reshape_gathered": (S0, R_),
    "scale_follows_activation": (S0, S2),
    "scale_gathered": (S0, R_),
    "write_rows_and_slots": (S0, S1),
    "write_slots_and_heads": (S1, S2),
    "write_slots_twice": (S1, S1),
}


def test_rules_give_the_plain_ops_values_on_four_ranks(tmp_path):
    """Every rank's result of every rule, gathered whole, equals the plain
    op on the whole tensors: exactly, or for the row-parallel product
    within f32 rounding (its two partial sums are added in another
    order); each result has the rule's layout."""
    ranks = R.spawn(4, str(tmp_path), "spmd_rule_values")
    for out in ranks:
        assert out.keys() == LAYOUTS.keys()
        for name, (got, want, placements) in out.items():
            assert placements == str(LAYOUTS[name]), name
            if name == "product_row_parallel":
                torch.testing.assert_close(got, want)
            else:
                assert torch.equal(got, want), name


def test_no_process_group_left_open():
    assert not dist.is_initialized()
