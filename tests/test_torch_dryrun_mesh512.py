"""The production dry run on the 512-rank (pod 2, data 16, model 16) mesh:

  * **Counts pinned.** Two records at two layers (a train_4k and a
    decode_32k) give these per-device counts, field by field.
  * **The layout searches of one product, counted.** A multi-query
    attention's P.V (the weights split along the heads over "model", the
    values along head_dim), left to DTensor, runs as a bmm over the
    batch and heads flattened into one strided split, which sends each
    later op's layout search through DTensor's exhaustive redistribution
    planner: minutes a shape on the 3-D mesh. Under ``SpmdRules`` the
    product runs on the local shards: forward and backward, it asks
    DTensor for no more layout searches and no more redistribution
    plans on the 512-rank mesh than on the 256-rank one.
  * **Microbatches finer than a rank's rows.** deepseek-v2-236b's 16
    microbatches over the 8 rows each rank holds on this mesh give each
    microbatch one row of each rank, as XLA pads them.
"""
import dataclasses
import logging

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Shard  # noqa: E402
from torch.distributed.tensor import _redistribute  # noqa: E402
from torch.distributed.tensor.experimental import (  # noqa: E402
    implicit_replication)

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (fake_process_group,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.shardings import to_placements  # noqa: E402
from repro_torch.launch.spmd import SpmdRules, wrap  # noqa: E402
from repro_torch.launch.steps import _rows  # noqa: E402

COUNTED = ("hlo_flops_per_dev", "hlo_bytes_per_dev", "collective_breakdown",
           "argument_size_in_bytes", "temp_size_in_bytes",
           "output_size_in_bytes", "score_bytes_per_dev")

# per-device counts of two records at two layers
PINNED = {
    ("internvl2-2b", "train_4k"): {
        "hlo_flops_per_dev": 5583457484800.0,
        "hlo_bytes_per_dev": 194717268200.0,
        "collective_breakdown": {"all-gather": 2614501376.0,
                                 "reduce-scatter": 121504768.0,
                                 "all-reduce": 4493348.0,
                                 "all-to-all": 167772160.0},
        "argument_size_in_bytes": 28419072,
        "temp_size_in_bytes": 3917861896,
        "output_size_in_bytes": 19768324,
        "score_bytes_per_dev": 115504720796.0},
    ("qwen3-1.7b", "decode_32k"): {
        "hlo_flops_per_dev": 340262912.0,
        "hlo_bytes_per_dev": 959357220.0,
        "collective_breakdown": {"reduce-scatter": 12288.0,
                                 "all-reduce": 83536.0,
                                 "all-gather": 1680000.0},
        "argument_size_in_bytes": 118625376,
        "temp_size_in_bytes": 68913680,
        "output_size_in_bytes": 67201296,
        "score_bytes_per_dev": 0.0},
}


@pytest.mark.parametrize("arch,shape", list(PINNED))
def test_counts_are_the_pinned_ones(arch, shape, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses.replace(
        get_config(a), num_layers=2))
    rec = dryrun.run_one(arch, shape, True, save=False)
    assert rec["status"] == "ok", rec.get("reason")
    assert rec["mesh"] == "pod2x16x16" and rec["chips"] == 512
    assert {k: rec[k] for k in COUNTED} == PINNED[arch, shape]


class _Misses(logging.Handler):
    """Counts the sharding-cache misses (layout searches) that DTensor's
    dispatcher logs at DEBUG."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.count = 0

    def emit(self, record):
        self.count += "sharding_prop MISS" in record.msg


def _mqa_pv_searches(multi_pod: bool) -> tuple:
    """The searches that granite-20b's P.V (one 512-key chunk of
    train_4k: 48 query heads over one kv head) asks for, forward and
    backward, under the rules, on a production mesh."""
    with fake_process_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        dp = [Shard(0)] * (mesh.ndim - 1)

        def operand(shape, last):
            placements = dp + [last]
            local = list(shape)
            for i, p in enumerate(placements):
                local[p.dim] //= mesh.size(i)
            return wrap(torch.empty(local, device="meta"), mesh, placements,
                        shape).requires_grad_(True)

        p = operand((128, 48, 4096, 512), Shard(1))     # [b, h, q, k]
        v = operand((128, 48, 512, 128), Shard(3))      # [b, h, k, d]
        logger = logging.getLogger("torch.distributed.tensor._dispatch")
        level, misses = logger.level, _Misses()
        logger.addHandler(misses)
        logger.setLevel(logging.DEBUG)
        logger.propagate = False
        _redistribute._gen_transform_infos.cache_clear()
        try:
            with implicit_replication(), SpmdRules():
                out = torch.einsum("bhqk,bhkd->bhqd", p, v)
                grads = torch.autograd.grad(out.sum(), [p, v])
        finally:
            logger.removeHandler(misses)
            logger.setLevel(level)
            logger.propagate = True
        assert out.placements == tuple(dp + [Shard(1)])
        assert [g.placements for g in grads] == [p.placements, v.placements]
    return misses.count, _redistribute._gen_transform_infos.cache_info().misses


def test_mqa_pv_searches_no_more_on_the_512_rank_mesh():
    small = _mqa_pv_searches(False)
    large = _mqa_pv_searches(True)
    assert large[0] <= small[0] and large[1] <= small[1], (small, large)
    assert large[0] <= 4 and large[1] <= 8, large


def test_microbatches_finer_than_a_ranks_rows_take_one_row_each():
    with fake_process_group(512):
        mesh = make_production_mesh(multi_pod=True)
        placements = to_placements(mesh, (("pod", "data"), None))
        tokens = wrap(torch.empty(8, 3, device="meta"), mesh, placements,
                      (256, 3))
        pieces = [_rows(tokens, i, 16) for i in range(16)]
        assert all(p.to_local().shape == (1, 3) for p in pieces)
        assert all(p.shape == (32, 3) for p in pieces)
        # the i-th microbatch holds local row i * 8 // 16
        assert [p.to_local().storage_offset() // 3 for p in pieces] == \
            [i * 8 // 16 for i in range(16)]
        # whole microbatches where the rows suffice: 2 of 4 rows each
        assert [_rows(tokens, i, 4).to_local().shape[0]
                for i in range(4)] == [2] * 4


def test_no_process_group_left_open():
    assert not dist.is_initialized()
