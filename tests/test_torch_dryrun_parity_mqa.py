"""The port's dry run against the JAX package's for a multi-query arch:
granite-20b (48 query heads over one kv head) cut to two layers in both
packages, train_4k and prefill_32k over the 256-rank (data 16, model 16)
mesh, held as in ``test_torch_dryrun_parity`` (train_4k: but one score
pass, as in ``test_torch_dryrun_parity_train``).

Its attention's P.V has the weights split along the heads over "model"
and the values along head_dim; ``launch.spmd.local_einsum`` moves the
values to the heads (14 GB of collectives a device at these two layers
in train_4k, 4.6 GB in prefill_32k, against the reference's 77 GB and
16 GB). Left to DTensor, every chunk's weights would be gathered whole
over "model" instead (255 GB and 842 GB), outside the band that
``torch_parity.assert_collectives_like`` holds.
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from torch_parity import assert_collectives_like, dryrun_records  # noqa: E402

ARCH, LAYERS = "granite-20b", 2
CUT = ("train_4k", "prefill_32k")


@pytest.fixture(scope="module")
def records():
    return dryrun_records(ARCH, CUT, layers=LAYERS)


@pytest.mark.parametrize("shape", CUT)
def test_flops_per_device_are_the_references(records, shape):
    ref, got = (recs[shape] for recs in records)
    flops = got["hlo_flops_per_dev"]
    if shape == "train_4k":     # the reference's recomputed q @ k^T
        cfg, spec = get_config(ARCH), SHAPES[shape]
        flops += (2 * (spec.global_batch // 16) * (cfg.num_heads // 16)
                  * spec.seq_len ** 2 * cfg.head_dim * LAYERS)
    assert math.isclose(flops, ref["hlo_flops_per_dev"], rel_tol=1e-12)


@pytest.mark.parametrize("shape", CUT)
def test_argument_bytes_are_the_references(records, shape):
    ref, got = (recs[shape] for recs in records)
    step_count = 4 if shape == "train_4k" else 0
    assert got["argument_size_in_bytes"] + step_count \
        == ref["argument_size_in_bytes"]


@pytest.mark.parametrize("shape", CUT)
def test_collectives_gather_and_reduce_as_the_references(records, shape):
    assert_collectives_like(*(recs[shape] for recs in records))


def test_no_process_group_left_open():
    assert not dist.is_initialized()
