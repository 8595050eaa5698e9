"""The port's dry run against the JAX package's on the same arch, shape
and mesh: qwen3-1.7b's decode_32k and prefill_32k over the 256-rank
(data 16, model 16) mesh (train_4k: ``test_torch_dryrun_parity_train``).
The reference runs in a subprocess (``torch_parity.dryrun_records``).

What is held, and why:

  * **flops per device**: both count 2 * M * N * K of each product on
    one device's shapes, so they agree exactly (relative 1e-12: the
    sums run in another order).
  * **arguments' bytes per device**: the same specs over the same
    shapes: equal.
  * **collectives**: the two partitioners pick different collectives
    for the same layouts (the port's DTensor reduce-scatters where XLA
    all-reduces; XLA also permutes and re-tiles), so their kinds are
    held as far as they must agree: both gather and both reduce
    (``torch_parity.assert_collectives_like``). Their bytes are held to
    a band. XLA's CPU program runs these collectives in f32 (twice the
    port's bf16 bytes) and replicates tensors it cannot re-tile (its
    "involuntary full rematerialization"), so the port moves no more
    than the reference: a count above it is a layout the partitioner
    does not make. The floor, an eighth, sits below the ratios that
    qwen3-1.7b's records give (0.24 to 0.43).
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from torch_parity import assert_collectives_like, dryrun_records  # noqa: E402

SHAPES = ("decode_32k", "prefill_32k")


@pytest.fixture(scope="module")
def records():
    return dryrun_records("qwen3-1.7b", SHAPES)


@pytest.mark.parametrize("shape", SHAPES)
def test_flops_per_device_are_the_references(records, shape):
    ref, got = (recs[shape] for recs in records)
    assert math.isclose(got["hlo_flops_per_dev"], ref["hlo_flops_per_dev"],
                        rel_tol=1e-12)
    for key in ("model_flops_global", "chips"):
        assert got[key] == ref[key]


@pytest.mark.parametrize("shape", SHAPES)
def test_argument_bytes_are_the_references(records, shape):
    ref, got = (recs[shape] for recs in records)
    assert got["argument_size_in_bytes"] == ref["argument_size_in_bytes"]


@pytest.mark.parametrize("shape", SHAPES)
def test_collectives_gather_and_reduce_as_the_references(records, shape):
    assert_collectives_like(*(recs[shape] for recs in records))


def test_no_process_group_left_open():
    assert not dist.is_initialized()
