"""The port's train_4k dry run against the JAX package's: qwen3-1.7b
over the 256-rank (data 16, model 16) mesh, held as in
``test_torch_dryrun_parity``, with two differences accounted for:

  * **flops**: the reference's attention scan recomputes the scores in
    its backward pass, which the port's autograd saves from the remat
    forward instead. The reference counts one more pass of q @ k^T,
    2 * (B / 16) * (H / 16) * S * S * hd a layer, and nothing else
    differs.
  * **arguments' bytes**: the reference's AdamW step count is an int32
    scalar on the device; the port keeps it as a Python int.
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from torch_parity import assert_collectives_like, dryrun_records  # noqa: E402

ARCH = "qwen3-1.7b"


@pytest.fixture(scope="module")
def records():
    ref, got = dryrun_records(ARCH, ("train_4k",))
    return ref["train_4k"], got["train_4k"]


def test_flops_per_device_are_the_references_but_one_score_pass(records):
    ref, got = records
    cfg, shape = get_config(ARCH), SHAPES["train_4k"]
    score_pass = (2 * (shape.global_batch // 16) * (cfg.num_heads // 16)
                  * shape.seq_len ** 2 * cfg.head_dim * cfg.num_layers)
    assert math.isclose(got["hlo_flops_per_dev"] + score_pass,
                        ref["hlo_flops_per_dev"], rel_tol=1e-12)
    for key in ("model_flops_global", "chips"):
        assert got[key] == ref[key]


def test_argument_bytes_are_the_references_but_the_step_count(records):
    ref, got = records
    assert got["argument_size_in_bytes"] + 4 == ref["argument_size_in_bytes"]


def test_collectives_gather_and_reduce_as_the_references(records):
    assert_collectives_like(*records)


def test_no_process_group_left_open():
    assert not dist.is_initialized()
