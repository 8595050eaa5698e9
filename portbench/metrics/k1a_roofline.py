"""k1a_roofline (%): the decode attention's byte bound over the device
time of every kernel that implements it in the profiled stretch: the
cluster decode face (``csrc/paged_decode.cu``), ``decode_kernel`` and
its split-K ``merge_kernel`` (``csrc/paged_attention.cu``).

The bytes are counted from the live lanes' lengths, each byte once per
call: per layer and live lane-iteration, the query and the output
(heads x head dim, bf16); per layer and iteration, the K and V (kv heads
x head dim, bf16) of every pool slot some live lane attends over, a
block that lanes share (a prefix) once. A frozen lane, which the batch
still carries, adds time and no bytes. Layer: kernels (``kernels/
paged_attention.py``)."""
import re

from portbench.bounds import BF16, HBM_BYTES_PER_S, kernel_seconds

PATTERN = re.compile(r"decode_cluster_kernel|(?<![A-Za-z_])decode_kernel"
                     r"|(?<![A-Za-z_])merge_kernel")


def decode_attention_bytes(cfg: dict, lane_iters: int, slots: int) -> float:
    L, H, KVH, hd = (cfg["num_layers"], cfg["num_heads"],
                     cfg["num_kv_heads"], cfg["head_dim"])
    return L * BF16 * (2 * H * hd * lane_iters + 2 * KVH * hd * slots)


def read(rec: dict):
    prof = rec.get("profile")
    if not prof:
        return None
    ticks = [t for t in rec["ticks"] if t["profiled"]]
    t = kernel_seconds(prof, PATTERN)
    if not ticks or t <= 0:
        return None
    nbytes = decode_attention_bytes(rec["cfg"], sum(x["live"] for x in ticks),
                                    sum(x["kv_slots"] for x in ticks))
    return 100.0 * nbytes / HBM_BYTES_PER_S / t
