"""The yardstick's counts against hand counts at the cells' shapes."""
import pytest

from portbench import bounds, manifest as M

MAN = M.Manifest()
QWEN = MAN.config("qwen3-4b-thinking")
MIXTRAL = MAN.config("mixtral-8x7b")
k1a = MAN.reader("k1a_roofline")
k2 = MAN.reader("k2_roofline")
mfu = MAN.reader("mfu")


def test_matmul_params_qwen3():
    # per layer: q 2560x4096, k and v 2560x1024, o 4096x2560, three
    # 2560x9728 SwiGLU matrices; then the tied head 2560 x 151936
    layer = 2560 * 4096 + 2 * 2560 * 1024 + 4096 * 2560 + 3 * 2560 * 9728
    assert bounds.matmul_params_per_token(QWEN) == 36 * layer + 2560 * 151936


def test_matmul_params_mixtral_counts_two_experts():
    layer = (4096 * 4096 + 2 * 4096 * 1024 + 4096 * 4096
             + 4096 * 8 + 2 * 3 * 4096 * 14336)
    assert bounds.matmul_params_per_token(MIXTRAL) == \
        16 * layer + 4096 * 32000


def test_model_flops_adds_attention():
    base = 2.0 * bounds.matmul_params_per_token(QWEN) * 10
    # 36 layers x 32 heads x 128 x 4 per attended slot
    assert bounds.model_flops(QWEN, 10, 1000) == base + 36 * 32 * 128 * 4 * 1000


def test_k1a_bytes_qwen3():
    # one lane-iteration over 300 slots: q and out (32 x 128 bf16 each),
    # K and V of 300 slots x 8 kv heads x 128 (bf16), 36 layers
    want = 36 * 2 * (2 * 32 * 128 + 2 * 8 * 128 * 300)
    assert k1a.decode_attention_bytes(QWEN, 1, 300) == want


def test_k2_bound_at_64_lanes():
    nbytes = 4 * (2560 * 512 + 2 * 512 + 1 + 64) + 2 * 64 * 2560
    assert k2.bound_s(64, 2560) == pytest.approx(nbytes / 3.35e12)


def test_shares_read_from_records():
    prof = {"ops": [("void (anonymous namespace)::decode_cluster_kernel<128>",
                     2e-3), ("(anonymous namespace)::merge_kernel", 1e-3),
                    ("nvjet_tst_96x64", 5e-3), ("score_kernel", 1e-5),
                    ("finish_kernel", 1e-5)],
            "window_s": 0.1, "busy_s": 0.09, "host_s": (0.0, 0.1)}
    ticks = [{"profiled": True, "traced": True, "horizon": 4, "live": 64,
              "ctx": 64 * 300, "kv_slots": 64 * 300, "t0": 0, "t1": 0.05,
              "d0": 0, "d1": 50}]
    rec = {"profile": prof, "ticks": ticks, "prefills": [], "cfg": QWEN,
           "mix": MAN.traffic("step-n64"), "problems": [], "origin_s": 0.0}
    want = k1a.decode_attention_bytes(QWEN, 64, 64 * 300) / 3.35e12 / 3e-3
    assert k1a.read(rec) == pytest.approx(100 * want)
    assert k2.read(rec) == pytest.approx(100 * 4 * k2.bound_s(64, 2560) / 2e-5)
    assert MAN.reader("products_ms_per_iter").read(rec) == \
        pytest.approx(5e-3 / 4 * 1e3)


def test_mfu_and_idle_before_the_stretch():
    ticks = [{"profiled": False, "traced": False, "horizon": 4, "live": 256,
              "ctx": 256 * 100, "t0": 0.0, "t1": 0.01, "d0": 0.0, "d1": 8.0},
             {"profiled": False, "traced": False, "horizon": 4, "live": 256,
              "ctx": 256 * 104, "t0": 0.01, "t1": 0.02, "d0": 10.0,
              "d1": 18.0}]
    rec = {"ticks": ticks, "prefills": [], "cfg": QWEN, "profile": None,
           "problems": [], "origin_s": 0.0}
    flops = bounds.model_flops(QWEN, 512, 256 * 204)
    assert mfu.read(rec) == pytest.approx(100 * flops / (18e-3 * 989e12))
    idle = MAN.reader("device_idle_share").read(rec)
    assert idle == pytest.approx(100 * (1 - 16 / 18))


def test_readers_return_nothing_without_records():
    rec = {"ticks": [], "prefills": [], "cfg": QWEN, "profile": None,
           "problems": [], "origin_s": 0.0, "window_s": 1.0,
           "mix": MAN.traffic("step-n64")}
    for name in ("k1a_roofline", "k2_roofline", "mfu", "device_idle_share",
                 "products_ms_per_iter", "ttft_p90_s", "pruned_share"):
        assert MAN.reader(name).read(rec) is None, name


def test_distinct_slots_count_a_shared_prefix_once():
    import numpy as np

    from portbench.drive import distinct_slots
    # two lanes share blocks 1 and 2 (32 slots) and own blocks 3 and 4;
    # lane 0 writes at 40, lane 1 at 35; both live one iteration, then
    # lane 1 is frozen
    tables = np.array([[1, 2, 3, 0], [1, 2, 4, 0]])
    pos = np.array([40, 35])
    valid = np.array([[True, True], [True, False]])
    first = 32 + (41 - 32) + (36 - 32)
    second = 32 + (42 - 32)
    assert distinct_slots(tables, pos, valid, 16) == first + second
