"""The step scorer's kernel K2 on Hopper, on the CPU: its
launch plan ``score_plan`` (cluster per hidden tile of 32 units, the
CTAs' W1 rows, lane tiles, shared memory, from shapes and the SM count
alone), the rows each warp sums (``score_blocks``), the phases of the
warps' TMA barriers over passes and lane tiles, and
``step_score_face_plain``, the kernel's sum order in PyTorch (per-warp
partials over the plan's row blocks, bf16 hidden states times W1 in
three bf16 pieces or f32 ones in 3xTF32, warps then cluster ranks
merged in order, per-tile logits summed in tile order), held to
``step_score_plain``, ``ref.step_score_ref`` and the JAX package's Pallas
``step_score`` in interpret mode, as
tests/test_torch_kernels.py::test_step_score_plain_vs_oracle_and_pallas
runs it. The kernel itself runs on the card (tests/test_torch_cuda.py).

Tolerance: 1e-6 absolute on the scores. The emulation and the oracles
differ only in the order of f32 sums, in 3xTF32's dropped small-by-small
term (~2^-22 of a product) and in the last bit the three bf16 pieces of
W1 keep (~2^-24), on scores in (0, 1).
"""
import itertools

import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.step_score import step_score as j_step_score  # noqa: E402
from repro_torch.kernels import step_score as ss  # noqa: E402
from torch_parity import to_np  # noqa: E402

SCORES = dict(rtol=0.0, atol=1e-6)
# (B, D, Hd) the main paths run: the serve phases' 16 lanes at qwen3's,
# mamba2's and zamba2's D 2560 and mixtral's 4096, the serving launcher's
# D 256, the dense archs' 8 lanes at 2048, 3072 and 6144, the kernels
# phase's 64 lanes, mixtral's batched phase's 4; hidden 512 throughout
ZOO = [(16, 2560, 512), (16, 4096, 512), (16, 256, 512), (8, 2048, 512),
       (8, 3072, 512), (8, 6144, 512), (64, 2560, 512), (4, 4096, 512)]
EDGES = list(itertools.product((1, 13, 16, 64, 130),
                               (1, 256, 1000, 2048, 2560, 3072, 4096, 6144),
                               (32, 512, 1024)))


@pytest.mark.parametrize("B,D,Hd", ZOO + EDGES)
def test_plan_fits_and_covers_every_row_and_unit(B, D, Hd):
    plan = ss.score_plan(B, D, Hd)
    assert plan["smem"] == ss.score_smem(plan["rows"], plan["lane_tile"],
                                         plan["cluster"])
    assert ss.score_smem(plan["rows"], plan["lane_tile"], plan["cluster"],
                         2) <= plan["smem"]
    assert ss.ONE_PER_SM <= plan["smem"] <= ss.MAX_SMEM == 232448
    assert 1 <= plan["cluster"] <= ss.MAX_CLUSTER <= 16
    assert plan["tiles"] * ss.HIDDEN_TILE == Hd     # each unit in one tile
    assert plan["ctas"] == plan["cluster"] * plan["tiles"]
    # one wave, one CTA per SM; no larger cluster would do both
    assert plan["cluster"] == 1 or \
        ss.H100_FITS[plan["cluster"] - 1] >= plan["tiles"]
    assert all(ss.H100_FITS[S - 1] < plan["tiles"]
               or S * ss.WARPS * ss.K_STEP > D
               for S in range(plan["cluster"] + 1, ss.MAX_CLUSTER + 1))
    assert 1 <= plan["rows"] <= ss.MAX_ROWS         # one TMA box per warp
    assert plan["rows"] <= ss.K_STEP or plan["rows"] % ss.K_STEP == 0
    assert plan["lane_tile"] in ss.LANE_TILES
    assert plan["lane_tiles"] * plan["lane_tile"] >= B
    assert (plan["lane_tiles"] - 1) * plan["lane_tile"] < B
    # every W1 row below D summed by exactly one warp of each cluster
    covered = []
    for rank, p, w, r0, n in ss.score_blocks(plan, D):
        assert 0 <= rank < plan["cluster"] and 0 <= p < plan["passes"]
        assert 0 <= w < ss.WARPS and 1 <= n <= plan["rows"]
        covered.extend(range(r0, r0 + n))
    assert sorted(covered) == list(range(D))
    assert plan["cluster"] * plan["rows_per_cta"] >= D


def test_plan_at_the_serve_shape():
    """16 hidden tiles: clusters of 6, the largest of which an H100 runs 16
    at once on distinct SMs (clusters of 7 or 8: 15), 96 CTAs of 448 rows;
    the serving launcher's D 256 keeps 8 rows a warp in clusters of 4."""
    plan = ss.score_plan(16, 2560, 512)
    assert (plan["cluster"], plan["tiles"], plan["ctas"], plan["rows"],
            plan["passes"], plan["lane_tiles"]) == (6, 16, 96, 56, 1, 1)
    assert ss.score_plan(16, 256, 512)["cluster"] == 4
    # a card of 64 SMs in GPCs of 8 runs 16 clusters of 4 at once
    fits = tuple(64 // S * (S <= 8) for S in range(1, 9))
    assert ss.score_plan(16, 2560, 512, fits)["ctas"] == 64


@pytest.mark.parametrize("h_bytes", [2, 4])
@pytest.mark.parametrize("rows", [1, 4, 8, 32, 40, 64, 96, 136, 256])
def test_h_rows_take_no_bank_conflict(rows, h_bytes):
    """A warp's h rows: a lane stride of 4 mod 8 words, so that the A
    fragments' loads (lane g, word t) fall on 32 distinct banks; whole
    product steps (16 rows of bf16, 8 of f32) and at least the hidden
    tile, for the partials over it. bf16 rows never take more room."""
    words = ss.h_words(rows, h_bytes)
    step = 16 if h_bytes == 2 else 8
    assert words % 8 == 4 and words >= ss.HIDDEN_TILE
    assert words * 4 >= -(-rows // step) * step * h_bytes
    banks = {(g * words + t) % 32 for g in range(8) for t in range(4)}
    assert len(banks) == 32
    assert ss.h_words(rows, 2) <= ss.h_words(rows, 4)


@pytest.mark.parametrize("B,D,Hd", ZOO + [
    (33, 20000, 128), (130, 6144, 1024), (64, 6144, 512), (16, 100000, 512),
    (1, 1, 32), (130, 1000, 512), (5, 1001, 64)])
def test_every_barrier_wait_finds_its_load(B, D, Hd):
    """The kernel's parity rule: a warp's box is loaded in the passes whose
    rows start below D, again each lane tile where the plan has passes;
    the wait of (lane tile, pass) takes parity (lane tile * loads + pass),
    which must be the parity of the load it waits for."""
    plan = ss.score_plan(B, D, Hd)
    rows, P = plan["rows"], plan["passes"]
    span, reload = ss.WARPS * rows, P > 1
    for rank in range(plan["cluster"]):
        for w in range(ss.WARPS):
            first = rank * P * span + w * rows
            loads = min(P, -(-(D - first) // span)) if first < D else 0
            done = 0
            for lt in range(plan["lane_tiles"]):
                for p in range(loads):
                    if p == lt == 0 or reload:
                        done += 1
                    parity = (lt * loads + p) & 1 if reload else 0
                    assert parity == (done - 1) & 1


def _inputs(seed, B, D, Hd):
    rs = np.random.RandomState(seed)
    h = rs.randn(B, D).astype(np.float32)
    w = [rs.randn(D, Hd) * D ** -0.5, rs.randn(Hd) * 0.1,
         rs.randn(Hd, 1) * Hd ** -0.5, rs.randn(1) * 0.1]
    return h, [a.astype(np.float32) for a in w]


@pytest.mark.parametrize("B,D,Hd", [(1, 64, 512), (8, 256, 512),
                                    (13, 1000, 32), (130, 512, 512),
                                    (16, 2560, 512), (5, 1001, 1024)])
def test_face_emulation_vs_plain_oracle_and_pallas(B, D, Hd):
    h, w = _inputs(B + D + Hd, B, D, Hd)
    th, tw = torch.from_numpy(h), [torch.from_numpy(a) for a in w]
    got = ss.step_score_face_plain(th, *tw)
    np.testing.assert_allclose(to_np(got), to_np(ss.step_score_plain(th, *tw)),
                               **SCORES)
    jh, jw = jnp.asarray(h), [jnp.asarray(a) for a in w]
    np.testing.assert_allclose(to_np(got),
                               to_np(ref.step_score_ref(jh, *jw)), **SCORES)
    kern = j_step_score(jh, *jw, blk_b=64, interpret=True)
    np.testing.assert_allclose(to_np(got), to_np(kern), **SCORES)


@pytest.mark.parametrize("cluster,passes,lane_tile", [(1, 1, 16), (2, 3, 32),
                                                      (8, 2, 16)])
def test_face_emulation_over_forced_plans(cluster, passes, lane_tile):
    """Other plans sum the same rows in other orders: the emulation stays
    within the tolerance of the plain version over each."""
    B, D, Hd = 20, 700, 64
    h, w = _inputs(7, B, D, Hd)
    th, tw = torch.from_numpy(h), [torch.from_numpy(a) for a in w]
    rows = -(-D // (cluster * passes * ss.WARPS))
    rows = rows if rows <= ss.K_STEP else -(-rows // ss.K_STEP) * ss.K_STEP
    plan = dict(ss.score_plan(B, D, Hd), cluster=cluster, passes=passes,
                rows=rows, lane_tile=lane_tile,
                rows_per_cta=passes * ss.WARPS * rows)
    assert sorted(r for *_, r0, n in ss.score_blocks(plan, D)
                  for r in range(r0, r0 + n)) == list(range(D))
    np.testing.assert_allclose(
        to_np(ss.step_score_face_plain(th, *tw, plan=plan)),
        to_np(ss.step_score_plain(th, *tw)), **SCORES)


def test_bf16_pieces_rebuild_w1():
    """W1 in three bf16 pieces, each the nearest bf16 to what the others
    leave: their sum is W1 to f32's precision (the bf16 hidden state is
    exact in bf16, so its products lose nothing more)."""
    rs = np.random.RandomState(5)
    w = torch.from_numpy((rs.randn(4096) * np.exp(rs.randn(4096) * 4))
                         .astype(np.float32))
    hi, mid, lo = ss.split_bf16x3(w)
    for p in (hi, mid, lo):
        assert torch.equal(p, p.to(torch.bfloat16).float())
    err = ((hi + mid) + lo - w).abs()
    assert bool((err <= w.abs() * 2.0 ** -23).all())


def test_face_emulation_in_bf16_vs_oracles():
    """bf16 hidden states (the serve path): the emulation's bf16 pieces
    against the plain version and the oracle on the same bf16 values."""
    h, w = _inputs(11, 16, 2560, 512)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    tw = [torch.from_numpy(a) for a in w]
    got = ss.step_score_face_plain(hb, *tw)
    np.testing.assert_allclose(to_np(got),
                               to_np(ss.step_score_plain(hb, *tw)), **SCORES)
    jh = jnp.asarray(to_np(hb.float()))
    np.testing.assert_allclose(
        to_np(got), to_np(ref.step_score_ref(jh, *[jnp.asarray(a)
                                                    for a in w])), **SCORES)
