"""The wgmma prefill kernel's schedule (``kernels/paged_attention.py``
``prefill_plan``, the host's copy of the kernel's ``TilePlan``) against
the plain version's mask, and its route (``prefill_rows``).

For every CTA the plan must visit exactly the key tiles that hold a pair
visible to one of its live rows, and mark a tile mask-free exactly when
every key of it is visible to every live row: the kernel skips the mask
there. The mask is ``prefill_mask``, the one
``paged_attention_prefill_plain`` applies, and one case holds the plain
version to the JAX package's interpret-mode kernel at a windowed shape,
so the oracle of the plan is the reference's. The kernel itself runs on
the card (tests/test_torch_cuda.py).

Tolerances: f32 at 1e-5 relative / 1e-6 absolute (summation order only).
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention_prefill as j_paged_prefill)
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from torch_parity import F32, prefill_case, to_np  # noqa: E402

BK = pa.PREFILL_BLOCK
PAGE = 16


def _window(edge: str, C: int, prefix: int):
    """A window whose left edge falls inside the chunk's own keys for
    some rows ("own"), inside the pooled prefix ("pool"), or none."""
    if edge == "none":
        return None
    if edge == "own":
        return max(1, C // 2)
    return prefix // 2 + 1 if prefix else C


def _tiles(mask: torch.Tensor, n: int) -> torch.Tensor:
    """[tokens, keys] -> [tokens, tiles, BK], keys padded as invisible."""
    tiles = -(-n // BK)
    padded = torch.zeros(mask.shape[0], tiles * BK, dtype=torch.bool)
    padded[:, :n] = mask
    return padded.reshape(mask.shape[0], tiles, BK)


def _check_plan(C, G, rows, prefix, nvalid, window):
    S = -(-max(prefix, 1) // PAGE) * PAGE   # the pooled slots, whole pages
    mask = pa.prefill_mask(torch.tensor([prefix]), torch.tensor([nvalid]),
                           C, S, window)[0]                 # [C, S + C]
    parts = {"pool": _tiles(mask[:, :S], S), "own": _tiles(mask[:, S:], C)}
    ctas = pa.prefill_plan(C, G, rows, prefix, nvalid, window)
    T = rows // G
    assert [c["tokens"] for c in ctas] == [
        (c0, min(C, c0 + T)) for c0 in range(0, C, T)]
    for cta in ctas:
        (t0, t1), (lo, hi) = cta["tokens"], cta["live"]
        assert lo == t0 and hi == max(t0, min(t1, nvalid))
        assert not mask[hi:t1].any()     # padded tokens see nothing
        for name, tiles in parts.items():
            live = tiles[lo:hi]          # [live tokens, tiles, BK]
            needed = live.any(2).any(0).nonzero().flatten().tolist()
            full = live.all(2).all(0)
            assert [t for t, _ in cta[name]] == needed, (name, cta)
            for t, masked in cta[name]:
                assert masked == (not bool(full[t])), (name, t, cta)


@pytest.mark.parametrize("edge", ["own", "pool", "none"])
@pytest.mark.parametrize("C", [1, 16, 64, 512])
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 6, 48])
def test_plan_visits_exactly_the_visible_tiles(G, rows, C, edge):
    """Over ragged prefixes (0, mid-tile, several tiles) and num_valid
    (whole, ragged, fully padded): every visible pair lies in a visited
    tile, no visited tile is empty of them, and a mask-free tile is
    visible whole to every live row (masked ones are not)."""
    for prefix, nvalid in ((0, C), (37, max(1, C - 3)), (600, C // 2 + 1),
                           (131, 0)):
        _check_plan(C, G, rows, prefix, nvalid, _window(edge, C, prefix))


def _emulate(q, kp, vp, bt, prefix, nvalid, own_k, own_v, scale, window,
             rows):
    """The kernel's schedule in PyTorch (f32), one lane: per kv head and
    CTA, the visited tiles only, the mask only on the tiles the plan
    marks, the online softmax of ``tiled_softmax_pv``; rows of padded
    tokens zero."""
    _, C, H, hd = q.shape
    KVH = kp.shape[2]
    G = H // KVH
    keys = pa.gather_pages(kp, bt)[0].float()     # [S, KVH, hd]
    vals = pa.gather_pages(vp, bt)[0].float()
    S = keys.shape[0]
    mask = pa.prefill_mask(torch.tensor([prefix]), torch.tensor([nvalid]),
                           C, S, window)[0]
    out = torch.zeros(C, H, hd)
    for h in range(KVH):
        for cta in pa.prefill_plan(C, G, rows, prefix, nvalid, window):
            lo, hi = cta["live"]
            if hi == lo:
                continue
            qr = q[0, lo:hi, h * G:(h + 1) * G].float().reshape(-1, hd)
            ks, vs, ms = [], [], []
            for name, src_k, src_v, n, off in (
                    ("pool", keys, vals, S, 0),
                    ("own", own_k[0], own_v[0], C, S)):
                for t, masked in cta[name]:
                    k = torch.zeros(BK, hd)
                    v = torch.zeros(BK, hd)
                    m = torch.zeros(hi - lo, BK, dtype=torch.bool)
                    j1 = min(n, t * BK + BK) - t * BK
                    k[:j1] = src_k[t * BK:t * BK + j1, h].float()
                    v[:j1] = src_v[t * BK:t * BK + j1, h].float()
                    m[:, :j1] = mask[lo:hi, off + t * BK:off + t * BK + j1]
                    if not masked:   # the kernel applies no mask here
                        assert bool(m.all())
                        m[:] = True
                    ks.append(k)
                    vs.append(v)
                    ms.append(m)
            scores = qr @ torch.cat(ks).T
            m = torch.cat(ms, dim=1).repeat_interleave(G, dim=0)
            o = pa.tiled_softmax_pv(scores * scale, m, torch.cat(vs),
                                    block=BK)
            out[lo:hi, h * G:(h + 1) * G] = o.reshape(hi - lo, G, hd)
    return out[None]


@pytest.mark.parametrize("rows,G,C,prefix,nvalid,window", [
    (128, 4, 96, 150, 90, 100),    # the edge inside the pool, then own
    (64, 4, 16, 70, 13, None),     # the serve's chunk over a ragged prefix
    (128, 6, 40, 64, 40, 30),      # whole tokens per CTA (21 of G 6)
    (64, 48, 3, 20, 2, None),      # granite's group: one token per CTA
])
def test_plan_schedule_computes_the_plain_version(rows, G, C, prefix,
                                                  nvalid, window):
    """The attention over the plan's tiles, masking only the tiles it
    marks, equals ``paged_attention_prefill_plain`` (f32)."""
    KVH, hd, page = 2, 32, 16
    bp = -(-prefix // page) + 1
    rs = np.random.RandomState(7)
    H = KVH * G
    NB = bp + 2
    q, kp, vp = (torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in
                 ((1, C, H, hd), (NB, page, KVH, hd), (NB, page, KVH, hd)))
    own_k, own_v = (torch.from_numpy(rs.randn(1, C, KVH, hd)
                                     .astype(np.float32)) for _ in range(2))
    bt = torch.from_numpy(rs.permutation(NB)[:bp][None].astype(np.int32))
    scale = 1.0 / math.sqrt(hd)
    want = pa.paged_attention_prefill_plain(
        q, kp, vp, bt, torch.tensor([prefix], dtype=torch.int32),
        torch.tensor([nvalid], dtype=torch.int32), own_k, own_v, scale,
        window)
    got = _emulate(q, kp, vp, bt, prefix, nvalid, own_k, own_v, scale,
                   window, rows)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_plain_mask_is_the_reference_kernels():
    """The JAX package's Pallas kernel (interpret mode) at a small
    windowed shape against the port's plain version, which applies
    ``prefill_mask``: chunks starting mid-page, ragged num_valid, the
    window's edge inside the pool for some rows and inside the chunk for
    others."""
    jargs, targs = prefill_case(31, 2, 8, 2, 4, 8, 4, starts=[20, 3],
                                nvalid=[8, 5])
    scale = 1.0 / math.sqrt(32)
    got = pa.paged_attention_prefill_plain(*targs, scale, 6)
    kern = j_paged_prefill(*jargs, scale=scale, window=6, interpret=True)
    np.testing.assert_allclose(to_np(got), to_np(kern), **F32)


@pytest.mark.parametrize("C,G,hd,page,q,pool,rows", [
    (512, 4, 128, 16, "bf16", "bf16", 128),   # mixtral's chunk
    (16, 4, 128, 16, "bf16", "bf16", 64),     # the serve's chunk
    (8, 2, 64, 16, "bf16", "bf16", 64),       # the serving launcher's
    (64, 2, 64, 8, "bf16", "bf16", 128),
    (64, 4, 128, 32, "bf16", "bf16", 128),
    (64, 4, 128, 128, "bf16", "bf16", 128),   # 64-slot pieces of a page
    (1, 48, 128, 16, "bf16", "bf16", 64),     # granite's group
    (2, 48, 128, 16, "bf16", "bf16", 128),
    (16, 4, 80, 16, "bf16", "bf16", 0),       # hd 80: the mma.sync tile
    (16, 4, 32, 16, "bf16", "bf16", 0),
    (16, 4, 128, 4, "bf16", "bf16", 0),       # a page under 8 slots
    (16, 4, 128, 24, "bf16", "bf16", 0),      # a page 64 does not split
    (16, 4, 128, 16, "f32", "bf16", 0),       # f32 queries
    (16, 4, 128, 16, "bf16", "f32", 0),       # an f32 pool
    (16, 4, 128, 16, "bf16", "int8", 64),     # codes converted in smem
    (512, 4, 128, 16, "bf16", "fp8", 128),
    (16, 4, 80, 16, "bf16", "int8", 0),
    (1, 256, 128, 16, "bf16", "bf16", 0),     # G past two warpgroups
])
def test_prefill_route(C, G, hd, page, q, pool, rows):
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32,
              "int8": torch.int8, "fp8": torch.float8_e4m3fn}
    assert pa.prefill_rows(C, G, hd, page, dtypes[q], dtypes[pool]) == rows
