"""The port's SSD scan (kernel K4) against the JAX package: the plain
version against ``ref.ssd_scan_ref`` (the sequential oracle) and the
interpret-mode Pallas ``ssd_scan`` on the shapes of
``tests/test_kernels.py``, the port's dense ``ssd_chunked`` against the
JAX package's, and the wrapper's CPU route and refusals.

Tolerances: against the sequential oracle 1e-5 relative plus 1e-4
absolute (the same recurrence in f32, summed in another order; outputs
reach ~1e2); the two packages' dense ``ssd_chunked`` 1e-4 relative plus
1e-3 absolute (the same einsums, contracted in other orders over up to
128 positions of a chunk); against the Pallas kernel and across the
chunked forms 2e-3, as ``tests/test_kernels.py`` holds the Pallas kernel
to the oracle (the chunked form exponentiates cumsum differences instead
of multiplying per-step decays).
"""
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as t_ssd  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from torch_parity import to_np  # noqa: E402

ORACLE = dict(rtol=1e-5, atol=1e-4)
CROSS = dict(rtol=1e-4, atol=1e-3)
CHUNKED = dict(rtol=2e-3, atol=2e-3)
# (B, S, H, P, N, chunk, head_group): tests/test_kernels.py's cases, the
# last with a head group that does not divide H
SHAPES = [(1, 64, 2, 8, 16, 16, 1), (2, 128, 6, 16, 32, 32, 3),
          (1, 256, 4, 32, 64, 128, 4), (2, 96, 5, 16, 32, 32, 4)]


def _inputs(seed, B, S, H, P, N, stress=False):
    """x, dt, A, Bm, Cm as numpy f32. ``stress``: the init's decay rates
    A = -(1..H) and large steps, so cs falls hundreds below zero inside a
    chunk."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, H, P)
    dt = np.log1p(np.exp(rs.randn(B, S, H) + (2.0 if stress else 0.0)))
    A = -np.arange(1, H + 1) if stress else -np.exp(rs.randn(H))
    Bm, Cm = rs.randn(B, S, N), rs.randn(B, S, N)
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


@pytest.mark.parametrize("B,S,H,P,N,chunk,g", SHAPES)
def test_plain_matches_oracle_and_pallas(B, S, H, P, N, chunk, g):
    jargs, targs = _both(_inputs(0, B, S, H, P, N))
    y, h = t_ssd.ssd_scan_plain(*targs)
    yr, hr = ref.ssd_scan_ref(*jargs)
    np.testing.assert_allclose(to_np(y), to_np(yr), **ORACLE)
    np.testing.assert_allclose(to_np(h), to_np(hr), **ORACLE)
    yk, hk = j_ssd_scan(*jargs, chunk=chunk, head_group=g, interpret=True)
    np.testing.assert_allclose(to_np(y), to_np(yk), **CHUNKED)
    np.testing.assert_allclose(to_np(h), to_np(hk), **CHUNKED)
    # on a CPU tensor the wrapper is the plain version, and counts nothing
    ops.reset_launch_counts()
    yw, hw = ops.ssd_scan(*targs, chunk=chunk, head_group=g)
    assert torch.equal(yw, y) and torch.equal(hw, h)
    assert ops.launch_counts()["ssd_scan"] == 0


@pytest.mark.parametrize("B,S,H,P,N,chunk,g", SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_dense_chunked_matches_jax(B, S, H, P, N, chunk, g, with_state):
    arrs = _inputs(1, B, S, H, P, N)
    jargs, targs = _both(arrs)
    init_j = init_t = None
    if with_state:
        h0 = np.random.RandomState(2).randn(B, H, P, N).astype(np.float32)
        init_j, init_t = jnp.asarray(h0), torch.from_numpy(h0)
    yj, hj = jl.ssd_chunked(*jargs, chunk=chunk, initial_state=init_j)
    yt, ht = tl.ssd_chunked(*targs, chunk=chunk, initial_state=init_t)
    np.testing.assert_allclose(to_np(yt), to_np(yj), **CROSS)
    np.testing.assert_allclose(to_np(ht), to_np(hj), **CROSS)
    yp, hp = t_ssd.ssd_scan_plain(*targs, initial_state=init_t)
    np.testing.assert_allclose(to_np(yt), to_np(yp), **CHUNKED)
    np.testing.assert_allclose(to_np(ht), to_np(hp), **CHUNKED)


@pytest.mark.parametrize("S,chunk", [(40, 64), (100, 32), (64, 64)])
def test_padding_with_zero_steps_keeps_the_state(S, chunk):
    """The mixer pads S up to a multiple of the chunk with dt = 0 (decay
    1, input 0): the chunked scan over the padded sequence gives the
    oracle's y on the real positions and its final state exactly as the
    unpadded recurrence leaves it. S below the chunk, S not a multiple of
    it, and S a multiple."""
    arrs = _inputs(3, 2, S, 4, 16, 32)
    chunk = min(chunk, S)
    pad = (-S) % chunk
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              if a.ndim > 1 else a for a in arrs]
    y, h = tl.ssd_chunked(*[torch.from_numpy(a) for a in padded],
                          chunk=chunk)
    yp, hp = t_ssd.ssd_scan_plain(*[torch.from_numpy(a) for a in arrs])
    np.testing.assert_allclose(to_np(y[:, :S]), to_np(yp), **CHUNKED)
    np.testing.assert_allclose(to_np(h), to_np(hp), **CHUNKED)


def test_steep_decay_stays_finite():
    """A = -(1..H) with large steps: cs drops hundreds below zero inside
    one chunk. The chunked forms stay finite and agree with the oracle
    (the decays underflow to 0, which is the right answer)."""
    arrs = _inputs(4, 1, 128, 8, 16, 32, stress=True)
    jargs, targs = _both(arrs)
    cs = np.cumsum(arrs[1][0] * arrs[2], axis=0)
    assert cs.min() < -500.0
    yp, hp = t_ssd.ssd_scan_plain(*targs)
    yr, hr = ref.ssd_scan_ref(*jargs)
    np.testing.assert_allclose(to_np(yp), to_np(yr), **ORACLE)
    y, h = tl.ssd_chunked(*targs, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    np.testing.assert_allclose(to_np(y), to_np(yp), **CHUNKED)
    np.testing.assert_allclose(to_np(h), to_np(hp), **CHUNKED)


def test_layer_routes_to_the_wrapper():
    """``ssd_chunked(use_kernel=True)`` is the wrapper: on the CPU its
    plain version, which starts from a zero state like the kernel."""
    _, targs = _both(_inputs(5, 1, 64, 2, 8, 16))
    y, h = tl.ssd_chunked(*targs, chunk=32, use_kernel=True)
    yp, hp = t_ssd.ssd_scan_plain(*targs)
    assert torch.equal(y, yp) and torch.equal(h, hp)


def test_wrapper_refusals_and_no_backward():
    """The reference's restrictions (zero initial state, S a multiple of
    the chunk, a positive head group) raise; the JAX kernel has no
    backward, and neither has the wrapper."""
    _, (x, dt, A, Bm, Cm) = _both(_inputs(6, 1, 48, 2, 8, 16))
    with pytest.raises(ValueError, match="initial_state"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16,
                     initial_state=torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="head_group"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16, head_group=0)
    y, _ = ops.ssd_scan(x.requires_grad_(True), dt, A, Bm, Cm, chunk=16)
    with pytest.raises(NotImplementedError, match="no backward"):
        y.sum().backward()
