"""The port's flash-attention forward (kernel K3) against the JAX package:
the plain version against the interpret-mode Pallas ``flash_attention``,
causal, windowed and non-causal, and ``forward_full(use_kernel=True)``
against the JAX package's at ``serving_config()``.

Tolerances: f32 inputs at 1e-5 (both accumulate in f32; the Pallas kernel
folds 128-key blocks into an online softmax, the plain version takes one
softmax, so the summation order differs); bf16 inputs at 1e-2 (the output
rounds to bf16, one ulp near 1 is 2^-8); the model's logits at 1e-4, as
``tests/test_torch_model.py`` holds the f32 forward.
"""
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import serving_config as j_serving_config  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro_torch.configs.registry import serving_config  # noqa: E402
from repro_torch.kernels import flash_attention as t_flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from torch_parity import pair, to_np  # noqa: E402

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}
MASKS = {"causal": (True, None), "window": (True, 48),
         "noncausal": (False, None), "noncausal_window": (False, 40)}


def _qkv(seed, B, H, S, hd, dt):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(B, H, S, hd).astype(np.float32) for _ in range(3)]
    pairs = [pair(a, dt) for a in arrs]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("B,H,S,hd", [(1, 2, 256, 32), (2, 1, 64, 64),
                                      (1, 2, 128, 80)])
def test_plain_matches_pallas(dt, mask, B, H, S, hd):
    causal, window = MASKS[mask]
    jargs, targs = _qkv(0, B, H, S, hd, dt)
    want = j_flash(*jargs, causal=causal, window=window, interpret=True)
    got = t_flash.flash_attention_plain(*targs, causal=causal, window=window)
    assert got.dtype == targs[0].dtype
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[dt])
    # on a CPU tensor the wrapper is the plain version, and counts nothing
    ops.reset_launch_counts()
    wrapped = ops.flash_attention(*targs, causal=causal, window=window)
    assert torch.equal(wrapped, got)
    assert ops.launch_counts()["flash_attention"] == 0


def test_explicit_scale_and_ragged_sequence():
    """An explicit scale reaches both; a sequence under one block (S < 128)
    is its own block; one that does not tile by 128 raises, as the TPU
    kernel's assert does."""
    jargs, targs = _qkv(1, 1, 2, 40, 32, "f32")
    want = j_flash(*jargs, causal=True, scale=0.3, interpret=True)
    got = ops.flash_attention(*targs, causal=True, scale=0.3)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL["f32"])
    _, targs = _qkv(2, 1, 1, 200, 32, "f32")
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(*targs)


def test_backward_raises():
    """The JAX package has no backward for _flash_kernel; neither has the
    port's wrapper."""
    _, targs = _qkv(3, 1, 2, 32, 32, "f32")
    q = targs[0].requires_grad_(True)
    out = ops.flash_attention(q, targs[1], targs[2])
    with pytest.raises(NotImplementedError, match="no backward"):
        out.sum().backward()


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = j_serving_config(), serving_config()
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      j_init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, jp, params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("S", [16, 256])
def test_forward_full_kernel_matches_jax(models, S):
    jcfg, cfg, jp, tp = models
    toks = np.random.RandomState(S).randint(0, 25, (2, S)).astype(np.int32)
    jout = jm.forward_full(jp, jcfg, jnp.asarray(toks), use_kernel=True)
    tout = tm.forward_full(tp, cfg, torch.from_numpy(toks), use_kernel=True)
    dense = tm.forward_full(tp, cfg, torch.from_numpy(toks))
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(tout["logits"]), to_np(jout["logits"]),
                               **tol)
    np.testing.assert_allclose(to_np(tout["hidden"]), to_np(jout["hidden"]),
                               **tol)
    np.testing.assert_allclose(to_np(tout["logits"]),
                               to_np(dense["logits"]), **tol)


def test_lm_loss_kernel_matches_jax(models):
    jcfg, cfg, jp, tp = models
    rs = np.random.RandomState(4)
    toks = rs.randint(0, 25, (2, 32)).astype(np.int32)
    labels = rs.randint(-1, 25, (2, 32)).astype(np.int32)
    want = jm.lm_loss(jp, jcfg, jnp.asarray(toks), jnp.asarray(labels),
                      use_kernel=True)
    with torch.no_grad():
        got = tm.lm_loss(tp, cfg, torch.from_numpy(toks),
                         torch.from_numpy(labels), use_kernel=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
