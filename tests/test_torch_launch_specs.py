"""The port's shape stand-ins against the JAX package's: ``input_specs``
and ``kv_cache_specs`` give the same names, shapes and dtypes for every
arch of the zoo and every assigned shape, and allocate nothing (meta
tensors)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402


def _layout(specs, name_of):
    return {k: (tuple(v.shape), name_of(v.dtype)) for k, v in specs.items()}


def _jax(specs):
    return _layout(specs, lambda d: jnp.dtype(d).name)


def _torch(specs):
    assert all(v.device.type == "meta" for v in specs.values())
    return _layout(specs, lambda d: str(d).removeprefix("torch."))


@pytest.mark.parametrize("shape", sorted(treg.SHAPES))
@pytest.mark.parametrize("arch", treg.ALL_ARCHS)
def test_specs_match_jax(arch, shape):
    cfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    assert _torch(treg.input_specs(cfg, shape)) == \
        _jax(jreg.input_specs(jcfg, shape))
    if treg.get_shape(shape).kind == "decode":
        assert _torch(treg.kv_cache_specs(cfg, shape)) == \
            _jax(jreg.kv_cache_specs(jcfg, shape))
    else:
        with pytest.raises(ValueError, match="decode shape"):
            treg.kv_cache_specs(cfg, shape)


def test_cache_caps():
    """The window and long-context caps, block-rounded: mixtral's 4096
    window caps decode_32k; long_500k takes the 8192 cap of a dense arch
    and the whole sequence's state of an ssm arch (no K/V at all)."""
    mix = treg.kv_cache_specs(treg.get_config("mixtral-8x7b"), "decode_32k")
    assert mix["k_cache"].shape[2] == 4096
    qwen = treg.kv_cache_specs(treg.get_config("qwen3-4b-thinking"),
                               "long_500k")
    assert qwen["k_cache"].shape[1:3] == (1, 8192)
    ssm = treg.kv_cache_specs(treg.get_config("mamba2-2.7b"), "long_500k")
    assert set(ssm) == {"ssm_state", "conv_state"}
    assert ssm["ssm_state"].dtype == torch.float32
