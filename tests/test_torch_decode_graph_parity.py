"""Greedy ``serve_batch`` against the JAX engine with the decode horizon
going through its graph runner (``serving/cuda_graph.py``; on the CPU it
stages inputs and outputs and calls the horizon), for qwen3 and mamba2
at the smoke configs, as the parity tests of tests/test_torch_engine.py
and tests/test_torch_mamba2_engine.py state them: f32 at 1e-4, bf16 at
1e-2, identical tokens, statuses and prune decisions.
"""
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.registry import serving_config as j_serving_config  # noqa: E402
from repro.core.scorer import init_scorer as j_init_scorer  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro_torch.configs.registry import serving_config  # noqa: E402
from repro_torch.models.bridge import params_from_numpy, scorer_from_numpy  # noqa: E402
from repro_torch.serving.cuda_graph import DecodeGraph  # noqa: E402
from test_torch_engine import (TOL, assert_same_results, engine_kw,  # noqa: E402
                               make_setup, serve_jax, serve_torch)


def _mamba2_setup():
    s = make_setup("bf16")
    arch = "mamba2-2.7b"
    jcfg = j_serving_config(arch)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    js = j_init_scorer(jax.random.PRNGKey(1), jcfg.d_model)
    s.update(jcfg=jcfg, cfg=serving_config(arch), jp=jp, js=js,
             tp=params_from_numpy(jax.device_get(jp), device="cpu"),
             ts=scorer_from_numpy(jax.device_get(js), device="cpu"))
    return s


@pytest.mark.parametrize("model", ["qwen3_f32", "qwen3_bf16", "mamba2_bf16"])
def test_runner_in_the_loop_matches_jax(model):
    s = _mamba2_setup() if model == "mamba2_bf16" else \
        make_setup(model.split("_")[1])
    kw = engine_kw(s, decode_horizon=4)
    if model == "mamba2_bf16":
        kw["kv_dtype"] = "bf16"
    _, jres = serve_jax(s, "step", s["prompts"][:1], 8, **kw)
    eng, tres = serve_torch(s, "step", s["prompts"][:1], 8,
                            **dict(kw, use_kernel=True))
    assert eng._decode_fns and all(isinstance(f, DecodeGraph)
                                   for f in eng._decode_fns.values())
    assert_same_results(jres, tres, tol=TOL if model == "qwen3_f32"
                        else 1e-2)
    assert tres[0].num_pruned > 0
