"""Mamba2's one-token decode state update (``kernels/ssm_decode.py``) on
the CPU: the plain version against the JAX package's composition of the
same step, and the wrapper and the mixer's kernel path against the plain
version.

The JAX side composes ``causal_conv1d_step``, the SiLU, the step-size
decay, ``ssd_decode_step`` and the skip term as
``repro/models/layers.py::mamba2_mixer_decode`` does; the JAX package has
no kernel for it (XLA fuses it inside the jitted horizon). Both sides
chain several steps, each feeding its own new states to the next, with
the conv state kept in bf16 as both engines' caches keep it. Tolerances:
1e-5 relative plus absolute with f32 params (the same f32 arithmetic,
contracted in another order); 1e-2 with bf16 params (ROADMAP's bf16
tolerance: the convolution and the SiLU round to bf16 in both).
"""
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssm_decode as sd  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from torch_parity import pair, to_np  # noqa: E402

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}


def jax_step(conv_state, ssm_state, xbc, dt, conv_w, conv_b, dt_bias,
             A_log, D):
    """The reference's decode step, as its mixer composes it."""
    B, H, P, N = ssm_state.shape
    di = H * P
    conv, new_conv = jl.causal_conv1d_step(conv_state, xbc, conv_w, conv_b)
    act = jax.nn.silu(conv.astype(jnp.float32)).astype(xbc.dtype)
    xs = act[..., :di].reshape(B, H, P)
    Bm, Cm = act[..., di:di + N], act[..., di + N:]
    dt = jax.nn.softplus(dt.astype(jnp.float32)
                         + dt_bias.astype(jnp.float32))
    A = -jnp.exp(A_log.astype(jnp.float32))
    y, new_state = jl.ssd_decode_step(ssm_state, xs.astype(jnp.float32), dt,
                                      A, Bm.astype(jnp.float32),
                                      Cm.astype(jnp.float32))
    y = y + xs.astype(jnp.float32) * D.astype(jnp.float32)[None, :, None]
    return y, new_state, new_conv


def _case(seed, B, H, P, N, W, dt):
    """Params (numpy, f32 A_log / dt_bias / D as the init makes them) and
    the per-step projections of ``steps`` tokens."""
    rs = np.random.RandomState(seed)
    C = H * P + 2 * N
    f = np.float32
    params = {"conv_w": (rs.randn(W, C) * 0.5).astype(f),
              "conv_b": (rs.randn(C) * 0.1).astype(f),
              "dt_bias": np.log(np.expm1(rs.uniform(0.01, 0.1, H))).astype(f),
              "A_log": np.log(np.arange(1, H + 1)).astype(f),
              "D": rs.randn(H).astype(f)}
    state = rs.randn(B, H, P, N).astype(f)
    conv = rs.randn(B, W - 1, C).astype(f)
    return rs, params, state, conv


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_matches_jax_over_chained_steps(dt):
    B, H, P, N, W, steps = 3, 4, 8, 16, 4, 6
    rs, params, state, conv = _case(0, B, H, P, N, W, dt)
    C = H * P + 2 * N
    jp = {k: pair(v, dt if k in ("conv_w", "conv_b") else "f32")
          for k, v in params.items()}
    sj, st = pair(state)
    cj, ct = pair(conv, "bf16")          # the caches' conv state is bf16
    for _ in range(steps):
        xbc = pair(rs.randn(B, C).astype(np.float32), dt)
        dtr = pair(rs.randn(B, H).astype(np.float32), dt)
        args = [xbc, dtr] + [jp[k] for k in ("conv_w", "conv_b", "dt_bias",
                                             "A_log", "D")]
        yj, sj, cj = jax_step(cj, sj, *[a[0] for a in args])
        cj = cj.astype(jnp.bfloat16)
        yt, st, ct = sd.ssm_decode_plain(ct, st, *[a[1] for a in args])
        ct = ct.to(torch.bfloat16)
        assert yt.dtype == st.dtype == torch.float32
        for got, want in ((yt, yj), (st, sj), (ct, cj)):
            np.testing.assert_allclose(to_np(got), to_np(want), **TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_wrapper_updates_state_in_place_on_cpu(dt):
    """On a CPU tensor the wrapper runs the plain version and writes its
    states into the given tensors (the conv state cast to bf16), without
    counting a launch."""
    B, H, P, N, W = 2, 3, 4, 8, 4
    rs, params, state, conv = _case(1, B, H, P, N, W, dt)
    td = torch.float32 if dt == "f32" else torch.bfloat16
    tp = {k: torch.from_numpy(v).to(td if k in ("conv_w", "conv_b")
                                    else torch.float32)
          for k, v in params.items()}
    st = torch.from_numpy(state)
    ct = torch.from_numpy(conv).to(torch.bfloat16)
    # xbc and dt as strided slices of one projection row, as the mixer
    # hands them over
    proj = torch.from_numpy(rs.randn(B, 5 + H * P + 2 * N + H)
                            .astype(np.float32)).to(td)
    xbc, dtr = proj[:, 5:5 + H * P + 2 * N], proj[:, 5 + H * P + 2 * N:]
    args = (xbc, dtr, tp["conv_w"], tp["conv_b"], tp["dt_bias"],
            tp["A_log"], tp["D"])
    want_y, want_s, want_c = sd.ssm_decode_plain(ct, st, *args)
    ops.reset_launch_counts()
    st_ptr, ct_ptr = st.data_ptr(), ct.data_ptr()
    y = ops.ssm_decode(ct, st, *args)
    assert ops.launch_counts()["ssm_decode"] == 0
    assert (st.data_ptr(), ct.data_ptr()) == (st_ptr, ct_ptr)
    assert torch.equal(y, want_y) and torch.equal(st, want_s)
    assert torch.equal(ct, want_c.to(torch.bfloat16))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mixer_kernel_path_equals_dense_path(dt):
    """``mamba2_mixer_decode(use_kernel=True)`` on the CPU (the wrapper's
    plain version, in place) gives the dense path's output and states
    bitwise, at the smoke config, and every lane's state moves: a lane
    is updated whatever the engine makes of it (the reference's horizon
    drift)."""
    cfg = t_registry.get_config("mamba2-2.7b", smoke=True)
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g)
    lp = {k: v[0] if dt == "bf16" else v[0].float()
          for k, v in params["layers"]["mixer"].items()}
    B, H, P, N = 3, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state_size
    x = torch.randn(B, 1, cfg.d_model, generator=g).to(
        lp["w_in"].dtype)
    ss = torch.randn(B, H, P, N, generator=g)
    cs = torch.randn(B, cfg.ssm_conv_width - 1, cfg.d_inner + 2 * N,
                     generator=g).to(torch.bfloat16)
    out_d, ss_d, cs_d = tl.mamba2_mixer_decode(lp, cfg, x, ss, cs)
    ss_k, cs_k = ss.clone(), cs.clone()
    out_k, ss_r, cs_r = tl.mamba2_mixer_decode(lp, cfg, x, ss_k, cs_k,
                                               use_kernel=True)
    assert ss_r is ss_k and cs_r is cs_k
    assert torch.equal(out_k, out_d) and torch.equal(ss_k, ss_d)
    assert torch.equal(cs_k, cs_d.to(torch.bfloat16))
    assert bool((ss_k != ss).flatten(1).any(1).all())
