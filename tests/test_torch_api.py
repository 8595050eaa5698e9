"""The port's package-level API against the JAX package's: every name
that ``repro.serving``, ``repro.core`` and ``repro.kernels`` export comes
from the package of the same name under ``repro_torch``, defined there;
``sample_tokens_lanes`` draws the reference's tokens; the ``kernels.ref``
oracles equal the reference's on the same inputs; and importing the
three packages loads neither jax nor ``repro``.
"""
import inspect
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is as fast, and more threads would
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as j_core  # noqa: E402
import repro.kernels as j_kernels  # noqa: E402
import repro.serving as j_serving  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
import repro_torch.core as t_core  # noqa: E402
import repro_torch.kernels as t_kernels  # noqa: E402
import repro_torch.serving as t_serving  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

# Names whose kind of object differs from the reference's, with why. The
# module check below holds for them too.
KIND_EXCEPTIONS = {
    # jax.jit wrappers in the reference; PyTorch runs eagerly, so the
    # port's are the plain functions they wrap
    "sample_tokens": "a jitted wrapper, a plain function in the port",
    "sample_tokens_lanes": "a jitted wrapper, a plain function in the port",
}


def _kind(obj) -> str:
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    if inspect.isfunction(obj):
        return "function"
    return type(obj).__name__


def _core_exports() -> list:
    return sorted(n for n, v in vars(j_core).items()
                  if not n.startswith("_") and not inspect.ismodule(v))


def _exports():
    return ([("serving", n) for n in j_serving.__all__]
            + [("core", n) for n in _core_exports()]
            + [("kernels", n) for n in ("ops", "ref")])


_PACKAGES = {"serving": (j_serving, t_serving), "core": (j_core, t_core),
             "kernels": (j_kernels, t_kernels)}


def test_export_lists():
    assert len(j_serving.__all__) == 45
    assert list(t_serving.__all__) == list(j_serving.__all__)
    assert len(_core_exports()) == 21
    assert t_core.__doc__ == j_core.__doc__


@pytest.mark.parametrize("package,name", _exports())
def test_export_is_defined_in_the_port(package, name):
    ref_pkg, port_pkg = _PACKAGES[package]
    obj = getattr(port_pkg, name)
    want = getattr(ref_pkg, name)
    if inspect.ismodule(obj):
        assert obj.__name__ == f"repro_torch.{package}.{name}"
    else:
        assert obj.__module__.startswith(f"repro_torch.{package}."), \
            obj.__module__
    if name in KIND_EXCEPTIONS:
        assert _kind(want) != _kind(obj) == "function"
    else:
        assert _kind(obj) == _kind(want)


def test_star_imports_give_every_name():
    ns = {}
    exec("from repro_torch.serving import *", ns)
    assert set(j_serving.__all__) <= set(ns)
    ns = {}
    exec("from repro_torch.core import *", ns)
    assert set(_core_exports()) <= set(ns)


def _logits(B=6, V=64, seed=0):
    return np.random.default_rng(seed).normal(size=(B, V)).astype(np.float32)


def test_sample_tokens_lanes_matches_the_reference():
    """Greedy lanes give the reference's tokens with any key; sampled
    lanes are fed the Gumbel noise of the reference's key
    (``jax.random.categorical`` is argmax(logits + gumbel(key)))."""
    lg = _logits()
    temps = np.array([0.0, 0.8, 1.0, 0.0, 1.3, 0.5], np.float32)
    topk = np.array([0, 20, 0, 3, 0, 5], np.int32)
    topp = np.array([1.0, 0.95, 1.0, 0.5, 0.7, 1.0], np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jt, jc = j_serving.sample_tokens_lanes(
            key, jnp.asarray(lg), jnp.asarray(temps), jnp.asarray(topk),
            jnp.asarray(topp))
        noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, lg.shape)))
        tt, tc = t_serving.sample_tokens_lanes(
            None, torch.from_numpy(lg), torch.from_numpy(temps),
            torch.from_numpy(topk), torch.from_numpy(topp), noise=noise)
        assert tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    # all-greedy lanes draw nothing: no generator and no noise needed
    zeros = np.zeros(6, np.float32)
    jt, _ = j_serving.sample_tokens_lanes(
        jax.random.PRNGKey(9), jnp.asarray(lg), jnp.asarray(zeros),
        jnp.asarray(topk), jnp.asarray(topp))
    tt, _ = t_serving.sample_tokens_lanes(
        torch.Generator().manual_seed(0), torch.from_numpy(lg),
        torch.from_numpy(zeros), torch.from_numpy(topk),
        torch.from_numpy(topp))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


# ---------------------------------------------------------------------------
# kernels.ref: the oracles on seeded inputs, f32, atol 1e-5
# ---------------------------------------------------------------------------

def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _close(t_out, j_out, atol=1e-5):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)])
def test_mha_ref(causal, window):
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, 3, 16, 8)).astype(np.float32)
               for _ in range(3))
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    out = t_ref.mha_ref(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.float32 and out.shape == (2, 3, 16, 8)
    _close(out, j_ref.mha_ref(jq, jk, jv, causal=causal, window=window))


def _paged_inputs(rng, B=3, H=4, KVH=2, hd=8, NB=10, bs=4, bp=3):
    k_pool = rng.normal(size=(NB, bs, KVH, hd)).astype(np.float32)
    v_pool = rng.normal(size=(NB, bs, KVH, hd)).astype(np.float32)
    tables = np.stack([rng.permutation(NB)[:bp] for _ in range(B)]) \
        .astype(np.int32)
    return k_pool, v_pool, tables


def test_paged_attention_ref():
    rng = np.random.default_rng(2)
    k_pool, v_pool, tables = _paged_inputs(rng)
    q = rng.normal(size=(3, 4, 8)).astype(np.float32)
    lens = np.array([5, 12, 0], np.int32)   # the empty row emits zeros
    j_in, t_in = _both(q, k_pool, v_pool, tables, lens)
    out = t_ref.paged_attention_ref(*t_in, scale=0.35)
    assert out.shape == (3, 4, 8)
    _close(out, j_ref.paged_attention_ref(*j_in, scale=0.35))
    assert not out[2].any()


@pytest.mark.parametrize("window", [None, 6])
def test_paged_attention_prefill_ref(window):
    rng = np.random.default_rng(3)
    k_pool, v_pool, tables = _paged_inputs(rng)
    C = 4
    q = rng.normal(size=(3, C, 4, 8)).astype(np.float32)
    own_k = rng.normal(size=(3, C, 2, 8)).astype(np.float32)
    own_v = rng.normal(size=(3, C, 2, 8)).astype(np.float32)
    prefix = np.array([0, 5, 8], np.int32)
    nvalid = np.array([4, 2, 0], np.int32)
    j_in, t_in = _both(q, k_pool, v_pool, tables, prefix, nvalid, own_k,
                       own_v)
    out = t_ref.paged_attention_prefill_ref(*t_in, scale=0.35, window=window)
    assert out.dtype == torch.float32 and out.shape == (3, C, 4, 8)
    _close(out, j_ref.paged_attention_prefill_ref(*j_in, scale=0.35,
                                                  window=window))


@pytest.mark.parametrize("initial", [False, True])
def test_ssd_scan_ref(initial):
    rng = np.random.default_rng(4)
    B, S, H, P, N = 2, 12, 3, 4, 5
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32) if initial \
        else None
    arrays = (x, dt, A, Bm, Cm) + ((h0,) if initial else ())
    j_in, t_in = _both(*arrays)
    y, h = t_ref.ssd_scan_ref(*t_in)
    jy, jh = j_ref.ssd_scan_ref(*j_in)
    _close(y, jy)
    _close(h, jh)


def test_step_score_ref():
    rng = np.random.default_rng(5)
    hidden = rng.normal(size=(6, 32)).astype(np.float32)
    w1 = (rng.normal(size=(32, 16)) * 0.2).astype(np.float32)
    b1 = rng.normal(size=(16,)).astype(np.float32)
    w2 = (rng.normal(size=(16, 1)) * 0.2).astype(np.float32)
    b2 = rng.normal(size=(1,)).astype(np.float32)
    j_in, t_in = _both(hidden, w1, b1, w2, b2)
    out = t_ref.step_score_ref(*t_in)
    assert out.shape == (6,)
    _close(out, j_ref.step_score_ref(*j_in))


def test_packages_import_without_jax_or_repro():
    code = ("import sys\n"
            "import repro_torch.serving, repro_torch.core\n"
            "from repro_torch.kernels import ops, ref\n"
            "from repro_torch.serving import *\n"
            "from repro_torch.core import *\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
