"""Shared helpers of the PyTorch port's parity tests: inputs made once with
numpy and handed to both the JAX package and the port."""
import jax.numpy as jnp
import numpy as np
import torch

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def pair(x, dt="f32"):
    """One numpy array -> (jax array, torch tensor) of the same values."""
    jd, td = DTYPES[dt]
    return jnp.asarray(x, jd), torch.from_numpy(np.array(x)).to(td)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def decode_case(seed, B, H, KVH, hd, page, bp, lens=None, dt="f32"):
    rs = np.random.RandomState(seed)
    NB = B * bp + 2
    q = rs.randn(B, H, hd).astype(np.float32)
    kp = rs.randn(NB, page, KVH, hd).astype(np.float32)
    vp = rs.randn(NB, page, KVH, hd).astype(np.float32)
    bt = rs.permutation(NB)[:B * bp].reshape(B, bp).astype(np.int32)
    if lens is None:
        lens = rs.randint(1, page * bp + 1, B)
    lens = np.asarray(lens, np.int32)
    j = [pair(q, dt), pair(kp, dt), pair(vp, dt)]
    return ([a for a, _ in j] + [jnp.asarray(bt), jnp.asarray(lens)],
            [b for _, b in j] + [torch.from_numpy(bt), torch.from_numpy(lens)])


def prefill_case(seed, B, C, KVH, G, page, bp, starts, nvalid, dt="f32",
                 hd=32):
    rs = np.random.RandomState(seed)
    H = KVH * G
    NB = B * bp + 2
    arrs = [rs.randn(B, C, H, hd), rs.randn(NB, page, KVH, hd),
            rs.randn(NB, page, KVH, hd)]
    own = [rs.randn(B, C, KVH, hd), rs.randn(B, C, KVH, hd)]
    bt = rs.permutation(NB)[:B * bp].reshape(B, bp).astype(np.int32)
    ints = [bt, np.asarray(starts, np.int32), np.asarray(nvalid, np.int32)]
    jf = [pair(a.astype(np.float32), dt) for a in arrs + own]
    jargs = [p[0] for p in jf[:3]] + [jnp.asarray(i) for i in ints] + \
        [p[0] for p in jf[3:]]
    targs = [p[1] for p in jf[:3]] + [torch.from_numpy(i) for i in ints] + \
        [p[1] for p in jf[3:]]
    return jargs, targs


def mesh_setup(path, names) -> dict:
    """For the mesh tests: the JAX package's serving weights and scorer in
    f32, bridged and saved as ``path``/params.pt for the ranks, and the
    scenarios ``names`` of tests/torch_mesh_ranks.py through the port's
    single-device engine on them."""
    import jax
    import torch_mesh_ranks as R
    from repro.configs.registry import serving_config
    from repro.core.scorer import init_scorer
    from repro.models.init import init_params
    from repro_torch.models.bridge import params_from_numpy, scorer_from_numpy
    jcfg = serving_config()
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      init_params(jcfg, jax.random.PRNGKey(0)))
    js = init_scorer(jax.random.PRNGKey(1), jcfg.d_model)
    torch.save({"params": params_from_numpy(jax.device_get(jp), device="cpu"),
                "scorer": scorer_from_numpy(jax.device_get(js), device="cpu")},
               path / "params.pt")
    cfg, params, scorer, tok = R.setup(str(path / "params.pt"))
    single = {name: R.run_scenario(name, params, cfg, scorer, tok)
              for name in names}
    return {"path": path, "jp": jp, "js": js, "jcfg": jcfg, "tok": tok,
            "single": single}


# ---------------------------------------------------------------------------
# the production dry run: the JAX package's records beside the port's
# ---------------------------------------------------------------------------

# The JAX package's ``run_one`` over its production mesh with automatic
# axes: the JAX here makes ``jax.make_mesh``'s axes explicit by default,
# and the reference's ``with_sharding_constraint`` calls refuse explicit
# axes. Its layouts and steps are its own. Run in a subprocess: the
# module sets ``XLA_FLAGS`` to 512 host devices at import.
REFERENCE_DRYRUN = """
import dataclasses, json, sys
import jax
from repro.launch import dryrun

layers = int(sys.argv[2])
if layers:
    full = dryrun.get_config
    dryrun.get_config = lambda arch: dataclasses.replace(
        full(arch), num_layers=layers)

def make_production_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * len(shape)
    return jax.make_mesh(shape, axes, **kw)

dryrun.make_production_mesh = make_production_mesh
recs = {s: dryrun.run_one(sys.argv[1], s, False, save=False)
        for s in sys.argv[3:]}
print(json.dumps(recs, default=str))
"""


def dryrun_records(arch: str, shapes, layers: int = 0) -> tuple:
    """(the JAX package's dry-run records, the port's), by shape, of
    ``arch`` over the 256-rank mesh (cut to ``layers`` layers in both
    packages, when given); each must be ``ok``. The reference's
    subprocess runs while the port traces its steps."""
    import dataclasses
    import json
    import os
    import subprocess
    import sys

    from repro_torch.launch import dryrun

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    full = dryrun.get_config
    with subprocess.Popen([sys.executable, "-c", REFERENCE_DRYRUN, arch,
                           str(layers), *shapes], env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True) as child:
        try:
            if layers:
                dryrun.get_config = lambda a: dataclasses.replace(
                    full(a), num_layers=layers)
            port = {s: dryrun.run_one(arch, s, False, save=False)
                    for s in shapes}
            out, err = child.communicate(timeout=600)
        finally:
            dryrun.get_config = full
            child.kill()
    assert child.returncode == 0, err[-3000:]
    reference = json.loads(out.strip().splitlines()[-1])
    for recs in (reference, port):
        for shape, rec in recs.items():
            assert rec["status"] == "ok", (shape, rec.get("reason"))
    return reference, port


def assert_collectives_like(ref: dict, got: dict) -> None:
    """The collectives of a port's dry-run record against the reference's
    (see ``tests/test_torch_dryrun_parity.py``): both gather and both
    reduce, the port's kinds are the reference's or a reduce-scatter,
    and its bytes lie between an eighth of the reference's and all of
    them."""
    ref_kinds = set(ref["collective_breakdown"])
    kinds = set(got["collective_breakdown"])
    reduces = {"all-reduce", "reduce-scatter"}
    assert "all-gather" in ref_kinds and "all-gather" in kinds
    assert ref_kinds & reduces and kinds & reduces
    assert kinds <= ref_kinds | {"reduce-scatter"}
    ratio = got["collective_bytes_per_dev"] / ref["collective_bytes_per_dev"]
    assert 1 / 8 <= ratio <= 1, ratio
