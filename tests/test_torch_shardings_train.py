"""The training half of the port's sharding rules against the JAX
package's (``repro.launch.shardings``): the same spec for every param,
optimizer moment, input, cache entry and per-layer K/V of every arch,
entry by entry, on both production meshes (JAX on an ``AbstractMesh``,
the port on a mapping of axis sizes); the same byte counts; the port's
shapes-only params equal to ``jax.eval_shape(init_params)``; and
``to_placements`` on a DeviceMesh of a fake process group."""
import functools
import inspect

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate,  # noqa: E402
                                      Shard, distribute_tensor)

from repro.configs.base import SHAPES  # noqa: E402
from repro.configs.registry import ALL_ARCHS  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.launch import shardings as j_shd  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro.training.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import shardings as t_shd  # noqa: E402
from repro_torch.models.init import init_param_shapes  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _abstract_mesh(sizes, names):
    params = inspect.signature(AbstractMesh.__init__).parameters
    if "shape_tuple" in params:
        return AbstractMesh(tuple(zip(names, sizes)))
    return AbstractMesh(tuple(sizes), tuple(names))


def _meshes(name):
    sizes, names = MESHES[name]
    return _abstract_mesh(sizes, names), dict(zip(names, sizes))


def _jax_flat(tree):
    """{path: spec tuple} of a JAX spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(getattr(k, "key", getattr(k, "name", None)) for k in path):
            tuple(spec) for path, spec in flat}


def _port_flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(JAX config, its abstract params, port config, its meta params)."""
    jcfg = j_get_config(arch)
    jshapes = jax.eval_shape(lambda: j_init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    cfg = get_config(arch)
    return jcfg, jshapes, cfg, init_param_shapes(cfg)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_shapes_match_eval_shape(arch):
    """The shapes-only params: meta tensors of ``init_params``' names,
    shapes and dtypes, as ``jax.eval_shape`` gives them."""
    _, jshapes, _, shapes = _shapes(arch)
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _port_flat(jshapes).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _port_flat(shapes).items()}
    assert got == want
    assert all(v.device.type == "meta" for v in _port_flat(shapes).values())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_opt_specs_match_jax(arch, mesh):
    """``partition_params`` with fsdp True, False and None, and
    ``partition_opt_state``, leaf for leaf; ``param_bytes`` and
    ``sharded_bytes_per_device`` (all leaves, and the bf16 ones)."""
    jcfg, jshapes, cfg, shapes = _shapes(arch)
    jm, tm = _meshes(mesh)
    for fsdp in (True, False, None):
        want = j_shd.partition_params(jcfg, jm, jshapes, fsdp=fsdp)
        got = t_shd.partition_params(cfg, tm, shapes, fsdp=fsdp)
        assert _port_flat(got) == _jax_flat(want), fsdp
        assert t_shd.sharded_bytes_per_device(shapes, got, tm) \
            == j_shd.sharded_bytes_per_device(jshapes, want, jm)
        assert t_shd.sharded_bytes_per_device(
            shapes, got, tm, dtype_filter=torch.bfloat16) \
            == j_shd.sharded_bytes_per_device(jshapes, want, jm,
                                              dtype_filter=jnp.bfloat16)
    assert t_shd.param_bytes(shapes) == j_shd.param_bytes(jshapes)

    jopt = jax.eval_shape(JAdamW(moment_dtype="bfloat16").init, jshapes)
    opt = AdamW(moment_dtype="bfloat16").init(shapes)
    pspecs = t_shd.partition_params(cfg, tm, shapes, fsdp=True)
    want = j_shd.partition_opt_state(
        jcfg, jm, jopt, j_shd.partition_params(jcfg, jm, jshapes, fsdp=True))
    got = t_shd.partition_opt_state(cfg, tm, opt, pspecs)
    assert got.step == tuple(want.step) == ()
    for field in ("mu", "nu"):
        assert _port_flat(getattr(got, field)) \
            == _jax_flat(getattr(want, field))
    # the JAX state's step count is an int32 array; the port's a Python int
    assert t_shd.sharded_bytes_per_device(opt, got, tm) + 4 \
        == j_shd.sharded_bytes_per_device(jopt, want, jm)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_cache_kv_and_moe_specs_match_jax(arch, mesh):
    """``partition_inputs`` and ``partition_cache`` for each shape,
    ``kv_partition_specs`` at batches 1, 32 and 128, ``moe_expert_specs``
    and ``moe_ex_in_spec``."""
    jcfg, _, cfg, _ = _shapes(arch)
    jm, tm = _meshes(mesh)
    for shape in SHAPES:
        want = {k: tuple(v) for k, v in
                j_shd.partition_inputs(jcfg, jm, shape).items()}
        assert t_shd.partition_inputs(cfg, tm, shape) == want, shape
        if SHAPES[shape].kind == "decode" \
                and jcfg.supports_shape(SHAPES[shape]):
            want = {k: tuple(v) for k, v in
                    j_shd.partition_cache(jcfg, jm, shape).items()}
            assert t_shd.partition_cache(cfg, tm, shape) == want, shape
    for batch in (1, 32, 128):
        want = {k: tuple(v) for k, v in
                j_shd.kv_partition_specs(jcfg, jm, batch).items()}
        assert t_shd.kv_partition_specs(cfg, tm, batch) == want, batch
    want = j_shd.moe_expert_specs(jcfg, jm)
    got = t_shd.moe_expert_specs(cfg, tm)
    assert got == (None if want is None
                   else {k: tuple(v) for k, v in want.items()})
    want = j_shd.moe_ex_in_spec(jcfg, jm)
    assert t_shd.moe_ex_in_spec(cfg, tm) == (None if want is None
                                             else tuple(want))


def test_serve_fsdp_threshold_is_the_references():
    assert t_shd.SERVE_FSDP_THRESHOLD_BYTES \
        == j_shd.SERVE_FSDP_THRESHOLD_BYTES
    assert t_shd._MODEL_CONTRACT == j_shd._MODEL_CONTRACT
    assert t_shd._REPLICATE == j_shd._REPLICATE


# ---------------------------------------------------------------------------
# to_placements on a DeviceMesh (a fake process group)
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh_2x2():
    with t_mesh.fake_process_group(4):
        yield t_mesh.make_host_mesh(2, 2)
    assert not dist.is_initialized()


@pytest.fixture
def mesh_2x2x2():
    with t_mesh.fake_process_group(8):
        from torch.distributed.device_mesh import init_device_mesh
        yield init_device_mesh("cpu", (2, 2, 2),
                               mesh_dim_names=("pod", "data", "model"))
    assert not dist.is_initialized()


@pytest.mark.parametrize("spec,want,local", [
    (("data", "model"), (Shard(0), Shard(1)), (4, 3)),
    (("model", None), (Replicate(), Shard(0)), (4, 6)),
    ((None, None), (Replicate(), Replicate()), (8, 6)),
    ((("data", "model"), None), (Shard(0), Shard(0)), (2, 6)),
])
def test_to_placements_on_a_fake_2x2_mesh(mesh_2x2, spec, want, local):
    """A mesh dim named in entry d splits dim d; a two-axis entry splits
    one dim over both mesh dims, the first the major one; rank 0's shard
    has the local shape the spec gives."""
    got = t_shd.to_placements(mesh_2x2, spec)
    assert got == want
    x = distribute_tensor(torch.empty(8, 6, device="meta"), mesh_2x2,
                          list(got))
    assert isinstance(x, DTensor) and tuple(x.to_local().shape) == local


def test_to_placements_pod_entry_in_mesh_order(mesh_2x2x2):
    """The multi-pod batch entry ``("pod", "data")``: both mesh dims split
    the batch, pod the major one, as JAX splits it."""
    got = t_shd.to_placements(mesh_2x2x2, (("pod", "data"), None, "model"))
    assert got == (Shard(0), Shard(0), Shard(2))
    x = distribute_tensor(torch.empty(8, 3, 4, device="meta"), mesh_2x2x2,
                          list(got))
    assert tuple(x.to_local().shape) == (2, 3, 2)


def test_to_placements_refuses_unknown_or_repeated_axes(mesh_2x2):
    with pytest.raises(ValueError, match="not axes of the mesh"):
        t_shd.to_placements(mesh_2x2, ("pod", None))
    with pytest.raises(ValueError, match="named twice"):
        t_shd.to_placements(mesh_2x2, ("data", "data"))


def test_production_meshes(mesh_2x2):
    """``make_production_mesh`` wants its rank count; the fake group
    refuses to start over an open one."""
    with pytest.raises(ValueError, match="needs 256 ranks"):
        t_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="already initialized"):
        with t_mesh.fake_process_group(256):
            pass


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_shapes(multi_pod):
    sizes, names = t_mesh.production_mesh_shape(multi_pod=multi_pod)
    with t_mesh.fake_process_group(256 * (2 if multi_pod else 1)):
        m = t_mesh.make_production_mesh(multi_pod=multi_pod)
        assert m.mesh_dim_names == names
        assert tuple(m.size(i) for i in range(m.ndim)) == sizes
        assert t_mesh.data_axes(m) == (("pod", "data") if multi_pod
                                       else ("data",))
    assert not dist.is_initialized()


def test_fake_group_is_destroyed_on_error():
    with pytest.raises(KeyError):
        with t_mesh.fake_process_group(4):
            raise KeyError("boom")
    assert not dist.is_initialized()


def test_no_process_group_left_open():
    assert not dist.is_initialized()
