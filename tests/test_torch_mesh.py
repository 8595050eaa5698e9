"""The port's mesh factory and serving sharding rules against the JAX
package's (``repro.launch.mesh``, the serving half of
``repro.launch.shardings``): the same mesh shapes and refusals, and the
same spec for every param and cache entry of every arch, entry by entry,
at ``(2, 2)`` and ``(2, 16)``. Pure: no process group, no device; the
JAX side runs on an ``AbstractMesh``, the port's on a mapping of axis
sizes."""
import inspect

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs.registry import ALL_ARCHS  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.launch import mesh as j_mesh  # noqa: E402
from repro.launch import shardings as j_shd  # noqa: E402
from repro.models.init import init_params as j_init_params  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import shardings as t_shd  # noqa: E402

MESHES = [(2, 2), (2, 16)]


def _abstract_mesh(sizes):
    names = ("data", "model")
    params = inspect.signature(AbstractMesh.__init__).parameters
    if "shape_tuple" in params:
        return AbstractMesh(tuple(zip(names, sizes)))
    return AbstractMesh(tuple(sizes), names)


def _port_mesh(sizes):
    return dict(zip(("data", "model"), sizes))


def _jax_flat(tree):
    """{path: spec tuple} of a JAX spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(k.key for k in path): tuple(spec) for path, spec in flat}


def _port_flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


# ---------------------------------------------------------------------------
# the mesh factory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,want", [
    ((None, None, 4), (4, 1)), ((2, None, 4), (2, 2)),
    ((None, 2, 4), (2, 2)), ((1, 1, 1), (1, 1)), ((None, None, 1), (1, 1)),
])
def test_resolve_host_mesh_shape_adapts_as_jax(args, want):
    data, model, n = args
    assert t_mesh.resolve_host_mesh_shape(data, model, device_count=n) \
        == j_mesh.resolve_host_mesh_shape(data, model, device_count=n) \
        == want


@pytest.mark.parametrize("args,match", [
    ((3, None, 4), "does not divide"), ((2, 4, 4), "device"),
    ((0, 2, 4), ">= 1"),
])
def test_resolve_host_mesh_shape_refuses_as_jax(args, match):
    data, model, n = args
    with pytest.raises(ValueError, match=match):
        j_mesh.resolve_host_mesh_shape(data, model, device_count=n)
    with pytest.raises(ValueError, match=match) as err:
        t_mesh.resolve_host_mesh_shape(data, model, device_count=n)
    if match == "does not divide":
        assert "torchrun --nproc-per-node" in str(err.value)


def test_make_host_mesh_needs_a_process_group():
    """Without an initialized default group the world is one rank, and a
    mesh refuses to form rather than make one up."""
    assert t_mesh.resolve_host_mesh_shape() == (1, 1)
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        t_mesh.make_host_mesh(2, 2)


def test_axis_helpers():
    m = _port_mesh((2, 16))
    assert t_mesh.axis_size(m, "model") == 16
    assert t_mesh.axis_size(m, "pod") == 1
    assert t_mesh.data_axes(m) == ("data",)
    assert t_mesh.data_axes({"pod": 2, **m}) == ("pod", "data")


# ---------------------------------------------------------------------------
# the serving specs, every arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_serving_param_specs_match_jax(arch, sizes):
    """Every leaf of the full-size params (abstract shapes: nothing is
    allocated) gets JAX's spec. The port's tree has the JAX tree's keys
    and shapes (``models.bridge``), so the same shapes feed both."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda: j_init_params(jcfg, jax.random.PRNGKey(0)))
    want = _jax_flat(j_shd.serving_param_specs(jcfg, _abstract_mesh(sizes),
                                               shapes))
    got = _port_flat(t_shd.serving_param_specs(cfg, _port_mesh(sizes),
                                               shapes))
    assert got == want
    if sizes == (2, 2) and "layers" in shapes and "attn" in shapes["layers"] \
            and "wq" in shapes["layers"]["attn"]:
        assert got[("layers", "attn", "wq")][-1] == "model"


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_serving_cache_and_prefill_specs_match_jax(arch, sizes):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jm, tm = _abstract_mesh(sizes), _port_mesh(sizes)
    for kv_dtype in ("bf16", "int8"):
        want = {k: tuple(v) for k, v in
                j_shd.serving_cache_specs(jcfg, jm, kv_dtype).items()}
        assert t_shd.serving_cache_specs(cfg, tm, kv_dtype) == want
    want = {k: tuple(v.spec) for k, v in
            j_shd.serving_prefill_kv_specs(jcfg, jm).items()}
    assert t_shd.serving_prefill_kv_specs(cfg, tm) == want


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_serving_step_shardings_match_jax(kv_dtype):
    jcfg = j_get_config("qwen3-4b-thinking")
    cfg = get_config("qwen3-4b-thinking")
    want = j_shd.serving_step_shardings(jcfg, _abstract_mesh((2, 2)),
                                        kv_dtype)
    got = t_shd.serving_step_shardings(cfg, _port_mesh((2, 2)), kv_dtype)
    assert set(got) == set(want)
    for key in ("lane", "table", "hidden", "act", "prefill_act",
                "replicated"):
        assert got[key] == tuple(want[key].spec)
    for key in ("pools", "layer_pool"):
        assert got[key] == {k: tuple(v.spec) for k, v in want[key].items()}


# ---------------------------------------------------------------------------
# a rank's piece of a whole tensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    (None, "model"), ("model", None), ("data", "model"), ("model", "data"),
    (None, None), (None, None, "model", None),
])
def test_local_slice_reassembles(spec):
    sizes = _port_mesh((2, 4))
    g = torch.Generator().manual_seed(0)
    whole = torch.randn(*([8] * len(spec)), generator=g)
    pieces = {(d, m): t_shd.local_slice(whole, spec, sizes,
                                        {"data": d, "model": m})
              for d in range(2) for m in range(4)}
    for d in range(2):
        for m in range(4):
            piece = pieces[(d, m)]
            for dim, axis in enumerate(spec):
                n = sizes[axis] if axis else 1
                assert piece.shape[dim] == 8 // n
    # join the pieces back along each split dim, innermost axis first
    rows = []
    for d in range(2):
        row = [pieces[(d, m)] for m in range(4)]
        if "model" in spec:
            row = [torch.cat(row, dim=spec.index("model"))]
        rows.append(row[0])
    joined = (torch.cat(rows, dim=spec.index("data")) if "data" in spec
              else rows[0])
    assert torch.equal(joined, whole)
    for d in range(2):          # an unsplit axis: every rank holds it all
        if "data" not in spec:
            assert torch.equal(pieces[(d, 0)], pieces[(0, 0)])


def test_local_slice_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        t_shd.local_slice(torch.zeros(6, 3), (None, "model"),
                          _port_mesh((1, 2)), {"data": 0, "model": 0})
