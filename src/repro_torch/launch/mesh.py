"""Meshes of the port (``repro/launch/mesh.py``): ``DeviceMesh``es over
the ranks of the default process group, one rank per device.

The JAX package simulates N host devices in one process; here each
device is a process, started by ``torchrun --nproc-per-node=N`` (or
``torch.multiprocessing.spawn``), which initializes the default group
before anything asks for a mesh. The world size takes the place of
``jax.device_count()``. Nothing here initializes a group on import.

  make_host_mesh        — the serving mesh ``("data", "model")`` over
                          whatever ranks there are;
  make_production_mesh  — the production meshes: 256 ranks as
                          (data 16, model 16), and 512 as (pod 2, data
                          16, model 16), whose "pod" axis carries only
                          batch (data-parallel) sharding;
  fake_process_group    — a group of any world size inside this one
                          process, whose collectives move nothing: the
                          dry run lays its tensors out over a production
                          mesh with it, as the JAX package lowers onto
                          512 simulated host devices.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Mapping, Optional, Tuple

import torch.distributed as dist

AXES = ("data", "model")
PRODUCTION_AXES = ("pod", "data", "model")


def world_size() -> int:
    """Ranks of the default process group (1 when none is initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def resolve_host_mesh_shape(data: Optional[int] = None,
                            model: Optional[int] = None,
                            device_count: Optional[int] = None
                            ) -> Tuple[int, int]:
    """Resolve a ``(data, model)`` mesh shape against the ranks there are
    (``device_count``, default the world size). ``None`` axes adapt: with
    neither given every rank goes on "data"; a missing axis takes what
    the other leaves. A size that does not fit raises ``ValueError``
    naming the launcher that starts more ranks."""
    n = world_size() if device_count is None else device_count

    def _check(name: str, val: int) -> None:
        if val < 1:
            raise ValueError(f"mesh axis {name!r} must be >= 1, got {val}")
        if n % val != 0 or val > n:
            raise ValueError(
                f"mesh axis {name}={val} does not divide the {n} available "
                f"device(s); start one rank per device with torchrun "
                f"--nproc-per-node=<N>")

    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        _check("model", model)
        data = n // model
    elif model is None:
        _check("data", data)
        model = n // data
    _check("data", data)
    _check("model", model)
    if data * model != n:
        raise ValueError(
            f"mesh (data={data}, model={model}) needs {data * model} "
            f"devices but {n} are available")
    return data, model


def make_host_mesh(data: Optional[int] = None, model: Optional[int] = None):
    """A ``("data", "model")`` DeviceMesh over the default process group,
    whose ranks are laid out data-major (rank = data * model_n + model).
    Sizes are resolved by :func:`resolve_host_mesh_shape`. The mesh's
    device type follows the group's backend: CUDA under NCCL, the CPU
    under gloo (which also carries CUDA tensors, through the host).
    Raises ``RuntimeError`` when no default group is initialized."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a serving mesh needs an initialized torch.distributed default "
            "process group: run under torchrun --nproc-per-node=<N>, or "
            "call torch.distributed.init_process_group first")
    from torch.distributed.device_mesh import init_device_mesh
    data, model = resolve_host_mesh_shape(data, model)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(sizes, axis names) of a production mesh."""
    if multi_pod:
        return (2, 16, 16), PRODUCTION_AXES
    return (16, 16), AXES


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh (see :func:`production_mesh_shape`) over the
    default process group, whose world size must be its rank count: 256
    ranks as (data 16, model 16), or with ``multi_pod`` 512 as (pod 2,
    data 16, model 16). Ranks are laid out as the sizes read, the first
    axis the major one."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    if not dist.is_initialized():
        raise RuntimeError(
            "a production mesh needs an initialized default process group "
            "of its rank count (fake_process_group for a dry run)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks, the group has "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """Run the body as rank 0 of a default process group of
    ``world_size`` ranks that lives in this process alone: its
    collectives return at once and move nothing, so a program can lay
    DTensors out over a mesh of any size without the devices. The group
    is destroyed on exit, whatever happens. Refuses to start while a
    default group is initialized."""
    if dist.is_initialized():
        raise RuntimeError(
            "a default process group is already initialized; a fake one "
            "would replace it")
    # registers the "fake" backend; PyTorch keeps it with its test helpers
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, Mapping):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names or ())


def data_axes(mesh) -> tuple:
    """The batch-sharding axes for this mesh."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def axis_size(mesh, name: str) -> int:
    """Size of axis ``name`` (1 where the mesh has no such axis). ``mesh``
    is a DeviceMesh or a mapping of axis name to size (what the sharding
    rules need when no process group exists)."""
    names = axis_names(mesh)
    if name not in names:
        return 1
    if isinstance(mesh, Mapping):
        return int(mesh[name])
    return mesh.size(names.index(name))
