"""Production meshes, as ``DeviceMesh``es over the current process
group.

The port's copy of the JAX package's ``launch/mesh.py``. Single pod:
(16, 16) = 256 ranks, axes (data, model). Multi-pod: (2, 16, 16) = 512
ranks, axes (pod, data, model); ``pod`` is the outermost gradient-parallel
axis. ``REPRO_TEST_MESH`` (``"2x2"``, ``"2x2x2"``) overrides the shape, as
in the reference. Every mesh comes from a function call: importing this
module starts no process group.

:func:`start_fake_world` starts the process group the dry run lowers on:
PyTorch's ``fake`` backend, one process that plays rank 0 of a world of
any size, whose collectives move nothing. Its store,
``torch.testing._internal.distributed.fake_pg.FakeStore``, lives in
PyTorch's internal testing package (present in torch 2.11 and 2.13).
"""
from __future__ import annotations

import os


def _mesh(shape, axes, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_mesh_shape(multi_pod: bool = False) -> tuple:
    """``(shape, axes)`` of the production mesh, after the
    ``REPRO_TEST_MESH`` override."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    override = os.environ.get("REPRO_TEST_MESH")      # e.g. "2x2" or "2x2x2"
    if override:
        shape = tuple(int(x) for x in override.split("x"))
        axes = ("pod", "data", "model")[-len(shape):]
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production mesh over the current process group, whose world
    size must be the mesh's size."""
    return _mesh(*production_mesh_shape(multi_pod), device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type="cuda"):
    """Small mesh for tests and one-card runs (``(1, 1)``)."""
    return _mesh(shape, axes, device_type)


def prepare_groups(mesh) -> None:
    """Create ahead the flattened groups the runs gather and reduce over
    (the data axes together; the data axes with ``model``): building one
    reads the mesh's rank map, which a fake-tensor run cannot."""
    from repro_torch.distributed.sharding import axis_group, data_axes
    dp = data_axes(mesh)
    combos = [dp]
    if "model" in mesh.mesh_dim_names:
        combos.append(dp + ("model",))
    for axes in combos:
        if len(axes) > 1:
            axis_group(mesh, axes)


def required_devices(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def start_fake_world(world_size: int) -> None:
    """Start (or restart at another size) the ``fake`` process group as
    rank 0 of ``world_size`` ranks: every collective returns at once and
    moves nothing, so one process can run a step of a 256- or 512-rank
    mesh on fake tensors."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size \
                and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
