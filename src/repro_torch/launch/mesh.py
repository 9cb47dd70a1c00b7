"""Device meshes over a process group (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.DeviceMesh`` whose dimensions carry the
reference's axis names. Meshes are made by FUNCTIONS, never at import, and
every mesh needs a process group of exactly its size, which the caller
initialises (``process_group``, ``fake_process_group``) or a launcher such
as ``torchrun`` did.

Mesh geometry, as in the reference:

    single-pod : (data=16, model=16)            = 256 devices
    multi-pod  : (pod=2, data=16, model=16)     = 512 devices

The dry run backs a production mesh with PyTorch's ``fake`` process group:
one process stands for rank 0 of the whole mesh, collectives move no data,
and the tensors it runs are fake (``FakeTensorMode``). On H100 hosts of 8
GPUs a ``model`` group of 16 spans two NVLink domains
(``roofline.analysis`` charges its link accordingly).

A ``cuda`` mesh needs a card: without one ``make_host_mesh`` raises, and
never falls back to the CPU. The fake group is the one exception: it
touches no device.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``names`` over the initialised process
    group, whose world size must be the mesh's size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(process_group or fake_process_group)")
    size = 1
    for s in shape:
        size *= int(s)
    if size != dist.get_world_size():
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {size} "
                         f"ranks, the process group has "
                         f"{dist.get_world_size()}")
    if (device_type == "cuda" and not torch.cuda.is_available()
            and dist.get_backend() != "fake"):
        raise RuntimeError("a cuda mesh needs a card: "
                           "torch.cuda.is_available() is False")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(*, model: int = 1, device_type: str = "cuda"
                   ) -> DeviceMesh:
    """(world // model, model) mesh over ("data", "model"): one card per
    rank under NCCL, or CPU ranks under gloo (``device_type="cpu"``)."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model groups of "
                         f"{model}")
    return make_mesh((n // model, model), ("data", "model"), device_type)


@contextlib.contextmanager
def process_group(backend: str, world_size: int, rank: int,
                  init_file: str) -> Iterator[None]:
    """Initialise the default process group from a ``file://`` store (a
    path that no earlier group used) and destroy it on exit. Under
    ``nccl`` each rank takes card ``rank``."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world_size, rank=rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A ``fake`` process group of ``world_size`` ranks in this process
    (rank 0): meshes of that size build, collectives are recorded and move
    nothing. Destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()

