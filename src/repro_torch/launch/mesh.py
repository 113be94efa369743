"""Meshes (port of ``src/repro/launch/mesh.py``) and the roofline's
hardware constants for the NVIDIA H100.

The production meshes keep the reference's axis names and shapes, so that
plans compare across the two packages: 16×16 (``data``, ``model``), 256
GPUs, and 2×16×16 (``pod``, ``data``, ``model``), 512. On H100s, 16×16 is
32 nodes of 8 GPUs: each node's 8 GPUs share NVLink 4, so a 16-wide
``model`` axis spans two nodes and its collectives cross the InfiniBand
network between them, as every ``data`` and ``pod`` collective does. The
roofline prices every collective at that network's per-GPU rate.

``make_production_mesh`` builds a DeviceMesh on the ``fake`` process-group
backend: ranks without devices, on which DTensor programs run under a
``FakeTensorMode`` and record their collectives without sending anything.
``abstract_production_mesh`` is the same shape as an ``AbstractMesh`` (no
process group), enough to plan. ``make_debug_mesh`` is 1×N over real
cards. Nothing here touches ``torch.distributed`` at import time.
"""
from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Optional

from repro_torch.sharding import AbstractMesh, mesh_shape

# H100 SXM hardware constants (roofline terms), from NVIDIA's data sheet
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12  # bytes/s per GPU
# bytes/s per GPU between nodes: one NDR InfiniBand port, 400 Gb/s. NVLink 4
# gives 450 GB/s each way inside a node of 8, but a 16-wide axis spans two
# nodes, so its ring runs at the network's rate.
LINK_BW = 50e9

_SHAPES = {False: ((16, 16), ("data", "model")),
           True: ((2, 16, 16), ("pod", "data", "model"))}
_STORE_DIR = Path(__file__).resolve().parents[3] / "build" / "dist"


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape, names = _SHAPES[multi_pod]
    return AbstractMesh(shape, names)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh on the ``fake`` backend (``make_fake_mesh``)."""
    return make_fake_mesh(*_SHAPES[multi_pod])


def make_fake_mesh(shape, names):
    """A DeviceMesh of ``shape`` on the ``fake`` backend, this process rank
    0. Initialises the default process group (fake, of the mesh's size), or
    re-initialises a fake one of another size; any other default group is
    an error."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"the default process group is {dist.get_backend()!r}: "
                               "a fake mesh needs the fake backend")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def make_debug_mesh(devices: Optional[int] = None, *, device_type: str = "cuda"):
    """1×N mesh (``data``, ``model``) over the world's ranks, one device
    each. With no process group yet, this process becomes a world of one
    (NCCL for cuda, gloo for cpu) that meets through a FileStore under the
    checkout's ``build/dist``; ``devices`` must then be 1 (the default)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        if devices not in (None, 1):
            raise ValueError(f"a world of one process spans one device, not {devices}")
        if device_type == "cuda":
            import torch

            torch.cuda.set_device(0)
        _STORE_DIR.mkdir(parents=True, exist_ok=True)
        path = _STORE_DIR / f"store-{os.getpid()}"
        path.unlink(missing_ok=True)
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.FileStore(str(path), 1), rank=0, world_size=1)
    n = dist.get_world_size() if devices is None else devices
    return init_device_mesh(device_type, (1, n), mesh_dim_names=("data", "model"))


def mesh_chips(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())
