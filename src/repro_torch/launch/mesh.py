"""Mesh builders on ``torch.distributed`` (functions, not module
constants: importing this module never touches the process group).

Port of ``repro.launch.mesh``. The world comes from torchrun's
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` (``env://`` rendezvous at
``MASTER_ADDR:MASTER_PORT``); with none of them set it is one rank on a
``file://`` rendezvous in a temporary directory. A process group that the
caller initialized itself is used as it is. The backend is NCCL when the
mesh lives on the card and gloo on the CPU. A mesh whose size is not the
world size raises, naming both: ``make_production_mesh`` does that on
fewer than 256 / 512 ranks, as JAX's does on too few devices.
"""
from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import resolve_device
from repro_torch.distributed.sharding import axis_sizes


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def init_world(device_type: str = "cuda") -> bool:
    """Initialize the default process group unless it already is: NCCL
    for ``device_type="cuda"`` (the card ``cuda:LOCAL_RANK`` made current),
    gloo for ``"cpu"``. Returns whether this call initialized it (the
    caller then owns its ``destroy_process_group``). ``"cuda"`` without a
    card raises, as the port's entry points do."""
    if dist.is_initialized():
        return False
    resolve_device(device_type)       # a card asked for and absent raises
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(local_rank())
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
        atexit.register(shutil.rmtree, tmp, True)
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            rank=0, world_size=1)
    return True


def _mesh(shape, names, device_type: str) -> DeviceMesh:
    init_world(device_type)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(
            f"a {dict(zip(names, shape))} mesh needs {math.prod(shape)} "
            f"ranks; the world has {world}")
    # the mesh's device type follows the group's backend: a gloo world keeps
    # its mesh on the CPU even where its tensors live on a card
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(mesh_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the world's ranks — for tests."""
    return _mesh((data, model), ("data", "model"), device_type)


def make_fleet_mesh(n_devices: Optional[int] = None, n_pods: int = 1,
                    device_type: str = "cuda") -> DeviceMesh:
    """The fleet-training (pod, data) mesh over ``n_devices`` ranks
    (default: the world). The ``pod`` axis mirrors the FL hierarchy: it
    takes ``n_pods`` ranks when that divides the rank count (per-pod base
    networks then live one pod per slice); otherwise pods replicate and
    agents split over ``data`` alone."""
    init_world(device_type)
    n = dist.get_world_size() if n_devices is None else n_devices
    pod = n_pods if n_pods > 0 and n % n_pods == 0 else 1
    return _mesh((pod, n // pod), ("pod", "data"), device_type)


def mesh_axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)
