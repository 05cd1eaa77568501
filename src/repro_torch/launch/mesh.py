"""Device meshes over a process group.

Port of ``repro.launch.mesh``. The single-pod production mesh is 16x16 =
256 ranks (``data`` x ``model``); the multi-pod mesh prepends a ``pod``
axis: 2 x 16 x 16 = 512. Data parallelism spans (pod, data);
tensor/expert parallelism spans ``model``.

``make_host_mesh`` builds a small ``("data", "model")`` ``DeviceMesh`` over
the process group's world, on the card (NCCL) unless the caller asks for
the CPU (gloo). Under ``torchrun`` the launched group is used; with no group
it starts a one-rank group of its own. ``make_production_mesh`` builds the
full layouts over a launched world of that size, or, outside one, over a
fake process group: every collective is a no-op there, so the dry run
traces one rank's program without 256 processes. Both are functions, so
importing this module touches no process group.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

FAKE_BACKEND = "fake"


def _init_fake_world(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0
    (``torch.testing``'s ``FakeStore``: collectives return at once)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=0, world_size=world_size)


def _mesh(device_type: str, shape, names) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) with ``"pod"`` first,
    over a launched world of 256 (512) ranks, or else a fake one (a fake
    world of another size is replaced)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    if dist.is_initialized() and dist.get_world_size() != n:
        if dist.get_backend() != FAKE_BACKEND:
            raise RuntimeError(f"make_production_mesh: a launched world of "
                               f"{dist.get_world_size()} ranks, not {n}")
        dist.destroy_process_group()
    if not dist.is_initialized():
        _init_fake_world(n)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return _mesh(device_type, shape, axes)


def _init_host_world(device: torch.device) -> None:
    """The launched world (``torchrun``'s environment), else one rank."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> DeviceMesh:
    """Small mesh over the process group's world (clamped to its size, as the
    reference clamps to ``len(jax.devices())``). ``device`` None means the
    card; without CUDA that raises rather than falling back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh: CUDA is not available; the mesh is on the "
                               "card by default (pass device='cpu' to ask for the CPU)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    if not dist.is_initialized():
        _init_host_world(device)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(1, n // data))
    return _mesh(device.type, (data, model), ("data", "model"))
