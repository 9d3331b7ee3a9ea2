"""Device meshes over a ``torch.distributed`` process group.

Port of ``src/repro/launch/mesh.py``.  Axes: ('pod', 'data', 'model').
'pod' carries only DP whose gradient all-reduce is the sole cross-pod
collective; 'data' is FSDP; 'model' is TP.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with those dim names, one
rank a device: it spans the initialized process group, where the
reference's spans ``jax.devices()``.

:func:`init_distributed` starts the group a launcher runs under from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``): NCCL on CUDA, gloo on the CPU.  Nothing in this module
runs at import.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.kernels.logic_dsp.ops import resolve_device

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_for(device=None) -> str:
    """The collective backend of ``device`` (CUDA unless ``"cpu"``): NCCL
    on CUDA, gloo on the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def distributed_env() -> bool:
    """Whether this process was started by torchrun (or anything that
    sets its four variables)."""
    return all(k in os.environ for k in _ENV)


def init_distributed(device=None) -> torch.device:
    """Join the process group that torchrun's environment names, once
    (``init_method="env://"``), and return this rank's device: on CUDA
    the card ``LOCAL_RANK`` names, made current; on the CPU the CPU.
    Raises when the environment names no group."""
    dev = resolve_device(device)
    if not distributed_env():
        raise RuntimeError(
            "no process group to join: set " + ", ".join(_ENV) +
            " (torchrun does) or run one process without a mesh")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(dev), init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def init_single_process(device=None) -> torch.device:
    """Start a process group of this process alone (rank 0 of 1, on a
    free localhost port), for a mesh of one rank without torchrun, and
    return the device; :func:`destroy` ends it."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(dev), rank=0, world_size=1,
                                init_method=f"tcp://localhost:{free_port()}")
    return dev


def destroy() -> None:
    """End this process's group, if it has one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh spans the process group: initialize it "
                           "first (init_distributed, or "
                           "torch.distributed.init_process_group)")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: (data 16, model 16), or (pod 2, data 16,
    model 16) with ``multi_pod``, over a group of exactly that many
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = _world()
    if world != n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, the process "
                           f"group has {world}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device=None):
    """(data, model) = (world // model, model) over the whole process
    group; ``model`` must divide the world size."""
    world = _world()
    if model < 1 or world % model:
        raise ValueError(f"--model-parallel {model} does not divide the "
                         f"process group's {world} ranks: no (data, model) "
                         f"mesh of that size exists")
    return init_device_mesh(resolve_device(device).type,
                            (world // model, model),
                            mesh_dim_names=("data", "model"))
