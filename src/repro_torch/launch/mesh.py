"""Meshes.  Functions, not constants: importing this module touches no
device and no process group.

A `jax.sharding.Mesh` plays three parts in the reference; the port keeps
them apart:

  * `make_production_mesh`: the abstract (16,16) / (2,16,16) mesh of the
    dry run (`launch/lowering.py`), axis names and sizes only; nothing is
    allocated and no process group is built;
  * `make_serving_mesh`, `make_host_mesh`: a single-controller mesh over
    local devices, across which `VisionEngine(mesh=)` splits each step's
    batch;
  * `make_device_mesh`: a `DeviceMesh` over the ranks of an initialized
    process group (`torch.distributed`), for the compressed all-reduce and
    the checkpoint's elastic restore.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over a grid of devices (row-major in `devices`), or over
    none (`devices` None: an abstract mesh)."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...] | None = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} but sizes {self.axis_sizes}")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of {self.size}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16,16) ("data","model") single pod = 256 chips;
    multi_pod -> (2,16,16) ("pod","data","model") = 512 chips.  Abstract."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def _local_devices(devices) -> tuple[torch.device, ...]:
    """`devices` as torch devices; by default every CUDA device (raises
    where there is none: the CPU only when asked for)."""
    if devices is None:
        resolve_device("cuda")
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return tuple(resolve_device(d) for d in devices)


def make_host_mesh(model_axis: int = 1, devices=None) -> Mesh:
    """A small ("data","model") mesh over the local devices (tests, examples)."""
    devs = _local_devices(devices)
    return Mesh(("data", "model"), (len(devs) // model_axis, model_axis),
                devs[:len(devs) // model_axis * model_axis])


def make_serving_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Pure data-parallel serving mesh: all (or the first `n_devices`) local
    devices on one "data" axis, the vision engine's batch DP mesh.  A test
    may pass `devices=["cpu"] * 8`: eight shards, each on the CPU."""
    devs = _local_devices(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(("data",), (len(devs),), devs)


def make_device_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...]):
    """`init_device_mesh` over the initialized process group: CUDA devices
    under NCCL (each rank on its current device), the CPU under gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh: no process group is initialized")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))
