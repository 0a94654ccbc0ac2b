"""Device meshes of the port: one controller drives every shard.

A ``Mesh`` names its axes (``pod`` and ``data`` are batch axes, ``model``
the tensor-parallel axis, as in the reference) and holds one
``torch.device`` per shard, row-major over the axes. Devices may repeat:
``["cpu"] * 4`` in the tests, ``["cuda:0"] * 4`` on one card,
``cuda:0``..``cuda:3`` on a host with four cards. Each shard keeps its
partition of the weights and of the block pool as separate allocations
on its device, and every collective is an explicit copy, concatenation,
ordered sum or max across the shards' tensors (``dist.sharding``,
``dist.collectives``, ``dist.ring``). One Python process drives them all,
as the reference's single-controller JAX does; a process group per card
could not put its collectives on one card (NCCL refuses two ranks on one
GPU, and gloo has no CUDA all-gather).

An explicit device list is the port's counterpart of the reference's
``--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape``: axis -> size, in axis order; ``devices``: one per shard,
    row-major over the axes (the last axis fastest), repeats allowed."""

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        object.__setattr__(self, "shape", dict(self.shape))
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        if len(self.devices) != self.size:
            raise ValueError(f"a mesh of shape {self.shape} needs "
                             f"{self.size} devices, got {len(self.devices)}")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def home(self) -> torch.device:
        """The controller's device: replicated values live here."""
        return self.devices[0]

    def coords(self, i: int) -> Dict[str, int]:
        """The axis coordinates of shard ``i``."""
        out = {}
        for a in reversed(self.axis_names):
            i, out[a] = divmod(i, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def index(self, **coords: int) -> int:
        """The shard at ``coords`` (an axis left out is at 0)."""
        i = 0
        for a in self.axis_names:
            i = i * self.shape[a] + coords.get(a, 0)
        return i

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis`` with every other coordinate 0."""
        return tuple(self.devices[self.index(**{axis: j})]
                     for j in range(self.shape.get(axis, 1)))


def _cuda_devices() -> Tuple[torch.device, ...]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return tuple(torch.device("cuda", i) for i in range(n))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``: over ``devices`` (exactly one a
    shard, repeats allowed), or with ``devices=None`` over the first
    prod(shape) visible CUDA devices (raising when there are fewer)."""
    n = math.prod(shape)
    if devices is None:
        have = _cuda_devices()
        if len(have) < n:
            raise RuntimeError(
                f"a mesh of {n} devices needs {n} CUDA devices, "
                f"{len(have)} visible; pass devices=[...] (repeats allowed, "
                f"e.g. [\"cpu\"] * {n}) for a mesh of repeated devices")
        devices = have[:n]
    return Mesh(dict(zip(axes, shape)), tuple(devices))


def make_serving_mesh(mcfg, devices: Optional[Sequence[Device]] = None
                      ) -> Mesh:
    """Mesh for the sharded serving engine (ServeConfig.mesh): axes
    ("data", "model") of shape (mcfg.data, mcfg.model) over ``devices``,
    or with ``devices=None`` over the first data*model visible CUDA
    devices.

    Raises if fewer devices are visible than the config asks for —
    serving must never silently run a smaller mesh than it advertised.
    A device list with repeats (``["cuda:0"] * 4``) runs the mesh's
    shards on one card."""
    need = mcfg.n_devices
    if devices is None:
        have = len(_cuda_devices())
        if have < need:
            raise ValueError(
                f"MeshConfig(model={mcfg.model}, data={mcfg.data}) needs "
                f"{need} devices, only {have} visible (pass devices=[...] "
                f"with repeats, e.g. [\"cuda:0\"] * {need}, for a mesh of "
                f"shards on one device)")
    return make_mesh((mcfg.data, mcfg.model), ("data", "model"), devices)


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh as a plan (axis -> size): one pod
    of 16 x 16 chips, axes (data, model); or two pods, axes (pod, data,
    model). No device is touched."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def mesh_info(mesh: Mesh) -> dict:
    return {"shape": dict(mesh.shape), "n_devices": mesh.size,
            "axes": list(mesh.axis_names)}


__all__ = ["Mesh", "make_mesh", "make_production_mesh", "make_serving_mesh",
           "mesh_info"]
