"""Device meshes with named axes — the port of ``repro.launch.mesh``.

The reference builds its meshes with ``jax.make_mesh``; the port keeps a
small description of one (axis names, shape, devices). The model code
takes a mesh of size 1, where the reference's sharding constraints,
``shard_map`` bodies and collectives over its axes are the identity; a
larger mesh raises (more than one card stays unverified).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch import resolve_device


@dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: tuple
    devices: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{len(self.axis_names)} axis names for a mesh "
                             f"of shape {self.shape}")
        if len(self.devices) != math.prod(self.shape):
            raise ValueError(f"a mesh of shape {self.shape} needs "
                             f"{math.prod(self.shape)} devices, got "
                             f"{len(self.devices)}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh over this host's CUDA cards: 256 chips as
    (data=16, model=16), or 2 pods x 256 as (pod=2, data=16, model=16).
    Refuses to build on fewer cards than it names."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise RuntimeError(f"the production mesh {dict(zip(axes, shape))} "
                           f"names {need} cards; this host has {have}")
    return Mesh(axes, shape, tuple(torch.device("cuda", i)
                                   for i in range(need)))


def make_host_mesh(device=None) -> Mesh:
    """A one-device mesh with the production axis names, so the same
    sharded code paths run on one card or the CPU (``cuda`` unless
    ``device`` is given)."""
    return Mesh(("data", "model"), (1, 1), (resolve_device(device),))
