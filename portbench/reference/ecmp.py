"""ECMP hashing and per-hop routing (Sec. 2.1) — the port of
``repro.network.ecmp``.

Switches pick one of a set of equal-cost ports with a deterministic hash
of (src, dst, EV, switch salt): ``p = H(x) mod n_ports``. The hash state
is uint32 held as int32 bit patterns, so the modulus is unsigned
(:func:`repro_torch._u32.umod`): a signed ``%`` by a fanout that is not a
power of two is wrong whenever the hash has its top bit set.

``RoutingTables.injection_queue`` and ``route_step`` are the tick's
routing walks; their arithmetic is ``repro_torch.kernels.ref``'s
``ecmp_inject_ref`` / ``ecmp_route_ref``, and on a card each call is one
launch of its CUDA kernel (``kernels.ops.ecmp_inject`` / ``ecmp_route``).
"""
from __future__ import annotations

import torch

from .u32 import c32, shr
from .topology import QueueGraph

DELIVERED = -2
INVALID = -1


def ecmp_hash(src: torch.Tensor, dst: torch.Tensor, ev: torch.Tensor,
              salt: torch.Tensor) -> torch.Tensor:
    """Deterministic well-mixed 32-bit hash of the ECMP field set (int32
    tensors, broadcastable; uint32 result as an int32 pattern)."""
    x = (src * c32(0x9E3779B1) ^ dst * c32(0x85EBCA77)
         ^ ev * c32(0xC2B2AE3D) ^ salt * c32(0x27D4EB2F))
    x = x ^ shr(x, 15)
    x = x * c32(0x2C1B3C6D)
    x = x ^ shr(x, 12)
    x = x * c32(0x297A2D39)
    return x ^ shr(x, 15)


class RoutingTables:
    """Device-resident copies of the QueueGraph routing arrays."""

    def __init__(self, g: QueueGraph, device: torch.device):
        def t(a):
            return torch.as_tensor(a, dtype=torch.int32).to(device)

        self.g = g
        self.stage = t(g.stage)
        self.host_queue = t(g.host_queue)
        self.host_leaf = t(g.host_leaf)
        self.host_pod = t(g.host_pod)
        self.up1 = t(g.up1_table)
        self.down1 = t(g.down1_table)
        self.up2 = t(g.up2_table) if g.up2_table.size else None
        self.down2 = t(g.down2_table) if g.down2_table.size else None
        self.next_switch = t(g.queue_next_switch)
        self.three_level = g.up2_table.size > 0
        self.leaves_per_pod = (g.down1_table.shape[1]
                               if self.three_level else 1)
        self.aggs_per_pod = g.fanout1

    def injection_queue(self, src: torch.Tensor, dst: torch.Tensor,
                        ev: torch.Tensor) -> torch.Tensor:
        """First queue for a packet injected at host `src` toward `dst`
        (``ops.ecmp_inject``: one kernel launch on a card)."""
        from . import kops as ops
        return ops.ecmp_inject(self, src, dst, ev)

    def route_step(self, queue: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
        """Next queue for packets just dequeued from `queue`; DELIVERED
        for packets leaving a HOST queue (``ops.ecmp_route``: one kernel
        launch on a card). Table lookups clamp their row index where the
        reference relies on JAX's clamped gather."""
        from . import kops as ops
        return ops.ecmp_route(self, queue, src, dst, ev)
