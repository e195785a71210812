"""ECMP hashing and per-hop routing (Sec. 2.1) — the port of
``repro.network.ecmp``.

Switches pick one of a set of equal-cost ports with a deterministic hash
of (src, dst, EV, switch salt): ``p = H(x) mod n_ports``. The hash state
is uint32 held as int32 bit patterns, so the modulus is unsigned
(:func:`repro_torch._u32.umod`): a signed ``%`` by a fanout that is not a
power of two is wrong whenever the hash has its top bit set.
"""
from __future__ import annotations

import torch

from repro_torch._u32 import c32, shr, umod
from repro_torch.network.topology import QueueGraph, Stage

DELIVERED = -2


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
        """First queue for a packet injected at host `src` toward `dst`."""
        sleaf = self.host_leaf[src]
        dleaf = self.host_leaf[dst]
        h = umod(ecmp_hash(src, dst, ev, sleaf), self.g.fanout1)
        up = self.up1[sleaf, h]
        return torch.where(sleaf == dleaf, self.host_queue[dst], up)

    def route_step(self, queue: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
        """Next queue for packets just dequeued from `queue`; DELIVERED
        for packets leaving a HOST queue. Table lookups clamp their row
        index where the reference relies on JAX's clamped gather."""
        st = self.stage[queue]
        sw = self.next_switch[queue]  # switch the packet is *now* at
        dleaf = self.host_leaf[dst]

        if not self.three_level:
            L = self.up1.shape[0]
            nxt_up1 = self.down1[(sw - L).clamp(0, self.down1.shape[0] - 1),
                                 dleaf]
            nxt_down1 = self.host_queue[dst]
            out = torch.where(st == Stage.UP1, nxt_up1,
                              torch.where(st == Stage.DOWN1, nxt_down1,
                                          DELIVERED))
            return torch.where(st == Stage.HOST, DELIVERED, out)

        L = self.up1.shape[0]            # leaves
        A = self.down1.shape[0]          # aggs
        Lp = self.leaves_per_pod
        Ap = self.aggs_per_pod
        half = self.up2.shape[1]
        dpod = self.host_pod[dst]

        # at agg (arrived via UP1): same pod -> DOWN1; else UP2 via hash
        agg = (sw - L).clamp(0, A - 1)
        dleaf_local = dleaf % Lp
        go_down = self.down1[agg, dleaf_local]
        go_up = self.up2[agg, umod(ecmp_hash(src, dst, ev, sw), half)]
        nxt_up1 = torch.where(torch.div(agg, Ap, rounding_mode="floor")
                              == dpod, go_down, go_up)
        # at core (arrived via UP2): down to the destination pod's agg
        core = (sw - L - A).clamp(0, self.down2.shape[0] - 1)
        nxt_up2 = self.down2[core, dpod]
        # at agg (arrived via DOWN2) the next hop is go_down; at a leaf
        # (arrived via DOWN1) it is the host downlink
        nxt_down1 = self.host_queue[dst]
        return torch.where(
            st == Stage.UP1, nxt_up1,
            torch.where(st == Stage.UP2, nxt_up2,
                        torch.where(st == Stage.DOWN2, go_down,
                                    torch.where(st == Stage.DOWN1, nxt_down1,
                                                DELIVERED))))
