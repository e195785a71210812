"""Fault generator: scenario b takes fault class b mod 4, the four
classes of ``chip_smoke.fault_schedule`` (the faulted batch under
``TransportProfile.resilient()``):

0. gray loss ``loss_p`` on every uplink of one edge switch;
1. a host dead from ``host_fail_at`` for good, and another host's NIC
   stalled over ``nic_stall`` = [from, to);
2. PHY corruption ``corrupt_p`` on every uplink of another edge switch,
   with no link layer to replay it;
3. all of these, plus the first edge's first uplink dead from
   ``flap_at`` for good.

The two edge switches, the two hosts and every scenario's fault-draw
seed come from the generator ``rng``; the lanes are plain numpy arrays
in the layout of a ``FaultSchedule`` ([B, Q] queue lanes, [B, H] host
lanes, [B] uint32 seeds), so the program and the reference are each
built from the same arrays.
"""
from __future__ import annotations

import numpy as np

from portbench.reference.uet_types import NEVER_TICK

CLASSES = 4


def generate(rng: np.random.Generator, topo, lanes: int, spec: dict) -> dict:
    Q, H = int(topo.num_queues), int(topo.num_hosts)
    up1 = np.asarray(topo.up1_table)
    edge_a, edge_b = rng.choice(up1.shape[0], size=2, replace=False)
    dead, stalled = rng.choice(H, size=2, replace=False)
    seeds = rng.integers(0, 2 ** 32, size=lanes, dtype=np.uint64)
    out = {
        "fail_at": np.full((lanes, Q), NEVER_TICK, np.int32),
        "heal_at": np.full((lanes, Q), NEVER_TICK, np.int32),
        "loss_p": np.zeros((lanes, Q), np.float32),
        "corrupt_p": np.zeros((lanes, Q), np.float32),
        "seed": seeds.astype(np.uint32),
        "host_fail_at": np.full((lanes, H), NEVER_TICK, np.int32),
        "host_heal_at": np.full((lanes, H), NEVER_TICK, np.int32),
        "nic_stall_at": np.full((lanes, H), NEVER_TICK, np.int32),
        "nic_heal_at": np.full((lanes, H), NEVER_TICK, np.int32),
    }
    stall_from, stall_to = (int(t) for t in spec["nic_stall"])
    classes = np.arange(lanes) % CLASSES
    for b, c in enumerate(classes):
        if c in (0, 3):
            out["loss_p"][b, up1[edge_a]] = np.float32(spec["loss_p"])
        if c in (1, 3):
            out["host_fail_at"][b, dead] = int(spec["host_fail_at"])
            out["nic_stall_at"][b, stalled] = stall_from
            out["nic_heal_at"][b, stalled] = stall_to
        if c in (2, 3):
            out["corrupt_p"][b, up1[edge_b]] = np.float32(spec["corrupt_p"])
        if c == 3:
            out["fail_at"][b, up1[edge_a, 0]] = int(spec["flap_at"])
    out["classes"] = classes
    out["hit"] = {"edges": [int(edge_a), int(edge_b)],
                  "dead_host": int(dead), "stalled_host": int(stalled)}
    return out
