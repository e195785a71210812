#!/usr/bin/env python3
"""How many PyTorch operations the port's tick dispatches, outside its
kernel calls, on the CPU.

Steps ``ai_full`` on a 3-tier k=6 fat tree (27 hosts, two permutations,
F = 54 flows), as ``--batch`` scenarios of one tick (seeds 0x5EED + b),
and counts, with a ``TorchDispatchMode``, the ATen
operations each tick dispatches (views included), leaving out those
inside the ``repro_torch.kernels.ops`` entry points, which a card runs
as one kernel each. On a card, each counted operation that is not a view
is one device operation, so the count tracks
``scripts/torch_port_profile.py``'s device operations per tick without
a card. It is a count, not a time.

With ``--faulted`` the tick is ``resilient()`` (RTO backoff, EV
eviction, PDC teardown) with ``ooo_threshold=24`` over faulted lanes
that build every fault static (gray links and PHY corruption on edge
switch 0's and 1's uplinks, host 0 dead and host 1's NIC stalled from
tick 8, edge 0's first uplink dead), as ``chip_smoke.py``'s faulted
batch does at full width.

    PYTHONPATH=src python3 scripts/torch_port_opcount.py [--ticks 32] \
        [--batch 1] [--faulted]

Run with another tree's ``src`` on ``PYTHONPATH`` to count that tree.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops
from repro_torch.network import fabric
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import fat_tree3

KERNEL_ENTRIES = ("sack_fused", "sack_advance", "nack_mark",
                  "sack_fused_own", "sack_advance_own", "nack_mark_lanes_",
                  "set_own_bit_", "clear_own_bit_")


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.n += 1
        return func(*args, **(kwargs or {}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=32)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--faulted", action="store_true")
    args = ap.parse_args()
    g = fat_tree3(k=6, pods=3)
    h = np.arange(27, dtype=np.int32)
    wl = fabric.Workload.stack([fabric.Workload.of(
        np.concatenate([h, h]), np.concatenate([(h + 9) % 27, (h + 3) % 27]),
        64, device="cpu")] * args.batch)
    if args.faulted:
        p = fabric.SimParams(timeout_ticks=64, ooo_threshold=24)
        prof = TransportProfile.resilient()
        up0 = [int(q) for q in g.up1_table[0, :]]
        up1 = [int(q) for q in g.up1_table[1, :]]
        one = (FaultSchedule.healthy(g.num_queues, num_hosts=g.num_hosts)
               .lossy(up0, 0.01).corrupt(up1, 0.01).host_fail(0, 8)
               .nic_stall(1, 8).flap(up0[0], 0))
        fault = FaultSchedule.stack([one.with_seed(b)
                                     for b in range(args.batch)])
    else:
        p, prof = fabric.SimParams(), TransportProfile.ai_full()
        fault = FaultSchedule.healthy(g.num_queues, batch=args.batch,
                                      device="cpu")
    step = fabric.make_step(g, prof, p, int(wl.src.shape[1]),
                            lossy=fault.has_loss,
                            hosty=fault.has_host_faults,
                            corrupty=fault.has_corruption, device="cpu")
    s = fabric.init_state(g, wl, prof, p,
                          fabric.DEFAULT_SEED + np.arange(args.batch),
                          device="cpu")
    for tick in range(args.ticks):            # past the start-up ticks
        s, _ = step(s, tick, wl, fault)
    count = _Count()
    for name in KERNEL_ENTRIES:
        fn = getattr(ops, name, None)
        if fn is None:
            continue

        def paused(*a, _fn=fn, **kw):
            count.paused = True
            try:
                return _fn(*a, **kw)
            finally:
                count.paused = False
        setattr(ops, name, paused)
    with count:
        for tick in range(args.ticks, 2 * args.ticks):
            s, _ = step(s, tick, wl, fault)
    print(f"{g.name} F={int(wl.src.shape[1])} B={args.batch} "
          f"{prof.name}{' faulted' if args.faulted else ''}: "
          f"{count.n / args.ticks:.1f} ATen ops per tick outside the kernel "
          f"entry points (ticks {args.ticks}..{2 * args.ticks - 1}, "
          f"torch {torch.__version__}, CPU)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
