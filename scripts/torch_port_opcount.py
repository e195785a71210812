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

    PYTHONPATH=src python3 scripts/torch_port_opcount.py [--ticks 32] \
        [--batch 1]

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
    args = ap.parse_args()
    g = fat_tree3(k=6, pods=3)
    h = np.arange(27, dtype=np.int32)
    wl = fabric.Workload.stack([fabric.Workload.of(
        np.concatenate([h, h]), np.concatenate([(h + 9) % 27, (h + 3) % 27]),
        64, device="cpu")] * args.batch)
    p, prof = fabric.SimParams(), TransportProfile.ai_full()
    fault = FaultSchedule.healthy(g.num_queues, batch=args.batch,
                                  device="cpu")
    step = fabric.make_step(g, prof, p, int(wl.src.shape[1]), device="cpu")
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
    print(f"{g.name} F={int(wl.src.shape[1])} B={args.batch} ai_full: "
          f"{count.n / args.ticks:.1f} ATen ops per tick outside the kernel "
          f"entry points (ticks {args.ticks}..{2 * args.ticks - 1}, "
          f"torch {torch.__version__}, CPU)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
