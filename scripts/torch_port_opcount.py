#!/usr/bin/env python3
"""How many PyTorch operations the port's tick dispatches, outside its
kernel calls, on the CPU.

Steps ``ai_full`` on a 3-tier k=6 fat tree (27 hosts, two permutations,
F = 54 flows), as ``--batch`` scenarios of one tick (seeds 0x5EED + b),
and counts, with a ``TorchDispatchMode``, the ATen
operations each tick dispatches (views included, and the ones that are
not views apart), leaving out those
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

With ``--inc`` the profile is ``ai_full`` with ``inc=True`` and the
traffic three concurrent tree all-reduces of nine hosts each (group j =
hosts {j + 3 i}, 64 packets a rank, F = 48); scenario b carries the
groups' ``red`` ids when b is even and ``red = -1`` when it is odd, as
``chip_smoke.py``'s collectives phase does. With ``--link llr`` or
``--link cbfc`` the tick has ``LinkConfig.on(llr=True)`` (and
``cbfc=True``) and even scenarios 1 % BER on edge switch 1's uplinks,
as its link phase does.

With ``--traffic`` the graph is ``chip_smoke.py``'s full-width
``fat_tree3(k=16, pods=16)`` and the traffic its traffic phase's train
step: the deepseek-coder-33b ``train_4k`` plan at dp = tp = 16 compiled
by ``repro_torch.network.traffic.compile_step`` (F = 136 dep-chained
flows) under ``ai_full``.

With ``--telemetry`` the same ticks are counted again with
``TelemetrySpec.on(probe_every=16, slots=16)``: the tick's probe plus
the probe carry's update (``repro_torch.network.telemetry``), split into
probe ticks (a multiple of ``probe_every``) and the others.

With ``--profile hpc`` or ``--profile ai_base`` the healthy tick runs
that profile of the paper's table (hybrid NSCC + RCCC, all-ROD, REPS;
RCCC) instead of ``ai_full``.

    PYTHONPATH=src python3 scripts/torch_port_opcount.py [--ticks 32] \
        [--batch 1] [--profile ai_full|hpc|ai_base] \
        [--faulted | --inc | --link llr|cbfc | --traffic] [--telemetry]

``tick_op_counts`` is the count itself, for a test to call.

Run with another tree's ``src`` on ``PYTHONPATH`` to count that tree.
"""
from __future__ import annotations

import argparse
from contextlib import contextmanager
from dataclasses import replace

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.link import LinkConfig
from repro_torch.kernels import ops
from repro_torch.network import collectives as coll
from repro_torch.network import fabric
from repro_torch.network import telemetry as telem
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import fat_tree3

#: the probe spec of ``--telemetry`` (chip_smoke.py's faulted telemetry run)
TEL_SPEC = telem.TelemetrySpec.on(probe_every=16, slots=16)
KERNEL_ENTRIES = ("sack_fused", "sack_advance", "nack_mark",
                  "sack_fused_own", "sack_advance_own", "nack_mark_lanes_",
                  "set_own_bit_", "clear_own_bit_", "nscc_ack", "nscc_epoch",
                  "ecmp_inject", "ecmp_route")


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0
        self.views = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.n += 1
            self.views += bool(getattr(func, "is_view", False))
        return func(*args, **(kwargs or {}))


@contextmanager
def _entries_paused(count: _Count):
    """Count nothing inside the ``ops`` kernel entry points while open
    (those of them that the tree on the path has)."""
    saved = {name: getattr(ops, name) for name in KERNEL_ENTRIES
             if hasattr(ops, name)}

    def pausing(fn):
        def paused(*a, **kw):
            count.paused = True
            try:
                return fn(*a, **kw)
            finally:
                count.paused = False
        return paused
    try:
        for name, fn in saved.items():
            setattr(ops, name, pausing(fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def healthy_workload(batch: int) -> fabric.Workload:
    """The default count's traffic on ``fat_tree3(k=6, pods=3)``: two
    permutations of its 27 hosts (F = 54 flows of 64 packets), as
    ``batch`` scenarios."""
    h = np.arange(27, dtype=np.int32)
    return fabric.Workload.stack([fabric.Workload.of(
        np.concatenate([h, h]),
        np.concatenate([(h + 9) % 27, (h + 3) % 27]), 64,
        device="cpu")] * batch)


def tick_op_counts(g, wl, prof, p, fault, ticks: int, link=None,
                   tel=None, non_view: "dict | None" = None) -> dict:
    """{tick: ATen operations the tick dispatched outside the kernel
    entry points} for ticks ``ticks`` .. ``2 * ticks - 1`` of ``prof``
    on ``g`` (the first ``ticks`` warm the state up), on the CPU; given
    a dict ``non_view``, also {tick: those of them that are not views}
    there."""
    B, F = (int(n) for n in wl.src.shape)
    step = fabric.make_step(g, prof, p, F, lossy=fault.has_loss,
                            hosty=fault.has_host_faults,
                            corrupty=fault.has_corruption, link=link,
                            tel=tel, device="cpu")
    tel_up = (None if tel is None else
              telem.make_update(tel, g.num_queues, F, "cpu"))
    carry = (None if tel is None else
             telem.create(tel, B, g.num_queues, F, "cpu"))
    s = fabric.init_state(g, wl, prof, p, fabric.DEFAULT_SEED + np.arange(B),
                          device="cpu", link=link)
    count = _Count()
    counts = {}
    with _entries_paused(count):
        for tick in range(2 * ticks):   # count past the start-up ticks
            count.n = count.views = 0
            with count:
                s2, out = step(s, tick, wl, fault)
                if tel_up is not None:
                    carry = tel_up(carry, s2, out["probe"], tick)
            s = s2
            if tick >= ticks:
                counts[tick] = count.n
                if non_view is not None:
                    non_view[tick] = count.n - count.views
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=32)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--profile", choices=("ai_full", "hpc", "ai_base"),
                    default="ai_full")
    ap.add_argument("--faulted", action="store_true")
    ap.add_argument("--inc", action="store_true")
    ap.add_argument("--link", choices=("llr", "cbfc"), default=None)
    ap.add_argument("--traffic", action="store_true")
    ap.add_argument("--telemetry", action="store_true")
    args = ap.parse_args()
    g = fat_tree3(k=16, pods=16) if args.traffic else fat_tree3(k=6, pods=3)
    B = args.batch
    if args.inc:
        groups = [coll.build_workload(coll.CollectiveSpec(
            "all_reduce", tuple(range(j, 27, 3)), 64), "tree")
            for j in range(3)]
        lanes = {k: [] for k in ("src", "dst", "size", "dep", "red")}
        for j, w in enumerate(groups):
            for k in lanes:
                v = getattr(w, k).numpy()
                if k == "dep":
                    v = np.where(v >= 0, v + 16 * j, -1)
                if k == "red":
                    v = np.where(v >= 0, j, -1)
                lanes[k].append(v)
        a = {k: np.concatenate(v) for k, v in lanes.items()}
        wl = fabric.Workload.stack([fabric.Workload.of(
            a["src"], a["dst"], a["size"], dep=a["dep"],
            red=a["red"] if b % 2 == 0 else None) for b in range(B)])
    elif args.traffic:
        from repro_torch import configs
        from repro_torch.distributed.plan import derive_plan
        from repro_torch.network.traffic import compile_step
        plan = derive_plan(configs.get("deepseek-coder-33b"), "train_4k",
                           dp=16, tp=16, layout="fsdp_tp")
        wl = fabric.Workload.stack([compile_step(plan, g).workload] * B)
    else:
        wl = healthy_workload(B)
    link = (None if args.link is None else
            LinkConfig.on(llr=True, cbfc=args.link == "cbfc"))
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
    elif link is not None:
        p, prof = fabric.SimParams(), TransportProfile.ai_full()
        ok = FaultSchedule.healthy(g.num_queues)
        bad = ok.corrupt([int(q) for q in g.up1_table[1, :]], 0.01)
        fault = FaultSchedule.stack([bad if b % 2 == 0 else ok
                                     for b in range(B)])
    else:
        p = fabric.SimParams()
        prof = getattr(TransportProfile, args.profile)()
        fault = FaultSchedule.healthy(g.num_queues, batch=B, device="cpu")
    if args.inc:
        prof = replace(prof, inc=True, name=prof.name + "+inc")
    F = int(wl.src.shape[1])
    label = (f"{g.name} F={F} B={args.batch} {prof.name}"
             f"{' faulted' if args.faulted else ''}"
             f"{' traffic' if args.traffic else ''}"
             f"{'' if link is None else f' link={args.link}'}")
    specs = [None] + ([TEL_SPEC] if args.telemetry else [])
    per_tick = {}
    for tel in specs:
        non_view: dict = {}
        counts = tick_op_counts(g, wl, prof, p, fault, args.ticks, link=link,
                                tel=tel, non_view=non_view)
        per_tick[tel] = counts
        n = sum(counts.values()) / len(counts)
        nv = sum(non_view.values()) / len(non_view)
        print(f"{label}{'' if tel is None else ' telemetry'}: {n:.1f} ATen "
              f"ops ({nv:.1f} not views) per tick outside the kernel entry "
              f"points (ticks "
              f"{args.ticks}..{2 * args.ticks - 1}, torch {torch.__version__},"
              f" CPU)")
    if args.telemetry:
        off, on = per_tick[None], per_tick[TEL_SPEC]
        pe = TEL_SPEC.probe_every
        for name, ticks in (("probe ticks", [t for t in on if t % pe == 0]),
                            ("other ticks", [t for t in on if t % pe])):
            d = [on[t] - off[t] for t in ticks]
            print(f"{label}: telemetry (probe_every {pe}) adds "
                  f"{np.mean(d):.1f} ops on {name} ({len(ticks)} ticks)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
