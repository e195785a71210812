#!/usr/bin/env python
"""Write the JAX references that the PyTorch port is held against at full
width: ``tests/golden/torch_port_fullsize.npz``,
``tests/golden/torch_port_profiles.npz``,
``tests/golden/torch_port_batch.npz``,
``tests/golden/torch_port_faults.npz``,
``tests/golden/torch_port_inc.npz`` and
``tests/golden/torch_port_link.npz``.

Both use the port's full-width fabric (``chip_smoke.py`` phase 5): a full
3-tier k=16 fat tree (``fat_tree3(k=16, pods=16)``: 1024 endpoints, 320
switches, 5120 egress queues) carrying two cross-pod permutations at
once — host i sends 256 packets to host (i+512) mod 1024 and 256 packets
to host (i+256) mod 1024, so F = 2048 flows and every destination
downlink takes a 2:1 incast — under ``SimParams()`` with
``trace="stats"``.

* ``fullsize``: ``TransportProfile.ai_full()``, ``max_ticks=4096``.
* ``profiles``: three compositions of the paper's profile table, each
  for ``max_ticks=1024`` (completion is not required):

  - ``hpc``: ``TransportProfile.hpc()`` (hybrid NSCC+RCCC, all-ROD, LB
    pinned to STATIC);
  - ``base``: ``TransportProfile.ai_base(lb=LBScheme.EVBITMAP)`` (RCCC,
    EVBITMAP, RUD);
  - ``mixed``: ``TransportProfile(cc=CCAlgo.NONE, lb=LBScheme.RR_SLOTS,
    delivery=<ROD on odd flows, RUD on even>)`` (open loop, RR_SLOTS
    loss inference, mixed ROD).

* ``batch``: ``ai_full`` through ``simulate_batch`` as B = 4
  scenarios, ``max_ticks=4096``: lane 0 seed 0x5EED, healthy (the
  ``fullsize`` run); lane 1 seed 0x5EED+1, healthy; lane 2 seed
  0x5EED+2, the first uplink of edge switch 0 (``up1_table[0, 0]``)
  dead from tick 0; lane 3 seed 0x5EED+3, that uplink flapping over
  [100, 400).
* ``faults``: ``TransportProfile.resilient()`` (RTO backoff 2x capped
  at 8x, EV eviction, PDC teardown after 4 dead RTOs) through
  ``simulate_batch`` as B = 4 scenarios,
  ``SimParams(timeout_ticks=64, ooo_threshold=24)``, ``max_ticks=2048``,
  seeds 0x5EED+b, fault-draw seed b, host lanes over
  the 1024 hosts: lane 0 gray links (``lossy(up1_table[0, :], 0.01)``);
  lane 1 host 0 dead from tick 100 for good and host 1's NIC stalled
  over [100, 400); lane 2 PHY corruption
  (``corrupt(up1_table[1, :], 0.01)``, no link layer); lane 3 all of
  these at once and ``up1_table[0, 0]`` dead from tick 0.
* ``inc``: 32 concurrent tree all-reduces on the same fabric. Group j
  (j = 0..31) is hosts {j + 32 i : i = 0..31} with root j, so all 31
  children sit on other edge switches than their root; each rank sends
  32 packets (F = 32 x 62 = 1984 flows, group j's reduce flows carry
  ``red = j``). One ``simulate_batch`` under ``ai_full()`` with
  ``inc=True``, ``max_ticks=4096``, B = 2: lane 0 with the groups'
  ``red`` ids, lane 1 the same flows with ``red = -1`` (INC off as a
  data axis). Then the default ``collective_sweep()`` (15 scenarios on
  a small leaf-spine) under ``SimParams(ticks=1600)``.
* ``link``: the ``fullsize`` traffic under ``ai_full()`` as B = 2,
  seeds 0x5EED and 0x5EED+1: lane 0 with 1 % BER on edge 1's uplinks
  (``corrupt(up1_table[1, :], 0.01)``), lane 1 healthy, run twice under
  ``SimParams(ticks=4096)``: with ``link=LinkConfig.on(llr=True)``
  (tag ``llr``) and with ``LinkConfig.on(llr=True, cbfc=True)`` (tag
  ``cbfc``).

This script imports the JAX package and is not part of the port. It
runs on the CPU (about five minutes per one-scenario run on a few
cores):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_port_reference.py \
        [--which fullsize|profiles|batch|faults|inc|link]

``fullsize`` holds the workload lanes (``src``, ``dst``, ``size``), the
per-flow stats and final lanes (``stat_completion``,
``stat_src_completion``, ``delivered``, ``next_psn``, ``src_base``,
``dst_base``, ``cwnd``), the scalars (``horizon``, ``trims``, ``drops``,
``dups``, ``retransmits``, ``timeouts``, ``qlen_peak``) and the
wall-clock seconds the reference run took (``cpu_seconds``).

``profiles`` holds, per tag ``t``: ``t/describe`` (the profile's
``describe()``), ``t/delivery`` (the per-flow delivery modes), the stats
lanes ``t/stat_completion``, ``t/stat_src_completion``, the scalars
``t/horizon``, ``t/qlen_peak``, ``t/trims``, ``t/drops``, ``t/dups``,
``t/rod_rejects``, ``t/retransmits``, ``t/timeouts``, ``t/cpu_seconds``,
and every final ``SimState`` lane but the packet and event buffers as
``t/state.<dotted path>`` (uint32 lanes as uint32).

``batch`` holds ``seeds``, ``fail_queue``, the schedules' ``fail_at`` /
``heal_at`` lanes ([4, Q]) and, per lane ``b<i>``, the stats and final
lanes and the scalars of ``fullsize`` plus ``ticks_degraded``; and the
wall-clock seconds of the batched run (``cpu_seconds``).

``faults`` holds ``seeds``, ``timeout_ticks``, ``ooo_threshold``,
``max_ticks``, every
lane of the [4, Q] / [4, H] schedule as ``sched.<field>`` and, per lane
``b<i>``, the lanes and scalars of ``batch`` plus the recovery lanes
(``rto``, ``rto_strikes``, ``quarantined``, ``inflight``, ``bad_n``,
``last_ev``, ``bad_ev``, ``ev_set``) and counters (``ev_evictions``,
``flows_abandoned``, ``ticks_unreachable``, ``abandon_tick``); and the
wall-clock seconds of the batched run (``cpu_seconds``).

``inc`` holds the workload lanes of lane 0 (``src``, ``dst``, ``size``,
``dep``, ``red``), ``expected_rx`` (per host, INC off),
``max_ticks``, per lane ``b<i>``: ``horizon``, ``stat_completion``,
``stat_src_completion``, ``inc_reduced``, ``inc_emits``, the scalars of
``fullsize`` and every final state lane but the packet and event
buffers as ``b<i>/state.<dotted path>``; per sweep scenario ``s<i>``:
``name``, ``horizon``, ``stat_src_completion``, ``delivered``,
``inc_reduced``, ``inc_emits``; and ``cpu_seconds``.

``link`` holds ``seeds``, ``ber``, ``max_ticks`` and, per tag ``t`` and
lane ``b<i>``: ``t/b<i>/horizon``, the stats lanes, ``llr_replays``,
``credit_stall_ticks``, ``trims``, ``drops`` and the other scalars of
``fullsize``, and every final state lane but the packet and event
buffers as ``t/b<i>/state.<dotted path>``; and ``t/cpu_seconds``.
"""
import argparse
import dataclasses
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from repro.core.lb.schemes import LBScheme
from repro.core.link import LinkConfig
from repro.network import collectives as coll
from repro.network.workloads import collective_sweep
from repro.network.fabric import (SimParams, Workload, simulate,
                                  simulate_batch)
from repro.network.faults import FaultSchedule
from repro.network.profile import CCAlgo, DeliveryMode, TransportProfile
from repro.network.topology import fat_tree3

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
OUT = GOLDEN / "torch_port_fullsize.npz"
OUT_PROFILES = GOLDEN / "torch_port_profiles.npz"
OUT_BATCH = GOLDEN / "torch_port_batch.npz"
OUT_FAULTS = GOLDEN / "torch_port_faults.npz"
OUT_INC = GOLDEN / "torch_port_inc.npz"
OUT_LINK = GOLDEN / "torch_port_link.npz"
INC_GROUPS = 32               # concurrent tree all-reduces
INC_RANKS = 32                # hosts per group
INC_SIZE = 32                 # packets per rank
SWEEP_TICKS = 1600
LINK_BER = 0.01
FAULT_TIMEOUT = 64
FAULT_OOO = 24                # OOO-gap loss inference (receiver NACKs)
FAULT_TICKS = 2048
FAULT_FAIL = 100              # host 0 dies here; host 1's NIC stalls
FAULT_STALL_HEAL = 400        # until here
FAULT_P = 0.01                # gray-link loss and BER of the faulted uplinks
BATCH_SEEDS = (0x5EED, 0x5EED + 1, 0x5EED + 2, 0x5EED + 3)
FLAP = (100, 400)
HOSTS = 1024
SIZE = 256
MAX_TICKS = 4096
PROFILE_TICKS = 1024
#: SimState lanes the profile references leave out: the packet and event
#: buffers (large, and fixed by the lanes that are kept) and the lanes of
#: features the profiles do not run
SKIP_STATE = ("q_pkt", "ev_buf", "inc", "inc_reduced", "inc_emits",
              "ev_evictions", "rto_strikes", "quarantined", "flows_abandoned",
              "ticks_unreachable", "llr_busy_until", "llr_replays",
              "cbfc_consumed", "cbfc_freed", "cbfc_ret",
              "credit_stall_ticks")
#: the lanes the INC and link references leave out: only the buffers
SKIP_BUFFERS = ("q_pkt", "ev_buf")


def workload_lanes() -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """(src, dst, size) of the two overlapping cross-pod permutations."""
    h = np.arange(HOSTS, dtype=np.int32)
    src = np.concatenate([h, h])
    dst = np.concatenate([(h + 512) % HOSTS, (h + 256) % HOSTS]).astype(
        np.int32)
    return src, dst, np.full(src.shape, SIZE, np.int32)


def profiles(num_flows: int) -> "dict[str, TransportProfile]":
    """The three full-width profile runs, by tag."""
    mixed = tuple(DeliveryMode.ROD if f % 2 else DeliveryMode.RUD
                  for f in range(num_flows))
    return {
        "hpc": TransportProfile.hpc(),
        "base": TransportProfile.ai_base(lb=LBScheme.EVBITMAP),
        "mixed": TransportProfile(cc=CCAlgo.NONE, lb=LBScheme.RR_SLOTS,
                                  delivery=mixed, name="mixed"),
    }


def _flatten(obj, prefix: str, out: dict, skip=SKIP_STATE) -> None:
    """Dataclass / dict pytree -> {dotted path: numpy array}."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if not prefix and f.name in skip:
                continue
            _flatten(getattr(obj, f.name), f"{prefix}{f.name}.", out, skip)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(v, f"{prefix}{k}.", out, skip)
    else:
        out[prefix[:-1]] = np.asarray(obj)


def _run_lanes(r) -> dict:
    """The stats and final [F] lanes and the scalars of one run."""
    s = r.state
    return {
        "stat_completion": np.asarray(r.stat_completion),
        "stat_src_completion": np.asarray(r.stat_src_completion),
        "delivered": np.asarray(s.delivered),
        "next_psn": np.asarray(s.next_psn),
        "src_base": np.asarray(s.src_track.base),
        "dst_base": np.asarray(s.dst_track.base),
        "cwnd": np.asarray(s.cc.cwnd),
        "horizon": np.int64(r.horizon),
        "trims": np.int64(r.trims), "drops": np.int64(r.drops),
        "dups": np.int64(r.dups), "retransmits": np.int64(r.rtx_packets),
        "timeouts": np.int64(r.timeouts), "qlen_peak": np.int64(r.qlen_peak),
        "ticks_degraded": np.int64(r.ticks_degraded),
    }


def write_fullsize(path: Path) -> None:
    g = fat_tree3(k=16, pods=16)
    src, dst, size = workload_lanes()
    wl = Workload.of(src, dst, size)
    t0 = time.perf_counter()
    r = simulate(g, wl, TransportProfile.ai_full(), SimParams(),
                 trace="stats", max_ticks=MAX_TICKS)
    secs = time.perf_counter() - t0
    out = {"src": src, "dst": dst, "size": size, **_run_lanes(r),
           "cpu_seconds": np.float64(secs)}
    del out["ticks_degraded"]
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    ct = out["stat_completion"]
    print(f"{g.name}: Q={g.num_queues} F={src.size} horizon={r.horizon} "
          f"completion {ct.min()}..{ct.max()} trims={r.trims} "
          f"rtx={r.rtx_packets} timeouts={r.timeouts} "
          f"qlen_peak={r.qlen_peak} in {secs:.1f} s -> {path}")


def run_profile(tag: str) -> dict:
    """One profile run at full width, as the ``t/...`` entries."""
    g = fat_tree3(k=16, pods=16)
    src, dst, size = workload_lanes()
    prof = profiles(src.size)[tag]
    t0 = time.perf_counter()
    r = simulate(g, Workload.of(src, dst, size), prof, SimParams(),
                 trace="stats", max_ticks=PROFILE_TICKS)
    secs = time.perf_counter() - t0
    s = r.state
    out = {
        "describe": np.asarray(prof.describe()),
        "delivery": prof.delivery_modes(src.size),
        "stat_completion": np.asarray(r.stat_completion),
        "stat_src_completion": np.asarray(r.stat_src_completion),
        "horizon": np.int64(r.horizon), "qlen_peak": np.int64(r.qlen_peak),
        "trims": np.int64(r.trims), "drops": np.int64(r.drops),
        "dups": np.int64(r.dups), "rod_rejects": np.int64(s.rod_rejects),
        "retransmits": np.int64(r.rtx_packets),
        "timeouts": np.int64(r.timeouts), "cpu_seconds": np.float64(secs),
    }
    lanes: dict = {}
    _flatten(s, "", lanes)
    out.update({f"state.{k}": v for k, v in lanes.items()})
    print(f"{tag}: {prof.describe()[:80]} horizon={r.horizon} "
          f"delivered={int(np.asarray(s.delivered).sum())} trims={r.trims} "
          f"rod_rejects={int(s.rod_rejects)} rtx={r.rtx_packets} "
          f"timeouts={r.timeouts} in {secs:.1f} s", flush=True)
    return {f"{tag}/{k}": v for k, v in out.items()}


def batch_faults(g) -> "tuple[int, FaultSchedule]":
    """The batch's [4, Q] schedule: lanes 0-1 healthy, lane 2's uplink
    dead from tick 0, lane 3's flapping over FLAP."""
    q = int(g.up1_table[0, 0])
    ok = FaultSchedule.healthy(g.num_queues)
    return q, FaultSchedule.stack([ok, ok, ok.flap(q, 0), ok.flap(q, *FLAP)])


def write_batch(path: Path) -> None:
    g = fat_tree3(k=16, pods=16)
    src, dst, size = workload_lanes()
    wl = Workload.of(src, dst, size)
    q, faults = batch_faults(g)
    t0 = time.perf_counter()
    rs = simulate_batch(g, Workload.stack([wl] * len(BATCH_SEEDS)),
                        TransportProfile.ai_full(), SimParams(),
                        faults=faults,
                        seeds=np.asarray(BATCH_SEEDS, np.uint32),
                        trace="stats", max_ticks=MAX_TICKS)
    secs = time.perf_counter() - t0
    out = {"seeds": np.asarray(BATCH_SEEDS, np.uint32),
           "fail_queue": np.int64(q),
           "fail_at": np.asarray(faults.fail_at),
           "heal_at": np.asarray(faults.heal_at),
           "cpu_seconds": np.float64(secs)}
    for b, r in enumerate(rs):
        out.update({f"b{b}/{k}": v for k, v in _run_lanes(r).items()})
        ct = np.asarray(r.stat_completion)
        print(f"lane {b}: horizon={r.horizon} completion {ct.min()}.."
              f"{ct.max()} trims={r.trims} drops={r.drops} "
              f"rtx={r.rtx_packets} timeouts={r.timeouts} "
              f"degraded={r.ticks_degraded}", flush=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"{g.name}: B={len(rs)} in {secs:.1f} s -> {path}")


def faults_schedule(g) -> FaultSchedule:
    """The faulted batch's [4, Q] / [4, H] schedule (fault-draw seed b
    on lane b)."""
    up0 = [int(q) for q in g.up1_table[0, :]]
    up1 = [int(q) for q in g.up1_table[1, :]]
    ok = FaultSchedule.healthy(g.num_queues, num_hosts=g.num_hosts)
    lanes = [
        ok.lossy(up0, FAULT_P),
        ok.host_fail(0, FAULT_FAIL).nic_stall(1, FAULT_FAIL,
                                              FAULT_STALL_HEAL),
        ok.corrupt(up1, FAULT_P),
        ok.lossy(up0, FAULT_P).host_fail(0, FAULT_FAIL)
        .nic_stall(1, FAULT_FAIL, FAULT_STALL_HEAL).corrupt(up1, FAULT_P)
        .flap(up0[0], 0),
    ]
    return FaultSchedule.stack([s.with_seed(b) for b, s in enumerate(lanes)])


def write_faults(path: Path) -> None:
    g = fat_tree3(k=16, pods=16)
    src, dst, size = workload_lanes()
    wl = Workload.of(src, dst, size)
    faults = faults_schedule(g)
    t0 = time.perf_counter()
    rs = simulate_batch(g, Workload.stack([wl] * len(BATCH_SEEDS)),
                        TransportProfile.resilient(),
                        SimParams(timeout_ticks=FAULT_TIMEOUT,
                                  ooo_threshold=FAULT_OOO),
                        faults=faults,
                        seeds=np.asarray(BATCH_SEEDS, np.uint32),
                        trace="stats", max_ticks=FAULT_TICKS)
    secs = time.perf_counter() - t0
    out = {"seeds": np.asarray(BATCH_SEEDS, np.uint32),
           "timeout_ticks": np.int64(FAULT_TIMEOUT),
           "ooo_threshold": np.int64(FAULT_OOO),
           "max_ticks": np.int64(FAULT_TICKS),
           "cpu_seconds": np.float64(secs)}
    for f in dataclasses.fields(faults):
        out[f"sched.{f.name}"] = np.asarray(getattr(faults, f.name))
    for b, r in enumerate(rs):
        s = r.state
        lanes = {**_run_lanes(r),
                 "rto": np.asarray(s.rto),
                 "rto_strikes": np.asarray(s.rto_strikes),
                 "quarantined": np.asarray(s.quarantined),
                 "inflight": np.asarray(s.inflight),
                 "bad_n": np.asarray(s.lb.bad_n),
                 "last_ev": np.asarray(s.lb.last_ev),
                 "bad_ev": np.asarray(s.lb.bad_ev),
                 "ev_set": np.asarray(s.lb.ev_set),
                 "ev_evictions": np.int64(r.ev_evictions),
                 "flows_abandoned": np.int64(r.flows_abandoned),
                 "ticks_unreachable": np.int64(r.ticks_unreachable),
                 "abandon_tick": np.int64(r.abandon_tick)}
        out.update({f"b{b}/{k}": v for k, v in lanes.items()})
        ct = np.asarray(r.stat_completion)
        print(f"lane {b}: horizon={r.horizon} unfinished="
              f"{int((ct < 0).sum())} completion max {ct.max()} "
              f"trims={r.trims} drops={r.drops} rtx={r.rtx_packets} "
              f"timeouts={r.timeouts} degraded={r.ticks_degraded} "
              f"evictions={r.ev_evictions} abandoned={r.flows_abandoned} "
              f"at {r.abandon_tick} unreachable={r.ticks_unreachable} "
              f"quarantined={np.nonzero(np.asarray(s.quarantined))[0]}",
              flush=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"{g.name}: B={len(rs)} in {secs:.1f} s -> {path}")


def inc_workload_lanes() -> "dict[str, np.ndarray]":
    """The 32 concurrent tree all-reduces as one flow table (lane 0's
    ``red``: group j's reduce flows carry j) and the per-host rx each
    group's schedule expects with INC off."""
    parts: "dict[str, list]" = {k: [] for k in ("src", "dst", "size",
                                                "dep", "red")}
    rx = np.zeros((HOSTS,), np.int64)
    off = 0
    for j in range(INC_GROUPS):
        hosts = np.asarray([j + INC_GROUPS * i for i in range(INC_RANKS)],
                           np.int32)
        spec = coll.CollectiveSpec("all_reduce", tuple(hosts), INC_SIZE)
        t = coll.flow_table(spec, "tree")
        parts["src"].append(hosts[t.src])
        parts["dst"].append(hosts[t.dst])
        parts["size"].append(t.size)
        parts["dep"].append(np.where(t.dep >= 0, t.dep + off, -1))
        parts["red"].append(np.where(t.red >= 0, j, -1))
        rx[hosts] += coll.expected_host_rx(spec, "tree")
        off += len(t.src)
    out = {k: np.concatenate(v).astype(np.int32) for k, v in parts.items()}
    out["expected_rx"] = rx
    return out


def _state_lanes(s) -> dict:
    lanes: dict = {}
    _flatten(s, "", lanes, SKIP_BUFFERS)
    return {f"state.{k}": v for k, v in lanes.items()}


def write_inc(path: Path) -> None:
    g = fat_tree3(k=16, pods=16)
    lanes = inc_workload_lanes()
    wl_on = Workload.of(lanes["src"], lanes["dst"], lanes["size"],
                        dep=lanes["dep"], red=lanes["red"])
    wl_off = Workload.of(lanes["src"], lanes["dst"], lanes["size"],
                         dep=lanes["dep"])
    prof = replace(TransportProfile.ai_full(), inc=True, name="ai_full+inc")
    t0 = time.perf_counter()
    rs = simulate_batch(g, Workload.stack([wl_on, wl_off]), prof,
                        SimParams(), trace="stats", max_ticks=MAX_TICKS)
    secs = time.perf_counter() - t0
    out = {**lanes, "max_ticks": np.int64(MAX_TICKS),
           "cpu_seconds": np.float64(secs)}
    for b, r in enumerate(rs):
        s = r.state
        per = {**_run_lanes(r), **_state_lanes(s),
               "inc_reduced": np.int64(s.inc_reduced),
               "inc_emits": np.int64(s.inc_emits)}
        out.update({f"b{b}/{k}": v for k, v in per.items()})
        print(f"lane {b}: horizon={r.horizon} source completion "
              f"{r.source_completion_tick()} inc_reduced={int(s.inc_reduced)}"
              f" inc_emits={int(s.inc_emits)} delivered="
              f"{int(np.asarray(s.delivered).sum())} trims={r.trims}",
              flush=True)
    g2, wls, profs, names = collective_sweep()
    t0 = time.perf_counter()
    rs = simulate_batch(g2, wls, profs, SimParams(ticks=SWEEP_TICKS))
    out["sweep_cpu_seconds"] = np.float64(time.perf_counter() - t0)
    for i, (nm, r) in enumerate(zip(names, rs)):
        out.update({f"s{i}/name": np.asarray(nm),
                    f"s{i}/horizon": np.int64(r.horizon),
                    f"s{i}/stat_src_completion":
                        np.asarray(r.stat_src_completion),
                    f"s{i}/delivered": np.asarray(r.state.delivered),
                    f"s{i}/inc_reduced": np.int64(r.state.inc_reduced),
                    f"s{i}/inc_emits": np.int64(r.state.inc_emits)})
        print(f"sweep {nm}: horizon={r.horizon} completion="
              f"{coll.collective_completion_ticks(r)}", flush=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"{g.name}: F={lanes['src'].size} B=2 in {secs:.1f} s -> {path}")


def link_arms() -> "dict[str, LinkConfig]":
    return {"llr": LinkConfig.on(llr=True),
            "cbfc": LinkConfig.on(llr=True, cbfc=True)}


def link_schedule(g) -> FaultSchedule:
    """Lane 0: LINK_BER on edge 1's uplinks; lane 1 healthy."""
    ok = FaultSchedule.healthy(g.num_queues)
    up1 = [int(q) for q in g.up1_table[1, :]]
    return FaultSchedule.stack([ok.corrupt(up1, LINK_BER), ok])


def write_link(path: Path) -> None:
    g = fat_tree3(k=16, pods=16)
    src, dst, size = workload_lanes()
    wl = Workload.of(src, dst, size)
    seeds = np.asarray(BATCH_SEEDS[:2], np.uint32)
    out = {"seeds": seeds, "ber": np.float64(LINK_BER),
           "max_ticks": np.int64(MAX_TICKS)}
    for tag, link in link_arms().items():
        t0 = time.perf_counter()
        rs = simulate_batch(g, Workload.stack([wl, wl]),
                            TransportProfile.ai_full(),
                            SimParams(ticks=MAX_TICKS),
                            faults=link_schedule(g), seeds=seeds,
                            trace="stats", link=link)
        out[f"{tag}/cpu_seconds"] = np.float64(time.perf_counter() - t0)
        for b, r in enumerate(rs):
            per = {**_run_lanes(r), **_state_lanes(r.state),
                   "llr_replays": np.int64(r.llr_replays),
                   "credit_stall_ticks": np.int64(r.credit_stall_ticks)}
            out.update({f"{tag}/b{b}/{k}": v for k, v in per.items()})
            print(f"{tag} lane {b}: horizon={r.horizon} completion="
                  f"{r.completion_tick()} llr_replays={r.llr_replays} "
                  f"credit_stall_ticks={r.credit_stall_ticks} "
                  f"trims={r.trims} drops={r.drops} rtx={r.rtx_packets} "
                  f"timeouts={r.timeouts}", flush=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"{g.name}: link arms {tuple(link_arms())} -> {path}")


def write_profiles(path: Path) -> None:
    out = {}
    for tag in ("hpc", "base", "mixed"):
        out.update(run_profile(tag))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"-> {path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--which", default="fullsize",
                    choices=("fullsize", "profiles", "batch", "faults",
                             "inc", "link"))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if args.which == "fullsize":
        write_fullsize(args.out or OUT)
    elif args.which == "batch":
        write_batch(args.out or OUT_BATCH)
    elif args.which == "faults":
        write_faults(args.out or OUT_FAULTS)
    elif args.which == "inc":
        write_inc(args.out or OUT_INC)
    elif args.which == "link":
        write_link(args.out or OUT_LINK)
    else:
        write_profiles(args.out or OUT_PROFILES)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
