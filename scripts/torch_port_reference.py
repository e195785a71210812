#!/usr/bin/env python
"""Write the JAX references that the PyTorch port is held against at full
width: ``tests/golden/torch_port_fullsize.npz``,
``tests/golden/torch_port_profiles.npz`` and
``tests/golden/torch_port_batch.npz``.

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

This script imports the JAX package and is not part of the port. It
runs on the CPU (about five minutes per one-scenario run on a few
cores):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_port_reference.py \
        [--which fullsize|profiles|batch]

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
"""
import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np

from repro.core.lb.schemes import LBScheme
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


def _flatten(obj, prefix: str, out: dict) -> None:
    """Dataclass / dict pytree -> {dotted path: numpy array}."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if not prefix and f.name in SKIP_STATE:
                continue
            _flatten(getattr(obj, f.name), f"{prefix}{f.name}.", out)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(v, f"{prefix}{k}.", out)
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
                    choices=("fullsize", "profiles", "batch"))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if args.which == "fullsize":
        write_fullsize(args.out or OUT)
    elif args.which == "batch":
        write_batch(args.out or OUT_BATCH)
    else:
        write_profiles(args.out or OUT_PROFILES)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
