#!/usr/bin/env python
"""Write the JAX references that the PyTorch port is held against at full
width: ``tests/golden/torch_port_fullsize.npz``,
``tests/golden/torch_port_profiles.npz``,
``tests/golden/torch_port_batch.npz``,
``tests/golden/torch_port_faults.npz``,
``tests/golden/torch_port_inc.npz``,
``tests/golden/torch_port_link.npz``,
``tests/golden/torch_port_telemetry.npz``,
``tests/golden/torch_port_traffic.npz``,
``tests/golden/torch_port_control.npz``,
``tests/golden/torch_port_lm.npz``,
``tests/golden/torch_port_train.npz`` and
``tests/golden/torch_port_entry.npz``.

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
* ``telemetry``: the ``faults`` batch with
  ``telemetry=TelemetrySpec.on(probe_every=16, slots=16)`` (tag
  ``faults``) and the ``link`` run's LLR + CBFC arm with
  ``TelemetrySpec.on(probe_every=8, slots=16)`` (tag ``link``).
* ``traffic``: model-driven traffic and its pricing
  (``repro.network.traffic``), in four parts: ``a``, the reference
  bench's ``run_model_sweep()`` (2 archs x 2 layouts x 2 leaf-spines x
  3 profiles at ``decode_32k``, dp = tp = 16: 24 scenarios in one
  ``simulate_batch``); ``b``, the same grid on ``fat_tree3(k=16,
  pods=16)`` alone (12 scenarios) and ``step_time`` of the
  deepseek-coder-33b ``train_4k`` plan at dp = tp = 16 on that graph
  under ``ai_full()``; ``c``, ``price_recovery`` of the ``train_4k``
  plan at dp = tp = 4; ``d``, netmodel's ``simulated_collective_time``
  (all-reduce ring / tree, all-gather ring at 8 chips, 24 packets) and
  ``simulated_efficiency("all-reduce", hosts=4, size_pkts=16)``.

This script imports the JAX package and is not part of the port. It
runs on the CPU (about five minutes per one-scenario run on a few
cores):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_port_reference.py \
        [--which fullsize|profiles|batch|faults|inc|link|telemetry|traffic|control|lm|train|entry]

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

``control`` holds the JAX tour's values (``examples/uet_transport_tour.py``
walked step by step, ``tour/<key>`` as ``tour()`` of
``examples/uet_transport_tour_torch.py`` names them) and its printed
lines (``tour_lines``), the sha256 of the seeded batch's inputs
(``inputs_sha256``, ``chip_smoke.control_digest``), then every output of
the control plane's seeded batch
(``chip_smoke.control_inputs(CONTROL_GOLDEN)``: PSN tracking,
the PDC pool, addressing, matching, TSS, NSCC's batch API) as
``batch/<part>/<name>`` (uint32 lanes as uint32), and the seconds each
part took (``seconds/<part>``).

``lm`` holds, per arch ``a`` of the registry at ``configs.reduced(a,
seq=24)`` (``chip_smoke.LM_GOLDEN``; the params and tokens come from
``chip_smoke.lm_inputs``, whose digest it records as
``a/params_sha256``): ``a/tokens``, the full forward's ``a/logits`` and
``a/aux``, every decode step's logits ``a/decode`` ([B, S, V], the
reference's ``make_decode_step`` from an empty cache of S slots) and
the final cache as ``a/cache/<path>``; then ``serve/<key>`` (``eff``'s
scopes as ``serve/eff/<scope>``): ``serving_rate`` of mixtral-8x22b at
``chip_smoke.LM_RATE`` on ``leaf_spine(4, 4, 4)``.

``train`` holds, per arch ``a`` at ``configs.reduced(a, seq=16)``
(``chip_smoke.TRAIN_GOLDEN``; params and batch from
``chip_smoke.train_inputs``, whose digest it records as
``a/inputs_sha256``): two jitted ``make_train_step`` steps
(``chip_smoke.TRAIN_OPT``) on one batch, recorded by
``chip_smoke.train_record``: ``a/s<i>/<metric>`` of both steps, each
leaf's step-1 gradient sum of squares ``a/grad_sumsq/<path>`` and
seeded samples of up to 256 entries (``chip_smoke.train_sample``) of
the step-1 gradients ``a/grad/<path>`` and of the params and moments
after step 2 (``a/param/``, ``a/m/``, ``a/v/``); then ``derate/<kind>``,
``repro.launch.roofline.uet_efficiencies`` over
``chip_smoke.TRAIN_KINDS`` at ``chip_smoke.TRAIN_DERATE``.

``entry`` holds what the JAX package's entry points print, as lines:
``quickstart`` (``examples/quickstart.py``), ``tour``
(``examples/fabric_telemetry.py``, run in a temporary working
directory), ``export`` (``scripts/trace_export.py`` at its defaults, in
a temporary working directory) and, per canary ``c``, ``canary/c``:
``faults`` (``python -m repro.network.faults``), ``endpoint`` (the same
with ``--endpoint``), ``telemetry``, ``link``, ``traffic`` and ``shard``
(``python -m repro.network.shard`` under
``XLA_FLAGS=--xla_force_host_platform_device_count=4``), each in a
fresh interpreter; the export's Chrome-trace JSON as ``export_sha256``
(the hex sha256 of its text) and ``export_events`` (its event count);
``mask`` (``ENTRY_MASK``), the one regex whose matches every reader
replaces by one marker on both sides before comparing lines: the traffic
canary's wall seconds and the shard canary's device count, the only
fields that are wall clock or host shape; and the seconds each took on
this CPU (``seconds/<name>``).

``telemetry`` holds, per tag ``t`` (``faults``, ``link``): the spec's
``t/probe_every`` and ``t/slots``, ``t/cpu_seconds``, and per lane
``b<i>``: ``horizon``; the ring bookkeeping ``tel.n``, ``tel.stride``,
``tel.stamp``; the gauge rings ``tel.s_inflight``, ``tel.s_degraded``,
``tel.s_delivered`` and the final accumulators ``tel.ewma_q``,
``tel.peak_q``, ``tel.ecn_q``, ``tel.trim_q``, ``tel.drop_q``,
``tel.llr_q``, ``tel.stall_q``, ``tel.rtt_f`` in full; every [S, Q] /
[S, F] ring (``s_occ``, ``s_ecn``, ``s_trim``, ``s_drop``, ``s_llr``,
``s_stall``, ``s_rtt``, ``s_cwnd``) as ``sha.<name>``, the hex sha256
of its C-order bytes; and ``trims``, ``drops``, ``llr_replays``,
``credit_stall_ticks``.
"""
import argparse
import dataclasses
import functools
import hashlib
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
from repro.network.telemetry import TelemetrySpec
from repro.network.topology import fat_tree3

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
OUT = GOLDEN / "torch_port_fullsize.npz"
OUT_PROFILES = GOLDEN / "torch_port_profiles.npz"
OUT_BATCH = GOLDEN / "torch_port_batch.npz"
OUT_FAULTS = GOLDEN / "torch_port_faults.npz"
OUT_INC = GOLDEN / "torch_port_inc.npz"
OUT_LINK = GOLDEN / "torch_port_link.npz"
OUT_TELEMETRY = GOLDEN / "torch_port_telemetry.npz"
OUT_TRAFFIC = GOLDEN / "torch_port_traffic.npz"
OUT_CONTROL = GOLDEN / "torch_port_control.npz"
OUT_LM = GOLDEN / "torch_port_lm.npz"
OUT_TRAIN = GOLDEN / "torch_port_train.npz"
OUT_ENTRY = GOLDEN / "torch_port_entry.npz"
#: netmodel's (kind, algo) pairs of ``tests/test_collectives.py``
NET_PAIRS = (("all-reduce", "ring"), ("all-reduce", "tree"),
             ("all-gather", "ring"))
#: the telemetry runs' specs, by tag
TEL_SPECS = {"faults": TelemetrySpec.on(probe_every=16, slots=16),
             "link": TelemetrySpec.on(probe_every=8, slots=16)}
#: ring lanes the telemetry reference stores as sha256 digests
TEL_RINGS = ("s_occ", "s_ecn", "s_trim", "s_drop", "s_llr", "s_stall",
             "s_rtt", "s_cwnd")
#: the fields of the entry points' lines that are wall clock or host
#: shape (the traffic canary's ``[{s:.1f}s]``, the shard canary's device
#: count); the ``entry`` golden stores it, and every reader takes it from
#: there
ENTRY_MASK = r"\[\d+\.\ds\]|\b\d+ devices\b"
#: the CLI canaries: golden key -> the ``python -m`` arguments and extra
#: environment of their run
ENTRY_CANARIES = {
    "faults": (["repro.network.faults"], {}),
    "endpoint": (["repro.network.faults", "--endpoint"], {}),
    "telemetry": (["repro.network.telemetry"], {}),
    "link": (["repro.core.link"], {}),
    "traffic": (["repro.network.traffic"], {}),
    "shard": (["repro.network.shard"],
              {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}),
}
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


def ring_digest(a) -> str:
    """The hex sha256 of an array's C-order bytes."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def telemetry_lanes(tel: dict) -> dict:
    """One lane's probe carry as the ``telemetry`` reference stores it:
    rings as digests, everything else in full."""
    out = {}
    for k, v in tel.items():
        v = np.asarray(v)
        if k in TEL_RINGS:
            out[f"sha.{k}"] = np.asarray(ring_digest(v))
        else:
            out[f"tel.{k}"] = v
    return out


def write_telemetry(path: Path) -> None:
    from repro.network import fabric as jfab
    g = fat_tree3(k=16, pods=16)
    src, dst, size = workload_lanes()
    wl = Workload.of(src, dst, size)
    seeds = np.asarray(BATCH_SEEDS, np.uint32)
    carries: list = []
    # the probe carry (all S slots of every ring) as the driver hands it
    # to FabricTrace.from_lanes, captured per lane
    orig = jfab.telem.FabricTrace.from_lanes

    def capture(spec, tel, horizon):
        carries.append({k: np.asarray(v) for k, v in tel.items()})
        return orig(spec, tel, horizon)

    jfab.telem.FabricTrace.from_lanes = staticmethod(capture)
    out: dict = {}
    try:
        runs = {
            "faults": lambda spec: simulate_batch(
                g, Workload.stack([wl] * len(BATCH_SEEDS)),
                TransportProfile.resilient(),
                SimParams(timeout_ticks=FAULT_TIMEOUT,
                          ooo_threshold=FAULT_OOO),
                faults=faults_schedule(g), seeds=seeds, trace="stats",
                max_ticks=FAULT_TICKS, telemetry=spec),
            "link": lambda spec: simulate_batch(
                g, Workload.stack([wl, wl]), TransportProfile.ai_full(),
                SimParams(ticks=MAX_TICKS), faults=link_schedule(g),
                seeds=seeds[:2], trace="stats",
                link=link_arms()["cbfc"], telemetry=spec),
        }
        for tag, run in runs.items():
            spec = TEL_SPECS[tag]
            carries.clear()
            t0 = time.perf_counter()
            rs = run(spec)
            out[f"{tag}/cpu_seconds"] = np.float64(time.perf_counter() - t0)
            out[f"{tag}/probe_every"] = np.int64(spec.probe_every)
            out[f"{tag}/slots"] = np.int64(spec.slots)
            for b, (r, tel) in enumerate(zip(rs, carries)):
                per = {"horizon": np.int64(r.horizon),
                       "trims": np.int64(r.trims), "drops": np.int64(r.drops),
                       "llr_replays": np.int64(r.llr_replays),
                       "credit_stall_ticks": np.int64(r.credit_stall_ticks),
                       **telemetry_lanes(tel)}
                out.update({f"{tag}/b{b}/{k}": v for k, v in per.items()})
                print(f"{tag} lane {b}: horizon={r.horizon} samples="
                      f"{int(tel['n'])} stride={int(tel['stride'])} "
                      f"marks={int(tel['ecn_q'].sum())} trims="
                      f"{int(tel['trim_q'].sum())} drops="
                      f"{int(tel['drop_q'].sum())} llr="
                      f"{int(tel['llr_q'].sum())} stalls="
                      f"{int(tel['stall_q'].sum())}", flush=True)
            print(f"{tag}: {out[f'{tag}/cpu_seconds']:.1f} s", flush=True)
    finally:
        jfab.telem.FabricTrace.from_lanes = staticmethod(orig)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"{g.name}: telemetry runs {tuple(runs)} -> {path}")


class _Capture:
    """Record the SimResults of every call of ``module.name`` (the
    simulator entry point a traffic function calls) while it runs."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.results: list = []

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def run(*args, **kw):
            r = orig(*args, **kw)
            self.results += r if isinstance(r, list) else [r]
            return r
        setattr(self.module, self.name, run)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _timing_lanes(compiled, r, t) -> dict:
    """A compiled step, its run and its StepTiming as golden lanes."""
    wl = compiled.workload
    scopes = list(t.eff)
    return {
        "src": np.asarray(wl.src), "dst": np.asarray(wl.dst),
        "size": np.asarray(wl.size), "dep": np.asarray(wl.dep),
        "phase_names": np.asarray(",".join(ph.name for ph in compiled.phases)),
        "phases": np.asarray([(ph.lo, ph.hi, ph.ideal_ticks)
                              for ph in compiled.phases], np.int64),
        "horizon": np.int64(r.horizon),
        "stat_src_completion": np.asarray(r.stat_src_completion),
        "sim_ticks": np.int64(t.sim_ticks),
        **{k: np.float64(getattr(t, k))
           for k in ("step_s", "net_s", "analytic_net_s", "compute_s",
                     "memory_s", "tokens_per_sec")},
        "eff_scopes": np.asarray(",".join(scopes)),
        "eff": np.asarray([t.eff[k] for k in scopes], np.float64),
        "phase_ticks": np.asarray([d["ticks"] for d in t.phases], np.int64),
    }


def _sweep_lanes(prefix: str, topologies) -> dict:
    """``run_model_sweep(topologies=...)`` with its runs captured."""
    from repro.network import traffic
    t0 = time.perf_counter()
    with _Capture(traffic, "simulate_batch") as cap:
        pts = traffic.run_model_sweep(topologies=topologies)
    secs = time.perf_counter() - t0
    _, _, _, points = traffic.model_sweep_scenarios(topologies=topologies)
    budget = max(pt["compiled"].default_budget() for pt in points)
    out = {"n": np.int64(len(pts)), "budget": np.int64(budget),
           "cpu_seconds": np.float64(secs)}
    for i, (pt, ref, r) in enumerate(zip(pts, points, cap.results)):
        t = traffic.price_step(ref["compiled"], r)
        assert t.step_s == pt["step_s"] and t.sim_ticks == pt["sim_ticks"]
        lanes = {k: np.asarray(pt[k])
                 for k in ("arch", "layout", "topology", "profile")}
        lanes.update(_timing_lanes(ref["compiled"], r, t))
        out.update({f"s{i}/{k}": v for k, v in lanes.items()})
        print(f"{prefix} {i}: {pt['arch']} {pt['layout']} {pt['topology']} "
              f"{pt['profile']}: F={ref['compiled'].num_flows} horizon="
              f"{r.horizon} sim_ticks={t.sim_ticks} step_s={t.step_s!r} "
              f"eff={t.eff}", flush=True)
    print(f"{prefix}: {len(pts)} points in {secs:.1f} s", flush=True)
    return {f"{prefix}/{k}": v for k, v in out.items()}


def traffic_train_plan(dp: int, tp: int):
    from repro import configs
    from repro.distributed.plan import derive_plan
    return derive_plan(configs.get("deepseek-coder-33b"), "train_4k",
                       dp=dp, tp=tp, layout="fsdp_tp")


def traffic_part_a() -> dict:
    return _sweep_lanes("a", None)


def traffic_part_b() -> dict:
    from repro.network import traffic
    g = fat_tree3(k=16, pods=16)
    out = _sweep_lanes("b", [("ft16", g)])
    plan = traffic_train_plan(16, 16)
    t0 = time.perf_counter()
    with _Capture(traffic, "simulate") as cap:
        t = traffic.step_time(plan, g, TransportProfile.ai_full())
    secs = time.perf_counter() - t0
    compiled = traffic.compile_step(plan, g)
    (r,) = cap.results
    lanes = {**_timing_lanes(compiled, r, t), "cpu_seconds": np.float64(secs),
             "budget": np.int64(compiled.default_budget())}
    print(f"b train: F={compiled.num_flows} phases "
          f"{[ph.name for ph in compiled.phases]} horizon={r.horizon} "
          f"sim_ticks={t.sim_ticks} step_s={t.step_s!r} eff={t.eff} in "
          f"{secs:.1f} s", flush=True)
    out.update({f"b/train/{k}": v for k, v in lanes.items()})
    return out


def traffic_part_c() -> dict:
    from repro.network import traffic
    plan = traffic_train_plan(4, 4)
    t0 = time.perf_counter()
    with _Capture(traffic, "simulate") as cap:
        rc = traffic.price_recovery(plan)
    secs = time.perf_counter() - t0
    out = {k: np.asarray(getattr(rc, k))
           for k in ("detect_s", "detect_ticks", "restore_s", "replan_s",
                     "healthy_tokens_per_sec", "degraded_tokens_per_sec",
                     "flows_abandoned", "horizon", "budget")}
    out["cpu_seconds"] = np.float64(secs)
    for tag, r in zip(("healthy", "fault", "degraded"), cap.results):
        out.update({f"{tag}/horizon": np.int64(r.horizon),
                    f"{tag}/max_ticks": np.int64(r.max_ticks),
                    f"{tag}/flows_abandoned": np.int64(r.flows_abandoned),
                    f"{tag}/abandon_tick": np.int64(r.abandon_tick),
                    f"{tag}/stat_src_completion":
                        np.asarray(r.stat_src_completion)})
    print(f"c: {rc} in {secs:.1f} s", flush=True)
    return {f"c/{k}": v for k, v in out.items()}


def traffic_part_d() -> dict:
    from repro.distributed import netmodel
    t0 = time.perf_counter()
    out = {}
    for kind, algo in NET_PAIRS:
        out[f"t/{kind}/{algo}"] = np.float64(netmodel.simulated_collective_time(
            kind, chips=8, size_pkts=24, algo=algo))
    out["eff"] = np.float64(netmodel.simulated_efficiency(
        "all-reduce", hosts=4, size_pkts=16))
    out["cpu_seconds"] = np.float64(time.perf_counter() - t0)
    print(f"d: {out}", flush=True)
    return {f"d/{k}": v for k, v in out.items()}


def write_traffic(path: Path) -> None:
    """The four parts, the file rewritten after each (the full-width part
    ``b`` runs last: it takes the longest)."""
    out: dict = {}
    path.parent.mkdir(parents=True, exist_ok=True)
    for part in (traffic_part_a, traffic_part_c, traffic_part_d,
                 traffic_part_b):
        out.update(part())
        np.savez_compressed(path, **out)
    print(f"traffic -> {path}")


def write_profiles(path: Path) -> None:
    out = {}
    for tag in ("hpc", "base", "mixed"):
        out.update(run_profile(tag))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"-> {path}")


# ------------------------------------------------------- control plane --

def jax_tour() -> dict:
    """The JAX tour's values (``examples/uet_transport_tour.py``, step by
    step), keyed as the port's ``tour()`` keys them."""
    import jax.numpy as jnp

    from repro.core import addressing, matching, messaging, pdc
    from repro.core.types import MsgProtocol, Profile
    out = {"profiles": [prof.describe() for prof in (
        TransportProfile.ai_base(), TransportProfile.ai_full(),
        TransportProfile.hpc())]}
    t = addressing.FEPTables.create(num_jobs=4, procs_per_job=8,
                                    ris_per_proc=4)
    ris = jnp.arange(32, dtype=jnp.int32).reshape(8, 4) + 100
    t = addressing.register_job(t, 1, jobid=0x2313, proc_ids=jnp.arange(8),
                                ri_contexts=ris)
    ctx, ok = addressing.resolve(
        t, jobid=jnp.array([0x2313, 0xBAD]),
        pid_on_fep=jnp.array([2, 2]), ri=jnp.array([1, 1]),
        rel=jnp.array([1, 1]))
    out["addr_ctx"] = [int(x) for x in ctx]
    out["addr_ok"] = [bool(x) for x in ok]
    out["directory_relative"] = addressing.directory_entries(10000, 1000,
                                                             True)
    out["directory_direct"] = addressing.directory_entries(10000, 1000,
                                                           False)
    q = matching.RecvQueue.create(8)
    hi, lo = matching.encode_match_key(comm_id=7, tag=42, msg_seq=0)
    q = matching.post_receive(q, 0, hi, lo, 0, 0, matching.ANY_INITIATOR,
                              seq=0, buffer_id=5)
    slot, ok = matching.match(q, jnp.array([hi]), jnp.array([lo]),
                              jnp.array([3], jnp.uint32), Profile.AI_FULL)
    out["exact_slot"], out["exact_matched"] = int(slot[0]), bool(ok[0])
    mh, ml = matching.wildcard_mask(match_tag=False, match_seq=False)
    q2 = matching.RecvQueue.create(8)
    bh, bl = matching.encode_match_key(7, 0, 0)
    q2 = matching.post_receive(q2, 0, bh, bl, mh, ml,
                               matching.ANY_INITIATOR, 0, 6)
    th, tl = matching.encode_match_key(7, 999, 4)
    slot, ok = matching.match(q2, jnp.array([th]), jnp.array([tl]),
                              jnp.array([3], jnp.uint32), Profile.HPC)
    out["wildcard_matched"] = bool(ok[0])
    link = messaging.LinkModel(alpha=1.0, beta=0.01)
    out["protocol_names"] = [proto.name for proto in MsgProtocol]
    out["protocol_expected"] = [messaging.simulate_protocol(
        proto, 1000, 5.0, 2.0, link, eager_limit=2000).receiver_complete
        for proto in MsgProtocol]
    out["protocol_unexpected"] = [messaging.simulate_protocol(
        proto, 1000, 2.0, 12.0, link, eager_limit=2000).receiver_complete
        for proto in MsgProtocol]
    pool = pdc.PDCPool.create(2)
    pool = pdc.open_pdc(pool, jnp.int32(0), jnp.int32(7), jnp.uint32(4),
                        mode=int(DeliveryMode.ROD))
    out["pdc_open_state"] = pdc.PDCState(int(pool.state[0])).name
    out["pdc_mode"] = DeliveryMode(int(pool.mode[0])).name
    pool = pdc.on_ack(pool, jnp.int32(0), jnp.int32(19), jnp.int32(1))
    out["pdc_ack_state"] = pdc.PDCState(int(pool.state[0])).name
    out["pdc_remote_id"] = int(pool.remote_id[0])
    st = pool.state[:1]
    events = (pdc.InitEvent.CLOSE_REQ, pdc.InitEvent.DRAINED,
              pdc.InitEvent.CLOSE_ACK)
    out["pdc_close_events"] = [ev.name for ev in events]
    out["pdc_close_states"] = []
    for ev in events:
        st = pdc.step_initiator(st, jnp.array([int(ev)]))
        out["pdc_close_states"].append(pdc.PDCState(int(st[0])).name)
    return out


def jax_tour_lines() -> "list[str]":
    """The lines ``examples/uet_transport_tour.py`` prints."""
    import contextlib
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        "uet_transport_tour", REPO / "examples" / "uet_transport_tour.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue().splitlines()


def _printed(fn, *args) -> "list[str]":
    """The lines ``fn(*args)`` prints."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def _load(path: Path, name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_entry(path: Path) -> None:
    """The JAX package's entry points' printed lines (``entry`` above)."""
    import os
    import subprocess
    import sys
    import tempfile
    out: dict = {"mask": np.asarray(ENTRY_MASK)}
    secs: dict = {}
    t0 = time.perf_counter()
    out["quickstart"] = np.asarray(_printed(
        _load(REPO / "examples" / "quickstart.py", "quickstart").main))
    secs["quickstart"] = time.perf_counter() - t0
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            out["tour"] = np.asarray(_printed(_load(
                REPO / "examples" / "fabric_telemetry.py",
                "fabric_telemetry").main))
            secs["tour"] = time.perf_counter() - t0
            os.remove("fabric_trace.json")
            t0 = time.perf_counter()
            out["export"] = np.asarray(_printed(_load(
                REPO / "scripts" / "trace_export.py", "trace_export").main,
                []))
            secs["export"] = time.perf_counter() - t0
            text = Path("fabric_trace.json").read_text()
        finally:
            os.chdir(cwd)
    out["export_sha256"] = np.asarray(
        hashlib.sha256(text.encode()).hexdigest())
    import json
    out["export_events"] = np.asarray(len(json.loads(text)["traceEvents"]))
    for name, (args, extra) in ENTRY_CANARIES.items():
        env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
               "JAX_PLATFORMS": "cpu", **extra}
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", *args], env=env,
                             cwd=REPO, capture_output=True, text=True)
        secs[name] = time.perf_counter() - t0
        if run.returncode:
            raise RuntimeError(f"canary {name} failed:\n{run.stderr}")
        out[f"canary/{name}"] = np.asarray(run.stdout.splitlines())
    out.update({f"seconds/{k}": np.asarray(v) for k, v in secs.items()})
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"entry -> {path} ({path.stat().st_size} B); JAX seconds {secs}")


def _jnp(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def _jax_control_psn(inp: dict, size: dict) -> dict:
    import jax.numpy as jnp

    from repro.core import pds
    out = {}
    t = pds.PSNTracker.create(size["psn_n"], 1024)
    t = pds.PSNTracker(_jnp(inp["psn/base"]), t.ring, t.rx_ok, t.dup,
                       t.oor)
    for r in range(size["rounds"]):
        pdc = _jnp(inp[f"psn/pdc{r}"])
        psn = _jnp(inp[f"psn/psn{r}"])
        valid = _jnp(inp[f"psn/valid{r}"])
        off = (psn - t.base[jnp.where(valid, pdc, 0)]).astype(jnp.int32)
        mask, already = pds.or_mask(t.ring, pdc, off, valid)
        t, fresh = pds.record_rx(t, pdc, psn, valid)
        t, adv = pds.advance_cack(t)
        cack, lo, hi = pds.sack_view(t)
        for k, v in (("mask", mask), ("already", already), ("fresh", fresh),
                     ("adv", adv), ("cack", cack), ("lo", lo), ("hi", hi)):
            out[f"psn/{k}{r}"] = np.asarray(v)
    for k in ("base", "ring", "rx_ok", "dup", "oor"):
        out[f"psn/{k}"] = np.asarray(getattr(t, k))
    return out


def _jax_control_pdc(inp: dict, size: dict) -> dict:
    from repro.core import pdc
    out = {}

    def lane(k):
        return _jnp(inp[f"pdc/{k}"])
    pool = pdc.PDCPool.create(size["pdc_n"])
    pool = pdc.open_pdc(pool, lane("open_slot"), lane("open_peer"),
                        lane("open_psn"), lane("open_mode"))
    for f in dataclasses.fields(pool):
        out[f"pdc/open/{f.name}"] = np.asarray(getattr(pool, f.name))
    pool = pdc.on_ack(pool, lane("ack_slot"), lane("ack_remote"),
                      lane("ack_n"))
    for f in dataclasses.fields(pool):
        out[f"pdc/ack/{f.name}"] = np.asarray(getattr(pool, f.name))
    st = pool.state
    tg = np.zeros_like(np.asarray(st))
    for r in range(6):
        st = pdc.step_initiator(st, lane(f"init_ev{r}"))
        tg = pdc.step_target(tg, lane(f"tgt_ev{r}"))
        out[f"pdc/init{r}"], out[f"pdc/tgt{r}"] = np.asarray(st), np.asarray(tg)
        out[f"pdc/send{r}"] = np.asarray(pdc.may_send_data(st))
        out[f"pdc/accept{r}"] = np.asarray(pdc.may_accept_new_message(st))
    return out


def _jax_control_addr(inp: dict, size: dict) -> dict:
    from repro.core import addressing
    t = addressing.FEPTables.create(size["jobs"], size["pids"], size["ris"])
    t = addressing.FEPTables(t.jobid_keys, t.jobid_to_pid, t.pid_table,
                             t.ri_table, _jnp(inp["addr/service"]))
    for i, (slot, jobid) in enumerate(zip(inp["addr/slots"].tolist(),
                                          inp["addr/jobids"].tolist())):
        t = addressing.register_job(t, slot, jobid,
                                    _jnp(inp[f"addr/proc{i}"]),
                                    _jnp(inp[f"addr/ris{i}"]))
    ctx, ok = addressing.resolve(t, *(_jnp(inp[f"addr/{k}"]) for k in (
        "jobid", "pid", "ri", "rel")))
    out = {f"addr/{f.name}": np.asarray(getattr(t, f.name))
           for f in dataclasses.fields(t)}
    out["addr/ctx"], out["addr/ok"] = np.asarray(ctx), np.asarray(ok)
    return out


def _jax_control_match(inp: dict, size: dict) -> dict:
    from repro.core import matching
    from repro.core.types import Profile
    q = matching.RecvQueue.create(size["entries"])
    q = matching.post_receive(q, *(_jnp(inp[f"match/{k}"]) for k in (
        "slot", "hi", "lo", "mhi", "mlo", "init", "seq", "buf")))
    out = {f"match/q/{f.name}": np.asarray(getattr(q, f.name))
           for f in dataclasses.fields(q)}
    keys = [_jnp(inp[f"match/{k}"]) for k in ("khi", "klo", "kinit")]
    for prof in Profile:
        slot, ok = matching.match(q, *keys, prof)
        out[f"match/{prof.name}/slot"] = np.asarray(slot)
        out[f"match/{prof.name}/ok"] = np.asarray(ok)
        if prof == Profile.AI_FULL:
            consumed = matching.consume(q, slot, ok)
    slot, ok = matching.match(consumed, *keys, Profile.HPC)
    out["match/consumed/valid"] = np.asarray(consumed.valid)
    out["match/consumed/slot"] = np.asarray(slot)
    out["match/consumed/ok"] = np.asarray(ok)
    return out


def _jax_control_tss(inp: dict, size: dict) -> dict:
    import jax.numpy as jnp

    from repro.core import tss
    out = {}
    sd = tss.SecureDomain.create(size["members"], seed=0x5D)
    sd = tss.SecureDomain(sd.sdk, sd.iv_mask, sd.epoch + jnp.int32(3),
                          sd.an, _jnp(inp["tss/pkt_counter"]),
                          _jnp(inp["tss/key_packets"]))
    for r in range(size["iv_rounds"]):
        mem = _jnp(inp[f"tss/member{r}"])
        if r == size["iv_rounds"] // 2:
            sd = tss.rotate_key(sd)
        out[f"tss/key{r}"] = np.asarray(tss.source_key(sd, mem))
        sd, iv_hi, iv_lo = tss.iv_for_packet(sd, mem)
        out[f"tss/iv_hi{r}"] = np.asarray(iv_hi)
        out[f"tss/iv_lo{r}"] = np.asarray(iv_lo)
        out[f"tss/rot{r}"] = np.asarray(tss.needs_key_rotation(sd))
        out[f"tss/rot_shared{r}"] = np.asarray(
            tss.needs_key_rotation(sd, False))
    for f in dataclasses.fields(sd):
        out[f"tss/sd/{f.name}"] = np.asarray(getattr(sd, f.name))
    out["tss/kdf"] = np.asarray(tss.kdf(sd.sdk, _jnp(inp["tss/open_psn0"]),
                                        _jnp(inp["tss/close_last0"])))
    g = tss.PSNGuard(_jnp(inp["tss/start_psn"]),
                     _jnp(inp["tss/expected_psn"]))
    for r in range(4):
        g = tss.on_pdc_close(g, _jnp(inp[f"tss/close_peer{r}"]),
                             _jnp(inp[f"tss/close_last{r}"]))
        ok, nack = tss.accept_new_pdc(g, _jnp(inp[f"tss/open_peer{r}"]),
                                      _jnp(inp[f"tss/open_psn{r}"]))
        out[f"tss/accept{r}"], out[f"tss/nack{r}"] = (np.asarray(ok),
                                                      np.asarray(nack))
    out["tss/start_psn"] = np.asarray(g.start_psn)
    out["tss/expected_psn"] = np.asarray(g.expected_psn)
    out["tss/must_close"] = np.asarray(tss.pdc_must_close(
        _jnp(inp["tss/tx"])))
    return out


def _jax_control_nscc(inp: dict, size: dict, params: dict) -> dict:
    import jax.numpy as jnp

    from repro.core.cms import nscc
    p = nscc.NSCCParams(**params)

    def lane(k):
        return _jnp(inp[f"nscc/{k}"])
    st = nscc.NSCCState(lane("cwnd"), lane("epoch_acked"),
                        lane("epoch_lost"),
                        jnp.zeros_like(lane("epoch_lost")))
    out = {"nscc/case": np.asarray(nscc.classify(lane("ecn"), lane("rtt"),
                                                 p))}
    st = nscc.on_acks(st, p, lane("ccc"), lane("ecn"), lane("rtt"),
                      lane("valid"))
    out["nscc/acks_cwnd"] = np.asarray(st.cwnd)
    st = nscc.on_loss(st, lane("loss_ccc"), lane("loss_count"),
                      lane("valid"))
    st = nscc.apply_dfc_penalty(st, p, lane("dfc_ccc"), lane("penalty"),
                                lane("valid"))
    for f in dataclasses.fields(st):
        out[f"nscc/{f.name}"] = np.asarray(getattr(st, f.name))
    return out


def jax_control(inp: dict, size: dict, nscc_params: dict,
                parts=("psn", "pdc", "addr", "match", "tss", "nscc"),
                seconds: "dict | None" = None) -> dict:
    """Every part of the control batch through the JAX package, keyed as
    ``chip_smoke.run_control`` keys the port's outputs."""
    runs = {"psn": _jax_control_psn, "pdc": _jax_control_pdc,
            "addr": _jax_control_addr, "match": _jax_control_match,
            "tss": _jax_control_tss,
            "nscc": lambda i, s: _jax_control_nscc(i, s, nscc_params)}
    out = {}
    for part in parts:
        t0 = time.perf_counter()
        out.update(runs[part](inp, size))
        if seconds is not None:
            seconds[part] = time.perf_counter() - t0
    return out


def write_control(path: Path) -> None:
    """The JAX tour and the control batch at ``CONTROL_GOLDEN``."""
    import sys
    sys.path.insert(0, str(REPO))
    from chip_smoke import (CONTROL_GOLDEN, CONTROL_NSCC, control_digest,
                            control_inputs)
    out = {f"tour/{k}": np.asarray(v) for k, v in jax_tour().items()}
    out["tour_lines"] = np.asarray(jax_tour_lines())
    secs: dict = {}
    inp = control_inputs(CONTROL_GOLDEN)
    out["inputs_sha256"] = np.asarray(control_digest(inp))
    batch = jax_control(inp, CONTROL_GOLDEN, CONTROL_NSCC, seconds=secs)
    out.update({f"batch/{k}": v for k, v in batch.items()})
    out.update({f"seconds/{k}": np.asarray(v) for k, v in secs.items()})
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"control -> {path} ({path.stat().st_size} B); JAX seconds "
          f"per part {secs}")


def jax_lm(arch: str, size: dict) -> dict:
    """One arch of ``chip_smoke.py`` phase 9 (a) on the JAX package: the
    full forward's logits and aux, every decode step's logits and the
    final cache, as ``chip_smoke.run_lm`` names them."""
    import sys
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro.serve.serve_step import make_decode_step
    from repro_torch.models.lm import flatten, unflatten
    sys.path.insert(0, str(REPO))
    from chip_smoke import lm_inputs
    cfg = jconfigs.reduced(arch, seq=size["seq"])
    arrays, toks = lm_inputs(arch, size)
    params = unflatten({k: jnp.asarray(a) for k, a in arrays.items()})
    logits, aux, _ = jax.jit(jlm.build_forward(cfg, remat=False))(
        params, jnp.asarray(toks))
    step = jax.jit(make_decode_step(cfg))
    B, S = toks.shape
    cache = jlm.init_cache(cfg, B, S, jnp.float32)
    outs = []
    for i in range(S):
        lg, cache = step(params, cache, jnp.asarray(toks[:, i:i + 1]),
                         jnp.int32(i))
        outs.append(lg)
    out = {"logits": np.asarray(logits), "aux": np.asarray(aux),
           "decode": np.asarray(jnp.stack(outs, 1))}
    out.update({k: np.asarray(v) for k, v in flatten(cache, "cache/").items()})
    return out


def write_lm(path: Path) -> None:
    """The ten reduced archs of phase 9 (a) and the priced decode step of
    phase 9 (d)."""
    import sys
    from repro import configs as jconfigs
    from repro.serve.serve_step import serving_rate
    from repro_torch.models.lm import flatten
    sys.path.insert(0, str(REPO))
    from chip_smoke import LM_ARCH, LM_GOLDEN, LM_RATE, control_digest, \
        lm_inputs
    out = {}
    for arch in jconfigs.ARCH_NAMES:
        t0 = time.perf_counter()
        arrays, toks = lm_inputs(arch, LM_GOLDEN)
        out[f"{arch}/params_sha256"] = np.asarray(
            control_digest({**arrays, "tokens": toks}))
        out[f"{arch}/tokens"] = toks
        out.update({f"{arch}/{k}": v
                    for k, v in jax_lm(arch, LM_GOLDEN).items()})
        print(f"lm {arch}: {time.perf_counter() - t0:.1f} s")
    rate = serving_rate(jconfigs.get(LM_ARCH), **LM_RATE)
    out.update({k: np.asarray(v) for k, v in flatten(rate, "serve/").items()})
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"lm -> {path} ({path.stat().st_size} B); serving_rate {rate}")



@functools.lru_cache(maxsize=None)
def _jax_train_fn(arch: str, seq: int, microbatches: int):
    """The jitted (train step, step-1 gradients) of one reduced arch,
    built once per (arch, seq, microbatches)."""
    import sys
    import jax
    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro.train.optimizer import AdamWConfig
    from repro.train.train_step import (MOE_AUX_WEIGHT, chunked_ce_loss,
                                        make_train_step)
    sys.path.insert(0, str(REPO))
    from chip_smoke import TRAIN_OPT
    cfg = jconfigs.reduced(arch, seq=seq)
    step = make_train_step(cfg, opt_cfg=AdamWConfig(**TRAIN_OPT),
                           microbatches=microbatches)
    fwd = jlm.build_forward(cfg, remat=True, output="hidden")

    def loss(p, b):
        hidden, aux, _ = fwd(p, b["inputs"])
        return chunked_ce_loss(hidden, p["head"], b["labels"]) + \
            MOE_AUX_WEIGHT * aux

    return jax.jit(lambda p, o, b: (step(p, o, b), jax.grad(loss)(p, b)))


def jax_train(arch: str, size: dict, full: bool = False,
              microbatches: int = 1, inputs=None) -> dict:
    """One arch of ``chip_smoke.py`` phase 10 (a) on the JAX package,
    jitted: two steps of ``make_train_step`` on ``chip_smoke.train_inputs``
    (or on ``inputs``, a (params, batch) pair of numpy trees like it)
    and the step-1 gradients of its loss (``make_train_step``'s
    ``loss_fn``: the hidden forward with remat, ``chunked_ce_loss``, the
    MoE aux), recorded as ``chip_smoke.train_record`` names it."""
    import sys
    import jax.numpy as jnp
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.models.lm import flatten, unflatten
    sys.path.insert(0, str(REPO))
    from chip_smoke import TRAIN_OPT, train_inputs, train_record
    arrays, batch = inputs or train_inputs(arch, size)
    params = unflatten({k: jnp.asarray(a) for k, a in arrays.items()})
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    both = _jax_train_fn(arch, size["seq"], microbatches)
    opt = init_opt_state(params, AdamWConfig(**TRAIN_OPT))
    (p1, o1, m1), grads = both(params, opt, batch)
    (p2, o2, m2), _ = both(p1, o1, batch)

    def host(tree):
        return {k: np.asarray(v) for k, v in flatten(tree).items()}
    return train_record(host(m1), host(m2), host(grads), host(p2),
                        host(o2["m"]), host(o2["v"]), full)


def write_train(path: Path) -> None:
    """The ten reduced archs of phase 10 (a) and the derates of (d)."""
    import sys
    from repro import configs as jconfigs
    from repro.launch.roofline import uet_efficiencies
    sys.path.insert(0, str(REPO))
    from chip_smoke import (TRAIN_DERATE, TRAIN_GOLDEN, TRAIN_KINDS,
                            control_digest, train_inputs)
    out = {}
    for arch in jconfigs.ARCH_NAMES:
        t0 = time.perf_counter()
        arrays, batch = train_inputs(arch, TRAIN_GOLDEN)
        out[f"{arch}/inputs_sha256"] = np.asarray(
            control_digest({**arrays, **batch}))
        out.update({f"{arch}/{k}": v
                    for k, v in jax_train(arch, TRAIN_GOLDEN).items()})
        print(f"train {arch}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eff = uet_efficiencies(TRAIN_KINDS, **TRAIN_DERATE)
    out.update({f"derate/{k}": np.asarray(v) for k, v in eff.items()})
    print(f"derates {eff}: {time.perf_counter() - t0:.1f} s")
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"train -> {path} ({path.stat().st_size} B)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--which", default="fullsize",
                    choices=("fullsize", "profiles", "batch", "faults",
                             "inc", "link", "telemetry", "traffic",
                             "control", "lm", "train", "entry"))
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
    elif args.which == "telemetry":
        write_telemetry(args.out or OUT_TELEMETRY)
    elif args.which == "traffic":
        write_traffic(args.out or OUT_TRAFFIC)
    elif args.which == "control":
        write_control(args.out or OUT_CONTROL)
    elif args.which == "lm":
        write_lm(args.out or OUT_LM)
    elif args.which == "train":
        write_train(args.out or OUT_TRAIN)
    elif args.which == "entry":
        write_entry(args.out or OUT_ENTRY)
    else:
        write_profiles(args.out or OUT_PROFILES)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
