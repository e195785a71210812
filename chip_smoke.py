#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--out results.json]

Phases, one line each:

1. device — the card's name and power limit (``nvidia-smi``); no CUDA,
   no run: the script exits non-zero before printing any result.
2. build  — compile every CUDA kernel of the port from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, in parallel).
3. kernels — each of the ten kernels against its plain PyTorch
   version on the card, random inputs plus edge lanes, bitwise: the
   dense ``sack_fused`` / ``sack_advance`` and ``nack_mark`` at the main
   path's shapes (F = 2048 flows, W = 16 ring words, L = Q + 2F = 9216
   NACK lanes); the own-bit ``sack_fused_own`` / ``sack_advance_own``
   at N in {1, 33, 2048} x W in {1, 3, 8, 16, 17, 32}, and the in-place
   marks on the retransmit ring ``nack_mark_lanes`` (with and without a
   ROD mask), ``set_own_bit`` (with and without ``unless``) and
   ``clear_own_bit`` at F in {1, 33, 2048} x W in {1, 3, 16, 17, 32},
   each timed at the main shape; then the five tick kernels at the batch
   phase's shapes, B = 4 scenarios: the own-bit SACK forms and the row
   marks over B·F = 8192 rows, and ``nack_mark_lanes`` with the
   scenario stride (B x W in {1, 3, 8} x {1, 16, 17, 32} at F in
   {1, 33, 2048}, lanes as [B, L] slices of wider rows, out-of-range
   flows in every scenario), each bitwise and timed (kernel, plain,
   device, bound from the lanes, the rows they reach and a read and a
   write of each word marked); ``nscc_update`` (N = F = 2048) and
   ``ecmp_select`` (N = Q + F = 7168) at the entry-point path's shapes
   and at a pool of N = 2**24 lanes. Kernel and plain times (CUDA
   events, warm, median of 20) beside the bound (for the marks, the
   bytes this data needs: the lanes, and the rows and words they
   reach); each kernel's device time alone (``torch.profiler``, CUDA
   kernel time / launches). Then the sites: each tick kernel beside the
   dense composition that the tick ran before it (bit plane, old-bit
   test, dense kernel, and for the ACK site the clear of the ACKed bit;
   for the NACK site its lane arithmetic and the copying ``nack_mark``;
   for the RTO set, the retransmit clear and the RR_SLOTS mark the
   [F, W] plane, and the old-bit test for the last; a copy of each is
   kept here), bitwise, both timed with CUDA events in turns, with their
   device operations per call.
4. goldens — the two reference goldens (``tests/golden/fabric_golden.npz``)
   reproduced bitwise on the card: A through ``simulate``, B (REPS, a
   dead uplink, seed 0x5EED+3) through ``simulate_batch``, as its
   definition says.
5. full width — ``fat_tree3(k=16, pods=16)`` (1024 endpoints, Q = 5120)
   with two overlapping cross-pod permutations (F = 2048 flows of 256
   packets), ``SimParams()``: ``ai_full`` for ``max_ticks=4096`` (every
   flow completes), then the profile table's ``hpc()`` (hybrid CC,
   all-ROD), ``ai_base(lb=EVBITMAP)`` (RCCC) and an open-loop RR_SLOTS
   profile with ROD on odd flows, each for ``max_ticks=1024``. Each run's
   per-flow stats, final state lanes and counters are bitwise equal to
   the JAX references (``tests/golden/torch_port_fullsize.npz`` and
   ``torch_port_profiles.npz``, written by
   ``scripts/torch_port_reference.py``), and each tick kernel is
   launched as often per tick as the run's sites say (``PER_TICK``: the
   two SACK kernels once; ``nack_mark_lanes``, ``set_own_bit`` and
   ``clear_own_bit`` 1, 1, 1 under ``ai_full`` and ``ai_base``, 0, 0, 1
   under all-ROD ``hpc()``, whose tick has no selective-retransmit path
   or RTO mark, and 1, 3, 1 under RR_SLOTS, whose loss inference marks
   twice) and the entry-point forms never. Then the kernel entry points
   (``repro_torch.kernels.ops.nscc_update`` / ``ecmp_select`` /
   ``sack_fused`` / ``sack_advance`` / ``nack_mark``): one batched NSCC
   round over the hpc run's 2048 windows, the ECMP port choice of 7168
   packet lanes of the ai_full run, and the dense SACK forms and the
   copying NACK mark on the mixed run's final rings, checked against the
   plain versions and the tick's own routing.
   Then the batch: the same fabric and ``ai_full`` as B = 4 scenarios
   of one ``simulate_batch`` call (stats tier, ``max_ticks=4096``):
   seeds 0x5EED..0x5EED+3, lanes 0-1 healthy, lane 2's first edge-0
   uplink (``up1_table[0, 0]``) dead from tick 0, lane 3's flapping over
   [100, 400). Each lane's stats, final lanes and counters are bitwise
   equal to ``tests/golden/torch_port_batch.npz`` (the JAX
   ``simulate_batch``), lane 0 also to ``torch_port_fullsize.npz``;
   each tick kernel is launched once per tick for all four; the
   scenario-ticks per second beside the serial ``ai_full`` run's, and
   the peak memory.
   Then the faulted batch: the same fabric as B = 4 lanes of one
   ``simulate_batch`` call under ``TransportProfile.resilient()`` (RTO
   backoff, EV eviction, PDC teardown), ``SimParams(timeout_ticks=64,
   ooo_threshold=24)``, budget 2048, stats tier, seeds 0x5EED + b,
   fault-draw seed b: lane 0 gray links (1 % loss on edge switch 0's
   uplinks), lane 1 host 0 dead from tick 100 for good and host 1's NIC
   stalled over [100, 400), lane 2 PHY corruption (1 % BER on edge 1's
   uplinks, no link layer), lane 3 all of these and edge 0's first
   uplink dead from tick 0. Each lane's stats, final lanes (the
   recovery lanes included) and counters are bitwise equal to
   ``tests/golden/torch_port_faults.npz`` (the JAX ``simulate_batch``);
   lane 1 quarantines its four flows and stops before the budget, every
   other flow of every lane completes, some EV is evicted; each tick
   kernel is launched once per tick; scenario-ticks per second and peak
   memory beside the healthy batch's of the same call.
   Then the collectives: 32 concurrent tree all-reduces on the same
   fabric (group j = hosts {j + 32 i : i = 0..31}, root j, all 31
   children on other edge switches; 32 packets a rank; F = 1984 flows)
   as B = 2 lanes of one ``simulate_batch`` call under ``ai_full()`` with
   ``inc=True``, budget 4096: lane 0 with the groups' ``red`` ids, lane 1
   the same flows with ``red = -1`` (INC off as a data axis, the incast
   baseline). Each lane's horizon, stats lanes, ``inc_reduced`` /
   ``inc_emits``, counters and every final state lane but the packet and
   event buffers are bitwise equal to ``tests/golden/torch_port_inc.npz``
   (the JAX ``simulate_batch``); on lane 0 every non-root host receives
   what the schedule expects and the roots receive it less exactly the
   absorbed packets; each tick kernel is launched once per tick. Then
   the default ``collective_sweep()`` (15 scenarios, two profiles, a
   small leaf-spine, 1600 ticks) against the same golden.
   Then the link layer: the full-width ``ai_full`` traffic as B = 2
   lanes (1 % BER on edge 1's uplinks in lane 0, lane 1 healthy, seeds
   0x5EED and 0x5EED+1), ``SimParams(ticks=4096)``, once with
   ``link=LinkConfig.on(llr=True)`` and once with LLR + CBFC: each lane
   bitwise equal to ``tests/golden/torch_port_link.npz`` (horizon, stats
   lanes, ``llr_replays``, ``credit_stall_ticks``, trims, drops, every
   final state lane but the buffers), no drop on any lane, no trim under
   CBFC, each tick kernel once per tick. Both phases print
   scenario-ticks per second and peak memory beside the healthy
   batch's of the same call.
6. cross-device — the first 128-tick chunk of the ai_full run with
   ``trace="full"`` on the card and on the CPU (plain versions), bitwise.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failure raises and the script
exits non-zero. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "fabric_golden.npz"
FULLSIZE = ROOT / "tests" / "golden" / "torch_port_fullsize.npz"
PROFILES = ROOT / "tests" / "golden" / "torch_port_profiles.npz"
BATCH = ROOT / "tests" / "golden" / "torch_port_batch.npz"
FAULTS = ROOT / "tests" / "golden" / "torch_port_faults.npz"
INC = ROOT / "tests" / "golden" / "torch_port_inc.npz"
LINK = ROOT / "tests" / "golden" / "torch_port_link.npz"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit rate
F32_OPS_PER_S = 67e12       # H100 SXM non-tensor f32 rate
F_MAIN, W_MAIN, Q_MAIN = 2048, 16, 5120
POOL = 1 << 24              # a CCC-window / packet-lane pool at HBM rate
PROFILE_TICKS = 1024
KERNELS = {
    # name: (source in the repo, the TPU kernel it replaces, the symbol
    # of its CUDA kernel in a profiler trace)
    "sack_fused": ("src/repro_torch/kernels/csrc/sack.cu",
                   "src/repro/kernels/sack_fused.py:91",
                   "sack_kernel<true, false,"),
    "nack_mark": ("src/repro_torch/kernels/csrc/nack_mark.cu",
                  "src/repro/kernels/nack_mark.py:70",
                  "nack_mark_kernel<false,"),
    "sack_advance": ("src/repro_torch/kernels/csrc/sack.cu",
                     "src/repro/kernels/sack_bitmap.py:82",
                     "sack_kernel<false, false,"),
    "sack_fused_own": ("src/repro_torch/kernels/csrc/sack.cu",
                       "src/repro/kernels/sack_fused.py:91",
                       "sack_kernel<true, true,"),
    "sack_advance_own": ("src/repro_torch/kernels/csrc/sack.cu",
                         "src/repro/kernels/sack_bitmap.py:82",
                         "sack_kernel<false, true,"),
    "nack_mark_lanes": ("src/repro_torch/kernels/csrc/nack_mark.cu",
                        "src/repro/kernels/nack_mark.py:70",
                        "nack_mark_kernel<true,"),
    "set_own_bit": ("src/repro_torch/kernels/csrc/nack_mark.cu",
                    "src/repro/kernels/nack_mark.py:70",
                    "own_bit_kernel<true,"),
    "clear_own_bit": ("src/repro_torch/kernels/csrc/nack_mark.cu",
                      "src/repro/kernels/nack_mark.py:70",
                      "own_bit_kernel<false,"),
    "nscc_update": ("src/repro_torch/kernels/csrc/nscc_update.cu",
                    "src/repro/kernels/nscc_update.py:53",
                    "nscc_update_kernel"),
    "ecmp_select": ("src/repro_torch/kernels/csrc/ecmp_hash.cu",
                    "src/repro/kernels/ecmp_hash.py:52",
                    "ecmp_select_kernel"),
}
TICK_KERNELS = ("sack_fused_own", "sack_advance_own", "nack_mark_lanes",
                "set_own_bit", "clear_own_bit")
#: launches per tick of each tick kernel, by run: under all-ROD the NACK
#: site and the RTO's set are compiled out; RR_SLOTS's loss inference
#: adds two sets
PER_TICK = {"ai_full": (1, 1, 1, 1, 1), "hpc": (1, 1, 0, 0, 1),
            "base": (1, 1, 1, 1, 1), "mixed": (1, 1, 1, 3, 1),
            "resilient": (1, 1, 1, 1, 1), "inc": (1, 1, 1, 1, 1),
            "llr": (1, 1, 1, 1, 1), "cbfc": (1, 1, 1, 1, 1)}
#: SimState lanes the profile goldens leave out: those of the recovery
#: loop (RTO strikes, quarantine, their counters), of INC and of the link
#: layer, none of which the three profile runs turn on
UNRECORDED_LANES = ("ev_evictions", "rto_strikes", "quarantined",
                    "flows_abandoned", "ticks_unreachable", "inc.slot_psn",
                    "inc.slot_bits", "inc_reduced", "inc_emits",
                    "llr_busy_until", "llr_replays", "cbfc_consumed",
                    "cbfc_freed", "cbfc_ret", "credit_stall_ticks")
ENTRY_KERNELS = ("sack_fused", "sack_advance", "nack_mark", "nscc_update",
                 "ecmp_select")
OWN_WIDTHS = (1, 3, 8, 16, 17, 32)
OWN_ROWS = (1, 33, F_MAIN)
MARK_WIDTHS = (1, 3, 16, 17, 32)
B_MAIN = 4                  # scenarios of the batch phase
STRIDE_BATCHES = (1, 3, 8)
STRIDE_WIDTHS = (1, 16, 17, 32)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _i32(a: np.ndarray, dev) -> torch.Tensor:
    """uint32 words as the port's int32 bit patterns, on `dev`."""
    return torch.as_tensor(np.asarray(a, np.uint64).astype(np.uint32)
                           .view(np.int32)).to(dev)


def _median_ms(fn, reps: int = 20, inner: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return float(np.median(times))


def _max_abs_err(got, want) -> int:
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def _device_ms(fn, symbol: str, calls: int = 50) -> float:
    """Device time of one launch of the kernel named ``symbol``: its CUDA
    kernel time in a ``torch.profiler`` trace over its launch count. A
    trace now and then comes back without the kernel's records; it is
    taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for ev in prof.key_averages():
            if symbol.replace(" ", "") in ev.key.replace(" ", ""):
                us += float(ev.device_time_total)
                n += int(ev.count)
        if n and us > 0:
            return us / n / 1e3
    raise RuntimeError(f"three profiler traces hold no device time for "
                       f"{symbol}")


def _assert_bits(x: np.ndarray, y: np.ndarray, what: str) -> None:
    """Same dtype, shape and bytes (floats compared bit for bit)."""
    assert x.dtype == y.dtype and x.shape == y.shape, (what, x.dtype, y.dtype)
    assert x.tobytes() == y.tobytes(), what


def _assert_equal(got, want, what: str) -> None:
    """Bitwise: float outputs compare as their int32 bit patterns, so a
    NaN must match a NaN of the same bits."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.dtype != w.dtype or not torch.equal(g, w):
            bad = (g != w).nonzero()[:4].tolist()
            raise AssertionError(f"{what}: output {i} differs at {bad}")


# ------------------------------------------------------------------ phases

def phase_device() -> "tuple[str, dict]":
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script measures the CUDA card and has no CPU "
                         "fallback")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    say("1 device", f"{dev['kind']} x{dev['count']}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return smi, dev


def phase_build() -> dict:
    from repro_torch.kernels import build
    secs, logs = build.build_all()
    regs = {k: " | ".join(ln.strip() for ln in v.splitlines()
                          if "registers" in ln) for k, v in logs.items()}
    say("2 build", f"built {sorted(logs) or 'nothing (cached)'} in "
        f"{secs:.1f} s; ptxas: {regs}")
    return {"seconds": secs, "ptxas": regs}


def _sack_inputs(rng, n, w, dev):
    ring = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint64)
    # edge rows: leading full words of every length, empty, full, sparse
    for i in range(0, n, 7):
        k = (i // 7) % (w + 1)
        ring[i, :k] = 0xFFFFFFFF
        ring[i, k:] = rng.integers(0, 2 ** 32, w - k) >> rng.integers(0, 32)
    ring[1::97] = 0
    ring[2::97] = 0xFFFFFFFF
    base = rng.integers(0, 2 ** 32, n, dtype=np.uint64)
    base[::5] = 0xFFFFFFFF - rng.integers(0, 2048, base[::5].shape)
    rtx = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint64)
    mask = np.zeros((n, w), np.uint64)
    rows = rng.integers(0, n, n // 2)
    mask[rows, rng.integers(0, w, rows.size)] = (
        np.uint64(1) << rng.integers(0, 32, rows.size).astype(np.uint64))
    return (_i32(ring, dev), _i32(base, dev), _i32(rtx, dev),
            _i32(mask, dev))


def _nack_inputs(rng, f, w, lanes, dev):
    rtx = rng.integers(0, 2 ** 32, (f, w), dtype=np.uint64)
    rtx[::3] = 0
    flow = rng.integers(-2, f + 2, lanes)
    off = rng.integers(-4, w * 32 + 8, lanes)
    valid = rng.integers(0, 4, lanes) == 0
    # duplicates: the same (flow, bit) several times, and a negative row
    flow[:64], off[:64], valid[:64] = 5, 37, True
    flow[64:96], valid[64:96] = -1, True
    return (_i32(rtx, dev), torch.as_tensor(flow.astype(np.int32)).to(dev),
            torch.as_tensor(off.astype(np.int32)).to(dev),
            torch.as_tensor(valid).to(dev))


def _nscc_params():
    """The tick's NSCC params, the defaults, and a set whose target
    (base_rtt * target_factor) is not exact in f32."""
    from repro_torch.core.cms.nscc import NSCCParams
    return [NSCCParams(base_rtt=10.0, max_cwnd=48.0), NSCCParams(),
            NSCCParams(base_rtt=7.3, target_factor=1.1)]


def _nscc_inputs(rng, n, p, dev):
    """Random windows plus edge lanes: rtt 0, negative, +-inf, NaN and on
    the target; cwnd below 1 and NaN; count 0, negative and large."""
    target = np.float32(p.base_rtt * p.target_factor)
    cwnd = rng.uniform(0.25, p.max_cwnd * 1.2, n).astype(np.float32)
    ecn = rng.integers(0, 2, n).astype(bool)
    rtt = rng.uniform(0.0, 6.0 * float(target), n).astype(np.float32)
    cnt = rng.integers(-2, 6, n).astype(np.int32)
    edge_rtt = np.asarray([0.0, -3.5, np.inf, -np.inf, np.nan, target, 1e-7,
                           -0.0, 1e30, np.nextafter(target, np.float32(0))],
                          np.float32)
    for j, v in enumerate(edge_rtt):
        rtt[j::997] = v
    cwnd[3::1009] = 0.5
    cwnd[5::2003] = np.nan
    cwnd[7::4001] = 0.0
    cnt[1::89], cnt[2::89], cnt[4::89] = 0, -9, 1 << 30
    return (torch.as_tensor(cwnd).to(dev), torch.as_tensor(ecn).to(dev),
            torch.as_tensor(rtt).to(dev), torch.as_tensor(cnt).to(dev))


def _ecmp_inputs(rng, n, dev):
    """Four int32 lanes over the full range (negative = top bit set)."""
    lanes = [rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
             .astype(np.int32) for _ in range(4)]
    lanes[0][:4] = [-1, -2 ** 31, 2 ** 31 - 1, 0]
    return [torch.as_tensor(x).to(dev) for x in lanes]


def _time_row(name, kern, plain, args, nbytes, nops, fast=False,
              ops_per_s=INT_OPS_PER_S) -> dict:
    """Times and bound of one kernel on ``args`` (already checked)."""
    inner = 5 if fast else 50
    ms = _median_ms(lambda: kern(*args), inner=inner)
    plain_ms = _median_ms(lambda: plain(*args), inner=inner)
    dev_ms = _device_ms(lambda: kern(*args), KERNELS[name][2],
                        calls=20 if fast else 50)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = nops / ops_per_s * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "bytes": nbytes}


def phase_kernels() -> dict:
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    F, W, L = F_MAIN, W_MAIN, Q_MAIN + 2 * F_MAIN
    ring, base, rtx, mask = _sack_inputs(rng, F, W, dev)
    nrtx, flow, off, valid = _nack_inputs(rng, F, W, L, dev)
    cases = {
        "sack_fused": (ops.sack_fused_cuda, ref.sack_fused_ref,
                       (ring, base, rtx, mask),
                       # bytes: ring, rtx, mask, base in; ring, rtx,
                       # base, adv out. ops: ~24 per word
                       (3 * F * W + F) * 4 + (2 * F * W + 2 * F) * 4,
                       24 * F * W),
        "nack_mark": (ops.nack_mark_cuda, ref.nack_mark_ref,
                      (nrtx, flow, off, valid),
                      2 * F * W * 4 + L * (4 + 4 + 1), 8 * L),
        "sack_advance": (ops.sack_advance_cuda, ref.sack_advance_ref,
                         (ring, base),
                         (F * W + F) * 4 + (F * W + 2 * F) * 4, 16 * F * W),
    }
    rows = {}
    for name, (kern, plain, args, nbytes, nops) in cases.items():
        got, want = kern(*args), plain(*args)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        _assert_equal(got, want, name)
        rows[name] = _row(name, _max_abs_err(got, want),
                          _time_row(name, kern, plain, args, nbytes, nops))
        _say_row(name, rows[name], [tuple(a.shape) for a in args])
    # the own-bit SACK forms: bitwise at every width and row count, timed
    # at the main path's shape
    for n in OWN_ROWS:
        for w in OWN_WIDTHS:
            inputs = _own_inputs(rng, n, w, dev)
            for name, (kern, plain, args, _, _) in _own_cases(
                    *inputs).items():
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                _assert_equal(got, want, f"{name} n={n} w={w}")
    say("3 kernels", f"sack_fused_own, sack_advance_own: bitwise equal to "
        f"plain at N in {OWN_ROWS} x W in {OWN_WIDTHS}")
    for name, (kern, plain, args, nbytes, nops) in _own_cases(
            *_own_inputs(rng, F, W, dev)).items():
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        _assert_equal(got, want, name)
        rows[name] = _row(name, _max_abs_err(got, want),
                          _time_row(name, kern, plain, args, nbytes, nops))
        _say_row(name, rows[name], [tuple(a.shape) for a in args])
    # the in-place marks on the retransmit ring: bitwise at every width
    # and row count, each call on its own copy of the ring; timed at the
    # main path's shape
    for f in OWN_ROWS:
        for w in MARK_WIDTHS:
            for name, (kern, plain, args, _, _) in _mark_cases(
                    _mark_inputs(rng, f, w, dev)).items():
                got = kern(args[0].clone(), *args[1:])
                want = plain(args[0].clone(), *args[1:])
                torch.cuda.synchronize()
                _assert_equal((got,), (want,), f"{name} f={f} w={w}")
    say("3 kernels", f"nack_mark_lanes (with and without a ROD mask), "
        f"set_own_bit (with and without unless), clear_own_bit: bitwise "
        f"equal to plain at F in {OWN_ROWS} x W in {MARK_WIDTHS}")
    for name, (kern, plain, args, nbytes, nops) in _mark_cases(
            _mark_inputs(rng, F, W, dev)).items():
        if name not in KERNELS:    # a variant: checked above, not timed
            continue
        got = kern(args[0].clone(), *args[1:])
        want = plain(args[0].clone(), *args[1:])
        torch.cuda.synchronize()
        _assert_equal((got,), (want,), name)
        rows[name] = _row(name, _max_abs_err((got,), (want,)),
                          _time_row(name, kern, plain, args, nbytes, nops))
        _say_row(name, rows[name], [tuple(a.shape) for a in args])
    # the tick kernels at the batch phase's shapes: the NACK lanes with
    # the scenario stride, bitwise at every batch, row count and width
    # (with and without a ROD mask); then all five timed at B = 4
    for b in STRIDE_BATCHES:
        for f in OWN_ROWS:
            for w in STRIDE_WIDTHS:
                m = _stride_inputs(rng, b, f, w, dev)
                lanes = (m["rtx"], m["base"], m["flow"], m["psn"], m["nack"])
                for rod in (None, m["rod"]):
                    got = ops.nack_mark_lanes_cuda(lanes[0].clone(),
                                                   *lanes[1:], rod)
                    want = ref.nack_mark_lanes_ref_(lanes[0].clone(),
                                                    *lanes[1:], rod)
                    torch.cuda.synchronize()
                    _assert_equal((got,), (want,),
                                  f"nack_mark_lanes b={b} f={f} w={w}")
    say("3 kernels", f"nack_mark_lanes with the scenario stride ([B, L] "
        f"lane slices, flows -1, F, F + 3 and -2**31 in every scenario, "
        f"with and without a ROD mask): bitwise equal to plain at B in "
        f"{STRIDE_BATCHES} x F in {OWN_ROWS} x W in {STRIDE_WIDTHS}")
    for name, (kern, plain, args, nbytes, nops) in _batch_cases(
            rng, dev).items():
        got, want = kern(*_fresh(name, args)), plain(*_fresh(name, args))
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        _assert_equal(got, want, f"{name} b={B_MAIN}")
        rows[name]["batch"] = {
            "b": B_MAIN, "max_abs_err": _max_abs_err(got, want),
            **_time_row(name, kern, plain, args, nbytes, nops)}
        _say_row(f"{name} (B={B_MAIN})", rows[name]["batch"],
                 [tuple(a.shape) for a in args if a is not None])
    # the entry-point kernels: every params set / fanout, both sizes
    tick_params = _nscc_params()[0]
    for n in (F_MAIN, POOL):
        for p in _nscc_params():
            args = _nscc_inputs(rng, n, p, dev)
            got = ops.nscc_update_cuda(*args, p)
            want = ref.nscc_update_ref(*args, p)
            torch.cuda.synchronize()
            _assert_equal((got,), (want,), f"nscc_update n={n} {p}")
        args = _nscc_inputs(rng, n, tick_params, dev)
        timing = _time_row(
            "nscc_update", lambda *a: ops.nscc_update_cuda(*a, tick_params),
            lambda *a: ref.nscc_update_ref(*a, tick_params), args,
            n * (4 + 1 + 4 + 4) + n * 4, 20 * n, fast=n == POOL,
            ops_per_s=F32_OPS_PER_S)
        # the bitwise check above passed on every params set
        _record(rows, "nscc_update", n, 0.0, timing)
    for n in (Q_MAIN + F_MAIN, POOL):
        errs = []
        lanes = _ecmp_inputs(rng, n, dev)
        for fanout in (1, 2, 3, 7, 8, 13, 16, 32):
            got = ops.ecmp_select_cuda(*lanes, fanout)
            want = ref.ecmp_hash_ref(*lanes, fanout)
            torch.cuda.synchronize()
            _assert_equal((got,), (want,), f"ecmp_select n={n} f={fanout}")
            errs.append(_max_abs_err((got,), (want,)))
        # timed at the k=16 fat tree's fanout (8)
        timing = _time_row(
            "ecmp_select", lambda *a: ops.ecmp_select_cuda(*a, 8),
            lambda *a: ref.ecmp_hash_ref(*a, 8), lanes, n * 4 * 4 + n * 4,
            16 * n, fast=n == POOL)
        _record(rows, "ecmp_select", n, max(errs), timing)
    return rows


def _own_inputs(rng, n, w, dev):
    """Rings as ``_sack_inputs`` makes them and one PSN offset per row:
    mostly in [0, 32 W), with the edges -1, 31, 32 and 32 W first; ok on
    3 rows in 4, clear on the ok rows and 1 in 8 of the others."""
    ring, base, rtx, _ = _sack_inputs(rng, n, w, dev)
    off = rng.integers(-4, 32 * w + 4, n).astype(np.int32)
    k = min(n, 4)
    off[:k] = [-1, 31, 32, 32 * w][:k]
    ok = rng.integers(0, 4, n) > 0
    clear = ok | (rng.integers(0, 8, n) == 0)
    return (ring, base, rtx, torch.as_tensor(off).to(dev),
            torch.as_tensor(ok).to(dev), torch.as_tensor(clear).to(dev))


def _own_cases(ring, base, rtx, off, ok, clear) -> dict:
    from repro_torch.kernels import ops, ref
    f, w = ring.shape
    return {
        # bytes: ring, rtx, base, off in (4 B), ok, clear in (1 B); ring,
        # rtx, base, adv out (4 B), already out (1 B). ops: ~24 per word
        "sack_fused_own": (ops.sack_fused_own_cuda, ref.sack_fused_own_ref,
                           (ring, base, rtx, off, ok, clear),
                           16 * f * w + 19 * f, 24 * f * w),
        "sack_advance_own": (ops.sack_advance_own_cuda,
                             ref.sack_advance_own_ref, (ring, base, off, ok),
                             8 * f * w + 18 * f, 16 * f * w),
    }


def _mark_inputs(rng, f, w, dev) -> dict:
    """The in-place marks' operands at F rows of W words: the retransmit
    ring, a source ring (``unless``), the source CACK, L = Q + 2F NACK
    lanes (rows over [0, F), offsets over [-8, 32 W + 8), one lane in
    three not a NACK; then edge lanes: offsets -1, 32 W and the int32
    extremes, PSNs past the 2**32 and 2**31 wraps, duplicates, rows out
    of range, non-NACK lanes), a ROD mask, and one offset and valid lane
    per row with the edge offsets first."""
    lanes = Q_MAIN + 2 * f
    rtx = rng.integers(0, 2 ** 32, (f, w), dtype=np.uint64)
    rtx[::3] = 0
    ring = rng.integers(0, 2 ** 32, (f, w), dtype=np.uint64)
    ring[1::3] = 0
    base = rng.integers(0, 2 ** 32, f, dtype=np.uint64)
    base[::4] = 0xFFFFFFFF - rng.integers(0, 16, base[::4].shape)
    base[0], base[-1] = 0xFFFFFFF0, 0x7FFFFFF0
    flow = rng.integers(0, f, lanes)
    off = rng.integers(-8, 32 * w + 8, lanes)
    nack = rng.integers(0, 3, lanes) > 0
    edge_off = [-1, 0, 31, 32, 32 * w - 1, 32 * w, -(2 ** 31), 2 ** 31 - 1]
    edges = ([(0, o, True) for o in edge_off + [16, 17]]
             + [(f - 1, 17, True)] * 8
             + [(r, 3, True) for r in (-1, f, f + 3, -(2 ** 31))]
             + [(0, 2, False)] * 4)
    for i, (r, o, v) in enumerate(edges):
        flow[i], off[i], nack[i] = r, o, v
    psn = (base[np.clip(flow, 0, f - 1)].astype(np.int64) + off) % 2 ** 32
    rod = rng.integers(0, 2, f).astype(bool)
    rod[0] = False
    roff = rng.integers(-8, 32 * w + 8, f)
    k = min(f, len(edge_off))
    roff[:k] = edge_off[:k]
    t = lambda a: torch.as_tensor(a).to(dev)   # noqa: E731
    return {"rtx": _i32(rtx, dev), "ring": _i32(ring, dev),
            "base": _i32(base, dev), "flow": t(flow.astype(np.int32)),
            "psn": _i32(psn, dev), "nack": t(nack), "rod": t(rod),
            "off": t(roff.astype(np.int32)),
            "valid": t(rng.integers(0, 4, f) > 0)}


def _stride_inputs(rng, b, f, w, dev) -> dict:
    """B scenarios of ``_mark_inputs``: [B, F, W] rings, [B, F] bases
    and [B, L] NACK lanes handed over as the tick hands them, the
    [:, Q:] slice of [B, Q + L] rows; one [F] ROD mask for all."""
    per = [_mark_inputs(rng, f, w, dev) for _ in range(b)]
    out = {k: torch.stack([m[k] for m in per])
           for k in ("rtx", "ring", "base", "off", "valid")}
    for k in ("flow", "psn", "nack"):
        wide = torch.zeros((b, Q_MAIN + per[0][k].numel()),
                           dtype=per[0][k].dtype, device=dev)
        wide[:, Q_MAIN:] = torch.stack([m[k] for m in per])
        out[k] = wide[:, Q_MAIN:]
    out["rod"] = per[0]["rod"]
    return out


def _batch_cases(rng, dev) -> dict:
    """name -> (kernel, plain, args, bytes, ops) of the five tick
    kernels at the batch phase's shapes: B = 4 scenarios of F = 2048
    rows of W = 16 words, the row forms over the [B·F, W] view the tick
    hands them, the NACK lanes as [B, L] slices with the stride."""
    from repro_torch.kernels import ops, ref
    n = B_MAIN * F_MAIN
    cases = dict(_own_cases(*_own_inputs(rng, n, W_MAIN, dev)))
    rows = _mark_cases(_mark_inputs(rng, n, W_MAIN, dev))
    cases["set_own_bit"] = rows["set_own_bit"]
    cases["clear_own_bit"] = rows["clear_own_bit"]
    m = _stride_inputs(rng, B_MAIN, F_MAIN, W_MAIN, dev)
    lanes = (m["rtx"], m["base"], m["flow"], m["psn"], m["nack"])
    cases["nack_mark_lanes"] = (ops.nack_mark_lanes_cuda,
                                ref.nack_mark_lanes_ref_, lanes,
                                _lane_bytes(*lanes), 10 * m["flow"].numel())
    return cases


def _fresh(name, args):
    """An in-place form's arguments with a copy of the ring it writes."""
    if name in ("nack_mark_lanes", "set_own_bit", "clear_own_bit"):
        return (args[0].clone(), *args[1:])
    return args


def _lane_bytes(rtx, base, flow, psn, nack, rod=None) -> int:
    """The bytes the NACK lanes need on this data: each lane's flow, PSN
    and flag; base (and rod) of each row a NACK lane reaches (scenario
    b's flow f is row b*F + f of a [B, F, W] ring); a read and a write
    of each word it marks."""
    from repro_torch.core.types import scenario_rows
    f, w = rtx.shape[-2:]
    reach = nack & (flow >= 0) & (flow < f)
    row = torch.where(reach, scenario_rows(flow, f) + flow, 0).long()
    off = psn - base.reshape(-1)[row]
    ok = reach & (off >= 0) & (off < 32 * w)
    if rod is not None:
        ok = ok & ~rod[torch.where(reach, flow, 0).long()]
    rows = int(torch.unique(row[reach]).numel())
    words = int(torch.unique(row[ok] * w + (off[ok] // 32)).numel())
    return (flow.numel() * 9 + rows * (4 + (rod is not None))
            + words * 8)


def _row_bytes(rtx, off, valid, unless=None) -> int:
    """The bytes one bit per row needs on this data: each row's offset
    and flag; for each row in range, its ``unless`` word and a read and
    a write of its word where the bit is not blocked."""
    n, w = rtx.shape
    ok = valid & (off >= 0) & (off < 32 * w)
    k = int(ok.sum())
    if unless is None:
        return n * 5 + k * 8
    o = off.clamp(0, 32 * w - 1).long()
    word = unless.gather(1, (o // 32)[:, None])[:, 0]
    blocked = ok & (((word >> (o % 32)) & 1) != 0)
    return n * 5 + k * 4 + (k - int(blocked.sum())) * 8


def _mark_cases(m) -> dict:
    """name -> (kernel, plain, args, bytes, ops) of the in-place marks;
    ``args[0]`` is the ring each call writes. The names with a space are
    variants, checked but not timed."""
    from repro_torch.kernels import ops, ref
    lanes = (m["rtx"], m["base"], m["flow"], m["psn"], m["nack"])
    rows = (m["rtx"], m["off"], m["valid"])
    n_lanes, n_rows = m["flow"].numel(), m["off"].numel()
    return {
        "nack_mark_lanes": (ops.nack_mark_lanes_cuda,
                            ref.nack_mark_lanes_ref_, lanes,
                            _lane_bytes(*lanes), 10 * n_lanes),
        "nack_mark_lanes rod": (ops.nack_mark_lanes_cuda,
                                ref.nack_mark_lanes_ref_,
                                lanes + (m["rod"],),
                                _lane_bytes(*lanes, m["rod"]), 10 * n_lanes),
        "set_own_bit": (ops.set_own_bit_cuda, ref.set_own_bit_ref_, rows,
                        _row_bytes(*rows), 8 * n_rows),
        "set_own_bit unless": (ops.set_own_bit_cuda, ref.set_own_bit_ref_,
                               rows + (m["ring"],),
                               _row_bytes(*rows, m["ring"]), 10 * n_rows),
        "clear_own_bit": (ops.clear_own_bit_cuda, ref.clear_own_bit_ref_,
                          rows, _row_bytes(*rows), 8 * n_rows),
    }


def _site_fused_dense(ring, base, rtx, off, ok, clear):
    """The tick's ACK site as it ran before the own-bit kernel, kept as
    the yardstick: the old bit's test, the [F, W] bit plane, the dense
    ``sack_fused`` and the clear of the ACKed bit against the new base.
    ``ok`` is the tick's ``ack_in_range`` (range already tested)."""
    from repro_torch._u32 import bit
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import (_bit_plane, _clear_own_bit,
                                            _own_word)
    w = ring.shape[1]
    already = ok & ((_own_word(ring, off) & bit(off % 32)) != 0)
    ring, base, rtx, adv = ops.sack_fused(ring, base, rtx,
                                          _bit_plane(off, ok, w))
    return ring, base, _clear_own_bit(rtx, off - adv, clear), adv, already


def _site_advance_dense(ring, base, off, ok):
    """The tick's delivery site as it ran before the own-bit kernel: the
    old bit's test, the bit plane's OR and the dense ``sack_advance``."""
    from repro_torch._u32 import bit
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import _bit_plane, _own_word
    already = ok & ((_own_word(ring, off) & bit(off % 32)) != 0)
    ring, base, adv = ops.sack_advance(
        ring | _bit_plane(off, ok, ring.shape[1]), base)
    return ring, base, adv, already


def _site_nack_dense(rtx, base, flow, psn, nack, rod=None):
    """The tick's NACK site as it ran before the lane kernel: the lane
    arithmetic (offset from the source CACK, range and ROD tests, clip)
    and the copying ``nack_mark``."""
    from repro_torch.kernels import ops
    mp = 32 * rtx.shape[1]
    safe = torch.where(nack, flow, 0).long()
    off = psn - base[safe]
    ok = nack & (off >= 0) & (off < mp)
    if rod is not None:
        ok = ok & ~rod[safe]
    return ops.nack_mark(rtx, flow, off.clamp(0, mp - 1), ok)


def _site_rr_dense(rtx, off, valid, ring):
    """The tick's RR_SLOTS mark as it ran before the row kernel: the
    ``_own_word`` test of the source ring and ``_set_own_bit``."""
    from repro_torch._u32 import bit
    from repro_torch.network.fabric import _own_word, _set_own_bit
    w_i = off.clamp(0, 32 * rtx.shape[1] - 1)
    sacked = (_own_word(ring, off) & bit(w_i % 32)) != 0
    return _set_own_bit(rtx, off, valid & ~sacked)


def _device_ops(fn, calls: int = 10) -> float:
    """Device operations (kernels, memsets, copies) per call of ``fn``:
    the most that any of three traces holds."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):   # a trace now and then comes back with records lost
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    if not max(counts):
        raise RuntimeError("three profiler traces hold no device operation")
    return max(counts) / calls


def phase_sites() -> dict:
    """Each tick kernel beside the composition it replaced on the tick,
    on the same inputs at the main path's shape: bitwise equal, and both
    timed with CUDA events in turns (dense, own, own, dense). The
    in-place forms write into ``args[0]``: each is checked on its own
    copy, and timed on one of its own."""
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import _clear_own_bit, _set_own_bit
    dev = torch.device("cuda")
    rng = np.random.default_rng(1313)
    ring, base, rtx, off, ok, clear = _own_inputs(rng, F_MAIN, W_MAIN, dev)
    ok = ok & (off >= 0) & (off < 32 * W_MAIN)   # the tick's range test
    m = _mark_inputs(rng, F_MAIN, W_MAIN, dev)
    # the tick's NACK lanes reach rows in range only
    m["flow"] = m["flow"].clamp(0, F_MAIN - 1)
    lanes = (m["rtx"], m["base"], m["flow"], m["psn"], m["nack"])
    zeros = torch.zeros_like(m["off"])
    sites = {
        "sack_fused_own": (_site_fused_dense, ops.sack_fused_own,
                           (ring, base, rtx, off, ok, clear)),
        "sack_advance_own": (_site_advance_dense, ops.sack_advance_own,
                             (ring, base, off, ok)),
        "nack_mark_lanes": (_site_nack_dense, ops.nack_mark_lanes_, lanes),
        "set_own_bit rto": (_set_own_bit, ops.set_own_bit_,
                            (m["rtx"], zeros, m["valid"])),
        "clear_own_bit": (_clear_own_bit, ops.clear_own_bit_,
                          (m["rtx"], m["off"], m["valid"])),
        "set_own_bit rr_slots": (
            _site_rr_dense,
            lambda r, o, v, u: ops.set_own_bit_(r, o, v, unless=u),
            (m["rtx"], m["off"], m["valid"], m["ring"])),
    }
    out = {}
    for name, (dense, own, args) in sites.items():
        got = own(args[0].clone(), *args[1:])
        want = dense(*args)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        torch.cuda.synchronize()
        _assert_equal(got, want, f"site {name}")
        own_args = (args[0].clone(), *args[1:])
        t = [_median_ms(lambda f=f, a=a: f(*a))
             for f, a in ((dense, args), (own, own_args), (own, own_args),
                          (dense, args))]
        out[name] = {"dense_ms": (t[0] + t[3]) / 2, "own_ms": (t[1] + t[2]) / 2,
                     "dense_ms_runs": [t[0], t[3]],
                     "own_ms_runs": [t[1], t[2]],
                     "dense_device_ops": _device_ops(lambda: dense(*args)),
                     "own_device_ops": _device_ops(lambda: own(*own_args))}
        r = out[name]
        say("3 sites", f"{name}: bitwise equal to the dense composition it "
            f"replaced at F={F_MAIN}, W={W_MAIN}; dense {r['dense_ms'] * 1e3:.2f} us "
            f"({r['dense_device_ops']:.0f} device ops), own "
            f"{r['own_ms'] * 1e3:.2f} us ({r['own_device_ops']:.0f} device ops)")
    return out


def _row(name, err, timing) -> dict:
    return {"name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": None,
            "max_abs_err": err, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": None,
            "device_ms": timing["device_ms"], "bytes": timing["bytes"]}


def _record(rows, name, n, err, timing) -> None:
    """The main-size measurement is the kernel's row; the pool's goes
    beside it under ``pool``."""
    if n == POOL:
        rows[name]["pool"] = {"n": n, "max_abs_err": err, **timing}
        _say_row(name, rows[name]["pool"], [(n,)])
    else:
        rows[name] = _row(name, err, timing)
        _say_row(name, rows[name], [(n,)])


def _say_row(name, r, shapes) -> None:
    say("3 kernels", f"{name}: bitwise equal to plain at {shapes}; kernel "
        f"{r['ms'] * 1e3:.2f} us (device {r['device_ms'] * 1e3:.3f} us), plain {r['plain_ms'] * 1e3:.2f} us, bound "
        f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}, {r['bytes']} B)")


def _golden_configs():
    from repro_torch.core.lb.schemes import LBScheme
    from repro_torch.network.fabric import SimParams, Workload
    from repro_torch.network.profile import TransportProfile
    from repro_torch.network.topology import leaf_spine
    gold = np.load(GOLDEN)
    a = (leaf_spine(leaves=2, spines=4, hosts_per_leaf=4),
         Workload.of([0, 1, 2], [4, 5, 6], 200), TransportProfile.ai_full(),
         SimParams(ticks=300), {})
    b = (leaf_spine(leaves=2, spines=4, hosts_per_leaf=8),
         Workload.of(list(range(8)), [8 + i for i in range(8)], 700),
         TransportProfile.ai_full(lb=LBScheme.REPS),
         SimParams(ticks=400, timeout_ticks=64, ooo_threshold=24),
         {"failed": [int(gold["b_failed_queue"][0])], "seed": 0x5EED + 3})
    return gold, {"a": a, "b": b}


def phase_goldens() -> dict:
    from repro_torch.network.fabric import simulate, simulate_batch
    gold, cfgs = _golden_configs()
    out = {}
    for tag, (g, wl, prof, p, kw) in cfgs.items():
        if tag == "a":
            r = simulate(g, wl, prof, p, trace="full", device="cuda")
        else:   # golden B is the batched run, as its definition says
            mask = np.zeros((1, g.num_queues), bool)
            mask[0, kw["failed"]] = True
            r = simulate_batch(g, [wl], prof, p, failed=mask,
                               seeds=np.asarray([kw["seed"]], np.uint32),
                               trace="full", device="cuda")[0]
        h = r.horizon
        for lane, key in (("delivered_per_tick", "delivered"),
                          ("cwnd_per_tick", "cwnd"), ("qlen_max", "qlen")):
            _assert_bits(getattr(r, lane), gold[f"{tag}_{key}"][:h],
                         f"golden {tag} {lane}")
        # the run stopped early only where the golden tail is inert
        assert not gold[f"{tag}_delivered"][h:].any(), tag
        _assert_bits(r.state.delivered.cpu().numpy(),
                     gold[f"{tag}_state_delivered"], f"golden {tag} delivered")
        _assert_bits(r.state.src_track.base.cpu().numpy().view(np.uint32),
                     gold[f"{tag}_state_src_base"], f"golden {tag} src_base")
        out[tag] = h
        say("4 goldens", f"golden {tag.upper()} bitwise on the card "
            f"(horizon {h}{', through simulate_batch' if tag == 'b' else ''})")
    return out


def _fullsize():
    from repro_torch.network.fabric import SimParams, Workload
    from repro_torch.network.profile import TransportProfile
    from repro_torch.network.topology import fat_tree3
    ref = np.load(FULLSIZE)
    h = np.arange(1024, dtype=np.int32)
    src = np.concatenate([h, h])
    dst = np.concatenate([(h + 512) % 1024, (h + 256) % 1024])
    assert np.array_equal(src, ref["src"]) and np.array_equal(dst, ref["dst"])
    g = fat_tree3(k=16, pods=16)
    assert g.num_queues == Q_MAIN and g.num_hosts == 1024
    return (ref, g, Workload.of(src, dst, 256), TransportProfile.ai_full(),
            SimParams())


def phase_fullwidth() -> dict:
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import simulate
    ref, g, wl, prof, p = _fullsize()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    r = simulate(g, wl, prof, p, trace="stats", max_ticks=4096,
                 device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    assert (r.stat_completion >= 0).all(), "every flow must complete"
    _assert_launches("ai_full", launches, r.horizon)
    s = r.state
    checks = {
        "stat_completion": r.stat_completion,
        "stat_src_completion": r.stat_src_completion,
        "delivered": s.delivered.cpu().numpy(),
        "next_psn": s.next_psn.cpu().numpy(),
        "src_base": s.src_track.base.cpu().numpy().view(np.uint32),
        "dst_base": s.dst_track.base.cpu().numpy().view(np.uint32),
        "cwnd": s.cc.cwnd.cpu().numpy(),
    }
    for k, v in checks.items():
        _assert_bits(v, ref[k], k)
    scalars = {"horizon": r.horizon, "trims": r.trims, "drops": r.drops,
               "dups": r.dups, "retransmits": r.rtx_packets,
               "timeouts": r.timeouts, "qlen_peak": r.qlen_peak}
    for k, v in scalars.items():
        assert v == int(ref[k]), (k, v, int(ref[k]))
    res = {"seconds": secs, "ticks_per_s": r.horizon / secs,
           "peak_bytes": peak, "launches": launches, **scalars,
           "completion_min": int(r.stat_completion.min()),
           "completion_max": int(r.stat_completion.max())}
    say("5 full width", f"{g.name} F={wl.src.shape[0]}: all complete "
        f"(ticks {res['completion_min']}..{res['completion_max']}), "
        f"horizon {r.horizon}, {res['ticks_per_s']:.1f} ticks/s "
        f"({secs:.2f} s), peak {peak / 2 ** 30:.2f} GiB, launches "
        f"{launches}; bitwise equal to the JAX reference {scalars}")
    return res


def phase_batch(serial: dict) -> dict:
    """The full-width ``ai_full`` fabric as B = 4 scenarios of one
    ``simulate_batch`` call, against the JAX ``simulate_batch`` golden;
    ``serial`` is phase 5's one-scenario run of the same call."""
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import simulate_batch
    from repro_torch.network.faults import FaultSchedule
    full, g, wl, prof, p = _fullsize()
    gold = np.load(BATCH)
    seeds = gold["seeds"]
    q = int(g.up1_table[0, 0])
    assert q == int(gold["fail_queue"]), "the flapping uplink"
    ok = FaultSchedule.healthy(g.num_queues)
    faults = FaultSchedule.stack([ok, ok, ok.flap(q, 0), ok.flap(q, 100, 400)])
    assert np.array_equal(faults.fail_at.numpy(), gold["fail_at"])
    assert np.array_equal(faults.heal_at.numpy(), gold["heal_at"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    rs = simulate_batch(g, [wl] * B_MAIN, prof, p, faults=faults,
                        seeds=seeds, trace="stats", max_ticks=4096,
                        device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    horizons = [r.horizon for r in rs]
    # every scenario steps every tick until the last one stops: one
    # launch per tick kernel per tick for all four
    _assert_launches("ai_full", launches, max(horizons))
    for b, r in enumerate(rs):
        s = r.state
        lanes = {
            "stat_completion": r.stat_completion,
            "stat_src_completion": r.stat_src_completion,
            "delivered": s.delivered.cpu().numpy(),
            "next_psn": s.next_psn.cpu().numpy(),
            "src_base": s.src_track.base.cpu().numpy().view(np.uint32),
            "dst_base": s.dst_track.base.cpu().numpy().view(np.uint32),
            "cwnd": s.cc.cwnd.cpu().numpy(),
        }
        scalars = {"horizon": r.horizon, "trims": r.trims,
                   "drops": r.drops, "dups": r.dups,
                   "retransmits": r.rtx_packets, "timeouts": r.timeouts,
                   "qlen_peak": r.qlen_peak,
                   "ticks_degraded": r.ticks_degraded}
        for k, v in lanes.items():
            _assert_bits(v, gold[f"b{b}/{k}"], f"batch lane {b} {k}")
        for k, v in scalars.items():
            assert v == int(gold[f"b{b}/{k}"]), (b, k, v)
        if b == 0:   # lane 0 is the serial full-width run
            for k, v in lanes.items():
                _assert_bits(v, full[k], f"batch lane 0 {k} vs fullsize")
    sticks = sum(horizons)
    res = {"b": B_MAIN, "seconds": secs, "horizons": horizons,
           "ticks_run": max(horizons), "scenario_ticks": sticks,
           "scenario_ticks_per_s": sticks / secs,
           "lane_ticks_per_s": B_MAIN * max(horizons) / secs,
           "serial_ticks_per_s": serial["ticks_per_s"],
           "peak_bytes": peak, "serial_peak_bytes": serial["peak_bytes"],
           "launches": launches,
           "drops": [r.drops for r in rs],
           "timeouts": [r.timeouts for r in rs]}
    say("5 batch", f"B={B_MAIN} scenario-ticks/s {res['scenario_ticks_per_s']:.1f} "
        f"({sticks} scenario-ticks in {secs:.2f} s; all lanes stepped "
        f"{max(horizons)} ticks, {res['lane_ticks_per_s']:.1f} lane-ticks/s) "
        f"against the serial ai_full run's {serial['ticks_per_s']:.1f} "
        f"ticks/s")
    say("5 batch", f"peak {peak / 2 ** 30:.2f} GiB against the serial "
        f"run's {serial['peak_bytes'] / 2 ** 30:.2f} GiB")
    say("5 batch", f"{g.name} F={wl.src.shape[0]} x B={B_MAIN} (seeds "
        f"{[hex(int(x)) for x in seeds]}, uplink {q} dead / flapping on "
        f"lanes 2 / 3): horizons {horizons}, drops {res['drops']}, "
        f"timeouts {res['timeouts']}; every lane bitwise equal to the JAX "
        f"simulate_batch golden, lane 0 to the serial one; launches "
        f"{launches}")
    return res


def fault_schedule(g):
    """The faulted batch's [4, Q] / [4, H] schedule, as
    ``scripts/torch_port_reference.py`` builds it for the golden."""
    from repro_torch.network.faults import FaultSchedule
    up0 = [int(q) for q in g.up1_table[0, :]]
    up1 = [int(q) for q in g.up1_table[1, :]]
    ok = FaultSchedule.healthy(g.num_queues, num_hosts=g.num_hosts)
    lanes = [
        ok.lossy(up0, 0.01),
        ok.host_fail(0, 100).nic_stall(1, 100, 400),
        ok.corrupt(up1, 0.01),
        ok.lossy(up0, 0.01).host_fail(0, 100).nic_stall(1, 100, 400)
        .corrupt(up1, 0.01).flap(up0[0], 0),
    ]
    return FaultSchedule.stack([s.with_seed(b) for b, s in enumerate(lanes)])


def phase_faults(batch: dict) -> dict:
    """The full-width fabric as B = 4 faulted lanes of one
    ``simulate_batch`` call under ``resilient()``, against the JAX
    golden; ``batch`` is the healthy batch phase of the same call."""
    from dataclasses import fields
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import SimParams, simulate_batch
    from repro_torch.network.profile import TransportProfile
    _, g, wl, _, _ = _fullsize()
    gold = np.load(FAULTS)
    sched = fault_schedule(g)
    for f in fields(sched):
        got = getattr(sched, f.name).numpy()
        want = gold[f"sched.{f.name}"]
        _assert_bits(got.view(want.dtype) if f.name == "seed" else got,
                     want, f"schedule lane {f.name}")
    p = SimParams(timeout_ticks=int(gold["timeout_ticks"]),
                  ooo_threshold=int(gold["ooo_threshold"]))
    budget = int(gold["max_ticks"])
    prof = TransportProfile.resilient()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    rs = simulate_batch(g, [wl] * B_MAIN, prof, p, faults=sched,
                        seeds=gold["seeds"], trace="stats",
                        max_ticks=budget, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    horizons = [r.horizon for r in rs]
    _assert_launches("resilient", launches, max(horizons))
    for b, r in enumerate(rs):
        s = r.state
        lanes = {
            "stat_completion": r.stat_completion,
            "stat_src_completion": r.stat_src_completion,
            "delivered": s.delivered.cpu().numpy(),
            "next_psn": s.next_psn.cpu().numpy(),
            "src_base": s.src_track.base.cpu().numpy().view(np.uint32),
            "dst_base": s.dst_track.base.cpu().numpy().view(np.uint32),
            "cwnd": s.cc.cwnd.cpu().numpy(),
            "rto": s.rto.cpu().numpy(),
            "rto_strikes": s.rto_strikes.cpu().numpy(),
            "quarantined": s.quarantined.cpu().numpy(),
            "inflight": s.inflight.cpu().numpy(),
            "bad_n": s.lb.bad_n.cpu().numpy(),
            "last_ev": s.lb.last_ev.cpu().numpy(),
            "bad_ev": s.lb.bad_ev.cpu().numpy(),
            "ev_set": s.lb.ev_set.cpu().numpy(),
        }
        scalars = {"horizon": r.horizon, "trims": r.trims,
                   "drops": r.drops, "dups": r.dups,
                   "retransmits": r.rtx_packets, "timeouts": r.timeouts,
                   "qlen_peak": r.qlen_peak,
                   "ticks_degraded": r.ticks_degraded,
                   "ev_evictions": r.ev_evictions,
                   "flows_abandoned": r.flows_abandoned,
                   "ticks_unreachable": r.ticks_unreachable,
                   "abandon_tick": r.abandon_tick}
        for k, v in lanes.items():
            _assert_bits(v, gold[f"b{b}/{k}"], f"faulted lane {b} {k}")
        for k, v in scalars.items():
            assert v == int(gold[f"b{b}/{k}"]), (b, k, v)
        settled = (r.stat_completion >= 0) | lanes["quarantined"]
        assert settled.all(), f"faulted lane {b}: a live flow is unfinished"
    dead = rs[1]
    assert dead.flows_abandoned > 0 and dead.abandon_tick >= 0
    assert dead.horizon < budget, "lane 1 must quiesce before the budget"
    assert all(r.flows_abandoned == 0 for r in rs[::2]), "lanes 0 and 2"
    assert sum(r.ev_evictions for r in rs) > 0, "no EV was evicted"
    sticks = sum(horizons)
    res = {"b": B_MAIN, "seconds": secs, "horizons": horizons,
           "ticks_run": max(horizons), "scenario_ticks": sticks,
           "scenario_ticks_per_s": sticks / secs,
           "lane_ticks_per_s": B_MAIN * max(horizons) / secs,
           "healthy_scenario_ticks_per_s": batch["scenario_ticks_per_s"],
           "healthy_lane_ticks_per_s": batch["lane_ticks_per_s"],
           "peak_bytes": peak, "healthy_peak_bytes": batch["peak_bytes"],
           "launches": launches,
           **{k: [getattr(r, k) for r in rs] for k in (
               "drops", "timeouts", "rtx_packets", "ev_evictions",
               "flows_abandoned", "ticks_unreachable", "abandon_tick")}}
    say("5 faults", f"B={B_MAIN} scenario-ticks/s "
        f"{res['scenario_ticks_per_s']:.1f} ({sticks} scenario-ticks in "
        f"{secs:.2f} s; all lanes stepped {max(horizons)} ticks, "
        f"{res['lane_ticks_per_s']:.1f} lane-ticks/s) against the healthy "
        f"batch's {batch['scenario_ticks_per_s']:.1f} scenario-ticks/s "
        f"({batch['lane_ticks_per_s']:.1f} lane-ticks/s)")
    say("5 faults", f"peak {peak / 2 ** 30:.2f} GiB against the healthy "
        f"batch's {batch['peak_bytes'] / 2 ** 30:.2f} GiB")
    say("5 faults", f"{g.name} F={wl.src.shape[0]} x B={B_MAIN} under "
        f"{prof.describe()}: horizons {horizons}, drops {res['drops']}, "
        f"timeouts {res['timeouts']}, evictions {res['ev_evictions']}, "
        f"abandoned {res['flows_abandoned']} at {res['abandon_tick']}; "
        f"every lane bitwise equal to the JAX simulate_batch golden; "
        f"launches {launches}")
    return res


def inc_workloads(device="cpu"):
    """The collectives phase's lanes, as ``scripts/torch_port_reference.py
    --which inc`` builds them: (INC lane, the same flows with ``red =
    -1``, per-host rx the schedules expect with INC off, the roots)."""
    from repro_torch.network import collectives as coll
    from repro_torch.network.fabric import Workload
    lanes: dict = {k: [] for k in ("src", "dst", "size", "dep", "red")}
    rx = np.zeros((1024,), np.int64)
    for j in range(32):
        hosts = np.asarray([j + 32 * i for i in range(32)], np.int32)
        spec = coll.CollectiveSpec("all_reduce", tuple(hosts), 32)
        t = coll.flow_table(spec, "tree")
        off = 62 * j
        for k, v in (("src", hosts[t.src]), ("dst", hosts[t.dst]),
                     ("size", t.size),
                     ("dep", np.where(t.dep >= 0, t.dep + off, -1)),
                     ("red", np.where(t.red >= 0, j, -1))):
            lanes[k].append(v)
        rx[hosts] += coll.expected_host_rx(spec, "tree")
    a = {k: np.concatenate(v).astype(np.int32) for k, v in lanes.items()}
    on = Workload.of(a["src"], a["dst"], a["size"], dep=a["dep"],
                     red=a["red"], device=device)
    off = Workload.of(a["src"], a["dst"], a["size"], dep=a["dep"],
                      device=device)
    return on, off, rx, np.arange(32)


def link_schedule(g):
    """The link phase's [2, Q] schedule: 1 % BER on edge 1's uplinks in
    lane 0, lane 1 healthy."""
    from repro_torch.network.faults import FaultSchedule
    ok = FaultSchedule.healthy(g.num_queues)
    return FaultSchedule.stack(
        [ok.corrupt([int(q) for q in g.up1_table[1, :]], 0.01), ok])


def _state_vs_golden(s, gold, prefix: str) -> int:
    """Every state lane but the packet and event buffers bitwise against
    ``gold[prefix + 'state.' + path]``; the lane sets must agree."""
    from repro_torch.convert import state_to_numpy
    state = _flat(state_to_numpy(s))
    lanes = sorted(k for k in state if k not in ("q_pkt", "ev_buf"))
    want = sorted(k[len(prefix) + 6:] for k in gold.files
                  if k.startswith(prefix + "state."))
    assert lanes == want, (prefix, set(lanes) ^ set(want))
    for k in lanes:
        _assert_bits(state[k], gold[f"{prefix}state.{k}"], f"{prefix}{k}")
    return len(lanes)


def _batch_vs_golden(r, gold, prefix: str, extra=()) -> dict:
    """A batch lane's stats lanes, scalars and state against the
    golden's ``prefix`` entries; returns the scalars."""
    s = r.state
    for k in ("stat_completion", "stat_src_completion"):
        _assert_bits(getattr(r, k), gold[prefix + k], prefix + k)
    for k in ("delivered", "next_psn"):
        _assert_bits(getattr(s, k).cpu().numpy(), gold[prefix + k],
                     prefix + k)
    scalars = {"horizon": r.horizon, "trims": r.trims, "drops": r.drops,
               "dups": r.dups, "retransmits": r.rtx_packets,
               "timeouts": r.timeouts, "qlen_peak": r.qlen_peak,
               "ticks_degraded": r.ticks_degraded,
               **{k: int(getattr(r, k) if hasattr(r, k)
                         else getattr(s, k)) for k in extra}}
    for k, v in scalars.items():
        assert v == int(gold[prefix + k]), (prefix, k, v, int(gold[prefix + k]))
    scalars["state_lanes"] = _state_vs_golden(s, gold, prefix)
    return scalars


def _timed_batch(run) -> "tuple[list, float, int, dict]":
    """``run()`` on the card from zeroed launch counts and peak memory:
    (results, seconds, peak bytes, launches)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    rs = run()
    torch.cuda.synchronize()
    return (rs, time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
            dict(ops.LAUNCHES))


def _rate(tag: str, rs, secs: float, peak: int, batch: dict) -> dict:
    horizons = [r.horizon for r in rs]
    sticks = sum(horizons)
    res = {"b": len(rs), "seconds": secs, "horizons": horizons,
           "scenario_ticks": sticks, "scenario_ticks_per_s": sticks / secs,
           "lane_ticks_per_s": len(rs) * max(horizons) / secs,
           "peak_bytes": peak,
           "healthy_scenario_ticks_per_s": batch["scenario_ticks_per_s"],
           "healthy_peak_bytes": batch["peak_bytes"]}
    say(tag, f"B={len(rs)} scenario-ticks/s {res['scenario_ticks_per_s']:.1f}"
        f" ({sticks} scenario-ticks in {secs:.2f} s; all lanes stepped "
        f"{max(horizons)} ticks, {res['lane_ticks_per_s']:.1f} lane-ticks/s)"
        f" against the healthy B={batch['b']} batch's "
        f"{batch['scenario_ticks_per_s']:.1f} scenario-ticks/s")
    say(tag, f"peak {peak / 2 ** 30:.2f} GiB against the healthy batch's "
        f"{batch['peak_bytes'] / 2 ** 30:.2f} GiB")
    return res


def phase_collectives(batch: dict) -> dict:
    """INC at full width: the 32 concurrent tree all-reduces as B = 2
    lanes (INC on / off) of one ``simulate_batch`` call, then the default
    ``collective_sweep()``, against ``tests/golden/torch_port_inc.npz``."""
    from dataclasses import replace
    from repro_torch.network import collectives as coll
    from repro_torch.network.fabric import SimParams, simulate_batch
    from repro_torch.network.profile import TransportProfile
    from repro_torch.network.topology import fat_tree3
    from repro_torch.network.workloads import collective_sweep
    gold = np.load(INC)
    g = fat_tree3(k=16, pods=16)
    on, off, rx, roots = inc_workloads()
    for k in ("src", "dst", "size", "dep", "red"):
        _assert_bits(getattr(on, k).numpy(), gold[k], f"workload {k}")
    _assert_bits(rx, gold["expected_rx"], "expected_rx")
    prof = replace(TransportProfile.ai_full(), inc=True, name="ai_full+inc")
    rs, secs, peak, launches = _timed_batch(lambda: simulate_batch(
        g, [on, off], prof, SimParams(), trace="stats",
        max_ticks=int(gold["max_ticks"]), device="cuda"))
    _assert_launches("inc", launches, max(r.horizon for r in rs))
    scalars = [_batch_vs_golden(r, gold, f"b{b}/",
                                ("inc_reduced", "inc_emits"))
               for b, r in enumerate(rs)]
    assert all((r.stat_src_completion >= 0).all() for r in rs)
    got = [np.bincount(on.dst.numpy(), r.state.delivered.cpu().numpy(),
                       1024).astype(np.int64) for r in rs]
    np.testing.assert_array_equal(got[1], rx)    # INC off: every packet
    absorbed = int(rs[0].state.inc_reduced)
    assert absorbed > 0 and int(rs[1].state.inc_reduced) == 0
    others = np.setdiff1d(np.arange(1024), roots)
    np.testing.assert_array_equal(got[0][others], rx[others])
    assert int((rx - got[0])[roots].sum()) == absorbed, "payload lost"
    ct = [coll.collective_completion_ticks(r) for r in rs]
    assert 0 < ct[0] < ct[1], ct
    res = {**_rate("5 collectives", rs, secs, peak, batch),
           "launches": launches, "lanes": scalars, "completion": ct}
    say("5 collectives", f"{g.name} 32 tree all-reduces F={on.src.shape[0]}"
        f" x B=2 (INC on / off): horizons {res['horizons']}, collective "
        f"done at {ct}, absorbed {absorbed}, emitted "
        f"{int(rs[0].state.inc_emits)}; both lanes bitwise equal to the JAX "
        f"golden ({scalars[0]['state_lanes']} state lanes); delivered + "
        f"absorbed = the schedule's rx; launches {launches}")
    # the collective ablation grid: two profile groups, one after the
    # other, each running to its slowest scenario
    g2, wls, profs, names = collective_sweep()
    rs, secs, _, launches = _timed_batch(lambda: simulate_batch(
        g2, wls, profs, SimParams(ticks=1600), device="cuda"))
    for i, (nm, r) in enumerate(zip(names, rs)):
        assert nm == str(gold[f"s{i}/name"]), (i, nm)
        assert r.horizon == int(gold[f"s{i}/horizon"]), (nm, r.horizon)
        _assert_bits(r.stat_src_completion, gold[f"s{i}/stat_src_completion"],
                     f"{nm} stat_src_completion")
        _assert_bits(r.state.delivered.cpu().numpy(),
                     gold[f"s{i}/delivered"], f"{nm} delivered")
        for k in ("inc_reduced", "inc_emits"):
            assert int(getattr(r.state, k)) == int(gold[f"s{i}/{k}"]), (nm, k)
    group_ticks = sum(max(r.horizon for r, q in zip(rs, profs)
                          if q == p) for p in dict.fromkeys(profs))
    _assert_launches("inc", launches, group_ticks)
    cts = {nm: coll.collective_completion_ticks(r)
           for nm, r in zip(names, rs)}
    assert all(c > 0 for c in cts.values()), cts
    assert cts["ai_full/all_reduce/tree/inc"] < cts["ai_full/all_reduce/tree"]
    res["sweep"] = {"seconds": secs, "scenarios": len(rs),
                    "group_ticks": group_ticks, "launches": launches,
                    "completion": cts}
    say("5 collectives", f"collective_sweep(): {len(rs)} scenarios in two "
        f"profile groups ({group_ticks} ticks, {secs:.2f} s), bitwise equal "
        f"to the JAX golden; tree all-reduce done at "
        f"{cts['ai_full/all_reduce/tree/inc']} with INC against "
        f"{cts['ai_full/all_reduce/tree']} without")
    return res


def phase_link(batch: dict) -> dict:
    """The link layer at full width: B = 2 lanes (BER on edge 1's uplinks
    / healthy) under LLR and under LLR + CBFC, against
    ``tests/golden/torch_port_link.npz``."""
    from repro_torch.core.link import LinkConfig
    from repro_torch.network.fabric import SimParams, simulate_batch
    gold = np.load(LINK)
    _, g, wl, prof, _ = _fullsize()
    sched = link_schedule(g)
    budget = int(gold["max_ticks"])
    out = {}
    for tag, spec in (("llr", LinkConfig.on(llr=True)),
                      ("cbfc", LinkConfig.on(llr=True, cbfc=True))):
        rs, secs, peak, launches = _timed_batch(lambda: simulate_batch(
            g, [wl, wl], prof, SimParams(ticks=budget), faults=sched,
            seeds=gold["seeds"], trace="stats", link=spec, device="cuda"))
        _assert_launches(tag, launches, max(r.horizon for r in rs))
        scalars = [_batch_vs_golden(r, gold, f"{tag}/b{b}/",
                                    ("llr_replays", "credit_stall_ticks"))
                   for b, r in enumerate(rs)]
        assert all((r.stat_completion >= 0).all() for r in rs)
        assert all(r.drops == 0 for r in rs), "LLR lets no corruption out"
        assert rs[0].llr_replays > 0 and rs[1].llr_replays == 0
        if tag == "cbfc":
            assert all(r.trims == 0 for r in rs), "CBFC never trims"
        res = out[tag] = {**_rate(f"5 link {tag}", rs, secs, peak, batch),
                          "launches": launches, "lanes": scalars}
        say(f"5 link {tag}", f"{g.name} F={wl.src.shape[0]} x B=2 ({spec}):"
            f" horizons {res['horizons']}, llr_replays "
            f"{[r.llr_replays for r in rs]}, credit_stall_ticks "
            f"{[r.credit_stall_ticks for r in rs]}, trims "
            f"{[r.trims for r in rs]}, drops {[r.drops for r in rs]}; both "
            f"lanes bitwise equal to the JAX golden "
            f"({scalars[0]['state_lanes']} state lanes); launches {launches}")
    return out


def _assert_launches(tag: str, launches: dict, ticks: int) -> None:
    """Each tick kernel launched ``PER_TICK[tag]`` times a tick, and no
    entry-point form on the tick."""
    for k, n in zip(TICK_KERNELS, PER_TICK[tag]):
        assert launches[k] == n * ticks, \
            f"{tag}: {k} launched {launches[k]} times in {ticks} ticks"
    assert all(launches[k] == 0 for k in ENTRY_KERNELS), (tag, launches)


def _profiles(num_flows: int) -> dict:
    """The three full-width profile runs, by tag (as in
    ``scripts/torch_port_reference.py``)."""
    from repro_torch.core.lb.schemes import LBScheme
    from repro_torch.network.profile import (CCAlgo, DeliveryMode,
                                             TransportProfile)
    mixed = tuple(DeliveryMode.ROD if f % 2 else DeliveryMode.RUD
                  for f in range(num_flows))
    return {
        "hpc": TransportProfile.hpc(),
        "base": TransportProfile.ai_base(lb=LBScheme.EVBITMAP),
        "mixed": TransportProfile(cc=CCAlgo.NONE, lb=LBScheme.RR_SLOTS,
                                  delivery=mixed, name="mixed"),
    }


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def phase_profiles() -> "tuple[dict, dict]":
    """Phase 5, the profile table at full width against the references.
    Returns the results and each run's final state, by tag."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import simulate
    _, g, wl, _, p = _fullsize()
    ref = np.load(PROFILES)
    out, states = {}, {}
    for tag, prof in _profiles(int(wl.src.shape[0])).items():
        assert str(ref[f"{tag}/describe"]) == prof.describe(), tag
        modes = prof.delivery_modes(int(wl.src.shape[0]))
        assert np.array_equal(modes, ref[f"{tag}/delivery"]), tag
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        r = simulate(g, wl, prof, p, trace="stats", max_ticks=PROFILE_TICKS,
                     device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        _assert_launches(tag, launches, r.horizon)
        _assert_bits(r.stat_completion, ref[f"{tag}/stat_completion"],
                     f"{tag} stat_completion")
        _assert_bits(r.stat_src_completion,
                     ref[f"{tag}/stat_src_completion"],
                     f"{tag} stat_src_completion")
        state = _flat(state_to_numpy(r.state))
        lanes = [k for k in state
                 if k not in ("q_pkt", "ev_buf") + UNRECORDED_LANES]
        assert sorted(lanes) == sorted(
            k[len(f"{tag}/state."):] for k in ref.files
            if k.startswith(f"{tag}/state.")), tag
        # the reference leaves these lanes out of its profile goldens:
        # inert here (zero, or zero-size where INC / the link is off)
        for k in UNRECORDED_LANES:
            assert not state[k].any(), (tag, k)
        for k in lanes:
            _assert_bits(state[k], ref[f"{tag}/state.{k}"], f"{tag} {k}")
        s = r.state
        scalars = {"horizon": r.horizon, "qlen_peak": r.qlen_peak,
                   "trims": r.trims, "drops": r.drops, "dups": r.dups,
                   "rod_rejects": int(s.rod_rejects),
                   "retransmits": r.rtx_packets, "timeouts": r.timeouts}
        for k, v in scalars.items():
            assert v == int(ref[f"{tag}/{k}"]), (tag, k, v)
        out[tag] = {"seconds": secs, "ticks_per_s": r.horizon / secs,
                    "peak_bytes": peak, "launches": launches,
                    "state_lanes": len(lanes), **scalars}
        say("5 full width", f"{prof.describe()[:72]}: {r.horizon} ticks, "
            f"{r.horizon / secs:.1f} ticks/s ({secs:.2f} s), peak "
            f"{peak / 2 ** 30:.2f} GiB, launches {launches}; bitwise equal to "
            f"the JAX reference on the stats and {len(lanes)} state lanes "
            f"{scalars}")
        states[tag] = s
    return out, states


def phase_entry_points(states: dict) -> dict:
    """The kernels that are not on the tick, through their public entry
    points, as a user calls them: one coalesced NSCC ACK round over the
    hpc run's 2048 windows; the ECMP port choice of one tick's
    Q + F = 7168 packet lanes of the ai_full fabric (each queue's head
    packet at its next switch, each flow's next injection at its source
    leaf); the dense SACK forms of ``repro.kernels.ops`` on the mixed
    run's final rings, one received PSN on half the flows; and the
    copying ``nack_mark`` of one NACK lane per flow on its final
    retransmit ring."""
    from repro_torch.kernels import ops, ref
    from repro_torch.network.ecmp import RoutingTables
    from repro_torch.network.fabric import _bit_plane
    hpc_cwnd = states["hpc"].cc["nscc"].cwnd
    st = states["mixed"]
    _, g, wl, _, p = _fullsize()
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    F, Q = int(wl.src.shape[0]), g.num_queues
    ecn = torch.as_tensor(rng.integers(0, 2, F).astype(np.int32)).to(dev)
    rtt = torch.as_tensor(rng.uniform(4.0, 40.0, F).astype(np.float32)
                          ).to(dev)
    count = torch.as_tensor(rng.integers(0, 4, F).astype(np.int32)).to(dev)
    ev = torch.as_tensor(rng.integers(0, 1 << 16, Q + F).astype(np.int32)
                         ).to(dev)
    qflow = torch.as_tensor(rng.integers(0, F, Q).astype(np.int32)).to(dev)
    rt = RoutingTables(g, dev)
    wl = wl.to(dev)
    src = torch.cat([wl.src[qflow.long()], wl.src])
    dst = torch.cat([wl.dst[qflow.long()], wl.dst])
    salt = torch.cat([rt.next_switch, rt.host_leaf[wl.src.long()]])
    params = _nscc_params()[0]
    w = int(st.rtx.shape[1])
    mask = _bit_plane(
        torch.as_tensor(rng.integers(0, 32 * w, F).astype(np.int32)).to(dev),
        torch.as_tensor(rng.integers(0, 2, F).astype(bool)).to(dev), w)
    sack_in = (st.src_track.ring, st.src_track.base, st.rtx, mask)
    adv_in = (st.dst_track.ring | mask, st.dst_track.base)
    nack_in = (st.rtx, torch.arange(F, dtype=torch.int32, device=dev),
               torch.as_tensor(rng.integers(-4, 32 * w + 4, F).astype(
                   np.int32)).to(dev),
               torch.as_tensor(rng.integers(0, 2, F).astype(bool)).to(dev))
    ops.reset_launches()
    cwnd2 = ops.nscc_update(hpc_cwnd, ecn, rtt, count, params)
    port = ops.ecmp_select(src, dst, ev, salt, g.fanout1)
    fused = ops.sack_fused(*sack_in)
    advanced = ops.sack_advance(*adv_in)
    marked = ops.nack_mark(*nack_in)
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in ENTRY_KERNELS}
    for k, n in launches.items():
        assert n >= 1, f"{k} was not launched on its entry-point path"
    cpu = [t.cpu() for t in (hpc_cwnd, ecn, rtt, count)]
    _assert_bits(cwnd2.cpu().numpy(),
                 ref.nscc_update_ref(*cpu, params).numpy(), "nscc round")
    _assert_bits(port.cpu().numpy(),
                 ref.ecmp_hash_ref(src.cpu(), dst.cpu(), ev.cpu(), salt.cpu(),
                                   g.fanout1).numpy(), "ecmp ports")
    for what, got, want in (
            ("sack_fused", fused, ref.sack_fused_ref(
                *(t.cpu() for t in sack_in))),
            ("sack_advance", advanced, ref.sack_advance_ref(
                *(t.cpu() for t in adv_in))),
            ("nack_mark", (marked,), (ref.nack_mark_ref(
                *(t.cpu() for t in nack_in)),))):
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_bits(a.cpu().numpy(), b.numpy(), f"{what} output {i}")
    # the injection lanes' ports are the tick's own first-hop choice
    remote = rt.host_leaf[wl.src.long()] != rt.host_leaf[wl.dst.long()]
    sleaf = rt.host_leaf[wl.src.long()].long()
    up = rt.up1[sleaf, port[Q:].long()]
    inj = rt.injection_queue(wl.src, wl.dst, ev[Q:])
    assert torch.equal(up[remote], inj[remote]), "first-hop port"
    say("5 entry points", f"ops.nscc_update over {F} windows, "
        f"ops.ecmp_select over {Q + F} packet lanes (fanout {g.fanout1}) "
        f"and ops.sack_fused / sack_advance / nack_mark over {F} rings of "
        f"{w} words: "
        f"bitwise equal to the plain versions on the CPU, injection ports "
        f"equal to the tick's routing; launches {launches}")
    return {"launches": launches}


def phase_cross_device() -> dict:
    from repro_torch.convert import state_to_numpy
    from repro_torch.network.fabric import simulate
    _, g, wl, prof, p = _fullsize()
    secs, runs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = simulate(g, wl, prof, p, trace="full",
                             max_ticks=p.chunk_ticks, device=dev)
        secs[dev] = time.perf_counter() - t0
    a, b = runs["cuda"], runs["cpu"]
    assert a.horizon == b.horizon == p.chunk_ticks
    for lane in ("delivered_per_tick", "cwnd_per_tick", "qlen_max",
                 "rx_base_per_tick", "src_base_per_tick"):
        _assert_bits(getattr(a, lane), getattr(b, lane), lane)
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)

    def walk(x, y, path):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
        else:
            _assert_bits(x, y, path)
    walk(sa, sb, "state")
    say("6 cross-device", f"first {p.chunk_ticks}-tick chunk at full width "
        f"bitwise equal on cuda and cpu (every out lane and state field; "
        f"cuda {secs['cuda']:.2f} s, cpu {secs['cpu']:.2f} s)")
    return {"seconds": secs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every phase's numbers to this JSON file")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi, device = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    result = {"nvidia_smi": smi, "device": device,
              "build": phase_build(), "kernels": phase_kernels(),
              "sites": phase_sites(), "goldens": phase_goldens(),
              "full_width": phase_fullwidth()}
    result["batch"] = phase_batch(result["full_width"])
    result["faults"] = phase_faults(result["batch"])
    result["collectives"] = phase_collectives(result["batch"])
    result["link"] = phase_link(result["batch"])
    result["profiles"], states = phase_profiles()
    result["entry_points"] = phase_entry_points(states)
    result["cross_device"] = phase_cross_device()
    kernels = []
    for name, row in result["kernels"].items():
        row = {k: v for k, v in row.items()
               if k not in ("bytes", "pool")}
        row["launches"] = (result["full_width"]["launches"][name]
                           if name in TICK_KERNELS
                           else result["entry_points"]["launches"][name])
        if "batch" in row:   # the same kernel on the batch phase's path
            row["batch"] = {**{k: v for k, v in row["batch"].items()
                               if k != "bytes"},
                            "launches": result["batch"]["launches"][name]}
            # and on the faulted batch's, the collectives' and the link
            # layer's
            row["faults"] = {"launches": result["faults"]["launches"][name]}
            row["collectives"] = {
                "launches": result["collectives"]["launches"][name]}
            row["link"] = {k: {"launches": v["launches"][name]}
                           for k, v in result["link"].items()}
        kernels.append(row)
    result["seconds"] = time.perf_counter() - t0
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
