#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--out results.json]

Phases, one line each:

1. device — the card's name and power limit (``nvidia-smi``); no CUDA,
   no run: the script exits non-zero before printing any result.
2. build  — compile every CUDA kernel of the port from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, in parallel).
3. kernels — each of the five kernels against its plain PyTorch version
   on the card, random inputs plus edge lanes, bitwise: the tick's three
   at the main path's shapes (F = 2048 flows, W = 16 ring words,
   L = Q + 2F = 9216 NACK lanes), ``nscc_update`` (N = F = 2048) and
   ``ecmp_select`` (N = Q + F = 7168) at the entry-point path's shapes
   and at a pool of N = 2**24 lanes. Kernel and plain times (CUDA events,
   warm, median of 20) beside the bound; each kernel's device time alone
   (``torch.profiler``, CUDA kernel time / launches).
4. goldens — the two reference goldens (``tests/golden/fabric_golden.npz``)
   reproduced bitwise on the card.
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
   launched once per tick (``nack_mark`` not at all under all-ROD, whose
   tick has no selective-retransmit path). Then the kernel entry points
   (``repro_torch.kernels.ops.nscc_update`` / ``ecmp_select``): one
   batched NSCC round over the hpc run's 2048 windows and the ECMP port
   choice of 7168 packet lanes of the ai_full run, checked against the
   plain versions and the tick's own routing.
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
                   "src/repro/kernels/sack_fused.py:91", "sack_kernel<true>"),
    "nack_mark": ("src/repro_torch/kernels/csrc/nack_mark.cu",
                  "src/repro/kernels/nack_mark.py:70", "nack_mark_kernel"),
    "sack_advance": ("src/repro_torch/kernels/csrc/sack.cu",
                     "src/repro/kernels/sack_bitmap.py:82",
                     "sack_kernel<false>"),
    "nscc_update": ("src/repro_torch/kernels/csrc/nscc_update.cu",
                    "src/repro/kernels/nscc_update.py:53",
                    "nscc_update_kernel"),
    "ecmp_select": ("src/repro_torch/kernels/csrc/ecmp_hash.cu",
                    "src/repro/kernels/ecmp_hash.py:52",
                    "ecmp_select_kernel"),
}
TICK_KERNELS = ("sack_fused", "nack_mark", "sack_advance")
ENTRY_KERNELS = ("nscc_update", "ecmp_select")


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
    kernel time in a ``torch.profiler`` trace over its launch count."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for ev in prof.key_averages():
        if symbol in ev.key:
            us += float(ev.device_time_total)
            n += int(ev.count)
    if not (n and us > 0):
        raise RuntimeError(f"the profiler trace holds no device time for "
                           f"{symbol}")
    return us / n / 1e3


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
    from repro_torch.network.fabric import simulate
    gold, cfgs = _golden_configs()
    out = {}
    for tag, (g, wl, prof, p, kw) in cfgs.items():
        r = simulate(g, wl, prof, p, trace="full", device="cuda", **kw)
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
            f"(horizon {h})")
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
    for k in TICK_KERNELS:
        assert launches[k] == r.horizon, \
            f"{k} launched {launches[k]} times in {r.horizon} ticks"
    assert all(launches[k] == 0 for k in ENTRY_KERNELS), launches
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


def phase_profiles() -> "tuple[dict, torch.Tensor]":
    """Phase 5, the profile table at full width against the references.
    Returns the results and the hpc run's final NSCC windows."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.kernels import ops
    from repro_torch.network.fabric import simulate
    _, g, wl, _, p = _fullsize()
    ref = np.load(PROFILES)
    out = {}
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
        all_rod = bool((modes == 1).all())
        for k in TICK_KERNELS:
            want = 0 if (k == "nack_mark" and all_rod) else r.horizon
            assert launches[k] == want, (tag, k, launches[k], r.horizon)
        assert all(launches[k] == 0 for k in ENTRY_KERNELS), launches
        _assert_bits(r.stat_completion, ref[f"{tag}/stat_completion"],
                     f"{tag} stat_completion")
        _assert_bits(r.stat_src_completion,
                     ref[f"{tag}/stat_src_completion"],
                     f"{tag} stat_src_completion")
        state = _flat(state_to_numpy(r.state))
        lanes = [k for k in state if k not in ("q_pkt", "ev_buf")]
        assert sorted(lanes) == sorted(
            k[len(f"{tag}/state."):] for k in ref.files
            if k.startswith(f"{tag}/state.")), tag
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
        if tag == "hpc":
            hpc_cwnd = s.cc["nscc"].cwnd
    return out, hpc_cwnd


def phase_entry_points(hpc_cwnd: torch.Tensor) -> dict:
    """The batched kernels through their public entry points, as a user
    calls them: one coalesced NSCC ACK round over the hpc run's 2048
    windows, and the ECMP port choice of one tick's Q + F = 7168 packet
    lanes of the ai_full fabric (each queue's head packet at its next
    switch, each flow's next injection at its source leaf)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.network.ecmp import RoutingTables
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
    ops.reset_launches()
    cwnd2 = ops.nscc_update(hpc_cwnd, ecn, rtt, count, params)
    port = ops.ecmp_select(src, dst, ev, salt, g.fanout1)
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
    # the injection lanes' ports are the tick's own first-hop choice
    remote = rt.host_leaf[wl.src.long()] != rt.host_leaf[wl.dst.long()]
    sleaf = rt.host_leaf[wl.src.long()].long()
    up = rt.up1[sleaf, port[Q:].long()]
    inj = rt.injection_queue(wl.src, wl.dst, ev[Q:])
    assert torch.equal(up[remote], inj[remote]), "first-hop port"
    say("5 entry points", f"ops.nscc_update over {F} windows and "
        f"ops.ecmp_select over {Q + F} packet lanes (fanout {g.fanout1}): "
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
              "goldens": phase_goldens(), "full_width": phase_fullwidth()}
    result["profiles"], hpc_cwnd = phase_profiles()
    result["entry_points"] = phase_entry_points(hpc_cwnd)
    result["cross_device"] = phase_cross_device()
    kernels = []
    for name, row in result["kernels"].items():
        row = {k: v for k, v in row.items()
               if k not in ("bytes", "pool")}
        row["launches"] = (result["full_width"]["launches"][name]
                           if name in TICK_KERNELS
                           else result["entry_points"]["launches"][name])
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
