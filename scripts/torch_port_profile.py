#!/usr/bin/env python3
"""Where the PyTorch port's tick spends its time on a CUDA card.

Runs the port's full-width configuration — ``fat_tree3(k=16, pods=16)``
with the two overlapping cross-pod permutations of ``chip_smoke.py``
(F = 2048 flows of 256 packets), ``ai_full``, ``SimParams()``, as
``--batch`` scenarios of one tick (seeds 0x5EED + b; 1 by default) —
twice:

1. unprofiled, to quiescence, timing every ``--window``-tick window
   (host wall ms per tick, synchronized at each window edge);
2. from a fresh state: ``--warm`` ticks, then ``--window`` ticks under
   ``torch.profiler``.

With ``--faulted`` the tick is ``chip_smoke.py``'s faulted batch
instead: ``TransportProfile.resilient()``, ``SimParams(timeout_ticks=64,
ooo_threshold=24)``, and scenario b takes lane (b + 3) mod 4 of its four
fault lanes (``chip_smoke.fault_schedule``; 3: everything at once; 0:
gray links; 1: a dead host and a stalled NIC; 2: PHY corruption), so
one scenario already builds every fault static and four run the whole
faulted batch.

With ``--inc`` the tick is ``chip_smoke.py``'s collectives phase:
``ai_full`` with ``inc=True`` over its 32 concurrent tree all-reduces
(F = 1984), scenario b carrying the groups' ``red`` ids when b is even
and ``red = -1`` when it is odd. With ``--link llr`` or ``--link cbfc``
it is its link phase: the two permutations under
``LinkConfig.on(llr=True)`` (and ``cbfc=True``), even scenarios with
1 % BER on edge 1's uplinks (``chip_smoke.link_schedule``).

It reports the per-window wall times and, for the profiled window, the
device busy time per tick (the sum of the device time of every kernel,
memset and copy; one stream, so they do not overlap), the device's idle
share against the unprofiled wall time of the same window, the number of
device operations per tick, the peak device memory of the unprofiled
run, and the ten largest device-time consumers. A tick of B scenarios
is B scenario-ticks.

    PYTHONPATH=src python3 scripts/torch_port_profile.py [--batch B] \
        [--faulted | --inc | --link llr|cbfc] [--out FILE]

Needs a CUDA card; imports nothing of JAX.
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

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from dataclasses import replace

from repro_torch.core.link import LinkConfig
from repro_torch.kernels import ops
from repro_torch.network import fabric
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import TransportProfile
from repro_torch.network.topology import fat_tree3

sys.path.insert(0, str(ROOT))
from chip_smoke import (fault_schedule, inc_workloads,  # noqa: E402
                        link_schedule)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm", type=int, default=64)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--faulted", action="store_true")
    ap.add_argument("--inc", action="store_true")
    ap.add_argument("--link", choices=("llr", "cbfc"), default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_port_profile: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = fat_tree3(k=16, pods=16)
    h = np.arange(1024, dtype=np.int32)
    B = args.batch
    if args.inc:
        on, off, _, _ = inc_workloads(dev)
        wl = fabric.Workload.stack([off if b % 2 else on for b in range(B)])
    else:
        wl = fabric.Workload.stack([fabric.Workload.of(
            np.concatenate([h, h]),
            np.concatenate([(h + 512) % 1024, (h + 256) % 1024]), 256,
            device=dev)] * B)
    F = int(wl.src.shape[1])
    link = (None if args.link is None else
            LinkConfig.on(llr=True, cbfc=args.link == "cbfc"))
    if args.faulted:
        p = fabric.SimParams(timeout_ticks=64, ooo_threshold=24)
        prof_ = TransportProfile.resilient()
        fault = fault_schedule(g).lanes(
            torch.as_tensor([(b + 3) % 4 for b in range(B)])).to(dev)
    elif link is not None:
        p = fabric.SimParams()
        prof_ = TransportProfile.ai_full()
        fault = link_schedule(g).lanes(
            torch.as_tensor([b % 2 for b in range(B)])).to(dev)
    else:
        p = fabric.SimParams()
        prof_ = TransportProfile.ai_full()
        fault = FaultSchedule.healthy(g.num_queues, batch=B, device=dev)
    if args.inc:
        prof_ = replace(prof_, inc=True, name="ai_full+inc")
    step = fabric.make_step(g, prof_, p, F, lossy=fault.has_loss,
                            hosty=fault.has_host_faults,
                            corrupty=fault.has_corruption, link=link,
                            device=dev)
    seeds = fabric.DEFAULT_SEED + np.arange(B)
    n = args.window

    # 1. unprofiled, windowed wall time over the whole run
    s = fabric.init_state(g, wl, prof_, p, seeds, device=dev, link=link)
    windows, tick = [], 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    while True:
        t0 = time.perf_counter()
        for tick in range(tick, tick + n):
            s, _ = step(s, tick, wl, fault)
        tick += 1
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / n * 1e3)
        if bool(fabric._quiescent(s, wl).all()) or tick >= 4096:
            break
    ticks_run = tick
    peak = torch.cuda.max_memory_allocated()

    # 2. one profiled window from a fresh state
    s = fabric.init_state(g, wl, prof_, p, seeds, device=dev, link=link)
    for tick in range(args.warm):
        s, _ = step(s, tick, wl, fault)
    torch.cuda.synchronize()
    ops.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for tick in range(args.warm, args.warm + n):
            s, _ = step(s, tick, wl, fault)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / n / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    plain_ms = windows[args.warm // n] if args.warm % n == 0 else None
    res = {
        "nvidia_smi": smi, "config": g.name, "flows": F, "batch": B,
        "profile": prof_.describe(), "faulted": args.faulted,
        "inc": args.inc, "link": args.link,
        "window_ticks": n, "ticks_run": ticks_run, "peak_bytes": peak,
        "scenario_ticks_per_s_by_window": [B * 1e3 / w for w in windows],
        "wall_ms_per_tick_by_window": windows,
        "wall_ms_per_tick_mean": float(np.mean(windows)),
        "profiled_first_tick": args.warm,
        "profiled_wall_ms_per_tick": wall / n * 1e3,
        "device_busy_ms_per_tick": busy_ms,
        "device_idle_share_unprofiled": (None if plain_ms is None
                                         else 1.0 - busy_ms / plain_ms),
        "device_ops_per_tick": len(dev_events) / n,
        "kernel_launches": dict(ops.LAUNCHES),
        "top_device_us_per_tick": [[k[:160], v / n] for k, v in top],
    }
    print(smi)
    print(f"{g.name} F={F} B={B} {prof_.describe()}"
          f"{' faulted' if args.faulted else ''}"
          f"{'' if link is None else f' link={args.link}'}: "
          f"{ticks_run} ticks, peak "
          f"{peak / 2 ** 30:.2f} GiB, wall ms/tick by {n}-tick "
          f"window {[round(w, 2) for w in windows]}")
    print(f"profiled ticks {args.warm}..{args.warm + n - 1}: device busy "
          f"{busy_ms:.3f} ms/tick, idle share (vs unprofiled wall) "
          f"{res['device_idle_share_unprofiled']}, "
          f"{res['device_ops_per_tick']:.0f} device ops/tick")
    for name, us in res["top_device_us_per_tick"]:
        print(f"  {us:9.2f} us/tick  {name}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
