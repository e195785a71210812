#!/usr/bin/env python
"""Write the JAX reference that the PyTorch port is held against at full
width: ``tests/golden/torch_port_fullsize.npz``.

The configuration is the port's full-width run (``chip_smoke.py`` phase
5): a full 3-tier k=16 fat tree (``fat_tree3(k=16, pods=16)``: 1024
endpoints, 320 switches, 5120 egress queues) carrying two cross-pod
permutations at once — host i sends 256 packets to host (i+512) mod
1024 and 256 packets to host (i+256) mod 1024, so F = 2048 flows and
every destination downlink takes a 2:1 incast — under
``TransportProfile.ai_full()``, ``SimParams()``, ``max_ticks=4096``,
``trace="stats"``.

This script imports the JAX package and is not part of the port. It
runs on the CPU (about five minutes on a few cores):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_port_reference.py

The file holds the workload lanes (``src``, ``dst``, ``size``), the
per-flow stats and final lanes (``stat_completion``,
``stat_src_completion``, ``delivered``, ``next_psn``, ``src_base``,
``dst_base``, ``cwnd``), the scalars (``horizon``, ``trims``, ``drops``,
``dups``, ``retransmits``, ``timeouts``, ``qlen_peak``) and the
wall-clock seconds the reference run took (``cpu_seconds``).
"""
import argparse
import time
from pathlib import Path

import numpy as np

from repro.network.fabric import SimParams, Workload, simulate
from repro.network.profile import TransportProfile
from repro.network.topology import fat_tree3

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "golden" / "torch_port_fullsize.npz"
HOSTS = 1024
SIZE = 256
MAX_TICKS = 4096


def workload_lanes() -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """(src, dst, size) of the two overlapping cross-pod permutations."""
    h = np.arange(HOSTS, dtype=np.int32)
    src = np.concatenate([h, h])
    dst = np.concatenate([(h + 512) % HOSTS, (h + 256) % HOSTS]).astype(
        np.int32)
    return src, dst, np.full(src.shape, SIZE, np.int32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    g = fat_tree3(k=16, pods=16)
    src, dst, size = workload_lanes()
    wl = Workload.of(src, dst, size)
    t0 = time.perf_counter()
    r = simulate(g, wl, TransportProfile.ai_full(), SimParams(),
                 trace="stats", max_ticks=MAX_TICKS)
    secs = time.perf_counter() - t0
    s = r.state
    out = {
        "src": src, "dst": dst, "size": size,
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
        "cpu_seconds": np.float64(secs),
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    ct = out["stat_completion"]
    print(f"{g.name}: Q={g.num_queues} F={src.size} horizon={r.horizon} "
          f"completion {ct.min()}..{ct.max()} trims={r.trims} "
          f"rtx={r.rtx_packets} timeouts={r.timeouts} "
          f"qlen_peak={r.qlen_peak} in {secs:.1f} s -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
