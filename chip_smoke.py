#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--out results.json]

Phases, one line each:

1. device — the card's name and power limit (``nvidia-smi``); no CUDA,
   no run: the script exits non-zero before printing any result.
2. build  — compile every CUDA kernel of the path from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, in parallel).
3. kernels — each kernel against its plain PyTorch version on the card
   at the main path's shapes (F = 2048 flows, W = 16 ring words,
   L = Q + 2F = 9216 NACK lanes), random inputs plus edge cases, bitwise;
   kernel and plain times (CUDA events, warm, median of 20) beside the
   bytes bound.
4. goldens — the two reference goldens (``tests/golden/fabric_golden.npz``)
   reproduced bitwise on the card.
5. full width — ``fat_tree3(k=16, pods=16)`` (1024 endpoints, Q = 5120)
   with two overlapping cross-pod permutations (F = 2048 flows of 256
   packets), ``ai_full``, ``SimParams()``, ``max_ticks=4096``: every flow
   completes, each kernel launched once per tick, and the per-flow stats
   and final lanes bitwise equal to the JAX reference
   (``tests/golden/torch_port_fullsize.npz``, written by
   ``scripts/torch_port_reference.py``).
6. cross-device — the first 128-tick chunk of that run with
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
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit rate
F_MAIN, W_MAIN, Q_MAIN = 2048, 16, 5120
KERNELS = {
    # name: (source in the repo, the TPU kernel it replaces)
    "sack_fused": ("src/repro_torch/kernels/csrc/sack.cu",
                   "src/repro/kernels/sack_fused.py:91"),
    "nack_mark": ("src/repro_torch/kernels/csrc/nack_mark.cu",
                  "src/repro/kernels/nack_mark.py:70"),
    "sack_advance": ("src/repro_torch/kernels/csrc/sack.cu",
                     "src/repro/kernels/sack_bitmap.py:82"),
}


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


def _assert_bits(x: np.ndarray, y: np.ndarray, what: str) -> None:
    """Same dtype, shape and bytes (floats compared bit for bit)."""
    assert x.dtype == y.dtype and x.shape == y.shape, (what, x.dtype, y.dtype)
    assert x.tobytes() == y.tobytes(), what


def _assert_equal(got, want, what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
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
        ms = _median_ms(lambda: kern(*args))
        plain_ms = _median_ms(lambda: plain(*args))
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = nops / INT_OPS_PER_S * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": None,
            "max_abs_err": _max_abs_err(got, want), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "library_ms": None, "bytes": nbytes,
        }
        say("3 kernels", f"{name}: bitwise equal to plain at "
            f"{[tuple(a.shape) for a in args]}; kernel {ms * 1e3:.2f} us, "
            f"plain {plain_ms * 1e3:.2f} us, bound {max(b_bytes, b_ops) * 1e3:.3f}"
            f" us ({nbytes} B)")
    return rows


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
    for k, n in launches.items():
        assert n == r.horizon, f"{k} launched {n} times in {r.horizon} ticks"
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
              "goldens": phase_goldens(), "full_width": phase_fullwidth(),
              "cross_device": phase_cross_device()}
    kernels = []
    for name, row in result["kernels"].items():
        row = {k: v for k, v in row.items() if k != "bytes"}
        row["launches"] = result["full_width"]["launches"][name]
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
