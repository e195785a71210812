#!/usr/bin/env python3
"""Where the PyTorch port's serving path spends its time on a CUDA card.

Runs ``chip_smoke.py`` phase 9 (c)'s model — mixtral-8x22b at full width
(d_model 6144, 48 / 8 heads of 128, d_ff 16384, 8 experts top-2, SWA
4096, vocab 32768), depth cut to R = 2, bf16, params drawn on the card
from a seeded generator — and measures two things:

1. the decode step (``make_decode_step``) at ``--batch`` requests against
   a ring cache of ``--cache`` slots, at positions from ``--start`` on:
   ``--warm`` steps, then ``--window`` steps unprofiled (host wall ms per
   step, synchronized at the window's ends), then ``--window`` steps
   under ``torch.profiler``. The decode step computes every slot of the
   ring whether it is filled or not, so its cost does not depend on how
   far the cache is filled;
2. ``make_prefill`` at ``--batch`` x ``--prompt`` tokens: one warm call,
   ``--calls`` unprofiled calls each timed alone (the median is kept),
   then ``--calls`` profiled.

For each: the host syncs in one call (``torch.cuda.set_sync_debug_mode``),
the unprofiled wall ms per call, the profiled run's wall and device busy
ms per call (the sum of the device time of every kernel, memset and
copy; one stream, so they do not overlap), the device's idle share in
that same profiled run (1 - busy / its wall), the device operations per
call, the ten largest device-time consumers and the peak device
memory. For the decode step also the least time the card could take:
every weight but the embedding's unread rows read once, over 3.35 TB/s.

    PYTHONPATH=src python3 scripts/torch_port_profile_serving.py \\
        [--batch 8] [--prompt 1024] [--cache 1152] [--calls 5] \\
        [--out FILE]

Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.serve_step import make_decode_step, make_prefill  # noqa: E402

sys.path.insert(0, str(ROOT))
from chip_smoke import (HBM_BYTES_PER_S, LM_SEED, _full_cfg,  # noqa: E402
                        _param_bytes)


def profiled(fn, calls: int) -> dict:
    """``fn()`` ``calls`` times under ``torch.profiler``: wall, device
    busy and operations per call, the top device-time consumers."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"profiled_wall_ms": wall / calls * 1e3,
            "device_busy_ms": sum(by_name.values()) / calls / 1e3,
            "device_ops": len(dev) / calls,
            "top_device_us": [[k[:160], v / calls] for k, v in top]}


def host_syncs(fn) -> int:
    """Operations of one ``fn()`` that make the host wait for the device
    (``torch.cuda.set_sync_debug_mode("warn")``: a copy to or from the
    host, a read of a device value)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def timed(fn, calls: int) -> float:
    """Host wall ms per call of ``fn()``, synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def report(tag: str, wall_ms: float, prof: dict, peak: int,
           syncs: int) -> dict:
    """``prof``'s idle share is taken within the profiled run; the
    unprofiled ``wall_ms`` is printed beside it."""
    res = {"wall_ms": wall_ms, **prof, "peak_bytes": peak,
           "host_syncs": syncs,
           "device_idle_share": 1.0 - prof["device_busy_ms"]
           / prof["profiled_wall_ms"]}
    print(f"{tag}: {syncs} host syncs, wall {wall_ms:.3f} ms (profiled "
          f"{prof['profiled_wall_ms']:.3f}), device busy "
          f"{prof['device_busy_ms']:.3f} ms, idle share "
          f"{res['device_idle_share']:.3f}, {prof['device_ops']:.0f} device "
          f"ops, peak {peak / 2 ** 30:.2f} GiB")
    for name, us in prof["top_device_us"]:
        print(f"  {us:10.2f} us  {name}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--cache", type=int, default=1152)
    ap.add_argument("--start", type=int, default=1024)
    ap.add_argument("--warm", type=int, default=8)
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--calls", type=int, default=5,
                    help="prefill calls timed, and profiled")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_port_profile_serving: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    cfg = _full_cfg()
    params = lm.init_params(cfg, LM_SEED, torch.bfloat16, device=dev)
    nbytes = _param_bytes(params)
    bound_ms = ((nbytes - params["embed"].numel() * 2) / HBM_BYTES_PER_S
                * 1e3)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    B = args.batch
    res = {"nvidia_smi": smi, "arch": cfg.name, "repeats": cfg.repeats,
           "dtype": "bfloat16", "param_bytes": nbytes, "batch": B}

    # 1. the decode step
    step = make_decode_step(cfg)
    state = {"cache": lm.init_cache(cfg, B, args.cache, torch.bfloat16,
                                    device=dev),
             "pos": args.start}
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=dev,
                        dtype=torch.int32)

    def one_step():
        _, state["cache"] = step(params, state["cache"], tok, state["pos"])
        state["pos"] += 1

    for _ in range(args.warm):
        one_step()
    torch.cuda.reset_peak_memory_stats()
    wall = timed(one_step, args.window)
    peak = torch.cuda.max_memory_allocated()
    res["decode"] = {"cache_slots": args.cache, "bound_ms": bound_ms,
                     **report(f"decode step B={B} C={args.cache}", wall,
                              profiled(one_step, args.window), peak,
                              host_syncs(one_step))}
    print(f"  the weights' bytes over {HBM_BYTES_PER_S / 1e12} TB/s bound "
          f"a step at {bound_ms:.3f} ms")
    del state

    # 2. the prefill
    prefill = make_prefill(cfg)
    prompts = torch.randint(0, cfg.vocab, (B, args.prompt), generator=gen,
                            device=dev, dtype=torch.int32)
    prefill(params, prompts)
    torch.cuda.reset_peak_memory_stats()
    walls = sorted(timed(lambda: prefill(params, prompts), 1)
                   for _ in range(args.calls))
    peak = torch.cuda.max_memory_allocated()
    res["prefill"] = {"tokens": B * args.prompt, "walls_ms": walls,
                      **report(f"prefill B={B} S={args.prompt} (median of "
                               f"{args.calls})", walls[len(walls) // 2],
                               profiled(lambda: prefill(params, prompts),
                                        args.calls),
                               peak, host_syncs(
                                   lambda: prefill(params, prompts)))}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
