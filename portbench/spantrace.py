#!/usr/bin/env python3
"""The program's spans (``repro_torch.spans``) read beside the device
trace.

The port records its spans while ``torch.profiler`` runs, so the traced
sweep of a ``--trace 1`` run carries them: :func:`records` takes them
once per run into ``ctx`` for the span readers of ``metrics/``. Each
record is (name, span id, parent id, sweep id, start ns, end ns), on the
clock of the profiler's events. A program without spans gives None.

The rest joins spans to the device: a device operation belongs to the
innermost span open at its launch's host time (the runtime call that
launched it, found by correlation id), an idle gap to the span in which
the host launched the operation that ended it. The harness's trace keeps
neither the launches nor the correlation ids, so these numbers come from
this file run as a script on a card:

    python3 portbench/spantrace.py --workload <cell> --seed <n> \\
        [--pairs 2] [--out spantrace.json]

It sets the cell up as a run does, profiles the window's first sweep
with the spans on and joins the two (``tick.faults_device_ms``, the
breakdowns ``device_by_span`` / ``idle_by_span`` / ``host_by_span`` /
``runtime_by_span``, the share of busy and idle time under a span below
``sweep``, and the clock check: the share of the tick kernels' launches
inside their own ``kernels.<name>`` span), then times the sweep under
the profiler with the spans on and off, ``--pairs`` times each, in
turns. The result is one JSON line.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench.harness import busy_seconds  # noqa: E402


def records(ctx: dict):
    """The program's span records of the traced sweep (the last sweep the
    recorder saw), taken once per run and kept in ``ctx``; None where the
    program records no spans."""
    if "spans" not in ctx:
        ctx["spans"] = last_sweep(_take())
    return ctx["spans"]


def _take():
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.take()


def last_sweep(recs):
    """The records of the latest sweep among ``recs`` (None if none)."""
    sweeps = [r[3] for r in recs or () if r[3] > 0]
    if not sweeps:
        return None
    last = max(sweeps)
    return [r for r in recs if r[3] == last]


def durations_ns(recs: list, name: str) -> list:
    """The durations of the spans called ``name`` (or, for a name ending
    in ``.``, of every span whose name starts with it)."""
    if name.endswith("."):
        return [r[5] - r[4] for r in recs if r[0].startswith(name)]
    return [r[5] - r[4] for r in recs if r[0] == name]


def self_times(recs: list) -> dict:
    """Each span name's self time (s): its spans' durations minus the
    parts their child spans cover (children do not overlap)."""
    child = {}
    for r in recs:
        child[r[2]] = child.get(r[2], 0) + r[5] - r[4]
    out: dict = {}
    for r in recs:
        own = max(r[5] - r[4] - child.get(r[1], 0), 0)
        out[r[0]] = out.get(r[0], 0.0) + own / 1e9
    return out


def innermost(recs: list, times: list) -> list:
    """For each host time, the id of the innermost span open at it (0:
    none), by one sweep over the spans' bounds (they nest)."""
    bounds = [(r[4], 0, r[1]) for r in recs]
    bounds += [(r[5], 2, r[1]) for r in recs]
    bounds += [(t, 1, k) for k, t in enumerate(times)]
    bounds.sort()
    out = [0] * len(times)
    stack: list = []
    for _, kind, x in bounds:
        if kind == 0:
            stack.append(x)
        elif kind == 1:
            out[x] = stack[-1] if stack else 0
        elif stack and stack[-1] == x:
            stack.pop()
        elif x in stack:                # a parent closing with its child
            stack.remove(x)
    return out


def paths(recs: list) -> dict:
    """{span id: the names from the root down to it, joined by "/"}."""
    by_id = {r[1]: r for r in recs}
    out = {0: ""}
    for r in recs:
        chain, i = [], r[1]
        while i in by_id and i not in out:
            chain.append(i)
            i = by_id[i][2]
        base = out.get(i, "")
        for j in reversed(chain):
            base = f"{base}/{by_id[j][0]}" if base else by_id[j][0]
            out[j] = base
    return out


NO_LAUNCH = "(launch not found)"
NO_SPAN = "(no span)"


def attribute(recs: list, launches: dict, device: list) -> list:
    """The span path of each device operation (name, start, end,
    correlation id): the innermost span open at its launch's host time
    (``launches``: {correlation id: host ns}), less the root ``sweep/``;
    ``sweep`` itself where no span below it was open."""
    joined = [k for k, d in enumerate(device) if d[3] in launches]
    ids = innermost(recs, [launches[device[k][3]] for k in joined])
    path = paths(recs)
    out = [NO_LAUNCH] * len(device)
    for k, i in zip(joined, ids):
        out[k] = _label(path[i])
    return out


def _label(path: str) -> str:
    """A span path less its root ``sweep/``; NO_SPAN for none."""
    return path.split("/", 1)[1] if path.startswith("sweep/") else (
        path or NO_SPAN)


def below_sweep(label: str) -> bool:
    return label not in (NO_LAUNCH, NO_SPAN, "sweep")


def _gaps(device: list) -> list:
    """(index of the operation that ended it, seconds) of each idle gap
    of the device between the first operation and the last."""
    out, end = [], None
    for k in sorted(range(len(device)), key=lambda k: device[k][1]):
        s, e = device[k][1], device[k][2]
        if end is not None and s > end:
            out.append((k, (s - end) / 1e9))
        end = e if end is None else max(end, e)
    return out


def _top(d: dict) -> list:
    return [[k[:200], v] for k, v in sorted(d.items(),
                                           key=lambda kv: -kv[1])[:10]]


def span_breakdown(recs: list, launches: dict, device: list) -> dict:
    """``device_by_span``: device seconds by the span path of the launch;
    ``idle_by_span``: idle seconds by the span path of the launch of the
    operation that ended each gap; ``host_by_span``: each span name's
    self time; the ten largest of each. ``coverage``: the shares of busy
    and idle time put down to a span below ``sweep``."""
    where = attribute(recs, launches, device)
    dev: dict = {}
    for label, d in zip(where, device):
        dev[label] = dev.get(label, 0.0) + (d[2] - d[1]) / 1e9
    idle: dict = {}
    for k, s in _gaps(device):
        idle[where[k]] = idle.get(where[k], 0.0) + s
    share = lambda d: (sum(v for k, v in d.items() if below_sweep(k))  # noqa: E731
                       / sum(d.values()) if d else None)
    return {"device_by_span": _top(dev), "idle_by_span": _top(idle),
            "host_by_span": _top(self_times(recs)),
            "coverage": {"busy": share(dev), "idle": share(idle)}}


def faults_device_ms(recs: list, launches: dict, device: list):
    """Device busy (ms, the union) of the operations launched under a
    ``tick.faults`` span, per group tick; None where none opened."""
    if not any(r[0] == "tick.faults" for r in recs):
        return None
    ticks = len(durations_ns(recs, "tick"))
    where = attribute(recs, launches, device)
    mine = [d[:3] for label, d in zip(where, device)
            if "tick.faults" in label.split("/")]
    return busy_seconds(mine) * 1e3 / ticks


def clock_check(recs: list, launches: dict, device: list,
                sites: tuple) -> dict:
    """The share of the tick kernels' launches (``sites``: (name, pattern
    of the device operation's name, ...)) whose host time lies in their
    own ``kernels.<name>`` span: the spans and the profiler's events
    share a clock where it is 1."""
    import re
    pats = [(name, re.compile(pat)) for name, pat, *_ in sites]
    mine = []
    for d in device:
        if d[3] not in launches:
            continue
        for name, pat in pats:
            if pat.search(d[0]):
                mine.append((f"kernels.{name}", launches[d[3]]))
                break
    if not mine:
        return {"launches": 0}
    by_id = {r[1]: r[0] for r in recs}
    ids = innermost(recs, [t for _, t in mine])
    inside = sum(by_id.get(i) == want for (want, _), i in zip(mine, ids))
    return {"launches": len(mine), "inside": inside / len(mine)}


# ------------------------------------------------------------ the script --

#: the readers of ``metrics/`` that read the spans or the driver's counts
SPAN_METRICS = ("tick.host_ms", "kernels.wrapper_us", "driver.build_ms",
                "driver.masked_tick_share")


def read_events(prof) -> "tuple[list, list]":
    """From a finished ``torch.profiler`` run: the device operations
    (name, start ns, end ns, correlation id) and the host's runtime
    calls (name, start ns, end ns, correlation id): the launches, copies
    and syncs."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    device, calls = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
               e.correlation_id())
        (calls if e.device_type() == cpu else device).append(row)
    return device, calls


def launch_times(calls: list) -> dict:
    """{correlation id: host ns} of the runtime calls that carry one."""
    out: dict = {}
    for _, s, _, corr in calls:
        if corr and corr not in out:
            out[corr] = s
    return out


def runtime_by_span(recs: list, calls: list) -> list:
    """The host's seconds inside runtime calls, by call name and the span
    path it was made in (a launch that waits for a free slot of the
    launch queue, a sync that waits for the device): the ten largest."""
    ids = innermost(recs, [c[1] for c in calls])
    path = paths(recs)
    out: dict = {}
    for c, i in zip(calls, ids):
        key = f"{c[0]} @ {_label(path[i])}"
        out[key] = out.get(key, 0.0) + (c[2] - c[1]) / 1e9
    return _top(out)


def main(argv=None) -> int:
    import argparse
    import json
    import subprocess
    import time

    import torch

    from portbench import harness
    from repro_torch import spans
    from repro_torch.network import fabric

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spantrace: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    manifest = harness.load_manifest(ROOT)
    cell = harness.Cell.load(ROOT / "portbench", harness.workload_entry(
        manifest, args.workload))
    topo = cell.topology()
    harness.load_kernels(dev)
    prog = harness.Engine(harness.program_modules(), cell.config, dev)
    inputs = harness.sweep_inputs(cell, topo, args.seed, 0)
    prog.sweep(inputs, cell.lanes, int(prog.params.chunk_ticks))
    harness.sync(dev)
    acts = [torch.profiler.ProfilerActivity.CUDA]

    def traced(on: bool):
        (spans.follow_profiler if on else spans.disable)()
        spans.take()
        fabric.reset_driver_counts()
        with torch.profiler.profile(activities=acts) as prof:
            harness.sync(dev)
            t0 = time.perf_counter()
            rs = prog.sweep(inputs, cell.lanes, cell.max_ticks)
            harness.sync(dev)
            wall = time.perf_counter() - t0
        spans.follow_profiler()
        return prof, rs, wall

    prof, rs, wall = traced(True)
    recs = last_sweep(spans.take())
    counts = dict(fabric.DRIVER_COUNTS)     # the traced sweep's alone
    t1 = time.perf_counter()
    device, calls = read_events(prof)
    launches = launch_times(calls)
    del prof
    read_s = time.perf_counter() - t1
    metrics = ROOT / "portbench" / "metrics"
    roof = harness.load_module(metrics / "kernels.roofline_share.py")
    ctx = {"spans": recs}
    out = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(dev),
        "horizons": [int(r.horizon) for r in rs],
        "metrics": {m: harness.load_module(metrics / f"{m}.py").read(ctx)
                    for m in SPAN_METRICS}
        | {"tick.faults_device_ms": faults_device_ms(recs, launches,
                                                     device)},
        "driver_counts": counts, "spans": len(recs),
        "device_ops": len(device), "launches": len(launches),
        "joined": sum(d[3] in launches for d in device) / len(device),
        "clock": clock_check(recs, launches, device, roof.SITES),
        **span_breakdown(recs, launches, device),
        "runtime_by_span": runtime_by_span(recs, calls),
        "traced_wall_s": wall, "events_read_s": read_s}
    del rs, device, calls, launches
    out["cost_runs"] = []           # [spans on, traced wall s], in order
    for i in range(args.pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            _, rs, w = traced(on)
            spans.take()
            del rs, _
            out["cost_runs"].append([on, w])
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except OSError:
        smi = None
    out["smi"] = smi
    print(f"spantrace: under a span below sweep, busy "
          f"{out['coverage']['busy']:.6f}, idle {out['coverage']['idle']:.6f}; "
          f"tick kernels' launches in their own span {out['clock']}",
          file=sys.stderr)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
