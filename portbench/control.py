#!/usr/bin/env python3
"""The control of ``correct``: the reference put in the program's place,
with its congestion windows held in bfloat16, one precision below the
float32 that the configurations state.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--device cuda|cpu]

For each seed it runs the first sweep of the cell (as a run with that
``--seed`` draws it) through the reference twice, once as it is and once
under :func:`bf16_windows`, and prints one JSON line per seed with the
numbers ``correct`` compares (``harness.LIMITS``). The benchmark's own
runs never run it; it reads the upper end of each limit.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from portbench import harness  # noqa: E402


@contextlib.contextmanager
def bf16_windows():
    """The reference's NSCC window updates (the tick's two sites) with
    ``cwnd`` rounded to bfloat16 on the way in and out."""
    from portbench.reference import kops
    ack, epoch = kops.nscc_ack, kops.nscc_epoch

    def bf16(cwnd: torch.Tensor) -> torch.Tensor:
        return cwnd.to(torch.bfloat16).to(torch.float32)

    def ack_bf16(cwnd, *args):
        cw, acked = ack(bf16(cwnd), *args)
        return bf16(cw), acked

    def epoch_bf16(cwnd, *args):
        cw, *rest = epoch(bf16(cwnd), *args)
        return (bf16(cw), *rest)

    kops.nscc_ack, kops.nscc_epoch = ack_bf16, epoch_bf16
    try:
        yield
    finally:
        kops.nscc_ack, kops.nscc_epoch = ack, epoch


def control(root: Path, name: str, seeds, dev: torch.device) -> list:
    """{seed, numbers compared, seconds} for each seed: the bfloat16
    control against the reference on the first sweep of a run."""
    entry = harness.workload_entry(harness.load_manifest(root), name)
    cell = harness.Cell.load(root / harness.BENCH.name, entry)
    topo = cell.topology()
    ref = harness.Engine(harness.reference_modules(), cell.config, dev)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        inputs = harness.sweep_inputs(cell, topo, seed, 0)
        want = harness.lane_outputs(
            ref.sweep(inputs, cell.lanes, cell.max_ticks))
        with bf16_windows():
            got = harness.lane_outputs(
                ref.sweep(inputs, cell.lanes, cell.max_ticks))
        res = harness.compare(got, want)
        out.append({"seed": seed,
                    **{k: res[k] for k in harness.LIMITS},
                    "lanes_differing": res["lanes_differing"],
                    "where": dict(list(res["where"].items())[:12]),
                    "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for row in control(ROOT, args.workload, args.seeds,
                       torch.device(args.device)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
