#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port of the UET fabric engine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. It runs one
cell of ``BENCHMARK.json``: set-up (the kernels, the fat tree, a warm-up
chunk at the cell's shapes), a window of ``--seconds`` seconds of sweeps
through ``repro_torch.network.fabric.simulate_batch``, and the check of
one sweep of the window against the plain reference. With ``--trace 0``
the result carries the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, read from the same window and from its first sweep run
again under ``torch.profiler``. The window ends with the first sweep that
finishes after ``--seconds``, so it holds whole sweeps only.

The last line of standard output is the result, one JSON object; the
last lines of standard error are the numbers compared, each beside its
limit. A run exits non-zero and prints no result when there is no CUDA
card, when the cell asks for more cards than there are, or when the
process has loaded JAX or the JAX package by the end.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    entry = harness.workload_entry(harness.load_manifest(ROOT),
                                   args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(entry["chips"]):
        print(f"portbench: the cell asks for {entry['chips']} cards, there "
              f"are {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda"), T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    print(json.dumps({k: v for k, v in res.items() if k != "checks"}
                     | {"checks": res["checks"]}))
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
