#!/usr/bin/env python
"""Export a fabric telemetry run of the PyTorch port as
Chrome-trace/Perfetto JSON (the port's ``scripts/trace_export.py``).

Runs the canonical flap-victim scenario (``workloads.victim_sweep`` with
3 of 4 leaf-0 uplinks flapping mid-run) with telemetry on and writes the
probe lanes as counter tracks — queue-occupancy EWMA, per-queue
mark/trim/drop rates, per-flow RTT and cwnd, inflight — loadable
directly in ``chrome://tracing`` or https://ui.perfetto.dev. The run
lives on ``cuda`` unless ``--device cpu`` is given.

    PYTHONPATH=src python scripts/trace_export_torch.py --out fabric_trace.json
    PYTHONPATH=src python scripts/trace_export_torch.py --ticks 6000 \
        --probe-every 8 --slots 128 [--device cpu]

One tick renders as one microsecond in the viewer.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="fabric_trace.json",
                    help="output JSON path (default: fabric_trace.json)")
    ap.add_argument("--ticks", type=int, default=3000,
                    help="tick budget (default: 3000)")
    ap.add_argument("--probe-every", type=int, default=16,
                    help="base sampling cadence in ticks (default: 16)")
    ap.add_argument("--slots", type=int, default=64,
                    help="telemetry ring capacity (default: 64)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from dataclasses import replace

    from repro_torch.network.fabric import simulate
    from repro_torch.network.telemetry import (TelemetrySpec,
                                               flap_victim_scenario)

    g, wl, prof, p, sched, _, (fail_at, heal_at) = flap_victim_scenario()
    p = replace(p, ticks=args.ticks)
    spec = TelemetrySpec.on(probe_every=args.probe_every, slots=args.slots)
    print(f"simulating {args.ticks} ticks (flap window [{fail_at}, "
          f"{heal_at}), probe_every={args.probe_every}, "
          f"slots={args.slots}) ...")
    r = simulate(g, wl, prof, p, faults=sched, telemetry=spec,
                 device=args.device)
    tr = r.telemetry
    tr.save_chrome_trace(args.out)
    s = tr.summary()
    print(f"wrote {args.out}: {tr.num_samples} samples at "
          f"{tr.sample_spacing}-tick spacing, "
          f"{len(tr.to_chrome_trace())} counter events")
    print(f"summary: occ p50/p99 {s['occ_p50']:.1f}/{s['occ_p99']:.1f}, "
          f"marks {s['marks_total']}, trims {s['trims_total']}, "
          f"drops {s['drops_total']}, goodput {s.get('goodput', 0):.2f} "
          f"pkts/tick")
    print("open in chrome://tracing or https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
