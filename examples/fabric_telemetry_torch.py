"""Fabric telemetry tour on the PyTorch port: watch an outage happen,
then export it. It walks the steps of ``examples/fabric_telemetry.py``
(the JAX package's tour) and prints the same lines.

The scenario is the canonical flap-victim run (``workloads.victim_
sweep`` with 3 of leaf-0's 4 uplinks flapping over [1000, 1800)): 12
cross-leaf flows pile onto the one surviving uplink while the probes
record what UET's own congestion signals show. The walkthrough:

  [1] run with ``telemetry=TelemetrySpec.on()`` — one extra kwarg, and
      the probes provably change nothing (final state is bitwise the
      off-run's);
  [2] read the outage off the lanes: the four closed-loop signatures
      (silent-drop confinement, NSCC's mark-rate back-off, the goodput
      dip + recovery, the heal-boundary trim burst);
  [3] ASCII-plot the victim uplink's occupancy EWMA straight from the
      decimated ring;
  [4] export everything as Perfetto/Chrome-trace counter tracks, to
      ``fabric_trace.json`` in the working directory.

The run lives on ``cuda`` unless ``--device cpu`` is given (there is no
CPU fallback).

Run: PYTHONPATH=src python examples/fabric_telemetry_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.network.fabric import simulate
from repro_torch.network.telemetry import (flap_victim_scenario,
                                           outage_visibility)


def spark(vals, width=60):
    """One-line ASCII sparkline."""
    ramp = " .:-=+*#%@"
    v = np.asarray(vals, float)
    if v.size > width:  # decimate for the terminal like the ring does
        v = v[np.linspace(0, v.size - 1, width).astype(int)]
    hi = v.max() or 1.0
    return "".join(ramp[int(x / hi * (len(ramp) - 1))] for x in v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    device = ap.parse_args(argv).device
    print("=== fabric telemetry tour ===")
    g, wl, prof, p, sched, spec, (fail_at, heal_at) = flap_victim_scenario()

    print(f"\n[1] {p.ticks}-tick victim-share run, 3 uplinks flapping over "
          f"[{fail_at}, {heal_at}), telemetry on")
    r = simulate(g, wl, prof, p, faults=sched, telemetry=spec, device=device)
    tr = r.telemetry
    print(f"    {tr.num_samples} samples at {tr.sample_spacing}-tick "
          f"spacing (probe_every={spec.probe_every}, ring of "
          f"{spec.slots} slots decimated to stride {tr.stride})")
    s = tr.summary()
    print(f"    occ p50/p99 {s['occ_p50']:.1f}/{s['occ_p99']:.1f} pkts, "
          f"rtt p50/p99 {s.get('rtt_p50', 0):.0f}/{s.get('rtt_p99', 0):.0f} "
          f"ticks, {s['marks_total']} marks, {s['trims_total']} trims, "
          f"{s['drops_total']} silent drops")

    print("\n[2] the outage in the lanes (what a CLOSED-LOOP transport "
          "shows — see DESIGN.md 'Telemetry contract'):")
    vis = outage_visibility(tr, fail_at, heal_at, p.ticks)
    print(f"    silent drops   : {vis['drop_pre']:.2f} -> "
          f"{vis['drop_during']:.2f} -> {vis['drop_post']:.2f}/tick "
          f"(confined to the window — dead links say nothing)")
    print(f"    ECN mark rate  : {vis['mark_pre']:.2f} -> "
          f"{vis['mark_during']:.2f}/tick (NSCC backs off on the "
          f"shrinking ACK stream: marks CRATER, not spike)")
    print(f"    goodput        : {vis['goodput_pre']:.2f} -> "
          f"{vis['goodput_during']:.2f} -> {vis['goodput_post']:.2f} "
          f"pkts/tick (dip, then recovery)")
    print(f"    heal trim burst: {vis['trim_pre']:.2f} -> "
          f"{vis['trim_burst']:.2f}/tick right after heal_at (every "
          f"flow's retransmit backlog floods the restored links at once)")

    print("\n[3] the surviving uplink's occupancy EWMA, straight off the "
          "decimated ring:")
    # victim_sweep names leaf-0's uplink queues; the flap takes all but
    # the last, so the survivor carries the whole cross-leaf load
    from repro_torch.network import workloads
    _, _, exp = workloads.victim_sweep()
    q = exp["uplinks"][-1]
    occ = tr.occ[:, q]
    print(f"    q{q}: {spark(occ)}")
    w = (tr.ticks >= fail_at) & (tr.ticks < heal_at)
    print(f"    in-window mean {occ[w].mean():.1f} vs outside "
          f"{occ[~w].mean():.1f} pkts")

    print("\n[4] Perfetto export")
    out = "fabric_trace.json"
    tr.save_chrome_trace(out)
    print(f"    wrote {out} ({len(tr.to_chrome_trace())} counter events) — "
          f"open in chrome://tracing or https://ui.perfetto.dev")
    print("    (scripts/trace_export.py is the CLI for custom budgets / "
          "cadences)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
