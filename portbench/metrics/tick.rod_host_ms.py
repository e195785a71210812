"""tick.rod_host_ms (ms): the host's time a group tick in the tick's
ROD-only blocks in the traced sweep: the ``pds.rod`` spans' durations
(go-back-N's trigger in section 1, its rewind and in-order gate in
section 3, the receiver's reject and its counters in section 5, the OOO
NACK lanes in section 8) over the sweep's ``tick`` spans. None where the
sweep recorded no such span: a profile without ROD flows, or a program
without the spans."""
from portbench.spantrace import durations_ns, records


def read(ctx: dict):
    recs = records(ctx) or []
    rod, ticks = durations_ns(recs, "pds.rod"), durations_ns(recs, "tick")
    if not rod or not ticks:
        return None
    return sum(rod) / 1e6 / len(ticks)
