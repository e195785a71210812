"""tick.gbn_waste_share (%): the share of the data packets that reached
their receiver and carried no new PSN, the work that go-back-N throws
away: (duplicates + ROD rejects) / arrivals, from the program's counters
``fabric.TRANSPORT_COUNTS``, summed over every sweep the run finished
before the read (the warm-up chunk, the window and the traced sweep).
The results fix it, so only the traffic moves it. None where the traced
sweep recorded no ``pds.rod`` span (no ROD flows, or a program without
the spans) or the program has no such counters."""
from portbench.spantrace import durations_ns, records


def read(ctx: dict):
    from repro_torch.network import fabric
    counts = getattr(fabric, "TRANSPORT_COUNTS", None)
    if (not counts or not counts["arrivals"]
            or not durations_ns(records(ctx) or [], "pds.rod")):
        return None
    return 100.0 * (counts["dups"] + counts["rod_rejects"]) \
        / counts["arrivals"]
