"""tick.host_ms (ms): the host's time a group tick in the traced sweep:
the ``tick`` spans' durations (each ``step`` call of the chunk loop, its
dispatch of the tick's device operations) over their count. Read from
the program's spans (``repro_torch.spans``), which record while the
profiler runs; None for a program without them."""
from portbench.spantrace import durations_ns, records


def read(ctx: dict):
    ticks = durations_ns(records(ctx) or [], "tick")
    if not ticks:
        return None
    return sum(ticks) / 1e6 / len(ticks)
