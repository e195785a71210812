"""tick.rccc_host_ms (ms): the host's time a group tick in RCCC's
receiver-credit policy in the traced sweep: the ``policy.rccc`` spans'
durations (``RCCCPolicy``'s grant round, send gate, spend, seen-merge and
window view; under the hybrid inside ``policy.cc``) over the sweep's
``tick`` spans. None where the sweep recorded no such span: a profile
without RCCC, or a program without the spans."""
from portbench.spantrace import durations_ns, records


def read(ctx: dict):
    recs = records(ctx) or []
    rccc, ticks = durations_ns(recs, "policy.rccc"), durations_ns(recs, "tick")
    if not rccc or not ticks:
        return None
    return sum(rccc) / 1e6 / len(ticks)
