"""kernels.roofline_share (%): over the tick's hand-written kernels in
the traced chunk, the least time their bytes need at the card's
bandwidth over the time they took: sum of bytes / 3.35 TB/s over sum of
device time.

Each kernel's bytes are computed here from the tick's shapes (B lanes,
F flows, W ring words, Q queues, L = Q + 2F NACK lanes a scenario, the
routing tables), with each lane read and written once and the tables
read once, as in PERF.md's kernel table; n = B x F rows. So a change
that fuses or replaces a kernel does not change the count of work. The
three bit marks (the NACK lanes, set and clear own bit) also write the
words they mark; how many depends on the data, so only their lanes are
counted and their bound is a lower one. Kernels are known by the names
of their CUDA functions (``repro_torch/kernels/csrc``).
"""
import re


def _route_tables(t: dict) -> int:
    return 4 * sum(t[k] for k in ("stage", "next_switch", "host_leaf",
                                  "host_queue", "host_pod", "down1", "up2",
                                  "down2"))


#: (pattern of the device operation's name, bytes of one launch)
SITES = (
    # ring, rtx, base, off in (4 B), ok, clear in (1 B); ring, rtx, base,
    # adv out (4 B), already out (1 B)
    ("sack_fused_own", r"sack_kernel<true, true",
     lambda s: 16 * s["n"] * s["W"] + 19 * s["n"]),
    # ring, base, off in (4 B), ok in (1 B); ring, base, adv out (4 B),
    # already out (1 B)
    ("sack_advance_own", r"sack_kernel<false, true",
     lambda s: 8 * s["n"] * s["W"] + 18 * s["n"]),
    # each lane's flow and PSN (4 B) and NACK flag (1 B)
    ("nack_mark_lanes", r"nack_mark_kernel<true",
     lambda s: 9 * s["B"] * s["L"]),
    # each row's offset (4 B) and flag (1 B)
    ("set_own_bit", r"own_bit_kernel<true", lambda s: 5 * s["n"]),
    ("clear_own_bit", r"own_bit_kernel<false", lambda s: 5 * s["n"]),
    # cwnd, rtt, acked (4 B), has_ack, ecn (1 B) in; cwnd, acked out
    ("nscc_ack", r"nscc_ack_kernel", lambda s: 22 * s["n"]),
    # four 4-byte lanes in and out
    ("nscc_epoch", r"nscc_epoch_kernel", lambda s: 32 * s["n"]),
    # src, dst, ev in, the queue out; host_leaf, host_queue, up1 once
    ("ecmp_inject", r"ecmp_inject_kernel",
     lambda s: 16 * s["n"] + 4 * sum(s["tables"][k] for k in (
         "host_leaf", "host_queue", "up1"))),
    # the [Q] queue ids once; src, dst, ev in and the queue out for B x Q
    # heads; the tables once
    ("ecmp_route", r"ecmp_route_kernel",
     lambda s: 4 * s["Q"] + 16 * s["B"] * s["Q"]
     + _route_tables(s["tables"])),
)


def site_bytes(shapes: dict) -> dict:
    s = dict(shapes, n=shapes["B"] * shapes["F"])
    return {name: fn(s) for name, _, fn in SITES}


def read(ctx: dict):
    per = site_bytes(ctx["shapes"])
    pats = [(name, re.compile(pat)) for name, pat, _ in SITES]
    least = took = 0.0
    for op, start, end in ctx["trace"]["device"]:
        for name, pat in pats:
            if pat.search(op):
                least += per[name] / ctx["hbm_bytes_per_s"]
                took += (end - start) / 1e9
                break
    if not took:
        return None
    return 100.0 * least / took
