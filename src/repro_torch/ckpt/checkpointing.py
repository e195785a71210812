"""Checkpoint-restart economics (Young/Daly): the closed forms that price
the endpoint-failure recovery loop, from ``repro.ckpt.checkpointing``.

Given a failure rate (MTBF), a checkpoint write cost, and the measured
recovery costs — detection time from the fabric's PDC-teardown signal,
elastic restore, replan — what fraction of wall time is NEW forward
progress, and what checkpoint interval maximizes it?
`repro_torch.network.traffic.price_recovery` measures the costs and these
forms price effective throughput over an MTBF x checkpoint-interval grid.

Only the economics are here. The reference module's sharded save and
elastic restore of parameter trees belong to the model substrate, which
the port does not carry yet.
"""
from __future__ import annotations

import math


def young_daly_interval(mtbf_s: float, write_s: float) -> float:
    """Young/Daly first-order optimal checkpoint interval:
    ``tau* = sqrt(2 * write_s * mtbf_s)``.

    Within :func:`availability`'s overhead model this tau is EXACTLY the
    argmax (d/dtau of ``write/tau + tau/(2*MTBF)`` vanishes there), so
    any fixed interval != tau* prices strictly worse — the inequality
    the resilience bench asserts."""
    if mtbf_s <= 0:
        raise ValueError(f"mtbf_s must be > 0, got {mtbf_s}")
    if write_s < 0:
        raise ValueError(f"write_s must be >= 0, got {write_s}")
    return math.sqrt(2.0 * write_s * mtbf_s)


def availability(interval_s: float, mtbf_s: float, *, write_s: float,
                 detect_s: float = 0.0, restore_s: float = 0.0,
                 replan_s: float = 0.0) -> float:
    """Fraction of wall time spent on new forward progress under
    periodic checkpointing with exponential failures of rate 1/MTBF:

    * every interval pays one checkpoint write (``write_s / interval_s``
      of the time);
    * every failure pays detection (the fabric's fault -> PDC-teardown
      latency), checkpoint restore, collective replan, and on average
      half an interval of lost work (``interval_s / 2``).

    ``availability = 1 / (1 + write/tau + (tau/2 + D + R + P) / MTBF)``

    Strictly increasing in MTBF and strictly unimodal in ``interval_s``
    with its maximum at :func:`young_daly_interval`."""
    if interval_s <= 0:
        raise ValueError(f"interval_s must be > 0, got {interval_s}")
    if mtbf_s <= 0:
        raise ValueError(f"mtbf_s must be > 0, got {mtbf_s}")
    for name, v in (("write_s", write_s), ("detect_s", detect_s),
                    ("restore_s", restore_s), ("replan_s", replan_s)):
        if v < 0:
            raise ValueError(f"{name} must be >= 0, got {v}")
    per_failure = detect_s + restore_s + replan_s + interval_s / 2.0
    overhead = write_s / interval_s + per_failure / mtbf_s
    return 1.0 / (1.0 + overhead)


def effective_rate(healthy_rate: float, interval_s: float, mtbf_s: float,
                   **costs) -> float:
    """Throughput after the checkpoint-restart tax: e.g. effective
    tokens/sec = healthy tokens/sec x :func:`availability`."""
    return healthy_rate * availability(interval_s, mtbf_s, **costs)
