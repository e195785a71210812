"""Declarative UET transport profiles (Sec. 2.2) — the port of
``repro.network.profile``.

A :class:`TransportProfile` is the frozen, hashable spec of one transport
composition: congestion control (``cc``), EV load balancing (``lb``),
per-flow delivery modes, and the recovery-loop statics. The named
constructors are the paper's profile table. This slice builds the NSCC
CC policy only; the others raise ``NotImplementedError``.

CC policy protocol (hooks the tick calls over densified [F] lanes)::

    create(F, device)              -> state
    on_ack(st, has_ack, ecn, rtt)  -> st    ACK arrived (<=1 per flow/tick)
    on_nack(st, count)             -> st    loss evidence (trim/OOO NACKs)
    on_grant_tick(st, dst, active, H) -> st receiver scheduling round
    on_send_gate(st, inflight)     -> [F] bool  may this flow inject?
    on_inject(st, injected)        -> st    a packet actually left
    on_rx_seen(st, seen)           -> st    receiver observed flow activity
    on_timeout(st, stalled)        -> st    retransmit timer fired
    end_of_tick(st, tick)          -> st    epoch work (Quick Adapt)
    cwnd_view(st, F)               -> [F] float32  reported window lane
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.cms.nscc import NSCCParams, NSCCPolicy
from repro_torch.core.lb.schemes import LBScheme


class CCAlgo(enum.IntEnum):
    """Congestion-control composition (Sec. 3.3)."""

    NONE = 0
    NSCC = 1
    RCCC = 2
    NSCC_AND_RCCC = 3


class DeliveryMode(enum.IntEnum):
    """Per-flow PDS delivery mode (Sec. 3.2.1)."""

    RUD = 0   # reliable unordered — spraying + selective retransmit
    ROD = 1   # reliable ordered — go-back-N on one static path
    RUDI = 3  # reliable unordered, idempotent ops — dedup-free receiver


@dataclass(frozen=True)
class TransportProfile:
    """Frozen, hashable spec of one transport operating point (fields as
    in the reference ``TransportProfile``; ``name`` is a display label
    excluded from equality)."""

    cc: CCAlgo = CCAlgo.NSCC
    lb: LBScheme = LBScheme.OBLIVIOUS
    delivery: "DeliveryMode | tuple[DeliveryMode, ...]" = DeliveryMode.RUD
    inc: bool = False
    rto_backoff: float = 1.0
    rto_max_scale: int = 8
    ev_eviction: bool = False
    pdc_dead_after: int = 0
    name: str = field(default="custom", compare=False)

    def __post_init__(self):
        if isinstance(self.delivery, (list, tuple)):
            object.__setattr__(
                self, "delivery",
                tuple(DeliveryMode(m) for m in self.delivery))
        else:
            object.__setattr__(self, "delivery", DeliveryMode(self.delivery))
        if self.rto_backoff < 1.0:
            raise ValueError(f"rto_backoff must be >= 1.0 (got "
                             f"{self.rto_backoff}); 1.0 disables backoff")
        if self.rto_max_scale < 1:
            raise ValueError(f"rto_max_scale must be >= 1, got "
                             f"{self.rto_max_scale}")
        if self.pdc_dead_after < 0:
            raise ValueError(f"pdc_dead_after must be >= 0 (got "
                             f"{self.pdc_dead_after}); 0 disables liveness "
                             f"teardown")

    # -- named constructors (paper Sec. 2.2 profile table) ----------------
    @classmethod
    def ai_base(cls, **overrides) -> "TransportProfile":
        return cls(**{"cc": CCAlgo.RCCC, "lb": LBScheme.OBLIVIOUS,
                      "delivery": DeliveryMode.RUD, "name": "ai_base",
                      **overrides})

    @classmethod
    def ai_full(cls, **overrides) -> "TransportProfile":
        return cls(**{"cc": CCAlgo.NSCC, "lb": LBScheme.OBLIVIOUS,
                      "delivery": DeliveryMode.RUD, "name": "ai_full",
                      **overrides})

    @classmethod
    def hpc(cls, **overrides) -> "TransportProfile":
        return cls(**{"cc": CCAlgo.NSCC_AND_RCCC, "lb": LBScheme.REPS,
                      "delivery": DeliveryMode.ROD, "name": "hpc",
                      **overrides})

    @classmethod
    def resilient(cls, **overrides) -> "TransportProfile":
        return cls(**{"cc": CCAlgo.NSCC, "lb": LBScheme.OBLIVIOUS,
                      "delivery": DeliveryMode.RUD, "rto_backoff": 2.0,
                      "ev_eviction": True, "pdc_dead_after": 4,
                      "name": "resilient", **overrides})

    def delivery_modes(self, num_flows: int) -> np.ndarray:
        """[F] int array of DeliveryMode codes (validates per-flow tuples)."""
        if isinstance(self.delivery, tuple):
            if len(self.delivery) != num_flows:
                raise ValueError(
                    f"profile has {len(self.delivery)} per-flow delivery "
                    f"modes but the workload has {num_flows} flows")
            return np.asarray([int(m) for m in self.delivery], np.int32)
        return np.full((num_flows,), int(self.delivery), np.int32)


def make_cc_policy(cc: CCAlgo, nparams: NSCCParams, max_cwnd: float):
    """Instantiate the CC policy object a profile asks for."""
    if cc == CCAlgo.NSCC:
        return NSCCPolicy(params=nparams)
    if cc in (CCAlgo.RCCC, CCAlgo.NSCC_AND_RCCC, CCAlgo.NONE):
        raise NotImplementedError(
            f"CC algorithm {CCAlgo(cc).name} is not ported yet (ROADMAP.md, "
            f"'Modules to port' item 2: RCCC, hybrid and open-loop "
            f"policies)")
    raise ValueError(f"unknown CC algorithm: {cc!r}")
