"""Declarative UET transport profiles (Sec. 2.2) — the port of
``repro.network.profile``.

A :class:`TransportProfile` is the frozen, hashable spec of one transport
composition: congestion control (``cc``), EV load balancing (``lb``),
per-flow delivery modes, and the recovery-loop statics. The named
constructors are the paper's profile table; ``make_cc_policy`` builds
every CC composition (NSCC, RCCC, the hybrid of both, open loop) and
``cc_ablation`` the CC-ablation axis.

CC policy protocol (hooks the tick calls over densified [F] lanes, or
[B, F] lanes with one scenario per row; ``F`` below is the lane shape,
an int or a tuple such as (B, F))::

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
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .nscc import NSCCParams, NSCCPolicy
from .rccc import RCCCPolicy
from .schemes import LBScheme
from .uet_types import lane_shape


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

    def describe(self) -> str:
        d = (self.delivery.name if isinstance(self.delivery, DeliveryMode)
             else "per-flow[" + ",".join(m.name for m in self.delivery) + "]")
        inc = ", inc=on" if self.inc else ""
        rec = ""
        if self.rto_backoff != 1.0:
            rec += (f", rto_backoff={self.rto_backoff:g}x"
                    f"(cap {self.rto_max_scale}x)")
        if self.ev_eviction:
            rec += ", ev_eviction=on"
        if self.pdc_dead_after:
            rec += f", pdc_dead_after={self.pdc_dead_after}"
        return (f"{self.name}(cc={self.cc.name}, lb={self.lb.name}, "
                f"delivery={d}{inc}{rec})")


@dataclass(frozen=True)
class OpenLoopPolicy:
    """No congestion control: a fixed window of ``max_cwnd`` packets. Its
    state is an empty [0] int32 tensor (as the reference's placeholder;
    [B, 0] over B scenarios)."""

    max_cwnd: float

    def create(self, f, device: torch.device) -> torch.Tensor:
        return torch.zeros(lane_shape(f)[:-1] + (0,), dtype=torch.int32,
                           device=device)

    def on_ack(self, st, has_ack, ecn, rtt):
        return st

    def on_nack(self, st, count):
        return st

    def on_grant_tick(self, st, flow_dst, active, num_hosts):
        return st

    def on_send_gate(self, st, inflight) -> torch.Tensor:
        return inflight < int(self.max_cwnd)

    def on_inject(self, st, injected):
        return st

    def on_rx_seen(self, st, seen):
        return st

    def on_timeout(self, st, stalled):
        return st

    def end_of_tick(self, st, tick):
        return st

    def cwnd_view(self, st: torch.Tensor, f) -> torch.Tensor:
        return torch.full(lane_shape(f), self.max_cwnd, dtype=torch.float32,
                          device=st.device)


@dataclass(frozen=True)
class HybridCCPolicy:
    """NSCC and RCCC composed (Sec. 3.3.3): the sender obeys both the
    network-signal window and the receiver credit balance; each
    sub-policy sees the feedback it would see alone. State: the dict
    ``{"nscc": NSCCState, "rccc": RCCCState}``."""

    nscc: NSCCPolicy
    rccc: RCCCPolicy

    def create(self, f, device: torch.device) -> dict:
        return {"nscc": self.nscc.create(f, device),
                "rccc": self.rccc.create(f, device)}

    def on_ack(self, st, has_ack, ecn, rtt):
        return {"nscc": self.nscc.on_ack(st["nscc"], has_ack, ecn, rtt),
                "rccc": st["rccc"]}

    def on_nack(self, st, count):
        return {"nscc": self.nscc.on_nack(st["nscc"], count),
                "rccc": st["rccc"]}

    def on_grant_tick(self, st, flow_dst, active, num_hosts):
        return {"nscc": st["nscc"],
                "rccc": self.rccc.on_grant_tick(st["rccc"], flow_dst,
                                                active, num_hosts)}

    def on_send_gate(self, st, inflight) -> torch.Tensor:
        return (self.nscc.on_send_gate(st["nscc"], inflight)
                & self.rccc.on_send_gate(st["rccc"], inflight))

    def on_inject(self, st, injected):
        return {"nscc": st["nscc"],
                "rccc": self.rccc.on_inject(st["rccc"], injected)}

    def on_rx_seen(self, st, seen):
        return {"nscc": st["nscc"],
                "rccc": self.rccc.on_rx_seen(st["rccc"], seen)}

    def on_timeout(self, st, stalled):
        return {"nscc": self.nscc.on_timeout(st["nscc"], stalled),
                "rccc": st["rccc"]}

    def end_of_tick(self, st, tick):
        return {"nscc": self.nscc.end_of_tick(st["nscc"], tick),
                "rccc": st["rccc"]}

    def cwnd_view(self, st, f) -> torch.Tensor:
        return self.nscc.cwnd_view(st["nscc"], f)


def make_cc_policy(cc: CCAlgo, nparams: NSCCParams, max_cwnd: float):
    """Instantiate the CC policy object a profile asks for."""
    if cc == CCAlgo.NSCC:
        return NSCCPolicy(params=nparams)
    if cc == CCAlgo.RCCC:
        return RCCCPolicy(initial_credit=max_cwnd, report_cwnd=max_cwnd)
    if cc == CCAlgo.NSCC_AND_RCCC:
        return HybridCCPolicy(
            nscc=NSCCPolicy(params=nparams),
            rccc=RCCCPolicy(initial_credit=max_cwnd, report_cwnd=max_cwnd))
    if cc == CCAlgo.NONE:
        return OpenLoopPolicy(max_cwnd=max_cwnd)
    raise ValueError(f"unknown CC algorithm: {cc!r}")


def cc_ablation(base: "TransportProfile | None" = None
                ) -> "list[TransportProfile]":
    """The CC-ablation axis over one composition: NSCC-only vs RCCC-only
    vs hybrid, all else (lb, delivery) held from ``base`` (default
    ai_full)."""
    base = TransportProfile.ai_full() if base is None else base
    return [replace(base, cc=CCAlgo.NSCC, name="nscc_only"),
            replace(base, cc=CCAlgo.RCCC, name="rccc_only"),
            replace(base, cc=CCAlgo.NSCC_AND_RCCC, name="hybrid")]
