"""Receiver Credit-based Congestion Control (Sec. 3.3.2) — the port of
``repro.core.cms.rccc``.

The sender does not interpret network signals: it spends credits granted
by the *receiver*, which knows how many flows are arriving and divides
its ingress line rate among them, so incast sharing is exact but blind to
in-network congestion (hence the hybrid with NSCC, Sec. 3.3.3).

Receiver side (:func:`grant_credits`): once per tick each destination
splits ``rate * dfc`` evenly (or by ``demand``) across its active, seen
incoming flows. Sender side: a flow may inject while ``balance >= 1``;
an injection spends one credit. Balances start at the BDP (optimistic
start).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class RCCCState:
    """SoA over F flows.

    balance: [F] float32 — credits the sender may spend (packets)
    seen:    [F] bool    — the receiver has seen this flow's first packet;
                           credits flow only afterwards
    """

    balance: torch.Tensor
    seen: torch.Tensor

    @staticmethod
    def create(f: int, initial_credit: float,
               device: torch.device) -> "RCCCState":
        return RCCCState(
            balance=torch.full((f,), initial_credit, dtype=torch.float32,
                               device=device),
            seen=torch.zeros((f,), dtype=torch.bool, device=device))


def grant_credits(state: RCCCState, flow_dst: torch.Tensor,
                  active: torch.Tensor, num_hosts: int, rate: float = 1.0,
                  dfc: "torch.Tensor | None" = None,
                  demand: "torch.Tensor | None" = None) -> RCCCState:
    """One receiver scheduling round.

    flow_dst: [F] int32 destination host; active: [F] bool; dfc: [H]
    float32 per-destination rate scale (Destination Flow Control, Sec.
    3.3.4); demand: [F] float32 optional source demand weights. Each
    destination grants ``rate * dfc[h]`` split over its active seen flows
    in proportion to ``w`` (1 each by default).

    The per-destination weight sum is a scatter-add: on CUDA
    ``index_add_`` adds with atomics in no fixed order. With the default
    weights (the only ones the fabric tick passes) every weight is 0.0 or
    1.0, so every partial sum is a small integer, exact in f32 in any
    order, and the result is bitwise the reference's. A ``demand=`` sum
    is not exact and may differ in the last bit from run to run.
    """
    act = active & state.seen
    if demand is None:
        w = act.to(torch.float32)
    else:
        w = torch.where(act, demand.to(torch.float32), 0.0)
    dst = flow_dst.long()
    per_dst = torch.zeros((num_hosts,), dtype=torch.float32,
                          device=w.device).index_add_(0, dst, w)
    pd = per_dst[dst]
    share = torch.where(pd > 0, w / torch.clamp(pd, min=1e-9), 0.0)
    scale = rate if dfc is None else rate * dfc[dst]
    return replace(state, balance=state.balance + share * scale)


def _scatter_rows(flow: torch.Tensor, valid: torch.Tensor,
                  f: int) -> torch.Tensor:
    """Scatter rows under JAX's ``.at[...](mode="drop")`` rules: a
    negative flow counts from the end, an out-of-range one and a lane
    with ``valid`` unset go to the spare row ``f``."""
    idx = torch.where(flow < 0, flow + f, flow)
    ok = valid & (idx >= 0) & (idx < f)
    return torch.where(ok, idx, f).long()


def mark_seen(state: RCCCState, flow: torch.Tensor,
              valid: torch.Tensor) -> RCCCState:
    """The receiver observed the first packet(s) of flow(s): credits
    start flowing."""
    f = state.seen.shape[0]
    seen = torch.cat([state.seen, state.seen.new_zeros((1,))])
    seen[_scatter_rows(flow, valid, f)] = True
    return replace(state, seen=seen[:f])


def can_send(state: RCCCState) -> torch.Tensor:
    """[F] bool: the flow holds at least one packet credit."""
    return state.balance >= 1.0


def spend(state: RCCCState, flow: torch.Tensor,
          valid: torch.Tensor) -> RCCCState:
    """Deduct one credit per injected packet (lanes may repeat a flow:
    each adds -1.0, and repeated equal addends give one result in any
    order)."""
    f = state.balance.shape[0]
    bal = torch.cat([state.balance, state.balance.new_zeros((1,))])
    bal.index_add_(0, _scatter_rows(flow, valid, f),
                   torch.full(flow.shape, -1.0, dtype=torch.float32,
                              device=bal.device))
    return replace(state, balance=bal[:f])


@dataclass(frozen=True)
class RCCCPolicy:
    """RCCC as the fabric engine's CC policy (the protocol of
    ``repro_torch.network.profile``). ``initial_credit`` is the
    optimistic-start balance; ``report_cwnd`` is what the per-tick "cwnd"
    lane shows (RCCC has no window: it reports the static cap, and the
    live signal is the balance in the final state)."""

    initial_credit: float
    report_cwnd: float

    def create(self, f: int, device: torch.device) -> RCCCState:
        return RCCCState.create(f, self.initial_credit, device)

    def on_ack(self, st, has_ack, ecn, rtt):
        return st  # receiver-driven: network signals are ignored

    def on_nack(self, st, count):
        return st

    def on_grant_tick(self, st: RCCCState, flow_dst, active,
                      num_hosts: int) -> RCCCState:
        return grant_credits(st, flow_dst, active, num_hosts)

    def on_send_gate(self, st: RCCCState, inflight) -> torch.Tensor:
        return (inflight < int(self.report_cwnd)) & can_send(st)

    def on_inject(self, st: RCCCState, injected) -> RCCCState:
        return replace(st, balance=st.balance - injected.to(torch.float32))

    def on_rx_seen(self, st: RCCCState, seen) -> RCCCState:
        return replace(st, seen=st.seen | seen)

    def on_timeout(self, st, stalled):
        return st

    def end_of_tick(self, st, tick):
        return st

    def cwnd_view(self, st: RCCCState, f: int) -> torch.Tensor:
        return torch.full((f,), self.report_cwnd, dtype=torch.float32,
                          device=st.balance.device)
