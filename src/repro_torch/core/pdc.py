"""Ephemeral Packet Delivery Contexts — the dynamic creation state machine
(Sec. 3.2.3, Fig. 6) — the port of ``repro.core.pdc``.

The defining property: a PDC is established *by the first arriving packet*
with zero additional latency — the source keeps sending at full rate while
still in SYN state, and the target-assigned PDCID is echoed back in ACKs.
Closing drains via QUIESCE -> ACK_WAIT -> CLOSED, initiated by the source
when idle (optionally nudged by the target via control packet/ACK flags).

Implemented as a dense transition table over int32 codes so a whole pool of
PDCs steps in one gather. The initiator and target machines share the
state enum (`PDCState`) but use different tables, built here as the
reference builds them. Indexed reads and writes follow the reference's
rules (``repro_torch.core.scatter``): a repeated slot in one batch keeps
the last lane's value in a set and accumulates in an add, on every
device. uint32 lanes (the PSNs) are int32 bit patterns.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch._u32 import lane
from repro_torch.core import scatter
from repro_torch.core.types import PDCState


class InitEvent(enum.IntEnum):
    """Initiator-side events."""

    NONE = 0
    SEND_FIRST = 1     # SES asks to send, no PDC yet -> allocate, go SYN
    ACK_PDCID = 2      # first ACK carrying the target-assigned PDCID
    CLOSE_REQ = 3      # idle close decision (or target-requested via flags)
    DRAINED = 4        # all started messages fully sent
    ALL_ACKED = 5      # every outstanding reply arrived -> send final close
    CLOSE_ACK = 6      # final ACK for the close command
    PEER_DEAD = 7      # liveness lost: consecutive dead RTOs crossed the
    #                    teardown threshold -> abort straight to CLOSED
    #                    (no drain/handshake — the peer cannot answer)


class TgtEvent(enum.IntEnum):
    """Target-side events."""

    NONE = 0
    RX_SYN = 1         # first packet w/ SYN -> create PDC, assign PDCID
    RX_NOSYN = 2       # first packet without SYN -> initiator saw our PDCID
    RX_CLOSE = 3       # final close command
    SECURE_PENDING = 4  # TSS secure-PSN query (Sec. 3.4.2) -> PENDING
    SECURE_OK = 5      # accepted starting PSN


_S = PDCState
_NUM_STATES = len(_S)


def _table(rules: dict[tuple[int, int], int], num_events: int) -> np.ndarray:
    t = np.tile(np.arange(_NUM_STATES, dtype=np.int32)[:, None],
                (1, num_events))  # default: self-loop (event ignored)
    for (s, e), ns in rules.items():
        t[s, e] = ns
    return t


# Initiator transitions (Fig. 6 left). Unlisted (state, event) pairs hold.
INIT_TABLE = _table({
    (_S.CLOSED, InitEvent.SEND_FIRST): _S.SYN,
    (_S.SYN, InitEvent.ACK_PDCID): _S.ESTABLISHED,
    # a close can begin from SYN too if the message drains before the ACK
    (_S.SYN, InitEvent.CLOSE_REQ): _S.QUIESCE,
    (_S.ESTABLISHED, InitEvent.CLOSE_REQ): _S.QUIESCE,
    (_S.QUIESCE, InitEvent.DRAINED): _S.ACK_WAIT,
    (_S.ACK_WAIT, InitEvent.CLOSE_ACK): _S.CLOSED,
    # liveness teardown: any live state aborts to CLOSED when the peer is
    # declared unreachable — there is no one left to drain against. The
    # orderly QUIESCE -> ACK_WAIT path is bypassed by design.
    (_S.SYN, InitEvent.PEER_DEAD): _S.CLOSED,
    (_S.ESTABLISHED, InitEvent.PEER_DEAD): _S.CLOSED,
    (_S.QUIESCE, InitEvent.PEER_DEAD): _S.CLOSED,
    (_S.ACK_WAIT, InitEvent.PEER_DEAD): _S.CLOSED,
}, len(InitEvent))

# Target transitions (Fig. 6 right).
TGT_TABLE = _table({
    (_S.CLOSED, TgtEvent.RX_SYN): _S.SYN,
    (_S.CLOSED, TgtEvent.SECURE_PENDING): _S.PENDING,
    (_S.PENDING, TgtEvent.SECURE_OK): _S.SYN,
    (_S.SYN, TgtEvent.RX_NOSYN): _S.ESTABLISHED,
    (_S.SYN, TgtEvent.RX_CLOSE): _S.CLOSED,
    (_S.ESTABLISHED, TgtEvent.RX_CLOSE): _S.CLOSED,
}, len(TgtEvent))


def _step(table: np.ndarray, state: torch.Tensor, event) -> torch.Tensor:
    t = torch.as_tensor(table, device=state.device)
    e = lane(event, state.device)
    return t[scatter.read_index(state, table.shape[0]),
             scatter.read_index(e, table.shape[1])]


def step_initiator(state: torch.Tensor, event) -> torch.Tensor:
    """Vectorized initiator transition: next = T[state, event]."""
    return _step(INIT_TABLE, state, event)


def step_target(state: torch.Tensor, event) -> torch.Tensor:
    return _step(TGT_TABLE, state, event)


def may_send_data(state: torch.Tensor) -> torch.Tensor:
    """Full-rate sending is allowed in SYN (the headline feature: "the
    source has been sending at full rate during PDC establishment!"),
    ESTABLISHED, and QUIESCE (started messages drain)."""
    return (state == _S.SYN) | (state == _S.ESTABLISHED) | (state == _S.QUIESCE)


def may_accept_new_message(state: torch.Tensor) -> torch.Tensor:
    """QUIESCE refuses new messages; CLOSED implicitly allocates."""
    return (state == _S.CLOSED) | (state == _S.SYN) | (state == _S.ESTABLISHED)


def unreachable(strikes: torch.Tensor, dead_after: int) -> torch.Tensor:
    """[..] bool liveness verdict: a PDC whose consecutive zero-progress
    RTO-expiry count has reached ``dead_after`` is declared unreachable
    and takes the PEER_DEAD teardown. ``dead_after <= 0`` disables it
    (never unreachable), the contract of
    ``TransportProfile.pdc_dead_after``. The tick's quarantine lanes
    mirror exactly this predicate on their per-flow ``rto_strikes``."""
    if dead_after <= 0:
        return torch.zeros(strikes.shape, dtype=torch.bool,
                           device=strikes.device)
    return strikes >= int(dead_after)


@dataclass(frozen=True)
class PDCPool:
    """SoA pool of initiator-side PDCs.

    state:        [N] int32 PDCState
    peer:         [N] int32 destination FEP (-1 = free slot)
    local_id:     [N] int32 our PDCID (== slot index here)
    remote_id:    [N] int32 target-assigned PDCID (-1 until first ACK)
    next_psn:     [N] uint32 next PSN to stamp (starts random per Fig. 6)
    start_psn:    [N] uint32 first PSN of this PDC (for close bookkeeping)
    unacked:      [N] int32 packets outstanding
    active_msgs:  [N] int32 messages started and not finished
    tx_packets:   [N] int32 total request packets sent (TSS 2^31 close rule)
    mode:         [N] int32 DeliveryMode code — a PDC carries exactly one
                  delivery mode (Sec. 3.2.3: mixed-mode traffic between a
                  FEP pair opens one PDC per mode); set at open time and
                  immutable for the PDC's lifetime
    """

    state: torch.Tensor
    peer: torch.Tensor
    local_id: torch.Tensor
    remote_id: torch.Tensor
    next_psn: torch.Tensor
    start_psn: torch.Tensor
    unacked: torch.Tensor
    active_msgs: torch.Tensor
    tx_packets: torch.Tensor
    mode: torch.Tensor

    @staticmethod
    def create(n: int, device=None) -> "PDCPool":
        dev = resolve_device(device)

        def full(v):
            return torch.full((n,), v, dtype=torch.int32, device=dev)
        return PDCPool(
            state=full(int(_S.CLOSED)), peer=full(-1),
            local_id=torch.arange(n, dtype=torch.int32, device=dev),
            remote_id=full(-1), next_psn=full(0), start_psn=full(0),
            unacked=full(0), active_msgs=full(0), tx_packets=full(0),
            mode=full(0),  # DeliveryMode.RUD
        )


def open_pdc(pool: PDCPool, slot, peer, start_psn, mode=0) -> PDCPool:
    """SES first-send: allocate slot, go SYN, PSN starts at a random value
    (Fig. 6 starts at PSN 4). ``mode`` is the DeliveryMode code the PDC
    will carry (one PDC per mode per peer). ``start_psn`` is a uint32
    lane as its int32 pattern (a Python int may be unsigned)."""
    dev = pool.state.device
    psn = lane(start_psn, dev)
    return PDCPool(
        state=scatter.set_last(pool.state, slot, int(_S.SYN)),
        peer=scatter.set_last(pool.peer, slot, lane(peer, dev)),
        local_id=pool.local_id,
        remote_id=scatter.set_last(pool.remote_id, slot, -1),
        next_psn=scatter.set_last(pool.next_psn, slot, psn),
        start_psn=scatter.set_last(pool.start_psn, slot, psn),
        unacked=scatter.set_last(pool.unacked, slot, 0),
        active_msgs=scatter.set_last(pool.active_msgs, slot, 1),
        tx_packets=scatter.set_last(pool.tx_packets, slot, 0),
        mode=scatter.set_last(pool.mode, slot, lane(mode, dev)),
    )


def on_ack(pool: PDCPool, slot, remote_id, n_acked) -> PDCPool:
    """Process an ACK: learn the remote PDCID (SYN->ESTABLISHED), retire
    outstanding packets. Every lane reads the pool as it was before the
    batch; a repeated slot keeps its last lane's state and remote PDCID
    and retires the packets of all its lanes."""
    dev = pool.state.device
    rid = lane(remote_id, dev)
    cur = scatter.gather(pool.state, slot)
    got_id = rid >= 0
    ev = torch.where(got_id & (cur == _S.SYN), int(InitEvent.ACK_PDCID),
                     int(InitEvent.NONE))
    return PDCPool(
        state=scatter.set_last(pool.state, slot, step_initiator(cur, ev)),
        peer=pool.peer, local_id=pool.local_id,
        remote_id=scatter.set_last(
            pool.remote_id, slot,
            torch.where(got_id, rid, scatter.gather(pool.remote_id, slot))),
        next_psn=pool.next_psn, start_psn=pool.start_psn,
        unacked=scatter.add_at(pool.unacked, slot, -lane(n_acked, dev)),
        active_msgs=pool.active_msgs, tx_packets=pool.tx_packets,
        mode=pool.mode,
    )
