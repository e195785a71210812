"""Link-layer options: Link-Level Retry and Credit-Based Flow Control
(Sec. 3.5) — a copy of ``repro.core.link`` (the port imports nothing of
the reference package). ``LinkConfig`` is the ``link=`` static of the
fabric tick (``repro_torch.network.fabric``): LLR replay at the hop and
the CBFC credit gate.

LLR: go-back-N retransmission confined to one link. Justified at this
layer (unlike end-to-end, which UET redesigned away from go-back-N)
because the link RTT is ~1 us, bounded, and congestion plays no role —
only PHY corruption drops. Modeled as a replay-buffer state machine whose
invariants (no loss escapes the link; buffer bounded by link BDP) are
tested in tests/test_link_tss.py.

CBFC: 20-bit cyclic credit counters at sender and receiver per virtual
channel, periodically synchronized. Compared against PFC headroom:
PFC needs RTT+MTU headroom per (port, priority) to be lossless; CBFC
needs only the actual receive buffer it advertises (Sec. 3.5.2 claims
(1)-(4); `pfc_headroom_bytes` / `cbfc_buffer_bytes` quantify claim (1)).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


CTR_BITS = 20
CTR_MOD = 1 << CTR_BITS


# ---------------------------------------------------------------------------
# LLR — go-back-N on one link
# ---------------------------------------------------------------------------


@dataclass
class LLRLink:
    """One LLR-enabled link direction (host-side model, event-driven)."""

    replay_capacity: int = 64
    timeout: int = 8               # ~link RTT in frame times
    # state
    next_seq: int = 0              # next new frame sequence
    send_base: int = 0             # oldest unacked
    now: int = 0
    last_progress: int = 0
    retransmissions: int = 0

    def in_flight(self) -> int:
        return self.next_seq - self.send_base

    def can_send(self) -> bool:
        return self.in_flight() < self.replay_capacity

    def send(self) -> int:
        assert self.can_send()
        seq = self.next_seq
        self.next_seq += 1
        return seq

    def on_ack(self, seq: int):
        """Cumulative ACK frees the replay buffer up to seq."""
        if seq >= self.send_base:
            self.send_base = seq + 1
            self.last_progress = self.now

    def on_nack(self, seq: int) -> list[int]:
        """Receiver saw a gap: go-back-N from `seq`. A duplicate or
        late NACK (seq below the cumulative-ACK base) is stale — the
        frames it names are already freed from the replay buffer, so
        replay starts at `send_base`, never before it."""
        seq = max(seq, self.send_base)
        self.retransmissions += self.next_seq - seq
        resend = list(range(seq, self.next_seq))
        return resend

    def tick(self) -> list[int]:
        """Timeout guard for tail loss: resend everything outstanding."""
        self.now += 1
        if (self.in_flight() > 0
                and self.now - self.last_progress > self.timeout):
            self.last_progress = self.now
            self.retransmissions += self.in_flight()
            return list(range(self.send_base, self.next_seq))
        return []


def llr_deliver(frames_sent: list[int], corrupt: set[int],
                expected: int = 0) -> list[int]:
    """Receiver view: frames arrive in order; corrupted ones are dropped
    and NACK'd by the first out-of-order arrival. `expected` carries the
    receiver's next-in-order sequence across retransmission rounds."""
    delivered = []
    for f in frames_sent:
        if f in corrupt:
            continue
        if f == expected:
            delivered.append(f)
            expected += 1
    return delivered


# ---------------------------------------------------------------------------
# CBFC — credit counters per virtual channel
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CBFCState:
    """20-bit cyclic counters (Sec. 3.5.2): sender tracks consumed,
    receiver tracks freed; available = buffer - (consumed - freed)."""

    buffer_bytes: int
    consumed: int = 0   # sender-side, mod 2^20 (units: cells/bytes)
    freed: int = 0      # receiver-side, mod 2^20

    def available(self) -> int:
        return self.buffer_bytes - ((self.consumed - self.freed) % CTR_MOD)

    def can_send(self, size: int) -> bool:
        return self.available() >= size

    def send(self, size: int) -> "CBFCState":
        assert self.can_send(size), "CBFC never oversends"
        return replace(self, consumed=(self.consumed + size) % CTR_MOD)

    def drain(self, size: int) -> "CBFCState":
        """Receiver forwards a packet out of its buffer -> credit update
        message back to the sender."""
        return replace(self, freed=(self.freed + size) % CTR_MOD)


def pfc_headroom_bytes(link_gbps: float, cable_m: float, mtu: int,
                       priorities: int = 8) -> float:
    """Lossless PFC headroom per port: in-flight bytes during the pause
    round trip (2x propagation + 2x MTU serialization + response time),
    per priority class."""
    c = 2e8  # m/s in fiber
    rtt_s = 2 * cable_m / c
    inflight = link_gbps * 1e9 / 8 * rtt_s
    return priorities * (inflight + 2 * mtu)


def cbfc_buffer_bytes(link_gbps: float, cable_m: float, mtu: int,
                      active_vcs: int = 2) -> float:
    """CBFC needs one link-BDP of credited buffer to keep the pipe full —
    and only for the VCs actually in use (claims (1) and (4))."""
    c = 2e8
    rtt_s = 2 * cable_m / c
    bdp = link_gbps * 1e9 / 8 * rtt_s
    return active_vcs * (bdp + mtu)


# ---------------------------------------------------------------------------
# LinkConfig — the traced-engine gating spec (repro.network.fabric)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkConfig:
    """Link-layer reliability spec for the batched tick engine — a
    compile-key STATIC joining ``fabric._cache_key`` the way
    ``TelemetrySpec`` does: ``None`` / ``LinkConfig.off()`` normalize
    out of the key, so reliability-off runs compile the exact
    pre-feature program (golden-locked bitwise).

    ``llr`` arms per-queue go-back-N replay confined to the hop: a
    PHY-corrupted head-of-line frame holds its queue for ``llr_rtt``
    ticks (the link-NACK turnaround plus the go-back-N replay of the
    in-flight window, ~1 us on a real link) and is then retransmitted —
    delivery is DELAYED by replay, never dropped, and nothing downstream
    or end-to-end sees the loss. Replay occupancy is implicitly bounded
    by ``llr_rtt`` frames (the hop serves one frame per tick), the
    traced analogue of :class:`LLRLink`'s ``replay_capacity``.

    ``cbfc`` arms the per-queue credit gate at enqueue: 20-bit cyclic
    consumed/freed counters (:class:`CBFCState` semantics) with a
    ``credit_return_ticks`` update latency. Credit exhaustion
    back-pressures the sender — the upstream hop holds its head frame
    and injectors stall — instead of overflowing the buffer, so a
    CBFC-on fabric never trims for lack of credited space.
    """

    llr: bool = False
    llr_rtt: int = 8                # link NACK turnaround + replay, ticks
    cbfc: bool = False
    credit_return_ticks: int = 4    # credit-update message latency, ticks

    def __post_init__(self):
        if self.llr_rtt < 1:
            raise ValueError(f"llr_rtt must be >= 1, got {self.llr_rtt}")
        if self.credit_return_ticks < 1:
            raise ValueError("credit_return_ticks must be >= 1, got "
                             f"{self.credit_return_ticks}")

    @property
    def enabled(self) -> bool:
        return self.llr or self.cbfc

    @classmethod
    def off(cls) -> "LinkConfig":
        return cls()

    @classmethod
    def on(cls, llr: bool = True, cbfc: bool = False, **kw) -> "LinkConfig":
        return cls(llr=llr, cbfc=cbfc, **kw)


def fabric_buffer_pricing(num_queues: int, link_gbps: float = 400.0,
                          cable_m: float = 100.0, mtu: int = 4096) -> dict:
    """Price the lossless-fabric buffer bill both ways for a topology:
    PFC's per-(port, priority) RTT+MTU headroom vs the buffer CBFC
    actually advertises (Sec. 3.5.2 claim (1)). One fabric queue is one
    link direction in the simulator, so `num_queues` is the port count
    the bill scales with."""
    pfc = pfc_headroom_bytes(link_gbps, cable_m, mtu)
    cbfc = cbfc_buffer_bytes(link_gbps, cable_m, mtu)
    return {
        "num_queues": num_queues,
        "link_gbps": link_gbps,
        "cable_m": cable_m,
        "mtu": mtu,
        "pfc_headroom_bytes_per_port": pfc,
        "cbfc_buffer_bytes_per_port": cbfc,
        "pfc_total_bytes": pfc * num_queues,
        "cbfc_total_bytes": cbfc * num_queues,
        "cbfc_over_pfc": cbfc / pfc,
    }


LINK_STATE_LANES = frozenset({
    "llr_busy_until", "llr_replays", "cbfc_consumed", "cbfc_freed",
    "cbfc_ret", "credit_stall_ticks"})
"""SimState lanes owned by the link layer — the only fields whose
SHAPES differ between a ``link=``-armed executable and the pre-feature
program. Bitwise on-vs-off comparisons (canary, bench, tests) skip
exactly this set."""


def state_bitwise_equal(a, b, skip=LINK_STATE_LANES) -> "str | None":
    """Field-by-field bitwise compare of two SimStates, skipping `skip`.
    Returns the first drifted field name, or None when bitwise equal."""
    import torch
    from dataclasses import fields, is_dataclass

    def leaves(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif is_dataclass(x):
            for f in fields(x):
                yield from leaves(getattr(x, f.name))

    for f in fields(a):
        if f.name in skip:
            continue
        pairs = zip(leaves(getattr(a, f.name)), leaves(getattr(b, f.name)))
        if not all(x.shape == y.shape and torch.equal(x, y)
                   for x, y in pairs):
            return f.name
    return None


def _smoke(device=None) -> int:
    """Link-layer canary: corruption confinement on the engine (an
    LLR-armed BER-y fabric delivers every flow with ZERO end-to-end
    drops, while the LLR-off twin leaks the corruption into end-to-end
    recovery) and the CBFC-beats-PFC buffer claim. Runs the shared
    ``workloads.corruption_sweep`` grid at two BER points — lane 0
    (BER=0) is the bitwise-inertness anchor. Runs on ``device``
    (``cuda`` unless given)."""
    # import through the canonical module path: under ``python -m
    # repro_torch.core.link`` this file is also loaded as __main__, and
    # fabric's isinstance check needs the real LinkConfig class
    from repro_torch.core import link as linkmod
    from repro_torch.network import workloads
    from repro_torch.network.fabric import simulate_batch

    g, wls, scheds, exp = workloads.corruption_sweep(bers=(0.0, 0.03))
    prof, p, link = exp["profile"], exp["params"], exp["link"]
    on = simulate_batch(g, wls, prof, p, faults=scheds, link=link,
                        device=device)
    off = simulate_batch(g, wls, prof, p, faults=scheds, device=device)

    r_llr, r_e2e = on[1], off[1]
    ct_llr, ct_e2e = r_llr.completion_tick(), r_e2e.completion_tick()
    assert int(r_llr.drops) == 0, \
        f"LLR must confine corruption to the hop, saw {int(r_llr.drops)} drops"
    assert r_llr.llr_replays > 0, "the BER lane must actually corrupt"
    assert ct_llr > 0, "every flow must complete under LLR"
    assert int(r_e2e.drops) > 0, "LLR-off must leak corruption end-to-end"
    e2e_str = str(ct_e2e) if ct_e2e > 0 else f"DNF@{p.ticks}"
    ct_e2e_eff = ct_e2e if ct_e2e > 0 else p.ticks
    assert ct_llr < ct_e2e_eff, (ct_llr, ct_e2e)
    print(f"link canary: LLR confined {r_llr.llr_replays} corrupted "
          f"frames (0 e2e drops), completion {ct_llr} vs e2e-only {e2e_str} "
          f"({int(r_e2e.drops)} silent drops, {int(r_e2e.timeouts)} RTOs)")

    # the clean-link inertness half of the contract: BER=0 + LLR armed
    # must be bitwise the plain run
    drift = linkmod.state_bitwise_equal(on[0].state, off[0].state)
    assert drift is None, f"clean-link LLR run drifted: {drift}"
    print("link canary: clean-link LLR-on run is bitwise the LLR-off run")

    # Sec. 3.5.2 claim (1): CBFC is lossless on the buffer it advertises;
    # PFC needs RTT+MTU headroom per (port, priority) on top
    pricing = linkmod.fabric_buffer_pricing(g.num_queues)
    assert pricing["cbfc_total_bytes"] < pricing["pfc_total_bytes"] / 2, \
        pricing
    print(f"link canary: {g.name} lossless buffer bill "
          f"CBFC {pricing['cbfc_total_bytes'] / 1e6:.2f} MB vs "
          f"PFC {pricing['pfc_total_bytes'] / 1e6:.2f} MB "
          f"({pricing['cbfc_over_pfc']:.2f}x per port)")
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="the link-layer canary")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    from repro_torch.core import link as _canonical
    raise SystemExit(_canonical._smoke(ap.parse_args().device))
