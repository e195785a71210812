"""Transport Security Sublayer — protocol logic and overhead model
(Sec. 3.4) — the port of ``repro.core.tss``.

TSS at the level of its *protocol rules*, not the cipher: AES-GCM itself
is out of scope (DESIGN.md records this adaptation), but everything the
spec actually innovates on is here:

* secure domains (SD) with a shared symmetric key and derived per-source
  keys (KDF modes: direct SDK / per-source / client-server);
* nonce discipline: the IV is (TSC epoch:16 | packet counter:48) XOR an
  IV mask, with per-member packet counters and the source id folded into
  the derived key;
* key-lifetime enforcement: between 2^27 and 2^34.5 packets per key
  (Sec. 3.4.1) with association-number (AN) rotation;
* anti-replay PSN establishment (Sec. 3.4.2): the zero-RTT
  start_psn/expected_psn scheme with the close-time expected_psn
  ratchet; PDCs must close after 2^31 packets;
* trimmed packets must not trigger PDC creation (zero-trust rule for
  unauthenticated switch-modified packets).

State is SoA over domain members. Every uint32 lane (keys, IV words,
counters, PSNs) is an int32 bit pattern: the logical shifts, the
unsigned compare of ``accept_new_pdc`` and the unsigned scatter-max of
``on_pdc_close`` go through ``repro_torch._u32``.

``iv_for_packet`` reads every lane's counter before it adds, as the
reference does, so a member that appears twice in one batch gets the
same IV twice under the same key (ROADMAP.md queue 3: a property of the
reference, reproduced bitwise).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch import resolve_device
from repro_torch._u32 import c32, lane, shr, ult
from repro_torch.core import scatter
from repro_torch.core.types import (TSS_KEY_LIFETIME_MAX,
                                    TSS_KEY_LIFETIME_MIN,
                                    TSS_PDC_MAX_PACKETS)

TSC_EPOCH_BITS = 16
TSC_COUNTER_BITS = 48


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ shr(x, 16)) * 0x45D9F3B
    x = (x ^ shr(x, 16)) * 0x45D9F3B
    return x ^ shr(x, 16)


def kdf(domain_key: torch.Tensor, *args) -> torch.Tensor:
    """Deterministic, non-invertible key derivation (stand-in for HKDF):
    domain key + arguments -> derived key (uint32 lanes)."""
    out = _mix(lane(domain_key))
    for a in args:
        out = _mix(out ^ _mix(lane(a, out.device)))
    return out


@dataclass(frozen=True)
class SecureDomain:
    """One SD: shared key, IV mask, epoch, per-member packet counters.

    members are indexed 0..N-1; `an` is the association number (key
    generation) — receivers keep both AN keys during rotation.
    """

    sdk: torch.Tensor          # [] uint32 domain key (model of the 256b key)
    iv_mask: torch.Tensor      # [] uint32
    epoch: torch.Tensor        # [] int32 TSC epoch (SDME-managed)
    an: torch.Tensor           # [] int32 association number
    pkt_counter: torch.Tensor  # [N] uint32 packets stamped per member
    key_packets: torch.Tensor  # [N] int32 packets under the current key

    @staticmethod
    def create(n_members: int, seed: int = 0xD0,
               device=None) -> "SecureDomain":
        dev = resolve_device(device)
        return SecureDomain(
            sdk=lane(seed * 2654435761 & 0xFFFFFFFF, dev),
            iv_mask=_mix(lane(seed + 1, dev)),
            epoch=torch.zeros((), dtype=torch.int32, device=dev),
            an=torch.zeros((), dtype=torch.int32, device=dev),
            pkt_counter=torch.zeros((n_members,), dtype=torch.int32,
                                    device=dev),
            key_packets=torch.zeros((n_members,), dtype=torch.int32,
                                    device=dev),
        )


def source_key(sd: SecureDomain, member) -> torch.Tensor:
    """Per-source derived key (the 'distributed communication' KDF mode)."""
    return kdf(sd.sdk, member, sd.an)


def iv_for_packet(sd: SecureDomain, member):
    """Assign the next nonce for `member` (batch ok): returns
    (sd', iv_hi, iv_lo). IV = (epoch | counter) ^ mask. Every lane reads
    the counter as it was before the batch; a member's counter then
    advances by its number of lanes."""
    ctr = scatter.gather(sd.pkt_counter, member)
    iv_lo = ctr ^ sd.iv_mask
    iv_hi = _mix(sd.epoch) ^ shr(sd.iv_mask, 16)
    new_ctr = scatter.add_at(sd.pkt_counter, member, 1)
    new_kp = scatter.add_at(sd.key_packets, member, 1)
    return replace(sd, pkt_counter=new_ctr, key_packets=new_kp), iv_hi, iv_lo


def needs_key_rotation(sd: SecureDomain,
                       single_user: bool = True) -> torch.Tensor:
    """[N] bool — key lifetime exceeded (Sec. 3.4.1: 2^27..2^34.5 pkts)."""
    limit = TSS_KEY_LIFETIME_MIN if not single_user else min(
        TSS_KEY_LIFETIME_MAX, 2 ** 31 - 1)
    return sd.key_packets >= limit


def rotate_key(sd: SecureDomain) -> SecureDomain:
    """SDME key rotation: bump AN, refresh SDK, zero per-key counters."""
    return replace(
        sd, an=sd.an + 1, sdk=_mix(sd.sdk ^ c32(0xA5A5A5A5)),
        key_packets=torch.zeros_like(sd.key_packets))


def pdc_must_close(tx_packets: torch.Tensor) -> torch.Tensor:
    """Encrypted PDCs close+reopen before PSN wrap (2e9 pkts, Sec 3.4.2)."""
    return lane(tx_packets) >= min(TSS_PDC_MAX_PACKETS, 2 ** 31 - 1)


# ---------------------------------------------------------------------------
# anti-replay PSN establishment (Sec. 3.4.2, zero-RTT scheme)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PSNGuard:
    """Per-(SD, peer) start_psn / expected_psn ratchet state."""

    start_psn: torch.Tensor     # [N] uint32 — source side: next PDC's PSN
    expected_psn: torch.Tensor  # [N] uint32 — target side: min accepted PSN

    @staticmethod
    def create(n: int, device=None) -> "PSNGuard":
        z = torch.zeros((n,), dtype=torch.int32,
                        device=resolve_device(device))
        return PSNGuard(start_psn=z, expected_psn=z.clone())


def accept_new_pdc(g: PSNGuard, peer, psn):
    """Target check on a connection request: accept iff psn >=
    expected_psn (unsigned); otherwise NACK carrying the PSN the source
    must use.

    Returns (accept [B] bool, nack_psn [B]).
    """
    exp = scatter.gather(g.expected_psn, peer)
    ok = ~ult(lane(psn, exp.device), exp)
    return ok, exp


def on_pdc_close(g: PSNGuard, peer, last_psn) -> PSNGuard:
    """Close ratchet: expected_psn := last_psn + 1 (target), echoed to the
    source which sets start_psn likewise => future opens are zero-RTT and
    replayed packets from the closed PDC can never re-establish. The
    ratchet takes the unsigned max, so a wrapped ``last_psn + 1`` (0)
    never lowers it."""
    nxt = lane(last_psn, g.start_psn.device) + 1
    return PSNGuard(
        start_psn=scatter.umax_at(g.start_psn, peer, nxt),
        expected_psn=scatter.umax_at(g.expected_psn, peer, nxt),
    )


def trimmed_packet_may_create_pdc() -> bool:
    """Zero-trust rule: trimmed packets are unauthenticated (switches are
    untrusted) and MUST NOT trigger PDC creation."""
    return False
