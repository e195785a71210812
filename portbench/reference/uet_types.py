"""Core UET types, enums and constants — a copy of the reference
package's ``core/types.py`` (JAX-free there; the port imports nothing of
the reference package), and the two shape rules of the port's scenario
axis (``lane_shape``, ``scenario_rows``).

Mirrors the vocabulary of the UE 1.0 spec overview paper:
  - profiles (HPC / AI Full / AI Base), Sec. 2.2
  - PDS transport modes (RUD / ROD / UUD / RUDI), Sec. 3.2.1
  - packet types (request / ack / control), Sec. 3.2
  - drop causes ("the three Cs"), Sec. 3.2.4

Everything that ends up in a simulator lane is an int32 code; the enums
here are the single source of truth for those codes.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field

import torch


class Profile(enum.IntEnum):
    """UE profiles (Sec. 2.2). HPC ⊃ AI_BASE; HPC + deferrable send ⊃ AI_FULL."""

    HPC = 0
    AI_FULL = 1
    AI_BASE = 2


class TransportMode(enum.IntEnum):
    """PDS packet ordering / reliability modes (Sec. 3.2.1)."""

    RUD = 0   # Reliable Unordered Delivery — default bulk mode, enables spraying
    ROD = 1   # Reliable Ordered Delivery — go-back-N, single path per flowlet
    UUD = 2   # Unreliable Unordered Delivery — datagrams
    RUDI = 3  # Reliable Unordered for Idempotent ops — no receiver dedup state


class PacketType(enum.IntEnum):
    """PDS packet types (Sec. 3.2)."""

    REQUEST = 0  # carries data (initiator->target for write/send; reverse for read)
    ACK = 1      # acknowledges request packets; rides the control TC
    CONTROL = 2  # transport control (probe path, close PDC, NACK, credit grant)


class DropCause(enum.IntEnum):
    """The "three Cs" of packet drops (Sec. 3.2.4)."""

    NONE = 0
    CONGESTION = 1     # switch buffer full
    CORRUPTION = 2     # checksum/FEC failure
    CONFIGURATION = 3  # firewall / TTL expiry
    TRIMMED = 4        # payload trimmed by switch, header delivered (Sec. 3.2.4)


class SemOp(enum.IntEnum):
    """SES operation kinds (Sec. 3.1)."""

    SEND = 0            # (optionally tagged) send
    TAGGED_SEND = 1
    RMA_WRITE = 2
    RMA_READ = 3        # single-packet reads (Sec. 3.1.4)
    ATOMIC = 4
    RENDEZVOUS_READ = 5  # the read step of the rendezvous protocol
    DEFER_RESUME = 6     # restart-token control messages of deferrable send


class MsgProtocol(enum.IntEnum):
    """Large-unexpected-message protocols (Sec. 3.1.3 / Fig. 5)."""

    RENDEZVOUS = 0          # HPC
    DEFERRABLE_SEND = 1     # AI Full
    RECEIVER_INITIATED = 2  # AI Base


class AddrMode(enum.IntEnum):
    """SES addressing modes (Sec. 3.1.1), selected by the `rel` header bit."""

    RELATIVE = 0   # parallel jobs: JobID -> PIDonFEP table -> RI table
    ABSOLUTE = 1   # client/server: PIDonFEP acts like a UDP port


class PDCState(enum.IntEnum):
    """PDC state machine states (Fig. 6). Used by initiator and target pools."""

    CLOSED = 0
    SYN = 1        # initiator sent first packet(s) with SYN, no PDCID echo yet
    ESTABLISHED = 2
    QUIESCE = 3    # draining: finishes started messages, refuses new ones
    ACK_WAIT = 4   # all drained, waiting for outstanding replies
    PENDING = 5    # target-side secure-PSN pending state (Sec. 3.4.2)


# ---------------------------------------------------------------------------
# Wire / fabric constants
# ---------------------------------------------------------------------------

#: UDP destination port assigned to UET by IANA ("beautiful large prime",
#: and == RoCEv2's 4791 + 2).
UET_UDP_PORT = 4793

#: Default MTU payload for full packets. UE prohibits fragmentation and sends
#: all but the last packet of a message with a full MTU payload (Sec. 3.2).
DEFAULT_MTU = 4096

#: Entropy Value space: the EV replaces the 16-bit UDP source port (Sec. 2.1).
EV_BITS = 16
EV_SPACE = 1 << EV_BITS

#: Sentinel tick meaning "never" in fault-schedule lanes (int32 max, so
#: `tick < NEVER_TICK` is always true for any reachable simulator tick).
#: A statically-failed queue is `fail_at=0, heal_at=NEVER_TICK`; a healthy
#: one is `fail_at=NEVER_TICK` (see repro_torch.network.faults).
NEVER_TICK = 2 ** 31 - 1

#: SACK bitmap width carried in ACK packets (Sec. 3.2.5).
SACK_BITMAP_BITS = 64

#: Default Maximum PSN Range — receiver packet-tracking resource bound
#: (Sec. 3.2.5). Powers of two keep the bitmap ring arithmetic cheap.
DEFAULT_MP_RANGE = 1024

#: TSS key lifetime bounds, in packets (Sec. 3.4.1).
TSS_KEY_LIFETIME_MIN = 2 ** 27
TSS_KEY_LIFETIME_MAX = int(2 ** 34.5)

#: Encrypted PDCs must close + reopen after this many packets so PSNs never
#: wrap under one key (Sec. 3.4.2).
TSS_PDC_MAX_PACKETS = 2_000_000_000


@dataclass(frozen=True)
class FabricParams:
    """Physical parameters of the modeled backend fabric.

    Defaults model the paper's design point: 400+ Gbps links, 10-150 m
    reach, MTU-sized packets. One simulator tick == the serialization time
    of one MTU payload on one link, so bandwidth shares are exact and all
    latencies are expressed in packet-times.
    """

    link_gbps: float = 400.0
    mtu_bytes: int = DEFAULT_MTU
    #: one-way propagation+pipeline latency per hop, in ticks
    hop_latency_ticks: int = 1
    #: switch egress queue capacity, in packets (per output port)
    queue_capacity: int = 64
    #: ECN marking threshold (egress queue occupancy, packets). Egress
    #: marking per the spec (differs from RFC 3168 ingress marking).
    ecn_threshold: int = 16
    #: when True, switches trim instead of dropping on overflow (Sec. 3.2.4)
    trimming: bool = True
    #: number of return-path ticks for ACKs on the control TC (uncongested
    #: second traffic class, Sec. 3.1.4)
    ack_return_ticks: int = 3

    @property
    def tick_seconds(self) -> float:
        return self.mtu_bytes * 8 / (self.link_gbps * 1e9)


@dataclass(frozen=True)
class UETConfig:
    """Top-level transport configuration used by the simulator."""

    profile: Profile = Profile.AI_FULL
    mode: TransportMode = TransportMode.RUD
    mtu: int = DEFAULT_MTU
    mp_range: int = DEFAULT_MP_RANGE
    #: congestion control switches (either/both; Sec. 3.3)
    nscc: bool = True
    rccc: bool = False
    #: load balancing scheme name: "oblivious" | "reps" | "evbitmap" | "static"
    lb: str = "oblivious"
    #: security on/off (adds TSS header + ICV overhead and secure-PSN rules)
    tss: bool = False
    fabric: FabricParams = field(default_factory=FabricParams)


def lane_shape(n: "int | tuple[int, ...]") -> "tuple[int, ...]":
    """The shape of a per-flow lane: ``n`` flows ([n]), or a shape with
    leading scenario axes ((B, F): one scenario per row)."""
    return (int(n),) if isinstance(n, int) else tuple(int(d) for d in n)


def scenario_rows(lanes: torch.Tensor, rows: int) -> torch.Tensor:
    """[..., 1] first flat row of each lane's scenario, for [..., L]
    lanes scattered into [..., R] state flattened to one row axis: with
    lanes [B, L], b*R (0 for unbatched [L] lanes)."""
    lead = tuple(lanes.shape[:-1])
    return (torch.arange(math.prod(lead), dtype=torch.int32,
                         device=lanes.device).view(lead + (1,)) * rows)
