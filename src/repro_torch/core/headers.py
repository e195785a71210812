"""UE packet header / overhead byte model (Sec. 3.2.2, Fig. 3).

The paper gives exact byte counts for every sublayer header. We reproduce
them as an accounting model: given a transport configuration, compute the
per-packet overhead and the wire efficiency (goodput fraction) for a given
MTU. These numbers feed the fabric simulator (packets are an MTU of payload
plus `header_bytes` of overhead) and `benchmarks/bench_headers.py`.

A copy of the reference package's ``core/headers.py`` (JAX-free there; the
port imports nothing of the reference package): every formula and its
order are kept, so its results are ``==`` to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.types import TransportMode

# -- fixed Ethernet framing --------------------------------------------------
ETHERNET_HEADER = 14      # standard Ethernet header
ETHERNET_FCS = 4          # frame check sequence
# Physical-layer per-frame cost (preamble+SFD 8B, IPG 12B). Not a "header"
# in Fig. 3 but real wire occupancy; kept separate so tests can check both.
ETHERNET_PHY_OVERHEAD = 20

# -- L3/L4 encapsulation -----------------------------------------------------
IPV4_HEADER = 20
IPV6_HEADER = 40
UDP_HEADER = 8            # UET runs over UDP (dst port 4793) ...
IP_ENTROPY_HEADER = 4     # ... or natively over IP with a 4B entropy header

# -- PDS (Sec. 3.2.2): 12B for RUD/ROD (16 with RCCC), 8B RUDI, 4B UUD -------
PDS_HEADER = {
    TransportMode.RUD: 12,
    TransportMode.ROD: 12,
    TransportMode.RUDI: 8,
    TransportMode.UUD: 4,
}
PDS_RCCC_EXTRA = 4        # RCCC credit fields grow the RUD/ROD PDS header to 16B

# -- SES (Sec. 3.2.2) ---------------------------------------------------------
SES_HEADER_STD = 44       # standard operations
SES_HEADER_MATCH_8K = 32  # matching messages up to 8 KiB
SES_HEADER_MIN = 20       # minimal, non-matching

# -- integrity / security ------------------------------------------------------
E2E_CRC = 4               # optional trailing end-to-end CRC (before FCS)
TSS_HEADER = 12           # security header before the PDS header
TSS_HEADER_EXPLICIT_SRC = 16  # with explicit source identifiers
TSS_ICV = 16              # integrity check value at the end (before FCS)


@dataclass(frozen=True)
class HeaderConfig:
    """One concrete header stack choice."""

    mode: TransportMode = TransportMode.RUD
    ipv6: bool = False
    native_ip: bool = False       # native IP mode: 4B EV header replaces UDP
    rccc: bool = False            # RCCC congestion-control PDS fields
    ses: int = SES_HEADER_STD     # which SES header variant
    e2e_crc: bool = False
    tss: bool = False
    tss_explicit_src: bool = False

    def overhead_bytes(self) -> int:
        """Total non-payload bytes per packet (excluding PHY idle/preamble)."""
        total = ETHERNET_HEADER + ETHERNET_FCS
        total += IPV6_HEADER if self.ipv6 else IPV4_HEADER
        total += IP_ENTROPY_HEADER if self.native_ip else UDP_HEADER
        pds = PDS_HEADER[self.mode]
        if self.rccc and self.mode in (TransportMode.RUD, TransportMode.ROD):
            pds += PDS_RCCC_EXTRA
        total += pds
        total += self.ses
        if self.tss:
            total += (TSS_HEADER_EXPLICIT_SRC if self.tss_explicit_src
                      else TSS_HEADER) + TSS_ICV
            # The ICV is far stronger than the PDS CRC, which can be omitted
            # when an ICV is used (Sec. 3.2.2); e2e_crc is ignored under TSS.
        elif self.e2e_crc:
            total += E2E_CRC
        return total

    def wire_bytes(self, payload: int) -> int:
        """Bytes occupying the wire for `payload` bytes of user data."""
        return payload + self.overhead_bytes() + ETHERNET_PHY_OVERHEAD

    def efficiency(self, payload: int) -> float:
        """Goodput fraction at a given per-packet payload size."""
        return payload / self.wire_bytes(payload)


def max_efficiency_table(mtu: int = 4096) -> dict[str, float]:
    """Wire efficiency for the common stacks at full-MTU payload.

    Used by bench_headers to reproduce the Fig. 3 overhead discussion.
    """
    stacks = {
        "rud_udp_ipv4_std": HeaderConfig(),
        "rud_udp_ipv4_match": HeaderConfig(ses=SES_HEADER_MATCH_8K),
        "rud_native_ip_min": HeaderConfig(native_ip=True, ses=SES_HEADER_MIN),
        "rud_rccc_udp_ipv4": HeaderConfig(rccc=True),
        "rud_tss_udp_ipv6": HeaderConfig(ipv6=True, tss=True),
        "uud_udp_ipv4_min": HeaderConfig(mode=TransportMode.UUD, ses=SES_HEADER_MIN),
        "rudi_udp_ipv4_min": HeaderConfig(mode=TransportMode.RUDI, ses=SES_HEADER_MIN),
    }
    return {name: cfg.efficiency(mtu) for name, cfg in stacks.items()}
