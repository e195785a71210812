"""The one predicate of ``repro_torch.core.pdc`` that the tick reads."""
from __future__ import annotations

import torch


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
