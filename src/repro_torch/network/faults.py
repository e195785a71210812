"""Fault schedules — the port of ``repro.network.faults``, link lanes only.

A queue is dead while ``fail_at <= tick < heal_at``; packets routed into
a dead queue vanish silently (no trim, no NACK) and recovery is the
transport's job. The static ``failed=`` mask is the degenerate schedule
``fail_at=0, heal_at=NEVER_TICK``. Gray-link loss, PHY corruption and the
per-host lanes are not ported yet (ROADMAP.md, "Modules to port" item 6).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.types import NEVER_TICK


@dataclass(frozen=True)
class FaultSchedule:
    """Per-queue outage windows for one scenario."""

    fail_at: torch.Tensor   # [Q] int32 first dead tick (NEVER = healthy)
    heal_at: torch.Tensor   # [Q] int32 first live-again tick (NEVER = forever)

    @staticmethod
    def healthy(num_queues: int, device="cpu") -> "FaultSchedule":
        never = torch.full((num_queues,), NEVER_TICK, dtype=torch.int32,
                           device=device)
        return FaultSchedule(fail_at=never, heal_at=never.clone())

    @staticmethod
    def from_mask(mask, device="cpu") -> "FaultSchedule":
        """Queues set in the [Q] bool ``mask`` are dead from tick 0
        forever — the reference's ``failed=`` semantics."""
        mask = torch.as_tensor(np.asarray(mask, bool), device=device)
        return FaultSchedule(
            fail_at=torch.where(mask, 0, NEVER_TICK).to(torch.int32),
            heal_at=torch.full(mask.shape, NEVER_TICK, dtype=torch.int32,
                               device=device))

    @property
    def num_queues(self) -> int:
        return int(self.fail_at.shape[-1])

    def to(self, device) -> "FaultSchedule":
        return FaultSchedule(self.fail_at.to(device), self.heal_at.to(device))
