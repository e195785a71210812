"""Fault schedules — the port of ``repro.network.faults``, link lanes only.

A queue is dead while ``fail_at <= tick < heal_at``; packets routed into
a dead queue vanish silently (no trim, no NACK) and recovery is the
transport's job. The static ``failed=`` mask is the degenerate schedule
``fail_at=0, heal_at=NEVER_TICK``. A schedule is [Q] lanes for one
scenario or [B, Q] lanes for a batch (``stack``, ``healthy(batch=)``,
``from_mask`` of a [B, Q] mask). Gray-link loss, PHY corruption and the
per-host lanes are not ported yet (ROADMAP.md, "Modules to port" item
6): ``lossy`` and ``corrupt`` raise.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.types import NEVER_TICK


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, 'Modules to "
        f"port' item 6: faults + recovery)")


@dataclass(frozen=True)
class FaultSchedule:
    """Per-queue outage windows of one scenario ([Q]) or of a scenario
    batch ([B, Q])."""

    fail_at: torch.Tensor   # [.., Q] int32 first dead tick (NEVER = healthy)
    heal_at: torch.Tensor   # [.., Q] int32 first live-again tick (NEVER = forever)

    @staticmethod
    def healthy(num_queues: int, batch: "int | None" = None,
                device="cpu") -> "FaultSchedule":
        """All-healthy lanes ([Q], or [batch, Q] when batch is given)."""
        shape = (num_queues,) if batch is None else (batch, num_queues)
        never = torch.full(shape, NEVER_TICK, dtype=torch.int32,
                           device=device)
        return FaultSchedule(fail_at=never, heal_at=never.clone())

    @staticmethod
    def from_mask(mask, device="cpu") -> "FaultSchedule":
        """Queues set in the bool ``mask`` ([Q] or [B, Q]) are dead from
        tick 0 forever — the reference's ``failed=`` semantics."""
        mask = torch.as_tensor(np.array(mask, bool), device=device)
        return FaultSchedule(
            fail_at=torch.where(mask, 0, NEVER_TICK).to(torch.int32),
            heal_at=torch.full(mask.shape, NEVER_TICK, dtype=torch.int32,
                               device=device))

    def flap(self, queues, fail_at: int,
             heal_at: int = NEVER_TICK) -> "FaultSchedule":
        """Give ``queues`` the outage window [fail_at, heal_at) (in every
        scenario of a batch). One window per queue: a later flap
        overwrites an earlier one."""
        hot = np.zeros((self.num_queues,), bool)
        hot[np.atleast_1d(np.asarray(queues, np.int64))] = True
        hot = torch.as_tensor(hot, device=self.fail_at.device)
        return replace(
            self,
            fail_at=torch.where(hot, int(fail_at), self.fail_at).to(
                torch.int32),
            heal_at=torch.where(hot, int(heal_at), self.heal_at).to(
                torch.int32))

    def lossy(self, queues, p: float) -> "FaultSchedule":
        raise _not_ported("gray-link loss (FaultSchedule.lossy)")

    def corrupt(self, queues, p: float) -> "FaultSchedule":
        raise _not_ported("PHY corruption (FaultSchedule.corrupt)")

    @staticmethod
    def stack(scheds: "list[FaultSchedule]") -> "FaultSchedule":
        """Stack per-scenario [Q] schedules into a [B, Q] batch."""
        return FaultSchedule(
            fail_at=torch.stack([s.fail_at for s in scheds]),
            heal_at=torch.stack([s.heal_at for s in scheds]))

    @property
    def num_queues(self) -> int:
        return int(self.fail_at.shape[-1])

    def dead_at(self, tick: int) -> torch.Tensor:
        """[.., Q] bool — queues dead at ``tick``."""
        return (self.fail_at <= tick) & (tick < self.heal_at)

    def to(self, device) -> "FaultSchedule":
        return FaultSchedule(self.fail_at.to(device), self.heal_at.to(device))

    def lanes(self, idx) -> "FaultSchedule":
        """The scenarios ``idx`` (an index array) of a [B, Q] batch."""
        return FaultSchedule(self.fail_at[idx], self.heal_at[idx])


def failed_to_mask(num_queues: int, failed) -> np.ndarray:
    """[Q] bool mask from None / a queue-id iterable / a bool mask."""
    if failed is None:
        return np.zeros((num_queues,), bool)
    arr = np.asarray(failed)
    if arr.dtype == bool:
        if arr.shape != (num_queues,):
            raise ValueError(f"failed mask must be [Q={num_queues}], "
                             f"got {arr.shape}")
        return arr
    if arr.size and (arr.min() < 0 or arr.max() >= num_queues):
        raise ValueError(f"failed queue ids must be in [0, {num_queues}); "
                         f"pass a bool array to give a mask instead")
    mask = np.zeros((num_queues,), bool)
    mask[arr.astype(np.int64)] = True
    return mask


def as_schedule(num_queues: int, failed, faults, batch: int,
                device="cpu") -> FaultSchedule:
    """One [batch, Q] schedule from the public (failed=, faults=) pair.
    ``faults``: a [Q] schedule (broadcast to every scenario) or a
    [batch, Q] one. ``failed``: a [batch, Q] mask (any 2-D array, 0/1
    ints included), one [Q] mask, or queue ids (broadcast). At most one
    of the two; neither means all healthy."""
    if faults is not None:
        if failed is not None:
            raise ValueError("pass either failed= (static mask) or "
                             "faults= (FaultSchedule), not both")
        if not isinstance(faults, FaultSchedule):
            raise TypeError(f"faults= must be a FaultSchedule, got "
                            f"{type(faults).__name__}")
        if faults.num_queues != num_queues:
            raise ValueError(
                f"fault schedule is over {faults.num_queues} queues but "
                f"the topology has {num_queues}")
        if faults.fail_at.dim() == 1:
            return FaultSchedule(
                *(a.expand(batch, num_queues).contiguous()
                  for a in (faults.fail_at, faults.heal_at))).to(device)
        if faults.fail_at.shape[0] != batch:
            raise ValueError(f"fault schedule batch axis is "
                             f"{faults.fail_at.shape[0]}, expected {batch}")
        return faults.to(device)
    if failed is None:
        dead = np.zeros((batch, num_queues), bool)
    else:
        arr = np.asarray(failed)
        if arr.ndim == 2:
            dead = arr.astype(bool)
        else:
            dead = np.broadcast_to(failed_to_mask(num_queues, failed),
                                   (batch, num_queues))
    if dead.shape != (batch, num_queues):
        raise ValueError(f"failed mask must be [B={batch}, Q={num_queues}], "
                         f"got {dead.shape}")
    return FaultSchedule.from_mask(dead, device)
