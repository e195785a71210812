"""Entropy-Value load balancing schemes (Sec. 2.1, 3.3.5) — the port of
``repro.core.lb.schemes``.

This slice ports STATIC, OBLIVIOUS and REPS selection and the REPS
recycle feedback. RR_SLOTS, EVBITMAP and EV eviction raise
``NotImplementedError`` (ROADMAP.md, "Modules to port" item 4).
All uint32 lanes are int32 bit patterns (see ``repro_torch._u32``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, replace

import torch

from repro_torch._u32 import c32, shr, umod
from repro_torch.core.types import EV_SPACE

_NOT_PORTED = ("LB scheme {} is not ported yet (ROADMAP.md, 'Modules to "
               "port' item 4: the tick's named profiles)")


class LBScheme(enum.IntEnum):
    STATIC = 0
    OBLIVIOUS = 1
    RR_SLOTS = 2
    REPS = 3
    EVBITMAP = 4


PORTED_SCHEMES = (LBScheme.STATIC, LBScheme.OBLIVIOUS, LBScheme.REPS)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """xxhash-style avalanche finalizer (uint32 -> uint32)."""
    x = x ^ shr(x, 16)
    x = x * c32(0x7FEB352D)
    x = x ^ shr(x, 15)
    x = x * c32(0x846CA68B)
    return x ^ shr(x, 16)


@dataclass(frozen=True)
class LBState:
    """Unified LB state; schemes use the fields they need. SoA over F flows
    (field meanings as in the reference ``LBState``)."""

    rr_ptr: torch.Tensor      # [F] int32
    reps_ring: torch.Tensor   # [F, K] int32 recycled EVs (-1 = empty)
    reps_head: torch.Tensor   # [F] int32
    reps_size: torch.Tensor   # [F] int32
    ev_set: torch.Tensor      # [F, K] int32 candidate EV per slot
    cong_bits: torch.Tensor   # [F, K] bool
    salt: torch.Tensor        # [F] uint32 per-flow PRNG salt
    bad_ev: torch.Tensor      # [F, K] int32 eviction blacklist (-1 = empty)
    bad_n: torch.Tensor       # [F] int32
    last_ev: torch.Tensor     # [F] int32

    @staticmethod
    def create(f: int, k: int, seed: int,
               device: torch.device) -> "LBState":
        seed = c32(int(seed))
        i32 = dict(dtype=torch.int32, device=device)
        flows = torch.arange(f, **i32)
        # per-flow, per-slot initial EVs: well-mixed distinct values
        slot_ev = umod(_mix32(flows[:, None] * 977
                              + torch.arange(k, **i32)[None, :] + seed),
                       EV_SPACE)
        return LBState(
            rr_ptr=torch.zeros((f,), **i32),
            reps_ring=torch.full((f, k), -1, **i32),
            reps_head=torch.zeros((f,), **i32),
            reps_size=torch.zeros((f,), **i32),
            ev_set=slot_ev,
            cong_bits=torch.zeros((f, k), dtype=torch.bool, device=device),
            salt=_mix32(flows + c32(seed * 2654435761)),
            bad_ev=torch.full((f, k), -1, **i32),
            bad_n=torch.zeros((f,), **i32),
            last_ev=torch.full((f,), -1, **i32),
        )


def select_ev(state: LBState, scheme: LBScheme, psn: torch.Tensor,
              tick: int) -> "tuple[LBState, torch.Tensor]":
    """Choose the EV for the next packet of every flow.

    psn: [F] uint32 — the PSN about to be stamped. Returns (state',
    ev [F] int32); the caller keeps the new state lanes only where a
    packet was actually injected.
    """
    K = state.ev_set.shape[1]
    if scheme == LBScheme.STATIC:
        return state, state.ev_set[:, 0]
    if scheme == LBScheme.OBLIVIOUS:
        t8 = c32((int(tick) << 8) & 0xFFFFFFFF)
        ev = umod(_mix32(state.salt ^ _mix32(psn + t8)), EV_SPACE)
        return state, ev
    if scheme == LBScheme.REPS:
        has = state.reps_size > 0
        pos = state.reps_head % K
        recycled = state.reps_ring.gather(1, pos[:, None].long())[:, 0]
        fresh = umod(_mix32(state.salt ^ _mix32(psn * c32(2246822519))),
                     EV_SPACE)
        # an evicted (tombstoned, -1) ring entry is consumed but replaced
        # by a fresh draw
        ev = torch.where(has & (recycled >= 0), recycled, fresh)
        return replace(
            state,
            reps_head=torch.where(has, (state.reps_head + 1) % K,
                                  state.reps_head),
            reps_size=torch.where(has, state.reps_size - 1, state.reps_size),
        ), ev
    raise NotImplementedError(_NOT_PORTED.format(LBScheme(scheme).name))


def _pick_lane(hot: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Per-row value from <= 1 active lane: hot [R, L] bool, vals [L]."""
    return torch.where(hot, vals[None, :], 0).sum(dim=1, dtype=vals.dtype)


def reps_recycle(state: LBState, ev: torch.Tensor,
                 valid: torch.Tensor) -> LBState:
    """Per-flow REPS recycle: push one clean-ACK EV per flow (ev, valid:
    [F]); pure elementwise + one-hot work."""
    K = state.ev_set.shape[1]
    push = valid & (state.reps_size < K)
    pos = (state.reps_head + state.reps_size) % K
    hot = ((torch.arange(K, device=ev.device)[None, :] == pos[:, None])
           & push[:, None])
    return replace(
        state,
        reps_ring=torch.where(hot, ev[:, None], state.reps_ring),
        reps_size=state.reps_size + push.to(torch.int32),
    )


@dataclass(frozen=True)
class LBPolicy:
    """One LB scheme as the fabric engine's pluggable policy: ``on_ack``
    (path feedback) and ``select`` (per-flow EV choice)."""

    scheme: LBScheme
    evict_enabled: bool = False

    def __post_init__(self):
        if self.scheme not in PORTED_SCHEMES:
            raise NotImplementedError(_NOT_PORTED.format(self.scheme.name))
        if self.evict_enabled:
            raise NotImplementedError(
                "EV eviction is not ported yet (ROADMAP.md, 'Modules to "
                "port' item 6: faults + recovery)")

    def on_ack(self, st: LBState, hot_ack, ef, ee, ec, is_ack, is_nack,
               flow_ok=None) -> LBState:
        """Feedback from this tick's control events (hot_ack: [F, E]
        one-hot ACK lanes; ef/ee/ec: [E] lane flow/EV/ECN)."""
        if self.scheme == LBScheme.REPS:
            # recycle EVs that came back on clean (un-marked) ACKs
            hot_clean = hot_ack & (ec[None, :] == 0)
            if flow_ok is not None:
                hot_clean = hot_clean & flow_ok[:, None]
            return reps_recycle(st, _pick_lane(hot_clean, ee),
                                hot_clean.any(dim=1))
        return st  # STATIC / OBLIVIOUS take no path feedback

    def select(self, st: LBState, psn: torch.Tensor,
               tick: int) -> "tuple[LBState, torch.Tensor]":
        return select_ev(st, self.scheme, psn, tick)
