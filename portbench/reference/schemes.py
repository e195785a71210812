"""Entropy-Value load balancing schemes (Sec. 2.1, 3.3.5) — the port of
``repro.core.lb.schemes``.

Every scheme is ported: STATIC, OBLIVIOUS, RR_SLOTS, REPS (with its
recycle feedback) and EVBITMAP (with its congestion-bit feedback), and
the recovery loop's EV eviction (the blacklist ring, the steering of
draws off it, ``LBPolicy.evict``). All uint32 lanes are int32 bit
patterns (see ``repro_torch._u32``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, fields, replace

import torch

from .u32 import c32, shr, umod
from . import scatter
from .uet_types import EV_SPACE, scenario_rows


class LBScheme(enum.IntEnum):
    STATIC = 0
    OBLIVIOUS = 1
    RR_SLOTS = 2
    REPS = 3
    EVBITMAP = 4


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
    def create(f: int, k: int, seed: "int | torch.Tensor",
               device: torch.device) -> "LBState":
        """The initial state of F flows. ``seed`` is one seed (a Python
        int: [F] lanes) or a [B] lane of uint32 seeds as int32 patterns
        ([B, F] lanes, one scenario per seed); the int32 multiply and add
        wrap as the reference's traced uint32 arithmetic does."""
        i32 = dict(dtype=torch.int32, device=device)
        if isinstance(seed, torch.Tensor):
            seed = seed.to(**i32)
        else:
            seed = torch.tensor(c32(int(seed)), **i32)
        lead = tuple(seed.shape)
        flows = torch.arange(f, **i32)
        # per-flow, per-slot initial EVs: well-mixed distinct values
        slot_ev = umod(_mix32(flows[:, None] * 977
                              + torch.arange(k, **i32)[None, :]
                              + seed[..., None, None]), EV_SPACE)
        return LBState(
            rr_ptr=torch.zeros(lead + (f,), **i32),
            reps_ring=torch.full(lead + (f, k), -1, **i32),
            reps_head=torch.zeros(lead + (f,), **i32),
            reps_size=torch.zeros(lead + (f,), **i32),
            ev_set=slot_ev,
            cong_bits=torch.zeros(lead + (f, k), dtype=torch.bool,
                                  device=device),
            salt=_mix32(flows + seed[..., None] * c32(2654435761)),
            bad_ev=torch.full(lead + (f, k), -1, **i32),
            bad_n=torch.zeros(lead + (f,), **i32),
            last_ev=torch.full(lead + (f,), -1, **i32),
        )


def select_ev(state: LBState, scheme: LBScheme, psn: torch.Tensor,
              tick: int) -> "tuple[LBState, torch.Tensor]":
    """Choose the EV for the next packet of every flow.

    psn: [..., F] uint32 — the PSN about to be stamped (any leading
    scenario axes, as the state's). Returns (state', ev [..., F] int32);
    the caller keeps the new state lanes only where a packet was
    actually injected.
    """
    K = state.ev_set.shape[-1]
    if scheme == LBScheme.STATIC:
        return state, state.ev_set[..., 0]
    if scheme == LBScheme.OBLIVIOUS:
        t8 = c32((int(tick) << 8) & 0xFFFFFFFF)
        ev = umod(_mix32(state.salt ^ _mix32(psn + t8)), EV_SPACE)
        return state, ev
    if scheme == LBScheme.RR_SLOTS:
        # slot i carries PSNs i, i+K, i+2K... (psn as int32, floor mod)
        slot = psn % K
        return state, _row_pick(state.ev_set, slot)
    if scheme == LBScheme.REPS:
        has = state.reps_size > 0
        pos = state.reps_head % K
        recycled = _row_pick(state.reps_ring, pos)
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
    if scheme != LBScheme.EVBITMAP:
        raise ValueError(f"unknown LB scheme: {scheme!r}")
    # EVBITMAP: advance the pointer, skipping (and clearing) a congested
    # slot — one skip per selection (the spec's skip-then-unset rounds)
    ptr = state.rr_ptr % K
    congested = _row_pick(state.cong_bits, ptr)
    use = torch.where(congested, (ptr + 1) % K, ptr)
    ev = _row_pick(state.ev_set, use)
    # clear the skipped bit so the slot is retried next round
    skipped = ((torch.arange(K, device=ptr.device) == ptr[..., None])
               & congested[..., None])
    return replace(state, rr_ptr=(use + 1) % K,
                   cong_bits=state.cong_bits & ~skipped), ev


def _row_pick(table: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """table[..., i, col[..., i]]: one column per row of a [..., F, K]
    table (col in [0, K))."""
    return table.gather(-1, col[..., None].long())[..., 0]


def _pick_lane(hot: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Per-row value from <= 1 active lane: hot [..., R, L] bool, vals
    [..., L]."""
    return torch.where(hot, vals[..., None, :], 0).sum(dim=-1,
                                                       dtype=vals.dtype)


def reps_recycle(state: LBState, ev: torch.Tensor,
                 valid: torch.Tensor) -> LBState:
    """Per-flow REPS recycle: push one clean-ACK EV per flow (ev, valid:
    [..., F]); pure elementwise + one-hot work."""
    K = state.ev_set.shape[-1]
    push = valid & (state.reps_size < K)
    pos = (state.reps_head + state.reps_size) % K
    hot = ((torch.arange(K, device=ev.device) == pos[..., None])
           & push[..., None])
    return replace(
        state,
        reps_ring=torch.where(hot, ev[..., None], state.reps_ring),
        reps_size=state.reps_size + push.to(torch.int32),
    )


def commit_selection(old: LBState, new: LBState,
                     injected: torch.Tensor) -> LBState:
    """Keep ``new`` lanes only where a packet was actually injected: a
    per-flow select over every field, the [..., F] mask broadcast over
    each field's trailing axes."""
    def pick(a, b):
        mask = injected.reshape(injected.shape
                                + (1,) * (a.dim() - injected.dim()))
        return torch.where(mask, b, a)

    return LBState(*(pick(getattr(old, f.name), getattr(new, f.name))
                     for f in fields(LBState)))


def _rows(flow: torch.Tensor, n: int) -> torch.Tensor:
    """Row indices under JAX's rules: a negative index counts from the
    end (the caller clamps a gather or drops a scatter beyond that)."""
    return torch.where(flow < 0, flow + n, flow)


def on_ack(state: LBState, scheme: LBScheme, flow: torch.Tensor,
           ev: torch.Tensor, congested: torch.Tensor,
           valid: torch.Tensor) -> LBState:
    """Feed ACK/NACK path feedback back into the scheme, lane-wise.

    flow, ev: [..., L] int32 lanes of the scenario(s) whose state is
    [..., F]; congested: [..., L] bool (ECN-CE marked ACK or trim NACK);
    valid: [..., L] lane mask. EVBITMAP marks the slot whose EV saw
    congestion: an OR over lanes that may repeat a flow, written as an
    integer count per (flow, slot) (``index_add_``, exact and
    order-free) then ``> 0`` — torch has no boolean scatter-max. The
    rows are flat: scenario b's flow f is row b*F + f, and a lane that
    marks nothing goes to a discard row past every scenario's, so no
    lane reaches another scenario's rows. REPS feedback on this
    lane-wise path is not ported (its ring write is a
    duplicate-order-dependent scatter); the fabric tick uses the dense
    :func:`reps_recycle`. Other schemes take no feedback.
    """
    F, K = state.ev_set.shape[-2:]
    if scheme == LBScheme.EVBITMAP:
        n = state.ev_set[..., 0].numel()          # B*F rows
        base = scenario_rows(flow, F)
        safe = _rows(torch.where(valid, flow, 0), F).clamp(0, F - 1)
        hit = ((state.ev_set.reshape(n, K)[(base + safe).long()]
                == ev[..., None])
               & congested[..., None] & valid[..., None])
        r = _rows(flow, F)
        rows = torch.where(valid & (r >= 0) & (r < F), base + r, n).long()
        plane = torch.zeros((n + 1, K), dtype=torch.int32,
                            device=flow.device)
        plane.index_add_(0, rows.reshape(-1),
                         hit.to(torch.int32).reshape(-1, K))
        marks = plane[:n].view(state.cong_bits.shape) > 0
        return replace(state, cong_bits=state.cong_bits | marks)
    if scheme == LBScheme.REPS:
        # recycle EVs that came back clean; congested EVs leave circulation
        n = state.reps_size.numel()               # B*F rows
        base = scenario_rows(flow, F)
        ok = valid & ~congested
        size = state.reps_size.reshape(n)
        pos = ((state.reps_head + state.reps_size) % K).reshape(n)
        # reads take the reference's rule (negatives once from the end,
        # then clamped), writes keep only rows in [0, F)
        rd = base + scatter.read_index(torch.where(ok, flow, 0), F)
        r, in_range = scatter.write_index(flow, F)
        keep = ok & (size[rd] < K) & in_range     # the ring has room
        rows = torch.where(keep, base + r, n)     # n: dropped
        # lanes of one flow read the same pos: the last lane's EV wins
        ring = scatter.set_last(state.reps_ring.reshape(n * K),
                                torch.where(keep, rows * K + pos[rd], n * K),
                                ev)
        return replace(
            state, reps_ring=ring.view(state.reps_ring.shape),
            reps_size=scatter.add_at(size, rows, 1).view(
                state.reps_size.shape))
    return state


def _in_blacklist(st: LBState, ev: torch.Tensor) -> torch.Tensor:
    """[..., F] bool — is each flow's ``ev`` currently on its blacklist?"""
    return ((st.bad_ev == ev[..., None]) & (st.bad_ev >= 0)).any(dim=-1)


@dataclass(frozen=True)
class LBPolicy:
    """One LB scheme as the fabric engine's pluggable policy: ``on_ack``
    (path feedback), ``select`` (per-flow EV choice) and, when the
    profile enables the recovery loop, ``evict`` (blacklist an EV that a
    timeout or trim NACK implicates, purge it from the scheme's state
    and steer later draws off it)."""

    scheme: LBScheme
    evict_enabled: bool = False

    def on_ack(self, st: LBState, hot_ack, ef, ee, ec, is_ack, is_nack,
               flow_ok=None) -> LBState:
        """Feedback from this tick's control events (hot_ack: [..., F, E]
        one-hot ACK lanes; ef/ee/ec: [..., E] lane flow/EV/ECN; flow_ok:
        [F], the same for every scenario)."""
        if self.scheme == LBScheme.REPS:
            # recycle EVs that came back on clean (un-marked) ACKs
            hot_clean = hot_ack & (ec[..., None, :] == 0)
            if flow_ok is not None:
                hot_clean = hot_clean & flow_ok[:, None]
            return reps_recycle(st, _pick_lane(hot_clean, ee),
                                hot_clean.any(dim=-1))
        if self.scheme == LBScheme.EVBITMAP:
            valid = is_ack | is_nack
            if flow_ok is not None:
                f = flow_ok.shape[0]
                at = _rows(torch.where(valid, ef, 0), f).clamp(0, f - 1)
                valid = valid & flow_ok[at.long()]
            return on_ack(st, self.scheme, ef, ee, (ec != 0) | is_nack,
                          valid)
        return st  # STATIC / OBLIVIOUS / RR_SLOTS take no path feedback

    def select(self, st: LBState, psn: torch.Tensor,
               tick: int) -> "tuple[LBState, torch.Tensor]":
        st2, ev = select_ev(st, self.scheme, psn, tick)
        if self.evict_enabled:
            # steer draws off the blacklist: a blacklisted EV is re-mixed
            # once (a colliding re-mix behaves like the plain draw)
            bad = _in_blacklist(st, ev)
            alt = umod(_mix32(ev * c32(0x9E3779B1) ^ st.salt), EV_SPACE)
            ev = torch.where(bad, alt, ev)
        return st2, ev

    def static_ev(self, st: LBState) -> torch.Tensor:
        """The flow's pinned single-path EV (ROD lanes)."""
        return st.ev_set[..., 0]

    def evict(self, st: LBState, ev: torch.Tensor,
              valid: torch.Tensor) -> LBState:
        """Blacklist ``ev`` for flows with ``valid`` set (ev, valid:
        [..., F]) and purge it: the blacklist ring takes it at
        ``bad_n % K``; ``ev_set`` slots that carry it are re-rolled to
        draws salted by the eviction count (re-mixed once if they land
        on the updated blacklist); REPS recycle-ring entries that carry
        it become -1 tombstones, which ``select_ev`` replaces by a fresh
        draw when it pops one."""
        K = st.ev_set.shape[-1]
        slots = torch.arange(K, dtype=torch.int32, device=ev.device)
        pos = st.bad_n % K
        hot = (slots == pos[..., None]) & valid[..., None]
        bad_ev = torch.where(hot, ev[..., None], st.bad_ev)
        bad_n = st.bad_n + valid.to(torch.int32)
        slot_match = (st.ev_set == ev[..., None]) & valid[..., None]
        # (bad_n * K + k) as uint32, times the constant: int32 wraps alike
        fresh = umod(_mix32(st.salt[..., None]
                            ^ _mix32((bad_n[..., None] * K + slots)
                                     * c32(0x85EBCA77))), EV_SPACE)
        fresh_bad = ((bad_ev[..., :, None] == fresh[..., None, :])
                     & (bad_ev[..., :, None] >= 0)).any(dim=-2)
        fresh = torch.where(
            fresh_bad,
            umod(_mix32(fresh * c32(0x9E3779B1) ^ st.salt[..., None]),
                 EV_SPACE),
            fresh)
        ev_set = torch.where(slot_match, fresh, st.ev_set)
        ring_match = (st.reps_ring == ev[..., None]) & valid[..., None]
        reps_ring = torch.where(ring_match, -1, st.reps_ring)
        return replace(st, bad_ev=bad_ev, bad_n=bad_n, ev_set=ev_set,
                       reps_ring=reps_ring)
