"""In-network collectives (INC): switch-resident reduction contexts — the
port of ``repro.core.inc``.

When k member flows of one reduction group converge on a parent host,
the parent's top-of-rack switch aggregates their payloads and forwards
ONE packet per PSN instead of k. The modeling contract is the
reference's (DESIGN.md has the full discussion):

* A reduction **group** is a set of flows sharing one destination host
  and one message size, marked by ``Workload.red`` (-1 = none). Only
  cross-leaf members traverse the parent ToR, so only they aggregate.
* Per (group, PSN) the context keeps an **accumulator slot**: the PSN it
  aggregates and a child-arrival bitmap over the group's cross-leaf
  members. All but the LAST expected child are **absorbed** (ACKed at
  the switch, never forwarded); the child that completes the bitmap is
  **emitted** as the aggregate under its own flow identity.
* Slots are a ring indexed by ``psn % slots``; a higher PSN resets a
  slot. Any packet the context cannot safely account (stale PSN,
  duplicate child bit, slot owned by a newer PSN) passes through.

Here every lane carries a leading [B] scenario axis, and ``process``
does without the reference's three dense [Q, Q] comparisons: each is an
exact order-free form (a scatter-min of the lane index per flow, one
stable sort on the slot key with a scatter-max of the PSN per run and a
running count within each run). ``member_ranks`` is a stable sort of the
group ids in place of the dense [F, F] pass. The bitmaps are uint32
lanes stored as int32 bit patterns (``repro_torch._u32``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .device import resolve_device
from .u32 import bit
from .pds import _popcount32

#: child-arrival bitmaps are one uint32 word: at most 32 cross-leaf
#: members per reduction group (larger groups pass through un-aggregated)
MAX_FANIN = 32

I32 = torch.int32
_INT_MIN = -(1 << 31)


@dataclass(frozen=True)
class INCState:
    """Accumulator slots of every reduction context of B scenarios.

    slot_psn:  [B, G, A] int32 — PSN the slot currently aggregates (-1 free)
    slot_bits: [B, G, A] uint32 as int32 — child-arrival bitmap (bit =
               member rank)
    """

    slot_psn: torch.Tensor
    slot_bits: torch.Tensor

    @staticmethod
    def create(groups: int, slots: int, batch: "int | tuple" = (),
               device=None) -> "INCState":
        """Free slots for ``groups`` contexts of ``slots`` slots each,
        behind the lane shape ``batch`` (an int B or a shape tuple)."""
        dev = resolve_device(device)
        shape = ((batch,) if isinstance(batch, int) else tuple(batch)) \
            + (groups, slots)
        return INCState(
            slot_psn=torch.full(shape, -1, dtype=I32, device=dev),
            slot_bits=torch.zeros(shape, dtype=I32, device=dev))

    @staticmethod
    def empty(batch: "int | tuple" = (), device=None) -> "INCState":
        """Zero-size placeholder carried when the profile has INC off."""
        return INCState.create(0, 1, batch, device)


def _run_starts(key: torch.Tensor):
    """Stable sort of ``key`` [B, n] along the lanes: (lane order of the
    sorted keys, each sorted position's run start — the first sorted
    position holding the same key)."""
    sk, order = torch.sort(key, dim=-1, stable=True)
    return order, torch.searchsorted(sk, sk)


def member_ranks(red: torch.Tensor, cross_leaf: torch.Tensor,
                 allowed: "torch.Tensor | None" = None):
    """Per-flow INC membership, member rank, and effective fan-in.

    red:        [B, F] int32 reduction-group ids (-1 = none)
    cross_leaf: [B, F] bool — src and dst on different leaves
    allowed:    optional [F] or [B, F] bool extra gate (e.g. RUD-only)

    Returns (member [B, F] bool, rank [B, F] int32 — the number of
    members of the same group at lower flow indices, gsz [B, F] int32 —
    the group's member count; rank and gsz are 0 off the members). A
    stable sort of the members' group ids puts each group in one run in
    flow order: the rank is the position within the run, the size the
    run's length.
    """
    member = (red >= 0) & cross_leaf
    if allowed is not None:
        member = member & allowed
    key = torch.where(member, red.to(torch.int64), -1)
    sk, order = torch.sort(key, dim=-1, stable=True)
    lo = torch.searchsorted(sk, sk)
    hi = torch.searchsorted(sk, sk, right=True)
    pos = torch.arange(key.shape[-1], device=key.device).expand_as(lo)
    rank = torch.empty_like(lo).scatter_(-1, order, pos - lo)
    gsz = torch.empty_like(lo).scatter_(-1, order, hi - lo)
    zero = torch.zeros_like(red)
    return (member, torch.where(member, rank.to(I32), zero),
            torch.where(member, gsz.to(I32), zero))


def process(st: INCState, *, lane_flow: torch.Tensor,
            lane_psn: torch.Tensor, lane_cand: torch.Tensor,
            member: torch.Tensor, rank: torch.Tensor, gsz: torch.Tensor,
            red: torch.Tensor, has_delivery: torch.Tensor):
    """One tick of switch-resident aggregation over the forwarded lanes.

    lane_flow/lane_psn/lane_cand: [B, Q] — per-queue dequeued packet
    about to enter its destination host downlink (lane_flow a valid flow
    id; lane_cand False = not an INC candidate this tick).
    member/rank/gsz/red: [B, F] from :func:`member_ranks`.
    has_delivery: [B, F] — the flow already produced a delivery ACK this
    tick (absorption is deferred then: at most one ACK per flow per
    tick).

    Returns (state', absorb [B, Q] bool, emit [B, Q] bool). The
    reference's gathers clamp their group index and its scatters drop an
    out-of-range one; both are written out here.
    """
    B, Q = lane_flow.shape
    F = red.shape[-1]
    G, A = st.slot_psn.shape[-2:]
    dev = lane_flow.device
    lf = lane_flow.long()
    # groups wider than the bitmap word can never complete their child
    # bitmap: the WHOLE group passes through un-aggregated
    m = (lane_cand & member.gather(-1, lf)
         & (gsz.gather(-1, lf) <= MAX_FANIN))
    g = torch.where(m, red.gather(-1, lf), 0)
    slot = torch.where(lane_psn >= 0, lane_psn, 0) % A
    row0 = torch.arange(B, device=dev)[:, None] * (G * A)
    cell = (row0 + g.clamp(0, max(G - 1, 0)) * A + slot).long()
    cur_psn = st.slot_psn.reshape(-1).gather(0, cell.reshape(-1)).view(B, Q)
    cur_bits = st.slot_bits.reshape(-1).gather(0, cell.reshape(-1)).view(B, Q)
    # a higher PSN resets (recycles) the slot; a lower one is stale
    fresh = lane_psn > cur_psn
    eff_bits = torch.where(fresh, 0, cur_bits)
    b = bit(rank.gather(-1, lf).clamp(0, MAX_FANIN - 1))
    already = (eff_bits & b) != 0       # retransmit of an accounted child
    usable = (m & (lane_psn >= cur_psn) & ~already
              & ~has_delivery.gather(-1, lf))
    # one absorption per flow per tick: the first usable lane of each
    # flow (a scatter-min of the lane index into the scenario's flow
    # rows, a discard row past them)
    lane = torch.arange(Q, device=dev).expand(B, Q)
    frow = torch.where(usable, torch.arange(B, device=dev)[:, None] * F + lf,
                       B * F)
    first = torch.full((B * F + 1,), Q, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, frow.reshape(-1), lane.reshape(-1), "amin")
    ok = usable & (first.gather(0, frow.reshape(-1)).view(B, Q) == lane)
    # lanes on one (group, slot): sorted into one run each, in lane
    # order. Two PSNs on one slot: the higher owns it (the run's
    # scatter-max), the lower lanes pass through. Among the survivors
    # the arrival order decides: the lane that completes the bitmap
    # emits, earlier ones absorb.
    key = torch.where(ok, g * A + slot, -1)
    order, start = _run_starts(key)
    psn_s = lane_psn.gather(-1, order)
    run_max = torch.full((B, Q), _INT_MIN, dtype=I32, device=dev)
    run_max.scatter_reduce_(-1, start, psn_s, "amax")
    ok_s = ok.gather(-1, order) & (psn_s >= run_max.gather(-1, start))
    before = ok_s.to(I32).cumsum(-1, dtype=I32) - ok_s.to(I32)
    r_s = before - before.gather(-1, start)
    ok = torch.zeros_like(ok).scatter_(-1, order, ok_s)
    r_tick = torch.zeros_like(lane_psn).scatter_(-1, order, r_s)
    total = _popcount32(eff_bits) + r_tick + 1
    full = total >= gsz.gather(-1, lf)
    emit = ok & full
    absorb = ok & ~full
    # state scatters into flat cells, a discard cell past every
    # scenario's (an out-of-range group drops, as the reference's do)
    hit = ok & (g < G)
    dst = torch.where(hit, row0 + g * A + slot, B * G * A).long().reshape(-1)
    zi = torch.where(hit & fresh, row0 + g * A + slot,
                     B * G * A).long().reshape(-1)
    bits = torch.cat([st.slot_bits.reshape(-1), b.new_zeros(1)])
    bits[zi] = 0
    bits.scatter_add_(0, dst, torch.where(ok, b, 0).reshape(-1))
    psn = torch.cat([st.slot_psn.reshape(-1), b.new_zeros(1)])
    psn.scatter_reduce_(0, dst, lane_psn.reshape(-1), "amax")
    shape = st.slot_psn.shape
    return (INCState(slot_psn=psn[:-1].view(shape),
                     slot_bits=bits[:-1].view(shape)), absorb, emit)
