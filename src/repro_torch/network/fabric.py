"""Vectorized packet-level fabric simulator — the port of
``repro.network.fabric``.

One simulator tick == the serialization time of one MTU packet on one
link; every link is a FIFO queue that dequeues at most one packet per
tick. All protocol state — PSN bitmaps, congestion windows, EV state —
is structure-of-arrays over flows and queues, held in frozen dataclasses
of tensors on one device. ``make_step`` builds the tick (the same ten
numbered sections as the reference, so the two read side by side) and
``simulate`` drives it in ``chunk_ticks``-tick chunks from a Python loop,
syncing with the host once per chunk to test quiescence.

Three kernels run every tick through ``repro_torch.kernels.ops``:
``sack_fused`` (section 1, source ACKs), ``nack_mark`` (section 1, NACKed
PSNs into the retransmit ring) and ``sack_advance`` (section 5, receiver
CACK). On CUDA tensors they are hand-written CUDA; on CPU tensors their
plain PyTorch versions.

Every profile of the paper's table runs: each CC composition (NSCC,
RCCC, their hybrid, open loop), every LB scheme (STATIC, OBLIVIOUS,
RR_SLOTS with its EV-based loss inference, REPS, EVBITMAP) and per-flow
RUD / ROD / RUDI delivery (ROD is go-back-N on one static path), with
link outages. The fault-engine statics (gray loss, host faults,
corruption, RTO backoff, EV eviction, PDC teardown), INC, the link layer
and telemetry raise ``NotImplementedError`` naming their ROADMAP.md item.
uint32 lanes are int32 bit patterns (``_u32``); JAX's clamped gathers
and dropped scatters are written out as clamps and masks.

The dense one-hots of the reference stay ([F, E] ACK/NACK lanes, [H, F]
host pick, [F, Q] deliveries, [n, n] enqueue ranks, [Q, n] enqueue
counts), so parity is easy to reason about; they are quadratic and cap
the fabric size (ROADMAP.md, "Scale cap").
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch._u32 import bit, c32, shr
from repro_torch.core import pds
from repro_torch.core.cms.nscc import NSCCParams
from repro_torch.core.lb.schemes import LBPolicy, LBScheme, LBState, _mix32
from repro_torch.core.lb.schemes import _pick_lane as _pick
from repro_torch.kernels import ops as kops
from repro_torch.network.ecmp import DELIVERED, RoutingTables
from repro_torch.network.faults import FaultSchedule
from repro_torch.network.profile import (DeliveryMode, TransportProfile,
                                         make_cc_policy)
from repro_torch.network.topology import QueueGraph

# packet meta bits
META_TRIMMED = 1
META_ECN = 2

# event types
EV_NONE, EV_ACK, EV_NACK, EV_OOO = 0, 1, 2, 3

# packed packet-field lanes of SimState.q_pkt
PKT_FLOW, PKT_PSN, PKT_EV, PKT_META, PKT_TSENT, PKT_FIELDS = 0, 1, 2, 3, 4, 5
# packed control-event lanes of SimState.ev_buf
EVF_TYPE, EVF_FLOW, EVF_PSN, EVF_VAL, EVF_ECN, EVF_TSENT, EVF_FIELDS = \
    0, 1, 2, 3, 4, 5, 6

DEFAULT_SEED = 0x5EED
TRACE_MODES = ("stats", "full")

I32 = torch.int32


@dataclass(frozen=True)
class SimParams:
    """Numeric simulation knobs (fields and defaults as in the reference)."""

    ticks: int = 2000
    chunk_ticks: int = 128
    queue_capacity: int = 64
    ecn_threshold: int = 12
    trimming: bool = True
    ack_return_ticks: int = 4
    mp_range: int = 512           # receiver tracking window (PSNs)
    ev_slots: int = 16            # K for RR/REPS/EVBITMAP
    timeout_ticks: int = 256
    ooo_threshold: int = 0        # 0 = disabled
    max_cwnd: float = 48.0        # ~BDP in packets (optimistic start)
    base_rtt: float = 10.0        # unloaded RTT in ticks, for NSCC
    inc_slots: int = 64           # INC accumulator slots per reduction group


@dataclass(frozen=True)
class Workload:
    """Flow set: src/dst host ids, message size (packets), start tick, the
    dependency lane (flow f waits until flow dep[f] source-completes;
    -1 = none) and the INC reduction-group lane (-1 = none; read only by
    INC profiles, which are not ported yet). All [F] int32."""

    src: torch.Tensor
    dst: torch.Tensor
    size: torch.Tensor
    start: torch.Tensor
    dep: torch.Tensor
    red: torch.Tensor

    @staticmethod
    def of(src, dst, size, start=None, dep=None, red=None,
           device="cpu") -> "Workload":
        def lane(v, fill):
            a = np.full((f,), fill, np.int64) if v is None else v
            return torch.as_tensor(np.broadcast_to(np.asarray(a), (f,))
                                   .astype(np.int32)).to(device)

        f = int(np.asarray(src).shape[0])
        return Workload(src=lane(src, 0), dst=lane(dst, 0),
                        size=lane(size, 0), start=lane(start, 0),
                        dep=lane(dep, -1), red=lane(red, -1))

    def to(self, device) -> "Workload":
        return Workload(*(getattr(self, f.name).to(device)
                          for f in fields(self)))


@dataclass(frozen=True)
class SimState:
    """The whole fabric + protocol state of one scenario.

    Mirrors the reference ``SimState`` lane for lane, minus the lanes of
    features this slice does not port (INC contexts, the link-layer LLR /
    CBFC lanes, PDC quarantine, and the counters only those features
    move); ``repro_torch.convert`` checks they are inert when carrying a
    reference state across.
    """

    q_pkt: torch.Tensor      # [Q, C, PKT_FIELDS] int32 (flow = -1 => empty)
    q_head: torch.Tensor     # [Q] int32
    q_len: torch.Tensor      # [Q] int32
    next_psn: torch.Tensor   # [F] int32
    inflight: torch.Tensor   # [F] int32
    src_track: pds.PSNTracker  # ACK tracking at the source (base = CACK)
    rtx: torch.Tensor        # [F, W] uint32 retransmit bitmap (rel. to base)
    last_progress: torch.Tensor  # [F] int32
    slot_last_ack: torch.Tensor  # [F, K] int32
    dst_track: pds.PSNTracker
    last_ooo_nack: torch.Tensor  # [F] int32
    cc: object               # CC policy state: NSCCState, RCCCState, the
                             # hybrid's {"nscc", "rccc"} dict, or the open
                             # loop's empty [0] int32 tensor
    lb: LBState
    ev_buf: torch.Tensor     # [D, E, EVF_FIELDS] int32 control-TC delay ring
    delivered: torch.Tensor  # [F] int32 packets delivered (first copies)
    trims: torch.Tensor      # [] int32
    drops: torch.Tensor      # [] int32
    dups: torch.Tensor       # [] int32
    rod_rejects: torch.Tensor  # [] int32 out-of-order arrivals ROD discarded
    retransmits: torch.Tensor  # [] int32
    rto: torch.Tensor        # [F] int32 per-flow retransmission timeout
    timeouts: torch.Tensor   # [] int32
    ticks_degraded: torch.Tensor  # [] int32


def _first_set_bit(ring: torch.Tensor) -> torch.Tensor:
    """Per-row index of the lowest set bit of a [N, W] uint32 ring, or -1."""
    nz = ring != 0
    has = nz.any(dim=1)
    first_w = torch.argmax(nz.to(I32), dim=1)   # first max, as jnp.argmax
    w = ring.gather(1, first_w[:, None])[:, 0]
    ctz = pds._popcount32((w & (0 - w)) - 1)
    return torch.where(has, first_w * 32 + ctz, -1).to(I32)


def _bit_plane(off: torch.Tensor, valid: torch.Tensor, w: int) -> torch.Tensor:
    """[F, W] uint32 plane with row i's bit `off[i]` set (elementwise —
    the dense replacement for a one-lane-per-row bit scatter)."""
    o = off.clamp(0, w * 32 - 1)
    wordsel = (torch.arange(w, device=off.device)[None, :]
               == torch.div(o, 32, rounding_mode="floor")[:, None])
    ok = valid & (off >= 0) & (off < w * 32)
    return torch.where(ok[:, None] & wordsel, bit(o % 32)[:, None], 0)


def _set_own_bit(ring, off, valid):
    """Row i sets bit off[i] — elementwise, no scatter."""
    return ring | _bit_plane(off, valid, ring.shape[1])


def _clear_own_bit(ring, off, valid):
    """Row i clears bit off[i] — elementwise, no scatter."""
    return ring & ~_bit_plane(off, valid, ring.shape[1])


def _own_word(ring: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Row i's ring word containing bit offset off[i] (clipped)."""
    w = ring.shape[1]
    word = torch.div(off.clamp(0, w * 32 - 1), 32, rounding_mode="floor")
    return ring.gather(1, word[:, None].long())[:, 0]


def _rank_within(target, valid, base, lower=None):
    """Each candidate lane's arrival rank within its target queue, and its
    queue position ``base[target] + rank``: rank[i] = #{j < i : valid[j]
    and target[j] == target[i]} as a masked pairwise count. ``lower`` is
    the strictly-lower-triangular [n, n] mask (built once per step)."""
    n = target.shape[0]
    if lower is None:
        lane = torch.arange(n, device=target.device)
        lower = lane[None, :] < lane[:, None]
    t = torch.where(valid, target, -1)
    same = (t[None, :] == t[:, None]) & valid[None, :] & lower
    rank = same.sum(dim=1, dtype=I32)
    pos = base[torch.where(valid, target, 0).long()] + rank
    return pos, rank


def _where_rows(cond: torch.Tensor, new, old):
    """Field-wise select of two same-typed state dataclasses: keep `new`
    rows where `cond` [F] is set."""
    def sel(a, b):
        return torch.where(cond.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    return type(new)(*(sel(getattr(new, f.name), getattr(old, f.name))
                       for f in fields(new)))


def _cc_params(p: SimParams) -> NSCCParams:
    return NSCCParams(base_rtt=p.base_rtt, max_cwnd=p.max_cwnd)


def init_state(g: QueueGraph, wl: Workload, profile: TransportProfile,
               p: SimParams, seed: int = DEFAULT_SEED,
               device=None) -> SimState:
    dev = resolve_device(device)
    Q, C = g.num_queues, p.queue_capacity
    F = int(wl.src.shape[0])
    D = p.ack_return_ticks + 1
    E = 2 * Q + 2 * F
    W = p.mp_range // 32
    cc_pol = make_cc_policy(profile.cc, _cc_params(p), p.max_cwnd)
    i32 = dict(dtype=I32, device=dev)
    q_pkt = torch.zeros((Q, C, PKT_FIELDS), **i32)
    q_pkt[:, :, PKT_FLOW] = -1
    zero = torch.zeros((), **i32)
    return SimState(
        q_pkt=q_pkt,
        q_head=torch.zeros((Q,), **i32), q_len=torch.zeros((Q,), **i32),
        next_psn=torch.zeros((F,), **i32), inflight=torch.zeros((F,), **i32),
        src_track=pds.PSNTracker.create(F, p.mp_range, dev),
        rtx=torch.zeros((F, W), **i32),
        last_progress=torch.zeros((F,), **i32),
        slot_last_ack=torch.full((F, p.ev_slots), -1, **i32),
        dst_track=pds.PSNTracker.create(F, p.mp_range, dev),
        last_ooo_nack=torch.full((F,), -10 ** 6, **i32),
        cc=cc_pol.create(F, dev),
        lb=LBState.create(F, p.ev_slots, seed, dev),
        ev_buf=torch.zeros((D, E, EVF_FIELDS), **i32),
        delivered=torch.zeros((F,), **i32),
        trims=zero, drops=zero.clone(), dups=zero.clone(),
        rod_rejects=zero.clone(), retransmits=zero.clone(),
        rto=torch.full((F,), p.timeout_ticks, **i32),
        timeouts=zero.clone(), ticks_degraded=zero.clone(),
    )


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, 'Modules to "
        f"port' item {item})")


def _check_statics(profile: TransportProfile, lossy, tel, hosty, corrupty,
                   link) -> None:
    """Raise for every static this slice does not port."""
    if lossy:
        raise _not_ported("gray-link loss (lossy)", "6: faults + recovery")
    if hosty:
        raise _not_ported("host / NIC faults (hosty)", "6: faults + recovery")
    if corrupty:
        raise _not_ported("PHY corruption (corrupty)", "6: faults + recovery")
    if tel is not None:
        raise _not_ported("telemetry", "9: telemetry")
    if link is not None:
        raise _not_ported("the link layer (LLR / CBFC)", "8: link layer")
    if profile.inc:
        raise _not_ported("in-network reduction (inc)", "7: INC + "
                          "collectives")
    if profile.rto_backoff != 1.0:
        raise _not_ported("RTO backoff", "6: faults + recovery")
    if profile.ev_eviction:
        raise _not_ported("EV eviction", "6: faults + recovery")
    if profile.pdc_dead_after > 0:
        raise _not_ported("PDC liveness teardown", "6: faults + recovery")


def make_step(g: QueueGraph, profile: TransportProfile, p: SimParams, F: int,
              lossy: bool = False, tel=None, hosty: bool = False,
              corrupty: bool = False, link=None, device=None):
    """Build the per-tick transition ``step(s, tick, wl, fault) -> (s',
    out)`` for one transport profile on one device.

    ``tick`` is a Python int; the step never syncs with the host. The
    statics mirror the reference's ``make_step``: any CC composition, LB
    scheme and per-flow delivery modes (ROD flows run go-back-N on one
    static path, gate injection on in-order CACK advance, and their
    receiver accepts only the next expected PSN; an all-ROD profile pins
    LB to STATIC). ``lossy``/``hosty``/``corrupty``, ``tel``, ``link``,
    INC, RTO backoff, eviction and PDC teardown are not ported and raise
    ``NotImplementedError``.
    """
    dev = resolve_device(device)
    _check_statics(profile, lossy, tel, hosty, corrupty, link)
    rt = RoutingTables(g, dev)
    Q = g.num_queues
    C = p.queue_capacity
    D = p.ack_return_ticks + 1
    H = g.num_hosts
    mp = p.mp_range
    W = mp // 32
    K = p.ev_slots
    i32 = dict(dtype=I32, device=dev)
    flow_ids = torch.arange(F, **i32)
    qidx = torch.arange(Q, **i32)
    hosts = torch.arange(H, **i32)
    zeros_f = torch.zeros((F,), **i32)
    zeros_qf = torch.zeros((Q + F,), **i32)
    n_cand = Q + F
    lane = torch.arange(n_cand, device=dev)
    lower = lane[None, :] < lane[:, None]        # [n, n] for _rank_within
    cc_pol = make_cc_policy(profile.cc, _cc_params(p), p.max_cwnd)
    # per-flow delivery modes are static: compiled into the step
    rod_np = profile.delivery_modes(F) == int(DeliveryMode.ROD)
    all_rod = bool(rod_np.all())
    any_rod = bool(rod_np.any())
    mixed_rod = any_rod and not all_rod
    rod_mask = torch.as_tensor(rod_np, device=dev)
    # an all-ROD profile is single-path (ordered delivery forbids
    # spraying); mixed profiles spray the RUD lanes and pin the ROD lanes
    # to their static EV
    lb_pol = LBPolicy(LBScheme.STATIC if all_rod else profile.lb,
                      evict_enabled=profile.ev_eviction)
    rr_slots = profile.lb == LBScheme.RR_SLOTS and not all_rod
    kslots = torch.arange(K, device=dev)
    ooo_gap = int(p.base_rtt)

    def step(s: SimState, tick: int, wl: Workload, fault: FaultSchedule):
        flow_src = wl.src
        flow_dst = wl.dst
        slot = tick % D
        dead = (fault.fail_at <= tick) & (tick < fault.heal_at)

        # ------------------------------------------------ 1. control events
        evs = s.ev_buf[slot]                                  # [E, 6]
        et, ef, ep, ee, ec, ets = (evs[:, k].contiguous()
                                   for k in range(EVF_FIELDS))
        is_ack = et == EV_ACK
        is_nack = (et == EV_NACK) | (et == EV_OOO)
        # at most one ACK lane per flow per tick: one [F, E] one-hot
        # densifies every ACK-driven update to [F] / [F, W] work
        hot_ack = (ef[None, :] == flow_ids[:, None]) & is_ack[None, :]
        hot_nack = (ef[None, :] == flow_ids[:, None]) & is_nack[None, :]
        has_ack = hot_ack.any(dim=1)
        nack_count = hot_nack.sum(dim=1, dtype=I32)
        ack_psn = _pick(hot_ack, ep)

        # ACKs: record at source, advance CACK, shift the rtx ring in
        # lockstep — the fused SACK kernel
        ack_off0 = ack_psn - s.src_track.base          # uint32 wrap
        ack_in_range = has_ack & (ack_off0 >= 0) & (ack_off0 < mp)
        ack_bit = bit(ack_off0 % 32)
        ack_already = ack_in_range & (
            (_own_word(s.src_track.ring, ack_off0) & ack_bit) != 0)
        ack_mask = _bit_plane(ack_off0, ack_in_range, W)
        src_ring, src_base, rtx, adv = kops.sack_fused(
            s.src_track.ring, s.src_track.base, s.rtx, ack_mask)
        src_track = pds.PSNTracker(
            base=src_base, ring=src_ring,
            rx_ok=s.src_track.rx_ok + (ack_in_range & ~ack_already).to(I32),
            dup=s.src_track.dup + ack_already.to(I32),
            oor=s.src_track.oor + (has_ack & ~ack_in_range).to(I32),
        )

        # retire inflight, CC + LB feedback (policy hooks over [F] lanes)
        retire = has_ack.to(I32) + nack_count
        inflight = torch.clamp(s.inflight - retire, min=0)
        ack_ecn = _pick(hot_ack, ec).to(torch.bool)
        rtt = (tick - _pick(hot_ack, ets)).to(torch.float32)
        cc_st = cc_pol.on_ack(s.cc, has_ack, ack_ecn, rtt)
        cc_st = cc_pol.on_nack(cc_st, nack_count)
        lbs = lb_pol.on_ack(s.lb, hot_ack, ef, ee, ec, is_ack, is_nack,
                            flow_ok=(~rod_mask) if mixed_rod else None)

        # progress clock: any ACK freshens the flow (the RTO lane stays
        # at its base value: backoff is not ported)
        last_progress = torch.where(has_ack, tick, s.last_progress)
        rto = s.rto

        # ACK'd PSNs can't be pending retransmit anymore (offsets are
        # relative to the new base: rtx was shifted by the fused kernel)
        ack_off = ack_psn - src_track.base
        rtx = _clear_own_bit(rtx, ack_off, has_ack)

        # NACKs (trim / OOO): mark the PSN for selective retransmit (RUD;
        # ROD rewinds instead, section 3). Lanes [Q, E) are the
        # NACK-capable ones (lanes [0, Q) carry NACKs only for ROD
        # flows); several may hit one flow or one bit, so the mark is a
        # duplicate-safe OR (the kernel). An all-ROD profile has no
        # selective-retransmit path: the reference compiles it out, and
        # the kernel is not launched.
        nf, nep = ef[Q:], ep[Q:]
        n_nack = is_nack[Q:]
        safe_nf = torch.where(n_nack, nf, 0).long()
        nack_off = nep - src_track.base[safe_nf]
        if not all_rod:
            n_ok = n_nack & (nack_off >= 0) & (nack_off < mp)
            if mixed_rod:
                n_ok = n_ok & ~rod_mask[safe_nf]
            rtx = kops.nack_mark(rtx, nf, nack_off.clamp(0, mp - 1), n_ok)
        rod_gbn = hot_nack.any(dim=1)

        # EV-based loss inference (Sec. 3.2.4), RR_SLOTS layout: slot i
        # carries PSNs i, i+K, i+2K...; an ACK for PSN x implies every
        # unacked PSN x-K, x-2K... of its slot was lost
        slot_last_ack = s.slot_last_ack
        if rr_slots:
            has_ack_rr = has_ack & ~rod_mask if mixed_rod else has_ack
            sl = ack_psn % K
            prev = slot_last_ack.gather(1, sl[:, None].long())[:, 0]
            # mark up to 2 predecessors (losses per ACK are almost
            # always <= 1)
            for back in (1, 2):
                miss = ack_psn - back * K
                off = miss - src_track.base
                # skip PSNs already SACKed at the source (not lost)
                w_i = off.clamp(0, W * 32 - 1)
                sacked = (_own_word(src_track.ring, off) & bit(w_i % 32)) != 0
                lost = has_ack_rr & (miss > prev) & (miss >= 0) & ~sacked
                rtx = _set_own_bit(rtx, off, lost)
            hot_sl = (kslots[None, :] == sl[:, None]) & has_ack_rr[:, None]
            slot_last_ack = torch.where(
                hot_sl, torch.maximum(slot_last_ack, ack_psn[:, None]),
                slot_last_ack)

        # consume the slot: clear only the EVF_TYPE lane (the slot is
        # fully rewritten when it next comes up as out_slot)
        ev_buf = s.ev_buf.clone()
        ev_buf[slot, :, EVF_TYPE] = EV_NONE

        # ------------------------------------------- 2. RCCC receiver grants
        done = src_track.base >= wl.size
        # dependency lane: eligible once flow dep[f] source-completed
        safe_dep = torch.where(wl.dep >= 0, wl.dep, 0).long()
        dep_ok = (wl.dep < 0) | done[safe_dep]
        active = ~done & (tick >= wl.start) & dep_ok
        cc_st = cc_pol.on_grant_tick(cc_st, flow_dst, active, H)

        # --------------------------------------------------- 3. injection
        has_rtx = (rtx != 0).any(dim=1)
        if all_rod:
            has_rtx = torch.zeros_like(has_rtx)
        elif mixed_rod:
            has_rtx = has_rtx & ~rod_mask
        # RTO time predicate, shared by the ROD rewind here and the RUD
        # stall in section 9 (the rewind touches last_progress only on
        # ROD lanes, which section 9 masks out)
        overdue = (tick - last_progress) > rto
        # ROD go-back-N: on a NACK or a timeout, rewind next_psn to base
        next_psn = s.next_psn
        timeout_rod = torch.zeros((F,), dtype=torch.bool, device=dev)
        if any_rod:
            timeout_rod = (inflight > 0) & overdue
            rewind = rod_gbn | timeout_rod
            if mixed_rod:
                rewind = rewind & rod_mask
                timeout_rod = timeout_rod & rod_mask
            next_psn = torch.where(rewind, src_track.base, next_psn)
            inflight = torch.where(rewind, 0, inflight)
            last_progress = torch.where(rewind, tick, last_progress)
        win_ok = cc_pol.on_send_gate(cc_st, inflight)
        if any_rod:
            # in-order CACK gate (ROD): the ordered window may not race
            # more than one congestion window past the cumulative ACK
            rod_win = torch.floor(cc_pol.cwnd_view(cc_st, F)).to(I32).clamp(
                min=1)
            rod_ok = (next_psn - src_track.base) < rod_win
            win_ok = win_ok & (rod_ok | ~rod_mask)
        mp_ok = (next_psn - src_track.base) < p.mp_range
        can_new = (next_psn < wl.size) & mp_ok
        eligible = ((tick >= wl.start) & ~done & dep_ok & win_ok
                    & (has_rtx | can_new))

        # fair per-host pick: per-tick pseudo-random rotation, flow id in
        # the low bits so exactly one winner exists per host
        rot = shr(_mix32(flow_ids * c32(2654435761) ^ c32(tick)), 16)
        key = rot * F + flow_ids
        key = torch.where(eligible, key, 2 ** 30)
        hot_host = flow_src[None, :] == hosts[:, None]           # [H, F]
        host_min = torch.where(hot_host, key[None, :], 2 ** 30).amin(dim=1)
        injected = (eligible & (key == host_min[flow_src.long()])
                    & (key < 2 ** 30))

        rtx_off = _first_set_bit(rtx)
        rtx_psn = src_track.base + rtx_off
        use_rtx = injected & has_rtx & (rtx_off >= 0)
        psn_out = torch.where(use_rtx, rtx_psn, next_psn)

        lbs2, ev_sel = lb_pol.select(lbs, psn_out, tick)
        if mixed_rod:
            # ROD lanes are pinned to their static single-path EV and do
            # not advance the spraying state
            ev_sel = torch.where(rod_mask, lb_pol.static_ev(lbs), ev_sel)
        inj_q = rt.injection_queue(flow_src, flow_dst, ev_sel)

        # sender-state commit for this tick's injections
        rtx = _clear_own_bit(rtx, rtx_off, use_rtx)
        next_psn = torch.where(injected & ~use_rtx, next_psn + 1, next_psn)
        lbs = _where_rows(injected & ~rod_mask if mixed_rod else injected,
                          lbs2, lbs)
        inflight = inflight + injected.to(I32)
        cc_st = cc_pol.on_inject(cc_st, injected)
        retransmits = s.retransmits + use_rtx.sum(dtype=I32)

        # ------------------------------------------------- 4. forwarding
        nonempty = s.q_len > 0
        # with the link layer off every nonempty queue transmits its head
        txq = leaves = nonempty
        head_pkt = s.q_pkt.gather(
            1, s.q_head.long()[:, None, None].expand(Q, 1, PKT_FIELDS))[:, 0]
        pf, pp, pe, pm, pt = (head_pkt[:, k].contiguous()
                              for k in range(PKT_FIELDS))
        # egress ECN marking: queue length at departure above threshold
        mark = txq & (s.q_len > p.ecn_threshold)
        pm = torch.where(mark, pm | META_ECN, pm)
        q_head = torch.where(leaves, (s.q_head + 1) % C, s.q_head)
        q_len = torch.where(leaves, s.q_len - 1, s.q_len)

        safe_pf = torch.where(nonempty, pf, 0)
        nq = rt.route_step(qidx, flow_src[safe_pf.long()],
                           flow_dst[safe_pf.long()], pe)
        deliver = txq & (nq == DELIVERED)
        forward = txq & (nq >= 0)

        # --------------------------------------------- 5. delivery at FEPs
        dtrim = deliver & ((pm & META_TRIMMED) != 0)
        ddata = deliver & ~dtrim
        # one host downlink per destination => at most one delivery per
        # flow per tick: densify to per-flow [F] values
        hot_d = (pf[None, :] == flow_ids[:, None]) & ddata[None, :]  # [F, Q]
        has_d = hot_d.any(dim=1)
        d_psn = _pick(hot_d, pp)
        d_off = d_psn - s.dst_track.base               # uint32 wrap
        d_in_range = has_d & (d_off >= 0) & (d_off < mp)
        if any_rod:
            # the ROD receiver accepts only the next in-order PSN
            # (go-back-N): out-of-order arrivals are discarded and NACKed
            # with the first-gap PSN so the source rewinds at once
            rod_rej_f = d_in_range & (d_off != 0)
            if mixed_rod:
                rod_rej_f = rod_rej_f & rod_mask
            d_rec = d_in_range & ~rod_rej_f
        else:
            d_rec = d_in_range
        d_bit = bit(d_off % 32)
        d_already = d_rec & (
            (_own_word(s.dst_track.ring, d_off) & d_bit) != 0)
        fresh_f = d_rec & ~d_already
        d_ring = s.dst_track.ring | _bit_plane(d_off, d_rec, W)
        d_ring, d_base, _ = kops.sack_advance(d_ring, s.dst_track.base)
        dst_track = pds.PSNTracker(
            base=d_base, ring=d_ring,
            rx_ok=s.dst_track.rx_ok + fresh_f.to(I32),
            dup=s.dst_track.dup + d_already.to(I32),
            oor=s.dst_track.oor + (has_d & ~d_in_range).to(I32),
        )
        if any_rod:
            dups = s.dups + (has_d & ~fresh_f & ~rod_rej_f).sum(dtype=I32)
            rod_rejects = s.rod_rejects + rod_rej_f.sum(dtype=I32)
        else:
            dups = s.dups + (has_d & ~fresh_f).sum(dtype=I32)
            rod_rejects = s.rod_rejects
        delivered_ctr = s.delivered + fresh_f.to(I32)
        # flows whose packet reached its receiver this tick (trimmed or
        # not), as a scatter into a spare row instead of an [F, Q] pass
        seen = torch.zeros((F + 1,), dtype=torch.bool, device=dev)
        seen[torch.where(deliver, pf, F).long()] = True
        cc_st = cc_pol.on_rx_seen(cc_st, seen[:F])

        # ------------------------------------- 6. OOO-count loss inference
        ooo_fire = torch.zeros((F,), dtype=torch.bool, device=dev)
        if p.ooo_threshold > 0:
            dist = pds.ooo_distance(dst_track)
            ooo_fire = ((dist > p.ooo_threshold)
                        & ((tick - s.last_ooo_nack) > ooo_gap))
        last_ooo_nack = torch.where(ooo_fire, tick, s.last_ooo_nack)

        # ---------------------------------- 6b. in-network reduction (INC)
        # not ported: INC profiles raise in _check_statics

        # ------------------------------------------------- 7. enqueue phase
        # candidates: forwarded packets (Q lanes) + injections (F lanes)
        cand_q = torch.cat([torch.where(forward, nq, -1),
                            torch.where(injected, inj_q, -1)])
        cand_flow = torch.cat([pf, flow_ids])
        cand_psn = torch.cat([pp, psn_out])
        cand_ev = torch.cat([pe, ev_sel])
        cand_meta = torch.cat([pm, zeros_f])
        cand_ts = torch.cat([pt, torch.full((F,), tick, **i32)])
        cvalid = cand_q >= 0
        safe_cq = torch.where(cvalid, cand_q, 0).long()
        # failed links (outage window): packets routed into them vanish
        is_dead = dead[safe_cq] & cvalid
        cvalid = cvalid & ~is_dead
        pos, _ = _rank_within(cand_q, cvalid, q_len, lower)
        fits = cvalid & (pos < C)
        overflow = cvalid & ~fits

        wslot = (q_head[safe_cq] + pos) % C
        # JAX drops the scatter rows of packets that do not fit (row Q);
        # here they go to a spare discard record past the last queue
        dst_rec = torch.where(fits, cand_q * C + wslot, Q * C).long()
        cand_pkt = torch.stack(
            [cand_flow, cand_psn, cand_ev, cand_meta, cand_ts], dim=-1)
        q_flat = torch.cat([s.q_pkt.reshape(Q * C, PKT_FIELDS),
                            cand_pkt.new_zeros((1, PKT_FIELDS))])
        q_flat[dst_rec] = cand_pkt
        q_pkt = q_flat[:Q * C].view(Q, C, PKT_FIELDS)
        hot_enq = (cand_q[None, :] == qidx[:, None]) & fits[None, :]  # [Q, n]
        q_len = q_len + hot_enq.sum(dim=1, dtype=I32)

        # overflow: trim (fast NACK via control TC) or drop
        n_over = overflow.sum(dtype=I32)
        if p.trimming:
            trims, drops, nack_mask = s.trims + n_over, s.drops, overflow
        else:
            trims, drops = s.trims, s.drops + n_over
            nack_mask = torch.zeros_like(overflow)
        # failed links drop silently: no trim header, no NACK
        drops = drops + is_dead.sum(dtype=I32)

        # ------------------------------------------- 8. schedule control TC
        out_slot = (tick + p.ack_return_ticks) % D
        # lanes [0, Q): ACKs from deliveries (a ROD reject becomes an OOO
        # NACK carrying the receiver's first-gap PSN); [Q, 2Q+F): trim
        # NACKs from enqueue overflow; [2Q+F, 2Q+2F): OOO NACKs (psn =
        # first gap)
        ack_lane_t = ddata.to(I32) * EV_ACK
        ack_lane_psn = pp
        if any_rod:
            rod_rej_lane = ddata & rod_rej_f[safe_pf.long()]
            ack_lane_t = torch.where(rod_rej_lane, EV_OOO, ack_lane_t)
            ack_lane_psn = torch.where(rod_rej_lane,
                                       dst_track.base[safe_pf.long()], pp)
        new_type = torch.cat([ack_lane_t, nack_mask.to(I32) * EV_NACK,
                              ooo_fire.to(I32) * EV_OOO])
        new_flow = torch.cat([safe_pf, cand_flow, flow_ids])
        new_psn = torch.cat([ack_lane_psn, cand_psn, dst_track.base])
        new_val = torch.cat([pe, cand_ev, zeros_f])
        new_ecn = torch.cat([((pm & META_ECN) != 0).to(I32), zeros_qf,
                             zeros_f])
        new_ts = torch.cat([pt, cand_ts, zeros_f])
        ev_buf[out_slot] = torch.stack(
            [new_type, new_flow, new_psn, new_val, new_ecn, new_ts], dim=-1)

        # ------------------------------------------------- 9. timeouts + QA
        timeout_fire = timeout_rod  # ROD rewinds already count as expiries
        if not all_rod:
            # sent-but-unacked PSNs with nothing in flight still need the
            # RTO (a silent loss can drain inflight to 0 with gaps open)
            unacked = src_track.base < next_psn
            stalled = ((inflight > 0) | unacked) & overdue & ~done
            if mixed_rod:
                stalled = stalled & ~rod_mask  # ROD timeouts rewind instead
            # offset 0 == oldest unacked
            rtx = _set_own_bit(rtx, zeros_f, stalled)
            # a timeout implies the outstanding packets are gone: reopen
            # the window
            inflight = torch.where(stalled, 0, inflight)
            last_progress = torch.where(stalled, tick, last_progress)
            cc_st = cc_pol.on_timeout(cc_st, stalled)
            timeout_fire = timeout_fire | stalled
        cc_st = cc_pol.end_of_tick(cc_st, tick)

        # ---------------------------------------- 10. recovery loop lanes
        # (backoff, eviction and PDC teardown are not ported: the
        # counters below are the whole section under the ported statics)
        timeouts = s.timeouts + timeout_fire.sum(dtype=I32)
        ticks_degraded = s.ticks_degraded + dead.any().to(I32)

        ns = SimState(
            q_pkt=q_pkt, q_head=q_head, q_len=q_len,
            next_psn=next_psn, inflight=inflight, src_track=src_track,
            rtx=rtx, last_progress=last_progress,
            slot_last_ack=slot_last_ack, dst_track=dst_track,
            last_ooo_nack=last_ooo_nack, cc=cc_st, lb=lbs, ev_buf=ev_buf,
            delivered=delivered_ctr, trims=trims, drops=drops, dups=dups,
            rod_rejects=rod_rejects, retransmits=retransmits, rto=rto, timeouts=timeouts,
            ticks_degraded=ticks_degraded,
        )
        out = {
            "delivered": fresh_f.to(I32),
            "cwnd": cc_pol.cwnd_view(cc_st, F),
            "qlen_max": q_len.max(),
            "rx_base": dst_track.base,
            "src_base": src_track.base,
        }
        return ns, out

    return step


# --------------------------------------------------------------------------
# results
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SimResult:
    """One scenario's outcome, in one of two trace tiers (as in the
    reference): ``trace="stats"`` carries the streamed per-flow completion
    ticks, one goodput window and the peak queue length; ``trace="full"``
    the dense per-tick lanes ([horizon, ...] numpy arrays; base lanes as
    uint32). ``state`` is the final :class:`SimState`, on the run's
    device. ``horizon`` is the number of ticks executed: the first chunk
    boundary at which the scenario is quiescent, clamped to the budget.
    """

    state: SimState
    msg_size: np.ndarray            # [F] message sizes (packets)
    horizon: int
    max_ticks: int
    trace: str = "full"
    delivered_per_tick: "np.ndarray | None" = None  # [T, F]
    cwnd_per_tick: "np.ndarray | None" = None       # [T, F]
    qlen_max: "np.ndarray | None" = None            # [T]
    rx_base_per_tick: "np.ndarray | None" = None    # [T, F] receiver CACK
    src_base_per_tick: "np.ndarray | None" = None   # [T, F] source CACK
    stat_completion: "np.ndarray | None" = None      # [F] tick or -1
    stat_src_completion: "np.ndarray | None" = None  # [F] tick or -1
    stat_win_delivered: "np.ndarray | None" = None   # [F] packets in window
    goodput_window: "tuple[int, int] | None" = None
    qlen_peak: "int | None" = None

    def completion_ticks(self) -> np.ndarray:
        """Per-flow first tick by which the full message was delivered
        (-1 where the flow did not finish within the run)."""
        if self.trace == "stats":
            return self.stat_completion.copy()
        cum = self.delivered_per_tick.cumsum(axis=0)
        reached = cum >= self.msg_size[None, :]
        return np.where(reached.any(0), reached.argmax(axis=0), -1)

    def completion_tick(self) -> int:
        """Tick by which EVERY flow completed; -1 if any did not."""
        ct = self.completion_ticks()
        return -1 if bool((ct < 0).any()) else int(ct.max())

    def source_completion_ticks(self) -> np.ndarray:
        """Per-flow first tick at which the source's CACK reached the
        message size (-1 = unfinished)."""
        if self.trace == "stats":
            return self.stat_src_completion.copy()
        reached = (self.src_base_per_tick.astype(np.int64)
                   >= self.msg_size[None, :].astype(np.int64))
        return np.where(reached.any(0), reached.argmax(axis=0), -1)

    def goodput(self, window: "tuple[int, int] | None" = None) -> np.ndarray:
        """Per-flow delivered packets / tick over ``[w0, min(w1,
        max_ticks))``; ticks past the horizon count as zero delivery."""
        mt = self.max_ticks
        w0, w1 = (0, mt) if window is None else window
        w1, w0 = min(int(w1), mt), int(w0)
        if w0 < 0 or w1 <= w0:
            raise ValueError(f"goodput window {window!r} selects no ticks "
                             f"within the {mt}-tick budget")
        if self.trace == "stats":
            if window is None:
                return self.state.delivered.cpu().numpy() / float(mt)
            if (self.goodput_window is not None and tuple(
                    int(w) for w in window) == self.goodput_window):
                return self.stat_win_delivered / float(w1 - w0)
            raise ValueError(
                f"trace='stats' recorded only the goodput window "
                f"{self.goodput_window!r}; pass goodput_window= to "
                f"simulate() or use trace='full'")
        d = self.delivered_per_tick[w0:min(w1, self.horizon)]
        return d.sum(axis=0) / float(w1 - w0)

    @property
    def trims(self) -> int:
        """Packets trimmed on queue overflow (each sent a fast NACK)."""
        return int(self.state.trims)

    @property
    def drops(self) -> int:
        """Silent drops: dead-link and (no-trim profiles) overflow losses."""
        return int(self.state.drops)

    @property
    def dups(self) -> int:
        """Duplicate deliveries discarded at the receiver."""
        return int(self.state.dups)

    @property
    def timeouts(self) -> int:
        """RTO expiries over the run."""
        return int(self.state.timeouts)

    @property
    def rtx_packets(self) -> int:
        """Retransmitted packets injected over the run."""
        return int(self.state.retransmits)

    @property
    def ticks_degraded(self) -> int:
        """Executed ticks during which at least one link was dead."""
        return int(self.state.ticks_degraded)


# --------------------------------------------------------------------------
# driver: chunked host loop
# --------------------------------------------------------------------------

def _quiescent(s: SimState, wl: Workload) -> torch.Tensor:
    """Scenario-wide quiescence: every source CACK-complete, nothing
    inflight, all queues empty and the control-TC ring drained. Once it
    holds no later tick can make protocol progress."""
    done = (s.src_track.base >= wl.size).all()
    idle = (s.inflight == 0).all() & (s.q_len == 0).all()
    drained = (s.ev_buf[:, :, EVF_TYPE] == EV_NONE).all()
    return done & idle & drained


def _stats_init(F: int, device) -> dict:
    i32 = dict(dtype=I32, device=device)
    return {"comp": torch.full((F,), -1, **i32),
            "src_comp": torch.full((F,), -1, **i32),
            "win_delivered": torch.zeros((F,), **i32),
            "qlen_peak": torch.zeros((), **i32)}


def _stats_update(st: dict, prev: SimState, s: SimState, wl: Workload,
                  tick: int, w0: int, w1: int) -> dict:
    """The streamed trace="stats" lanes: elementwise [F] updates off
    state the tick already computed."""
    win = st["win_delivered"]
    if w0 <= tick < w1:
        win = win + (s.delivered - prev.delivered)
    return {
        "comp": torch.where((st["comp"] < 0) & (s.delivered >= wl.size),
                            tick, st["comp"]),
        "src_comp": torch.where(
            (st["src_comp"] < 0) & (s.src_track.base >= wl.size), tick,
            st["src_comp"]),
        "win_delivered": win,
        "qlen_peak": torch.maximum(st["qlen_peak"], s.q_len.max()),
    }


def _fault_schedule(g: QueueGraph, failed, faults, device) -> FaultSchedule:
    """One [Q] FaultSchedule from the public (failed=, faults=) pair."""
    if faults is not None:
        if failed is not None:
            raise ValueError("pass either failed= (static mask) or faults= "
                             "(FaultSchedule), not both")
        if not isinstance(faults, FaultSchedule):
            raise TypeError(f"faults= must be a FaultSchedule, got "
                            f"{type(faults).__name__}")
        if faults.num_queues != g.num_queues:
            raise ValueError(f"fault schedule is over {faults.num_queues} "
                             f"queues but the topology has {g.num_queues}")
        return faults.to(device)
    mask = np.zeros((g.num_queues,), bool)
    if failed is not None:
        arr = np.asarray(failed)
        if arr.dtype == bool:
            if arr.shape != mask.shape:
                raise ValueError(f"failed mask must be [Q={g.num_queues}], "
                                 f"got {arr.shape}")
            mask = arr
        else:
            if arr.size and (arr.min() < 0 or arr.max() >= g.num_queues):
                raise ValueError(f"failed queue ids must be in [0, "
                                 f"{g.num_queues})")
            mask[arr.astype(np.int64)] = True
    return FaultSchedule.from_mask(mask, device)


_FULL_LANES = ("delivered", "cwnd", "qlen_max", "rx_base", "src_base")


def _chunk_to_host(outs: "list[dict]", quiet: torch.Tensor):
    """Stack one chunk's per-tick out lanes and copy them, with the
    quiescence flag, to the host in ONE transfer (the chunk's only sync).
    Returns ({lane: np array [T, ...]}, quiet)."""
    T = len(outs)
    parts = []
    for k in _FULL_LANES:
        a = torch.stack([o[k] for o in outs])
        parts.append((a.view(I32) if a.dtype == torch.float32 else a)
                     .reshape(-1))
    host = torch.cat(parts + [quiet.to(I32).reshape(1)]).cpu().numpy()
    lanes, at = {}, 0
    for k in _FULL_LANES:
        shape = (T,) + tuple(outs[0][k].shape)
        n = int(np.prod(shape))
        lanes[k] = host[at:at + n].reshape(shape)
        at += n
    lanes["cwnd"] = lanes["cwnd"].view(np.float32)
    lanes["rx_base"] = lanes["rx_base"].view(np.uint32)
    lanes["src_base"] = lanes["src_base"].view(np.uint32)
    return lanes, bool(host[-1])


def run_chunks(step, s: SimState, wl: Workload, fault: FaultSchedule,
               budget: int, chunk: int, trace: str, w0: int = 0,
               w1: int = 0, tick0: int = 0):
    """Drive ``step`` from tick ``tick0`` in ``chunk``-tick chunks until
    the scenario is quiescent at a chunk boundary or the budget is spent.
    Ticks at or past the budget do not run. Returns (final state, stats
    lanes or None, host out lanes per chunk, horizon)."""
    st = _stats_init(int(wl.src.shape[0]), wl.src.device) \
        if trace == "stats" else None
    chunks: list = []
    horizon = min(tick0, budget)
    while tick0 < budget:
        end = min(tick0 + chunk, budget)
        outs = []
        for tick in range(tick0, end):
            ns, out = step(s, tick, wl, fault)
            if st is not None:
                st = _stats_update(st, s, ns, wl, tick, w0, w1)
            else:
                outs.append(out)
            s = ns
        tick0 += chunk
        horizon = min(tick0, budget)
        if st is not None:
            quiet = bool(_quiescent(s, wl))
        else:
            lanes, quiet = _chunk_to_host(outs, _quiescent(s, wl))
            chunks.append(lanes)
        if quiet:
            break
    return s, st, chunks, horizon


def simulate(g: QueueGraph, wl: Workload,
             profile: "TransportProfile | None" = None,
             p: "SimParams | None" = None, *, seed: int = DEFAULT_SEED,
             failed=None, faults: "FaultSchedule | None" = None,
             trace: str = "stats", max_ticks: "int | None" = None,
             goodput_window: "tuple[int, int] | None" = None,
             device=None) -> SimResult:
    """Run one scenario for at most ``max_ticks`` (default p.ticks),
    exiting at the first chunk boundary where it is quiescent.

    profile: the transport composition (defaults to ai_full()).
    failed:  queue ids or a [Q] bool mask of dead links; ``faults``: a
             link-outage :class:`FaultSchedule` (mutually exclusive).
    trace:   "stats" (streamed stat lanes) or "full" (dense per-tick
             lanes, copied to the host once per chunk).
    device:  where the run lives: ``cuda`` unless given (``"cpu"`` runs
             the plain PyTorch path, as the tests do).
    """
    dev = resolve_device(device)
    profile = TransportProfile.ai_full() if profile is None else profile
    p = SimParams() if p is None else p
    if trace not in TRACE_MODES:
        raise ValueError(f"unknown trace tier {trace!r}; choose from "
                         f"{TRACE_MODES}")
    if p.chunk_ticks < 1:
        raise ValueError(f"chunk_ticks must be >= 1, got {p.chunk_ticks}")
    budget = int(p.ticks if max_ticks is None else max_ticks)
    F = int(wl.src.shape[0])
    profile.delivery_modes(F)  # validate per-flow tuples early
    fault = _fault_schedule(g, failed, faults, dev)
    wl = wl.to(dev)
    step = make_step(g, profile, p, F, device=dev)
    s0 = init_state(g, wl, profile, p, seed, device=dev)
    msg_size = wl.size.cpu().numpy()
    w0, w1 = (0, budget) if goodput_window is None else map(int,
                                                            goodput_window)
    s, st, chunks, horizon = run_chunks(step, s0, wl, fault, budget,
                                        p.chunk_ticks, trace, w0, w1)
    if trace == "stats":
        return SimResult(
            state=s, msg_size=msg_size, horizon=horizon, max_ticks=budget,
            trace="stats",
            stat_completion=st["comp"].cpu().numpy(),
            stat_src_completion=st["src_comp"].cpu().numpy(),
            stat_win_delivered=st["win_delivered"].cpu().numpy(),
            goodput_window=(None if goodput_window is None
                            else tuple(int(w) for w in goodput_window)),
            qlen_peak=int(st["qlen_peak"]))
    lanes = {k: np.concatenate([c[k] for c in chunks])[:horizon]
             for k in _FULL_LANES} if chunks else None
    return SimResult(
        state=s, msg_size=msg_size, horizon=horizon, max_ticks=budget,
        trace="full",
        delivered_per_tick=None if lanes is None else lanes["delivered"],
        cwnd_per_tick=None if lanes is None else lanes["cwnd"],
        qlen_max=None if lanes is None else lanes["qlen_max"],
        rx_base_per_tick=None if lanes is None else lanes["rx_base"],
        src_base_per_tick=None if lanes is None else lanes["src_base"])
