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

The tick runs B scenarios at once: every lane of the state carries a
leading [B] scenario axis (the reference vmaps its one-scenario step;
here the axis is written out), and ``simulate`` is the B = 1 case of
``simulate_batch``, so the two share one tick. Scatters that cross rows
(the packet write into the queues, the ``seen`` mark, RCCC's
per-destination sums, EVBITMAP's marks, the NACK lanes) index flat rows
with a per-scenario offset and send dropped lanes to a discard row that
belongs to no scenario. The kernels see the [B, F, W] rings as
[B·F, W] rows; one launch per site and tick, whatever B is.

The tick's kernels, through ``repro_torch.kernels.ops``:
``sack_fused_own`` (section 1, source ACKs) and ``sack_advance_own``
(section 5, receiver CACK) once a tick; and the in-place marks on the
retransmit ring that ``sack_fused_own`` made: ``nack_mark_lanes_``
(section 1, NACKed PSNs; not under all-ROD), ``set_own_bit_`` (the
RR_SLOTS loss inference of section 1, twice, with the source ring as
``unless``; the RTO of section 9, not under all-ROD) and
``clear_own_bit_`` (the retransmit pick of section 3). Each takes each
flow's own PSN offset, or the raw NACK lanes, and sets, tests and clears
the bits itself, where the reference builds an [F, W] bit plane around
its dense kernels; each site is one launch. Section 7 takes its
arrival ranks, queue positions and per-queue enqueue counts from
``enqueue_rank`` (once a tick, twice under CBFC, whose credit gate ranks
the candidates against a zero base), a sequential count in linear work
where the reference builds [B, n, n] and [B, Q, n] one-hots. On CUDA
tensors they are hand-written CUDA; on CPU tensors their plain PyTorch
versions.

Every profile of the paper's table runs: each CC composition (NSCC,
RCCC, their hybrid, open loop), every LB scheme (STATIC, OBLIVIOUS,
RR_SLOTS with its EV-based loss inference, REPS, EVBITMAP) and per-flow
RUD / ROD / RUDI delivery (ROD is go-back-N on one static path). So do
the faults and the closed recovery loop: link outages, gray links and
PHY corruption (counter-hash draws), host deaths and NIC stalls, RTO
backoff, EV eviction and PDC liveness teardown (quarantine). Each fault
class and recovery knob is a static of ``make_step`` derived from the
schedule or the profile, so a run without it builds the tick without its
lanes. So do in-network reduction (``inc=True`` profiles: the ToR's
accumulator contexts of ``repro_torch.core.inc``, section 6b) and the
link layer (``link=LinkConfig(...)``: LLR replay at the hop in section
4, the CBFC credit gate in section 7) and the telemetry probe
(``telemetry=TelemetrySpec.on(...)``: per-queue event counts, per-flow
RTT and cwnd, riding the stats carry; ``repro_torch.network.telemetry``).
``simulate_batch(shard=, devices=)`` splits the scenario axis across
devices (``repro_torch.network.shard``). uint32 lanes are
int32 bit patterns (``_u32``; the 20-bit CBFC counters are masked to
``CTR_MOD``); JAX's clamped gathers and dropped scatters are written
out as clamps and masks.

Each ``simulate_batch`` call is a ``sweep`` span of ``repro_torch.spans``
(recorded while ``torch.profiler`` runs), holding the driver's build,
chunk issue and collect, each tick, the tick's numbered sections as
phases, its fault draws, its policy calls and its ROD-only blocks
(``pds.rod``); ``DRIVER_COUNTS`` counts the group ticks the chunk loops
issue and those under the masked body, ``TRANSPORT_COUNTS`` the finished
sweeps' arrivals, duplicates, ROD rejects and trims.

The other dense one-hots of the reference stay ([B, F, E] ACK/NACK
lanes, [B, H, F] host pick, [B, F, Q] deliveries), so parity is easy to
reason about; they are quadratic and cap the fabric size (ROADMAP.md,
"Scale cap").
"""
from __future__ import annotations

import warnings
from contextlib import nullcontext
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from repro_torch import resolve_device, spans
from repro_torch._u32 import c32, shr, ult
from repro_torch.core import inc, pds
from repro_torch.core.link import CTR_MOD, LinkConfig
from repro_torch.core.pdc import unreachable
from repro_torch.core.cms.nscc import NSCCParams
from repro_torch.core.lb.schemes import LBPolicy, LBScheme, LBState, _mix32
from repro_torch.core.lb.schemes import _pick_lane as _pick
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import rank_within
from repro_torch.network.ecmp import DELIVERED, RoutingTables
from repro_torch.network.faults import (FaultSchedule, as_schedule,
                                        failed_to_mask, loss_threshold)
from repro_torch.network.profile import (DeliveryMode, TransportProfile,
                                         make_cc_policy)
from repro_torch.network import telemetry as telem
from repro_torch.network.telemetry import TelemetrySpec
from repro_torch.network.topology import QueueGraph, Stage

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
    ``inc=True`` profiles). All [F] int32, or [B, F] for a scenario
    batch (``Workload.stack``)."""

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

    @staticmethod
    def stack(wls: "list[Workload] | tuple[Workload, ...]") -> "Workload":
        """Stack same-F workloads along a leading scenario axis ([B, F])."""
        f = {int(w.src.shape[-1]) for w in wls}
        if len(f) != 1:
            raise ValueError(f"scenario batch needs a uniform flow count, "
                             f"got {sorted(f)}")
        return Workload(*(torch.stack([getattr(w, fl.name) for w in wls])
                          for fl in fields(Workload)))

    def to(self, device) -> "Workload":
        return Workload(*(getattr(self, f.name).to(device)
                          for f in fields(self)))

    def lanes(self, idx) -> "Workload":
        """The scenarios ``idx`` (an index array) of a [B, F] batch."""
        return Workload(*(getattr(self, f.name)[idx] for f in fields(self)))


@dataclass(frozen=True)
class SimState:
    """The whole fabric + protocol state of B scenarios: every lane below
    has a leading [B] axis (shapes are given per scenario). A result's
    state (``SimResult.state``) is one scenario's, without it.

    Mirrors the reference ``SimState`` lane for lane. The INC contexts
    and the link-layer lanes are zero-size ([0, 1] slots, [0] and
    [0, 0] lanes) unless the profile has ``inc`` and the run ``link``
    armed, as the reference's are.
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
                             # loop's empty [0] int32 tensor ([B, 0])
    lb: LBState
    ev_buf: torch.Tensor     # [D, E, EVF_FIELDS] int32 control-TC delay ring
    inc: inc.INCState        # [F, inc_slots] reduction contexts ([0, 1] off)
    delivered: torch.Tensor  # [F] int32 packets delivered (first copies)
    trims: torch.Tensor      # [] int32
    drops: torch.Tensor      # [] int32
    dups: torch.Tensor       # [] int32
    inc_reduced: torch.Tensor  # [] int32 packets absorbed at a switch
    inc_emits: torch.Tensor  # [] int32 aggregates forwarded
    rod_rejects: torch.Tensor  # [] int32 out-of-order arrivals ROD discarded
    retransmits: torch.Tensor  # [] int32
    rto: torch.Tensor        # [F] int32 per-flow retransmission timeout
    timeouts: torch.Tensor   # [] int32
    ev_evictions: torch.Tensor  # [] int32 EVs blacklisted by the LB policy
    ticks_degraded: torch.Tensor  # [] int32 ticks with >= 1 link/host dead
    rto_strikes: torch.Tensor  # [F] int32 consecutive zero-progress RTOs
    quarantined: torch.Tensor  # [F] bool PDC torn down, flow abandoned
    flows_abandoned: torch.Tensor  # [] int32 PDCs declared unreachable
    ticks_unreachable: torch.Tensor  # [] int32 ticks with >= 1 quarantined
    llr_busy_until: torch.Tensor  # [Q] int32 LLR replay window end ([0] off)
    llr_replays: torch.Tensor  # [] int32 frames corrupted and replayed
    cbfc_consumed: torch.Tensor  # [Q] uint32, 20-bit cyclic ([0] off)
    cbfc_freed: torch.Tensor  # [Q] uint32, 20-bit cyclic ([0] off)
    cbfc_ret: torch.Tensor   # [Rd, Q] int32 credit-return delay ring
    credit_stall_ticks: torch.Tensor  # [] int32 ticks with >= 1 stall


def _first_set_bit(ring: torch.Tensor) -> torch.Tensor:
    """Per-row index of the lowest set bit of a [..., N, W] uint32 ring,
    or -1."""
    nz = ring != 0
    has = nz.any(dim=-1)
    first_w = torch.argmax(nz.to(I32), dim=-1)  # first max, as jnp.argmax
    w = ring.gather(-1, first_w[..., None])[..., 0]
    ctz = pds._popcount32((w & (0 - w)) - 1)
    return torch.where(has, first_w * 32 + ctz, -1).to(I32)


# The reference tick's dense one-bit-per-row helpers. The port's tick
# calls the in-place kernels instead (kops.set_own_bit_ / clear_own_bit_);
# these stay as the compositions that the parity tests and chip_smoke.py
# hold those kernels against.
_bit_plane = pds.bit_plane


def _set_own_bit(ring, off, valid):
    """Row i sets bit off[i] — elementwise, no scatter."""
    return ring | _bit_plane(off, valid, ring.shape[-1])


def _clear_own_bit(ring, off, valid):
    """Row i clears bit off[i] — elementwise, no scatter."""
    return ring & ~_bit_plane(off, valid, ring.shape[-1])


def _own_word(ring: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Row i's ring word containing bit offset off[i] (clipped)."""
    w = ring.shape[-1]
    word = torch.div(off.clamp(0, w * 32 - 1), 32, rounding_mode="floor")
    return ring.gather(-1, word[..., None].long())[..., 0]


#: the plain masked pairwise count of the enqueue ranks (the reference's
#: ``_rank_within``); the tick calls ``kops.enqueue_rank``
_rank_within = rank_within


def _tree_map(fn, *objs):
    """``fn`` over the tensors of same-shaped state trees (dataclasses of
    tensors, nested dataclasses and dicts), leaf by leaf."""
    o = objs[0]
    if isinstance(o, torch.Tensor):
        return fn(*objs)
    if isinstance(o, dict):
        return {k: _tree_map(fn, *(x[k] for x in objs)) for k in o}
    return type(o)(*(_tree_map(fn, *(getattr(x, f.name) for x in objs))
                     for f in fields(o)))


def _where_rows(cond: torch.Tensor, new, old):
    """Tree-wise select of two same-typed state trees: keep `new` where
    `cond` is set — per flow ([B, F] against [B, F, ...] lanes) or per
    scenario ([B] against every [B, ...] lane)."""
    def sel(a, b):
        return torch.where(cond.reshape(cond.shape
                                        + (1,) * (a.dim() - cond.dim())),
                           a, b)
    return _tree_map(sel, new, old)


def take_lane(tree, b: int):
    """Scenario b of a batched state tree (views, no copy)."""
    return _tree_map(lambda a: a[b], tree)


def stack_lanes(trees):
    """One batched state tree from per-scenario trees ([B] axis first)."""
    return _tree_map(lambda *a: torch.stack(a), *trees)


def _cc_params(p: SimParams) -> NSCCParams:
    return NSCCParams(base_rtt=p.base_rtt, max_cwnd=p.max_cwnd)


def _seed_lane(seeds, B: int, device) -> torch.Tensor:
    """[B] uint32 seeds as int32 patterns, from one seed or B of them
    (each taken modulo 2**32, as ``jnp.asarray(seeds, jnp.uint32)``)."""
    a = np.asarray(seeds).astype(np.int64) & 0xFFFFFFFF
    a = np.broadcast_to(a, (B,)).astype(np.uint32).view(np.int32)
    return torch.as_tensor(a).to(device)


def init_state(g: QueueGraph, wl: Workload, profile: TransportProfile,
               p: SimParams, seed=DEFAULT_SEED, device=None,
               link: "LinkConfig | None" = None) -> SimState:
    """The initial state of a [B, F] scenario batch (``Workload.stack``),
    with one seed for every scenario or a [B] seed lane; ``link`` sizes
    the link-layer lanes."""
    dev = resolve_device(device)
    if wl.src.dim() != 2:
        raise ValueError(f"init_state takes a [B, F] workload (build one "
                         f"with Workload.stack), got {tuple(wl.src.shape)}")
    B, F = (int(d) for d in wl.src.shape)
    Q, C = g.num_queues, p.queue_capacity
    D = p.ack_return_ticks + 1
    E = 2 * Q + 2 * F
    W = p.mp_range // 32
    cc_pol = make_cc_policy(profile.cc, _cc_params(p), p.max_cwnd)
    i32 = dict(dtype=I32, device=dev)
    q_pkt = torch.zeros((B, Q, C, PKT_FIELDS), **i32)
    q_pkt[..., PKT_FLOW] = -1
    zero = torch.zeros((B,), **i32)
    llr = link is not None and link.llr
    cbfc = link is not None and link.cbfc
    return SimState(
        q_pkt=q_pkt,
        q_head=torch.zeros((B, Q), **i32), q_len=torch.zeros((B, Q), **i32),
        next_psn=torch.zeros((B, F), **i32),
        inflight=torch.zeros((B, F), **i32),
        src_track=pds.PSNTracker.create((B, F), p.mp_range, dev),
        rtx=torch.zeros((B, F, W), **i32),
        last_progress=torch.zeros((B, F), **i32),
        slot_last_ack=torch.full((B, F, p.ev_slots), -1, **i32),
        dst_track=pds.PSNTracker.create((B, F), p.mp_range, dev),
        last_ooo_nack=torch.full((B, F), -10 ** 6, **i32),
        cc=cc_pol.create((B, F), dev),
        lb=LBState.create(F, p.ev_slots, _seed_lane(seed, B, dev), dev),
        ev_buf=torch.zeros((B, D, E, EVF_FIELDS), **i32),
        inc=(inc.INCState.create(F, p.inc_slots, B, dev) if profile.inc
             else inc.INCState.empty(B, dev)),
        delivered=torch.zeros((B, F), **i32),
        trims=zero, drops=zero.clone(), dups=zero.clone(),
        inc_reduced=zero.clone(), inc_emits=zero.clone(),
        rod_rejects=zero.clone(), retransmits=zero.clone(),
        rto=torch.full((B, F), p.timeout_ticks, **i32),
        timeouts=zero.clone(), ev_evictions=zero.clone(),
        ticks_degraded=zero.clone(),
        rto_strikes=torch.zeros((B, F), **i32),
        quarantined=torch.zeros((B, F), dtype=torch.bool, device=dev),
        flows_abandoned=zero.clone(), ticks_unreachable=zero.clone(),
        llr_busy_until=torch.zeros((B, Q if llr else 0), **i32),
        llr_replays=zero.clone(),
        cbfc_consumed=torch.zeros((B, Q if cbfc else 0), **i32),
        cbfc_freed=torch.zeros((B, Q if cbfc else 0), **i32),
        cbfc_ret=torch.zeros((B,) + ((link.credit_return_ticks, Q) if cbfc
                                     else (0, 0)), **i32),
        credit_stall_ticks=zero.clone(),
    )


def _check_telemetry(telemetry, trace: str) -> "TelemetrySpec | None":
    """The ``telemetry=`` argument as the driver takes it, as the
    reference's ``_check_telemetry``: None or an off spec is the
    pre-telemetry tick; any other type is a ``TypeError``; an enabled
    spec needs ``trace="stats"``."""
    if telemetry is None:
        return None
    if not isinstance(telemetry, TelemetrySpec):
        raise TypeError(f"telemetry= takes a TelemetrySpec, got "
                        f"{type(telemetry).__name__}")
    if not telemetry.enabled:
        return None
    if trace != "stats":
        raise ValueError(
            "telemetry lanes ride the streaming stats carry — enabled "
            "TelemetrySpec requires trace='stats'")
    return telemetry


def _check_link(link) -> "LinkConfig | None":
    """The ``link=`` argument as the tick takes it, as the reference's
    ``_check_link``: None or an off spec is the pre-link-layer tick; any
    other type is a ``TypeError``."""
    if link is None:
        return None
    if not isinstance(link, LinkConfig):
        raise TypeError(f"link= takes a LinkConfig, got "
                        f"{type(link).__name__}")
    return link if link.enabled else None


def make_step(g: QueueGraph, profile: TransportProfile, p: SimParams, F: int,
              lossy: bool = False, tel=None, hosty: bool = False,
              corrupty: bool = False, link=None, device=None):
    """Build the per-tick transition ``step(s, tick, wl, fault) -> (s',
    out)`` for one transport profile on one device.

    ``s`` is the state of B scenarios ([B, ...] lanes), ``wl`` their
    [B, F] workload and ``fault`` their [B, Q] schedule; ``tick`` is one
    Python int for every scenario, and the step never syncs with the
    host. Scenarios share nothing but the topology and the profile: each
    cross-row scatter offsets its rows by scenario. The statics mirror
    the reference's ``make_step``: any CC composition, LB scheme and
    per-flow delivery modes (ROD flows run go-back-N on one static path,
    gate injection on in-order CACK advance, and their receiver accepts
    only the next expected PSN; an all-ROD profile pins LB to STATIC).

    The fault statics come from the schedule (``simulate_batch`` derives
    them): ``lossy`` builds the gray-link draw (a nonzero ``loss_p``
    lane), ``hosty`` the host-death / NIC-stall lanes (a scheduled host
    fault), ``corrupty`` the per-transmission BER draw (a nonzero
    ``corrupt_p`` lane; without the link layer a corrupted frame is a
    silent drop). The recovery statics come from the profile:
    ``rto_backoff != 1`` (exponential RTO, reset by any ACK, capped at
    ``rto_max_scale``), ``ev_eviction`` (trim NACKs, and timeouts of
    pinned paths, blacklist the EV) and ``pdc_dead_after > 0`` (that
    many consecutive zero-progress RTOs quarantine the flow). Off, each
    builds no lane of its own: the default tick is the pre-fault one.

    ``profile.inc`` builds section 6b: forwarded packets about to enter
    their destination host downlink and belonging to a reduction group
    (``wl.red``) are offered to the ToR's accumulator contexts; absorbed
    ones leave the enqueue set and are ACKed like deliveries. On
    ``red = -1`` lanes it changes nothing, bitwise. ``link`` (a
    :class:`LinkConfig`) arms the link layer: ``llr`` holds a corrupted
    head frame in its queue for ``llr_rtt`` ticks and resends it (no
    drop); ``cbfc`` back-pressures an enqueue without credited space in
    place (the upstream hop keeps its frame, an injection waits with no
    sender-state trace), with credits returning after
    ``credit_return_ticks``. ``tel`` (an enabled
    :class:`TelemetrySpec`) adds the ``probe`` dict to the out lanes:
    per-queue event counts (``telemetry.queue_events``: egress ECN marks,
    trims and silent drops on the enqueue lanes split as the profile
    trims, corruption drops at the transmitting queue without LLR, LLR
    replays, CBFC stalls at their target), each flow's RTT sample and
    cwnd. Off, no probe lane is built.
    """
    dev = resolve_device(device)
    tel_on = tel is not None and tel.enabled
    link = _check_link(link)
    llr = link is not None and link.llr
    cbfc = link is not None and link.cbfc
    llr_rtt = int(link.llr_rtt) if llr else 0
    Rd = int(link.credit_return_ticks) if cbfc else 1
    mask20 = CTR_MOD - 1
    inc_on = profile.inc
    rt = RoutingTables(g, dev)
    Q = g.num_queues
    C = p.queue_capacity
    D = p.ack_return_ticks + 1
    H = g.num_hosts
    mp = p.mp_range
    K = p.ev_slots
    i32 = dict(dtype=I32, device=dev)
    flow_ids = torch.arange(F, **i32)
    qidx = torch.arange(Q, **i32)
    hosts = torch.arange(H, **i32)
    n_cand = Q + F
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
    # recovery-loop statics: off (the defaults) they build no lane
    backoff_on = profile.rto_backoff != 1.0
    evict_on = profile.ev_eviction
    pdc_on = profile.pdc_dead_after > 0
    rto_cap = int(p.timeout_ticks) * int(profile.rto_max_scale)
    backoff = torch.tensor(profile.rto_backoff, dtype=torch.float32,
                           device=dev)
    # the draws' per-lane hash terms (uint32 lane id times a constant)
    if lossy:
        lane_mix = torch.arange(n_cand, **i32) * c32(0x85EBCA77)
    if corrupty:
        queue_mix = qidx * c32(0xC2B2AE35)
    if hosty:
        # queue -> host map of the dead-host downlink mask: only each
        # host's final downlink is host-owned; fabric queues never
        # inherit a host outage
        qh_np = np.full((Q,), -1, np.int64)
        qh_np[np.asarray(g.host_queue, np.int64)] = np.arange(H)
        q_is_host = torch.as_tensor(qh_np >= 0, device=dev)
        q_host = torch.as_tensor(np.where(qh_np >= 0, qh_np, 0),
                                 device=dev)
    # per batch size: [B, 1] first flat row of each scenario (queue
    # records, flows) and the [B, ...] zero lanes, made once
    consts: dict = {}
    # INC membership of the workload last stepped: its red lane is fixed
    # for a run, so the sort runs once per call, not per tick
    members: dict = {}

    def inc_members(wl: Workload):
        if members.get("wl") is not wl:
            cross = rt.host_leaf[wl.src.long()] != rt.host_leaf[wl.dst.long()]
            members["wl"] = wl
            members["ranks"] = inc.member_ranks(
                wl.red, cross, (~rod_mask) if any_rod else None)
        return members["ranks"]

    def batch_consts(B: int) -> dict:
        c = consts.get(B)
        if c is None:
            b = torch.arange(B, **i32)[:, None]
            c = consts[B] = {
                "rec0": b * (Q * C), "flow0": b * F,
                "flow_ids": flow_ids.expand(B, F),
                "zeros_f": torch.zeros((B, F), **i32),
                "zeros_qf": torch.zeros((B, Q + F), **i32),
                "no_f": torch.zeros((B, F), dtype=torch.bool, device=dev),
                "zeros_q": torch.zeros((B, Q), **i32),
            }
            if tel_on:
                c["tel_rows"] = telem.event_rows(B, Q, n_cand, dev)
        return c

    def step(s: SimState, tick: int, wl: Workload, fault: FaultSchedule):
        B = int(wl.src.shape[0])
        bc = batch_consts(B)
        zeros_f = bc["zeros_f"]
        flow_src = wl.src
        flow_dst = wl.dst
        slot = tick % D
        dead = fault.dead_at(tick)                              # [B, Q]
        if hosty:
            # endpoint lanes: dead hosts inject nothing, process no ACKs
            # and absorb nothing (their downlink eats enqueues as silent
            # drops); stalled NICs only stop injecting. A dead
            # destination does not freeze its source, which retransmits
            # into the dead downlink until the PDC teardown.
            with spans.span("tick.faults"):
                hd = fault.host_dead_at(tick)                   # [B, H]
                nic = fault.nic_stalled_at(tick)
                dead = dead | (q_is_host & hd[:, q_host])
                src_dead = hd.gather(-1, flow_src.long())       # [B, F]
                dst_dead = hd.gather(-1, flow_dst.long())
                inj_frozen = src_dead | nic.gather(-1, flow_src.long())

        # ------------------------------------------------ 1. control events
        spans.phase("tick.1_control")
        evs = s.ev_buf[:, slot]                               # [B, E, 6]
        et, ef, ep, ee, ec, ets = (evs[..., k].contiguous()
                                   for k in range(EVF_FIELDS))
        is_ack = et == EV_ACK
        is_nack = (et == EV_NACK) | (et == EV_OOO)
        if hosty:
            # a dead source host loses its returning ACKs and NACKs on
            # arrival (consumed from the ring: nothing replays at heal)
            lane_src_dead = src_dead.gather(-1, ef.clamp(0, F - 1).long())
            is_ack = is_ack & ~lane_src_dead
            is_nack = is_nack & ~lane_src_dead
        # at most one ACK lane per flow per tick: one [B, F, E] one-hot
        # densifies every ACK-driven update to [B, F] / [B, F, W] work
        own = ef[:, None, :] == flow_ids[:, None]
        hot_ack = own & is_ack[:, None, :]
        hot_nack = own & is_nack[:, None, :]
        del own   # [B, F, E]: not held through the tick's peak
        has_ack = hot_ack.any(dim=-1)
        nack_count = hot_nack.sum(dim=-1, dtype=I32)
        ack_psn = _pick(hot_ack, ep)
        if evict_on:
            # trim NACKs implicate the path EV they carry (OOO NACKs are
            # gap reports, not path evidence; ROD lanes evict on timeout
            # only). Several may hit one flow in a tick: the reference
            # takes the max EV, here a scatter-max into each scenario's
            # flow rows (a discard row past them) instead of a [B, F, E]
            # pass; max is order-free, so the result is exact.
            tn = is_nack & (et == EV_NACK) & (ef >= 0) & (ef < F)
            rows = torch.where(tn, bc["flow0"] + ef, B * F).long()
            nack_ev = torch.full((B * F + 1,), -1, **i32).scatter_reduce_(
                0, rows.reshape(-1), ee.reshape(-1), "amax")
            nack_ev = nack_ev[:B * F].view(B, F)
            hit = torch.zeros((B * F + 1,), dtype=torch.bool, device=dev)
            hit[rows.reshape(-1)] = True
            nack_evict = hit[:B * F].view(B, F)
            if any_rod:
                nack_evict = nack_evict & ~rod_mask

        # ACKs: record at source, advance CACK, shift the rtx ring in
        # lockstep, and clear the ACKed PSN's pending retransmit bit
        # (its offset from the new base; ACK'd PSNs can't be pending
        # retransmit anymore) — the fused SACK kernel on each row's own
        # bit, over the B*F rows. Nothing between the reference's fused
        # call and its clear touches rtx, so the kernel does both.
        ack_off0 = ack_psn - s.src_track.base          # uint32 wrap
        ack_in_range = has_ack & (ack_off0 >= 0) & (ack_off0 < mp)
        src_ring, src_base, rtx, adv, ack_already = kops.sack_fused_own(
            s.src_track.ring, s.src_track.base, s.rtx, ack_off0,
            ack_in_range, has_ack)
        src_track = pds.PSNTracker(
            base=src_base, ring=src_ring,
            rx_ok=s.src_track.rx_ok + (ack_in_range & ~ack_already).to(I32),
            dup=s.src_track.dup + ack_already.to(I32),
            oor=s.src_track.oor + (has_ack & ~ack_in_range).to(I32),
        )

        # retire inflight, CC + LB feedback (policy hooks over [B, F])
        retire = has_ack.to(I32) + nack_count
        inflight = torch.clamp(s.inflight - retire, min=0)
        ack_ecn = _pick(hot_ack, ec).to(torch.bool)
        rtt = (tick - _pick(hot_ack, ets)).to(torch.float32)
        with spans.span("policy.cc"):
            cc_st = cc_pol.on_ack(s.cc, has_ack, ack_ecn, rtt)
            cc_st = cc_pol.on_nack(cc_st, nack_count)
        with spans.span("policy.lb"):
            lbs = lb_pol.on_ack(s.lb, hot_ack, ef, ee, ec, is_ack, is_nack,
                                flow_ok=(~rod_mask) if mixed_rod else None)

        # progress clock: any ACK freshens the flow; with backoff on, it
        # also resets the flow's RTO to its base value
        last_progress = torch.where(has_ack, tick, s.last_progress)
        rto = (torch.where(has_ack, p.timeout_ticks, s.rto)
               if backoff_on else s.rto)

        # NACKs (trim / OOO): mark the PSN for selective retransmit (RUD;
        # ROD rewinds instead, section 3). Lanes [Q, E) are the
        # NACK-capable ones (lanes [0, Q) carry NACKs only for ROD
        # flows); several may hit one flow or one bit, so the mark is a
        # duplicate-safe OR. The kernel takes the raw [B, L] lanes,
        # keeps each scenario's lanes on its own F rows and computes
        # each lane's offset from the new base itself. An all-ROD
        # profile has no selective-retransmit path: the reference
        # compiles it out, and the kernel is not launched.
        # The marks here, in the RR_SLOTS inference, the retransmit pick
        # and the RTO write into rtx in place. That is safe: rtx is the
        # ring that sack_fused_own made this tick, no other name holds
        # it (the input state keeps its own), and `out` does not record
        # it.
        if not all_rod:
            rtx = kops.nack_mark_lanes_(rtx, src_track.base, ef[:, Q:],
                                        ep[:, Q:], is_nack[:, Q:],
                                        rod_mask if mixed_rod else None)
        with spans.span("pds.rod") if any_rod else nullcontext():
            rod_gbn = hot_nack.any(dim=-1)

        # EV-based loss inference (Sec. 3.2.4), RR_SLOTS layout: slot i
        # carries PSNs i, i+K, i+2K...; an ACK for PSN x implies every
        # unacked PSN x-K, x-2K... of its slot was lost
        slot_last_ack = s.slot_last_ack
        if rr_slots:
            has_ack_rr = has_ack & ~rod_mask if mixed_rod else has_ack
            sl = ack_psn % K
            prev = slot_last_ack.gather(-1, sl[..., None].long())[..., 0]
            # mark up to 2 predecessors (losses per ACK are almost
            # always <= 1)
            for back in (1, 2):
                miss = ack_psn - back * K
                # skip PSNs already SACKed at the source (not lost): the
                # kernel tests the bit of the source ring (`unless`)
                rtx = kops.set_own_bit_(
                    rtx, miss - src_track.base,
                    has_ack_rr & (miss > prev) & (miss >= 0),
                    unless=src_track.ring)
            hot_sl = (kslots == sl[..., None]) & has_ack_rr[..., None]
            slot_last_ack = torch.where(
                hot_sl, torch.maximum(slot_last_ack, ack_psn[..., None]),
                slot_last_ack)

        # consume the slot: clear only the EVF_TYPE lane (the slot is
        # fully rewritten when it next comes up as out_slot)
        ev_buf = s.ev_buf.clone()
        ev_buf[:, slot, :, EVF_TYPE] = EV_NONE

        # ------------------------------------------- 2. RCCC receiver grants
        spans.phase("tick.2_grants")
        done = src_track.base >= wl.size
        # dependency lane: eligible once flow dep[f] source-completed
        safe_dep = torch.where(wl.dep >= 0, wl.dep, 0).long()
        dep_ok = (wl.dep < 0) | done.gather(-1, safe_dep)
        active = ~done & (tick >= wl.start) & dep_ok
        if pdc_on:
            # a torn-down PDC holds no receiver credit claim
            active = active & ~s.quarantined
        with spans.span("policy.cc"):
            cc_st = cc_pol.on_grant_tick(cc_st, flow_dst, active, H)

        # --------------------------------------------------- 3. injection
        spans.phase("tick.3_injection")
        has_rtx = (rtx != 0).any(dim=-1)
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
        timeout_rod = bc["no_f"]
        if any_rod:
            with spans.span("pds.rod"):
                timeout_rod = (inflight > 0) & overdue
                if pdc_on:
                    timeout_rod = timeout_rod & ~s.quarantined
                rewind = rod_gbn | timeout_rod
                if mixed_rod:
                    rewind = rewind & rod_mask
                    timeout_rod = timeout_rod & rod_mask
                next_psn = torch.where(rewind, src_track.base, next_psn)
                inflight = torch.where(rewind, 0, inflight)
                last_progress = torch.where(rewind, tick, last_progress)
        with spans.span("policy.cc"):
            win_ok = cc_pol.on_send_gate(cc_st, inflight)
        if any_rod:
            # in-order CACK gate (ROD): the ordered window may not race
            # more than one congestion window past the cumulative ACK
            with spans.span("pds.rod"):
                with spans.span("policy.cc"):
                    rod_win = torch.floor(cc_pol.cwnd_view(cc_st, (B, F))
                                          ).to(I32).clamp(min=1)
                rod_ok = (next_psn - src_track.base) < rod_win
                win_ok = win_ok & (rod_ok | ~rod_mask)
        mp_ok = (next_psn - src_track.base) < p.mp_range
        can_new = (next_psn < wl.size) & mp_ok
        eligible = ((tick >= wl.start) & ~done & dep_ok & win_ok
                    & (has_rtx | can_new))
        if hosty:
            # frozen injectors: dead source hosts and stalled NICs
            eligible = eligible & ~inj_frozen
        if pdc_on:
            # a quarantined flow gets no retransmit bandwidth
            eligible = eligible & ~s.quarantined

        # fair per-host pick: per-tick pseudo-random rotation, flow id in
        # the low bits so exactly one winner exists per host
        rot = shr(_mix32(flow_ids * c32(2654435761) ^ c32(tick)), 16)
        key = rot * F + flow_ids
        key = torch.where(eligible, key, 2 ** 30)
        hot_host = flow_src[:, None, :] == hosts[:, None]      # [B, H, F]
        host_min = torch.where(hot_host, key[:, None, :], 2 ** 30).amin(
            dim=-1)
        injected = (eligible & (key == host_min.gather(-1, flow_src.long()))
                    & (key < 2 ** 30))

        rtx_off = _first_set_bit(rtx)
        rtx_psn = src_track.base + rtx_off
        use_rtx = injected & has_rtx & (rtx_off >= 0)
        psn_out = torch.where(use_rtx, rtx_psn, next_psn)

        with spans.span("policy.lb"):
            lbs2, ev_sel = lb_pol.select(lbs, psn_out, tick)
            if mixed_rod:
                # ROD lanes are pinned to their static single-path EV and
                # do not advance the spraying state
                ev_sel = torch.where(rod_mask, lb_pol.static_ev(lbs), ev_sel)
        inj_q = rt.injection_queue(flow_src, flow_dst, ev_sel)

        def commit_injection(injected, use_rtx, rtx, next_psn, lbs,
                             inflight, cc_st):
            """Sender-state commit for this tick's injections: here with
            CBFC off; with CBFC on after the section-7 credit gate,
            which may cancel an injection, and a cancelled one leaves no
            sender-state trace."""
            rtx = kops.clear_own_bit_(rtx, rtx_off, use_rtx)
            next_psn = torch.where(injected & ~use_rtx, next_psn + 1,
                                   next_psn)
            lbs = _where_rows(injected & ~rod_mask if mixed_rod
                              else injected, lbs2, lbs)
            if evict_on:
                # each flow's most recent EV: the path a later RTO
                # implicates (ROD lanes included, whose pinned EV skips
                # the commit above)
                lbs = replace(lbs, last_ev=torch.where(injected, ev_sel,
                                                       lbs.last_ev))
            inflight = inflight + injected.to(I32)
            with spans.span("policy.cc"):
                cc_st = cc_pol.on_inject(cc_st, injected)
            retransmits = s.retransmits + use_rtx.sum(dim=-1, dtype=I32)
            return rtx, next_psn, lbs, inflight, cc_st, retransmits

        if not cbfc:
            rtx, next_psn, lbs, inflight, cc_st, retransmits = \
                commit_injection(injected, use_rtx, rtx, next_psn, lbs,
                                 inflight, cc_st)

        # ------------------------------------------------- 4. forwarding
        spans.phase("tick.4_forwarding")
        nonempty = s.q_len > 0
        # `txq`: the queues whose head frame reaches the next hop this
        # tick; `leaves`: those whose head frame leaves its queue. With
        # the link layer off both are the nonempty queues.
        txq = nonempty
        if llr:
            # a queue mid-replay is re-sending its corrupted window at
            # the link layer: nothing reaches the next hop until then
            txq = txq & (tick >= s.llr_busy_until)
        leaves = txq
        llr_busy_until, llr_replays = s.llr_busy_until, s.llr_replays
        if corrupty:
            # per-transmission BER draw hashed from (seed, tick, queue),
            # a stream independent of the gray-link draw. Without LLR the
            # corrupted frame leaves its queue and dies on the wire (a
            # silent drop charged here); with LLR it stays at the head of
            # its queue for a replay window and is resent, delayed,
            # never dropped.
            with spans.span("tick.faults"):
                uc = _mix32(_mix32(c32(tick) ^ fault.seed[:, None]
                                   * c32(0x85EBCA77)) ^ queue_mix)
                corrupt_hit = txq & ult(uc, loss_threshold(fault.corrupt_p))
            txq = txq & ~corrupt_hit
            if llr:
                leaves = txq
                llr_busy_until = torch.where(corrupt_hit, tick + llr_rtt,
                                             s.llr_busy_until)
                llr_replays = llr_replays + corrupt_hit.sum(dim=-1,
                                                            dtype=I32)
        head_pkt = s.q_pkt.gather(
            2, s.q_head.long()[:, :, None, None].expand(B, Q, 1, PKT_FIELDS)
        )[:, :, 0]
        pf, pp, pe, pm, pt = (head_pkt[..., k].contiguous()
                              for k in range(PKT_FIELDS))
        # egress ECN marking: queue length at departure above threshold
        mark = txq & (s.q_len > p.ecn_threshold)
        pm = torch.where(mark, pm | META_ECN, pm)
        if not cbfc:
            # with CBFC the dequeue commit waits for the section-7 credit
            # gate, which can hold a head frame in place
            q_head = torch.where(leaves, (s.q_head + 1) % C, s.q_head)
            q_len = torch.where(leaves, s.q_len - 1, s.q_len)

        safe_pf = torch.where(nonempty, pf, 0).long()
        nq = rt.route_step(qidx, flow_src.gather(-1, safe_pf),
                           flow_dst.gather(-1, safe_pf), pe)
        deliver = txq & (nq == DELIVERED)
        if hosty:
            # packets dequeued toward a dead destination vanish at its
            # NIC (the dead-queue mask only eats enqueues): silent drops,
            # and no ACK
            dst_gone = deliver & dst_dead.gather(-1, safe_pf)
            deliver = deliver & ~dst_gone
        forward = txq & (nq >= 0)

        # --------------------------------------------- 5. delivery at FEPs
        spans.phase("tick.5_delivery")
        dtrim = deliver & ((pm & META_TRIMMED) != 0)
        ddata = deliver & ~dtrim
        # one host downlink per destination => at most one delivery per
        # flow per tick: densify to per-flow [B, F] values
        hot_d = ((pf[:, None, :] == flow_ids[:, None])
                 & ddata[:, None, :])                          # [B, F, Q]
        has_d = hot_d.any(dim=-1)
        d_psn = _pick(hot_d, pp)
        d_off = d_psn - s.dst_track.base               # uint32 wrap
        d_in_range = has_d & (d_off >= 0) & (d_off < mp)
        if any_rod:
            # the ROD receiver accepts only the next in-order PSN
            # (go-back-N): out-of-order arrivals are discarded and NACKed
            # with the first-gap PSN so the source rewinds at once
            with spans.span("pds.rod"):
                rod_rej_f = d_in_range & (d_off != 0)
                if mixed_rod:
                    rod_rej_f = rod_rej_f & rod_mask
                d_rec = d_in_range & ~rod_rej_f
        else:
            d_rec = d_in_range
        d_ring, d_base, _, d_already = kops.sack_advance_own(
            s.dst_track.ring, s.dst_track.base, d_off, d_rec)
        fresh_f = d_rec & ~d_already
        dst_track = pds.PSNTracker(
            base=d_base, ring=d_ring,
            rx_ok=s.dst_track.rx_ok + fresh_f.to(I32),
            dup=s.dst_track.dup + d_already.to(I32),
            oor=s.dst_track.oor + (has_d & ~d_in_range).to(I32),
        )
        if any_rod:
            with spans.span("pds.rod"):
                dups = s.dups + (has_d & ~fresh_f & ~rod_rej_f).sum(
                    dim=-1, dtype=I32)
                rod_rejects = s.rod_rejects + rod_rej_f.sum(dim=-1,
                                                            dtype=I32)
        else:
            dups = s.dups + (has_d & ~fresh_f).sum(dim=-1, dtype=I32)
            rod_rejects = s.rod_rejects
        delivered_ctr = s.delivered + fresh_f.to(I32)
        # flows whose packet reached its receiver this tick (trimmed or
        # not), as a scatter into flat rows b*F + flow, with a spare
        # discard row past every scenario's, instead of a [B, F, Q] pass
        seen = torch.zeros((B * F + 1,), dtype=torch.bool, device=dev)
        seen[torch.where(deliver, bc["flow0"] + pf, B * F).long()] = True
        with spans.span("policy.cc"):
            cc_st = cc_pol.on_rx_seen(cc_st, seen[:B * F].view(B, F))

        # ------------------------------------- 6. OOO-count loss inference
        spans.phase("tick.6_ooo")
        ooo_fire = bc["no_f"]
        if p.ooo_threshold > 0:
            dist = pds.ooo_distance(dst_track)
            ooo_fire = ((dist > p.ooo_threshold)
                        & ((tick - s.last_ooo_nack) > ooo_gap))
        last_ooo_nack = torch.where(ooo_fire, tick, s.last_ooo_nack)

        # ---------------------------------- 6b. in-network reduction (INC)
        # forwarded packets about to enter their destination host
        # downlink that belong to a reduction group meet the ToR's
        # accumulator: all but the bitmap-completing child are absorbed
        # (ACKed at the switch, out of the enqueue set); the completing
        # child forwards as the aggregate
        inc_st = s.inc
        inc_reduced, inc_emits = s.inc_reduced, s.inc_emits
        if inc_on:
            spans.phase("tick.6b_inc")
            member, grank, gsz = inc_members(wl)
            into_host = (forward & (rt.stage[nq.clamp(0, Q - 1).long()]
                                    == int(Stage.HOST))
                         & ((pm & META_TRIMMED) == 0))
            inc_st, inc_absorb, inc_emit = inc.process(
                inc_st, lane_flow=safe_pf, lane_psn=pp, lane_cand=into_host,
                member=member, rank=grank, gsz=gsz, red=wl.red,
                has_delivery=has_d)
            inc_reduced = inc_reduced + inc_absorb.sum(dim=-1, dtype=I32)
            inc_emits = inc_emits + inc_emit.sum(dim=-1, dtype=I32)
            forward = forward & ~inc_absorb

        # ------------------------------------------------- 7. enqueue phase
        spans.phase("tick.7_enqueue")
        # candidates: forwarded packets (Q lanes, minus INC absorptions)
        # + injections (F lanes)
        cand_q = torch.cat([torch.where(forward, nq, -1),
                            torch.where(injected, inj_q, -1)], dim=-1)
        cand_flow = torch.cat([pf, bc["flow_ids"]], dim=-1)
        cand_psn = torch.cat([pp, psn_out], dim=-1)
        cand_ev = torch.cat([pe, ev_sel], dim=-1)
        cand_meta = torch.cat([pm, zeros_f], dim=-1)
        cand_ts = torch.cat([pt, torch.full((B, F), tick, **i32)], dim=-1)
        cvalid = cand_q >= 0
        safe_cq = torch.where(cvalid, cand_q, 0).long()
        # failed links (outage window): packets routed into them vanish
        is_dead = dead.gather(-1, safe_cq) & cvalid
        cvalid = cvalid & ~is_dead
        if lossy:
            # gray links: a counter-hash draw per (seed, tick, enqueue
            # lane), compared unsigned with the lane's target threshold
            with spans.span("tick.faults"):
                u = _mix32(_mix32(c32(tick) ^ fault.seed[:, None]
                                  * c32(0x9E3779B1)) ^ lane_mix)
                is_lost = cvalid & ult(u, loss_threshold(fault.loss_p)
                                       .gather(-1, safe_cq))
            cvalid = cvalid & ~is_lost
        credit_stall_ticks = s.credit_stall_ticks
        if cbfc:
            # CBFC credit gate: available = capacity - (consumed - freed)
            # over 20-bit cyclic counters, `freed` lagging the dequeues
            # by the credit-return delay. A candidate past its target's
            # credited space is back-pressured in place: a forwarded
            # frame stays in its upstream queue (its dequeue is
            # cancelled) and an injection waits at the NIC (the deferred
            # commit). Deliveries, absorptions and dead / gray-eaten
            # candidates are no enqueues and bypass the gate. The stalled
            # lanes are each target's rank suffix, so the survivors'
            # ranks, and hence their positions, are unchanged.
            arriving = s.cbfc_ret[:, tick % Rd]
            freed_now = (s.cbfc_freed + arriving) & mask20
            avail = C - ((s.cbfc_consumed - freed_now) & mask20)
            crank, _, _ = kops.enqueue_rank(cand_q, cvalid, bc["zeros_q"],
                                            C)
            stall = cvalid & (crank >= avail.gather(-1, safe_cq))
            cvalid = cvalid & ~stall
            dequeued = leaves & ~stall[:, :Q]
            q_head = torch.where(dequeued, (s.q_head + 1) % C, s.q_head)
            q_len = torch.where(dequeued, s.q_len - 1, s.q_len)
            injected = injected & ~stall[:, Q:]
            use_rtx = use_rtx & ~stall[:, Q:]
            rtx, next_psn, lbs, inflight, cc_st, retransmits = \
                commit_injection(injected, use_rtx, rtx, next_psn, lbs,
                                 inflight, cc_st)
            credit_stall_ticks = credit_stall_ticks + stall.any(dim=-1).to(I32)
        pos, added, fits = kops.enqueue_rank(cand_q, cvalid, q_len, C)
        overflow = cvalid & ~fits

        wslot = (q_head.gather(-1, safe_cq) + pos) % C
        # JAX drops the scatter rows of packets that do not fit; here
        # they go to a spare discard record past every scenario's queues,
        # and scenario b's records start at b*Q*C
        dst_rec = torch.where(fits, bc["rec0"] + cand_q * C + wslot,
                              B * Q * C).long()
        cand_pkt = torch.stack(
            [cand_flow, cand_psn, cand_ev, cand_meta, cand_ts], dim=-1)
        q_flat = torch.cat([s.q_pkt.reshape(B * Q * C, PKT_FIELDS),
                            cand_pkt.new_zeros((1, PKT_FIELDS))])
        q_flat[dst_rec.reshape(-1)] = cand_pkt.reshape(-1, PKT_FIELDS)
        q_pkt = q_flat[:B * Q * C].view(B, Q, C, PKT_FIELDS)
        q_len = q_len + added
        cbfc_consumed, cbfc_freed, cbfc_ret = \
            s.cbfc_consumed, s.cbfc_freed, s.cbfc_ret
        if cbfc:
            # commit the cyclic counters: enqueues consume; this tick's
            # dequeues become the credit update that reaches the senders
            # `credit_return_ticks` later (the slot just read as
            # `arriving` is exactly Rd ticks old: overwrite it)
            cbfc_consumed = (s.cbfc_consumed + added) & mask20
            cbfc_freed = freed_now
            cbfc_ret = s.cbfc_ret.clone()
            cbfc_ret[:, tick % Rd] = dequeued.to(I32)

        # overflow: trim (fast NACK via control TC) or drop
        n_over = overflow.sum(dim=-1, dtype=I32)
        if p.trimming:
            trims, drops, nack_mask = s.trims + n_over, s.drops, overflow
        else:
            trims, drops = s.trims, s.drops + n_over
            nack_mask = torch.zeros_like(overflow)
        # failed and gray links drop silently: no trim header, no NACK
        drops = drops + is_dead.sum(dim=-1, dtype=I32)
        if lossy:
            drops = drops + is_lost.sum(dim=-1, dtype=I32)
        if corrupty and not llr:
            # corruption without link-layer replay: a silent drop
            # charged at the transmitting hop
            drops = drops + corrupt_hit.sum(dim=-1, dtype=I32)
        if hosty:
            drops = drops + dst_gone.sum(dim=-1, dtype=I32)

        # ------------------------------------------- 8. schedule control TC
        spans.phase("tick.8_control_tc")
        out_slot = (tick + p.ack_return_ticks) % D
        # lanes [0, Q): ACKs from deliveries and from INC absorptions
        # (the switch ACKs an absorbed child as a delivery would; a ROD
        # reject becomes an OOO NACK carrying the receiver's first-gap
        # PSN); [Q, 2Q+F): trim NACKs from enqueue overflow; [2Q+F,
        # 2Q+2F): OOO NACKs (psn = first gap)
        ack_like = (ddata | inc_absorb) if inc_on else ddata
        ack_lane_t = ack_like.to(I32) * EV_ACK
        ack_lane_psn = pp
        if any_rod:
            with spans.span("pds.rod"):
                rod_rej_lane = ddata & rod_rej_f.gather(-1, safe_pf)
                ack_lane_t = torch.where(rod_rej_lane, EV_OOO, ack_lane_t)
                ack_lane_psn = torch.where(
                    rod_rej_lane, dst_track.base.gather(-1, safe_pf), pp)
        new_type = torch.cat([ack_lane_t, nack_mask.to(I32) * EV_NACK,
                              ooo_fire.to(I32) * EV_OOO], dim=-1)
        new_flow = torch.cat([safe_pf.to(I32), cand_flow, bc["flow_ids"]],
                             dim=-1)
        new_psn = torch.cat([ack_lane_psn, cand_psn, dst_track.base], dim=-1)
        new_val = torch.cat([pe, cand_ev, zeros_f], dim=-1)
        new_ecn = torch.cat([((pm & META_ECN) != 0).to(I32), bc["zeros_qf"],
                             zeros_f], dim=-1)
        new_ts = torch.cat([pt, cand_ts, zeros_f], dim=-1)
        ev_buf[:, out_slot] = torch.stack(
            [new_type, new_flow, new_psn, new_val, new_ecn, new_ts], dim=-1)

        # ------------------------------------------------- 9. timeouts + QA
        spans.phase("tick.9_timeouts")
        timeout_fire = timeout_rod  # ROD rewinds already count as expiries
        if not all_rod:
            # sent-but-unacked PSNs with nothing in flight still need the
            # RTO (a silent loss can drain inflight to 0 with gaps open)
            unacked = src_track.base < next_psn
            stalled = ((inflight > 0) | unacked) & overdue & ~done
            if hosty:
                # a dead endpoint arms the RTO itself (a frozen source
                # never sends, so `unacked` cannot), so strikes accrue
                # and the teardown fires; NIC stalls are excluded
                stalled = stalled | ((src_dead | dst_dead) & overdue
                                     & ~done)
            if pdc_on:
                # a torn-down PDC stops timing out (and striking)
                stalled = stalled & ~s.quarantined
            if mixed_rod:
                stalled = stalled & ~rod_mask  # ROD timeouts rewind instead
            # offset 0 == oldest unacked
            rtx = kops.set_own_bit_(rtx, zeros_f, stalled)
            # a timeout implies the outstanding packets are gone: reopen
            # the window
            inflight = torch.where(stalled, 0, inflight)
            last_progress = torch.where(stalled, tick, last_progress)
            with spans.span("policy.cc"):
                cc_st = cc_pol.on_timeout(cc_st, stalled)
            timeout_fire = timeout_fire | stalled
        with spans.span("policy.cc"):
            cc_st = cc_pol.end_of_tick(cc_st, tick)

        # ---------------------------------------- 10. recovery loop lanes
        spans.phase("tick.10_recovery")
        if backoff_on:
            # exponential backoff on expiry: an f32 multiply, truncated
            # to int32 as XLA's convert does, capped
            rto = torch.where(
                timeout_fire,
                torch.clamp((rto.to(torch.float32) * backoff).to(I32),
                            max=rto_cap),
                rto)
        ev_evictions = s.ev_evictions
        if evict_on:
            # a trim NACK implicates the EV it carries (any scheme); an
            # RTO the flow's last EV, only where selection is pinned
            # (STATIC, incl. the all-ROD pin, and ROD lanes of mixed
            # profiles): a sprayed lane's last EV is just its last draw
            if lb_pol.scheme == LBScheme.STATIC:
                timeout_evict = timeout_fire
            elif mixed_rod:
                timeout_evict = timeout_fire & rod_mask
            else:
                timeout_evict = bc["no_f"]
            evict_ev = torch.where(nack_evict, nack_ev, lbs.last_ev)
            evict_valid = (nack_evict | timeout_evict) & (evict_ev >= 0)
            with spans.span("policy.lb"):
                lbs = lb_pol.evict(lbs, evict_ev, evict_valid)
            ev_evictions = ev_evictions + evict_valid.sum(dim=-1, dtype=I32)
        timeouts = s.timeouts + timeout_fire.sum(dim=-1, dtype=I32)
        ticks_degraded = s.ticks_degraded + dead.any(dim=-1).to(I32)
        rto_strikes, quarantined = s.rto_strikes, s.quarantined
        flows_abandoned = s.flows_abandoned
        ticks_unreachable = s.ticks_unreachable
        if pdc_on:
            # PDC liveness teardown: consecutive zero-progress RTOs are
            # strikes (any ACK resets them); at pdc_dead_after the flow
            # is quarantined: no retransmit bandwidth, no more expiries,
            # settled for quiescence. Its dependents can never start, so
            # the dependency chain collapses one hop per tick.
            rto_strikes = (torch.where(has_ack, 0, s.rto_strikes)
                           + timeout_fire.to(I32))
            live = ~s.quarantined & ~done
            newly = live & (unreachable(rto_strikes, profile.pdc_dead_after)
                            | ((wl.dep >= 0)
                               & s.quarantined.gather(-1, safe_dep)))
            quarantined = s.quarantined | newly
            inflight = torch.where(quarantined, 0, inflight)
            flows_abandoned = flows_abandoned + newly.sum(dim=-1, dtype=I32)
            ticks_unreachable = (ticks_unreachable
                                 + quarantined.any(dim=-1).to(I32))

        ns = SimState(
            q_pkt=q_pkt, q_head=q_head, q_len=q_len,
            next_psn=next_psn, inflight=inflight, src_track=src_track,
            rtx=rtx, last_progress=last_progress,
            slot_last_ack=slot_last_ack, dst_track=dst_track,
            last_ooo_nack=last_ooo_nack, cc=cc_st, lb=lbs, ev_buf=ev_buf,
            inc=inc_st, delivered=delivered_ctr, trims=trims, drops=drops,
            dups=dups, inc_reduced=inc_reduced, inc_emits=inc_emits,
            rod_rejects=rod_rejects, retransmits=retransmits, rto=rto,
            timeouts=timeouts, ev_evictions=ev_evictions,
            ticks_degraded=ticks_degraded, rto_strikes=rto_strikes,
            quarantined=quarantined, flows_abandoned=flows_abandoned,
            ticks_unreachable=ticks_unreachable,
            llr_busy_until=llr_busy_until, llr_replays=llr_replays,
            cbfc_consumed=cbfc_consumed, cbfc_freed=cbfc_freed,
            cbfc_ret=cbfc_ret, credit_stall_ticks=credit_stall_ticks,
        )
        out = {
            "delivered": fresh_f.to(I32),
            "cwnd": cc_pol.cwnd_view(cc_st, (B, F)),
            "qlen_max": q_len.amax(dim=-1),
            "rx_base": dst_track.base,
            "src_base": src_track.base,
        }
        if tel_on:
            # telemetry probe off lanes the tick already has. Trim vs
            # silent drop follows the transport's split (a no-trim
            # profile drops overflow); dead and gray losses are silent
            # drops. Each event lane counts at its target queue, found
            # in safe_cq (the events are subsets of the candidates).
            if p.trimming:
                trim_ev, drop_ev = overflow, is_dead
            else:
                trim_ev, drop_ev = None, is_dead | overflow
            if lossy:
                drop_ev = drop_ev | is_lost
            probe = {"rtt": rtt, "has_rtt": has_ack, "cwnd": out["cwnd"]}
            if tel.queues:
                probe["cnt"] = telem.queue_events(
                    bc["tel_rows"], Q, mark, safe_cq, drop_ev, trim_ev,
                    stall=stall if cbfc else None,
                    # unrecovered corruption is charged at the
                    # transmitting queue; under LLR it is a replay
                    tx_drop=corrupt_hit if corrupty and not llr else None,
                    llr=corrupt_hit if corrupty and llr else None)
            out["probe"] = probe
        spans.phase(None)
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
    stat_abandon_tick: "int | None" = None  # first teardown tick or -1
    #: the probe lanes' time series (``telemetry=TelemetrySpec.on()``)
    telemetry: "telem.FabricTrace | None" = None

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

    def source_completion_tick(self) -> int:
        """Tick by which every flow source-completed; -1 if any did not."""
        ct = self.source_completion_ticks()
        return -1 if bool((ct < 0).any()) else int(ct.max())

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
        """Silent drops: dead-link, gray-link, corruption without LLR and
        (no-trim profiles) overflow losses."""
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
    def ev_evictions(self) -> int:
        """Path (EV) evictions by the recovery loop (0 unless the profile
        sets ``ev_eviction``)."""
        return int(self.state.ev_evictions)

    @property
    def ticks_degraded(self) -> int:
        """Executed ticks during which at least one link or host was
        dead."""
        return int(self.state.ticks_degraded)

    @property
    def flows_abandoned(self) -> int:
        """Flows whose PDC was declared unreachable and torn down (0
        unless the profile sets ``pdc_dead_after``)."""
        return int(self.state.flows_abandoned)

    @property
    def ticks_unreachable(self) -> int:
        """Executed ticks during which at least one flow sat
        quarantined."""
        return int(self.state.ticks_unreachable)

    @property
    def llr_replays(self) -> int:
        """Frames corrupted on a BER lane and replayed at the hop by
        link-level retry (0 unless the run had ``link=LinkConfig(
        llr=True)``)."""
        return int(self.state.llr_replays)

    @property
    def credit_stall_ticks(self) -> int:
        """Executed ticks on which at least one enqueue was
        back-pressured by CBFC credit exhaustion (0 unless
        ``link=LinkConfig(cbfc=True)``)."""
        return int(self.state.credit_stall_ticks)

    @property
    def abandon_tick(self) -> int:
        """First tick at which any PDC teardown fired (-1 = none);
        streamed on the ``trace="stats"`` tier only."""
        if self.stat_abandon_tick is None:
            raise ValueError(
                "abandon_tick is streamed on the trace='stats' tier "
                "only; rerun with trace='stats'")
        return int(self.stat_abandon_tick)


# --------------------------------------------------------------------------
# driver: chunked host loop
# --------------------------------------------------------------------------

#: group ticks the chunk loops issued, and those of them under the
#: masked body (a chunk after some scenario stopped): plain ints, counted
#: once a chunk
DRIVER_COUNTS = {"ticks": 0, "masked_ticks": 0}
#: the finished sweeps' transport work, summed over their lanes from the
#: final states' counters (plain ints, added once a sweep by
#: ``_results``): data packets that reached their receiver (fresh,
#: duplicate or ROD-rejected), the duplicates and the ROD rejects among
#: them, and the packets trimmed on queue overflow
TRANSPORT_COUNTS = {"arrivals": 0, "dups": 0, "rod_rejects": 0, "trims": 0}


def reset_driver_counts() -> None:
    for counts in (DRIVER_COUNTS, TRANSPORT_COUNTS):
        for k in counts:
            counts[k] = 0


def _count_transport(s: SimState) -> None:
    """Add a finished loop's lane sums to ``TRANSPORT_COUNTS``, in one
    copy to the host after the loop has ended."""
    dups, rej, trims, fresh = (x.sum(dtype=torch.int64) for x in (
        s.dups, s.rod_rejects, s.trims, s.delivered))
    sums = torch.stack([fresh + dups + rej, dups, rej, trims]).tolist()
    for k, v in zip(("arrivals", "dups", "rod_rejects", "trims"), sums):
        TRANSPORT_COUNTS[k] += v


def _quiescent(s: SimState, wl: Workload) -> torch.Tensor:
    """Per-scenario quiescence ([B] bool): every source CACK-complete or
    quarantined (a torn-down PDC can make no progress), nothing
    inflight, all queues empty and the control-TC ring drained. Once it
    holds no later tick can make protocol progress."""
    done = ((s.src_track.base >= wl.size) | s.quarantined).all(dim=-1)
    idle = (s.inflight == 0).all(dim=-1) & (s.q_len == 0).all(dim=-1)
    drained = (s.ev_buf[..., EVF_TYPE] == EV_NONE).flatten(1).all(dim=-1)
    return done & idle & drained


def _stats_init(B: int, F: int, device) -> dict:
    i32 = dict(dtype=I32, device=device)
    return {"comp": torch.full((B, F), -1, **i32),
            "src_comp": torch.full((B, F), -1, **i32),
            "win_delivered": torch.zeros((B, F), **i32),
            "qlen_peak": torch.zeros((B,), **i32),
            "abandon_tick": torch.full((B,), -1, **i32)}


def _stats_update(st: dict, prev: SimState, s: SimState, wl: Workload,
                  tick: int, w0: int, w1: int) -> dict:
    """The streamed trace="stats" lanes: elementwise [B, F] updates off
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
        "qlen_peak": torch.maximum(st["qlen_peak"], s.q_len.amax(dim=-1)),
        # first tick any PDC teardown fired (-1: none)
        "abandon_tick": torch.where(
            (st["abandon_tick"] < 0) & (s.flows_abandoned > 0), tick,
            st["abandon_tick"]),
    }


_FULL_LANES = ("delivered", "cwnd", "qlen_max", "rx_base", "src_base")


def _chunk_to_host(outs: "list[dict]", quiet: torch.Tensor):
    """Stack one chunk's per-tick out lanes and copy them, with the [B]
    quiescence flags, to the host in ONE transfer (the chunk's only
    sync). Returns ({lane: np array [T, B, ...]}, quiet [B] bool)."""
    T = len(outs)
    parts = []
    for k in _FULL_LANES:
        a = torch.stack([o[k] for o in outs])
        parts.append((a.view(I32) if a.dtype == torch.float32 else a)
                     .reshape(-1))
    host = torch.cat(parts + [quiet.to(I32)]).cpu().numpy()
    lanes, at = {}, 0
    for k in _FULL_LANES:
        shape = (T,) + tuple(outs[0][k].shape)
        n = int(np.prod(shape))
        lanes[k] = host[at:at + n].reshape(shape)
        at += n
    lanes["cwnd"] = lanes["cwnd"].view(np.float32)
    lanes["rx_base"] = lanes["rx_base"].view(np.uint32)
    lanes["src_base"] = lanes["src_base"].view(np.uint32)
    return lanes, host[at:].astype(bool)


class ChunkLoop:
    """The chunked driver of B scenarios on one device, one chunk at a
    time: :meth:`issue` queues the next chunk's ticks without waiting
    for the device, :meth:`collect` reads the chunk's [B] quiescence
    flags (its one sync with the host) and stops the scenarios that are
    done. :meth:`run` alternates the two; the sharded driver
    (``repro_torch.network.shard``) issues a chunk on every shard before
    it collects any.

    Each scenario stops at the first chunk boundary where it is
    quiescent, or at the budget. A chunk in which no scenario has
    stopped runs the tick as it is; a chunk after some scenario stopped
    runs the masked body, which keeps a stopped scenario's whole state
    and stat lanes (the probe rings included) frozen at its own
    boundary (a select per lane, bitwise what the unmasked tick gives
    the others). ``tel`` (an enabled :class:`TelemetrySpec`, stats tier
    only) adds the probe carry ``st["tel"]``.
    """

    def __init__(self, step, s: SimState, wl: Workload,
                 fault: FaultSchedule, budget: int, chunk: int, trace: str,
                 w0: int = 0, w1: int = 0, tick0: int = 0,
                 tel: "TelemetrySpec | None" = None):
        B, F = (int(d) for d in wl.src.shape)
        dev = wl.src.device
        self.step, self.s, self.wl, self.fault = step, s, wl, fault
        self.budget, self.chunk, self.w0, self.w1 = budget, chunk, w0, w1
        self.tick0 = tick0
        self.st = _stats_init(B, F, dev) if trace == "stats" else None
        self.tel_up = None
        if tel is not None and tel.enabled:
            if self.st is None:
                raise ValueError("telemetry lanes ride the streaming stats "
                                 "carry — enabled TelemetrySpec requires "
                                 "trace='stats'")
            Q = int(s.q_len.shape[1])
            self.st["tel"] = telem.create(tel, B, Q, F, dev)
            self.tel_up = telem.make_update(tel, Q, F, dev)
        self.stop = np.full((B,), budget <= tick0)
        self.horizon = np.where(self.stop, min(tick0, budget),
                                -1).astype(np.int64)
        self.chunks: list = []
        self._quiet = self._outs = None

    @property
    def done(self) -> bool:
        return bool(self.stop.all())

    def issue(self) -> None:
        """Queue the next chunk's ticks on the device."""
        with spans.span("driver.issue"):
            s, st, wl, fault = self.s, self.st, self.wl, self.fault
            live = (torch.as_tensor(~self.stop, device=wl.src.device)
                    if self.stop.any() else None)
            ticks = range(self.tick0, min(self.tick0 + self.chunk,
                                          self.budget))
            DRIVER_COUNTS["ticks"] += len(ticks)
            if live is not None:
                DRIVER_COUNTS["masked_ticks"] += len(ticks)
            outs = []
            for tick in ticks:
                with spans.span("tick"):
                    ns, out = self.step(s, tick, wl, fault)
                if st is not None:
                    with spans.span("driver.stats"):
                        nst = _stats_update(st, s, ns, wl, tick, self.w0,
                                            self.w1)
                        if self.tel_up is not None:
                            nst["tel"] = self.tel_up(st["tel"], ns,
                                                     out["probe"], tick)
                    if live is None:
                        st = nst
                    else:
                        with spans.span("driver.mask"):
                            st = _where_rows(live, nst, st)
                else:
                    outs.append(out)
                if live is None:
                    s = ns
                else:
                    with spans.span("driver.mask"):
                        s = _where_rows(live, ns, s)
            self.s, self.st = s, st
            self.tick0 += self.chunk
            self._quiet, self._outs = _quiescent(s, wl), outs

    def collect(self) -> None:
        """Read the issued chunk's quiescence flags (and, on the full
        tier, its out lanes) and stop the scenarios that are done."""
        with spans.span("driver.collect"):
            if self.st is not None:
                quiet = self._quiet.cpu().numpy()
            else:
                lanes, quiet = _chunk_to_host(self._outs, self._quiet)
                self.chunks.append(lanes)
        self._quiet = self._outs = None
        nstop = self.stop | quiet | (self.tick0 >= self.budget)
        self.horizon[nstop & ~self.stop] = min(self.tick0, self.budget)
        self.stop = nstop

    def run(self) -> "ChunkLoop":
        """Issue and collect chunks until every scenario has stopped."""
        while not self.done:
            self.issue()
            self.collect()
        return self


def run_chunks(step, s: SimState, wl: Workload, fault: FaultSchedule,
               budget: int, chunk: int, trace: str, w0: int = 0,
               w1: int = 0, tick0: int = 0,
               tel: "TelemetrySpec | None" = None):
    """Drive ``step`` over B scenarios from tick ``tick0`` in
    ``chunk``-tick chunks (:class:`ChunkLoop`) until every scenario has
    stopped. Ticks at or past the budget do not run. Returns (final
    state, stats lanes or None, host out lanes per chunk, horizon [B]
    int64: each scenario's stop boundary, clamped to the budget)."""
    loop = ChunkLoop(step, s, wl, fault, budget, chunk, trace, w0, w1,
                     tick0, tel).run()
    return loop.s, loop.st, loop.chunks, loop.horizon


def _results(loop: ChunkLoop, sizes: np.ndarray, budget: int, trace: str,
             goodput_window,
             tel: "TelemetrySpec | None" = None) -> "list[SimResult]":
    """One SimResult per scenario of a finished chunk loop: its own state
    lanes (views of the batch's), horizon and stat or trace lanes, and
    its probe lanes' :class:`~repro_torch.network.telemetry.FabricTrace`."""
    with spans.span("driver.results"):
        s, st, chunks, horizon = loop.s, loop.st, loop.chunks, loop.horizon
        B, F = sizes.shape
        _count_transport(s)
        if trace == "stats":
            host = {k: v.cpu().numpy() for k, v in st.items() if k != "tel"}
            traces = [None] * B
            if tel is not None:
                Q = int(s.q_len.shape[1])
                th = {k: v.cpu().numpy() for k, v in st["tel"].items()}
                traces = [telem.FabricTrace.from_lanes(
                    tel, telem.lanes(tel, Q, F,
                                     {k: v[b] for k, v in th.items()}),
                    int(horizon[b])) for b in range(B)]
            return [SimResult(
                state=take_lane(s, b), msg_size=sizes[b],
                horizon=int(horizon[b]), max_ticks=budget, trace="stats",
                stat_completion=host["comp"][b],
                stat_src_completion=host["src_comp"][b],
                stat_win_delivered=host["win_delivered"][b],
                goodput_window=(None if goodput_window is None
                                else tuple(int(w) for w in goodput_window)),
                qlen_peak=int(host["qlen_peak"][b]),
                stat_abandon_tick=int(host["abandon_tick"][b]),
                telemetry=traces[b])
                for b in range(B)]
        if chunks:
            full = {k: np.concatenate([c[k] for c in chunks])
                    for k in _FULL_LANES}
        else:      # a zero budget runs no tick
            empty = {"delivered": (np.int32, (F,)), "cwnd": (np.float32, (F,)),
                     "qlen_max": (np.int32, ()), "rx_base": (np.uint32, (F,)),
                     "src_base": (np.uint32, (F,))}
            full = {k: np.zeros((0, B) + shp, dt) for k, (dt, shp) in
                    empty.items()}
        out = []
        for b in range(B):
            h = int(horizon[b])
            lane = {k: np.ascontiguousarray(v[:h, b]) for k, v in full.items()}
            out.append(SimResult(
                state=take_lane(s, b), msg_size=sizes[b], horizon=h,
                max_ticks=budget, trace="full",
                delivered_per_tick=lane["delivered"],
                cwnd_per_tick=lane["cwnd"], qlen_max=lane["qlen_max"],
                rx_base_per_tick=lane["rx_base"],
                src_base_per_tick=lane["src_base"]))
        return out


def _group_loop(g: QueueGraph, wls: Workload, profile: TransportProfile,
                p: SimParams, fault: FaultSchedule, seeds, trace: str,
                budget: int, goodput_window, dev: torch.device, link=None,
                tel=None, statics: "dict | None" = None) -> ChunkLoop:
    """The chunk loop of B scenarios of one (graph, profile) group on
    ``dev``, from tick 0. The fault statics of the tick are the
    schedule's (``statics`` overrides them with a whole batch's, for a
    shard of it)."""
    with spans.span("driver.build"):
        F = int(wls.src.shape[1])
        wls = wls.to(dev)
        if statics is None:
            statics = fault_statics(fault)
        step = make_step(g, profile, p, F, tel=tel, link=link, device=dev,
                         **statics)
        s0 = init_state(g, wls, profile, p, seeds, device=dev, link=link)
        w0, w1 = (0, budget) if goodput_window is None else map(int,
                                                                goodput_window)
        return ChunkLoop(step, s0, wls, fault.to(dev), budget, p.chunk_ticks,
                         trace, w0, w1, tel=tel)


def fault_statics(fault: FaultSchedule) -> dict:
    """The tick's fault statics of a schedule: its fault classes."""
    return {"lossy": fault.has_loss, "hosty": fault.has_host_faults,
            "corrupty": fault.has_corruption}


def _run_batch(g: QueueGraph, wls: Workload, profile: TransportProfile,
               p: SimParams, fault: FaultSchedule, seeds: np.ndarray,
               trace: str, budget: int, goodput_window,
               dev: torch.device, link=None, tel=None,
               devs: "tuple | None" = None) -> "list[SimResult]":
    """One (graph, profile) group: B scenarios through one tick, or
    split over ``devs`` (``shard.run_sharded``)."""
    profile.delivery_modes(int(wls.src.shape[1]))  # validate tuples early
    if devs is not None:
        from repro_torch.network import shard
        return shard.run_sharded(g, wls, profile, p, fault, seeds, trace,
                                 budget, goodput_window, devs, tel=tel,
                                 link=link)
    loop = _group_loop(g, wls, profile, p, fault, seeds, trace, budget,
                       goodput_window, dev, link, tel).run()
    return _results(loop, wls.size.cpu().numpy(), budget, trace,
                    goodput_window, tel)


def _normalize_call(profile, p):
    """The public (profile, params) pair as the engine takes it, as the
    reference's ``_normalize_call`` does: the pre-profile form
    ``simulate(g, wl, SimParams(...))`` warns and runs ``ai_full()``;
    ``None`` means ``ai_full()`` / ``SimParams()``."""
    if isinstance(profile, SimParams):
        if p is not None:
            raise TypeError("got SimParams in the profile position AND a "
                            "params argument — pass (profile, params)")
        warnings.warn(
            "simulate(g, wl, SimParams(...)) is deprecated: pass the "
            "transport composition explicitly — "
            "simulate(g, wl, TransportProfile.ai_full(), SimParams(...))",
            DeprecationWarning, stacklevel=3)
        return TransportProfile.ai_full(), profile
    return (TransportProfile.ai_full() if profile is None else profile,
            SimParams() if p is None else p)


def simulate(g: QueueGraph, wl: Workload,
             profile: "TransportProfile | SimParams | None" = None,
             p: "SimParams | None" = None, *, seed: int = DEFAULT_SEED,
             failed=None, faults: "FaultSchedule | None" = None,
             trace: str = "stats", max_ticks: "int | None" = None,
             goodput_window: "tuple[int, int] | None" = None,
             telemetry=None, link=None, device=None) -> SimResult:
    """Run one scenario for at most ``max_ticks`` (default p.ticks),
    exiting at the first chunk boundary where it is quiescent: the B = 1
    case of :func:`simulate_batch`, through the same tick.

    profile: the transport composition (defaults to ai_full()); a
             SimParams here takes the deprecated pre-profile form (warns,
             runs ai_full()).
    failed:  queue ids or a [Q] bool mask of dead links; ``faults``: a
             [Q] :class:`FaultSchedule` (link flaps, gray links, PHY
             corruption, host deaths and NIC stalls; mutually exclusive
             with ``failed``).
    trace:   "stats" (streamed stat lanes) or "full" (dense per-tick
             lanes, copied to the host once per chunk).
    link:    a :class:`LinkConfig` (LLR replay, CBFC credits); None or
             ``LinkConfig.off()`` run the pre-link-layer tick.
    telemetry: a :class:`~repro_torch.network.telemetry.TelemetrySpec`
             (a static of the tick); an enabled spec streams the probe
             lanes into decimated rings in the stats carry and attaches
             their :class:`~repro_torch.network.telemetry.FabricTrace` as
             ``result.telemetry``. None or the off spec: no probe.
    device:  where the run lives: ``cuda`` unless given (``"cpu"`` runs
             the plain PyTorch path, as the tests do).
    """
    profile, p = _normalize_call(profile, p)
    if wl.src.dim() != 1:
        raise ValueError(f"simulate runs one [F] workload, got "
                         f"{tuple(wl.src.shape)}; use simulate_batch")
    if faults is not None and isinstance(faults, FaultSchedule) \
            and faults.fail_at.dim() != 1:
        raise ValueError(f"serial simulate() takes a [Q] fault schedule, "
                         f"got {tuple(faults.fail_at.shape)}")
    if failed is not None:
        failed = failed_to_mask(g.num_queues, failed)
    return simulate_batch(
        g, Workload.stack([wl]), profile, p, failed=failed, faults=faults,
        seeds=[seed], trace=trace, max_ticks=max_ticks,
        goodput_window=goodput_window, telemetry=telemetry, link=link,
        device=device)[0]


def simulate_batch(g, wls, profile=None, p: "SimParams | None" = None, *,
                   failed=None, faults=None, seeds=None,
                   trace: str = "stats", max_ticks: "int | None" = None,
                   goodput_window: "tuple[int, int] | None" = None,
                   shard: bool = False, devices=None, telemetry=None,
                   link=None, device=None) -> "list[SimResult]":
    """Run B scenarios through one tick with an explicit [B] lane axis;
    one SimResult per scenario, bitwise what B ``simulate`` calls give.

    g:       one QueueGraph for every scenario, or a length-B list of
             per-scenario graphs (grouped by graph and profile).
    wls:     a [B, F] Workload (``Workload.stack``) or a list of same-F
             Workloads.
    profile: one TransportProfile, or a length-B list of per-scenario
             profiles. Scenarios are grouped by (graph, profile); the
             groups run one after another on the device and the results
             come back in scenario order.
    failed:  a [B, Q] bool mask, one [Q] mask, or queue ids (broadcast);
    faults:  a [B, Q] / [B, H] or [Q] / [H] (broadcast)
             :class:`FaultSchedule`. Mutually exclusive; with
             per-scenario graphs of different queue counts, neither may
             be given. The schedule decides the fault statics of each
             (graph, profile) group's tick.
    seeds:   [B] per-scenario LB/EV seeds (default DEFAULT_SEED each).
    trace / max_ticks / goodput_window: as in :func:`simulate`. Each
             scenario stops at its own chunk boundary; a group runs
             until its slowest scenario stops.
    link:    one :class:`LinkConfig` for the whole batch (a static of
             the tick); None or ``LinkConfig.off()``: no link layer.
    shard / devices: split the scenario axis across devices of the run's
             kind (``repro_torch.network.shard``): ``shard=True`` takes
             every one, ``devices=`` an int (the first n) or a sequence
             of devices. Each (graph, profile) group is split; ragged
             groups are padded with inert lanes, dropped from the
             results. One device (a CPU run) is the unsharded path.
             Per-lane results are bitwise the unsharded ones.
    telemetry: one :class:`~repro_torch.network.telemetry.TelemetrySpec`
             for the whole batch, as in :func:`simulate`; each scenario
             gets its own rings and ``result.telemetry``.
    device:  ``cuda`` unless given (``"cpu"``: the plain PyTorch path).
    """
    dev = resolve_device(device)
    devs = None
    if shard or devices is not None:
        from repro_torch.network.shard import resolve_devices
        devs = resolve_devices(devices, shard, dev)
    if isinstance(wls, (list, tuple)):
        wls = Workload.stack(wls)
    graphs = None
    if isinstance(g, (list, tuple)):
        graphs = list(g)
        if not graphs:
            raise ValueError("per-scenario topology list is empty")
        if not all(isinstance(gr, QueueGraph) for gr in graphs):
            raise TypeError("per-scenario topologies must all be "
                            "QueueGraph instances")
        g = graphs[0]
        if all(gr is graphs[0] for gr in graphs):
            graphs = None               # degenerate list: one graph
    profiles = None
    if isinstance(profile, (list, tuple)):
        profiles = list(profile)
        profile = None
        if not all(isinstance(q, TransportProfile) for q in profiles):
            raise TypeError("per-scenario profiles must all be "
                            "TransportProfile instances")
    profile, p = _normalize_call(profile, p)
    if trace not in TRACE_MODES:
        raise ValueError(f"unknown trace tier {trace!r}; choose from "
                         f"{TRACE_MODES}")
    if p.chunk_ticks < 1:
        raise ValueError(f"chunk_ticks must be >= 1, got {p.chunk_ticks}")
    tel = _check_telemetry(telemetry, trace)
    link = _check_link(link)
    budget = int(p.ticks if max_ticks is None else max_ticks)
    B, F = (int(d) for d in wls.src.shape)
    if graphs is not None and len(graphs) != B:
        raise ValueError(f"got {len(graphs)} topologies for B={B} scenarios")
    if profiles is not None and len(profiles) != B:
        raise ValueError(f"got {len(profiles)} profiles for B={B} scenarios")
    seeds = np.broadcast_to(np.asarray(DEFAULT_SEED if seeds is None
                                       else seeds), (B,))
    # fault lanes are [B, Q]: with per-scenario topologies of differing
    # queue counts there is no uniform Q to normalize against
    mixed_q = (graphs is not None
               and len({gr.num_queues for gr in graphs}) > 1)
    if mixed_q and (failed is not None or faults is not None):
        raise ValueError(
            "failed=/faults= with per-scenario topologies requires all "
            "graphs to share num_queues — run unequal groups separately")
    with spans.sweep():
        fault = None if mixed_q else as_schedule(g.num_queues, failed, faults,
                                                 B, g_num_hosts=g.num_hosts)
        if profiles is None and graphs is None:
            return _run_batch(g, wls, profile, p, fault, seeds, trace, budget,
                              goodput_window, dev, link, tel, devs)
        per_g = graphs if graphs is not None else [g] * B
        per_q = profiles if profiles is not None else [profile] * B
        groups: "dict[tuple, tuple]" = {}
        for i, (gr, q) in enumerate(zip(per_g, per_q)):
            groups.setdefault((id(gr), q), (gr, q, []))[2].append(i)
        results: "list[SimResult | None]" = [None] * B
        for gr, q, idxs in groups.values():
            sel = torch.as_tensor(idxs)
            sub_fault = (FaultSchedule.healthy(gr.num_queues, len(idxs))
                         if fault is None else fault.lanes(sel))
            rs = _run_batch(gr, wls.lanes(sel), q, p, sub_fault,
                            seeds[idxs], trace, budget, goodput_window, dev,
                            link, tel, devs)
            for i, r in zip(idxs, rs):
                results[i] = r
        return results
