"""Plain PyTorch versions of the port's kernels: the three of the
reference's tick (SACK advance, fused SACK, NACK marking), the own-bit
forms of the two SACK kernels and the in-place marks on the retransmit
ring (the NACK lanes, one bit per row set or cleared) that the port's
tick runs, the batched NSCC window update and ECMP port selection, and
their tick forms: NSCC's per-flow ACK update and Quick Adapt epoch, and
the ECMP injection and per-hop routing walks over ``RoutingTables``;
and the tick's enqueue ranks and per-queue counts (``enqueue_rank_ref``,
the composition section 7 of ``make_step`` ran, and its pairwise count
``rank_within``); and the per-flow folds of the tick's ACK/NACK and
delivery lanes (``flow_fold_ref``, the one-hot composition sections 1
and 5 ran). The in-place forms end in ``_`` and return the ring they
were given.

These run for CPU tensors (the tests) and are what ``chip_smoke.py``
holds each CUDA kernel against on the card, bit for bit. All rings and
hash lanes are uint32 lanes stored as int32 bit patterns
(``repro_torch._u32``).
"""
from __future__ import annotations

import torch

from repro_torch._u32 import from_u64, umod
from repro_torch.core.cms.nscc import NSCCParams, window_delta
from repro_torch.core.lb.schemes import _pick_lane
from repro_torch.core.pds import bit_plane, shift_ring, trailing_ones
from repro_torch.core.types import scenario_rows
from repro_torch.network.ecmp import DELIVERED, ecmp_hash
from repro_torch.network.topology import Stage


def nscc_update_ref(cwnd: torch.Tensor, ecn: torch.Tensor, rtt: torch.Tensor,
                    count: torch.Tensor, params: NSCCParams) -> torch.Tensor:
    """Batched NSCC window update (Sec. 3.3.1): the four-case delta of
    each window times its coalesced ACK count, applied where count > 0,
    clipped to [min_cwnd, max_cwnd].

    cwnd/rtt: [N] float32; ecn: [N] bool (or integer, nonzero = marked);
    count: [N] int32. Returns [N] float32.
    """
    if ecn.dtype != torch.bool:
        ecn = ecn != 0
    delta = window_delta(cwnd, ecn, rtt, params) * count.to(torch.float32)
    out = torch.where(count > 0, cwnd + delta, cwnd)
    return out.clamp(params.min_cwnd, params.max_cwnd)


def ecmp_hash_ref(src: torch.Tensor, dst: torch.Tensor, ev: torch.Tensor,
                  salt: torch.Tensor, fanout: int) -> torch.Tensor:
    """Batched ECMP port selection (Sec. 2.1): H(src, dst, ev, salt) mod
    fanout over [N] int32 lanes (uint32 patterns), as int32."""
    return umod(ecmp_hash(src, dst, ev, salt), fanout)


def nscc_ack_ref(cwnd: torch.Tensor, epoch_acked: torch.Tensor,
                 has_ack: torch.Tensor, ecn: torch.Tensor, rtt: torch.Tensor,
                 params: NSCCParams):
    """The tick's NSCC ACK hook (``nscc.on_ack_per_flow``): one ACK a
    flow where ``has_ack``, the gap in the compiled tick's folded form,
    then the clip to [min_cwnd, max_cwnd]. Lanes of any one shape: cwnd /
    rtt float32, epoch_acked int32, has_ack / ecn bool. Returns (cwnd',
    epoch_acked')."""
    delta = window_delta(cwnd, ecn, rtt, params, folded_reciprocal=True)
    out = torch.where(has_ack, cwnd + delta, cwnd)
    return (out.clamp(params.min_cwnd, params.max_cwnd),
            epoch_acked + has_ack.to(torch.int32))


def nscc_epoch_ref(cwnd: torch.Tensor, epoch_acked: torch.Tensor,
                   epoch_lost: torch.Tensor, epoch_tick: torch.Tensor,
                   now: int, params: NSCCParams):
    """The tick's end-of-tick Quick Adapt (``nscc.quick_adapt``): where
    the epoch is due, a lossy one rescales cwnd to the delivered
    fraction (clipped to [qa_min_frac * max_cwnd, max_cwnd]) and the
    counters reset; every window is floored at min_cwnd. Returns (cwnd',
    epoch_acked', epoch_lost', epoch_tick')."""
    epoch_len = int(params.base_rtt * params.target_factor)
    due = (now - epoch_tick) >= epoch_len
    delivered = epoch_acked.to(torch.float32)
    lost = epoch_lost.to(torch.float32)
    frac = delivered / torch.clamp(delivered + lost, min=1.0)
    lossy = due & (epoch_lost > 0)
    new_cwnd = torch.where(
        lossy,
        (cwnd * frac).clamp(params.qa_min_frac * params.max_cwnd,
                            params.max_cwnd),
        cwnd)
    return (torch.clamp(new_cwnd, min=params.min_cwnd),
            torch.where(due, 0, epoch_acked),
            torch.where(due, 0, epoch_lost),
            torch.where(due, now, epoch_tick))


def ecmp_inject_ref(tables, src: torch.Tensor, dst: torch.Tensor,
                    ev: torch.Tensor) -> torch.Tensor:
    """``RoutingTables.injection_queue``: the first queue of a packet
    injected at host ``src`` toward ``dst`` on entropy value ``ev``."""
    sleaf = tables.host_leaf[src]
    dleaf = tables.host_leaf[dst]
    h = umod(ecmp_hash(src, dst, ev, sleaf), tables.g.fanout1)
    up = tables.up1[sleaf, h]
    return torch.where(sleaf == dleaf, tables.host_queue[dst], up)


def ecmp_route_ref(tables, queue: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
    """``RoutingTables.route_step``: the next queue of packets just
    dequeued from ``queue``; DELIVERED for packets leaving a HOST queue.
    Table lookups clamp their row index where the reference relies on
    JAX's clamped gather."""
    st = tables.stage[queue]
    sw = tables.next_switch[queue]  # switch the packet is *now* at
    dleaf = tables.host_leaf[dst]

    if not tables.three_level:
        L = tables.up1.shape[0]
        nxt_up1 = tables.down1[(sw - L).clamp(0, tables.down1.shape[0] - 1),
                               dleaf]
        nxt_down1 = tables.host_queue[dst]
        out = torch.where(st == Stage.UP1, nxt_up1,
                          torch.where(st == Stage.DOWN1, nxt_down1,
                                      DELIVERED))
        return torch.where(st == Stage.HOST, DELIVERED, out)

    L = tables.up1.shape[0]            # leaves
    A = tables.down1.shape[0]          # aggs
    Lp = tables.leaves_per_pod
    Ap = tables.aggs_per_pod
    half = tables.up2.shape[1]
    dpod = tables.host_pod[dst]

    # at agg (arrived via UP1): same pod -> DOWN1; else UP2 via hash
    agg = (sw - L).clamp(0, A - 1)
    dleaf_local = dleaf % Lp
    go_down = tables.down1[agg, dleaf_local]
    go_up = tables.up2[agg, umod(ecmp_hash(src, dst, ev, sw), half)]
    nxt_up1 = torch.where(torch.div(agg, Ap, rounding_mode="floor")
                          == dpod, go_down, go_up)
    # at core (arrived via UP2): down to the destination pod's agg
    core = (sw - L - A).clamp(0, tables.down2.shape[0] - 1)
    nxt_up2 = tables.down2[core, dpod]
    # at agg (arrived via DOWN2) the next hop is go_down; at a leaf
    # (arrived via DOWN1) it is the host downlink
    nxt_down1 = tables.host_queue[dst]
    return torch.where(
        st == Stage.UP1, nxt_up1,
        torch.where(st == Stage.UP2, nxt_up2,
                    torch.where(st == Stage.DOWN2, go_down,
                                torch.where(st == Stage.DOWN1, nxt_down1,
                                            DELIVERED))))


def sack_advance_ref(ring: torch.Tensor, base: torch.Tensor):
    """Cumulative-ACK advance over [N, W] SACK rings: count the contiguous
    received prefix, shift it out, advance the base PSN (Sec. 3.2.5).
    Returns (new_ring, new_base, advanced[int32])."""
    adv = trailing_ones(ring)
    return shift_ring(ring, adv), base + adv, adv


def sack_fused_ref(ring: torch.Tensor, base: torch.Tensor, rtx: torch.Tensor,
                   mask: torch.Tensor):
    """Fused SACK hot path (Sec. 3.2.5): record-rx OR, CACK advance, and
    the lockstep shift of the SACK ring and the retransmit ring.
    Returns (new_ring, new_base, new_rtx, advanced[int32])."""
    ring = ring | mask
    adv = trailing_ones(ring)
    return shift_ring(ring, adv), base + adv, shift_ring(rtx, adv), adv


def sack_advance_own_ref(ring: torch.Tensor, base: torch.Tensor,
                         off: torch.Tensor, ok: torch.Tensor):
    """``sack_advance`` with the row's own received bit: row i records
    bit off[i] (PSN - base, int32) where ok[i] and 0 <= off[i] < W*32,
    then advances. Returns (new_ring, new_base, advanced[int32],
    already[bool]), ``already`` = the bit was set in the old ring."""
    mask = bit_plane(off, ok, ring.shape[1])
    already = ((ring & mask) != 0).any(dim=1)
    return (*sack_advance_ref(ring | mask, base), already)


def sack_fused_own_ref(ring: torch.Tensor, base: torch.Tensor,
                       rtx: torch.Tensor, off: torch.Tensor, ok: torch.Tensor,
                       clear: torch.Tensor):
    """``sack_fused`` with the row's own ACKed bit: records bit off[i]
    as ``sack_advance_own_ref`` does, advances and shifts both rings, and
    where clear[i] clears bit off[i] - adv[i] (the ACKed PSN against the
    new base, uint32 wrap) of the shifted rtx ring if it lies in
    [0, W*32). Returns (new_ring, new_base, new_rtx, advanced[int32],
    already[bool])."""
    w = ring.shape[1]
    mask = bit_plane(off, ok, w)
    already = ((ring & mask) != 0).any(dim=1)
    ring, base, rtx, adv = sack_fused_ref(ring, base, rtx, mask)
    return ring, base, rtx & ~bit_plane(off - adv, clear, w), adv, already


def _lane_words(f: int, w: int, flow: torch.Tensor, off: torch.Tensor,
                ok: torch.Tensor) -> torch.Tensor:
    """[F, W] words holding bit off[l] of row flow[l] for every lane with
    ok[l] (ok implies 0 <= flow[l] < F and 0 <= off[l] < W*32); lanes
    hitting one bit combine as OR. The distinct (row, bit) keys are summed
    into their words: distinct powers of two, so the sum IS the OR."""
    key = torch.where(ok, flow.long() * (w * 32) + off.long(), -1)
    key = torch.unique(key)
    key = key[key >= 0]
    words = torch.zeros(f * w, dtype=torch.int64, device=flow.device)
    words.index_add_(0, torch.div(key, 32, rounding_mode="floor"),
                     torch.ones_like(key) << (key % 32))
    return from_u64(words.view(f, w))


def nack_mark_ref(rtx: torch.Tensor, flow: torch.Tensor, off: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Duplicate-safe NACK retransmit-bit marking (Sec. 3.2.4).

    Lane l with valid[l] and 0 <= flow[l] < F sets bit off[l] (clipped to
    [0, W*32)) of row flow[l]; lanes hitting one bit combine as OR. A
    valid lane with an out-of-range row marks nothing — the contract of
    the reference's Pallas kernel (its jnp oracle instead wraps a
    negative row, see ROADMAP.md "Faults found").

    rtx: [F, W]; flow/off: [L] int32; valid: [L] bool. Returns a new ring.
    """
    f, w = rtx.shape
    ok = valid & (flow >= 0) & (flow < f)
    return rtx | _lane_words(f, w, flow, off.clamp(0, w * 32 - 1), ok)


def nack_mark_lanes_ref_(rtx: torch.Tensor, base: torch.Tensor,
                         flow: torch.Tensor, psn: torch.Tensor,
                         nack: torch.Tensor,
                         rod: "torch.Tensor | None" = None) -> torch.Tensor:
    """The tick's NACK site, in place on ``rtx``, over B scenarios:
    ``rtx`` [B, F, W], ``base`` [B, F], flow/psn [B, L] int32 and nack
    [B, L] bool (or [F, W], [F] and [L]: B = 1); rod: [F] bool, the same
    for every scenario. Lane l of scenario b with nack, 0 <= flow < F
    and (without ``rod``, or where ~rod[flow]) sets bit off = psn -
    base[b, flow] (uint32 wrap, read as int32) of scenario b's row flow
    (flat row b*F + flow) where 0 <= off < W*32; lanes hitting one bit
    combine as OR. A lane whose flow is out of [0, F) marks nothing, so
    no lane reaches a neighbour scenario's rows. Returns ``rtx``."""
    f, w = rtx.shape[-2:]
    if not f or not flow.numel():
        return rtx
    rows = rtx.view(-1, w)
    ok = nack & (flow >= 0) & (flow < f)
    row = torch.where(ok, scenario_rows(flow, f) + flow, 0).long()
    off = psn - base.reshape(-1)[row]
    ok = ok & (off >= 0) & (off < w * 32)
    if rod is not None:
        ok = ok & ~rod[torch.where(ok, flow, 0).long()]
    rows.bitwise_or_(_lane_words(rows.shape[0], w, row.reshape(-1),
                                 off.reshape(-1), ok.reshape(-1)))
    return rtx


def set_own_bit_ref_(rtx: torch.Tensor, off: torch.Tensor,
                     valid: torch.Tensor,
                     unless: "torch.Tensor | None" = None) -> torch.Tensor:
    """In place on ``rtx`` [N, W]: row i sets bit off[i] where valid[i]
    and 0 <= off[i] < W*32 and, with ``unless`` ([N, W]), where that bit
    of unless is clear. off: [N] int32; valid: [N] bool. Returns
    ``rtx``."""
    plane = bit_plane(off, valid, rtx.shape[1])
    if unless is not None:
        plane = plane & ~unless
    return rtx.bitwise_or_(plane)


def clear_own_bit_ref_(rtx: torch.Tensor, off: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """In place on ``rtx`` [N, W]: row i clears bit off[i] where valid[i]
    and 0 <= off[i] < W*32. Returns ``rtx``."""
    return rtx.bitwise_and_(~bit_plane(off, valid, rtx.shape[1]))


def rank_within(target: torch.Tensor, valid: torch.Tensor,
                base: torch.Tensor):
    """Each candidate lane's arrival rank within its target queue, and its
    queue position ``base[target] + rank``: rank[i] = #{j < i : valid[j]
    and target[j] == target[i]} as a masked pairwise count under the
    strictly-lower-triangular [n, n] mask, per scenario (target/valid
    [..., n], base [..., Q]). Returns (pos, rank)."""
    lane = torch.arange(target.shape[-1], device=target.device)
    lower = lane[None, :] < lane[:, None]
    t = torch.where(valid, target, -1)
    same = (t[..., None, :] == t[..., :, None]) & valid[..., None, :] & lower
    rank = same.sum(dim=-1, dtype=torch.int32)
    pos = base.gather(-1, torch.where(valid, target, 0).long()) + rank
    return pos, rank


def enqueue_rank_ref(target: torch.Tensor, valid: torch.Tensor,
                     base: torch.Tensor, capacity: int):
    """The tick's enqueue ranks (section 7 of ``make_step``) as the
    composition the tick ran: ``rank_within``'s [..., n, n] pairwise
    count and the [..., Q, n] enqueue one-hot summed into each queue's
    count. target [..., n] int32 (each valid lane's in [0, Q)), valid
    [..., n] bool, base [..., Q] int32. Returns (pos, added, fits): pos
    [..., n] = base[target] + rank (base[0] on an invalid lane), fits =
    valid & (pos < capacity), added [..., Q] the fitting lanes a
    queue."""
    pos, _ = rank_within(target, valid, base)
    fits = valid & (pos < capacity)
    qidx = torch.arange(base.shape[-1], dtype=torch.int32,
                        device=base.device)
    hot_enq = (target[..., None, :] == qidx[:, None]) & fits[..., None, :]
    return pos, hot_enq.sum(dim=-1, dtype=torch.int32), fits


def flow_fold_ref(flow: torch.Tensor, num_flows: int, masks, sums):
    """The tick's per-flow folds (sections 1 and 5 of ``make_step``) as
    the composition the tick ran: one [..., F, L] one-hot of each lane's
    flow, ANDed with each mask's lanes; a mask's count is its plane's
    sum over the lanes, and sum (k, value) is ``_pick_lane`` of the value
    under mask k's plane. flow [..., L] int32, masks 1-3 [..., L] bool,
    sums pairs (k, value [..., L] int32). Returns (counts [M, ..., F],
    totals [S, ..., F]), int32."""
    flow_ids = torch.arange(num_flows, dtype=torch.int32, device=flow.device)
    own = flow[..., None, :] == flow_ids[:, None]
    hots = [own & m[..., None, :] for m in masks]
    del own   # [..., F, L]: not held beside the planes
    counts = torch.stack([h.sum(dim=-1, dtype=torch.int32) for h in hots])
    return counts, torch.stack([_pick_lane(hots[k], v) for k, v in sums])
