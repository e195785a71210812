"""Plain PyTorch versions of the port's five kernels: the fabric tick's
three (SACK advance, fused SACK, NACK marking) and the batched NSCC
window update and ECMP port selection.

These run for CPU tensors (the tests) and are what ``chip_smoke.py``
holds each CUDA kernel against on the card, bit for bit. All rings and
hash lanes are uint32 lanes stored as int32 bit patterns
(``repro_torch._u32``).
"""
from __future__ import annotations

import torch

from repro_torch._u32 import from_u64, umod
from repro_torch.core.cms.nscc import NSCCParams, window_delta
from repro_torch.core.pds import shift_ring, trailing_ones
from repro_torch.network.ecmp import ecmp_hash


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


def nack_mark_ref(rtx: torch.Tensor, flow: torch.Tensor, off: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Duplicate-safe NACK retransmit-bit marking (Sec. 3.2.4).

    Lane l with valid[l] and 0 <= flow[l] < F sets bit off[l] (clipped to
    [0, W*32)) of row flow[l]; lanes hitting one bit combine as OR. A
    valid lane with an out-of-range row marks nothing — the contract of
    the reference's Pallas kernel (its jnp oracle instead wraps a
    negative row, see ROADMAP.md "Faults found").

    rtx: [F, W]; flow/off: [L] int32; valid: [L] bool.
    """
    f, w = rtx.shape
    mp = w * 32
    ok = valid & (flow >= 0) & (flow < f)
    rows = torch.where(ok, flow, f).long()      # row f is a discard row
    cols = off.clamp(0, mp - 1).long()
    plane = torch.zeros((f + 1, mp), dtype=torch.bool, device=rtx.device)
    plane[rows, cols] = True
    # bits are distinct powers of two per word: the pack-sum IS the OR
    shifts = torch.arange(32, dtype=torch.int64, device=rtx.device)
    words = (plane[:f].view(f, w, 32).to(torch.int64) << shifts).sum(dim=2)
    return rtx | from_u64(words)
