"""PDS packet tracking: PSN space, SACK bitmaps, CACK, MP_RANGE
(Sec. 3.2.5) — the port of ``repro.core.pds``.

A flow's tracker keeps a ring bitmap anchored at the cumulative-ACK point:

    bit i of the ring  <=>  PSN (base + i) has arrived

All uint32 lanes are int32 bit patterns (see ``repro_torch._u32``).
The CACK advance and ring shift run per tick through
``repro_torch.kernels.ops`` (hand-written CUDA on the card); the
helpers here are the plain versions those kernels are held against.

The batch API of the reference — ``record_rx`` (with ``or_mask``),
``advance_cack`` and ``sack_view`` over one [N, W] tracker — runs
through the same kernels: ``record_rx`` ORs its accepted lanes into the
ring with one ``ops.nack_mark`` launch, ``advance_cack`` is one
``ops.sack_advance`` launch (the plain versions for CPU tensors).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .device import resolve_device
from .u32 import bit, funnel_r, shr, ult
from . import scatter
from .uet_types import lane_shape

WORD = 32  # ring bitmap word width


@dataclass(frozen=True)
class PSNTracker:
    """Per-PDC receive tracking state (SoA over N PDCs, or [B, N] with
    one scenario per row).

    base:   [N] uint32 — lowest not-cumulatively-acked PSN
    ring:   [N, W] uint32 — ring bitmap covering mp_range = W*32 PSNs
    rx_ok:  [N] uint32 — accepted packets (stats)
    dup:    [N] uint32 — duplicate arrivals (stats)
    oor:    [N] uint32 — rejected: outside MP_RANGE (stats)
    """

    base: torch.Tensor
    ring: torch.Tensor
    rx_ok: torch.Tensor
    dup: torch.Tensor
    oor: torch.Tensor

    @staticmethod
    def create(n: "int | tuple[int, ...]", mp_range: int,
               device=None) -> "PSNTracker":
        """n trackers, or a lane shape such as (B, N), on ``device``
        (``cuda`` unless the caller asks for another)."""
        if mp_range % WORD:
            raise ValueError(f"mp_range must be a multiple of {WORD}, "
                             f"got {mp_range}")
        shape = lane_shape(n)
        device = resolve_device(device)
        z = torch.zeros(shape, dtype=torch.int32, device=device)
        return PSNTracker(
            base=z, ring=torch.zeros(shape + (mp_range // WORD,),
                                     dtype=torch.int32, device=device),
            rx_ok=z.clone(), dup=z.clone(), oor=z.clone())

    @property
    def mp_range(self) -> int:
        return self.ring.shape[-1] * WORD


def _lane_bits(ring: torch.Tensor, row: torch.Tensor, off: torch.Tensor,
               valid: torch.Tensor):
    """The reference ``or_mask``'s lanes over an [N, W] ring: (flow, o,
    already, keep). ``o`` is the offset clamped into the window, ``flow``
    the lane's row with a negative one counted from the end (the
    reference's index rule; a row still outside [0, N) marks nothing),
    ``already`` whether the lane's bit is set in ``ring`` (read at the
    clamped row), and ``keep`` the in-window lanes that set a new bit."""
    n, w = ring.shape
    mp = w * WORD
    ok = valid & (off >= 0) & (off < mp)
    o = off.clamp(0, mp - 1).to(torch.int32)
    safe = torch.where(ok, row, 0)
    word = torch.div(o, WORD, rounding_mode="floor")
    already = (ring[scatter.read_index(safe, n), word] & bit(o % WORD)) != 0
    flow, _ = scatter.write_index(safe, n)
    return flow.to(torch.int32), o, already, ok & ~already


def or_mask(ring: torch.Tensor, row: torch.Tensor, off: torch.Tensor,
            valid: torch.Tensor, unique_rows: bool = False):
    """Build the uint32 OR-mask a batch of lanes wants to set in `ring`.

    ring: [N, W] uint32; row, off: [B] int32 (off = bit offset within the
    row's window); valid: [B] bool. Out-of-window offsets are dropped.
    Returns (mask [N, W] uint32, already [B] bool) where `already` flags
    lanes whose bit is set in `ring` before this batch.

    The mask is one ``ops.nack_mark`` over a zero ring: lanes that hit
    one bit combine as OR, so no dedup pass is needed (the reference's
    first-lane-wins claim is an O(B^2) pairwise test). The mask is bitwise
    the reference's whenever the caller keeps ``unique_rows``' contract:
    with ``unique_rows=True`` the reference adds its single-bit words, so
    two lanes at one (row, bit) carry into the next bit; the port ORs
    them and never carries (ROADMAP.md queue 3). ``unique_rows`` is kept
    for the reference's signature and changes nothing here.
    """
    from . import kops as ops
    flow, o, already, keep = _lane_bits(ring, row, off, valid)
    return ops.nack_mark(torch.zeros_like(ring), flow, o, keep), already


def record_rx(t: PSNTracker, pdc: torch.Tensor, psn: torch.Tensor,
              valid: torch.Tensor, unique_rows: bool = False):
    """Record a batch of arriving packets.

    pdc: [B] int32; psn: [B] uint32 (int32 pattern); valid: [B] bool
    (False = no packet in lane). Returns (tracker', accepted [B] bool) —
    accepted means in-range and not a duplicate of a PSN already in the
    ring; two lanes of one batch at one PSN are both accepted, and both
    count in ``rx_ok``, as in the reference. The ring update is one
    ``ops.nack_mark`` launch (OR-combined, so duplicate lanes need no
    dedup); ``unique_rows`` is the reference's signature (see
    ``or_mask``). The counters accumulate every lane (integer adds).
    """
    from . import kops as ops
    safe = torch.where(valid, pdc, 0)
    off = psn - scatter.gather(t.base, safe)      # uint32 wrap
    in_range = ult(off, t.mp_range) & valid
    flow, o, already, keep = _lane_bits(t.ring, pdc, off, in_range)
    fresh = in_range & ~already
    i32 = torch.int32
    return PSNTracker(
        base=t.base,
        ring=ops.nack_mark(t.ring, flow, o, keep),
        rx_ok=scatter.add_at(t.rx_ok, safe, fresh.to(i32)),
        dup=scatter.add_at(t.dup, safe, (in_range & already).to(i32)),
        oor=scatter.add_at(t.oor, safe, (valid & ~in_range).to(i32)),
    ), fresh


def advance_cack(t: PSNTracker):
    """Advance the cumulative-ACK point past every contiguous received PSN.

    Returns (tracker', advanced [N] int32): one ``ops.sack_advance``
    launch (the hand-written kernel on the card, its plain version on
    the CPU)."""
    from . import kops as ops
    ring, base, adv = ops.sack_advance(t.ring, t.base)
    return PSNTracker(base=base, ring=ring, rx_ok=t.rx_ok, dup=t.dup,
                      oor=t.oor), adv


def sack_view(t: PSNTracker):
    """(cack_psn, sack_lo, sack_hi) per PDC: the ACK-carried fields.

    cack_psn acknowledges every PSN < base; (sack_hi:sack_lo) is the 64-bit
    SACK bitmap immediately above base (Sec. 3.2.5), as two uint32 words
    (int32 patterns) — exactly the two words a wire header would carry.
    """
    cack = t.base
    lo = t.ring[:, 0]
    hi = t.ring[:, 1] if t.ring.shape[1] > 1 else torch.zeros_like(lo)
    return cack, lo, hi


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x - (shr(x, 1) & 0x55555555)
    x = (x & 0x33333333) + (shr(x, 2) & 0x33333333)
    x = (x + shr(x, 4)) & 0x0F0F0F0F
    return shr(x * 0x01010101, 24)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    for n in (1, 2, 4, 8, 16):
        x = x | shr(x, n)
    return WORD - _popcount32(x)


def trailing_ones(ring: torch.Tensor) -> torch.Tensor:
    """Per-row count of contiguous set bits from bit 0 of word 0.

    ring: [N, W] uint32 -> [N] int32 in [0, W*32].
    """
    N, W = ring.shape
    full = ring == -1
    inv = ~ring
    # ctz(x) = popcount((x & -x) - 1); an all-ones word has 32 ones
    ctz = _popcount32((inv & (0 - inv)) - 1)
    ctz = torch.where(inv == 0, WORD, ctz)
    # words before the first non-full one contribute 32 each
    first_partial = torch.argmin(full.to(torch.int32), dim=1)
    all_full = full.all(dim=1)
    n_full = torch.where(all_full, W, first_partial)
    partial = ctz.gather(1, first_partial[:, None])[:, 0]
    partial = torch.where(all_full, 0, partial)
    return (n_full * WORD + partial).to(torch.int32)


def shift_ring(ring: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Logical right-shift each row of the ring bitmap by `count` bits
    (cross-word funnel shift), vectorized over rows."""
    N, W = ring.shape
    words = torch.div(count, WORD, rounding_mode="floor")
    idx = torch.arange(W, device=ring.device)[None, :] + words[:, None]
    lo = torch.where(idx < W, ring.gather(1, idx.clamp(0, W - 1)), 0)
    hi = torch.where(idx + 1 < W, ring.gather(1, (idx + 1).clamp(0, W - 1)),
                     0)
    return funnel_r(lo, hi, (count % WORD)[:, None])


def bit_plane(off: torch.Tensor, valid: torch.Tensor, w: int) -> torch.Tensor:
    """[..., N, W] uint32 plane with row i's bit `off[i]` set where
    valid[i] and 0 <= off[i] < W*32 (signed): the dense replacement for
    a one-lane-per-row bit scatter, elementwise."""
    o = off.clamp(0, w * WORD - 1)
    wordsel = (torch.arange(w, device=off.device)
               == torch.div(o, WORD, rounding_mode="floor")[..., None])
    ok = valid & (off >= 0) & (off < w * WORD)
    return torch.where(ok[..., None] & wordsel, bit(o % WORD)[..., None], 0)


def ooo_distance(t: PSNTracker) -> torch.Tensor:
    """Out-of-order span: distance between the highest received PSN and the
    CACK point — the OOO_COUNT loss-inference signal (Sec. 3.2.4). Rows
    may carry leading scenario axes ([..., N, W] rings)."""
    W = t.ring.shape[-1]
    any_bit = t.ring != 0
    # highest word holding a set bit: the first max of the reversed row
    word_idx = (W - 1) - torch.argmax(any_bit.flip(-1).to(torch.int32),
                                      dim=-1)
    has = any_bit.any(dim=-1)
    w = t.ring.gather(-1, word_idx.clamp(0, W - 1)[..., None])[..., 0]
    msb = 31 - _clz32(w)
    return torch.where(has, word_idx * WORD + msb + 1, 0).to(torch.int32)
