"""PDS packet tracking: PSN space, SACK bitmaps, CACK, MP_RANGE
(Sec. 3.2.5) — the port of ``repro.core.pds``.

A flow's tracker keeps a ring bitmap anchored at the cumulative-ACK point:

    bit i of the ring  <=>  PSN (base + i) has arrived

All uint32 lanes are int32 bit patterns (see ``repro_torch._u32``).
The CACK advance and ring shift run per tick through
``repro_torch.kernels.ops`` (hand-written CUDA on the card); the
functions here are the plain versions those kernels are held against.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch._u32 import bit, funnel_r, shr
from repro_torch.core.types import lane_shape

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
               device: torch.device) -> "PSNTracker":
        """n trackers, or a lane shape such as (B, N)."""
        if mp_range % WORD:
            raise ValueError(f"mp_range must be a multiple of {WORD}, "
                             f"got {mp_range}")
        shape = lane_shape(n)
        z = torch.zeros(shape, dtype=torch.int32, device=device)
        return PSNTracker(
            base=z, ring=torch.zeros(shape + (mp_range // WORD,),
                                     dtype=torch.int32, device=device),
            rx_ok=z.clone(), dup=z.clone(), oor=z.clone())

    @property
    def mp_range(self) -> int:
        return self.ring.shape[-1] * WORD


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
