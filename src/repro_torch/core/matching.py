"""SES message matching (Sec. 3.1.2) — the port of ``repro.core.matching``.

Hardware message matching uses a packet-carried initiator ID (32b) and a
64-bit matching key. Profiles differ:

* HPC      — in-order *wildcard* matching (MPI semantics): the lowest-index
             posted entry whose unmasked bits equal the message key wins.
* AI FULL  — *exact* matching, unordered: any entry with full 64b+initiator
             equality may match (CAM-style); we return the lowest index for
             determinism, which a CAM is free to do.
* AI BASE  — no transport-layer matching (handled by the libfabric provider).

64-bit keys are carried as (hi, lo) uint32 pairs, each an int32 bit
pattern here (``repro_torch._u32``): ``encode_match_key`` and
``wildcard_mask`` return the patterns as Python ints, and a uint32
constant such as ``ANY_INITIATOR`` (0xFFFFFFFF) is its pattern, -1.

The receive queue is a fixed-capacity structure-of-arrays; matching a batch
of arriving messages is one [B, E] comparison (no wider temporary).
Unexpected messages (no posted entry) return -1 and the caller chooses the
paper's options: discard + "buffer not ready", buffer headers, or buffer
partial payload (Sec. 3.1.2-3.1.3). Ties take the first index: the
lowest posting seq's first entry under HPC, the first exact hit under
AI Full, as the reference's ``argmin`` / ``argmax`` do.

The message-id trick for in-order RUD matching (Sec. 3.2.1: the CCL places
a sequence number in the match bits so an unordered wire still fills buffers
in order) is `encode_match_key`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch._u32 import c32, lane
from repro_torch.core import scatter
from repro_torch.core.types import Profile

ANY_INITIATOR = c32(0xFFFFFFFF)

# 64-bit key layout: [comm:16 | tag:24 | seq:24]
#   hi word = [comm:16 | tag_hi:16], lo word = [tag_lo:8 | seq:24]
_COMM_BITS, _TAG_BITS, _SEQ_BITS = 16, 24, 24


def encode_match_key(comm_id: int, tag: int, msg_seq: int) -> "tuple[int, int]":
    """Pack (communicator, user tag, message seq) into the 64b match key,
    returned as (hi, lo) uint32 words (int32 patterns). Placing a
    per-(src,dst) message sequence number in the low bits is the paper's
    recipe for in-order message matching over unordered RUD (Sec. 3.2.1)."""
    comm = int(comm_id) & 0xFFFF
    tag = int(tag) & 0xFFFFFF
    seq = int(msg_seq) & 0xFFFFFF
    hi = (comm << 16) | (tag >> 8)
    lo = ((tag & 0xFF) << 24) | seq
    return c32(hi), c32(lo)


def wildcard_mask(match_comm: bool = True, match_tag: bool = True,
                  match_seq: bool = True) -> "tuple[int, int]":
    """Wildcard mask (hi, lo) for `encode_match_key` layout (HPC profile).
    A field set to False is wildcarded (its bits are ignored)."""
    hi = 0
    lo = 0
    if not match_comm:
        hi |= 0xFFFF << 16
    if not match_tag:
        hi |= 0xFFFF
        lo |= 0xFF << 24
    if not match_seq:
        lo |= 0xFFFFFF
    return c32(hi), c32(lo)


@dataclass(frozen=True)
class RecvQueue:
    """Posted-receive table of one receive context (RI). All [E] tensors.

    tag_hi/tag_lo:   uint32 match key words of posted entries
    mask_hi/mask_lo: uint32 wildcard masks — a 1 bit means "ignore this bit"
    initiators:      uint32 expected initiator, ANY_INITIATOR = wildcard
    seq:             int32 posting order (for HPC in-order semantics)
    valid:           bool
    buffer_id:       int32 destination buffer handle
    """

    tag_hi: torch.Tensor
    tag_lo: torch.Tensor
    mask_hi: torch.Tensor
    mask_lo: torch.Tensor
    initiators: torch.Tensor
    seq: torch.Tensor
    valid: torch.Tensor
    buffer_id: torch.Tensor

    @staticmethod
    def create(capacity: int, device=None) -> "RecvQueue":
        dev = resolve_device(device)
        u = torch.zeros((capacity,), dtype=torch.int32, device=dev)
        return RecvQueue(
            tag_hi=u, tag_lo=u.clone(), mask_hi=u.clone(),
            mask_lo=u.clone(), initiators=u.clone(),
            seq=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
            buffer_id=torch.full((capacity,), -1, dtype=torch.int32,
                                 device=dev),
        )


def post_receive(q: RecvQueue, slot, key_hi, key_lo, mask_hi, mask_lo,
                 initiator, seq, buffer_id) -> RecvQueue:
    """Post into table slot `slot`: one receive (scalars), or a batch
    (``slot`` and the fields as [K] lanes; a repeated slot keeps its
    last lane, as the reference's set does)."""
    def put(field, v):
        return scatter.set_last(field, slot, lane(v, field.device))
    return RecvQueue(
        tag_hi=put(q.tag_hi, key_hi),
        tag_lo=put(q.tag_lo, key_lo),
        mask_hi=put(q.mask_hi, mask_hi),
        mask_lo=put(q.mask_lo, mask_lo),
        initiators=put(q.initiators, initiator),
        seq=put(q.seq, seq),
        valid=scatter.set_last(q.valid, slot, True),
        buffer_id=put(q.buffer_id, buffer_id),
    )


def _entry_hits(q: RecvQueue, key_hi, key_lo, initiator) -> torch.Tensor:
    """[B, E] bool: does entry e match message b (ignoring order)."""
    khi = key_hi.to(torch.int32)[:, None]
    klo = key_lo.to(torch.int32)[:, None]
    init = initiator.to(torch.int32)[:, None]
    hi_eq = (q.tag_hi | q.mask_hi)[None, :] == (khi | q.mask_hi[None, :])
    lo_eq = (q.tag_lo | q.mask_lo)[None, :] == (klo | q.mask_lo[None, :])
    init_eq = (q.initiators[None, :] == init) | (
        q.initiators == ANY_INITIATOR)[None, :]
    return hi_eq & lo_eq & init_eq & q.valid[None, :]


def _first(cand: torch.Tensor) -> torch.Tensor:
    """[B] index of each row's first True (0 where none), as ``argmax``
    over a bool row takes it."""
    e = cand.shape[1]
    cols = torch.arange(e, dtype=torch.int32, device=cand.device)
    first = torch.where(cand, cols, e).amin(dim=1)
    return torch.where(first < e, first, 0)


def match(q: RecvQueue, key_hi: torch.Tensor, key_lo: torch.Tensor,
          initiator: torch.Tensor, profile: Profile = Profile.AI_FULL):
    """Match a batch of arriving messages against the posted-receive table.

    NOTE: entries are matched independently (a batch does not consume
    entries as it goes); the caller consumes matched slots between batches.

    Returns (slot [B] int32, matched [B] bool); slot == -1 if unexpected.
    """
    hits = _entry_hits(q, key_hi, key_lo, initiator)
    if profile == Profile.HPC:
        # In-order wildcard matching: lowest posting-seq valid hit wins
        # (the first such entry; a non-hit ranks at 2**30).
        order = torch.where(hits, q.seq[None, :], 2 ** 30)
        best = _first(order == order.amin(dim=1, keepdim=True))
        matched = hits.gather(1, best.long()[:, None])[:, 0]
    elif profile == Profile.AI_FULL:
        # Exact matching: wildcard masks are illegal — treat masked entries
        # as non-matching (the spec constrains AI Full to exact match).
        exact = hits & ((q.mask_hi == 0) & (q.mask_lo == 0))[None, :]
        best = _first(exact)
        matched = exact.any(dim=1)
    else:  # AI_BASE: no transport-layer matching
        best = torch.zeros(key_hi.shape[0], dtype=torch.int32,
                           device=key_hi.device)
        matched = torch.zeros(key_hi.shape[0], dtype=torch.bool,
                              device=key_hi.device)
    slot = torch.where(matched, best.to(torch.int32), -1)
    return slot, matched


def consume(q: RecvQueue, slot, matched) -> RecvQueue:
    """Invalidate a matched entry (one message per call; a batch of
    lanes keeps the last lane's write at a repeated slot)."""
    matched = torch.as_tensor(matched, device=q.valid.device)
    safe = torch.where(matched, torch.as_tensor(slot, device=q.valid.device),
                       0)
    valid = scatter.set_last(
        q.valid, safe,
        torch.where(matched, False, scatter.gather(q.valid, safe)))
    return RecvQueue(q.tag_hi, q.tag_lo, q.mask_hi, q.mask_lo,
                     q.initiators, q.seq, valid, q.buffer_id)
