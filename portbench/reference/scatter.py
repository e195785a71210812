"""The reference's indexed reads and writes, with its exact semantics and
a fixed result on every device.

The control-plane modules (``pdc``, ``pds``, ``addressing``,
``matching``, ``tss``, ``nscc``) update [N] tables at batches of lane
indices, as the reference's ``x[idx]`` and ``x.at[idx].set/add/mul/max``
do. The reference's rules, on the CPU (probed, and held by
``tests/test_torch_control.py``):

* an index below 0 counts from the end once (``-1`` is ``n - 1``);
* a read then clamps into [0, n) — ``x[n + 3]`` reads ``x[n - 1]``;
* a write to an index still outside [0, n) is dropped;
* a set with repeated indices keeps the last lane's value;
* adds and multiplies accumulate, f32 ones in lane order; a max on
  uint32 lanes compares unsigned.

Torch's own scatters leave the winner of a repeated set, and the order
of f32 accumulation, to the device (CUDA atomics have no fixed order),
so a repeated set here takes the largest lane index per row
(``scatter_reduce`` "amax", exact for integers) and gathers its value,
and an ordered f32 update runs one scatter over unique rows per rank
round: lane l's rank is the number of earlier lanes at its row, from a
stable sort, and round r applies the lanes of rank r. The rounds are as
many as the largest multiplicity. Every function returns a new tensor.
"""
from __future__ import annotations

import torch

from .u32 import scatter_umax


def _lanes(idx: "torch.Tensor | int", like: torch.Tensor) -> torch.Tensor:
    """The index as a 1-d int64 tensor on ``like``'s device."""
    t = torch.as_tensor(idx, device=like.device)
    return t.reshape(-1).to(torch.int64)


def read_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The row a read at ``idx`` takes: negatives once from the end, then
    clamped into [0, n)."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def gather(x: torch.Tensor, idx: "torch.Tensor | int") -> torch.Tensor:
    """``x[idx]`` along the first axis under the reference's read rule;
    the result has ``idx``'s shape (a 0-d index gives x's row)."""
    t = torch.as_tensor(idx, device=x.device)
    return x[read_index(t, x.shape[0])]


def write_index(idx: torch.Tensor, n: int):
    """(row, kept) of a write at ``idx``: negatives once from the end,
    and only rows in [0, n) kept."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


def _values(val, lanes: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    v = torch.as_tensor(val, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(v.reshape(-1) if v.dim() else v,
                              lanes.shape)


def set_last(x: torch.Tensor, idx, val) -> torch.Tensor:
    """``x.at[idx].set(val)``: rows written by several lanes take the
    last lane's value; writes outside [0, n) are dropped."""
    n = x.shape[0]
    row, kept = write_index(_lanes(idx, x), n)
    if row.numel() == 0:
        return x.clone()
    v = _values(val, row, x)
    lane = torch.arange(row.numel(), device=x.device)
    win = torch.full((n + 1,), -1, dtype=torch.int64, device=x.device)
    win.scatter_reduce_(0, torch.where(kept, row, n), lane, "amax")
    win = win[:n]
    return torch.where(win >= 0, v[win.clamp(min=0)], x)


def add_at(x: torch.Tensor, idx, val) -> torch.Tensor:
    """``x.at[idx].add(val)`` for an integer ``x`` (exact in any order);
    writes outside [0, n) are dropped."""
    n = x.shape[0]
    row, kept = write_index(_lanes(idx, x), n)
    v = _values(val, row, x)
    out = torch.cat([x, x.new_zeros((1,))])
    out.index_add_(0, torch.where(kept, row, n), v)
    return out[:n]


def _rank_rounds(row: torch.Tensor, kept: torch.Tensor):
    """For each rank r, the lanes (kept ones only) that are the r-th at
    their row in lane order."""
    lanes = torch.nonzero(kept).reshape(-1)
    if lanes.numel() == 0:
        return []
    r = row[lanes]
    order = torch.sort(r, stable=True).indices
    sr = r[order]
    pos = torch.arange(sr.numel(), device=row.device)
    start = torch.ones_like(sr, dtype=torch.bool)
    start[1:] = sr[1:] != sr[:-1]
    first = torch.cummax(torch.where(start, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - first
    rounds = int(rank.max()) + 1
    return [lanes[rank == k] for k in range(rounds)]


def umax_at(x: torch.Tensor, idx, val) -> torch.Tensor:
    """``x.at[idx].max(val)`` for uint32 lanes (int32 patterns), unsigned;
    writes outside [0, n) are dropped."""
    n = x.shape[0]
    row, kept = write_index(_lanes(idx, x), n)
    out = scatter_umax(torch.cat([x, x.new_zeros((1,))]),
                       torch.where(kept, row, n), _values(val, row, x))
    return out[:n]


def add_at_ordered(x: torch.Tensor, idx, val) -> torch.Tensor:
    """``x.at[idx].add(val)`` for an f32 ``x``: each row sums its lanes
    in lane order, as the reference does."""
    return _ordered(x, idx, val, torch.add)


def mul_at_ordered(x: torch.Tensor, idx, val) -> torch.Tensor:
    """``x.at[idx].mul(val)`` for an f32 ``x``, in lane order."""
    return _ordered(x, idx, val, torch.mul)


def _ordered(x, idx, val, op) -> torch.Tensor:
    row, kept = write_index(_lanes(idx, x), x.shape[0])
    v = _values(val, row, x)
    out = x.clone()
    for lanes in _rank_rounds(row, kept):
        r = row[lanes]
        out[r] = op(out[r], v[lanes])
    return out
