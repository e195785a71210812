"""The tick's kernel sites, each as its plain PyTorch version
(``kernel_ref``): the dispatch of ``repro_torch.kernels.ops`` with only
the branch that a CPU tensor takes, on every device. The reference runs
no hand-written kernel, so it never shares a fault with the program's."""
from __future__ import annotations

import torch

from . import kernel_ref as ref


def _flat_rows(ring: torch.Tensor, *lanes: torch.Tensor):
    """The [..., N, W] ring and its [..., N] lanes as [R, W] rows and
    [R] lanes (views of contiguous tensors)."""
    return (ring.reshape(-1, ring.shape[-1]),
            *(t.reshape(-1) for t in lanes))


def _unflat(outs, ring_shape, lane_shape):
    """Outputs over [R] rows back to the caller's leading axes."""
    return tuple(o.view(ring_shape if o.dim() == 2 else lane_shape)
                 for o in outs)


def sack_advance(ring, base):
    return ref.sack_advance_ref(ring, base)


def sack_fused(ring, base, rtx, mask):
    return ref.sack_fused_ref(ring, base, rtx, mask)


def sack_advance_own(ring, base, off, ok):
    outs = ref.sack_advance_own_ref(*_flat_rows(ring, base, off, ok))
    return _unflat(outs, ring.shape, base.shape)


def sack_fused_own(ring, base, rtx, off, ok, clear):
    r, b, o, k, c = _flat_rows(ring, base, off, ok, clear)
    outs = ref.sack_fused_own_ref(r, b, rtx.reshape(-1, rtx.shape[-1]),
                                  o, k, c)
    return _unflat(outs, ring.shape, base.shape)


def nack_mark(rtx, flow, off, valid):
    return ref.nack_mark_ref(rtx, flow, off, valid)


def nack_mark_lanes_(rtx, base, flow, psn, nack, rod=None):
    return ref.nack_mark_lanes_ref_(rtx, base, flow, psn, nack, rod)


def set_own_bit_(rtx, off, valid, unless=None):
    r, o, v = _flat_rows(rtx, off, valid)
    u = None if unless is None else unless.reshape(r.shape)
    ref.set_own_bit_ref_(r, o, v, u)
    return rtx


def clear_own_bit_(rtx, off, valid):
    ref.clear_own_bit_ref_(*_flat_rows(rtx, off, valid))
    return rtx


def nscc_ack(cwnd, epoch_acked, has_ack, ecn, rtt, params):
    return ref.nscc_ack_ref(cwnd, epoch_acked, has_ack, ecn, rtt, params)


def nscc_epoch(cwnd, epoch_acked, epoch_lost, epoch_tick, now: int, params):
    return ref.nscc_epoch_ref(cwnd, epoch_acked, epoch_lost, epoch_tick,
                              now, params)


def ecmp_inject(tables, src, dst, ev):
    return ref.ecmp_inject_ref(tables, src, dst, ev)


def ecmp_route(tables, queue, src, dst, ev):
    return ref.ecmp_route_ref(tables, queue, src, dst, ev)
