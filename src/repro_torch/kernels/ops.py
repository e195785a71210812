"""Dispatch for the port's kernels (the port of ``repro.kernels.ops``,
plus the forms the port's tick runs): ``sack_fused``, ``nack_mark`` and
``sack_advance`` of the reference's tick; the own-bit SACK forms
``sack_fused_own`` / ``sack_advance_own``; the in-place marks on the
retransmit ring, ``nack_mark_lanes_`` (the NACK site), ``set_own_bit_``
and ``clear_own_bit_`` (one bit per row); the batched ``nscc_update``
and ``ecmp_select``; and their tick forms: ``nscc_ack`` (NSCC's
per-flow ACK update) and ``nscc_epoch`` (Quick Adapt), which
``core.cms.nscc``'s tick hooks call, and ``ecmp_inject`` / ``ecmp_route``
(the injection and per-hop routing walks), which ``RoutingTables``
calls; ``enqueue_rank``, the arrival ranks and per-queue counts of
the tick's enqueue phase; and ``flow_fold``, the per-flow counts and
sums of the tick's ACK/NACK lanes (section 1) and deliveries (section
5). The tick forms return fresh tensors: the tick's previous state is
read again after the step.

The in-place forms (names ending in ``_``) write into the ring they are
given and return it: no copy, no [F, W] plane, no allocation. The
caller must own that ring; the tick does, since each tick's
``sack_fused_own`` makes a new one.

The tick's forms take rows with leading scenario axes: a [B, F, W] ring
with [B, F] lanes is handed to the kernel as its [B·F, W] view (no
copy: the rings are contiguous), and ``nack_mark_lanes_`` takes [B, L]
NACK lanes, each scenario's lanes marking only its own F rows. One
launch per call, whatever B is.

A CPU tensor goes to the plain PyTorch version in ``ref.py``; a CUDA
tensor goes to the hand-written CUDA kernel (``csrc/``, built by
``build.py``), and nothing else: there is no fallback, and a kernel that
fails to build or launch raises. The ``*_cuda`` launchers are the
kernels themselves; handing one a CPU tensor raises.

``LAUNCHES[name]`` counts the launches of each kernel (a plain int,
incremented only where the kernel is launched), so a run can show that
its main path went through the kernels. Each tick form's dispatch (its
checks, allocations and launch) is one ``kernels.<name>`` span of
``repro_torch.spans``, named as its ``LAUNCHES`` key.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch import spans
from repro_torch.core.cms.nscc import NSCCParams, _f32_reciprocal
from repro_torch.kernels import build, ref

LAUNCHES = {"sack_fused": 0, "nack_mark": 0, "sack_advance": 0,
            "sack_fused_own": 0, "sack_advance_own": 0,
            "nack_mark_lanes": 0, "set_own_bit": 0, "clear_own_bit": 0,
            "nscc_update": 0, "ecmp_select": 0, "nscc_ack": 0,
            "nscc_epoch": 0, "ecmp_inject": 0, "ecmp_route": 0,
            "enqueue_rank": 0, "flow_fold": 0}

MAX_WORDS = 32  # a ring row fits one warp: W <= 32 words (mp_range <= 1024)

_C_FNS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*ts: "torch.Tensor | None") -> bool:
    """True for operands on one CUDA device, False for CPU operands;
    raises for mixed or other devices. An absent optional operand
    (None) is skipped."""
    dev = {t.device for t in ts if t is not None}
    if len(dev) != 1:
        raise ValueError(f"kernel operands on several devices: {dev}")
    kind = next(iter(dev)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {kind!r}")
    return kind == "cuda"


def _card(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor for the kernel, "
                         f"got {t.device}")


def _require(name: str, t: torch.Tensor, dtype: torch.dtype, shape):
    _card(name, t)
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ring_shape(ring: torch.Tensor) -> "tuple[int, int]":
    if ring.dim() != 2 or not 1 <= ring.shape[1] <= MAX_WORDS:
        raise ValueError(f"ring must be [N, W] with 1 <= W <= {MAX_WORDS}, "
                         f"got {tuple(ring.shape)}")
    return int(ring.shape[0]), int(ring.shape[1])


def _lanes(t: torch.Tensor) -> int:
    return int(t.shape[0]) if t.dim() == 1 else -1


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _launch(name: str, lib: str, t: torch.Tensor, *args) -> None:
    """Launch kernel ``name`` (C function ``{name}_launch`` of library
    ``lib``, resolved once) on ``t``'s device and its current stream,
    raise on the CUDA error the launch returns, and count the launch."""
    fn = _C_FNS.get(name)
    if fn is None:
        fn = _C_FNS[name] = getattr(build.load(lib), f"{name}_launch")
    dev = t.device
    # the raw handle of the current stream, without building the
    # torch.cuda.Stream object that current_stream() returns
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    _check(err, name)
    LAUNCHES[name] += 1


# ------------------------------------------------------------- kernels --

def sack_advance_cuda(ring: torch.Tensor, base: torch.Tensor):
    """CUDA kernel: CACK advance of [N, W] int32-pattern rings."""
    _on_cuda(ring, base)
    n, w = _ring_shape(ring)
    _require("ring", ring, torch.int32, (n, w))
    _require("base", base, torch.int32, (n,))
    ring_out, base_out = torch.empty_like(ring), torch.empty_like(base)
    adv = torch.empty_like(base)
    if n:
        _launch("sack_advance", "sack", ring, ring.data_ptr(),
                base.data_ptr(), ring_out.data_ptr(), base_out.data_ptr(),
                adv.data_ptr(), n, w)
    return ring_out, base_out, adv


def sack_fused_cuda(ring: torch.Tensor, base: torch.Tensor, rtx: torch.Tensor,
                    mask: torch.Tensor):
    """CUDA kernel: record-rx OR + CACK advance + lockstep rtx shift."""
    _on_cuda(ring, base, rtx, mask)
    n, w = _ring_shape(ring)
    _require("ring", ring, torch.int32, (n, w))
    _require("base", base, torch.int32, (n,))
    _require("rtx", rtx, torch.int32, (n, w))
    _require("mask", mask, torch.int32, (n, w))
    ring_out, rtx_out = torch.empty_like(ring), torch.empty_like(rtx)
    base_out, adv = torch.empty_like(base), torch.empty_like(base)
    if n:
        _launch("sack_fused", "sack", ring, ring.data_ptr(), base.data_ptr(),
                rtx.data_ptr(), mask.data_ptr(), ring_out.data_ptr(),
                base_out.data_ptr(), rtx_out.data_ptr(), adv.data_ptr(), n, w)
    return ring_out, base_out, rtx_out, adv


def sack_advance_own_cuda(ring: torch.Tensor, base: torch.Tensor,
                          off: torch.Tensor, ok: torch.Tensor):
    """CUDA kernel: ``sack_advance`` recording each row's own bit
    ``off`` (int32) where ``ok`` (bool); also returns ``already``."""
    _on_cuda(ring, base, off, ok)
    n, w = _ring_shape(ring)
    _require("ring", ring, torch.int32, (n, w))
    _require("base", base, torch.int32, (n,))
    _require("off", off, torch.int32, (n,))
    _require("ok", ok, torch.bool, (n,))
    ring_out, base_out = torch.empty_like(ring), torch.empty_like(base)
    adv, already = torch.empty_like(base), torch.empty_like(ok)
    if n:
        _launch("sack_advance_own", "sack", ring, ring.data_ptr(),
                base.data_ptr(), off.data_ptr(), ok.data_ptr(),
                ring_out.data_ptr(), base_out.data_ptr(), adv.data_ptr(),
                already.data_ptr(), n, w)
    return ring_out, base_out, adv, already


def sack_fused_own_cuda(ring: torch.Tensor, base: torch.Tensor,
                        rtx: torch.Tensor, off: torch.Tensor, ok: torch.Tensor,
                        clear: torch.Tensor):
    """CUDA kernel: ``sack_fused`` recording each row's own bit ``off``
    (int32) where ``ok`` and clearing bit ``off - adv`` of the shifted
    rtx where ``clear`` (bool); also returns ``already``."""
    _on_cuda(ring, base, rtx, off, ok, clear)
    n, w = _ring_shape(ring)
    _require("ring", ring, torch.int32, (n, w))
    _require("base", base, torch.int32, (n,))
    _require("rtx", rtx, torch.int32, (n, w))
    _require("off", off, torch.int32, (n,))
    _require("ok", ok, torch.bool, (n,))
    _require("clear", clear, torch.bool, (n,))
    ring_out, rtx_out = torch.empty_like(ring), torch.empty_like(rtx)
    base_out, adv = torch.empty_like(base), torch.empty_like(base)
    already = torch.empty_like(ok)
    if n:
        _launch("sack_fused_own", "sack", ring, ring.data_ptr(),
                base.data_ptr(), rtx.data_ptr(), off.data_ptr(),
                ok.data_ptr(), clear.data_ptr(), ring_out.data_ptr(),
                base_out.data_ptr(), rtx_out.data_ptr(), adv.data_ptr(),
                already.data_ptr(), n, w)
    return ring_out, base_out, rtx_out, adv, already


def nack_mark_cuda(rtx: torch.Tensor, flow: torch.Tensor, off: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: OR lane-requested retransmit bits into a copy of
    [F, W] rings (off clipped to [0, W*32))."""
    _on_cuda(rtx, flow, off, valid)
    f, w = _ring_shape(rtx)
    lanes = _lanes(flow)
    _require("rtx", rtx, torch.int32, (f, w))
    _require("flow", flow, torch.int32, (lanes,))
    _require("off", off, torch.int32, (lanes,))
    _require("valid", valid, torch.bool, (lanes,))
    out = rtx.clone()
    if lanes and f:
        _launch("nack_mark", "nack_mark", rtx, out.data_ptr(),
                flow.data_ptr(), off.data_ptr(), valid.data_ptr(), lanes, f,
                w)
    return out


def nack_mark_lanes_cuda(rtx: torch.Tensor, base: torch.Tensor,
                         flow: torch.Tensor, psn: torch.Tensor,
                         nack: torch.Tensor,
                         rod: "torch.Tensor | None" = None) -> torch.Tensor:
    """CUDA kernel, in place on ``rtx``: the tick's NACK lanes, each
    marking bit psn - base[row] of its scenario's row (see
    ``nack_mark_lanes_``). rtx [B, F, W] (or [F, W]), base [B, F],
    flow / psn / nack [B, L] views whose rows may be slices of wider
    rows (a unit lane stride and one scenario stride for the three);
    rod [F]."""
    _on_cuda(rtx, base, flow, psn, nack, rod)
    bsz, f, w, per = _lane_batch(rtx, flow)
    _require("rtx", rtx, torch.int32, (bsz, f, w) if rtx.dim() == 3
             else (f, w))
    _require("base", base, torch.int32, tuple(rtx.shape[:-1]))
    ld = _lane_rows("flow", flow, torch.int32, bsz, per)
    for name, t, dt in (("psn", psn, torch.int32), ("nack", nack, torch.bool)):
        if _lane_rows(name, t, dt, bsz, per) != ld:
            raise ValueError("flow, psn and nack must share one scenario "
                             "stride")
    if rod is not None:
        _require("rod", rod, torch.bool, (f,))
    lanes = bsz * per
    if lanes and f:
        _launch("nack_mark_lanes", "nack_mark", rtx, rtx.data_ptr(),
                base.data_ptr(), flow.data_ptr(), psn.data_ptr(),
                nack.data_ptr(), None if rod is None else rod.data_ptr(),
                lanes, per, ld, f, w)
    return rtx


def _lane_batch(rtx: torch.Tensor, flow: torch.Tensor):
    """(B, F, W, L) of a [B, F, W] ring with [B, L] lanes, or of an
    [F, W] ring with [L] lanes (B = 1)."""
    if rtx.dim() == 2:
        f, w = _ring_shape(rtx)
        if flow.dim() != 1:
            raise ValueError(f"an [F, W] ring takes [L] lanes, got "
                             f"{tuple(flow.shape)}")
        return 1, f, w, int(flow.shape[0])
    if rtx.dim() != 3 or flow.dim() != 2 or flow.shape[0] != rtx.shape[0]:
        raise ValueError(f"a [B, F, W] ring takes [B, L] lanes, got "
                         f"{tuple(rtx.shape)} and {tuple(flow.shape)}")
    _, w = _ring_shape(rtx[0])
    return (int(rtx.shape[0]), int(rtx.shape[1]), w, int(flow.shape[1]))


def _lane_rows(name: str, t: torch.Tensor, dtype: torch.dtype, bsz: int,
               per: int) -> int:
    """Check [B, L] (or [L]) lanes on the card with a unit lane stride;
    return their scenario stride in elements."""
    _card(name, t)
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() == 1:
        if tuple(t.shape) != (per,) or (per > 1 and t.stride(0) != 1):
            raise ValueError(f"{name} must be [{per}] and contiguous")
        return per
    if tuple(t.shape) != (bsz, per) or (per > 1 and t.stride(1) != 1):
        raise ValueError(f"{name} must be [{bsz}, {per}] with unit lane "
                         f"stride, got {tuple(t.shape)} {t.stride()}")
    return int(t.stride(0)) if bsz > 1 else per


def _own_bit_operands(rtx, off, valid):
    n, w = _ring_shape(rtx)
    _require("rtx", rtx, torch.int32, (n, w))
    _require("off", off, torch.int32, (n,))
    _require("valid", valid, torch.bool, (n,))
    return n, w


def set_own_bit_cuda(rtx: torch.Tensor, off: torch.Tensor, valid: torch.Tensor,
                     unless: "torch.Tensor | None" = None) -> torch.Tensor:
    """CUDA kernel, in place on ``rtx``: row i sets bit off[i] where
    valid[i] (and, with ``unless``, that bit of unless is clear)."""
    _on_cuda(rtx, off, valid, unless)
    n, w = _own_bit_operands(rtx, off, valid)
    if unless is not None:
        _require("unless", unless, torch.int32, (n, w))
    if n:
        _launch("set_own_bit", "nack_mark", rtx, rtx.data_ptr(),
                off.data_ptr(), valid.data_ptr(),
                None if unless is None else unless.data_ptr(), n, w)
    return rtx


def clear_own_bit_cuda(rtx: torch.Tensor, off: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """CUDA kernel, in place on ``rtx``: row i clears bit off[i] where
    valid[i]."""
    _on_cuda(rtx, off, valid)
    n, w = _own_bit_operands(rtx, off, valid)
    if n:
        _launch("clear_own_bit", "nack_mark", rtx, rtx.data_ptr(),
                off.data_ptr(), valid.data_ptr(), n, w)
    return rtx


def nscc_update_cuda(cwnd: torch.Tensor, ecn: torch.Tensor, rtt: torch.Tensor,
                     count: torch.Tensor,
                     params: NSCCParams = NSCCParams()) -> torch.Tensor:
    """CUDA kernel: batched NSCC window update of [N] windows (ecn bool)."""
    _on_cuda(cwnd, ecn, rtt, count)
    n = _lanes(cwnd)
    _require("cwnd", cwnd, torch.float32, (n,))
    _require("ecn", ecn, torch.bool, (n,))
    _require("rtt", rtt, torch.float32, (n,))
    _require("count", count, torch.int32, (n,))
    out = torch.empty_like(cwnd)
    if n:
        # each constant rounded to f32 once, from the Python double, as
        # JAX and PyTorch round a Python scalar against an f32 tensor
        consts = (params.base_rtt * params.target_factor, -params.md,
                  params.quick_gain, params.ai, 1e-6, params.min_cwnd,
                  params.max_cwnd)
        _launch("nscc_update", "nscc_update", cwnd, cwnd.data_ptr(),
                ecn.data_ptr(), rtt.data_ptr(), count.data_ptr(),
                out.data_ptr(), n, *consts)
    return out


def ecmp_select_cuda(src: torch.Tensor, dst: torch.Tensor, ev: torch.Tensor,
                     salt: torch.Tensor, fanout: int) -> torch.Tensor:
    """CUDA kernel: ECMP port choice of [N] packet lanes, in [0, fanout)."""
    _on_cuda(src, dst, ev, salt)
    _check_fanout(fanout)
    n = _lanes(src)
    for name, t in (("src", src), ("dst", dst), ("ev", ev), ("salt", salt)):
        _require(name, t, torch.int32, (n,))
    out = torch.empty_like(src)
    if n:
        _launch("ecmp_select", "ecmp_hash", src, src.data_ptr(),
                dst.data_ptr(), ev.data_ptr(), salt.data_ptr(),
                out.data_ptr(), n, int(fanout))
    return out


@functools.lru_cache(maxsize=None)
def _window_consts(params: NSCCParams) -> tuple:
    """The ACK form's constants in its C order: target, the folded
    reciprocal of the tick's gap, -md, quick_gain, ai, eps = 1e-6,
    min_cwnd, max_cwnd (each rounded to f32 once, by ctypes, from the
    Python double)."""
    target = params.base_rtt * params.target_factor
    return (target, _f32_reciprocal(target), -params.md, params.quick_gain,
            params.ai, 1e-6, params.min_cwnd, params.max_cwnd)


def nscc_ack_cuda(cwnd: torch.Tensor, epoch_acked: torch.Tensor,
                  has_ack: torch.Tensor, ecn: torch.Tensor, rtt: torch.Tensor,
                  params: NSCCParams):
    """CUDA kernel: the tick's NSCC ACK update of [N] windows (one ACK
    where ``has_ack``, the folded gap): (cwnd', epoch_acked')."""
    _on_cuda(cwnd, epoch_acked, has_ack, ecn, rtt)
    n = _lanes(cwnd)
    _require("cwnd", cwnd, torch.float32, (n,))
    _require("epoch_acked", epoch_acked, torch.int32, (n,))
    _require("has_ack", has_ack, torch.bool, (n,))
    _require("ecn", ecn, torch.bool, (n,))
    _require("rtt", rtt, torch.float32, (n,))
    cwnd_out, acked_out = torch.empty_like(cwnd), torch.empty_like(epoch_acked)
    if n:
        _launch("nscc_ack", "nscc_update", cwnd, cwnd.data_ptr(),
                epoch_acked.data_ptr(), has_ack.data_ptr(), ecn.data_ptr(),
                rtt.data_ptr(), cwnd_out.data_ptr(), acked_out.data_ptr(), n,
                *_window_consts(params))
    return cwnd_out, acked_out


def _int32(name: str, v: int) -> int:
    if not -2 ** 31 <= int(v) < 2 ** 31:
        raise ValueError(f"{name} must fit an int32, got {v}")
    return int(v)


def nscc_epoch_cuda(cwnd: torch.Tensor, epoch_acked: torch.Tensor,
                    epoch_lost: torch.Tensor, epoch_tick: torch.Tensor,
                    now: int, params: NSCCParams):
    """CUDA kernel: Quick Adapt of [N] windows at tick ``now`` (a Python
    int): (cwnd', epoch_acked', epoch_lost', epoch_tick')."""
    _on_cuda(cwnd, epoch_acked, epoch_lost, epoch_tick)
    n = _lanes(cwnd)
    _require("cwnd", cwnd, torch.float32, (n,))
    for name, t in (("epoch_acked", epoch_acked), ("epoch_lost", epoch_lost),
                    ("epoch_tick", epoch_tick)):
        _require(name, t, torch.int32, (n,))
    outs = (torch.empty_like(cwnd), torch.empty_like(epoch_acked),
            torch.empty_like(epoch_lost), torch.empty_like(epoch_tick))
    if n:
        epoch_len = _int32("epoch_len",
                           int(params.base_rtt * params.target_factor))
        _launch("nscc_epoch", "nscc_update", cwnd, cwnd.data_ptr(),
                epoch_acked.data_ptr(), epoch_lost.data_ptr(),
                epoch_tick.data_ptr(), *(o.data_ptr() for o in outs), n,
                _int32("now", now), epoch_len,
                params.qa_min_frac * params.max_cwnd, params.min_cwnd,
                params.max_cwnd)
    return outs


def _tables(tables, names, device) -> "list[torch.Tensor]":
    """The named [R] or [R, C] int32 routing tables, checked on
    ``device``."""
    out = []
    for name in names:
        t = getattr(tables, name)
        if t.device != device:
            raise ValueError(f"routing table {name} is on {t.device}, the "
                             f"lanes on {device}")
        _require(name, t, torch.int32, t.shape)
        out.append(t)
    return out


def _strided_lanes(name: str, t: torch.Tensor, n: int) -> int:
    """Check [n] int32 lanes on the card, read in place at any element
    stride; return the stride."""
    _card(name, t)
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
    if tuple(t.shape) != (n,):
        raise ValueError(f"{name} must have shape ({n},), got "
                         f"{tuple(t.shape)}")
    return int(t.stride(0))


def ecmp_inject_cuda(tables, src: torch.Tensor, dst: torch.Tensor,
                     ev: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: the first queue of [N] packet lanes injected at host
    ``src`` toward ``dst`` on entropy ``ev`` (``RoutingTables``); each
    lane is read in place at its own element stride."""
    _on_cuda(src, dst, ev)
    n = _lanes(src)
    strides = [_strided_lanes(name, t, n)
               for name, t in (("src", src), ("dst", dst), ("ev", ev))]
    leaf, hq, up1 = _tables(tables, ("host_leaf", "host_queue", "up1"),
                            src.device)
    hosts, (leaves, fan) = leaf.shape[0], up1.shape
    if hq.shape != (hosts,) or fan != tables.g.fanout1:
        raise ValueError("host_queue must be [H] and up1 [L, fanout1]")
    out = torch.empty((n,), dtype=torch.int32, device=src.device)
    if n:
        _launch("ecmp_inject", "ecmp_hash", src, src.data_ptr(), strides[0],
                dst.data_ptr(), strides[1], ev.data_ptr(), strides[2],
                out.data_ptr(), n, leaf.data_ptr(), hq.data_ptr(),
                up1.data_ptr(), hosts, leaves, fan)
    return out


def ecmp_route_cuda(tables, queue: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: the next queue of [B, P] queue-head lanes (or [P]:
    B = 1) dequeued from ``queue``, whose ids are [P] (the same for every
    scenario, read with a zero scenario stride) or [B, P]
    (``RoutingTables``)."""
    _on_cuda(queue, src, dst, ev)
    if src.dim() not in (1, 2):
        raise ValueError(f"lanes must be [B, P] or [P], got "
                         f"{tuple(src.shape)}")
    batch, per = (1, int(src.shape[0])) if src.dim() == 1 else src.shape
    for name, t in (("src", src), ("dst", dst), ("ev", ev)):
        _require(name, t, torch.int32, src.shape)
    q_stride = 0 if tuple(queue.shape) == (per,) else per
    _require("queue", queue, torch.int32,
             (per,) if q_stride == 0 else src.shape)
    three = bool(tables.three_level)
    names = ("stage", "next_switch", "host_leaf", "host_queue", "host_pod",
             "down1") + (("up2", "down2") if three else ())
    tabs = _tables(tables, names, src.device)
    stage, nxt, leaf, hq, pod, down1 = tabs[:6]
    nq, hosts = stage.shape[0], leaf.shape[0]
    d1_rows, d1_cols = down1.shape
    up2, down2 = tabs[6:] if three else (None, None)
    half, (d2_rows, d2_cols) = ((up2.shape[1], down2.shape) if three
                                else (0, (0, 0)))
    if (nxt.shape != (nq,) or hq.shape != (hosts,) or pod.shape != (hosts,)
            or (three and up2.shape[0] != d1_rows)):
        raise ValueError("routing tables of mismatched shapes")
    out = torch.empty_like(src)
    if batch * per:
        _launch("ecmp_route", "ecmp_hash", src, queue.data_ptr(), q_stride,
                src.data_ptr(), dst.data_ptr(), ev.data_ptr(),
                out.data_ptr(), batch, per, stage.data_ptr(), nxt.data_ptr(),
                leaf.data_ptr(), hq.data_ptr(), pod.data_ptr(),
                down1.data_ptr(), None if up2 is None else up2.data_ptr(),
                None if down2 is None else down2.data_ptr(), nq, hosts,
                int(tables.up1.shape[0]), int(tables.aggs_per_pod), d1_rows,
                d1_cols, half, d2_rows, d2_cols, int(three))
    return out


#: device index -> the shared memory a block may opt into (bytes)
_SMEM_OPTIN: dict = {}


def _smem_optin(dev: torch.device) -> int:
    """The bytes of shared memory a block may opt into on ``dev``
    (queried once a device)."""
    optin = _SMEM_OPTIN.get(dev.index)
    if optin is None:
        with torch.cuda.device(dev):
            optin = build.load("enqueue").enqueue_rank_smem_optin()
        if optin < 0:
            raise RuntimeError(f"shared memory query failed: CUDA error "
                               f"{-optin}")
        _SMEM_OPTIN[dev.index] = optin
    return optin


def _counters_fit(dev: torch.device, q: int) -> bool:
    """Whether ``enqueue_rank``'s Q int32 counters fit one block's shared
    memory on ``dev``."""
    return 4 * q <= _smem_optin(dev)


def enqueue_rank_cuda(target: torch.Tensor, valid: torch.Tensor,
                      base: torch.Tensor, capacity: int):
    """CUDA kernel: the arrival ranks of [B, n] candidate lanes within
    their target queues and each of the [B, Q] queues' fitting lanes
    (see ``enqueue_rank``): (pos, added, fits). The counters live in
    shared memory, or in a [B, Q] scratch where Q does not fit it."""
    _on_cuda(target, valid, base)
    if target.dim() != 2 or base.dim() != 2:
        raise ValueError(f"lanes must be [B, n] and base [B, Q], got "
                         f"{tuple(target.shape)} and {tuple(base.shape)}")
    (batch, n), q = target.shape, int(base.shape[1])
    if q < 1:
        raise ValueError("base must hold at least one queue")
    _require("target", target, torch.int32, (batch, n))
    _require("valid", valid, torch.bool, (batch, n))
    _require("base", base, torch.int32, (batch, q))
    pos, fits = torch.empty_like(target), torch.empty_like(valid)
    added = torch.empty_like(base)
    scratch = (None if _counters_fit(target.device, q)
               else torch.empty_like(base))
    if batch:
        _launch("enqueue_rank", "enqueue", target, target.data_ptr(),
                valid.data_ptr(), base.data_ptr(), pos.data_ptr(),
                added.data_ptr(), fits.data_ptr(),
                None if scratch is None else scratch.data_ptr(), batch, n, q,
                _int32("capacity", capacity))
    return pos, added, fits


#: the most lane masks and sums one ``flow_fold`` launch takes
FOLD_MASKS, FOLD_SUMS = 3, 4


def flow_fold_cuda(flow: torch.Tensor, num_flows: int, masks, sums):
    """CUDA kernel: the per-flow folds of [B, L] lanes (see
    ``flow_fold``): (counts [M, B, F], totals [S, B, F]), two views of
    one int32 output. The counters live in shared memory, or, where
    (M + S) F of them do not fit it, in the zeroed output."""
    _on_cuda(flow, *masks, *(v for _, v in sums))
    if flow.dim() != 2:
        raise ValueError(f"flow must be [B, L], got {tuple(flow.shape)}")
    m, n_sums = len(masks), len(sums)
    if not (1 <= m <= FOLD_MASKS and 1 <= n_sums <= FOLD_SUMS):
        raise ValueError(f"flow_fold takes 1-{FOLD_MASKS} masks and 1-"
                         f"{FOLD_SUMS} sums, got {m} and {n_sums}")
    f = _int32("num_flows", num_flows)
    if f < 1:
        raise ValueError("num_flows must be at least 1")
    batch, lanes = flow.shape
    _require("flow", flow, torch.int32, (batch, lanes))
    for i, t in enumerate(masks):
        _require(f"masks[{i}]", t, torch.bool, (batch, lanes))
    packed = 0
    for j, (k, v) in enumerate(sums):
        if not 0 <= k < m:
            raise ValueError(f"sums[{j}] reads mask {k} of {m}")
        _require(f"sums[{j}]", v, torch.int32, (batch, lanes))
        packed |= k << 2 * j
    shared = 4 * (m + n_sums) * f <= _smem_optin(flow.device)
    out = (torch.empty if shared else torch.zeros)(
        (m + n_sums, batch, f), dtype=torch.int32, device=flow.device)
    if batch:
        ptrs = ([t.data_ptr() for t in masks] + [None] * (FOLD_MASKS - m)
                + [v.data_ptr() for _, v in sums]
                + [None] * (FOLD_SUMS - n_sums))
        _launch("flow_fold", "flow_fold", flow, flow.data_ptr(), *ptrs,
                out.data_ptr(), batch, lanes, f, m, n_sums, packed,
                int(shared))
    return out[:m], out[m:]


def _check_fanout(fanout: int) -> None:
    if not 1 <= int(fanout) < 2 ** 31:
        raise ValueError(f"fanout must be in [1, 2**31), got {fanout}")


# ------------------------------------------------------------ dispatch --

def sack_advance(ring, base):
    """CACK advance (Sec. 3.2.5): (ring', base', adv)."""
    if _on_cuda(ring, base):
        return sack_advance_cuda(ring, base)
    return ref.sack_advance_ref(ring, base)


def sack_fused(ring, base, rtx, mask):
    """Fused record-rx OR + CACK advance + dual ring shift (Sec. 3.2.5):
    (ring', base', rtx', adv)."""
    if _on_cuda(ring, base, rtx, mask):
        return sack_fused_cuda(ring, base, rtx, mask)
    return ref.sack_fused_ref(ring, base, rtx, mask)


def _flat_rows(ring: torch.Tensor, *lanes: torch.Tensor):
    """The [..., N, W] ring and its [..., N] lanes as [R, W] rows and
    [R] lanes (views of contiguous tensors)."""
    return (ring.reshape(-1, ring.shape[-1]),
            *(t.reshape(-1) for t in lanes))


def _unflat(outs, ring_shape, lane_shape):
    """Outputs over [R] rows back to the caller's leading axes."""
    return tuple(o.view(ring_shape if o.dim() == 2 else lane_shape)
                 for o in outs)


def sack_advance_own(ring, base, off, ok):
    """CACK advance recording each row's own received bit ``off``
    (PSN - base, int32) where ``ok`` (bool): (ring', base', adv,
    already). Rows may carry leading scenario axes ([..., N, W] ring,
    [..., N] lanes): one launch over all of them."""
    with spans.span("kernels.sack_advance_own"):
        args = _flat_rows(ring, base, off, ok)
        if _on_cuda(*args):
            outs = sack_advance_own_cuda(*args)
        else:
            outs = ref.sack_advance_own_ref(*args)
        return _unflat(outs, ring.shape, base.shape)


def sack_fused_own(ring, base, rtx, off, ok, clear):
    """Fused SACK on each row's own ACKed bit ``off`` (int32) where
    ``ok``, then bit ``off - adv`` of the shifted rtx cleared where
    ``clear`` (bool): (ring', base', rtx', adv, already). Rows may carry
    leading scenario axes, as in ``sack_advance_own``."""
    with spans.span("kernels.sack_fused_own"):
        r, b, o, k, c = _flat_rows(ring, base, off, ok, clear)
        x = rtx.reshape(-1, rtx.shape[-1])
        if _on_cuda(r, b, x, o, k, c):
            outs = sack_fused_own_cuda(r, b, x, o, k, c)
        else:
            outs = ref.sack_fused_own_ref(r, b, x, o, k, c)
        return _unflat(outs, ring.shape, base.shape)


def nack_mark(rtx, flow, off, valid):
    """Duplicate-safe OR of NACK-requested retransmit bits (Sec. 3.2.4),
    into a new ring."""
    if _on_cuda(rtx, flow, off, valid):
        return nack_mark_cuda(rtx, flow, off, valid)
    return ref.nack_mark_ref(rtx, flow, off, valid)


def nack_mark_lanes_(rtx, base, flow, psn, nack, rod=None):
    """The tick's NACK site, in place on ``rtx`` (Sec. 3.2.4), over B
    scenarios: ``rtx`` [B, F, W] with ``base`` [B, F] and [B, L] lanes
    (or [F, W], [F] and [L]: B = 1). Lane l of scenario b with nack[b,
    l], 0 <= flow[b, l] < F and, given the [F] ROD mask ``rod``, a
    non-ROD flow, sets bit psn[b, l] - base[b, flow[b, l]] (uint32 wrap)
    of scenario b's row flow[b, l] where that offset is in [0, W*32); a
    lane never reaches another scenario's rows. Returns ``rtx``."""
    with spans.span("kernels.nack_mark_lanes"):
        if _on_cuda(rtx, base, flow, psn, nack, rod):
            _own_ring(rtx)
            return nack_mark_lanes_cuda(rtx, base, flow, psn, nack, rod)
        return ref.nack_mark_lanes_ref_(rtx, base, flow, psn, nack, rod)


def _own_ring(rtx: torch.Tensor) -> None:
    """An in-place form writes through a [R, W] view of ``rtx``: it must
    be contiguous, or the view would be a copy and the marks lost."""
    if not rtx.is_contiguous():
        raise ValueError("the ring an in-place mark writes must be "
                         "contiguous")


def set_own_bit_(rtx, off, valid, unless=None):
    """In place on ``rtx`` [..., N, W]: row i sets bit off[i] (int32)
    where valid[i] and 0 <= off[i] < W*32 and, given the [..., N, W]
    ring ``unless``, where that bit of unless is clear. Leading
    scenario axes are one launch over all rows. Returns ``rtx``."""
    with spans.span("kernels.set_own_bit"):
        _own_ring(rtx)
        r, o, v = _flat_rows(rtx, off, valid)
        u = None if unless is None else unless.reshape(r.shape)
        if _on_cuda(r, o, v, u):
            set_own_bit_cuda(r, o, v, u)
        else:
            ref.set_own_bit_ref_(r, o, v, u)
        return rtx


def clear_own_bit_(rtx, off, valid):
    """In place on ``rtx`` [..., N, W]: row i clears bit off[i] (int32)
    where valid[i] and 0 <= off[i] < W*32. Returns ``rtx``."""
    with spans.span("kernels.clear_own_bit"):
        _own_ring(rtx)
        r, o, v = _flat_rows(rtx, off, valid)
        if _on_cuda(r, o, v):
            clear_own_bit_cuda(r, o, v)
        else:
            ref.clear_own_bit_ref_(r, o, v)
        return rtx


def nscc_update(cwnd, ecn, rtt, count, params: NSCCParams = NSCCParams()):
    """Batched NSCC window update (Sec. 3.3.1) of [N] windows; ``ecn`` is
    bool or integer (nonzero = ECN-CE)."""
    if ecn.dtype != torch.bool:
        ecn = ecn != 0
    if _on_cuda(cwnd, ecn, rtt, count):
        return nscc_update_cuda(cwnd, ecn, rtt, count, params)
    return ref.nscc_update_ref(cwnd, ecn, rtt, count, params)


def ecmp_select(src, dst, ev, salt, fanout: int):
    """ECMP port choice (Sec. 2.1): [N] int32 in [0, fanout). The four
    lanes are int32 tensors (uint32 as bit patterns); ``fanout >= 1``."""
    _check_fanout(fanout)
    for name, t in (("src", src), ("dst", dst), ("ev", ev), ("salt", salt)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32 (uint32 lanes as "
                            f"bit patterns), got {t.dtype}")
    if _on_cuda(src, dst, ev, salt):
        return ecmp_select_cuda(src, dst, ev, salt, fanout)
    return ref.ecmp_hash_ref(src, dst, ev, salt, fanout)


def nscc_ack(cwnd, epoch_acked, has_ack, ecn, rtt, params: NSCCParams):
    """The tick's NSCC ACK hook (Sec. 3.3.1) over per-flow lanes of one
    shape ([F] or [B, F]): one ACK a flow where ``has_ack``, the gap in
    the compiled tick's folded form, the window clipped to [min_cwnd,
    max_cwnd], ``epoch_acked`` counting the ACK. Returns fresh (cwnd',
    epoch_acked'); one launch on a card."""
    with spans.span("kernels.nscc_ack"):
        args = (cwnd, epoch_acked, has_ack, ecn, rtt)
        if _on_cuda(*args):
            outs = nscc_ack_cuda(*(t.reshape(-1) for t in args), params)
            return tuple(o.view(cwnd.shape) for o in outs)
        return ref.nscc_ack_ref(*args, params)


def nscc_epoch(cwnd, epoch_acked, epoch_lost, epoch_tick, now: int,
               params: NSCCParams):
    """The tick's Quick Adapt (Sec. 3.3.1) at tick ``now`` (a Python int)
    over per-flow lanes of one shape. Returns fresh (cwnd',
    epoch_acked', epoch_lost', epoch_tick'); one launch on a card."""
    with spans.span("kernels.nscc_epoch"):
        args = (cwnd, epoch_acked, epoch_lost, epoch_tick)
        if _on_cuda(*args):
            outs = nscc_epoch_cuda(*(t.reshape(-1) for t in args), now, params)
            return tuple(o.view(cwnd.shape) for o in outs)
        return ref.nscc_epoch_ref(*args, now, params)


def _lane_shape(*ts: torch.Tensor) -> torch.Size:
    """The broadcast shape of lanes that mostly share one shape: the
    shape itself without ``torch.broadcast_shapes``'s Python walk."""
    shape = ts[0].shape
    if all(t.shape == shape for t in ts[1:]):
        return shape
    return torch.broadcast_shapes(*(t.shape for t in ts))


def ecmp_inject(tables, src, dst, ev):
    """The first queue of packets injected at host ``src`` toward ``dst``
    on entropy value ``ev`` (Sec. 2.1), through ``tables`` (a
    ``RoutingTables``); int32 lanes of broadcastable shapes, each read in
    place where its elements lie at one stride (a strided slice such as
    ``ev_set[..., 0]`` included). One launch on a card."""
    with spans.span("kernels.ecmp_inject"):
        if _on_cuda(src, dst, ev):
            shape = _lane_shape(src, dst, ev)
            lanes = (t.expand(shape).reshape(-1) for t in (src, dst, ev))
            return ecmp_inject_cuda(tables, *lanes).view(shape)
        return ref.ecmp_inject_ref(tables, src, dst, ev)


def ecmp_route(tables, queue, src, dst, ev):
    """The next queue of packets just dequeued from ``queue`` (DELIVERED
    leaving a HOST queue; Sec. 2.1), through ``tables`` (a
    ``RoutingTables``); int32 lanes of broadcastable shapes. A [P] queue
    under [B, P] lanes — the tick's ids under its scenarios — is read
    once for all scenarios. One launch on a card."""
    with spans.span("kernels.ecmp_route"):
        if _on_cuda(queue, src, dst, ev):
            shape = _lane_shape(src, dst, ev)
            shared = queue.dim() == 1 and queue.shape == shape[-1:]
            if not shared and queue.shape != shape:
                shape = _lane_shape(queue, src, dst, ev)
            per = shape[-1] if shape else 1
            rows = math.prod(shape) // per if per else 0
            src, dst, ev = (t.expand(shape).reshape(rows, per).contiguous()
                            for t in (src, dst, ev))
            if not shared:
                queue = queue.expand(shape).reshape(rows, per)
            return ecmp_route_cuda(tables, queue.contiguous(), src, dst,
                                   ev).view(shape)
        return ref.ecmp_route_ref(tables, queue, src, dst, ev)


def enqueue_rank(target, valid, base, capacity: int):
    """The tick's enqueue phase (section 7 of ``make_step``): each
    candidate lane's queue position and each queue's enqueue count, over
    leading scenario axes. target [..., n] int32, valid [..., n] bool
    (a valid lane's target in [0, Q)), base [..., Q] int32 (each queue's
    length). Returns (pos, added, fits): pos [..., n] = base[target] +
    the lane's arrival rank, #{j < i : valid[j], target[j] == target[i]}
    (base[0] on an invalid lane); fits = valid & (pos < capacity); added
    [..., Q] the fitting lanes a queue. One launch on a card, linear in
    n and Q, where the plain version builds [..., n, n] and [..., Q, n]
    one-hots."""
    with spans.span("kernels.enqueue_rank"):
        if _on_cuda(target, valid, base):
            n, q = target.shape[-1], base.shape[-1]
            outs = enqueue_rank_cuda(target.reshape(-1, n).contiguous(),
                                     valid.reshape(-1, n).contiguous(),
                                     base.reshape(-1, q).contiguous(),
                                     capacity)
            return (outs[0].view(target.shape), outs[1].view(base.shape),
                    outs[2].view(valid.shape))
        return ref.enqueue_rank_ref(target, valid, base, capacity)


def flow_fold(flow, num_flows: int, masks, sums):
    """The tick's per-flow folds of its event lanes (sections 1 and 5 of
    ``make_step``), over leading scenario axes. flow [..., L] int32 (a
    lane's flow; one outside [0, num_flows) folds nowhere), masks 1-3
    [..., L] bool, sums 1-4 pairs (k, value [..., L] int32). Returns
    (counts, totals): counts [M, ..., F] int32, the lanes of each mask a
    flow; totals [S, ..., F] int32, each value's sum over the lanes of
    its mask k a flow, wrapping as ``torch.sum(dtype=int32)`` does. One
    launch on a card, linear in the lanes, where the plain version builds
    a [..., F, L] one-hot."""
    with spans.span("kernels.flow_fold"):
        if _on_cuda(flow, *masks, *(v for _, v in sums)):
            lead, n = flow.shape[:-1], flow.shape[-1]

            def rows(t):
                return t.reshape(-1, n).contiguous()
            counts, totals = flow_fold_cuda(
                rows(flow), num_flows, [rows(m) for m in masks],
                [(k, rows(v)) for k, v in sums])
            return (counts.view(len(masks), *lead, num_flows),
                    totals.view(len(sums), *lead, num_flows))
        return ref.flow_fold_ref(flow, num_flows, masks, sums)
