"""Dispatch for the port's kernels (the port of ``repro.kernels.ops``,
plus the forms the port's tick runs): ``sack_fused``, ``nack_mark`` and
``sack_advance`` of the reference's tick; the own-bit SACK forms
``sack_fused_own`` / ``sack_advance_own``; the in-place marks on the
retransmit ring, ``nack_mark_lanes_`` (the NACK site), ``set_own_bit_``
and ``clear_own_bit_`` (one bit per row); and the batched
``nscc_update`` and ``ecmp_select``.

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
its main path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.cms.nscc import NSCCParams
from repro_torch.kernels import build, ref

LAUNCHES = {"sack_fused": 0, "nack_mark": 0, "sack_advance": 0,
            "sack_fused_own": 0, "sack_advance_own": 0,
            "nack_mark_lanes": 0, "set_own_bit": 0, "clear_own_bit": 0,
            "nscc_update": 0, "ecmp_select": 0}

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


def _require(name: str, t: torch.Tensor, dtype: torch.dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor for the kernel, "
                         f"got {t.device}")
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
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor for the kernel, "
                         f"got {t.device}")
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
