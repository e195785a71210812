"""Dispatch for the port's five kernels (the port of
``repro.kernels.ops``): the fabric tick's ``sack_fused``, ``nack_mark``
and ``sack_advance``, and the batched ``nscc_update`` and
``ecmp_select``.

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
            "nscc_update": 0, "ecmp_select": 0}

MAX_WORDS = 32  # one warp per ring row: W <= 32 words (mp_range <= 1024)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True for operands on one CUDA device, False for CPU operands;
    raises for mixed or other devices."""
    dev = {t.device for t in ts}
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


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
        with torch.cuda.device(ring.device):
            lib = build.load("sack")
            _check(lib.sack_advance_launch(
                ring.data_ptr(), base.data_ptr(), ring_out.data_ptr(),
                base_out.data_ptr(), adv.data_ptr(), n, w, _stream(ring)),
                "sack_advance")
        LAUNCHES["sack_advance"] += 1
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
        with torch.cuda.device(ring.device):
            lib = build.load("sack")
            _check(lib.sack_fused_launch(
                ring.data_ptr(), base.data_ptr(), rtx.data_ptr(),
                mask.data_ptr(), ring_out.data_ptr(), base_out.data_ptr(),
                rtx_out.data_ptr(), adv.data_ptr(), n, w, _stream(ring)),
                "sack_fused")
        LAUNCHES["sack_fused"] += 1
    return ring_out, base_out, rtx_out, adv


def nack_mark_cuda(rtx: torch.Tensor, flow: torch.Tensor, off: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: OR lane-requested retransmit bits into [F, W] rings."""
    _on_cuda(rtx, flow, off, valid)
    f, w = _ring_shape(rtx)
    lanes = int(flow.shape[0]) if flow.dim() == 1 else -1
    _require("rtx", rtx, torch.int32, (f, w))
    _require("flow", flow, torch.int32, (lanes,))
    _require("off", off, torch.int32, (lanes,))
    _require("valid", valid, torch.bool, (lanes,))
    out = rtx.clone()
    if lanes and f:
        with torch.cuda.device(rtx.device):
            lib = build.load("nack_mark")
            _check(lib.nack_mark_launch(
                out.data_ptr(), flow.data_ptr(), off.data_ptr(),
                valid.data_ptr(), lanes, f, w, _stream(rtx)), "nack_mark")
        LAUNCHES["nack_mark"] += 1
    return out


def _lanes(t: torch.Tensor) -> int:
    return int(t.shape[0]) if t.dim() == 1 else -1


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
        with torch.cuda.device(cwnd.device):
            lib = build.load("nscc_update")
            _check(lib.nscc_update_launch(
                cwnd.data_ptr(), ecn.data_ptr(), rtt.data_ptr(),
                count.data_ptr(), out.data_ptr(), n, *consts,
                _stream(cwnd)), "nscc_update")
        LAUNCHES["nscc_update"] += 1
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
        with torch.cuda.device(src.device):
            lib = build.load("ecmp_hash")
            _check(lib.ecmp_select_launch(
                src.data_ptr(), dst.data_ptr(), ev.data_ptr(),
                salt.data_ptr(), out.data_ptr(), n, int(fanout),
                _stream(src)), "ecmp_select")
        LAUNCHES["ecmp_select"] += 1
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


def nack_mark(rtx, flow, off, valid):
    """Duplicate-safe OR of NACK-requested retransmit bits (Sec. 3.2.4)."""
    if _on_cuda(rtx, flow, off, valid):
        return nack_mark_cuda(rtx, flow, off, valid)
    return ref.nack_mark_ref(rtx, flow, off, valid)


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
