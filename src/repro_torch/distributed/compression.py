"""Gradient compression with error feedback — the port of
``repro.distributed.compression``.

int8 block-quantized gradient exchange: before the data-parallel
all-reduce, gradients are quantized to int8 with a per-block f32 scale
(block = last dim tile of 256), and the quantization error is carried to
the next step (error feedback keeps SGD/Adam convergence — Karimireddy et
al.). This cuts the dominant DP all-reduce bytes 4x (bf16 -> int8+scales);
the fabric-level view is fewer packets through the UET transport for the
same step.

Both packages round half to even (``jnp.round``, ``torch.round``) and
divide exactly in f32 (each divisor a tensor on the operand's device,
since CUDA multiplies by the reciprocal of a python scalar), so ``q``,
``scale`` and the carried error are the reference's bits, on the CPU
and on the card.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as T

BLOCK = 256
f32 = torch.float32


def _pad_to_block(x: torch.Tensor):
    n = x.numel()
    pad = (-n) % BLOCK
    flat = torch.nn.functional.pad(x.reshape(-1), (0, pad))
    return flat.reshape(-1, BLOCK), n


def quantize(g: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """g (any shape, float) -> (int8 blocks [N, BLOCK], scales [N] f32)."""
    blocks, _ = _pad_to_block(g.to(f32))
    # a true division on every device: CUDA multiplies by the reciprocal
    # of a python scalar divisor
    scale = torch.amax(torch.abs(blocks), dim=1) / torch.tensor(
        127.0, dtype=f32, device=blocks.device)
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)[:, None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               dtype) -> torch.Tensor:
    flat = (q.to(f32) * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(tuple(shape)).to(dtype)


def compress_tree(grads: Any, error: "Any | None"):
    """Quantize a gradient tree, adding carried error feedback.

    Returns (quantized tree of (q, scale), new_error tree)."""
    if error is None:
        error = T.map(torch.zeros_like, grads)

    def one(g, e):
        corrected = g + e.to(g.dtype)
        q, s = quantize(corrected)
        deq = dequantize(q, s, g.shape, g.dtype)
        return (q, s), (corrected - deq).to(g.dtype)

    pairs = T.map(one, grads, error)
    return (_pick(pairs, 0), _pick(pairs, 1))


def _pick(pairs, i: int):
    """Element ``i`` of every (quantized, error) pair of ``compress_tree``."""
    if isinstance(pairs, dict):
        return {k: _pick(v, i) for k, v in pairs.items()}
    return pairs[i]


def decompress_tree(qtree: Any, ref: Any) -> Any:
    """Inverse of compress_tree against reference shapes / dtypes."""
    if isinstance(ref, dict):
        return {k: decompress_tree(qtree[k], v) for k, v in ref.items()}
    q, s = qtree
    return dequantize(q, s, ref.shape, ref.dtype)


def compressed_bytes(tree: Any) -> int:
    """Wire bytes after compression (int8 payload + f32 scales)."""
    total = 0
    for leaf in T.leaves(tree):
        n = leaf.numel()
        blocks = -(-n // BLOCK)
        total += blocks * BLOCK + blocks * 4
    return total
