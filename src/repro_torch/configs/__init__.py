"""Config registry: ``get(name)`` returns the full ArchConfig; ``reduced``
returns a tiny same-family config for CPU smoke tests.

The port's own copy of ``repro.configs`` (pure python: the port imports
nothing of the reference package): the parallelism planner and the
traffic sweep look architectures up here by name."""
from __future__ import annotations

from dataclasses import replace

from repro_torch.configs.base import (ArchConfig, ShapeConfig, SHAPES,
                                      shapes_for, pad_for_tp)

_MODULES = {
    "deepseek-coder-33b": "deepseek_coder_33b",
    "minitron-4b": "minitron_4b",
    "starcoder2-15b": "starcoder2_15b",
    "glm4-9b": "glm4_9b",
    "grok-1-314b": "grok_1_314b",
    "mixtral-8x22b": "mixtral_8x22b",
    "internvl2-1b": "internvl2_1b",
    "musicgen-medium": "musicgen_medium",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "rwkv6-3b": "rwkv6_3b",
}

ARCH_NAMES = list(_MODULES)


def get(name: str) -> ArchConfig:
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def reduced(name: str, seq: int = 64) -> ArchConfig:
    """A tiny config of the same family: small widths, few layers/experts,
    tiny vocab - runs a forward/train step on CPU in seconds."""
    cfg = get(name)
    unit = cfg.unit_len
    small = dict(
        num_layers=2 * unit,
        d_model=128,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        pad_heads_to=0, pad_kv_to=0, pad_vocab_to=0,
        tp_pad=2,
    )
    if cfg.num_heads:
        small["num_heads"] = 4
        small["num_kv_heads"] = min(cfg.num_kv_heads, 2)
    if cfg.num_experts:
        small["num_experts"] = 4
        small["experts_per_token"] = 2
    if cfg.sliding_window:
        small["sliding_window"] = max(seq // 2, 16)
    return replace(cfg, **small)


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "shapes_for", "get",
           "reduced", "ARCH_NAMES", "pad_for_tp"]
