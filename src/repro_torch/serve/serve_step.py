"""Serving: prefill + single-token decode steps, and the serving rate
priced on the simulated UET fabric — the port of
``repro.serve.serve_step``.

decode: one new token per sequence against a ring KV cache (full-context
or sliding-window) / SSM state.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


def make_decode_step(cfg: ArchConfig, mesh=None, dp_axes=("data",),
                     select_write: bool = False, moe_token_spec=None,
                     scan_layers: bool = True, attn_head_specs=None,
                     sharded_cache_attn: bool = False):
    """decode_step(params, cache, tokens [B,1], pos) ->
    (logits [B, vocab], cache')."""
    fwd = lm.build_forward(cfg, mesh=mesh, dp_axes=dp_axes, decode=True,
                           remat=False, select_write=select_write,
                           moe_token_spec=moe_token_spec,
                           scan_layers=scan_layers,
                           attn_head_specs=attn_head_specs,
                           sharded_cache_attn=sharded_cache_attn)

    def decode_step(params, cache, tokens, pos):
        logits, _, new_cache = fwd(params, tokens, cache=cache, pos0=pos)
        return logits[:, -1], new_cache

    return decode_step


def make_prefill(cfg: ArchConfig, mesh=None, dp_axes=("data",),
                 act_spec=None, moe_token_spec=None,
                 scan_layers: bool = True, attn_head_specs=None):
    """prefill(params, tokens [B, S]) -> logits of the last position."""
    fwd = lm.build_forward(cfg, mesh=mesh, dp_axes=dp_axes, remat=False,
                           act_spec=act_spec, moe_token_spec=moe_token_spec,
                           scan_layers=scan_layers,
                           attn_head_specs=attn_head_specs)

    def prefill(params, tokens):
        logits, _, _ = fwd(params, tokens)
        return logits[:, -1]

    return prefill


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax token (the lowest index among equal maxima), int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def serving_rate(cfg: ArchConfig, *, dp: int = 4, tp: int = 4,
                 layout: str = "tp_only", shape: str = "decode_32k",
                 g=None, profile=None, device=None, **step_kw) -> dict:
    """Decode-time serving economics on a simulated UET fabric.

    Derives the parallelism plan for ``cfg`` on a (dp, tp) serving mesh,
    compiles its per-step collective schedule, runs it through the
    packet-level simulator on ``device`` (``cuda`` unless given) and
    prices tokens/sec served. Returns {tokens_per_sec_served, step_s,
    net_s, eff, ...}, as the reference's."""
    from repro_torch.distributed.plan import derive_plan
    from repro_torch.network import traffic

    plan = derive_plan(cfg, shape, dp=dp, tp=tp, layout=layout)
    t = traffic.step_time(plan, g, profile, device=device, **step_kw)
    return {
        "arch": cfg.name, "shape": shape, "layout": layout,
        "dp": dp, "tp": tp,
        "tokens_per_sec_served": t.tokens_per_sec,
        "step_s": t.step_s, "net_s": t.net_s,
        "compute_s": t.compute_s, "memory_s": t.memory_s,
        "eff": t.eff, "sim_ticks": t.sim_ticks,
    }
