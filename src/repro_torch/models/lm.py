"""The unified decoder LM — the port of ``repro.models.lm``.

A model is ``repeats`` copies of a repeating unit (``cfg.pattern``), each
unit a short list of (mixer, ffn) positions. Parameters are stored
stacked over repeats (an [R, ...] leading dim on every block leaf) in
nested dicts with the reference's paths and shapes; the layer stack is a
loop over R (the reference's ``lax.scan`` and its unrolled form give the
same values). Decode threads a per-position cache, stacked [R, ...] the
same way, through the loop.

The MoE block is the reference's capacity dispatch (``_moe_block``'s
``local_moe``): top-k routing, one stable sort per token chunk, a fixed
capacity per expert, one FFN per expert and a scatter-add that drops the
rows over capacity. The reference runs it under ``shard_map`` on a mesh;
on the port's one-device mesh its ``psum`` / ``pmean`` are the identity
and a larger mesh raises.

Where autograd records the forward (gradients on, no decode cache),
``remat`` recomputes on the backward pass what the reference's
``jax.checkpoint`` sites recompute: each repeating unit (or, under
``remat_policy="save_mixer"``, each mixer half and each FFN half apart,
so the residual stream after each mixer is kept), and inside it every
MoE token chunk and expert FFN (and, in ``layers.flash_attention``,
every kv step) whatever ``remat`` says. Results are the same either
way; only the backward's memory and recompute change.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.configs.base import (ArchConfig, FFN_MLP, FFN_MOE, FFN_RWKV,
                                      MIXER_ATTN, MIXER_MAMBA, MIXER_RWKV)
from repro_torch.models import layers as L

f32 = torch.float32


# ---------------------------------------------------------------------------
# nested-dict trees
# ---------------------------------------------------------------------------


def flatten(tree, prefix: str = "") -> "dict[str, Any]":
    """A nested dict as {"a/b/c": leaf}."""
    out: dict = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten(flat: "dict[str, Any]") -> dict:
    """The nested dict of {"a/b/c": leaf}."""
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _stack(trees: list):
    """Stack a list of same-structured trees leaf by leaf."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _put(dst: dict, src: dict, r: int) -> None:
    """dst's leaves [r] = src's leaves."""
    for k, v in src.items():
        if isinstance(v, dict):
            _put(dst[k], v, r)
        else:
            dst[k][r] = v


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _generator(seed, dev: torch.device):
    if isinstance(seed, torch.Generator) or dev.type == "meta":
        return seed
    return torch.Generator(device=dev).manual_seed(int(seed))


def init_params(cfg: ArchConfig, seed: "int | torch.Generator" = 0,
                dtype=torch.bfloat16, device=None) -> dict:
    """Parameter tree, the reference's paths and shapes. Leaves of block
    params carry a leading [R] dim. ``seed`` seeds a generator on
    ``device`` (``cuda`` unless given; ``"meta"`` gives the shapes
    alone), or is the generator itself."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    R = cfg.repeats
    D, V = cfg.d_model, cfg.vocab

    def stacked(init):
        """init() drawn R times into [R, ...] leaves (one repeat's
        tree held at a time)."""
        out = None
        for r in range(R):
            tree = init()
            if out is None:
                out = T.map(lambda a: a.new_empty((R,) + tuple(a.shape)),
                               tree)
            _put(out, tree, r)
            del tree
        return out

    blocks = {}
    for i, (mixer, ffn) in enumerate(cfg.pattern):
        def pos_init(mixer=mixer, ffn=ffn):
            p = {"norm1": L.init_rms(D, dtype, dev),
                 "norm2": L.init_rms(D, dtype, dev)}
            if mixer == MIXER_ATTN:
                p["mixer"] = L.init_attention(gen, D, cfg.n_q, cfg.n_kv,
                                              cfg.head_dim, dtype, dev)
            elif mixer == MIXER_MAMBA:
                p["mixer"] = L.init_mamba(gen, D, cfg.ssm_state,
                                          cfg.mamba_expand, dtype, dev)
            elif mixer == MIXER_RWKV:
                p["mixer"] = _init_rwkv_padded(gen, cfg, dtype, dev)
            if ffn == FFN_MLP:
                p["ffn"] = L.init_mlp(gen, D, cfg.d_ff, dtype, dev)
            elif ffn == FFN_MOE:
                p["ffn"] = L.init_moe(gen, D, cfg.d_ff, cfg.num_experts,
                                      dtype, dev)
            elif ffn == FFN_RWKV:
                p["ffn"] = L.init_rwkv_mlp(gen, D, cfg.d_ff, dtype, dev)
            return p
        blocks[f"pos{i}"] = stacked(pos_init)

    return {
        "embed": L.normal(gen, (V, D), dtype, dev, 0.02),
        "head": L.normal(gen, (D, V), dtype, dev, D ** -0.5),
        "final_norm": L.init_rms(D, dtype, dev),
        "blocks": blocks,
    }


def _init_rwkv_padded(gen, cfg: ArchConfig, dtype, device) -> dict:
    """RWKV with the inner dim padded so heads shard over TP."""
    D, DI = cfg.d_model, cfg.rwkv_inner
    s = D ** -0.5
    return {
        "w_r": L.normal(gen, (D, DI), dtype, device, s),
        "w_k": L.normal(gen, (D, DI), dtype, device, s),
        "w_v": L.normal(gen, (D, DI), dtype, device, s),
        "w_g": L.normal(gen, (D, DI), dtype, device, s),
        "w_o": L.normal(gen, (DI, D), dtype, device, DI ** -0.5),
        "w_decay": L.normal(gen, (D, DI), dtype, device, s),
        "decay_bias": torch.full((DI,), -6.0, dtype=f32, device=device),
        "bonus": torch.zeros((cfg.rwkv_heads, cfg.rwkv_head_dim), dtype=f32,
                             device=device),
        "mix": torch.full((5, D), 0.5, dtype=f32, device=device),
    }


def param_shapes(cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    """{path: (shape, dtype)} of ``init_params``'s tree, nothing drawn."""
    return {k: (tuple(v.shape), v.dtype) for k, v in
            flatten(init_params(cfg, dtype=dtype, device="meta")).items()}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Decode cache tree, stacked [R, ...] per pattern position.

    Attention: ring KV cache of ``cache_len`` slots (the sliding window
    for SWA). Mamba: [B, d_inner, N] state. RWKV: wkv matrix state +
    prev-token."""
    dev = resolve_device(device)
    R = cfg.repeats
    caches = {}
    for i, (mixer, ffn) in enumerate(cfg.pattern):
        c: dict[str, Any] = {}
        if mixer == MIXER_ATTN:
            clen = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
                else cache_len
            c["attn"] = T.map(
                lambda x: x.expand((R,) + tuple(x.shape)).clone(),
                L.init_attention_cache(batch, cfg.n_kv, clen, cfg.head_dim,
                                       dtype, dev))
        elif mixer == MIXER_MAMBA:
            di = cfg.mamba_expand * cfg.d_model
            c["mamba"] = torch.zeros((R, batch, di, cfg.ssm_state),
                                     dtype=f32, device=dev)
        elif mixer == MIXER_RWKV:
            c["rwkv"] = {
                "wkv": torch.zeros((R, batch, cfg.rwkv_heads,
                                    cfg.rwkv_head_dim, cfg.rwkv_head_dim),
                                   dtype=f32, device=dev),
                "prev": torch.zeros((R, batch, cfg.d_model), dtype=dtype,
                                    device=dev),
            }
        if ffn == FFN_RWKV:
            c["ffn_prev"] = torch.zeros((R, batch, cfg.d_model), dtype=dtype,
                                        device=dev)
        caches[f"pos{i}"] = c
    return caches


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


#: tokens per MoE chunk, at most (the reference's chunking bound)
MOE_CHUNK = 16384


def moe_capacity(tokens: int, top_k: int, n_experts: int,
                 capacity_factor: float = 1.25) -> int:
    """Rows per expert per chunk of ``tokens`` (python floats, as the
    reference computes it)."""
    return max(8, int(tokens * top_k * capacity_factor) // n_experts)


def _moe_block(cfg: ArchConfig, mesh, capacity_factor: float = 1.25,
               drops: "list | None" = None):
    """The MoE application fn ``local_moe(xt, router, w_gate, w_up,
    w_down) -> (out, aux)``.

    Capacity dispatch: tokens are sorted by expert and each expert
    processes a fixed-capacity contiguous slice (cap = cf * T * k / E per
    token chunk); assignments over capacity are dropped, Switch-style.
    ``drops``, when given, receives per chunk a 0-d tensor: the
    assignments dropped over capacity (no host sync)."""
    L.require_one_card(mesh, "the MoE block")
    top_k = cfg.experts_per_token
    if top_k > 2:
        # a token's rows land on its output row in one index_add_: with
        # at most two adds onto a zero row the sum is the same in any
        # order. More would need scatter.add_at_ordered's lane order.
        raise NotImplementedError(
            f"top_k={top_k} > 2: the MoE scatter-add would depend on the "
            f"order of its adds (use scatter.add_at_ordered)")

    def ffn(wg, wu, wd, xin):
        act = (F.silu(xin @ wg) * (xin @ wu)).to(xin.dtype)
        return act @ wd

    def chunk_moe(xc, gates, experts, w_gate, w_up, w_down, cap):
        """One token chunk: sort locally, one gather, E FFNs, one
        scatter. xc: [Tc, D]."""
        Tc, D = xc.shape
        E = w_gate.shape[0]
        dev = xc.device
        flat_expert = experts.reshape(-1)                      # [Tc*K]
        flat_token = torch.arange(Tc, device=dev)[:, None].expand(
            Tc, top_k).reshape(-1)
        order = torch.argsort(flat_expert, stable=True)
        sorted_token = flat_token[order]
        group_sizes = L.bincount(flat_expert, E)
        starts = torch.cumsum(group_sizes, 0) - group_sizes
        gates_flat = gates.reshape(-1)[order].to(xc.dtype)

        slots = torch.arange(cap, device=dev)
        pos = starts[:, None] + slots[None]                    # [E, cap]
        valid = slots[None] < group_sizes[:, None]
        pos_c = torch.clamp(pos, 0, Tc * top_k - 1).reshape(-1)
        tok_all = sorted_token[pos_c]                          # [E*cap]
        vmask = valid.reshape(-1)
        xin_all = xc[tok_all] * vmask[:, None].to(xc.dtype)
        g_all = gates_flat[pos_c] * vmask.to(xc.dtype)

        yos = [L.remat(ffn, w_gate[e], w_up[e], w_down[e],
                       xin_all[e * cap:(e + 1) * cap]) for e in range(E)]
        yo_all = torch.cat(yos, 0) * g_all[:, None]
        drop_tok = torch.where(vmask, tok_all, Tc)             # Tc => drop
        out = torch.zeros((Tc + 1, D), dtype=xc.dtype, device=dev)
        out.index_add_(0, drop_tok, yo_all.to(xc.dtype))
        return out[:Tc]

    def local_moe(xt, router, w_gate, w_up, w_down):
        T, D = xt.shape
        E = router.shape[1]
        # token chunking bounds the gather/scatter transients
        n_chunks = 1
        while T // n_chunks > MOE_CHUNK:
            n_chunks *= 2
        Tc = T // n_chunks
        cap = moe_capacity(Tc, top_k, E, capacity_factor)

        logits = (xt @ router.to(xt.dtype)).to(f32)
        probs = torch.softmax(logits, dim=-1)
        gate_all, experts_all = L.top_k_low_first(probs, top_k)
        gate_all = gate_all / gate_all.sum(dim=-1, keepdim=True)

        # the reference's chunk scan and its unrolled form: one loop over
        # the same reshape (which a ragged T fails, as the reference's)
        xs = xt.reshape(n_chunks, Tc, D)
        gs = gate_all.reshape(n_chunks, Tc, top_k)
        es = experts_all.reshape(n_chunks, Tc, top_k)
        out = torch.cat([L.remat(chunk_moe, xs[i], gs[i], es[i], w_gate,
                                 w_up, w_down, cap)
                         for i in range(n_chunks)], 0)
        if drops is not None and not L.recomputing():
            # counted once a forward, not again when the backward pass
            # recomputes it
            drops.extend((L.bincount(es[i], E) - cap).clamp(min=0).sum()
                         for i in range(n_chunks))
        me = probs.mean(dim=0)
        ce = L.bincount(experts_all, E).to(f32) / (T * top_k)
        aux = E * (me * ce).sum()
        return out, aux

    return local_moe


def build_forward(cfg: ArchConfig, mesh=None, dp_axes=("data",),
                  decode: bool = False, remat: bool = True,
                  moe_token_spec=None, select_write: bool = False,
                  act_spec=None, output: str = "logits",
                  scan_layers: bool = True, attn_head_specs=None,
                  sharded_cache_attn: bool = False,
                  remat_policy: str = "nothing",
                  moe_drops: "list | None" = None):
    """Return fwd(params, tokens_or_embeds, cache=None, pos0=0).

    Full sequence: returns (logits, aux, None); decode: one step against
    the cache, returns (logits, aux, cache'). The sharding specs
    (``act_spec``, ``moe_token_spec``, ``attn_head_specs``) are accepted
    and are the identity on one device; ``remat`` / ``remat_policy``
    choose what the backward pass recomputes (module docstring) and
    change no result; ``scan_layers`` either way is a loop over R. A
    mesh of more than one device raises. ``moe_drops``, when given,
    collects the MoE assignments dropped over capacity (see
    ``_moe_block``)."""
    L.require_one_card(mesh, "build_forward")
    moe_fn = _moe_block(cfg, mesh, drops=moe_drops)
    cache_attn = (L.sharded_cache_attention(mesh, dp_axes)
                  if sharded_cache_attn and mesh is not None else None)

    def mixer_half(x, positions, p, c, mixer):
        """x + the mixer of one position; and its new cache entries."""
        nc: dict[str, Any] = {}
        h = L.rms_norm(x, p["norm1"]["scale"])
        if mixer == MIXER_ATTN:
            out, ac = L.attention_fwd(
                p["mixer"], h, positions, n_q=cfg.n_q, n_kv=cfg.n_kv,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                window=cfg.sliding_window,
                cache=c["attn"] if c is not None else None,
                select_write=select_write,
                head_shardings=attn_head_specs,
                cache_attn=cache_attn)
            if ac is not None:
                nc["attn"] = ac
        elif mixer == MIXER_MAMBA:
            out, st = L.mamba_fwd(p["mixer"], h,
                                  state=c["mamba"] if c is not None
                                  else None)
            if c is not None:
                nc["mamba"] = st
        else:  # rwkv
            out, st = L.rwkv_fwd(p["mixer"], h,
                                 state=c["rwkv"] if c is not None
                                 else None, n_heads=cfg.rwkv_heads)
            if c is not None:
                nc["rwkv"] = st
        return x + out, nc

    def ffn_half(x, p, c, ffn):
        """x + the FFN of one position; its MoE aux (or None) and new
        cache entries."""
        nc: dict[str, Any] = {}
        aux = None
        h = L.rms_norm(x, p["norm2"]["scale"])
        if ffn == FFN_MLP:
            out = L.mlp_fwd(p["ffn"], h)
        elif ffn == FFN_MOE:
            B, S, D = h.shape
            out, aux = moe_fn(h.reshape(B * S, D), p["ffn"]["router"],
                              p["ffn"]["w_gate"], p["ffn"]["w_up"],
                              p["ffn"]["w_down"])
            out = out.reshape(B, S, D)
        else:  # rwkv channel mix
            out, prev = L.rwkv_mlp_fwd(
                p["ffn"], h, prev=c["ffn_prev"] if c is not None else None)
            if c is not None:
                nc["ffn_prev"] = prev
        return x + out, aux, nc

    def unit_fn(x, positions, unit_params, unit_cache, halves=False):
        """Apply one repeating unit. x: [B, S, D]. ``halves``: each
        mixer half and FFN half recomputed apart on the backward pass."""
        aux_total = torch.zeros((), dtype=f32, device=x.device)
        new_cache = {} if unit_cache is not None else None
        run = L.remat if halves else (lambda fn, *args: fn(*args))
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            p = unit_params[f"pos{i}"]
            c = unit_cache[f"pos{i}"] if unit_cache is not None else None
            x, nc = run(mixer_half, x, positions, p, c, mixer)
            x, aux, nf = run(ffn_half, x, p, c, ffn)
            if aux is not None:
                aux_total = aux_total + aux
            if new_cache is not None:
                new_cache[f"pos{i}"] = {**nc, **nf}
        return x, aux_total, new_cache

    def fwd(params, inputs, cache=None, pos0=0):
        if cfg.frontend == "vit_stub" and inputs.ndim == 3:
            x = inputs.to(params["embed"].dtype)      # precomputed embeds
        else:
            x = params["embed"][inputs]               # [B, S, D]
        S = x.shape[1]
        positions = pos0 + torch.arange(S, dtype=torch.int32, device=x.device)

        aux = torch.zeros((), dtype=f32, device=x.device)
        R = cfg.repeats
        new_caches = []
        for r in range(R):
            up = T.map(lambda a: a[r], params["blocks"])
            uc = (T.map(lambda a: a[r], cache)
                  if cache is not None else None)
            if remat and cache is None and remat_policy == "save_mixer":
                x, a, nc = unit_fn(x, positions, up, None, True)
            elif remat and cache is None:
                x, a, nc = L.remat(unit_fn, x, positions, up, None)
            else:
                x, a, nc = unit_fn(x, positions, up, uc)
            aux = aux + a
            if cache is not None:
                new_caches.append(nc)
        new_cache = _stack(new_caches) if cache is not None else None

        x = L.rms_norm(x, params["final_norm"]["scale"])
        if output == "hidden":
            return x, aux, new_cache
        return x @ params["head"], aux, new_cache

    return fwd
