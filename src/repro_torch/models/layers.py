"""Model building blocks: GQA attention (full / sliding-window), dense and
MoE FFNs, Mamba and RWKV6 mixers — the port of ``repro.models.layers``.

Plain functions over explicit parameter dicts, as in the reference:
``init_*`` returns a dict of tensors (drawn from an explicit
``torch.Generator``, in an explicit dtype, on ``device``: ``cuda``
unless the caller passes another), ``*_fwd`` consumes it.
Every computation is plain torch ops and ``torch.matmul`` in the
reference's order: no library attention, no ``torch.compile``.

Where the reference asks for an f32 product of bf16 operands
(``preferred_element_type=jnp.float32``: JAX returns the f32 sum
unrounded, a torch bf16 matmul rounds it to bf16) both operands are
cast to f32 first. Attention is the reference's blockwise online softmax
(q-chunks outer, kv-chunks inner, masks at -1e30); a length that does
not divide its chunk fails as the reference's reshape does.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch import tree as T

f32 = torch.float32


def normal(gen, shape, dtype, device, scale: float) -> torch.Tensor:
    """N(0, 1) draws in ``dtype`` times ``scale`` (the reference's
    ``jax.random.normal(k, shape, dtype) * s``); a meta device draws
    nothing (shapes only)."""
    dev = torch.device(device)
    g = None if dev.type == "meta" else gen
    return torch.randn(shape, generator=g, dtype=dtype, device=dev) * scale


def _f32_mm(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """``einsum(eq, a, b, preferred_element_type=f32)``."""
    return torch.einsum(eq, a.to(f32), b.to(f32))


def repeat_heads(x: torch.Tensor, rep: int) -> torch.Tensor:
    """``jnp.repeat(x, rep, axis=1)`` of [B, H, ...]: each head ``rep``
    times in a row."""
    B, H = x.shape[:2]
    return x[:, :, None].expand(B, H, rep, *x.shape[2:]).reshape(
        B, H * rep, *x.shape[2:])


_RECOMPUTING = [0]


@contextlib.contextmanager
def _recompute():
    _RECOMPUTING[0] += 1
    try:
        yield
    finally:
        _RECOMPUTING[0] -= 1


def recomputing() -> bool:
    """Whether the code running is a backward pass's recompute of a
    ``remat`` region (where a counter must not count again)."""
    return _RECOMPUTING[0] > 0


def remat(fn, *args):
    """``fn(*args)``, recomputed on the backward pass instead of saved
    (the reference's ``jax.checkpoint`` with nothing saveable) where
    autograd records it: gradients on and some tensor in ``args``
    requiring one. Elsewhere (inference, decode) a plain call. The
    result is the same either way."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad
            for a in T.leaves(list(args))):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              _recompute()))
    return fn(*args)


def bincount(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.bincount(idx, length=n)`` of indices in [0, n), int64, as an
    exact scatter-add (``torch.bincount`` reads the largest index back
    to the host on CUDA)."""
    idx = idx.reshape(-1)
    return torch.zeros(n, dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int64))


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    var = x.to(f32).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def init_rms(d: int, dtype, device=None) -> dict:
    device = resolve_device(device)
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding. x: [..., S, H, hd]; positions: [..., S]. cos and
    sin are cast to x.dtype before the multiply, as the reference's."""
    hd = x.shape[-1]
    half = hd // 2
    # log(theta) / half in f32 as the reference takes it, as a python
    # float (exact in f32) so that no host-to-device copy waits
    step = (torch.log(torch.tensor(theta, dtype=f32)) / half).item()
    freqs = torch.exp(-torch.arange(0, half, dtype=f32, device=x.device)
                      * step)
    ang = positions[..., :, None].to(f32) * freqs             # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :].to(x.dtype)
    sin = torch.sin(ang)[..., :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# attention (GQA, RoPE, optional sliding window), blockwise
# ---------------------------------------------------------------------------


def init_attention(gen, d_model, n_q, n_kv, head_dim, dtype,
                   device=None) -> dict:
    device = resolve_device(device)
    s = d_model ** -0.5
    return {
        "wq": normal(gen, (d_model, n_q * head_dim), dtype, device, s),
        "wk": normal(gen, (d_model, n_kv * head_dim), dtype, device, s),
        "wv": normal(gen, (d_model, n_kv * head_dim), dtype, device, s),
        "wo": normal(gen, (n_q * head_dim, d_model), dtype, device, s),
    }


def _flash_block(q, k, v, q_pos, k_pos, window: int):
    """One (q-chunk x kv-chunk) tile with the causal (+SWA) mask.
    q: [B, H, Tq, hd]; k, v: [B, H, Tk, hd]. Returns (max, exp sums,
    out chunk) for the online softmax, all f32."""
    scale = q.shape[-1] ** -0.5
    s = _f32_mm(q, k, "bhqd,bhkd->bhqk") * scale
    mask = k_pos[None, None, None, :] <= q_pos[None, None, :, None]
    if window > 0:
        mask &= k_pos[None, None, None, :] > (
            q_pos[None, None, :, None] - window)
    s = torch.where(mask, s, -1e30)
    m = s.amax(dim=-1)                                         # [B,H,Tq]
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)                                          # [B,H,Tq]
    o = _f32_mm(p.to(v.dtype), v, "bhqk,bhkd->bhqd")
    return m, l, o


def flash_attention(q, k, v, q_positions, k_positions, window: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024):
    """Blockwise causal attention; never holds more than one [q-chunk,
    kv-chunk] score tile. q: [B, Hq, Sq, hd]; k, v: [B, Hkv, Sk, hd];
    positions are absolute token indices."""
    B, Hq, Sq, hd = q.shape
    rep = Hq // k.shape[1]
    k = repeat_heads(k, rep)
    v = repeat_heads(v, rep)
    Sk = k.shape[2]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq = Sq // q_chunk
    nk = Sk // kv_chunk

    q_r = q.reshape(B, Hq, nq, q_chunk, hd).permute(2, 0, 1, 3, 4)
    qp_r = q_positions.reshape(nq, q_chunk)
    k_r = k.reshape(B, Hq, nk, kv_chunk, hd).permute(2, 0, 1, 3, 4)
    v_r = v.reshape(B, Hq, nk, kv_chunk, hd).permute(2, 0, 1, 3, 4)
    kp_r = k_positions.reshape(nk, kv_chunk)

    def kv_step(m_run, l_run, o_run, qc, kc, vc, qpc, kpc):
        m, l, o = _flash_block(qc, kc, vc, qpc, kpc, window)
        m_new = torch.maximum(m_run, m)
        alpha = torch.exp(m_run - m_new)
        beta = torch.exp(m - m_new)
        l_new = l_run * alpha + l * beta
        o_new = o_run * alpha[..., None] + o * beta[..., None]
        return m_new, l_new, o_new

    outs = []
    for qi in range(nq):
        m_run = torch.full((B, Hq, q_chunk), -1e30, dtype=f32,
                           device=q.device)
        l_run = torch.zeros((B, Hq, q_chunk), dtype=f32, device=q.device)
        o_run = torch.zeros((B, Hq, q_chunk, hd), dtype=f32, device=q.device)
        for ki in range(nk):
            # each step's score tile is recomputed on the backward pass,
            # not saved: O(S) residual memory, as the reference's
            m_run, l_run, o_run = remat(kv_step, m_run, l_run, o_run,
                                        q_r[qi], k_r[ki], v_r[ki], qp_r[qi],
                                        kp_r[ki])
        outs.append(o_run / torch.clamp_min(l_run[..., None], 1e-30))
    out = torch.stack(outs).permute(1, 2, 0, 3, 4).reshape(B, Hq, Sq, hd)
    return out.to(q.dtype)


def require_one_card(mesh, what: str) -> None:
    """Refuse a mesh of more than one device: the port runs the
    reference's sharded code paths at mesh size 1 only (ROADMAP: "more
    than one card stays unverified")."""
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {mesh.size} devices: the port runs at "
            f"mesh size 1 only; more than one card stays unverified "
            f"(ROADMAP.md)")


def sharded_cache_attention(mesh, dp_axes):
    """Decode attention over a sequence-sharded KV cache, at mesh size 1:
    the reference's local body with -inf masking (its psum / pmax over
    a size-1 "model" axis are the identity)."""
    require_one_card(mesh, "sharded_cache_attention")

    def local_attn(q, kk, vv, kpos, valid, pos_now, window_arr):
        # q [B,H,1,hd]; kk/vv [B,H,C,hd]; kpos/valid [C]
        scale = q.shape[-1] ** -0.5
        s = _f32_mm(q, kk, "bhqd,bhkd->bhqk") * scale
        mask = (kpos[None, None, None, :] <= pos_now) & \
            valid[None, None, None, :]
        w = window_arr[0]
        mask &= (w <= 0) | (kpos[None, None, None, :] > pos_now - w)
        s = torch.where(mask, s, -math.inf)
        m = s.amax(dim=-1)                                     # [B,H,1]
        e = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        l = e.sum(dim=-1)                                      # [B,H,1]
        o = _f32_mm(e.to(vv.dtype), vv, "bhqk,bhkd->bhqd")
        return o / torch.clamp_min(l[..., None], 1e-30)

    return local_attn


def _write_cache(cache: dict, kc, vc, positions, select_write: bool):
    """The new token(s) into the ring cache at slot ``positions[0] % C``."""
    C = cache["k"].shape[2]
    S = kc.shape[2]
    slot = positions[0] % C
    if select_write:
        sel = torch.arange(C, device=kc.device) == slot
        ck = torch.where(sel[None, None, :, None], kc, cache["k"])
        cv = torch.where(sel[None, None, :, None], vc, cache["v"])
        cpos = torch.where(sel, positions[0].to(cache["pos"].dtype),
                           cache["pos"])
        return ck, cv, cpos, cache["valid"] | sel
    # lax.dynamic_update_slice clamps its start so that the update fits;
    # ``valid`` marks only the one slot ``positions[0] % C``
    start = torch.clamp(slot, 0, C - S)
    idx = (start + torch.arange(S, device=kc.device)).to(torch.int64)
    ck = cache["k"].index_copy(2, idx, kc)
    cv = cache["v"].index_copy(2, idx, vc)
    cpos = cache["pos"].index_copy(0, idx, positions.to(cache["pos"].dtype))
    cvalid = cache["valid"].index_fill(0, slot.reshape(1).to(torch.int64),
                                       True)
    return ck, cv, cpos, cvalid


def attention_fwd(params, x, positions, *, n_q, n_kv, head_dim,
                  rope_theta, window=0, cache=None, select_write=False,
                  head_shardings=None, cache_attn=None):
    """GQA attention. x: [B, S, D]; positions: [S] int32.

    cache: None for a full-sequence forward, else dict(k=[B, n_kv, C, hd],
    v=..., pos=[C], valid=[C]) for decode — returns the updated cache. The
    cache is a ring over C slots (C == window for SWA, == context for
    full). ``select_write`` writes the new token by an iota compare and
    select instead of the slice update. ``head_shardings`` is accepted
    and is the identity on one device."""
    B, S, D = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_q, head_dim)
    k = (x @ params["wk"]).reshape(B, S, n_kv, head_dim)
    v = (x @ params["wv"]).reshape(B, S, n_kv, head_dim)
    q = rope(q, positions, rope_theta).transpose(1, 2)
    k = rope(k, positions, rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)

    if cache is None:
        out = flash_attention(q, k, v, positions, positions, window)
        new_cache = None
    else:
        ck, cv, cpos, cvalid = _write_cache(
            cache, k.to(cache["k"].dtype), v.to(cache["v"].dtype),
            positions, select_write)
        kk = repeat_heads(ck, n_q // n_kv)
        vv = repeat_heads(cv, n_q // n_kv)
        if cache_attn is not None:
            out = cache_attn(q, kk, vv, cpos, cvalid, positions[0],
                             torch.full((1,), window, dtype=torch.int32,
                                        device=x.device))
        else:
            scale = head_dim ** -0.5
            s = _f32_mm(q, kk, "bhqd,bhkd->bhqk") * scale
            mask = (cpos[None, None, None, :]
                    <= positions[None, None, :, None])
            mask &= cvalid[None, None, None, :]
            if window > 0:
                mask &= cpos[None, None, None, :] > (
                    positions[None, None, :, None] - window)
            s = torch.where(mask, s, -1e30)
            p = torch.softmax(s, dim=-1)
            out = _f32_mm(p.to(vv.dtype), vv, "bhqk,bhkd->bhqd")
        new_cache = {"k": ck, "v": cv, "pos": cpos, "valid": cvalid}

    out = out.to(x.dtype).transpose(1, 2).reshape(B, S, -1)
    return out @ params["wo"], new_cache


def init_attention_cache(batch, n_kv, cache_len, head_dim, dtype,
                         device=None) -> dict:
    device = resolve_device(device)
    return {
        "k": torch.zeros((batch, n_kv, cache_len, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, n_kv, cache_len, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.zeros((cache_len,), dtype=torch.int32, device=device),
        "valid": torch.zeros((cache_len,), dtype=torch.bool, device=device),
    }


# ---------------------------------------------------------------------------
# FFNs: dense SwiGLU and the ragged-dot MoE
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model, d_ff, dtype, device=None) -> dict:
    device = resolve_device(device)
    s = d_model ** -0.5
    return {
        "w_gate": normal(gen, (d_model, d_ff), dtype, device, s),
        "w_up": normal(gen, (d_model, d_ff), dtype, device, s),
        "w_down": normal(gen, (d_ff, d_model), dtype, device, d_ff ** -0.5),
    }


def mlp_fwd(params, x):
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


def init_moe(gen, d_model, d_ff, n_experts, dtype, device=None) -> dict:
    device = resolve_device(device)
    s = d_model ** -0.5
    return {
        "router": normal(gen, (d_model, n_experts), f32, device, s),
        "w_gate": normal(gen, (n_experts, d_model, d_ff), dtype, device, s),
        "w_up": normal(gen, (n_experts, d_model, d_ff), dtype, device, s),
        "w_down": normal(gen, (n_experts, d_ff, d_model), dtype, device,
                          d_ff ** -0.5),
    }


def top_k_low_first(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, the lower index
    first among equal values (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_fwd(params, x, *, top_k: int):
    """Dropless token-choice MoE by sort + grouped GEMM. x: [B, S, D].

    ``lax.ragged_dot`` multiplies each contiguous group of sorted rows by
    its expert's weights; here that is a loop over the experts' groups.
    Returns (out, load-balance aux)."""
    B, S, D = x.shape
    E = params["router"].shape[1]
    xt = x.reshape(B * S, D)
    T = B * S

    logits = xt.to(f32) @ params["router"]                     # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, experts = top_k_low_first(probs, top_k)         # [T, K]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    flat_expert = experts.reshape(-1)                          # [T*K]
    flat_token = torch.arange(T, device=x.device)[:, None].expand(
        T, top_k).reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_token = flat_token[order]
    counts = bincount(flat_expert, E)
    group_sizes = counts.tolist()

    xin = xt[sorted_token]                                     # [T*K, D]
    yo = torch.empty((T * top_k, D), dtype=x.dtype, device=x.device)
    start = 0
    for e, n in enumerate(group_sizes):
        rows = xin[start:start + n]
        act = F.silu(rows @ params["w_gate"][e]) * (rows @ params["w_up"][e])
        yo[start:start + n] = act @ params["w_down"][e]
        start += n

    gates_sorted = gate_vals.reshape(-1)[order]
    yo = yo * gates_sorted[:, None].to(yo.dtype)
    out = torch.zeros((T, D), dtype=yo.dtype, device=x.device)
    # a token's top_k rows land on its one output row: two adds onto a
    # zero are order-free (configs use top_k <= 2; see lm.local_moe)
    out.index_add_(0, sorted_token, yo)

    me = probs.mean(dim=0)
    ce = counts.to(f32) / (T * top_k)
    aux = E * (me * ce).sum()
    return out.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Mamba mixer (simplified selective SSM, Jamba-style)
# ---------------------------------------------------------------------------


def init_mamba(gen, d_model, d_state, expand, dtype, device=None) -> dict:
    device = resolve_device(device)
    d_inner = expand * d_model
    s = d_model ** -0.5
    return {
        "w_in": normal(gen, (d_model, 2 * d_inner), dtype, device, s),
        "w_out": normal(gen, (d_inner, d_model), dtype, device,
                         d_inner ** -0.5),
        "w_bcdt": normal(gen, (d_inner, 2 * d_state + 1), dtype, device,
                          d_inner ** -0.5),
        "a_log": torch.zeros((d_inner, d_state), dtype=f32, device=device)
        + torch.log(torch.arange(1, d_state + 1, dtype=f32, device=device)),
        "dt_bias": torch.zeros((), dtype=f32, device=device),
    }


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba_fwd(params, x, state=None):
    """Selective SSM. x: [B, S, D]; state: [B, d_inner, N] for decode.
    The scan over S is a loop."""
    B, S, D = x.shape
    xi = x @ params["w_in"]
    d_inner = xi.shape[-1] // 2
    u, gate = xi[..., :d_inner], xi[..., d_inner:]            # [B,S,d_inner]
    bcdt = u @ params["w_bcdt"]                                # [B,S,2N+1]
    N = params["a_log"].shape[1]
    Bc, Cc, dt = bcdt[..., :N], bcdt[..., N:2 * N], bcdt[..., -1:]
    dt = _softplus(dt.to(f32) + params["dt_bias"])
    A = -torch.exp(params["a_log"])                            # [d_inner, N]
    dA = torch.exp(dt[..., None] * A[None, None])              # [B,S,d_inner,N]
    dBu = (dt * u.to(f32))[..., None] * Bc[..., None, :].to(f32)
    Cf = Cc.to(f32)

    h = (torch.zeros((B, d_inner, N), dtype=f32, device=x.device)
         if state is None else state.to(f32))
    ys = []
    for t in range(S):
        h = h * dA[:, t] + dBu[:, t]                           # [B,d_inner,N]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)                     # [B,S,d_inner]
    out = (y * F.silu(gate)) @ params["w_out"]
    return out, h.to(f32)


# ---------------------------------------------------------------------------
# RWKV6 (Finch) mixer: data-dependent decay, per-head matrix state
# ---------------------------------------------------------------------------


def init_rwkv(gen, d_model, n_heads, dtype, device=None) -> dict:
    device = resolve_device(device)
    hd = d_model // n_heads
    s = d_model ** -0.5
    return {
        "w_r": normal(gen, (d_model, d_model), dtype, device, s),
        "w_k": normal(gen, (d_model, d_model), dtype, device, s),
        "w_v": normal(gen, (d_model, d_model), dtype, device, s),
        "w_g": normal(gen, (d_model, d_model), dtype, device, s),
        "w_o": normal(gen, (d_model, d_model), dtype, device, s),
        "w_decay": normal(gen, (d_model, d_model), dtype, device, s),
        "decay_bias": torch.full((d_model,), -6.0, dtype=f32, device=device),
        "bonus": torch.zeros((n_heads, hd), dtype=f32, device=device),
        "mix": torch.full((5, d_model), 0.5, dtype=f32, device=device),
    }


def rwkv_fwd(params, x, state=None, *, n_heads):
    """RWKV6 time-mix. x: [B, S, D]; state: dict(wkv=[B, H, hd, hd],
    prev=[B, D]) for decode, None for a full sequence. The scan over S is
    a loop."""
    B, S, D = x.shape
    DI = params["w_r"].shape[1]
    hd = DI // n_heads
    prev = (torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
            if state is None else state["prev"][:, None, :].to(x.dtype))
    x_shift = torch.cat([prev, x[:, :-1]], dim=1)

    def mixed(i):
        m = params["mix"][i].to(x.dtype)
        return x * m + x_shift * (1 - m)

    r = (mixed(0) @ params["w_r"]).reshape(B, S, n_heads, hd)
    k = (mixed(1) @ params["w_k"]).reshape(B, S, n_heads, hd)
    v = (mixed(2) @ params["w_v"]).reshape(B, S, n_heads, hd)
    g = F.silu(mixed(3) @ params["w_g"])
    decay = (mixed(4) @ params["w_decay"]).to(f32)
    w = torch.exp(-torch.exp(decay + params["decay_bias"]))    # (0, 1)
    w = w.reshape(B, S, n_heads, hd)
    bonus = params["bonus"][None, :, :, None]                  # [1,H,hd,1]

    h = (torch.zeros((B, n_heads, hd, hd), dtype=f32, device=x.device)
         if state is None else state["wkv"].to(f32))
    ys = []
    for t in range(S):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t].to(f32), v[:, t].to(f32))
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].to(f32),
                               h + bonus * kv))
        h = h * w[:, t].to(f32)[..., None] + kv
    y = torch.stack(ys, dim=1).reshape(B, S, DI).to(x.dtype)
    out = (y * g) @ params["w_o"]
    return out, {"wkv": h, "prev": x[:, -1]}


def init_rwkv_mlp(gen, d_model, d_ff, dtype, device=None) -> dict:
    device = resolve_device(device)
    s = d_model ** -0.5
    return {
        "w_k": normal(gen, (d_model, d_ff), dtype, device, s),
        "w_v": normal(gen, (d_ff, d_model), dtype, device, d_ff ** -0.5),
        "w_r": normal(gen, (d_model, d_model), dtype, device, s),
        "mix": torch.full((2, d_model), 0.5, dtype=f32, device=device),
    }


def rwkv_mlp_fwd(params, x, prev=None):
    """RWKV channel-mix (squared-relu FFN with token shift + receptance)."""
    B, S, D = x.shape
    pv = (torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
          if prev is None else prev[:, None, :].to(x.dtype))
    x_shift = torch.cat([pv, x[:, :-1]], dim=1)
    mk = params["mix"][0].to(x.dtype)
    mr = params["mix"][1].to(x.dtype)
    xk = x * mk + x_shift * (1 - mk)
    xr = x * mr + x_shift * (1 - mr)
    k = torch.square(torch.relu(xk @ params["w_k"]))
    r = torch.sigmoid(xr @ params["w_r"])
    return r * (k @ params["w_v"]), x[:, -1]
