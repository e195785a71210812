"""Sharding rules: parameter, activation, optimizer and cache layouts —
the port of ``repro.distributed.sharding``.

Production mesh: (data=16, model=16) per pod; multi-pod adds a leading
"pod" axis folded into data parallelism. Strategy per tensor family:

* 2-D parameter sharding (FSDP x TP): every weight is sharded over the
  data axis on one dim (ZeRO-3 style) and over "model" on its TP dim
  (Megatron column / row split); MoE expert weights ``[E, D, F]`` /
  ``[E, F, D]`` keep the expert dim whole; the Mamba and RWKV vectors
  shard their channel dim over "model".
* Residual activations: sequence-sharded over "model" for attention
  architectures; batch over data; SSM and hybrid archs keep S unsharded.
* Decode KV caches: head_dim over "model" for decode_32k; sequence over
  "data" + head_dim over "model" for the B=1 long_500k cells.

The rules are pure functions of a mesh's axis names and sizes
(``repro_torch.launch.mesh.Mesh``) and a tree's paths. Where the
reference returns a ``jax.sharding.PartitionSpec`` these return the
plain tuple of its entries (an axis name, a tuple of names, or ``None``
for an unsharded dim); ``named`` is the identity, since the port places
a whole tree on its one device. The parallelism planner reads
``param_pspec``.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import MIXER_ATTN, ArchConfig, ShapeConfig


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _size(mesh, axis: str) -> int:
    return dict(zip(mesh.axis_names, mesh.shape))[axis]


def tp_size(mesh) -> int:
    return _size(mesh, "model")


def _dp(mesh):
    """The data axes as one spec entry: the name, or the tuple of names."""
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def _dp_total(mesh) -> int:
    total = 1
    for a in dp_axes(mesh):
        total *= _size(mesh, a)
    return total


def _map_with_path(rule, tree, path=()):
    """``jax.tree_util.tree_map_with_path`` over nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_with_path(rule, v, path + (k,))
                for k, v in tree.items()}
    return rule(path, tree)


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


# name -> (spec for 2D [in, out]-style weights); leading R dim added later
_MATMUL_IN_OUT = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_r", "w_k",
                  "w_v", "w_g", "w_decay"}
_MATMUL_OUT_IN = {"wo", "w_down", "w_out", "w_o"}


def param_pspec(path, leaf, dp, stacked: bool) -> tuple:
    """Axis names of one parameter leaf, one per dim (None: unsharded)."""
    name = _path_str(path).split("/")[-1]
    pre = (None,) if stacked else ()
    nd = leaf.ndim - (1 if stacked else 0)

    if name in ("embed",):
        return ("model", None)
    if name in ("head",):
        return (dp, "model")
    if name in ("scale", "final_norm"):
        return pre + (None,) * nd
    if name == "router":
        return pre + (dp, None)
    if name in _MATMUL_IN_OUT:
        if nd == 3:  # MoE expert weights [E, D, F]
            return pre + (None, dp, "model")
        return pre + (dp, "model")
    if name in _MATMUL_OUT_IN:
        if nd == 3:  # MoE [E, F, D]
            return pre + (None, "model", dp)
        return pre + ("model", dp)
    if name == "w_bcdt":
        return pre + ("model", None)
    if name == "a_log":
        return pre + ("model", None)
    if name == "decay_bias":
        return pre + ("model",)
    if name == "bonus":
        return pre + ("model", None)
    # mix vectors, dt_bias, anything small: replicate
    return pre + (None,) * nd


def param_pspecs(params_shape: Any, mesh) -> Any:
    """Tree of specs matching a params tree (of tensors, or of anything
    with ``ndim``)."""
    dp = _dp(mesh)

    def rule(path, leaf):
        stacked = _path_str(path).startswith("blocks/")
        return param_pspec(path, leaf, dp, stacked)

    return _map_with_path(rule, params_shape)


def batch_pspec(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """Specs for the input batch dict."""
    dp = _dp(mesh)
    bshard = dp if shape.global_batch % _dp_total(mesh) == 0 else None
    if cfg.frontend == "vit_stub":
        toks = (bshard, None, None)
    else:
        toks = (bshard, None)
    return {"inputs": toks, "labels": (bshard, None)}


def activation_pspec(cfg: ArchConfig, mesh) -> tuple:
    """Residual-stream constraint: SP over model for attention archs."""
    pure_attn = all(m == MIXER_ATTN for m, _ in cfg.pattern)
    dp = _dp(mesh)
    if pure_attn:
        return (dp, "model", None)
    return (dp, None, None)


def cache_pspecs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                 cache_shape: Any) -> Any:
    """Specs for the decode-cache tree (stacked [R, ...])."""
    dp = _dp(mesh)
    long_ctx = shape.global_batch < _dp_total(mesh)  # B=1 long_500k cells

    def rule(path, leaf):
        name = _path_str(path).split("/")[-1]
        nd = leaf.ndim
        if name in ("k", "v"):  # [R, B, kv, C, hd]
            if long_ctx:
                return (None, None, None, "data", "model")
            return (None, dp, None, None, "model")
        if name == "pos" or name == "valid":
            if nd == 2:                      # [R, C]
                return (None, "data") if long_ctx else (None, None)
            return (None,) * nd
        if name == "mamba" or name == "wkv":  # [R,B,di,N] / [R,B,H,hd,hd]
            b = None if long_ctx else dp
            if nd == 4:
                return (None, b, "model", None)
            return (None, b, "model", None, None)
        if name == "prev" or name == "ffn_prev":  # [R, B, D]
            return (None, None if long_ctx else dp, None)
        return (None,) * nd

    return _map_with_path(rule, cache_shape)


def named(mesh, spec_tree: Any) -> Any:
    """The reference's ``NamedSharding`` per spec: the identity here —
    the port's code takes a mesh of one device, where every spec places
    the whole array on it."""
    return spec_tree


def attn_head_specs(cfg: ArchConfig, mesh, decode: bool = False):
    """(q spec, kv spec) for [B, H, S, hd] attention internals.

    Train / prefill: heads over "model" (kv heads replicated when the GQA
    kv count does not divide the TP width). Decode: q / k / v pinned to
    the KV cache's layout, head_dim over "model"."""
    if not any(m == "attn" for m, _ in cfg.pattern):
        return None
    dp = _dp(mesh)
    if decode:
        spec = (dp, None, None, "model")
        return (spec, spec)
    tp = tp_size(mesh)
    q = (dp, "model", None, None)
    kv = (dp, "model" if cfg.n_kv % tp == 0 else None, None, None)
    return (q, kv)


# ---------------------------------------------------------------------------
# the reference's layout variants
# ---------------------------------------------------------------------------


def _keep(spec: tuple, axis: str) -> tuple:
    return tuple(a if a == axis else None for a in spec)


def param_pspecs_tp_only(params_shape: Any, mesh) -> Any:
    """Serving layout: params sharded over "model" only (no FSDP axis)."""
    def rule(path, leaf):
        stacked = _path_str(path).startswith("blocks/")
        return _keep(param_pspec(path, leaf, None, stacked), "model")

    return _map_with_path(rule, params_shape)


def batch_pspec_dp_wide(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """Small-model layout: the "model" axis joins data parallelism."""
    axes = tuple(mesh.axis_names)
    if cfg.frontend == "vit_stub":
        return {"inputs": (axes, None, None), "labels": (axes, None)}
    return {"inputs": (axes, None), "labels": (axes, None)}


def param_pspecs_dp_wide(params_shape: Any, mesh) -> Any:
    """Params for the dp-wide layout: ZeRO over "data", replicated over
    "model"."""
    def rule(path, leaf):
        stacked = _path_str(path).startswith("blocks/")
        return _keep(param_pspec(path, leaf, "data", stacked), "data")

    return _map_with_path(rule, params_shape)


_ATTN_MLP = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}


def param_pspecs_decode_row(params_shape: Any, mesh) -> Any:
    """Decode layout: attention / dense-MLP weights row-parallel (the
    contracting dim over "model"); MoE experts keep the F-sharded
    layout; SSM mixers keep channel-TP."""
    def rule(path, leaf):
        pathstr = _path_str(path)
        name = pathstr.split("/")[-1]
        stacked = pathstr.startswith("blocks/")
        pre = (None,) if stacked else ()
        nd = leaf.ndim - (1 if stacked else 0)
        if name == "embed":
            return ("model", None)
        if name == "head":
            return ("model", None)
        if name in _ATTN_MLP and nd == 2:
            return pre + ("model", None)
        if name in _ATTN_MLP and nd == 3:  # MoE expert weights
            if name == "w_down":
                return pre + (None, "model", None)
            return pre + (None, None, "model")
        return _keep(param_pspec(path, leaf, None, stacked), "model")

    return _map_with_path(rule, params_shape)


def cache_pspecs_decode_row(cfg: ArchConfig, shape: ShapeConfig, mesh,
                            cache_shape: Any) -> Any:
    """KV cache sharded on the sequence (C) dim over "model"."""
    dp = _dp(mesh)

    def rule(path, leaf):
        name = _path_str(path).split("/")[-1]
        nd = leaf.ndim
        if name in ("k", "v"):   # [R, B, kv, C, hd]
            return (None, dp, None, "model", None)
        if name in ("pos", "valid") and nd == 2:  # [R, C]
            return (None, "model")
        if name == "mamba" or name == "wkv":
            if nd == 4:
                return (None, dp, "model", None)
            return (None, dp, "model", None, None)
        if name in ("prev", "ffn_prev"):
            return (None, dp, None)
        return (None,) * nd

    return _map_with_path(rule, cache_shape)


def param_pspecs_zero2(params_shape: Any, mesh) -> Any:
    """ZeRO-2 layout: parameters TP-sharded over "model" but replicated
    over "data"; optimizer moments stay 2-D sharded."""
    def rule(path, leaf):
        stacked = _path_str(path).startswith("blocks/")
        return _keep(param_pspec(path, leaf, None, stacked), "model")

    return _map_with_path(rule, params_shape)
