"""The name-based parameter sharding rule of ``repro.distributed.sharding``
(``param_pspec``), as the parallelism planner reads it.

The rule pattern-matches a parameter's path: every weight is sharded over
the data axis on one dim (ZeRO-3 style) and over "model" on its TP dim
(Megatron column / row split); MoE expert weights ``[E, D, F]`` /
``[E, F, D]`` keep the expert dim whole; the Mamba and RWKV vectors shard
their channel dim over "model". Where the reference returns a
``jax.sharding.PartitionSpec`` this returns the plain tuple of its axis
names (``None`` for an unsharded dim): the planner reads only which axes
a leaf names. The mesh and the other spec functions belong to the model
substrate and are not here.
"""
from __future__ import annotations


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
