"""Parallelism plans: ArchConfig + mesh shape -> per-step collective demand
(the port of ``repro.distributed.plan``, pure python as there).

A `ParallelismPlan` is the static, analytic half of the model-driven
traffic engine (`repro_torch.network.traffic` is the dynamic half that
compiles a plan onto the packet fabric). It answers: for THIS architecture on THIS
(dp, tp, pp) mesh under THIS sharding layout, which collectives run every
step, over which group sizes, moving how many bytes per rank?

The classification is NOT a re-derivation: every parameter leaf from
`ArchConfig.param_leaves()` is classified by the real sharding rule
(`sharding.param_pspec`) — "data" in the spec means the leaf is FSDP-
sharded (per-step param all-gathers + grad reduce-scatter over DP),
no "data" means the gradient is all-reduced; "model" means the leaf is
TP-sharded (its DP payload shrinks by 1/tp). The two supported layouts
mirror the reference's pspec functions:

* ``fsdp_tp``  — 2-D ZeRO-3 x Megatron
* ``tp_only``  — the serving layout (no DP param/grad collectives for
  inference, full-size grad all-reduce if trained)

Byte volumes are per-rank INPUT denominated, matching
`collectives.CollectiveSpec`. All derivation is pure python/numpy:
same (config, shape, mesh, layout) -> bitwise-identical plan.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES
from repro_torch.distributed import sharding


# ---------------------------------------------------------------------------
# demand records
# ---------------------------------------------------------------------------

# scope -> what the group is made of
SCOPE_TP = "tp"        # tensor-parallel group (contiguous, intra-leaf ideally)
SCOPE_DP = "dp"        # data-parallel group (crosses the fabric)
SCOPE_PP = "pp"        # pipeline neighbours
SCOPE_SERVE = "serve"  # serving frontend incast


@dataclass(frozen=True)
class CollectiveDemand:
    """One per-step collective requirement.

    bytes_per_rank is the per-rank INPUT payload (CollectiveSpec
    denomination); count is how many times per step this collective runs
    (e.g. TP all-reduces run `count` times across the layers of a stage);
    concurrent is how many disjoint groups run it in parallel (DP
    collectives run once per TP rank, on disjoint host sets)."""
    phase: str            # "tp_stream" | "dp_grad" | "dp_param" | "pp_p2p" | "serve_incast"
    kind: str             # collectives kind: all_reduce/reduce_scatter/all_gather/p2p/incast
    scope: str
    n: int                # group size
    bytes_per_rank: float
    count: int = 1
    concurrent: int = 1


@dataclass(frozen=True)
class ParallelismPlan:
    arch: str
    shape: str
    kind: str             # train | prefill | decode
    dp: int
    tp: int
    pp: int
    layout: str           # fsdp_tp | tp_only
    dtype_bytes: int
    num_layers: int
    d_model: int
    global_batch: int
    tokens_per_step: int
    param_bytes: int          # full model, all leaves
    active_param_bytes: int
    demands: tuple            # tuple[CollectiveDemand, ...]

    @property
    def devices(self) -> int:
        return self.dp * self.tp * self.pp

    def demands_for(self, scope: str) -> tuple:
        return tuple(d for d in self.demands if d.scope == scope)

    # -- analytic pricing (alpha-beta, bandwidth-only lower bounds) ---------

    def analytic_net_seconds(self, bw_bytes_per_s: float) -> dict:
        """Per-scope bandwidth-bound lower-bound seconds for one step.

        Groups in the same scope run concurrently on disjoint hosts, so a
        scope's time is the per-group time, not the sum over groups."""
        out: dict[str, float] = {}
        for d in self.demands:
            t = collective_seconds(d.kind, d.n, d.bytes_per_rank,
                                   bw_bytes_per_s) * d.count
            out[d.scope] = out.get(d.scope, 0.0) + t
        return out

    def compute_seconds(self, peak_flops: float) -> float:
        mult = 6 if self.kind == "train" else 2
        flops = mult * (self.active_param_bytes / self.dtype_bytes) \
            * self.tokens_per_step / self.devices
        return flops / peak_flops

    def memory_seconds(self, hbm_bw: float) -> float:
        """Heuristic HBM term: decode is weight-read bound (each TP shard
        streams its resident weights once per token step); train reads
        params + writes grads/updates, sharded over all devices."""
        if self.kind == "decode":
            return (self.active_param_bytes / self.tp) / hbm_bw
        return 3 * (self.param_bytes / self.devices) / hbm_bw


def collective_seconds(kind: str, n: int, bytes_per_rank: float,
                       bw_bytes_per_s: float) -> float:
    """Bandwidth-term alpha-beta time, per-rank-INPUT denominated
    (same convention as `collectives.CollectiveSpec` / `analytic_ticks`)."""
    if n <= 1:
        return 0.0
    m = bytes_per_rank / bw_bytes_per_s
    if kind == "all_reduce":
        return 2 * (n - 1) / n * m
    if kind == "reduce_scatter":
        return (n - 1) / n * m
    if kind == "all_gather":      # input block per rank -> (n-1) blocks rx'd
        return (n - 1) * m
    if kind == "all_to_all":
        return (n - 1) / n * m
    if kind == "p2p":
        return m
    if kind == "incast":          # n senders share one receiver downlink
        return n * m
    raise ValueError(f"unknown collective kind {kind!r}")


# ---------------------------------------------------------------------------
# leaf classification via the real sharding rules
# ---------------------------------------------------------------------------

class _LeafShim:
    """Duck-typed leaf for `sharding.param_pspec` (only .ndim is read)."""
    __slots__ = ("ndim",)

    def __init__(self, ndim: int):
        self.ndim = ndim


def classify_leaves(cfg: ArchConfig, layout: str) -> list:
    """[(path, shape, tp_sharded, dp_sharded)] via `sharding.param_pspec`."""
    out = []
    for path, shape in cfg.param_leaves():
        stacked = path[0] == "blocks"
        spec = sharding.param_pspec(path, _LeafShim(len(shape)),
                                    "data", stacked)
        axes = set(a for a in spec if a is not None)
        tp_sh = "model" in axes
        dp_sh = "data" in axes and layout == "fsdp_tp"
        out.append((path, shape, tp_sh, dp_sh))
    return out


def _numel(shape: Iterable[int]) -> int:
    return math.prod(shape)


# ---------------------------------------------------------------------------
# plan derivation
# ---------------------------------------------------------------------------

LAYOUTS = ("fsdp_tp", "tp_only")


def derive_plan(cfg: ArchConfig, shape: "ShapeConfig | str", *,
                dp: int, tp: int, pp: int = 1,
                layout: str = "fsdp_tp",
                dtype_bytes: int = 2) -> ParallelismPlan:
    """Derive the per-step collective demand for cfg on a (dp, tp, pp) mesh.

    Per-step phases emitted (train):
      tp_stream   — 2 fwd + 2 bwd activation all-reduces per layer over TP
      dp_param    — ZeRO-3 param all-gathers over DP (fwd + remat bwd),
                    fsdp_tp layout only
      dp_grad     — grad reduce-scatter (FSDP leaves) + grad all-reduce
                    (replicated leaves) over DP
      pp_p2p      — activation sends between stages, 2x per microbatch

    Inference (prefill/decode): tp_stream at 2 all-reduces per layer; the
    fsdp_tp layout pays ONE param all-gather per step (the decode penalty
    the tp_only serving layout exists to remove); decode adds a
    serve_incast phase (request fan-in at the serving frontend).
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if min(dp, tp, pp) < 1:
        raise ValueError("dp/tp/pp must be >= 1")
    if cfg.num_layers % pp:
        raise ValueError(f"pp={pp} does not divide num_layers={cfg.num_layers}")

    kind = shape.kind
    train = kind == "train"
    tokens_per_step = shape.global_batch * (shape.seq_len if kind != "decode"
                                            else 1)
    tokens_local = tokens_per_step / dp          # per DP replica
    layers_per_stage = cfg.num_layers // pp
    D = cfg.d_model

    leaves = classify_leaves(cfg, layout)
    param_bytes = sum(_numel(s) for _, s, _, _ in leaves) * dtype_bytes
    # active bytes scale the same way param counts do
    active_frac = cfg.active_param_count() / max(1, cfg.param_count())
    active_param_bytes = int(param_bytes * active_frac)

    # per-TP-rank resident bytes, split FSDP vs replicated-over-dp
    fsdp_shard = 0.0
    repl_shard = 0.0
    for _, s, tp_sh, dp_sh in leaves:
        b = _numel(s) * dtype_bytes / (tp if tp_sh else 1) / pp
        if dp_sh:
            fsdp_shard += b
        else:
            repl_shard += b

    demands: list[CollectiveDemand] = []

    # -- TP activation stream (the per-layer phase chain) -------------------
    if tp > 1:
        ar_per_layer = 4 if train else 2
        demands.append(CollectiveDemand(
            phase="tp_stream", kind="all_reduce", scope=SCOPE_TP, n=tp,
            bytes_per_rank=tokens_local * D * dtype_bytes,
            count=ar_per_layer * layers_per_stage, concurrent=dp * pp))

    # -- DP param / grad collectives ---------------------------------------
    if dp > 1 and fsdp_shard > 0:
        gathers = 2 if train else 1
        demands.append(CollectiveDemand(
            phase="dp_param", kind="all_gather", scope=SCOPE_DP, n=dp,
            bytes_per_rank=fsdp_shard / dp, count=gathers, concurrent=tp * pp))
    if train and dp > 1:
        if fsdp_shard > 0:
            demands.append(CollectiveDemand(
                phase="dp_grad", kind="reduce_scatter", scope=SCOPE_DP, n=dp,
                bytes_per_rank=fsdp_shard, count=1, concurrent=tp * pp))
        if repl_shard > 0:
            demands.append(CollectiveDemand(
                phase="dp_grad", kind="all_reduce", scope=SCOPE_DP, n=dp,
                bytes_per_rank=repl_shard, count=1, concurrent=tp * pp))

    # -- PP activation point-to-point --------------------------------------
    if pp > 1:
        micro = max(pp, 4)
        per_send = tokens_local / micro * D * dtype_bytes
        sends = (2 if train else 1) * (pp - 1) * micro
        demands.append(CollectiveDemand(
            phase="pp_p2p", kind="p2p", scope=SCOPE_PP, n=2,
            bytes_per_rank=per_send, count=sends, concurrent=dp))

    # -- decode-time serving incast ----------------------------------------
    if kind == "decode":
        fan = 4
        demands.append(CollectiveDemand(
            phase="serve_incast", kind="incast", scope=SCOPE_SERVE, n=fan,
            bytes_per_rank=shape.global_batch * 256 / fan, count=1))

    return ParallelismPlan(
        arch=cfg.name, shape=shape.name, kind=kind, dp=dp, tp=tp, pp=pp,
        layout=layout, dtype_bytes=dtype_bytes, num_layers=cfg.num_layers,
        d_model=D, global_batch=shape.global_batch,
        tokens_per_step=tokens_per_step, param_bytes=param_bytes,
        active_param_bytes=active_param_bytes, demands=tuple(demands))


def replan_onto_survivors(plan: ParallelismPlan,
                          failed_hosts: int = 1) -> ParallelismPlan:
    """Recovery replan: re-derive the collective schedule on the mesh
    that SURVIVES ``failed_hosts`` node losses.

    A DP replica spans ``tp * pp`` devices and a failed host takes its
    whole replica out of rotation (worst case: every failed host hits a
    distinct replica), so the surviving mesh is ``dp - failed_hosts``
    replicas wide. The checkpoint restores elastically onto it
    (an elastic restore reshards on load), the global
    batch is unchanged — each survivor carries more tokens and a larger
    per-rank DP payload, which is exactly the degraded step time the
    recovery-pricing path charges until the fleet is healed."""
    if failed_hosts < 0:
        raise ValueError(f"failed_hosts must be >= 0, got {failed_hosts}")
    if failed_hosts == 0:
        return plan
    new_dp = plan.dp - failed_hosts
    if new_dp < 1:
        raise ValueError(
            f"cannot replan: {failed_hosts} failed hosts leave no "
            f"surviving DP replica (dp={plan.dp})")
    from repro_torch import configs
    cfg = configs.get(plan.arch)
    return derive_plan(cfg, plan.shape, dp=new_dp, tp=plan.tp, pp=plan.pp,
                       layout=plan.layout, dtype_bytes=plan.dtype_bytes)


def describe(plan: ParallelismPlan) -> str:
    lines = [f"{plan.arch} x {plan.shape}: dp={plan.dp} tp={plan.tp} "
             f"pp={plan.pp} layout={plan.layout} "
             f"({plan.param_bytes / 1e9:.1f} GB params)"]
    for d in plan.demands:
        lines.append(f"  {d.phase:12s} {d.kind:14s} n={d.n:<3d} "
                     f"{d.bytes_per_rank / 1e6:10.3f} MB/rank x{d.count}")
    return "\n".join(lines)
