"""Architecture + shape configuration system.

Every assigned architecture is an `ArchConfig`; every input shape is a
`ShapeConfig`. The (arch x shape) grid drives smoke tests, the multi-pod
dry-run, and the roofline table.

Padding policy (recorded per-arch in `pad_note`): attention head counts
are padded up to the smallest multiple that shards over the 16-way
"model" axis while preserving the GQA group structure; RWKV's inner dim
is padded to a 16-divisible head count. Padding overhead shows up in the
MODEL_FLOPS / HLO_FLOPS ratio of the roofline table — it is reported, not
hidden.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


# block descriptors: (mixer, ffn) per layer position within a repeating unit
MIXER_ATTN = "attn"
MIXER_MAMBA = "mamba"
MIXER_RWKV = "rwkv"
FFN_MLP = "mlp"
FFN_MOE = "moe"
FFN_RWKV = "rwkv_mlp"


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    num_experts: int = 0
    experts_per_token: int = 0
    rope_theta: float = 10_000.0
    sliding_window: int = 0      # 0 = full attention
    pattern: tuple = ((MIXER_ATTN, FFN_MLP),)
    ssm_state: int = 16
    mamba_expand: int = 2
    rwkv_head_dim: int = 64
    frontend: Optional[str] = None  # "vit_stub" | "encodec_stub"
    source: str = ""
    # padding for 16-way TP (computed in __post_init__ if left 0)
    pad_heads_to: int = 0
    pad_kv_to: int = 0
    pad_vocab_to: int = 0
    pad_note: str = ""
    tp_pad: int = 16             # TP width sharded dims must divide

    @property
    def n_q(self) -> int:
        return self.pad_heads_to or self.num_heads

    @property
    def n_kv(self) -> int:
        return self.pad_kv_to or self.num_kv_heads

    @property
    def vocab(self) -> int:
        return self.pad_vocab_to or self.vocab_size

    @property
    def unit_len(self) -> int:
        return len(self.pattern)

    @property
    def repeats(self) -> int:
        assert self.num_layers % self.unit_len == 0
        return self.num_layers // self.unit_len

    @property
    def rwkv_heads(self) -> int:
        # padded so heads shard tp_pad-way (see module docstring)
        h = self.d_model // self.rwkv_head_dim
        return _round_up(h, self.tp_pad)

    @property
    def rwkv_inner(self) -> int:
        return self.rwkv_heads * self.rwkv_head_dim

    @property
    def is_subquadratic(self) -> bool:
        """May run long_500k: SSM / hybrid / sliding-window attention."""
        return (self.sliding_window > 0
                or any(m != MIXER_ATTN for m, _ in self.pattern))

    def param_count(self) -> int:
        """Analytic parameter count (unpadded, for 6ND roofline numbers)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        total = V * D  # embedding
        total += D * V  # lm head
        for (mixer, ffn) in self.pattern:
            reps = self.repeats
            if mixer == MIXER_ATTN:
                hd = self.head_dim
                total += reps * D * hd * (self.num_heads * 2
                                          + self.num_kv_heads * 2)
            elif mixer == MIXER_MAMBA:
                di = self.mamba_expand * D
                total += reps * (D * 2 * di + di * D
                                 + di * (2 * self.ssm_state + 1))
            elif mixer == MIXER_RWKV:
                total += reps * 6 * D * D
            if ffn == FFN_MLP:
                total += reps * 3 * D * F
            elif ffn == FFN_MOE:
                total += reps * (D * self.num_experts
                                 + self.num_experts * 3 * D * F)
            elif ffn == FFN_RWKV:
                total += reps * (2 * D * F // 2 + D * D)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.num_experts == 0:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        moe_layers = sum(1 for _, f in self.pattern if f == FFN_MOE) \
            * self.repeats
        inactive = moe_layers * (self.num_experts - self.experts_per_token) \
            * 3 * D * F
        return self.param_count() - inactive

    def param_leaves(self) -> "list[tuple[tuple, tuple]]":
        """Analytic parameter leaves as (path, shape) pairs, in the layer
        vocabulary the sharding rules pattern-match (wq/wk/wv/wo, w_gate/
        w_up/w_down, embed/head/router, ...). Block leaves carry the
        stacked leading repeats dim, path-prefixed ``blocks/`` exactly
        like the real params pytree, so ``sharding.param_pspec`` applies
        unchanged — the parallelism planner (`repro.distributed.plan`)
        classifies each leaf with the REAL rules rather than re-deriving
        a parallel set. Head/vocab counts use the TP-padded values (the
        sharded, communicated tensors); tiny vectors (norms, biases,
        mix gates) are omitted — they are noise at collective scale.
        """
        D, F, R = self.d_model, self.d_ff, self.repeats
        hd = self.head_dim
        leaves: list[tuple[tuple, tuple]] = [
            (("embed",), (self.vocab, D)),
            (("head",), (D, self.vocab)),
        ]
        for u, (mixer, ffn) in enumerate(self.pattern):
            blk = ("blocks", f"u{u}")
            if mixer == MIXER_ATTN:
                leaves += [
                    (blk + ("wq",), (R, D, self.n_q * hd)),
                    (blk + ("wk",), (R, D, self.n_kv * hd)),
                    (blk + ("wv",), (R, D, self.n_kv * hd)),
                    (blk + ("wo",), (R, self.n_q * hd, D)),
                ]
            elif mixer == MIXER_MAMBA:
                di = self.mamba_expand * D
                leaves += [
                    (blk + ("w_in",), (R, D, 2 * di)),
                    (blk + ("w_out",), (R, di, D)),
                    (blk + ("w_bcdt",), (R, di, 2 * self.ssm_state + 1)),
                ]
            elif mixer == MIXER_RWKV:
                leaves += [(blk + (n,), (R, D, D))
                           for n in ("w_r", "w_k", "w_v", "w_g",
                                     "w_decay", "w_o")]
            if ffn == FFN_MLP:
                leaves += [
                    (blk + ("w_gate",), (R, D, F)),
                    (blk + ("w_up",), (R, D, F)),
                    (blk + ("w_down",), (R, F, D)),
                ]
            elif ffn == FFN_MOE:
                E = self.num_experts
                leaves += [
                    (blk + ("router",), (R, D, E)),
                    (blk + ("w_gate",), (R, E, D, F)),
                    (blk + ("w_up",), (R, E, D, F)),
                    (blk + ("w_down",), (R, E, F, D)),
                ]
            elif ffn == FFN_RWKV:
                leaves += [
                    (blk + ("w_k",), (R, D, F // 2)),
                    (blk + ("w_v",), (R, F // 2, D)),
                    (blk + ("w_o",), (R, D, D)),
                ]
        return leaves


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_for_tp(cfg: ArchConfig, tp: int = 16) -> ArchConfig:
    """Pad head counts / vocab so every sharded dim divides the TP width."""
    from dataclasses import replace
    n_q, n_kv = cfg.num_heads, cfg.num_kv_heads
    note = []
    if n_q and n_q % tp:
        group = max(1, n_q // max(n_kv, 1))
        new_q = _round_up(n_q, tp)
        if n_kv and new_q % n_kv:
            new_kv = math.gcd(new_q, _round_up(n_kv, 1))
            # keep GQA structure: grow kv so that q % kv == 0
            new_kv = n_kv
            while new_q % new_kv:
                new_kv += 1
            note.append(f"kv {n_kv}->{new_kv}")
        else:
            new_kv = n_kv
        note.append(f"q {n_q}->{new_q}")
        cfg = replace(cfg, pad_heads_to=new_q, pad_kv_to=new_kv,
                      pad_note="; ".join(note))
    if cfg.vocab_size % 256:
        cfg = replace(cfg, pad_vocab_to=_round_up(cfg.vocab_size, 256))
    return cfg


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ArchConfig) -> list[str]:
    """The shape cells this architecture runs (long_500k only for
    sub-quadratic archs, per the assignment rules)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic:
        out.append("long_500k")
    return out
