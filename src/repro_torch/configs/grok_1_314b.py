"""grok-1-314b: MoE 8 experts top-2 [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ArchConfig, pad_for_tp, MIXER_ATTN, FFN_MOE

CONFIG = pad_for_tp(ArchConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=32768, vocab_size=131_072,
    num_experts=8, experts_per_token=2,
    pattern=((MIXER_ATTN, FFN_MOE),),
    source="hf:xai-org/grok-1; unverified",
))
