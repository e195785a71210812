"""mixtral-8x22b: MoE 8e top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ArchConfig, pad_for_tp, MIXER_ATTN, FFN_MOE

CONFIG = pad_for_tp(ArchConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=16384, vocab_size=32768,
    num_experts=8, experts_per_token=2,
    sliding_window=4096,
    pattern=((MIXER_ATTN, FFN_MOE),),
    source="arXiv:2401.04088; hf",
))
