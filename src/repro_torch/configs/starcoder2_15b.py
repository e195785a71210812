"""starcoder2-15b: GQA + RoPE dense decoder [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ArchConfig, pad_for_tp, MIXER_ATTN, FFN_MLP

CONFIG = pad_for_tp(ArchConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    head_dim=128, d_ff=24576, vocab_size=49152,
    rope_theta=100_000.0,
    pattern=((MIXER_ATTN, FFN_MLP),),
    source="arXiv:2402.19173; hf",
))
