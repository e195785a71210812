"""minitron-4b: pruned nemotron dense decoder [arXiv:2407.14679; hf]."""
from repro_torch.configs.base import ArchConfig, pad_for_tp, MIXER_ATTN, FFN_MLP

CONFIG = pad_for_tp(ArchConfig(
    name="minitron-4b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    head_dim=128, d_ff=9216, vocab_size=256_000,
    pattern=((MIXER_ATTN, FFN_MLP),),
    source="arXiv:2407.14679; hf",
))
