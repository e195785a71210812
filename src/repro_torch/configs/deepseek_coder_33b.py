"""deepseek-coder-33b: llama-arch dense decoder [arXiv:2401.14196; hf]."""
from repro_torch.configs.base import ArchConfig, pad_for_tp, MIXER_ATTN, FFN_MLP

CONFIG = pad_for_tp(ArchConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=19200, vocab_size=32256,
    rope_theta=100_000.0,
    pattern=((MIXER_ATTN, FFN_MLP),),
    source="arXiv:2401.14196; hf",
))
