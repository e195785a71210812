"""glm4-9b: RoPE + GQA dense decoder [hf:THUDM/glm-4-9b]."""
from repro_torch.configs.base import ArchConfig, pad_for_tp, MIXER_ATTN, FFN_MLP

CONFIG = pad_for_tp(ArchConfig(
    name="glm4-9b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    head_dim=128, d_ff=13696, vocab_size=151_552,
    pattern=((MIXER_ATTN, FFN_MLP),),
    source="hf:THUDM/glm-4-9b",
))
