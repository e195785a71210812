"""internvl2-1b: InternViT + InternLM2 VLM; backbone only, ViT frontend is
a stub providing precomputed patch embeddings [arXiv:2404.16821; hf]."""
from repro_torch.configs.base import ArchConfig, pad_for_tp, MIXER_ATTN, FFN_MLP

CONFIG = pad_for_tp(ArchConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    head_dim=64, d_ff=4864, vocab_size=151_655,
    pattern=((MIXER_ATTN, FFN_MLP),),
    frontend="vit_stub",
    source="arXiv:2404.16821; hf",
))
