"""musicgen-medium: decoder-only over EnCodec tokens; the EnCodec frontend
is a stub providing the token/frame stream [arXiv:2306.05284; hf]."""
from repro_torch.configs.base import ArchConfig, pad_for_tp, MIXER_ATTN, FFN_MLP

CONFIG = pad_for_tp(ArchConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    head_dim=64, d_ff=6144, vocab_size=2048,
    pattern=((MIXER_ATTN, FFN_MLP),),
    frontend="encodec_stub",
    source="arXiv:2306.05284; hf",
))
