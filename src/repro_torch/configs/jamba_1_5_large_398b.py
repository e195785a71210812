"""jamba-1.5-large-398b: hybrid Mamba+attention 1:7 interleave, MoE 16e
top-2 [arXiv:2403.19887; hf]. Unit of 8 layers: attention at position 3,
MoE FFN at every other position."""
from repro_torch.configs.base import (ArchConfig, pad_for_tp, MIXER_ATTN,
                                      MIXER_MAMBA, FFN_MLP, FFN_MOE)

_UNIT = tuple(
    (MIXER_ATTN if i == 3 else MIXER_MAMBA,
     FFN_MOE if i % 2 == 1 else FFN_MLP)
    for i in range(8)
)

CONFIG = pad_for_tp(ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=24576, vocab_size=65536,
    num_experts=16, experts_per_token=2,
    pattern=_UNIT, ssm_state=16, mamba_expand=2,
    source="arXiv:2403.19887; hf",
))
