"""rwkv6-3b (Finch): attention-free, data-dependent decay
[arXiv:2404.05892; hf]."""
from repro_torch.configs.base import ArchConfig, pad_for_tp, MIXER_RWKV, FFN_RWKV

CONFIG = pad_for_tp(ArchConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=8960, vocab_size=65536,
    pattern=((MIXER_RWKV, FFN_RWKV),),
    rwkv_head_dim=64,
    source="arXiv:2404.05892; hf",
))
