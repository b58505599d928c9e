"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536 —
Finch: data-dependent decay linear attention.  [arXiv:2404.05892; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab=65536, rwkv_head_dim=64,
    source="arXiv:2404.05892; hf",
)
