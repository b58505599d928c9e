"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576,
MoE 16e top-2 — Mamba+attention 1:7 interleave, MoE every 2nd layer.
[arXiv:2403.19887; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128,
    attn_every=8,                      # 1 attention : 7 mamba
    n_experts=16, top_k=2, moe_d_ff=24576, moe_every=2,
    ssm_d_state=16, ssm_conv=4, ssm_expand=2,
    source="arXiv:2403.19887; hf",
)
