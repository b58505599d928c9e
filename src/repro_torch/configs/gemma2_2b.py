"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000
— local+global alternating attention, logit softcaps.  [arXiv:2408.00118; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab=256000, head_dim=256, act="gelu",
    local_global_pattern=True, window=4096,
    attn_softcap=50.0, final_softcap=30.0, tie_embeddings=True,
    source="arXiv:2408.00118; hf",
)
