"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048 vocab=129280,
MoE 256e top-8 — MLA, 1 shared + 256 routed, MTP.  [arXiv:2412.19437; hf]

MLA dims from the paper: q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64,
v_head 128; first 3 layers dense with d_ff 18432; sigmoid router scores.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab=129280, head_dim=128,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
    first_dense=3, router_scores="sigmoid", mtp=True,
    source="arXiv:2412.19437; hf",
)
