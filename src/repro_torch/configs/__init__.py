"""Model/system configurations of the port: the LM architecture registry
(``--arch <id>`` resolution, a copy of ``repro/configs/__init__.py``) and
the DP model presets (``dpa1_md.py``)."""
from __future__ import annotations

from .base import (ArchConfig, LayerSpec, ShapeConfig, SHAPES,  # noqa: F401
                   applicable_shapes, LONG_CONTEXT_ARCHS)

from . import (llama_3_2_vision_90b, minitron_4b, gemma2_2b, qwen2_1_5b,
               qwen3_8b, deepseek_v3_671b, llama4_scout_17b_a16e, rwkv6_3b,
               jamba_1_5_large_398b, whisper_medium)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (llama_3_2_vision_90b, minitron_4b, gemma2_2b, qwen2_1_5b,
              qwen3_8b, deepseek_v3_671b, llama4_scout_17b_a16e, rwkv6_3b,
              jamba_1_5_large_398b, whisper_medium)
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def param_count(cfg: ArchConfig) -> tuple[int, int]:
    """(total, active) parameter counts from the config algebra."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.resolved_head_dim
    per_layer_total = 0
    per_layer_active = 0
    for spec in cfg.layer_specs():
        if spec.mixer in ("attn", "attn_local", "cross"):
            a = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
        elif spec.mixer == "mla":
            a = (d * cfg.q_lora_rank
                 + cfg.q_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                 + d * cfg.kv_lora_rank + d * cfg.qk_rope_dim
                 + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
                 + cfg.n_heads * cfg.v_head_dim * d)
        elif spec.mixer == "mamba":
            di = cfg.ssm_expand * d
            a = d * 2 * di + di * (2 * cfg.ssm_d_state + max(d // 16, 1)) \
                + max(d // 16, 1) * di + di * d + di * cfg.ssm_d_state
        elif spec.mixer == "rwkv":
            a = 5 * d * d + 2 * d * max(d // 16, 32)
        else:
            a = 0
        if spec.mlp == "moe":
            ff = cfg.moe_d_ff or f
            m_total = cfg.n_experts * 3 * d * ff + d * cfg.n_experts
            m_active = cfg.top_k * 3 * d * ff
            if cfg.n_shared_experts:
                m_total += cfg.n_shared_experts * 3 * d * ff
                m_active += cfg.n_shared_experts * 3 * d * ff
        else:
            ff = f
            m_total = m_active = 3 * d * ff if cfg.family != "ssm" else (
                2 * d * ff + d * d)
        per_layer_total += a + m_total
        per_layer_active += a + m_active
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    enc = 0
    if cfg.enc_dec:
        enc = cfg.n_enc_layers * (4 * d * d + 3 * d * f)
    total = per_layer_total + emb + enc
    active = per_layer_active + emb + enc
    return total, active
