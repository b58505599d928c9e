"""Architecture configuration schema (a copy of ``repro/configs/base.py``).

Every assigned architecture is expressed as an ``ArchConfig``; the port's
LM (``repro_torch.lm``) assembles the model from the per-layer
``LayerSpec`` sequence this config induces.  Heterogeneous stacks (gemma2
local/global alternation, jamba 1:7 attn:mamba, deepseek dense-then-MoE,
llama-vision cross-attention interleave) are described by a repeating
*pattern*; the port runs the pattern periods as a Python loop over
parameters stacked along a leading step axis, with any non-periodic prefix
unrolled.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer: (sequence mixer, channel mixer)."""

    mixer: str = "attn"      # attn | attn_local | mla | mamba | rwkv | cross
    mlp: str = "dense"       # dense | moe
    use_rope: bool = True


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention variants
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen2
    attn_softcap: float = 0.0        # gemma2
    final_softcap: float = 0.0       # gemma2
    window: int = 0                  # sliding-window size for local layers
    local_global_pattern: bool = False  # gemma2: alternate local/global
    rope_theta: float = 10000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # expert hidden dim (deepseek: 2048)
    first_dense: int = 0             # leading dense layers (deepseek: 3)
    moe_every: int = 1               # MoE every k-th layer (jamba: 2)
    router_scores: str = "softmax"   # softmax | sigmoid (deepseek v3)
    capacity_factor: float = 1.25

    # MLA (deepseek-v3)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    mtp: bool = False                # deepseek multi-token prediction head

    # SSM / RWKV
    ssm_d_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0              # jamba: attention every k-th layer
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_audio_frames: int = 1500

    # VLM cross-attention (llama-3.2-vision)
    cross_attn_every: int = 0        # every k-th layer is cross-attention
    n_image_tokens: int = 0

    tie_embeddings: bool = False
    act: str = "silu"                # silu | gelu | geglu
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""                 # provenance tag from the assignment

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    def layer_specs(self) -> list[LayerSpec]:
        """The full per-layer spec sequence (length n_layers)."""
        specs = []
        for i in range(self.n_layers):
            mixer = "attn"
            if self.mla:
                mixer = "mla"
            if self.local_global_pattern:
                mixer = "attn_local" if i % 2 == 0 else "attn"
            if self.attn_every:  # jamba: layer k-1 of each period is attn
                mixer = "attn" if (i % self.attn_every) == self.attn_every - 1 else "mamba"
            if self.family == "ssm":
                mixer = "rwkv"
            if self.cross_attn_every and (i % self.cross_attn_every
                                          == self.cross_attn_every - 1):
                mixer = "cross"
            mlp = "dense"
            if self.n_experts:
                if i >= self.first_dense and (i % self.moe_every
                                              == self.moe_every - 1 or self.moe_every == 1):
                    mlp = "moe"
            use_rope = mixer in ("attn", "attn_local", "mla")
            specs.append(LayerSpec(mixer=mixer, mlp=mlp, use_rope=use_rope))
        return specs

    def scan_pattern(self) -> tuple[int, int, list[LayerSpec]]:
        """(n_prefix_unrolled, n_scan_steps, pattern) — pattern repeats after
        the prefix; len(pattern) * n_scan_steps + n_prefix == n_layers."""
        specs = self.layer_specs()
        n = len(specs)
        for prefix in range(0, min(n, 8)):
            body = specs[prefix:]
            if not body:
                break
            for period in range(1, min(len(body), 16) + 1):
                if len(body) % period:
                    continue
                pat = body[:period]
                if all(body[i] == pat[i % period] for i in range(len(body))):
                    return prefix, len(body) // period, pat
        return n, 0, []  # fully unrolled fallback

    def reduced(self, n_layers: int = 4, d_model: int = 64, d_ff: int = 128,
                vocab: int = 256, n_experts: Optional[int] = None,
                **overrides) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        heads = max(2, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, 2))
        changes = dict(
            n_layers=n_layers, d_model=d_model, d_ff=d_ff, vocab=vocab,
            n_heads=heads, n_kv_heads=kv, head_dim=d_model // heads,
            name=self.name + "-smoke", dtype="float32",
        )
        if self.n_experts:
            changes["n_experts"] = n_experts if n_experts is not None else 4
            changes["top_k"] = min(self.top_k, 2)
            changes["moe_d_ff"] = d_ff
            changes["first_dense"] = min(self.first_dense, 1)
            # no-drop capacity so tests comparing different sequence lengths
            # (prefill vs full forward) see identical routing
            changes["capacity_factor"] = 8.0
        if self.mla:
            changes.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8,
                           qk_rope_dim=8, v_head_dim=8)
        if self.family == "ssm":
            changes["rwkv_head_dim"] = 16 if d_model % 16 == 0 else 8
        if self.window:
            changes["window"] = 32
        if self.enc_dec:
            changes["n_enc_layers"] = 2
            changes["n_audio_frames"] = 16
        if self.cross_attn_every:
            changes["n_image_tokens"] = 8
        if self.attn_every:
            changes["n_layers"] = max(n_layers, self.attn_every)
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only state-space / hybrid archs
# run it (DESIGN.md §Arch-applicability records the skips).
LONG_CONTEXT_ARCHS = {"rwkv6-3b", "jamba-1.5-large-398b"}


def applicable_shapes(arch: "ArchConfig") -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch.name in LONG_CONTEXT_ARCHS:
        out.append("long_500k")
    return out
