"""whisper-medium [audio]: 24L d_model=1024 16H d_ff=4096 vocab=51865 —
enc-dec, conv frontend (STUB: input_specs provides precomputed frame
embeddings).  24 encoder + 24 decoder layers (whisper-medium layout); the
decoder cross-attends every layer.  [arXiv:2212.04356; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, head_dim=64, act="gelu",
    enc_dec=True, n_enc_layers=24, n_audio_frames=1500,
    cross_attn_every=2,   # decoder: self/cross alternating blocks
    source="arXiv:2212.04356; unverified",
)
