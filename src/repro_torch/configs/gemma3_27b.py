"""gemma3-27b [dense] — 5:1 local:global sliding window, 128k context."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    local_window=1024,
    local_global_ratio=5,  # 5 local : 1 global
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
)
