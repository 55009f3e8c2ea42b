"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, pattern R,R,A."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"),  # 1 attn : 2 recurrent
    rglru_width=2560,
    local_window=2048,  # attention blocks are local-only (griffin)
    rope_theta=1e4,
    tie_embeddings=True,
)
