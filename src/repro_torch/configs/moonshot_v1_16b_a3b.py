"""moonshot-v1-16b-a3b [moe] — kimi/moonlight 64e top-6 + shared experts."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    d_ff_expert=1408,
    vocab_size=163840,
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    rope_theta=5e4,
)
