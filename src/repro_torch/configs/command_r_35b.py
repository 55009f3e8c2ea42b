"""command-r-35b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    attn_bias=False,
    rope_theta=8e6,
    tie_embeddings=True,
    # 64 q-heads: keep the [B,H,qc,kc] backward tile ≈ 1 GiB/device
    attn_q_chunk=256,
)
