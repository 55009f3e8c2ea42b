"""llava-next-mistral-7b [vlm] — mistral backbone, anyres patch stub."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    frontend="patch_stub",
    num_patch_tokens=2880,  # anyres tiling: base 576 + 4 tiles x 576
    rope_theta=1e6,
)
