"""whisper-small [audio] — enc-dec, conv frontend stubbed (frame embeds)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,  # decoder layers
    encoder_layers=12,
    encoder_seq=1500,  # mel frames after conv stride (stubbed)
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    frontend="frame_stub",
    rope_theta=1e4,  # sinusoidal absolute used in-model; rope unused
)
