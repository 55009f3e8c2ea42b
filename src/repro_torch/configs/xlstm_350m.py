"""xlstm-350m [ssm] — alternating mLSTM + sLSTM blocks [arXiv:2405.04517]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,  # xLSTM blocks carry their own projections
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
)
