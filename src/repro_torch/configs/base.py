"""Model configuration for the port: its own copy of the reference
``ModelConfig``, ``QuantConfig``, ``ShapeConfig``, ``SHAPES`` and
``supported_shapes`` (``repro/configs/base.py``), so the port imports
nothing of the JAX package. ``reduced()`` gives the CPU-sized config of the
same family (small dims, few experts, tiny vocab)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ModelConfig", "QuantConfig", "SHAPES", "ShapeConfig", "supported_shapes"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """PMQ compression settings attached to a model."""

    enabled: bool = False
    target_avg_bits: float = 2.25
    bit_choices: Tuple[int, ...] = (1, 2, 3)
    group: int = 128
    attn_bits: int = 4  # uniform width for non-expert weights (paper §3.2.3)
    alpha: float = 1.0
    beta: float = 0.5
    gamma: float = 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_capacity_factor: float = 1.25
    # --- attention pattern ---
    local_window: int = 0  # sliding window for local layers
    local_global_ratio: int = 0  # N local layers per 1 global (gemma3: 5)
    qk_norm: bool = False
    attn_bias: bool = False
    # --- hybrid / ssm ---
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rglru","rglru","attn")
    rglru_width: int = 0  # RNN width (recurrentgemma: d_model*1.0 rounded)
    # --- encoder-decoder ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # fixed source length (whisper: 1500 frames)
    # --- frontend stubs ---
    frontend: str = ""  # "" | "patch_stub" | "frame_stub"
    num_patch_tokens: int = 0  # llava anyres tiles -> tokens
    # --- misc ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    quant: QuantConfig = QuantConfig()
    # remat policy: "none" | "block" (checkpoint each layer)
    remat: str = "block"
    # loss chunking (tokens per logits chunk; bounds logits memory)
    logits_chunk: int = 512
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md: sliding-window/recurrent)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.local_global_ratio > 0 and self.local_window > 0

    def reduced(self) -> "ModelConfig":
        """Smoke-test config: same family/topology, tiny dims."""
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 2 if not self.block_pattern else len(self.block_pattern)),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=32,
            d_ff=256,
            d_ff_expert=128 if self.d_ff_expert else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            num_patch_tokens=min(self.num_patch_tokens, 8) if self.num_patch_tokens else 0,
            local_window=min(self.local_window, 16) if self.local_window else 0,
            rglru_width=128 if self.rglru_width else 0,
            logits_chunk=64,
            attn_q_chunk=32,
            attn_kv_chunk=32,
            dtype="float32",
            remat="none",
        )

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, l = self.d_model, self.num_layers
        attn = l * (
            self.num_heads * self.head_dim * d * 2  # q, o
            + self.num_kv_heads * self.head_dim * d * 2  # k, v
        )
        if self.family == "encdec":
            attn += self.encoder_layers * (
                self.num_heads * self.head_dim * d * 4
            ) + l * (self.num_heads * self.head_dim * d * 2 + self.num_kv_heads * self.head_dim * d * 2)
        ffn = 0
        if self.is_moe:
            ffn = l * self.num_experts * 3 * d * self.d_ff_expert
            ffn += l * self.num_shared_experts * 3 * d * self.d_ff_expert
            ffn += l * d * self.num_experts  # router
        elif self.d_ff:
            nl = l + (self.encoder_layers if self.family == "encdec" else 0)
            ffn = nl * 3 * d * self.d_ff
        if self.family == "ssm":  # xlstm block projections (approx)
            ffn = l * (8 * d * d)
        if self.family == "hybrid":
            n_rec = sum(1 for b in self.block_pattern for _ in [b] if b == "rglru")
            # per recurrent block: in/out proj + gates
            ffn += 0  # counted via d_ff MLPs; rglru params small
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return attn + ffn + emb

    def active_param_count(self) -> int:
        """Per-token activated parameters (MoE: top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        d, l = self.d_model, self.num_layers
        total = self.param_count()
        all_experts = l * self.num_experts * 3 * d * self.d_ff_expert
        active = l * self.top_k * 3 * d * self.d_ff_expert
        return total - all_experts + active


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


def supported_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """The shape cells of an arch: train, prefill and decode, and
    ``long_500k`` for the sub-quadratic ones."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return tuple(names)
