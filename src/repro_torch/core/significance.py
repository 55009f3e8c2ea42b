"""Expert significance analysis (paper §3.2.1–3.2.2, Figs. 4/5).

Port of ``repro/core/significance.py``. Three signals per expert, gathered
on a calibration set:

* access frequency     ``phi_i = n_i / N``            (how often routed to)
* activation weight    ``w_i = Σ_j sigma_j / N``      (mean routing weight)
* reconstruction error ``eps_{i,j}`` (Eq. 6): F-norm between the MoE layer
  output with full-precision experts and with only expert *i* quantized to
  *j* bits.

Routing statistics accumulate in numpy from ``(top-k indices, top-k
gates)`` streams, as the reference's do. ``eps`` runs a caller-supplied
layer forward that takes the one substituted expert, so the caller can swap
one expert's weights in place instead of rebuilding the stack per call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["RouterStats", "expert_eps", "importance"]


@dataclasses.dataclass
class RouterStats:
    """Streaming accumulator for phi / w over calibration batches."""

    num_experts: int
    counts: np.ndarray = None  # [E]
    weight_sums: np.ndarray = None  # [E]
    tokens: int = 0

    def __post_init__(self):
        if self.counts is None:
            self.counts = np.zeros(self.num_experts, np.int64)
        if self.weight_sums is None:
            self.weight_sums = np.zeros(self.num_experts, np.float64)

    def update(self, topk_idx, topk_gates) -> None:
        """``topk_idx [T, k]`` int, ``topk_gates [T, k]`` float (host arrays)."""
        idx = np.asarray(topk_idx).reshape(-1)
        gts = np.asarray(topk_gates, np.float64).reshape(-1)
        self.counts += np.bincount(idx, minlength=self.num_experts)
        self.weight_sums += np.bincount(idx, weights=gts, minlength=self.num_experts)
        self.tokens += int(np.asarray(topk_idx).shape[0])

    @property
    def phi(self) -> np.ndarray:
        """Access frequency ``n_i / N`` (N = token count)."""
        return self.counts / max(self.tokens, 1)

    @property
    def w(self) -> np.ndarray:
        """Mean routing weight ``Σ sigma / N``."""
        return self.weight_sums / max(self.tokens, 1)


def expert_eps(
    layer_forward: Callable[[Optional[Tuple[int, object]]], torch.Tensor],
    num_experts: int,
    quantize_expert: Callable[[int, int], object],
    bits_options: Sequence[int] = (1, 2, 3),
) -> np.ndarray:
    """Eq. 6: ``eps[i, j] = ||F(theta) - F(theta[e_i -> Q(e_i, j)])||_F``.

    ``layer_forward(None)`` runs the MoE layer on the calibration inputs;
    ``layer_forward((i, weights))`` runs it with expert ``i``'s weights
    replaced by ``weights``. ``quantize_expert(i, bits)`` returns expert
    ``i``'s fake-quantized (quantize → dequantize) weights. The norms are
    taken in f32 and stay on the device until the one transfer at the end.
    """
    base = layer_forward(None)
    norms = []
    for i in range(num_experts):
        for bits in bits_options:
            out = layer_forward((i, quantize_expert(i, bits)))
            norms.append(torch.linalg.vector_norm((out - base).float()))
    eps = torch.stack(norms).double().cpu().numpy()
    return eps.reshape(num_experts, len(bits_options))


def importance(phi: np.ndarray, w: np.ndarray, alpha: float = 1.0,
               beta: float = 0.5) -> np.ndarray:
    """Overall expert importance ``phi^alpha * w^beta`` (§3.2.2)."""
    return np.power(np.maximum(phi, 1e-12), alpha) * np.power(np.maximum(w, 1e-12), beta)
