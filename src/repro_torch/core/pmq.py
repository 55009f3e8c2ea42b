"""PMQ — Pre-Loading Mixed-Precision Quantization (paper §3.2, Eq. 7).

Port of ``repro/core/pmq.py``: the same numpy and scipy code, so a plan
is the reference's bit for bit on the same costs.

Bit-width allocation as an Integer Program:

    min  Σ_i Σ_j  phi_i^α · w_i^β · (eps_ij)^γ · x_ij
    s.t. Σ_ij j·x_ij = n·b     (exact average-bit budget)
         Σ_j  x_ij  = 1  ∀i    (one width per expert)
         Σ_i x_i,3bit ≥ 1, Σ_i x_i,2bit ≥ 1   (accuracy floors)
         x_ij ∈ {0,1}

Two exact solvers, cross-checked in tests:

* :func:`allocate_block_milp` — scipy ``milp`` (the paper's LP/IP route;
  solves a 384-expert block in well under a second).
* :func:`allocate_block_dp`   — exact dynamic program over
  (expert, budget, has-2bit, has-3bit); dependency-free, deterministic.

A model-level helper distributes a fractional global budget across layers
and can optionally let sensitive layers borrow bits from insensitive ones
(beyond-paper ``layer_adaptive`` mode).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .significance import importance

__all__ = [
    "PMQPlan",
    "pmq_costs",
    "allocate_block_dp",
    "allocate_block_milp",
    "allocate_model",
]

BIT_CHOICES = (1, 2, 3)


def pmq_costs(
    phi: np.ndarray,
    w: np.ndarray,
    eps: np.ndarray,
    alpha: float = 1.0,
    beta: float = 0.5,
    gamma: float = 1.0,
) -> np.ndarray:
    """Objective coefficients ``c[i,j] = phi^α·w^β·eps^γ`` ([E, |bits|])."""
    imp = importance(phi, w, alpha, beta)  # [E]
    return imp[:, None] * np.power(np.maximum(eps, 0.0), gamma)


def allocate_block_dp(
    costs: np.ndarray,
    budget: int,
    bit_choices: Sequence[int] = BIT_CHOICES,
    require_floors: bool = True,
) -> np.ndarray:
    """Exact DP for Eq. 7. ``costs [E, |bits|]``, ``budget = n·b`` (int).

    State: (expert prefix, bits spent, seen-2bit, seen-3bit). Complexity
    O(E² · max_bits · 4 · |bits|) in time via vectorized numpy transitions,
    O(E · budget · 4) memory for exact backtracking — a 384-expert block
    solves in milliseconds. Returns the chosen bit-width per expert.
    """
    e, nb = costs.shape
    assert nb == len(bit_choices)
    lo, hi = min(bit_choices) * e, max(bit_choices) * e
    if not (lo <= budget <= hi):
        raise ValueError(f"budget {budget} infeasible for {e} experts {bit_choices}")
    inf = np.inf
    two_i = bit_choices.index(2) if 2 in bit_choices else -1
    three_i = bit_choices.index(3) if 3 in bit_choices else -1
    use_floors = require_floors and e >= 2 and two_i >= 0 and three_i >= 0

    def transition(dp, i):
        """one expert step: returns new dp [B+1, 2, 2]."""
        ndp = np.full_like(dp, inf)
        for j, bits in enumerate(bit_choices):
            shifted = np.full_like(dp, inf)
            shifted[bits:, :, :] = dp[: dp.shape[0] - bits, :, :]
            upd = shifted
            if use_floors and j == two_i:
                m = np.full_like(dp, inf)
                m[:, 1, :] = np.minimum(shifted[:, 0, :], shifted[:, 1, :])
                upd = m
            elif use_floors and j == three_i:
                m = np.full_like(dp, inf)
                m[:, :, 1] = np.minimum(shifted[:, :, 0], shifted[:, :, 1])
                upd = m
            ndp = np.minimum(ndp, upd + costs[i, j])
        return ndp

    tables = [np.full((budget + 1, 2, 2), inf)]
    tables[0][0, 0, 0] = 0.0
    for i in range(e):
        tables.append(transition(tables[i], i))

    final = tables[e]
    if use_floors:
        if np.isinf(final[budget, 1, 1]):
            raise ValueError("infeasible under floor constraints")
        state = (budget, 1, 1)
    else:
        flat = int(np.argmin(final[budget]))
        state = (budget, flat // 2, flat % 2)
        if np.isinf(final[state]):
            raise ValueError("infeasible")

    # exact backtrack: find (j, predecessor state) reproducing the value
    bits_out = np.zeros(e, np.int32)
    b, f2, f3 = state
    for i in range(e - 1, -1, -1):
        val = tables[i + 1][b, f2, f3]
        found = False
        for j, bits in enumerate(bit_choices):
            if b - bits < 0:
                continue
            # enumerate valid predecessor flags
            if use_floors and j == two_i:
                preds = [(0, f3), (1, f3)] if f2 == 1 else []
            elif use_floors and j == three_i:
                preds = [(f2, 0), (f2, 1)] if f3 == 1 else []
            else:
                preds = [(f2, f3)]
            for pf2, pf3 in preds:
                prev = tables[i][b - bits, pf2, pf3]
                if np.isfinite(prev) and np.isclose(
                    prev + costs[i, j], val, rtol=1e-9, atol=1e-12
                ):
                    bits_out[i] = bits
                    b, f2, f3 = b - bits, pf2, pf3
                    found = True
                    break
            if found:
                break
        if not found:  # pragma: no cover - numeric safety net
            raise RuntimeError("DP backtrack failed")
    return bits_out


def allocate_block_milp(
    costs: np.ndarray,
    budget: int,
    bit_choices: Sequence[int] = BIT_CHOICES,
    require_floors: bool = True,
) -> np.ndarray:
    """Eq. 7 via ``scipy.optimize.milp`` (HiGHS branch-and-bound)."""
    from scipy import optimize, sparse

    e, nb = costs.shape
    nvar = e * nb
    c = costs.reshape(-1).astype(np.float64)

    rows, cols, vals, lb, ub = [], [], [], [], []
    r = 0
    for i in range(e):  # budget row
        for j, bits in enumerate(bit_choices):
            rows.append(r), cols.append(i * nb + j), vals.append(float(bits))
    lb.append(float(budget)), ub.append(float(budget))
    r += 1
    for i in range(e):  # one-hot rows
        for j in range(nb):
            rows.append(r), cols.append(i * nb + j), vals.append(1.0)
        lb.append(1.0), ub.append(1.0)
        r += 1
    if require_floors and e >= 2:
        for target in (2, 3):
            if target in bit_choices:
                jj = bit_choices.index(target)
                for i in range(e):
                    rows.append(r), cols.append(i * nb + jj), vals.append(1.0)
                lb.append(1.0), ub.append(np.inf)
                r += 1
    a = sparse.csr_matrix((vals, (rows, cols)), shape=(r, nvar))
    res = optimize.milp(
        c,
        constraints=optimize.LinearConstraint(a, np.array(lb), np.array(ub)),
        integrality=np.ones(nvar),
        bounds=optimize.Bounds(0, 1),
    )
    if not res.success:
        raise ValueError(f"MILP failed: {res.message}")
    x = np.round(res.x).reshape(e, nb)
    return np.array([bit_choices[int(np.argmax(row))] for row in x], np.int32)


@dataclasses.dataclass
class PMQPlan:
    """Model-level allocation: ``bits[L][E]`` + bookkeeping."""

    bits: list  # list of np.ndarray [E_l]
    target_avg_bits: float
    objective: float
    layer_budgets: np.ndarray

    @property
    def avg_bits(self) -> float:
        tot = sum(int(b.sum()) for b in self.bits)
        cnt = sum(len(b) for b in self.bits)
        return tot / max(cnt, 1)

    def histogram(self) -> dict:
        h: dict = {}
        for b in self.bits:
            for v in b:
                h[int(v)] = h.get(int(v), 0) + 1
        return h


def allocate_model(
    phi: np.ndarray,
    w: np.ndarray,
    eps: np.ndarray,
    target_avg_bits: float,
    alpha: float = 1.0,
    beta: float = 0.5,
    gamma: float = 1.0,
    bit_choices: Sequence[int] = BIT_CHOICES,
    solver: str = "dp",
    layer_adaptive: bool = False,
) -> PMQPlan:
    """Allocate bit-widths for all layers.

    ``phi, w [L, E]``, ``eps [L, E, |bits|]``. Per the paper each MoE block
    gets the same integer budget ``round(E·b)`` (largest-remainder rounding
    so the *global* average hits the target exactly). ``layer_adaptive=True``
    additionally shifts whole bits between layers proportional to layer
    sensitivity ``Σ_i c[i, lowest-bit]`` (beyond-paper option).
    """
    L, E = phi.shape
    total = int(round(target_avg_bits * L * E))
    base = np.full(L, total // L)
    budgets = base.copy()
    for i in range(total - int(base.sum())):  # largest-remainder leftover
        budgets[i % L] += 1

    costs = [
        pmq_costs(phi[l], w[l], eps[l], alpha, beta, gamma) for l in range(L)
    ]
    if layer_adaptive and L > 1:
        sens = np.array([c[:, 0].sum() for c in costs])
        sens = sens / max(sens.sum(), 1e-12)
        shift = np.round((sens - 1.0 / L) * 0.5 * E).astype(np.int64)
        budgets = np.clip(
            budgets + shift, min(bit_choices) * E + 2, max(bit_choices) * E - 2
        )
        drift = total - int(budgets.sum())  # repair rounding/clipping drift
        i = 0
        while drift != 0:
            step = 1 if drift > 0 else -1
            nb = budgets[i % L] + step
            if min(bit_choices) * E + 2 <= nb <= max(bit_choices) * E - 2:
                budgets[i % L] = nb
                drift -= step
            i += 1

    alloc_fn = allocate_block_dp if solver == "dp" else allocate_block_milp
    bits, obj = [], 0.0
    for layer in range(L):
        b = alloc_fn(costs[layer], int(budgets[layer]), bit_choices)
        bits.append(b)
        for i, bv in enumerate(b):
            obj += float(costs[layer][i, list(bit_choices).index(int(bv))])
    return PMQPlan(
        bits=bits,
        target_avg_bits=target_avg_bits,
        objective=obj,
        layer_budgets=budgets,
    )
