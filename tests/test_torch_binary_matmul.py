"""The port's ``binary_matmul`` kernels written out in plain torch, on the CPU.

``csrc/binary_matmul.cu`` cannot run here, so its arithmetic is modelled
step for step: the bf16 kernel's A fragments built from the packed bits (a
pair of codes to a bf16x2 of ±1 by setting sign bits, half a byte per lane
and k16 step), its K cut into the warps' slices of k16 steps
(:func:`binary_plan`), each slice summed step by step in f32 and the slices
added in warp order before alpha; and the f32 kernel's order (256-code
chunks, 32 codes a warp, f32 FMAs). The fragments must give exactly
``2·unpack − 1``; the models are held to the JAX reference
(``repro.kernels.ref.binary_matmul_ref`` and ``binary_matmul_pallas`` in
interpret mode) within ``2e-2 · max|ref|`` for bf16 (the outputs round to
bf16) and ``1e-4 · max|ref|`` for f32 (only the summation order differs).
The port's wrapper on the CPU (its plain version) is held to the same.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.packing import pack_bits as jpack_bits  # noqa: E402
from repro.core.packing import unpack_bits as junpack_bits  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.binary_matmul import binary_matmul_pallas  # noqa: E402
from repro_torch.kernels.binary_matmul import binary_matmul, binary_plan  # noqa: E402

from _torch_interop import torch_one_thread  # noqa: E402,F401

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(seed, m, k, n):
    """x [M, K] f32, b_packed [ceil(K/8), N] uint8 (bits padded with zeros to
    a whole byte, as the packer lays them out), alpha [1, N] f32."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    bits = np.pad((w >= 0).astype(np.uint8), ((0, -k % 8), (0, 0)))
    b_packed = np.array(jpack_bits(jnp.asarray(bits), 1, axis=0))
    alpha = np.abs(w).mean(axis=0, keepdims=True).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, b_packed, alpha


def pm1_pair(p: torch.Tensor) -> torch.Tensor:
    """The kernel's ``pm1_pair``: two codes (bit 0 the lower k) to the bits
    of a bf16x2, +1 = 0x3F80 for a set bit, -1 = 0xBF80 for a clear one."""
    p = p.to(torch.int64)
    return 0x3F803F80 | ((~p & 1) << 15) | ((~p & 2) << 30)


def fragment_weights(b_packed: torch.Tensor, k: int) -> torch.Tensor:
    """``[kx, N]`` f32 weights as the bf16 kernel's A fragments carry them:
    lane t of a k16 step at code kb reads half of byte kb/8 + t/2 of its
    column (shift 4·(t & 1)), codes 4t, 4t+1 in register a[h] and 4t+2, 4t+3
    in a[2 + h], low half the lower code. Rows past ceil(K/8) are zero
    bytes, as the kernel stages them."""
    plan = binary_plan(k, b_packed.shape[1])
    kx = plan["k_steps"] * 16
    rows = torch.zeros((kx // 8, b_packed.shape[1]), dtype=torch.int64)
    rows[: b_packed.shape[0]] = b_packed.to(torch.int64)
    w = torch.empty((kx, b_packed.shape[1]), dtype=torch.float32)
    for s in range(plan["k_steps"]):
        kb = 16 * s
        for t in range(4):
            codes = rows[(kb >> 3) + (t >> 1)] >> (4 * (t & 1))
            for i, pair in enumerate((codes & 3, (codes >> 2) & 3)):
                reg = pm1_pair(pair)
                for half in range(2):
                    h16 = ((reg >> (16 * half)) & 0xFFFF).to(torch.int32)
                    val = (h16 << 16).view(torch.float32)  # bf16 bits -> f32, exact
                    w[kb + 4 * t + 2 * i + half] = val
    return w


def emulate_bf16(x, b_packed, alpha) -> torch.Tensor:
    """The bf16 kernel's sum: x rounded to bf16 (zero past K), each warp's
    slice of k16 steps added step by step in f32, the slices in warp order,
    then alpha, then bf16."""
    m, k = x.shape
    plan = binary_plan(k, b_packed.shape[1])
    w = fragment_weights(b_packed, k)
    xp = torch.zeros((m, w.shape[0]), dtype=torch.float32)
    xp[:, :k] = x.to(torch.bfloat16).float()
    total = None
    for lo, hi in plan["k_slices"]:
        part = torch.zeros((m, w.shape[1]), dtype=torch.float32)
        for s in range(lo, hi):
            part = part + xp[:, 16 * s:16 * s + 16] @ w[16 * s:16 * s + 16]
        total = part if total is None else total + part
    return (total * alpha).to(torch.bfloat16)


def emulate_f32(x, b_packed, alpha) -> torch.Tensor:
    """The f32 kernel's sum: chunks of 256 codes, warp j taking codes
    [32j, 32j + 32) of each chunk one FMA at a time, the 8 warp partials in
    warp order, then alpha."""
    m, k = x.shape
    w = fragment_weights(b_packed, k)[:k]
    warps = [torch.zeros((m, w.shape[1]), dtype=torch.float32) for _ in range(8)]
    for k0 in range(0, k, 256):
        for j in range(8):
            for kk in range(k0 + 32 * j, min(k0 + 32 * j + 32, k)):
                warps[j] = warps[j] + x[:, kk:kk + 1] * w[kk]
    total = warps[0]
    for p in warps[1:]:
        total = total + p
    return total * alpha


@pytest.mark.parametrize("k,n", [(2048, 16), (451, 40), (200, 24), (8, 16)])
def test_fragments_are_two_unpack_minus_one(k, n):
    """The bits-to-±1 fragments give ``2·unpack − 1`` for every code of K,
    ragged K included (padding codes are never multiplied: x is zero there)."""
    _, b_packed, _ = _inputs(k, 1, k, n)
    want = np.asarray(junpack_bits(jnp.asarray(b_packed), 1, axis=0))[:k].astype(np.float32)
    got = fragment_weights(torch.from_numpy(b_packed), k)[:k].numpy()
    assert np.array_equal(got, 2 * want - 1)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(16, 512, 256), (5, 264, 96), (24, 2048, 128)])
def test_kernel_models_match_pallas(dtype, m, k, n):
    """The kernels' orders against ``binary_matmul_pallas(interpret=True)``
    and the JAX oracle; the port's CPU wrapper too."""
    x, b_packed, alpha = _inputs(m * k + n, m, k, n)
    xt, bt, at = torch.from_numpy(x).to(dtype), torch.from_numpy(b_packed), torch.from_numpy(alpha)
    jx, jb, ja = jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(b_packed), jnp.asarray(alpha)
    pallas = np.asarray(binary_matmul_pallas(jx, jb, ja, interpret=True).astype(jnp.float32))
    oracle = np.asarray(jref.binary_matmul_ref(jx, jb, ja).astype(jnp.float32))
    model = emulate_bf16(xt.float(), bt, at) if dtype == torch.bfloat16 else \
        emulate_f32(xt, bt, at)
    for want in (pallas, oracle):
        _close(model.float().numpy(), want, dtype)
        _close(binary_matmul(xt, bt, at).float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 451, 40), (7, 200, 24), (3, 8, 16)])
def test_kernel_models_ragged_k(dtype, m, k, n):
    """K off the byte and off the k16 step (the Pallas kernel takes whole
    blocks only): the models against the JAX oracle."""
    x, b_packed, alpha = _inputs(m * k + n, m, k, n)
    xt, bt, at = torch.from_numpy(x).to(dtype), torch.from_numpy(b_packed), torch.from_numpy(alpha)
    oracle = np.asarray(jref.binary_matmul_ref(jnp.asarray(x).astype(JDT[dtype]),
                                               jnp.asarray(b_packed), jnp.asarray(alpha))
                        .astype(jnp.float32))
    model = emulate_bf16(xt.float(), bt, at) if dtype == torch.bfloat16 else \
        emulate_f32(xt, bt, at)
    _close(model.float().numpy(), oracle, dtype)


def test_plan_takes_no_m_and_partitions_k():
    p = binary_plan(2048, 1408)
    assert p["n_tiles"] == 88 and p["k_steps"] == 128 and p["rows"] == 8
    ends = [b for _, b in p["k_slices"]]
    assert p["k_slices"][0][0] == 0 and ends[-1] == p["k_steps"]
    for (a0, b0), (a1, _) in zip(p["k_slices"], p["k_slices"][1:]):
        assert a0 <= b0 and (a1 == b0 or a1 >= p["k_steps"])
    # bits of the tile (K/8 rows of 16 bytes), 8 padded x rows, the warps' partials
    assert p["smem_bytes"] == 256 * 16 + 8 * 2064 * 2 + 8 * 8 * 16 * 4
