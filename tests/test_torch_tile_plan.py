"""The host-side tiling of the port's bf16 dequant-GEMM body and the plain
version of its per-group value tables, on the CPU.

``kernels/quant_matmul.py: tile_plan`` is what ``csrc/dequant_gemm_sm90.cuh``
runs: it must take no M (a row's arithmetic never depends on how many rows
there are), cover K and N exactly, and fit the card's shared memory at every
shape of the main path. ``ref.dequant_table_ref`` is the table the kernel
builds once per (group, column); each weight the kernel looks up must equal
``ref.dequant_ref``'s value byte for byte.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.packing import unpack_bits  # noqa: E402
from repro_torch.core.quantizers import quantize_parts  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.quant_matmul import SMEM_OPTIN, tile_plan  # noqa: E402

from _torch_interop import torch_one_thread  # noqa: E402,F401


def _main_path_shapes():
    """(K, N, bits, rows) of every bf16 dequant GEMM on the full-width path:
    4-bit attention and shared-expert linears through quant_matmul (row tile
    8), and each expert bucket's gate/up and down projections at the decode
    (bm 8) and prefill (bm 16) row blocks."""
    cfg = get_config("moonshot-v1-16b-a3b")
    d, f = cfg.d_model, cfg.d_ff_expert
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    fs = f * cfg.num_shared_experts
    shapes = [(d, qd, 4, 8), (d, kvd, 4, 8), (qd, d, 4, 8), (d, fs, 4, 8), (fs, d, 4, 8)]
    for bits in (1, 2, 3):
        for bm in (8, 16):
            shapes += [(d, f, bits, bm), (f, d, bits, bm)]
    return cfg.quant.group, shapes


GROUP, SHAPES = _main_path_shapes()


def test_tile_plan_takes_no_m():
    """The plan's inputs are static shapes only: no M, no row count of the
    call, so bf16 rows come out bit-identical for any M; ``operands`` (2 for
    SwiGLU's gate and up) defaults to one."""
    params = list(inspect.signature(tile_plan).parameters)
    assert params == ["k", "n", "bits", "group", "dtype", "rows", "operands"]
    a = tile_plan(2048, 2048, 4, 128, torch.bfloat16)
    assert a == tile_plan(2048, 2048, 4, 128, torch.bfloat16, rows=8, operands=1)
    assert a["rows"] == 8 and a["col_tile"] == 16 and a["operands"] == 1
    with pytest.raises(ValueError):
        tile_plan(2048, 2048, 4, 128, torch.bfloat16, operands=3)


def _swiglu_shapes():
    """(bits, rows) of every expert bucket's gate/up GEMM on the main path
    (K = d_model → N = d_ff_expert): bits 1-3 at the decode (bm 8) and
    prefill (bm 16) row blocks."""
    return [(bits, rows) for bits in (1, 2, 3) for rows in (8, 16)]


@pytest.mark.parametrize("bits,rows", _swiglu_shapes())
def test_two_operand_plan_covers_swiglu(bits, rows):
    """SwiGLU's plan: the same K split and column tiles as one operand, twice
    the stage buffers and value tables, one reduction buffer; it fits the
    opt-in shared memory, and the 2- and 3-bit decode shapes fit two blocks
    on an SM."""
    cfg = get_config("moonshot-v1-16b-a3b")
    k, n = cfg.d_model, cfg.d_ff_expert
    one = tile_plan(k, n, bits, GROUP, torch.bfloat16, rows=rows)
    two = tile_plan(k, n, bits, GROUP, torch.bfloat16, rows=rows, operands=2)
    assert two["body"] == "dequant_gemm_sm90.cuh" and two["operands"] == 2
    assert two["smem_bytes"] <= SMEM_OPTIN
    for key in ("k_slices", "k_steps", "n_tiles", "tables", "col_tile", "warps"):
        assert two[key] == one[key]
    ends = [b for _, b in two["k_slices"]]
    assert two["k_slices"][0][0] == 0 and ends[-1] == two["k_steps"]
    for (a0, b0), (a1, _) in zip(two["k_slices"], two["k_slices"][1:]):
        assert a0 <= b0 and (a1 == b0 or a1 >= two["k_steps"])
    # the second operand adds one stage region per buffer and one table, no x
    kx, ng = two["k_steps"] * 16, -(-k // GROUP)
    plane_rows = kx // 8 * 3 if bits == 3 else kx // (8 // bits)
    pairs = bits <= 2
    table = ng * 16 * ((1 << 2 * bits) + 1 if pairs else (1 << bits) + 2) * (4 if pairs else 2)
    stage = plane_rows * 16 + ng * 2 * 16 * 4
    assert two["smem_bytes"] - one["smem_bytes"] == 2 * stage + -(-table // 16) * 16
    if rows == 8 and bits in (2, 3):
        assert two["smem_blocks_per_sm"] >= 2
    assert tile_plan(k, n, bits, GROUP, torch.float32, rows=rows,
                     operands=2)["body"] == "dequant_gemm.cuh"


@pytest.mark.parametrize("k,n,bits,rows", SHAPES)
def test_tile_plan_covers_main_path(k, n, bits, rows):
    p = tile_plan(k, n, bits, GROUP, torch.bfloat16, rows=rows)
    assert p["body"] == "dequant_gemm_sm90.cuh"
    assert p["smem_bytes"] <= SMEM_OPTIN
    assert p["n_tiles"] * p["col_tile"] >= n > (p["n_tiles"] - 1) * p["col_tile"]
    assert p["k_steps"] * 16 >= k > (p["k_steps"] - 1) * 16
    # the warps' slices partition the k16 steps in order (a fixed reduction order)
    ends = [b for _, b in p["k_slices"]]
    assert p["k_slices"][0][0] == 0 and ends[-1] == p["k_steps"]
    for (a0, b0), (a1, _) in zip(p["k_slices"], p["k_slices"][1:]):
        assert a0 <= b0 and (a1 == b0 or a1 >= p["k_steps"])
    # every k16 step lies inside one quantization group
    for s in range(p["k_steps"]):
        assert (16 * s) // GROUP == (16 * s + 15) // GROUP
    assert p["tables"] == ("code pairs" if bits <= 2 else "codes")
    # the grid fills the card's 132 SMs at decode (one item per column tile)
    assert p["n_tiles"] >= 88


def test_tile_plan_f32_keeps_cuda_core_body():
    assert tile_plan(2048, 2048, 4, 128, torch.float32)["body"] == "dequant_gemm.cuh"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_dequant_table_matches_dequant_ref(bits, dtype):
    """Looking each code up in the per-(group, column) table gives
    dequant_ref's weight byte for byte, ragged last group included."""
    rng = np.random.default_rng(bits)
    k, n, group = 3 * 64 + 32, 24, 64
    w = torch.from_numpy(rng.standard_normal((2, k, n)).astype(np.float32))
    data, scale, zero = quantize_parts(w, bits, group, refine=bits > 1)
    want = ref.dequant_ref(data, scale, zero, bits, k, group, dtype=dtype)
    table = ref.dequant_table_ref(scale, zero, bits, dtype=dtype)  # [E, ng, N, 2^bits]
    assert table.shape == (2, -(-k // group), n, 1 << bits) and table.dtype == dtype
    if bits == 3:
        hi, lo = data
        codes = (unpack_bits(hi, 2, axis=-2) << 1) | unpack_bits(lo, 1, axis=-2)
    else:
        codes = unpack_bits(data, bits, axis=-2)
    codes = codes[..., :k, :].long()
    g = (torch.arange(k) // group)[None, :, None].expand(2, k, n)
    e = torch.arange(2)[:, None, None].expand(2, k, n)
    col = torch.arange(n)[None, None, :].expand(2, k, n)
    got = table[e, g, col, codes]
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
