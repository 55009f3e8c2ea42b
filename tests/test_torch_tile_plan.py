"""The host-side tiling of the port's bf16 dequant-GEMM body and the plain
version of its per-group value tables, on the CPU.

``kernels/quant_matmul.py: tile_plan`` is what ``csrc/dequant_gemm_sm90.cuh``
runs: it must take no M (a row's arithmetic never depends on how many rows
there are), cover K and N exactly, and fit the card's shared memory at every
shape of the main path. Where an item's whole K range does not fit, K is
cut into the fewest chunks of whole groups that do (kimi-k2's d_model 7168,
command-r's 8192, qwen3-14b's d_ff 17408); where it fits, the plan is the
whole-K plan the kernel ran before it could chunk, field for field.
``ref.dequant_table_ref`` is the table the kernel builds once per (group,
column); each weight the kernel looks up must equal ``ref.dequant_ref``'s
value byte for byte.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.packing import unpack_bits  # noqa: E402
from repro_torch.core.quantizers import quantize_parts  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.quant_matmul import (  # noqa: E402
    SMEM_OPTIN, _smem, check_plan, tile_plan)

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


def _whole_k_plan(k, n, bits, group, rows=8, operands=1):
    """The plan of the body that staged all of K per item, whatever its size
    (the kernel before it could chunk K): the bytes it needed."""
    kx = -(-k // 16) * 16
    ng = -(-k // group)
    plane_rows = (kx // 8 * 2 + kx // 8) if bits == 3 else kx // (8 // bits)
    steps = kx // 16
    spw = -(-steps // 8)
    pairs = bits <= 2
    entries = 1 << (2 * bits if pairs else bits)
    table = ng * 16 * (entries + 1 if pairs else entries + 2) * (4 if pairs else 2)
    x_stride = kx + 2 * ((8 - (kx // 2) % 32) % 32)
    stage = plane_rows * 16 + ng * 2 * 16 * 4
    smem = (2 * operands * stage + operands * (-(-table // 16) * 16) + rows * x_stride * 2
            + 8 * rows * 16 * 4)
    return {
        "body": "dequant_gemm_sm90.cuh", "rows": rows, "operands": operands,
        "col_tile": 16, "warps": 8, "n_tiles": -(-n // 16), "k_steps": steps,
        "k_slices": [(w * spw, min(steps, (w + 1) * spw)) for w in range(8)],
        "tables": "code pairs" if pairs else "codes", "smem_bytes": smem,
        "smem_blocks_per_sm": 233472 // (smem + 1024),
    }


def test_whole_k_staging_overflowed_at_model_widths():
    """The fault: staging all of K per item needs more than the 227 KB a block
    may use at kimi-k2's d_model (4-bit quant_matmul: 273 KB; 4-bit SwiGLU at
    bm 16: 547 KB) and at qwen3-14b's d_ff, so the wrappers refused those
    shapes. The chunked plans are accepted; a plan past the limit still
    raises, naming the kernel."""
    bf16 = torch.bfloat16
    for k, rows, nop in ((7168, 8, 1), (7168, 16, 2), (17408, 8, 1)):
        assert _whole_k_plan(k, 2048, 4, 128, rows, nop)["smem_bytes"] > SMEM_OPTIN
        check_plan("quant_matmul", tile_plan(k, 2048, 4, 128, bf16, rows=rows, operands=nop))
    assert _whole_k_plan(7168, 2048, 4, 128)["smem_bytes"] == 280320  # 273.75 KiB
    with pytest.raises(ValueError, match="moe_gmm_swiglu"):
        check_plan("moe_gmm_swiglu", {"smem_bytes": SMEM_OPTIN + 16})


def _split_k_cases():
    """(K, bits, rows, operands): quant_matmul (rows 8, one operand), moe_gmm
    (bm 8 and 16) and moe_gmm_swiglu (bm 8 and 16, two operands) at bits
    1-4, for K = 7168, 8192 and 17408."""
    kinds = [(8, 1), (8, 2), (16, 1), (16, 2)]
    return [(k, bits, rows, nop) for k in (7168, 8192, 17408) for bits in (1, 2, 3, 4)
            for rows, nop in kinds]


@pytest.mark.parametrize("k,bits,rows,nop", _split_k_cases())
def test_split_k_plan(k, bits, rows, nop):
    """The fewest chunks that fit SMEM_OPTIN, each of whole quantization
    groups (so whole k16 steps) and even but for the last; the chunks cover
    K's steps in order and each chunk's warp slices partition it in order."""
    p = tile_plan(k, 2048, bits, GROUP, torch.bfloat16, rows=rows, operands=nop)
    assert p["smem_bytes"] <= SMEM_OPTIN
    chunks = p["k_chunks"]
    assert chunks[0][0] == 0 and chunks[-1][1] == p["k_steps"] == -(-k // 16)
    for (a0, b0), (a1, _) in zip(chunks, chunks[1:]):
        assert b0 == a1
    width = chunks[0][1] - chunks[0][0]
    assert (16 * width) % GROUP == 0
    for lo, hi in chunks:
        assert (16 * lo) % GROUP == 0 and 0 < hi - lo <= width
    assert len(p["k_slices"]) == len(chunks) * p["warps"]
    for c, (lo, hi) in enumerate(chunks):
        sl = p["k_slices"][c * p["warps"]:(c + 1) * p["warps"]]
        assert sl[0][0] == lo and max(b for _, b in sl) == hi
        for (a0, b0), (a1, _) in zip(sl, sl[1:]):
            assert a0 <= b0 and (a1 == b0 or a1 >= hi)
    # one chunk fewer (even chunks of whole groups) would not fit
    if len(chunks) > 1:
        assert _whole_k_plan(k, 2048, bits, GROUP, rows, nop)["smem_bytes"] > SMEM_OPTIN
    if len(chunks) > 2:
        gpc = -(-(-(-k // GROUP)) // (len(chunks) - 1))
        assert _smem(gpc * GROUP, gpc, bits, rows, nop, chunked=True) > SMEM_OPTIN


@pytest.mark.parametrize("k,n,bits,rows", SHAPES)
@pytest.mark.parametrize("nop", [1, 2])
def test_main_path_plans_unchanged(k, n, bits, rows, nop):
    """Every bf16 shape of the main path (K 2048, 1408 and 2816) keeps the
    whole-K plan field for field, in one chunk: the same instruction order,
    so the same bits."""
    p = dict(tile_plan(k, n, bits, GROUP, torch.bfloat16, rows=rows, operands=nop))
    want = _whole_k_plan(k, n, bits, GROUP, rows, nop)
    assert p.pop("k_chunks") == [(0, want["k_steps"])]
    assert p == want
