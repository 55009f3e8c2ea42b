"""The port's CUDA kernels against their plain PyTorch versions on the card,
and a decode megastep that never waits on the host.

Skips without an NVIDIA GPU: the kernels have no CPU mode. Imports no JAX,
so it also runs on a machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: ``max|kernel − plain| ≤ tol · max|plain|`` with tol 1e-4 for f32
(only the summation order differs) and 2e-2 for bf16 (both round the
weights to bf16 and accumulate in f32; outputs round to bf16).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.quantizers import quantize_parts  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= TOL[dtype] * want.float().abs().max().item()


def _ragged(gen, experts, cap, bm, dev):
    """block_expert with dead trailing blocks repeating the last id, and
    num_active short of the block count."""
    nblocks = experts * cap // bm
    live = int(torch.randint(1, nblocks, (1,), generator=gen))
    be = torch.sort(torch.randint(0, experts, (live,), generator=gen)).values
    be = torch.cat([be, torch.full((nblocks - live,), experts - 1)]).to(torch.int32)
    return be.to(dev), torch.tensor([live], dtype=torch.int32, device=dev), live


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_dequant_gemm_kernels(dev, bits, dtype):
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_swiglu
    from repro_torch.kernels.quant_matmul import quant_matmul

    gen = torch.Generator().manual_seed(bits)
    e, k, n = 3, 256, 96
    w = torch.randn(e, k, n, generator=gen) * k**-0.5
    data, s, z = (t.to(dev) if isinstance(t, torch.Tensor) else tuple(p.to(dev) for p in t)
                  for t in quantize_parts(w, bits, 128, refine=False))
    x = torch.randn(48, k, generator=gen).to(dev, dtype)
    one = tuple(p[0] for p in data) if bits == 3 else data[0]
    _close(quant_matmul(x[:5], one, s[0], z[0], bits=bits),
            ref.quant_matmul_ref(x[:5], one, s[0], z[0], bits=bits), dtype)
    for bm in (8, 16):
        be, na, live = _ragged(gen, e, 16, bm, dev)
        got = moe_gmm(x, data, s, z, be, na, bits=bits, bm=bm)
        _close(got, ref.moe_gmm_ref(x, data, s, z, be, na, bits=bits, bm=bm), dtype)
        assert not got[live * bm:].any()
        args = (x, data, data, s, z, s, z, be, na)
        _close(moe_gmm_swiglu(*args, bits=bits, bm=bm),
               ref.moe_gmm_swiglu_ref(*args, bits=bits, bm=bm), dtype)


def _bitwise(a, b):
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return a.shape == b.shape and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def _weights(gen, e, k, n, bits, dev):
    w = torch.randn(e, k, n, generator=gen) * k**-0.5
    return tuple(t.to(dev) if isinstance(t, torch.Tensor) else tuple(p.to(dev) for p in t)
                 for t in quantize_parts(w, bits, 128, refine=False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_quant_matmul_tiling_edges(dev, bits, dtype):
    """N on and off the 16-column tile (96, 1408, 40, 1400), ragged K, M from
    1 to 24: each call against the plain version, and each row bit for bit
    equal to the same row of the M = 24 call."""
    from repro_torch.kernels.quant_matmul import quant_matmul

    gen = torch.Generator().manual_seed(30 + bits)
    for k, n in ((256, 96), (1408, 1408), (3 * 128 + 64, 40), (200, 1400)):
        data, s, z = _weights(gen, 1, k, n, bits, dev)
        one = tuple(p[0] for p in data) if bits == 3 else data[0]
        x = torch.randn(24, k, generator=gen).to(dev, dtype)
        full = quant_matmul(x, one, s[0], z[0], bits=bits)
        _close(full, ref.quant_matmul_ref(x, one, s[0], z[0], bits=bits), dtype)
        for m in range(1, 25):
            part = quant_matmul(x[:m].contiguous(), one, s[0], z[0], bits=bits)
            assert _bitwise(part, full[:m]), (k, n, m)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_moe_gmm_num_active_edges(dev, bits, dtype):
    """num_active 0, 1 and all blocks, bm 8 and 16, N on and off the column
    tile: against the plain version, dead rows exactly zero, and the live
    rows bit for bit those of the call with every block live."""
    from repro_torch.kernels.moe_gmm import moe_gmm

    gen = torch.Generator().manual_seed(40 + bits)
    for k, n in ((1408, 96), (3 * 128 + 64, 1400)):
        data, s, z = _weights(gen, 3, k, n, bits, dev)
        for bm in (8, 16):
            nblocks = 3 * 32 // bm
            x = torch.randn(3 * 32, k, generator=gen).to(dev, dtype)
            be = torch.sort(torch.randint(0, 3, (nblocks,), generator=gen)).values
            be = be.to(dev, torch.int32)
            all_live = None
            for live in (nblocks, 0, 1):
                na = torch.tensor([live], dtype=torch.int32, device=dev)
                got = moe_gmm(x, data, s, z, be, na, bits=bits, bm=bm)
                _close(got, ref.moe_gmm_ref(x, data, s, z, be, na, bits=bits, bm=bm), dtype)
                assert not got[live * bm:].any()
                if all_live is None:
                    all_live = got
                assert _bitwise(got[:live * bm], all_live[:live * bm])


@pytest.mark.cuda
def test_quant_matmul_rows_anywhere_in_the_tile(dev):
    """A row's bf16 output does not depend on its position inside the MMA's
    n8 tile either: rows 3..6 computed as rows 0..3 of their own call."""
    from repro_torch.kernels.quant_matmul import quant_matmul

    gen = torch.Generator().manual_seed(50)
    data, s, z = _weights(gen, 1, 2048, 2048, 4, dev)
    x = torch.randn(16, 2048, generator=gen).to(dev, torch.bfloat16)
    full = quant_matmul(x, data[0], s[0], z[0], bits=4)
    assert _bitwise(quant_matmul(x[3:7].contiguous(), data[0], s[0], z[0], bits=4), full[3:7])


@pytest.mark.cuda
def test_tile_plan_matches_kernel_smem(dev):
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.quant_matmul import tile_plan

    lib = load_library()
    for k in (64, 200, 1408, 2048, 2816, 5120, 7168, 7232, 8192, 17408):
        for bits in (1, 2, 3, 4):
            for rows in (8, 16):
                for nop in (1, 2):  # one operand, or SwiGLU's gate and up
                    want = tile_plan(k, 2048, bits, 128, torch.bfloat16, rows=rows,
                                     operands=nop)["smem_bytes"]
                    assert lib.repro_dequant_gemm_sm90_smem(k, bits, 128, rows, nop) == want


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_dequant_gemm_split_k(dev, bits):
    """K longer than one item's shared memory holds (kimi-k2's d_model 7168,
    and 7232, whose last chunk ends mid-group): the bf16 body walks K in
    chunks. Each kernel against its plain version at bm 8 and 16; rows bit
    for bit whatever M (quant_matmul) and whatever the other blocks hold
    (moe_gmm, moe_gmm_swiglu)."""
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_swiglu
    from repro_torch.kernels.quant_matmul import quant_matmul, tile_plan

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(60 + bits)
    for k in (7168, 7232):
        data, s, z = _weights(gen, 3, k, 96, bits, dev)
        x = torch.randn(48, k, generator=gen).to(dev, dtype)
        one = tuple(p[0] for p in data) if bits == 3 else data[0]
        full = quant_matmul(x[:24], one, s[0], z[0], bits=bits)
        _close(full, ref.quant_matmul_ref(x[:24], one, s[0], z[0], bits=bits), dtype)
        for m in (1, 5, 8, 16):
            assert _bitwise(quant_matmul(x[:m].contiguous(), one, s[0], z[0], bits=bits),
                            full[:m]), (k, m)
        for bm in (8, 16):
            assert len(tile_plan(k, 96, bits, 128, dtype, rows=bm, operands=2)["k_chunks"]) > 1
            nblocks = 48 // bm
            be = torch.sort(torch.randint(0, 3, (nblocks,), generator=gen)).values
            be = be.to(dev, torch.int32)
            for kind in ("moe_gmm", "moe_gmm_swiglu"):
                if kind == "moe_gmm":
                    call = lambda b_, na: moe_gmm(x, data, s, z, b_, na, bits=bits, bm=bm)
                    plain = lambda b_, na: ref.moe_gmm_ref(x, data, s, z, b_, na, bits=bits,
                                                           bm=bm)
                else:
                    args = (data, data, s, z, s, z)
                    call = lambda b_, na: moe_gmm_swiglu(x, *args, b_, na, bits=bits, bm=bm)
                    plain = lambda b_, na: ref.moe_gmm_swiglu_ref(x, *args, b_, na, bits=bits,
                                                                  bm=bm)
                na = torch.tensor([nblocks], dtype=torch.int32, device=dev)
                base = call(be, na)
                _close(base, plain(be, na), dtype)
                other = be.clone()
                other[2:] = 2 - other[2:]  # other experts in the later blocks, and dead ones
                fewer = torch.tensor([2], dtype=torch.int32, device=dev)
                got = call(other, fewer)
                assert _bitwise(got[:2 * bm], base[:2 * bm]), (k, bm, kind)
                assert not got[2 * bm:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("k,bits", [(8192, 1), (8192, 4), (17408, 3), (17408, 4)])
def test_quant_matmul_split_k_model_widths(dev, k, bits):
    """command-r's d_model (8192) and qwen3-14b's d_ff (17408, a 4-bit down
    projection) through quant_matmul at bf16: against the plain version,
    rows bit for bit whatever M."""
    from repro_torch.kernels.quant_matmul import quant_matmul

    gen = torch.Generator().manual_seed(k + bits)
    data, s, z = _weights(gen, 1, k, 256, bits, dev)
    one = tuple(p[0] for p in data) if bits == 3 else data[0]
    x = torch.randn(16, k, generator=gen).to(dev, torch.bfloat16)
    full = quant_matmul(x, one, s[0], z[0], bits=bits)
    _close(full, ref.quant_matmul_ref(x, one, s[0], z[0], bits=bits), torch.bfloat16)
    for m in (1, 4, 9):
        assert _bitwise(quant_matmul(x[:m].contiguous(), one, s[0], z[0], bits=bits), full[:m])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,window", [(1, None), (2, 17), (4, None), (5, None), (5, 17)])
def test_paged_attention_kernel(dev, dtype, g, window):
    from repro_torch.kernels.paged_attention import paged_attention

    gen = torch.Generator().manual_seed(g)
    q = torch.randn(3, 2, g, 128, generator=gen).to(dev, dtype)
    kp = torch.randn(12, 16, 2, 128, generator=gen).to(dev, dtype)
    vp = torch.randn(12, 16, 2, 128, generator=gen).to(dev, dtype)
    tables = torch.randperm(12, generator=gen)[:9].reshape(3, 3).to(dev, torch.int32)
    lengths = torch.tensor([1, 20, 48], dtype=torch.int32, device=dev)
    _close(paged_attention(q, kp, vp, tables, lengths, window=window),
           ref.paged_attention_ref(q, kp, vp, tables, lengths, window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_dequant_gemm_ragged_k(dev, bits, dtype):
    """K ending mid-group and K < group: the kernels bound their loop on the
    last group, as the reference pads it."""
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_swiglu
    from repro_torch.kernels.quant_matmul import quant_matmul

    gen = torch.Generator().manual_seed(10 + bits)
    for k in (3 * 128 + 64, 64):
        w = torch.randn(3, k, 96, generator=gen) * k**-0.5
        data, s, z = (t.to(dev) if isinstance(t, torch.Tensor) else tuple(p.to(dev) for p in t)
                      for t in quantize_parts(w, bits, 128, refine=False))
        x = torch.randn(48, k, generator=gen).to(dev, dtype)
        one = tuple(p[0] for p in data) if bits == 3 else data[0]
        _close(quant_matmul(x[:5], one, s[0], z[0], bits=bits),
               ref.quant_matmul_ref(x[:5], one, s[0], z[0], bits=bits), dtype)
        be, na, _ = _ragged(gen, 3, 16, 8, dev)
        _close(moe_gmm(x, data, s, z, be, na, bits=bits, bm=8),
               ref.moe_gmm_ref(x, data, s, z, be, na, bits=bits, bm=8), dtype)
        args = (x, data, data, s, z, s, z, be, na)
        _close(moe_gmm_swiglu(*args, bits=bits, bm=8),
               ref.moe_gmm_swiglu_ref(*args, bits=bits, bm=8), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_length_zero(dev, dtype):
    """Every position masked: the kernel averages V over the whole block
    table, as the reference does."""
    from repro_torch.kernels.paged_attention import paged_attention

    gen = torch.Generator().manual_seed(5)
    q = torch.randn(3, 2, 2, 128, generator=gen).to(dev, dtype)
    kp = torch.randn(12, 16, 2, 128, generator=gen).to(dev, dtype)
    vp = torch.randn(12, 16, 2, 128, generator=gen).to(dev, dtype)
    tables = torch.randperm(12, generator=gen)[:9].reshape(3, 3).to(dev, torch.int32)
    lengths = torch.tensor([0, 20, 0], dtype=torch.int32, device=dev)
    _close(paged_attention(q, kp, vp, tables, lengths),
           ref.paged_attention_ref(q, kp, vp, tables, lengths), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,window", [(1, None), (2, 17), (4, None), (5, None), (5, 17)])
def test_paged_attention_quant_kernel(dev, dtype, g, window):
    from repro_torch.core.quantizers import quantize_kv_rows
    from repro_torch.kernels.paged_attention import paged_attention_quant

    gen = torch.Generator().manual_seed(20 + g)
    q = torch.randn(4, 2, g, 128, generator=gen).to(dev, dtype)
    pools = []
    for _ in range(2):
        rows = torch.randn(12, 16, 2, 128, generator=gen) * 2
        rows[0] = 0.0  # an unwritten page
        pools.append(quantize_kv_rows(rows.to(dev)))
    (kc, ks, kz), (vc, vs, vz) = pools
    tables = torch.randperm(12, generator=gen)[:12].reshape(4, 3).to(dev, torch.int32)
    lengths = torch.tensor([1, 20, 48, 0], dtype=torch.int32, device=dev)
    quant = (ks, kz, vs, vz)
    _close(paged_attention_quant(q, kc, vc, *quant, tables, lengths, window=window),
           ref.paged_attention_ref(q, kc, vc, tables, lengths, window=window, quant=quant),
           dtype)


def _attn(gen, dev, kind, dtype, g, dh, lengths, mb, bs=16, hkv=2):
    """A decode-attention problem over permuted physical pages: the kernel's
    wrapper and the plain version as two callables of ``window``."""
    from repro_torch.core.quantizers import quantize_kv_rows
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_quant

    b = len(lengths)
    nb = b * mb + 5
    q = torch.randn(b, hkv, g, dh, generator=gen).to(dev, dtype)
    pools = [torch.randn(nb, bs, hkv, dh, generator=gen).to(dev) for _ in range(2)]
    tables = torch.randperm(nb, generator=gen)[: b * mb].reshape(b, mb).to(dev, torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if kind == "fp":
        kp, vp = (t.to(dtype) for t in pools)
        return (lambda w: paged_attention(q, kp, vp, tables, lens, window=w),
                lambda w: ref.paged_attention_ref(q, kp, vp, tables, lens, window=w))
    (kc, ks, kz), (vc, vs, vz) = (quantize_kv_rows(t * 2) for t in pools)
    quant = (ks, kz, vs, vz)
    return (lambda w: paged_attention_quant(q, kc, vc, *quant, tables, lens, window=w),
            lambda w: ref.paged_attention_ref(q, kc, vc, tables, lens, window=w, quant=quant))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 5, 8])
def test_paged_attention_chunk_edges(dev, kind, dtype, dh, g):
    """Lengths at the edges of the 256-position chunks (page 16), length 0,
    the whole table, and windows whose first valid position falls mid-chunk
    (at 50 the first chunk of the longest sequence is an empty partial)."""
    gen = torch.Generator().manual_seed(dh + g)
    call, plain = _attn(gen, dev, kind, dtype, g, dh, [0, 255, 256, 257, 320], mb=20)
    for window in (None, 50, 100, 7):
        _close(call(window), plain(window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_long_context(dev, kind, dtype):
    """4096 positions (16 chunks merged by the second kernel) and a window
    of 1000 starting mid-chunk."""
    gen = torch.Generator().manual_seed(4096)
    call, plain = _attn(gen, dev, kind, dtype, 2, 128, [4096, 2500], mb=256)
    for window in (None, 1000):
        _close(call(window), plain(window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_paged_attention_batch_invariant(dev, kind):
    """One sequence's output is bit-identical alone, in a batch of 4 with other
    lengths, with a wider block table (more chunks) and on other physical
    pages (one chunk at MB=8 against the merge kernel at MB=28, too)."""
    from repro_torch.core.quantizers import quantize_kv_rows
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_quant

    gen = torch.Generator().manual_seed(77)
    hkv, g, dh, bs, nb = 2, 2, 128, 16, 200
    rows = [torch.randn(nb, bs, hkv, dh, generator=gen).to(dev) for _ in range(2)]
    if kind == "fp":
        pools = tuple(t.to(torch.bfloat16) for t in rows)
        quant = ()
    else:
        (kc, ks, kz), (vc, vs, vz) = (quantize_kv_rows(t * 2) for t in rows)
        pools, quant = (kc, vc), (ks, kz, vs, vz)
    q = torch.randn(4, hkv, g, dh, generator=gen).to(dev, torch.bfloat16)

    def run(qq, tables, lengths, window):
        t = torch.tensor(tables, dtype=torch.int32, device=dev)
        n = torch.tensor(lengths, dtype=torch.int32, device=dev)
        if kind == "fp":
            return paged_attention(qq, *pools, t, n, window=window)
        return paged_attention_quant(qq, *pools, *quant, t, n, window=window)

    def moved(tables):  # the same contents on other physical pages
        perm = torch.randperm(nb, generator=gen)
        for pool in pools + quant:
            pool[perm[: len(tables)].to(dev)] = pool[torch.tensor(tables, device=dev)].clone()
        return perm[: len(tables)].tolist()

    for length, window in ((100, None), (300, None), (300, 150), (1000, 37)):
        mb = -(-length // bs) + 1
        own = torch.randperm(nb, generator=gen)[:mb].tolist()
        alone = run(q[:1], [own], [length], window)[0]
        others = [torch.randperm(nb, generator=gen)[:mb].tolist() for _ in range(3)]
        qb = torch.stack([q[1], q[0], q[2], q[3]])
        batch = run(qb, [others[0], own, others[1], others[2]], [5, length, 700, 0], window)[1]
        wide = run(q[:1], [own + list(range(20))], [length], window)[0]
        elsewhere = run(q[:1].clone(), [moved(own)], [length], window)[0]
        for got in (batch, wide, elsewhere):
            assert _bitwise(got, alone)


@pytest.mark.cuda
def test_attention_plan_matches_kernel_smem(dev):
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import POOL_CODES, attention_plan

    lib = build.load_library()
    for pool, code in POOL_CODES.items():
        for dh in (32, 96, 128, 256):
            for g in (1, 2, 8):
                for bs in (8, 16, 32):
                    want = attention_plan(4, bs, dh, g, pool)["smem_bytes"]
                    assert lib.repro_paged_attention_smem(bs, dh, g, code) == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_binary_matmul_kernel(dev, dtype):
    from repro_torch.core.packing import pack_bits
    from repro_torch.kernels.binary_matmul import binary_matmul

    gen = torch.Generator().manual_seed(3)
    for m, k, n in ((16, 512, 160), (5, 300, 96)):
        w = torch.randn(k, n, generator=gen)
        b = pack_bits(torch.nn.functional.pad((w >= 0).to(torch.uint8), (0, 0, 0, (-k) % 8)),
                      1, axis=0).to(dev)
        alpha = w.abs().mean(dim=0, keepdim=True).to(dev)
        x = torch.randn(m, k, generator=gen).to(dev, dtype)
        _close(binary_matmul(x, b, alpha), ref.binary_matmul_ref(x, b, alpha), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bm", [8, 16])
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_moe_gmm_swiglu_tensor_core_body(dev, bits, bm):
    """bf16 SwiGLU on the tensor-core body: K a whole number of groups,
    ending mid-group, off the k16 step and below one group, N on and off the
    column tile, against the plain version; dead rows exactly zero; a live
    block's rows bit for bit the same as num_active and the other blocks'
    experts change; num_active 0 all zero."""
    from repro_torch.kernels.moe_gmm import moe_gmm_swiglu

    gen = torch.Generator().manual_seed(60 + 2 * bits + bm)
    experts, cap = 4, 32
    nblocks = experts * cap // bm
    for k, n in ((256, 96), (3 * 128 + 64, 1400), (200, 40), (64, 96)):
        g, gs, gz = _weights(gen, experts, k, n, bits, dev)
        u, us, uz = _weights(gen, experts, k, n, bits, dev)
        x = torch.randn(experts * cap, k, generator=gen).to(dev, torch.bfloat16)
        be = torch.sort(torch.randint(0, experts, (nblocks,), generator=gen)).values
        be = be.to(dev, torch.int32)

        def run(be_, live):
            na = torch.tensor([live], dtype=torch.int32, device=dev)
            args = (x, g, u, gs, gz, us, uz, be_, na)
            got = moe_gmm_swiglu(*args, bits=bits, bm=bm)
            _close(got, ref.moe_gmm_swiglu_ref(*args, bits=bits, bm=bm), torch.bfloat16)
            assert not got[live * bm:].any()
            return got

        live = nblocks // 2
        base = run(be, live)
        other = be.clone()
        other[0] = (other[0] + 1) % experts
        other[live:] = experts - 1 - other[live:]
        for y, upto in ((run(be, nblocks), live), (run(be, live - 1), live - 1),
                        (run(other, live), live)):
            assert _bitwise(y[bm:upto * bm], base[bm:upto * bm]), (k, n)
        assert not run(be, 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_binary_matmul_rows_and_edges(dev, dtype):
    """M in 1/5/16/24/64, K off the byte and off the k16 step, N off the
    16-column tile: against the plain version, and each row bit for bit the
    same row of the M = 64 call."""
    from repro_torch.core.packing import pack_bits, pad_to_multiple
    from repro_torch.kernels.binary_matmul import binary_matmul

    gen = torch.Generator().manual_seed(70)
    for k, n in ((2048, 1408), (451, 1400), (200, 40), (8, 16)):
        w = torch.randn(k, n, generator=gen)
        b = pack_bits(pad_to_multiple((w >= 0).to(torch.uint8), 8, axis=0), 1, axis=0).to(dev)
        alpha = w.abs().mean(dim=0, keepdim=True).to(dev)
        x = torch.randn(64, k, generator=gen).to(dev, dtype)
        full = binary_matmul(x, b, alpha)
        _close(full, ref.binary_matmul_ref(x, b, alpha), dtype)
        for m in (1, 5, 16, 24, 64):
            part = binary_matmul(x[:m].contiguous(), b, alpha)
            _close(part, ref.binary_matmul_ref(x[:m], b, alpha), dtype)
            assert _bitwise(part, full[:m]), (k, n, m)


@pytest.mark.cuda
def test_binary_plan_matches_kernel_smem(dev):
    from repro_torch.kernels.binary_matmul import binary_plan
    from repro_torch.kernels.build import load_library

    lib = load_library()
    for k in (8, 200, 451, 1408, 2048, 2816):
        assert lib.repro_binary_matmul_smem(k) == binary_plan(k, 1408)["smem_bytes"]


@pytest.mark.cuda
def test_int8_decode_horizon_never_syncs(dev):
    """The int8-KV megastep (row quantization, table writes, the int8
    attention kernel) keeps the host out of the loop too."""
    _sync_free_horizon(dev, kv_bits=8)


@pytest.mark.cuda
def test_decode_horizon_never_syncs(dev):
    """A decode megastep of the reduced model keeps the host out of the loop:
    under ``set_sync_debug_mode("error")`` anything inside the horizon that
    waits on the device (an ``.item()``, a ``bincount``, a blocking copy)
    raises."""
    _sync_free_horizon(dev, kv_bits=None)


def _sync_free_horizon(dev, kv_bits):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.synthetic import build_synthetic
    from repro_torch.models.transformer import paged_decode_horizon
    from repro_torch.serving.kvcache import PagedKVCache

    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts))
    params = build_synthetic(cfg, seed=0, device=dev)
    cache = PagedKVCache(cfg, num_blocks=8, block_size=16, max_slots=2, max_blocks_per_slot=4,
                         device=dev, kv_bits=kv_bits)
    cache.acquire_slot(40)
    cache.acquire_slot(30)
    i32 = dict(dtype=torch.int32, device=dev)
    args = (params, cache.k, cache.v, cache.tables_device(),
            torch.tensor([[3], [5]], device=dev), torch.tensor([20, 7], **i32),
            torch.ones(2, dtype=torch.bool, device=dev), cfg)
    kw = dict(block_size=16, horizon=4, budgets=torch.tensor([4, 2], **i32),
              eos_ids=torch.full((2,), -1, **i32), qs=cache.quant_tables)
    paged_decode_horizon(*args, **kw)  # builds the kernels, warms the libraries
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, emits, _, _ = paged_decode_horizon(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert emits.sum(dim=0).tolist() == [4, 2]


# ------------------------------------------------------- control plane
@functools.lru_cache(maxsize=None)
def _reduced_pmq():
    """The reduced PMQ + OTP model's config and CPU params (built once)."""
    from repro_torch.configs import get_config
    from repro_torch.core.synthetic import build_synthetic
    from repro_torch.launch import workload

    cfg = get_config(workload.ARCH).reduced()
    return cfg, build_synthetic(cfg, seed=0, device="cpu")


def _control_plane_run(eng, drive):
    drive(eng)
    return (eng.results, {rid: type(e).__name__ for rid, e in sorted(eng.errors.items())},
            eng.metrics.counters(), eng.tracer.deterministic_jsonl())


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fair", "fcfs", "priority"])
def test_tenant_mix_card_matches_cpu(dev, policy):
    """The tenant mix through the control plane on the reduced model (f32):
    the card gives the CPU's tokens, typed errors, counters and
    deterministic trace bit for bit; under ``fair`` with the workload's
    fault plan the schedule counters are ``TENANT_MIX_COUNTERS``."""
    import dataclasses

    from repro_torch.core.tree import to_device
    from repro_torch.launch import workload
    from repro_torch.serving import PagedServingEngine

    cfg, params = _reduced_pmq()
    ecfg = dataclasses.replace(workload.TENANT_MIX, policy=policy)
    runs = []
    for device, p in (("cpu", params), (dev, to_device(params, dev))):
        faults = workload.tenant_mix_faults() if policy == "fair" else None
        eng = PagedServingEngine(cfg, p, ecfg, faults, device=device)
        runs.append(_control_plane_run(
            eng, lambda e: workload.serve_tenant_mix(e, workload.tenant_mix_requests(cfg))))
    assert runs[1] == runs[0]
    if policy == "fair":
        counters = runs[1][2]
        assert {k: counters[k] for k in workload.TENANT_MIX_COUNTERS} == \
            workload.TENANT_MIX_COUNTERS


@pytest.mark.cuda
def test_cancel_and_deadline_card_matches_cpu(dev):
    """Cancellation between prefill chunks with the prefix cache on, and a
    queued request's deadline, on the card as on the CPU: the same tokens,
    typed errors, counters and trace, and a pool drained clean."""
    import numpy as np

    from repro_torch.core.tree import to_device
    from repro_torch.serving import EngineConfig, PagedServingEngine, Request

    cfg, params = _reduced_pmq()
    rng = np.random.default_rng(5)
    system = rng.integers(0, cfg.vocab_size, size=32)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, size=n)]).astype(np.int32)
               for n in (10, 5, 7, 3)]
    ecfg = EngineConfig(max_slots=2, block_size=16, num_blocks=12, max_blocks_per_slot=4,
                        prefill_chunk=16, decode_horizon=4, prefix_cache=True,
                        trace_level="spans")

    def drive(eng):
        complete = eng.tracer.complete

        def hooked(name, **kw):  # cancel request 1 after its first chunk
            complete(name, **kw)
            if name == "prefill_chunk" and (kw.get("args") or {}).get("rid") == 1:
                eng.cancel(1)

        eng.tracer.complete = hooked
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=8,
                               deadline_steps=3 if i == 3 else None))
        while eng.scheduler.has_work():
            eng.step()
            eng.cache.check_consistency()
        assert eng.cache.slot_blocks == {}

    runs = [_control_plane_run(PagedServingEngine(cfg, p, ecfg, device=d), drive)
            for d, p in (("cpu", params), (dev, to_device(params, dev)))]
    assert runs[1] == runs[0]
    assert runs[1][1] == {1: "RequestCancelled", 3: "DeadlineExceeded"}
