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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hkv", [(2, 16), (8, 8)])
def test_paged_attention_served_shapes(dev, kind, dtype, g, hkv):
    """gemma3-27b's G = 2 over 16 KV heads at lengths 1088-1120 under its
    local window of 1024, a global layer's window (the table + 1) and none;
    kimi-k2-1t-a32b's G = 8 at the same lengths."""
    gen = torch.Generator().manual_seed(1088 + g)
    call, plain = _attn(gen, dev, kind, dtype, g, 128, [1088, 1097, 1104, 1120], mb=70,
                        hkv=hkv)
    for window in (1024, 70 * 16 + 1, None):
        _close(call(window), plain(window), dtype)


@pytest.mark.cuda
def test_sliced_expert_build_is_bytewise(dev, monkeypatch):
    """Buckets quantized on the card in slices of 5 experts (the last
    ragged) equal the one-shot build byte for byte."""
    from repro_torch.core import compressed_moe as cm

    gen = torch.Generator(device=dev).manual_seed(0)
    e, d, f = 24, 512, 384
    experts = {"w_gate": torch.randn(e, d, f, generator=gen, device=dev).to(torch.bfloat16),
               "w_up": torch.randn(e, d, f, generator=gen, device=dev).to(torch.bfloat16),
               "w_down": torch.randn(e, f, d, generator=gen, device=dev).to(torch.bfloat16)}
    bits = [1, 3, 2, 2] * 6
    makers = {k: (lambda w=w: w) for k, w in experts.items()}
    whole = cm.build_compressed_experts(makers, bits)
    monkeypatch.setattr(cm, "SLICE_ELEMENTS", 5 * d * f)
    sliced = cm.build_compressed_experts(makers, bits)
    assert sliced.meta == whole.meta and torch.equal(sliced.slot_of_expert, whole.slot_of_expert)
    for b, bucket in whole.arrays.items():
        for name, leaves in bucket.items():
            for key, t in leaves.items():
                got = sliced.arrays[b][name][key]
                assert got.shape == t.shape and torch.equal(got.view(torch.uint8),
                                                            t.view(torch.uint8))


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
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_decode_horizon_never_syncs(dev, temperature):
    """A decode megastep of the reduced model keeps the host out of the loop,
    with one slot writing into a page it grew at the boundary: under
    ``set_sync_debug_mode("error")`` anything inside the horizon that waits
    on the device (an ``.item()``, a ``bincount``, a blocking copy) raises.
    Sampled (``temperature > 0``), the megastep's generator is made and
    seeded inside the checked region, as the engine makes one per run."""
    _sync_free_horizon(dev, kv_bits=None, temperature=temperature)


@pytest.mark.cuda
def test_gumbel_max_draws_follow_the_softmax_on_the_card(dev):
    """The draws as a sampled megastep makes them on the card: one CUDA
    generator per megastep (400 of them), ``H = 8`` steps of 8 rows each
    from it. The pooled draws follow ``softmax(lg / T)`` (chi-square, as
    ``tests/test_torch_sampling.py`` holds the CPU's), and a row's draw at
    step ``s + 1`` is independent of its draw at step ``s`` (a generator
    offset reused or skipped across steps would repeat them)."""
    import numpy as np
    from scipy import stats

    from repro_torch.models.transformer import sample_gumbel

    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.25], device=dev)
    t, megasteps, horizon, rows = 0.8, 400, 8, 8
    steps = []
    for m in range(megasteps):
        gen = torch.Generator(device=dev).manual_seed(m)
        steps.append(torch.stack([sample_gumbel(logits.expand(rows, 8), t, gen)
                                  for _ in range(horizon)]))
    draws = torch.stack(steps).cpu().numpy()  # [megasteps, horizon, rows]
    observed = np.bincount(draws.reshape(-1), minlength=8)
    expected = torch.softmax(logits.double().cpu() / t, dim=-1).numpy() * draws.size
    p = stats.chisquare(observed, expected).pvalue
    assert p > 1e-3, (observed, expected, p)
    pairs = np.zeros((8, 8))
    np.add.at(pairs, (draws[:, :-1].reshape(-1), draws[:, 1:].reshape(-1)), 1)
    p_pairs = stats.chi2_contingency(pairs).pvalue
    assert p_pairs > 1e-3, (pairs, p_pairs)


def _sync_free_horizon(dev, kv_bits, temperature=0.0):
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
    cache.acquire_slot(16)
    cache.grow(1, 1)  # slot 1's second write lands on the grown page
    i32 = dict(dtype=torch.int32, device=dev)
    args = (params, cache.k, cache.v, cache.tables_device(),
            torch.tensor([[3], [5]], device=dev), torch.tensor([20, 15], **i32),
            torch.ones(2, dtype=torch.bool, device=dev), cfg)
    kw = dict(block_size=16, horizon=4, budgets=torch.tensor([4, 2], **i32),
              eos_ids=torch.full((2,), -1, **i32), qs=cache.quant_tables)
    if temperature > 0:
        kw["temperature"] = temperature
    paged_decode_horizon(*args, **kw, generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()  # the first call built the kernels and warmed the libraries
    torch.cuda.set_sync_debug_mode("error")
    try:
        gen = torch.Generator(device=dev).manual_seed(7)
        _, emits, _, _ = paged_decode_horizon(*args, **kw, generator=gen)
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
                        reserve_full=True, trace_level="spans")

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


# ------------------------------------------------------ growth and swap
@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_swap_round_trip_is_bitwise(dev, kind):
    """A 5-page slot of a bf16 or int8 pool at moonshot-v1-16b-a3b's widths
    (16 KV heads of 128) goes to the host and back into other physical
    pages: every row (codes and scale/zero rows too) returns bit for bit,
    and ``paged_attention[_quant]`` over the restored table equals the call
    over the original table bitwise in every layer. The write-back runs
    under ``torch.use_deterministic_algorithms(True)``."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.quantizers import quantize_kv_rows
    from repro_torch.kernels import ops
    from repro_torch.serving.kvcache import PagedKVCache

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), num_layers=2)
    nb, bs, length = 16, 16, 70
    hkv, dh, g = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    cache = PagedKVCache(cfg, num_blocks=nb, block_size=bs, max_slots=3, max_blocks_per_slot=6,
                         device=dev, kv_bits=8 if kind == "int8" else None)
    gen = torch.Generator().manual_seed(5)
    for name in ("k", "v"):
        rows = torch.randn(tuple(cache.k.shape), generator=gen).to(dev)
        pool = getattr(cache, name)
        if kind == "int8":
            codes, scale, zero = quantize_kv_rows(rows)
            pool.copy_(codes)
            cache.quant[f"{name}_scale"].copy_(scale)
            cache.quant[f"{name}_zero"].copy_(zero)
        else:
            pool.copy_(rows.to(pool.dtype))
    q = torch.randn(1, hkv, g, dh, generator=gen).to(dev, torch.bfloat16)

    def attend(slot):
        table = torch.as_tensor(cache.block_tables[slot:slot + 1], device=dev)
        n = torch.tensor([length], dtype=torch.int32, device=dev)
        return [ops.paged_attention(
            q, cache.k[l, :nb * bs].view(nb, bs, hkv, dh), cache.v[l, :nb * bs].view(nb, bs, hkv, dh),
            table, n, quant=(tuple(t[l, :nb * bs].view(nb, bs, hkv) for t in cache.quant_tables)
                             if cache.quant is not None else None))
            for l in range(cfg.num_layers)]

    def rows_of(slot):
        idx = torch.as_tensor(np.concatenate([np.arange(b * bs, (b + 1) * bs)
                                              for b in cache.slot_blocks[slot]]), device=dev)
        return [t[:, idx].contiguous().view(torch.uint8)
                for t in (cache.k, cache.v, *cache.quant_tables)]

    slot = cache.acquire_slot(length)
    pages = set(cache.slot_blocks[slot])
    before, rows_before = attend(slot), rows_of(slot)
    swapped = cache.swap_out(slot, length)
    assert swapped.n_pages == 5 and swapped.k.device.type == "cpu"
    assert swapped.payload_checksum() == swapped.checksum
    cache.acquire_slot(length)  # takes the freed pages: the restore lands elsewhere
    slot = cache.acquire_slot(length)
    assert pages.isdisjoint(cache.slot_blocks[slot])
    torch.use_deterministic_algorithms(True)  # the write-back is legal there: no atomics
    try:
        assert cache.swap_in(slot, swapped) == swapped.nbytes
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(rows_of(slot), rows_before))
    assert all(_bitwise(a, b) for a, b in zip(attend(slot), before))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kv_bits", [("swap", None), ("recompute", None), ("swap", 8)])
def test_preemption_card_matches_cpu(dev, mode, kv_bits):
    """The fp workload's requests on ``PREEMPT``'s 11-page pool with page
    growth, on the reduced PMQ model (f32), at trace level ``full``: the card
    gives the CPU's tokens, counters and deterministic trace bit for bit,
    and in swap mode with fp KV the schedule is ``PREEMPT_COUNTERS``."""
    import dataclasses

    from repro_torch.core.tree import to_device
    from repro_torch.launch import workload
    from repro_torch.serving import PagedServingEngine

    cfg, params = _reduced_pmq()
    ecfg = dataclasses.replace(workload.PREEMPT, preempt_mode=mode, kv_bits=kv_bits,
                               trace_level="full")
    runs = []
    for device, p in (("cpu", params), (dev, to_device(params, dev))):
        eng = PagedServingEngine(cfg, p, ecfg, device=device)
        runs.append(_control_plane_run(eng, lambda e: e.serve(workload.requests(cfg))))
    assert runs[1] == runs[0]
    counters = runs[1][2]
    assert [pre["rid"] for pre in counters["preemptions"]] == [workload.PREEMPT_VICTIM]
    assert (counters["swap_in_bytes"] > 0) == (mode == "swap")
    if (mode, kv_bits) == ("swap", None):
        assert workload.preempt_schedule(counters) == workload.PREEMPT_COUNTERS


@pytest.mark.cuda
@pytest.mark.parametrize("widths", ["reduced", "full"])
def test_reprefilled_kv_rows_against_decode_written(dev, widths):
    """What a recompute-mode resume rewrites, at bf16 on a PMQ model of 4
    layers, at reduced widths or at moonshot-v1-16b-a3b's
    (``tests/_torch_resume.py``): a 64-token prompt prefilled, 16 tokens
    decoded by one megastep (rows 64-79 written after ``paged_attention``),
    then the 80-token context re-prefilled into other pages as the engine's
    resume does, its decode-era rows through the same kernel. Every row
    comes back bit for bit, over one decode slot and over ``PREEMPT``'s 4,
    at the model's capacity factor. Prints, for the first layer, how far
    apart each op's outputs are at the decode's shape and at the chunk's
    (the attention: the kernel against the prefill's sweep) and the
    decode-era pairs the chunk's dispatch drops."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.synthetic import build_synthetic

    from _torch_resume import compare, op_deltas, reprefilled_rows

    cfg = get_config("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(cfg.reduced() if widths == "reduced" else cfg, dtype="bfloat16",
                              num_layers=4)
    params = build_synthetic(cfg, seed=0, device=dev)
    for slots in (1, 4):
        decoded, again, context = reprefilled_rows(params, cfg, dev, slots=slots)
        deltas, scales = compare(decoded, again, 64)
        print(f"re-prefilled rows 64-79 ({widths} widths, {slots} slots), max|Δ| per layer:",
              deltas, "of max|row|", scales)
        print(f"first layer's ops, decode shape against chunk shape ({widths}, {slots} slots):",
              op_deltas(params, cfg, dev, decoded, context, slots=slots))
        assert all(torch.isfinite(t.float()).all() for t in again)
        assert all(torch.equal(a, b) for a, b in zip(decoded, again)), (slots, deltas)


# ------------------------------------------------------- expert offload
def _rows(packed, scale, zero, idx, bits):
    """The experts ``idx`` of a packed bucket, as a new contiguous buffer."""
    pick = (lambda t: t.index_select(0, idx).contiguous())
    data = tuple(pick(p) for p in packed) if bits == 3 else pick(packed)
    return data, pick(scale), pick(zero)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 2, 3])
def test_moe_gmm_over_resident_rows_is_bitwise(dev, bits, dtype):
    """``moe_gmm`` and ``moe_gmm_swiglu`` over an ``[R]`` resident buffer —
    the live blocks' experts at permuted rows, the other slots mapped to row
    0 — with ``block_expert`` indirected through the resident map give the
    ``[count]`` call's rows bit for bit, dead blocks (exactly zero) included."""
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_swiglu

    gen = torch.Generator().manual_seed(70 + bits)
    count, cap, bm, d, f = 6, 32, 16, 256, 192
    for _ in range(3):
        be, na, live = _ragged(gen, count, cap, bm, dev)
        used = sorted(set(be[:live].tolist()))
        filler = [e for e in range(count) if e not in used][:1]
        order = torch.randperm(len(used) + len(filler), generator=gen)
        experts = [(used + filler)[int(i)] for i in order]  # row r holds expert experts[r]
        rmap = torch.zeros(count, dtype=torch.int32)
        for r, e in enumerate(experts):
            rmap[e] = r
        idx = torch.tensor(experts, device=dev)
        be_res = rmap.to(dev)[be.long()].to(torch.int32)
        gate, up, down = (_weights(gen, count, *kn, bits, dev) for kn in ((d, f), (d, f), (f, d)))
        x = torch.randn(count * cap, d, generator=gen).to(dev, dtype)
        h = moe_gmm_swiglu(x, gate[0], up[0], gate[1], gate[2], up[1], up[2], be, na, bits=bits,
                           bm=bm)
        y = moe_gmm(h, *down, be, na, bits=bits, bm=bm)
        g_r, u_r, d_r = (_rows(*w, idx, bits) for w in (gate, up, down))
        h_r = moe_gmm_swiglu(x, g_r[0], u_r[0], g_r[1], g_r[2], u_r[1], u_r[2], be_res, na,
                             bits=bits, bm=bm)
        y_r = moe_gmm(h_r, *d_r, be_res, na, bits=bits, bm=bm)
        assert _bitwise(h_r, h) and _bitwise(y_r, y)
        assert not y_r[live * bm:].any()


def _offload_serve(cfg, params, ecfg, device):
    import numpy as np

    from repro_torch.serving import PagedServingEngine, Request

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (20, 33, 7)]
    eng = PagedServingEngine(cfg, params, ecfg, device=device)
    eng.serve(Request(rid=i, prompt=p, max_new=12) for i, p in enumerate(prompts))
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("async_offload", [False, True])
@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("budget", [2, 3])
def test_offload_card_matches_cpu(dev, budget, horizon, async_offload):
    """The reduced PMQ model (f32) with its experts host-offloaded (budget 2
    clamps to 3 rows, one per bucket): the card gives the CPU's tokens and
    counters, and the tokens of the all-resident engine."""
    import dataclasses
    import warnings

    from repro_torch.core.tree import to_device
    from repro_torch.serving import EngineConfig

    cfg, params = _reduced_pmq()
    base = EngineConfig(max_slots=2, block_size=16, num_blocks=16, max_blocks_per_slot=4,
                        prefill_chunk=16, decode_horizon=horizon, reserve_full=True)
    ecfg = dataclasses.replace(base, resident_experts=budget, async_offload=async_offload)
    runs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the budget-2 clamp
        for device, p in (("cpu", params), (dev, to_device(params, dev))):
            eng = _offload_serve(cfg, p, ecfg, device)
            runs.append((eng.results, eng.metrics.counters()))
    assert runs[1] == runs[0]
    assert runs[1][0] == _offload_serve(cfg, to_device(params, dev), base, dev).results
    assert runs[1][1]["expert_miss_uploads"] > 0


@pytest.mark.cuda
def test_issue_async_never_syncs_and_stale_drop_is_harmless(dev):
    """``issue_async`` stages on the side stream without waiting on the device
    or reading from it (``set_sync_debug_mode("error")`` would raise); a batch
    dropped as stale after a miss upload leaves the layer's output the
    all-resident one, and a committed batch's rows are the host rows."""
    import numpy as np

    from repro_torch.core.compressed_moe import compressed_expert_ffn
    from repro_torch.core.tree import to_device
    from repro_torch.serving import ExpertOffloadManager

    cfg, params = _reduced_pmq()
    ces = [to_device(p["moe_ce"], dev) for p in params["layers"]]
    for stale in (True, False):
        mgr = ExpertOffloadManager(ces, resident_slots=4, ema_decay=0.5)
        counts = np.zeros((cfg.num_layers, mgr.num_slots), np.int64)
        counts[:, mgr.meta[1].start + 3] = 5  # a cold slot of the big bucket turns hot
        mgr.update_stats(counts)
        targets = mgr.residency_targets()
        assert targets
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ups, nbytes = mgr.issue_async(targets)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert ups >= 1 and nbytes > 0
        if stale:
            miss = np.zeros((cfg.num_layers, mgr.num_slots), np.int64)
            miss[0, mgr.meta[1].start + 5] = 1
            assert mgr.ensure_resident(miss)[0] >= 1
            assert mgr.commit_async()[:2] == (0, ups)
        else:
            assert mgr.commit_async()[:2] == (ups, 0)
        gen = torch.Generator().manual_seed(3)
        cap = 16
        fill = torch.zeros(mgr.num_slots, dtype=torch.long)
        for l, ce in enumerate(ces):
            for i, bk in enumerate(mgr.slot_row):
                res = np.nonzero(mgr.slot_row[bk][l] >= 0)[0] + mgr.meta[i].start
                fill[res] = torch.randint(1, cap + 1, (len(res),), generator=gen)
            xp = torch.randn(mgr.num_slots * cap, cfg.d_model, generator=gen).to(dev)
            want = compressed_expert_ffn(ce, xp, cap, fill.to(dev))
            got = compressed_expert_ffn(mgr.ces[l], xp, cap, fill.to(dev))
            assert _bitwise(got, want), (stale, l)
            fill.zero_()


# ------------------------------------------------------ compression pipeline
@pytest.mark.cuda
def test_pipeline_card_matches_cpu(dev):
    """The reduced moonshot-v1-16b-a3b (f32, seed 0) compressed by the port's
    pipeline on the card and on the CPU (``workload.tiny_pipeline``): the
    same PMQ plan, packed codes equal on at least 99.9 % of their bytes (the
    HQQ zero mean and the range reductions may round differently on the
    card), and each tree's greedy tokens equal."""
    from repro_torch.launch import workload

    _, plan_g, avg_g, codes_g, out_g, _ = workload.tiny_pipeline(dev)
    _, plan_c, avg_c, codes_c, out_c, _ = workload.tiny_pipeline("cpu")
    assert [b.tolist() for b in plan_g.bits] == [b.tolist() for b in plan_c.bits]
    assert avg_g == avg_c == 2.125
    differ = int((codes_g != codes_c).sum())
    print(f"packed code bytes differing card vs cpu: {differ} of {codes_c.numel()}")
    assert differ <= 1e-3 * codes_c.numel()
    assert out_g == out_c


# ------------------------------------------------- gradients for training
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_gemm_x_gradients_match_plain(dev, bits, dtype):
    """``ops``' three dequant GEMMs under autograd (kernel forward, plain
    backward for ``x``) against autograd through their plain versions on
    the same card tensors; dead row blocks get exactly zero gradient."""
    from repro_torch.kernels import build, ops

    gen = torch.Generator().manual_seed(10 + bits)
    e, k, n, bm, cap = 4, 256, 96, 8, 16
    parts = [tuple(t.to(dev) if isinstance(t, torch.Tensor) else tuple(p.to(dev) for p in t)
                   for t in quantize_parts(torch.randn(e, k, n, generator=gen) * k**-0.5,
                                           bits, 128, refine=False)) for _ in range(2)]
    (wg, gs, gz), (wu, us, uz) = parts
    be, na, live = _ragged(gen, e, cap, bm, dev)
    x = (torch.randn(e * cap, k, generator=gen)).to(dev, dtype).requires_grad_()
    gy = torch.randn(e * cap, n, generator=gen).to(dev, dtype)
    xr = x.detach().clone().requires_grad_()
    cases = [
        (lambda a: ops.moe_gmm(a, wg, gs, gz, be, na, bits=bits, bm=bm),
         lambda a: ref.moe_gmm_ref(a, wg, gs, gz, be, na, bits=bits, bm=bm)),
        (lambda a: ops.moe_gmm_swiglu(a, wg, wu, gs, gz, us, uz, be, na, bits=bits, bm=bm),
         lambda a: ref.moe_gmm_swiglu_ref(a, wg, wu, gs, gz, us, uz, be, na, bits=bits,
                                          bm=bm)),
    ]
    w0 = tuple(p[0] for p in wg) if bits == 3 else wg[0]
    cases.append((lambda a: ops.quant_matmul_parts(a, w0, gs[0], gz[0], bits=bits),
                  lambda a: ref.quant_matmul_ref(a, w0, gs[0], gz[0], bits=bits)))
    for fn, plain in cases:
        build.reset_launches()
        (got,) = torch.autograd.grad(fn(x), x, gy)
        assert sum(build.LAUNCHES.values()) == 1  # the forward kernel; the backward is plain
        (want,) = torch.autograd.grad(plain(xr), xr, gy)
        _close(got, want, dtype)
    (got,) = torch.autograd.grad(cases[0][0](x), x, gy)
    assert not got[live * bm:].any()


@pytest.mark.cuda
def test_ffn_backend_ref_runs_the_plain_versions_on_the_card(dev):
    """``ffn_backend="ref"`` on CUDA tensors runs the plain grouped GEMMs
    (no grouped kernel launches) and agrees with ``grouped``; ``scan`` is
    accepted and ``interpret`` refused."""
    from repro_torch.configs import get_config
    from repro_torch.core.compressed_moe import compressed_moe_layer
    from repro_torch.core.synthetic import build_synthetic
    from repro_torch.kernels import build

    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    params = build_synthetic(cfg, seed=0, device=dev)
    p = params["layers"][0]
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(0)).to(dev)
    out = {}
    for backend in ("grouped", "ref"):
        build.reset_launches()
        out[backend], _ = compressed_moe_layer(p["moe"], p["moe_ce"], x, cfg,
                                               otp_params=p.get("otp"), ffn_backend=backend)
        gmm = build.LAUNCHES["moe_gmm"] + build.LAUNCHES["moe_gmm_swiglu"]
        assert (gmm > 0) == (backend == "grouped")
    _close(out["grouped"], out["ref"], torch.float32)
    compressed_moe_layer(p["moe"], p["moe_ce"], x, cfg, ffn_backend="scan")
    with pytest.raises(ValueError, match="interpret.*not ported"):
        compressed_moe_layer(p["moe"], p["moe_ce"], x, cfg, ffn_backend="interpret")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_backend_scan_launches_quant_matmul_on_the_card(dev, dtype):
    """``ffn_backend="scan"`` on the card: three ``quant_matmul`` launches
    per expert slot (gate, up, down) and no grouped GEMM; the layer agrees
    with ``grouped``."""
    from repro_torch.configs import get_config
    from repro_torch.core.compressed_moe import compressed_moe_layer
    from repro_torch.core.synthetic import build_synthetic
    from repro_torch.kernels import build

    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    params = build_synthetic(cfg, seed=0, device=dev)
    p = params["layers"][0]
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    out = {}
    for backend in ("grouped", "scan"):
        build.reset_launches()
        out[backend], _ = compressed_moe_layer(p["moe"], p["moe_ce"], x, cfg,
                                               otp_params=p.get("otp"), ffn_backend=backend)
        launches = dict(build.LAUNCHES)
    assert launches["moe_gmm"] == launches["moe_gmm_swiglu"] == 0
    # three per slot, plus the shared experts' three 4-bit linears
    assert launches["quant_matmul"] == 3 * p["moe_ce"].num_slots + 3
    _close(out["scan"], out["grouped"], dtype)
