"""The port's int8-KV quantizer, its int8 attention and 1-bit matmul plain
versions, and the ragged-K dequant path, against the JAX reference.

Same numpy inputs through ``repro`` and ``repro_torch`` on the CPU: KV-row
codes, scales and zeros byte for byte; the plain kernel versions against
the reference's Pallas kernels in interpret mode and its ``ref`` oracles
within rtol = atol = 1e-5 in f32 (only the summation order differs) and
2e-2 in bf16 (outputs round to bf16). The CUDA kernels are held against
these plain versions on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.core import quantizers as jquant  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.binary_matmul import binary_matmul_pallas  # noqa: E402
from repro.kernels.paged_attention import paged_attention_quant_pallas  # noqa: E402

from repro_torch.core import quantizers as tquant  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

from _torch_interop import torch_one_thread  # noqa: E402,F401


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _kv_rows(rng, shape, dtype):
    """Random KV rows with an all-zero row (an unwritten page), in ``dtype``
    on both sides from the same bits."""
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[1, 0] = 0.0
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)).copy())
    return xj, xt.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_kv_rows_byte_identical(dtype):
    """Codes, scale and zero byte-identical (bf16 rows compute the range,
    scale and zero in bf16 before the f32 cast, as the reference does), and
    the dequantized rows bit-identical."""
    xj, xt = _kv_rows(np.random.default_rng(0), (6, 4, 32), dtype)
    cj, sj, zj = jquant.quantize_kv_rows(xj)
    ct, st, zt = tquant.quantize_kv_rows(xt)
    assert ct.dtype == torch.uint8 and st.dtype == zt.dtype == torch.float32
    for got, want in ((ct, cj), (st, sj), (zt, zj)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert not ct[1, 0].any() and float(zt[1, 0]) == 0.0 and float(st[1, 0]) > 0.0
    back = tquant.dequantize_kv_rows(ct, st, zt)
    assert np.array_equal(back.numpy(), np.asarray(jquant.dequantize_kv_rows(cj, sj, zj)))
    assert not back[1, 0].any()


def _quant_pools(rng, b, hkv, g, dh, nb, bs, mb):
    """Random q and int8 pools quantized by the reference, permuted tables."""
    q = rng.standard_normal((b, hkv, g, dh)).astype(np.float32)
    pools = []
    for _ in range(2):
        rows = (rng.standard_normal((nb, bs, hkv, dh)) * 2).astype(np.float32)
        rows[0] = 0.0  # an unwritten page
        c, s, z = jquant.quantize_kv_rows(jnp.asarray(rows))
        pools.append((np.asarray(c), np.asarray(s), np.asarray(z)))
    (kc, ks, kz), (vc, vs, vz) = pools
    tables = rng.permutation(nb)[: b * mb].reshape(b, mb).astype(np.int32)
    return q, kc, vc, (ks, kz, vs, vz), tables


@pytest.mark.parametrize("g,window,lengths", [
    (1, None, (1, 6, 12)),
    (2, None, (0, 5, 9)),
    (2, 5, (3, 12, 0)),
    (1, 9, (12, 1, 7)),
])
def test_paged_attention_quant_ref(g, window, lengths):
    """The port's quant-mode plain version against the reference's Pallas
    kernel (interpret mode) and its oracle: ragged lengths, windows, G = 1/2,
    length 0 (every position masked: both average V over the table)."""
    rng = np.random.default_rng(50 + g + (window or 0))
    b, hkv, dh, nb, bs, mb = 3, 2, 16, 12, 4, 3
    q, kc, vc, quant, tables = _quant_pools(rng, b, hkv, g, dh, nb, bs, mb)
    lens = np.asarray(lengths, np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc))
    win = np.array([mb * bs + 1 if window is None else window], np.int32)
    want_k = paged_attention_quant_pallas(*jargs, *(jnp.asarray(a) for a in quant),
                                          jnp.asarray(tables), jnp.asarray(lens),
                                          jnp.asarray(win), interpret=True)
    want_o = jref.paged_attention_ref(*jargs, jnp.asarray(tables), jnp.asarray(lens),
                                      window=window, quant=tuple(jnp.asarray(a) for a in quant))
    t = lambda a: torch.from_numpy(np.asarray(a).copy())  # noqa: E731
    got = tops.paged_attention(t(q), t(kc), t(vc), t(tables), t(lens), window=window,
                               quant=tuple(t(a) for a in quant))
    _close(got, want_k)
    _close(got, want_o)
    if 0 in lengths:  # the masked sequence averages V over its whole table
        i = lengths.index(0)
        rows = tquant.dequantize_kv_rows(t(vc), t(quant[2]), t(quant[3]))
        rows = rows[t(tables[i]).long()]  # [MB, BS, Hkv, dh]
        mean = rows.reshape(mb * bs, hkv, dh).mean(dim=0)
        _close(got[i], mean[:, None, :].expand(hkv, g, dh))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (16, 256, 256), (32, 512, 128)])
def test_binary_matmul_ref(m, k, n, dtype):
    """``binary_matmul_ref`` against the reference's Pallas kernel
    (interpret mode) at the shapes of ``tests/test_kernels.py``."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    b01, alpha = jquant.quantize_binary(jnp.asarray(w))
    bp = np.asarray(jpack.pack_bits(b01, 1, axis=0))
    xj = jnp.asarray(x).astype(dtype)
    want = binary_matmul_pallas(xj, jnp.asarray(bp), alpha, bm=8, bn=128, bk=128,
                                interpret=True)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)).copy())
    if dtype == jnp.bfloat16:
        xt = xt.to(torch.bfloat16)
    got = tops.binary_matmul(xt, torch.from_numpy(bp.copy()),
                             torch.from_numpy(np.asarray(alpha).copy()))
    assert got.dtype == xt.dtype
    want = np.asarray(want.astype(jnp.float32))
    if dtype == jnp.float32:
        _close(got, want)
    else:  # bf16 outputs: within 2e-2 · max|want|
        assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("k", [3 * 128 + 64, 64])
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_ragged_group_dequant_gemms(bits, k):
    """K that ends mid-group (and K < group): the port's wrappers take it,
    as the reference does by padding the last group, and agree with the
    reference's oracles."""
    rng = np.random.default_rng(60 + bits + k)
    n, group, e, bm = 40, 128, 2, 8
    w = torch.from_numpy(rng.standard_normal((e, k, n)).astype(np.float32) * k**-0.5)
    tw, scale, zero = tquant.quantize_parts(w, bits, group, refine=False)
    x = torch.from_numpy(rng.standard_normal((e * bm, k)).astype(np.float32))
    be, na = torch.tensor([1, 0], dtype=torch.int32), torch.tensor([2], dtype=torch.int32)
    j = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    jw = tuple(map(j, tw)) if bits == 3 else j(tw)
    want = jref.moe_gmm_ref(j(x), jw, j(scale), j(zero), j(be), j(na), bits=bits, group=group,
                            bm=bm)
    got = tops.moe_gmm(x, tw, scale, zero, be, na, bits=bits, group=group, bm=bm)
    _close(got, want)
    one = tuple(p[1] for p in tw) if bits == 3 else tw[1]
    want1 = jref.quant_matmul_ref(j(x[:5]), tuple(map(j, one)) if bits == 3 else j(one),
                                  j(scale[1]), j(zero[1]), bits=bits, group=group)
    got1 = tops.quant_matmul_parts(x[:5], one, scale[1], zero[1], bits=bits, group=group)
    _close(got1, want1)


@pytest.mark.parametrize("group,n", [(32, 16), (16, 16), (32, 8), (16, 4), (32, 40),
                                     (64, 16), (128, 16)])
def test_hqq_zero_mean_byte_identical(group, n):
    """HQQ-refined scales, zeros and packed codes byte for byte against the
    reference at every group size. At a group of 32 or less XLA does not
    rewrite the mean into windows; its fused step sums in vector lanes,
    with a scalar tail at 2-8 columns (``quantizers._xla_lane_mean``)."""
    rng = np.random.default_rng(12)
    w = (rng.standard_normal((128, n)) * 0.05).astype(np.float32)
    pj = jquant.quantize_to_packed(jnp.asarray(w), 2, group=group, refine=True)
    pt = tquant.quantize_to_packed(torch.from_numpy(w), 2, group=group, refine=True)
    assert np.array_equal(pt.data.numpy(), np.asarray(pj.data))
    assert np.array_equal(pt.scale.numpy(), np.asarray(pj.scale))
    assert np.array_equal(pt.zero.numpy().view(np.int32), np.asarray(pj.zero).view(np.int32))
