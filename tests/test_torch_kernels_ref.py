"""The port's formats and plain kernel versions against the JAX reference.

Same numpy inputs through ``repro`` (its ``ref`` oracles) and
``repro_torch`` on the CPU: packing and quantization byte for byte, the
plain kernel versions within rtol = atol = 1e-5 in f32. The hand-written
CUDA kernels themselves are held against these plain versions on the card
(``test_torch_kernels_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import packing as jpack  # noqa: E402
from repro.core import quantizers as jquant  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import quantizers as tquant  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

from _torch_interop import torch_one_thread  # noqa: E402,F401

BITS = (1, 2, 3, 4)


def _planes_np(data):
    return tuple(np.asarray(d) for d in data) if isinstance(data, tuple) else (np.asarray(data),)


def _t(data):
    if isinstance(data, tuple):
        return tuple(torch.from_numpy(np.asarray(d).copy()) for d in data)
    return torch.from_numpy(np.asarray(data).copy())


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_byte_identical(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2**bits, size=(64, 24)).astype(np.uint8)
    want = _planes_np(jpack.pack_bits(jnp.asarray(codes), bits, axis=0))
    got = tpack.pack_bits(torch.from_numpy(codes), bits, axis=0)
    got = tuple(g.numpy() for g in got) if bits == 3 else (got.numpy(),)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and np.array_equal(g, w)
    back = tpack.unpack_bits(_t(jpack.pack_bits(jnp.asarray(codes), bits, axis=0)), bits, axis=0)
    assert np.array_equal(back.numpy(), codes)
    # packing along the trailing axis too
    want_last = _planes_np(jpack.pack_bits(jnp.asarray(codes.T), bits, axis=-1))
    got_last = tpack.pack_bits(torch.from_numpy(np.ascontiguousarray(codes.T)), bits, axis=-1)
    got_last = tuple(g.numpy() for g in got_last) if bits == 3 else (got_last.numpy(),)
    for g, w in zip(got_last, want_last):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_quantize_to_packed_byte_identical(bits, refine):
    """Packed codes and group params are byte-identical for every width,
    with and without HQQ: the f32 means (the 1-bit α = mean|W| and the HQQ
    zero-point mean) sum in XLA's order (``quantizers._xla_mean``)."""
    rng = np.random.default_rng(10 + bits)
    w = (rng.standard_normal((256, 48)) * 0.05).astype(np.float32)
    pj = jquant.quantize_to_packed(jnp.asarray(w), bits, group=64, refine=refine)
    pt = tquant.quantize_to_packed(torch.from_numpy(w), bits, group=64, refine=refine)
    assert pt.shape == tuple(pj.shape) and pt.bits == pj.bits and pt.group == pj.group
    got = pt.data if bits == 3 else (pt.data,)
    for g, want in zip(got, _planes_np(pj.data)):
        assert g.dtype == torch.uint8 and np.array_equal(g.numpy(), want)
    assert np.array_equal(pt.scale.numpy(), np.asarray(pj.scale))
    assert np.array_equal(pt.zero.numpy(), np.asarray(pj.zero))


def _packed(rng, e, k, n, bits, group):
    """Random expert stack quantized by the reference: numpy planes, scale, zero."""
    pts = [jquant.quantize_to_packed(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)
                                                 * k**-0.5), bits, group=group, refine=False)
           for _ in range(e)]
    planes = [np.stack([_planes_np(p.data)[i] for p in pts]) for i in range(2 if bits == 3 else 1)]
    scale = np.stack([np.asarray(p.scale) for p in pts])
    zero = np.stack([np.asarray(p.zero) for p in pts])
    return planes, scale, zero


def _jw(planes):
    return tuple(jnp.asarray(p) for p in planes) if len(planes) == 2 else jnp.asarray(planes[0])


def _tw(planes):
    return (tuple(torch.from_numpy(p.copy()) for p in planes) if len(planes) == 2
            else torch.from_numpy(planes[0].copy()))


@pytest.mark.parametrize("bits", BITS)
def test_dequant_and_quant_matmul_ref(bits):
    rng = np.random.default_rng(20 + bits)
    k, n, group = 192, 40, 64
    planes, scale, zero = _packed(rng, 1, k, n, bits, group)
    planes = [p[0] for p in planes]
    x = rng.standard_normal((5, k)).astype(np.float32)
    want_w = jref.dequant_ref(_jw(planes), jnp.asarray(scale[0]), jnp.asarray(zero[0]), bits, k,
                              group)
    got_w = tref.dequant_ref(_tw(planes), torch.from_numpy(scale[0]), torch.from_numpy(zero[0]),
                             bits, k, group)
    _close(got_w, want_w)
    want = jref.quant_matmul_ref(jnp.asarray(x), _jw(planes), jnp.asarray(scale[0]),
                                 jnp.asarray(zero[0]), bits=bits, group=group)
    got = tref.quant_matmul_ref(torch.from_numpy(x), _tw(planes), torch.from_numpy(scale[0]),
                                torch.from_numpy(zero[0]), bits=bits, group=group)
    _close(got, want)


def _ragged(rng, experts, cap, bm):
    """block_expert with dead trailing blocks repeating the last id, and
    num_active short of the block count."""
    nblocks = experts * cap // bm
    live = int(rng.integers(1, nblocks))
    be = np.sort(rng.integers(0, experts, size=live)).astype(np.int32)
    be = np.concatenate([be, np.full(nblocks - live, experts - 1, np.int32)])
    return be, np.array([live], np.int32)


@pytest.mark.parametrize("bm", [8, 16])
@pytest.mark.parametrize("bits", BITS)
def test_moe_gmm_refs(bits, bm):
    rng = np.random.default_rng(30 + bits + bm)
    e, cap, k, n, group = 3, 16, 64, 48, 32
    be, na = _ragged(rng, e, cap, bm)
    x = rng.standard_normal((e * cap, k)).astype(np.float32)
    wg, gs, gz = _packed(rng, e, k, n, bits, group)
    wu, us, uz = _packed(rng, e, k, n, bits, group)
    kw = dict(bits=bits, group=group, bm=bm)
    want = jref.moe_gmm_ref(jnp.asarray(x), _jw(wg), jnp.asarray(gs), jnp.asarray(gz),
                            jnp.asarray(be), jnp.asarray(na), **kw)
    got = tref.moe_gmm_ref(torch.from_numpy(x), _tw(wg), torch.from_numpy(gs),
                           torch.from_numpy(gz), torch.from_numpy(be), torch.from_numpy(na), **kw)
    _close(got, want)
    assert not got[int(na[0]) * bm:].any()
    want = jref.moe_gmm_swiglu_ref(
        jnp.asarray(x), _jw(wg), _jw(wu), jnp.asarray(gs), jnp.asarray(gz), jnp.asarray(us),
        jnp.asarray(uz), jnp.asarray(be), jnp.asarray(na), **kw)
    got = tref.moe_gmm_swiglu_ref(
        torch.from_numpy(x), _tw(wg), _tw(wu), torch.from_numpy(gs), torch.from_numpy(gz),
        torch.from_numpy(us), torch.from_numpy(uz), torch.from_numpy(be), torch.from_numpy(na),
        **kw)
    _close(got, want)


@pytest.mark.parametrize("g,window", [(1, None), (2, None), (2, 5), (1, 9)])
def test_paged_attention_ref(g, window):
    rng = np.random.default_rng(40 + g + (window or 0))
    b, hkv, dh, nb, bs, mb = 3, 2, 16, 12, 4, 3
    q = rng.standard_normal((b, hkv, g, dh)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hkv, dh)).astype(np.float32)
    tables = rng.permutation(nb)[: b * mb].reshape(b, mb).astype(np.int32)
    lengths = np.array([1, 6, 12], np.int32)
    want = jref.paged_attention_ref(*(jnp.asarray(a) for a in (q, kp, vp, tables, lengths)),
                                    window=window)
    got = tref.paged_attention_ref(*(torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)),
                                   window=window)
    _close(got, want)
