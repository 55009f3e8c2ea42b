"""The port's CUDA kernels against their plain PyTorch versions on the card,
and a decode megastep that never waits on the host.

Skips without an NVIDIA GPU: the kernels have no CPU mode. Imports no JAX,
so it also runs on a machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: ``max|kernel − plain| ≤ tol · max|plain|`` with tol 1e-4 for f32
(only the summation order differs) and 2e-2 for bf16 (both round the
weights to bf16 and accumulate in f32; outputs round to bf16).
"""
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,window", [(1, None), (2, 17), (4, None)])
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
def test_decode_horizon_never_syncs(dev):
    """A decode megastep of the reduced model keeps the host out of the loop:
    under ``set_sync_debug_mode("error")`` anything inside the horizon that
    waits on the device (an ``.item()``, a ``bincount``, a blocking copy)
    raises."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.synthetic import build_synthetic
    from repro_torch.models.transformer import paged_decode_horizon
    from repro_torch.serving.kvcache import PagedKVCache

    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts))
    params = build_synthetic(cfg, seed=0, device=dev)
    cache = PagedKVCache(cfg, num_blocks=8, block_size=16, max_slots=2, max_blocks_per_slot=4,
                         device=dev)
    cache.acquire_slot(40)
    cache.acquire_slot(30)
    i32 = dict(dtype=torch.int32, device=dev)
    args = (params, cache.k, cache.v, cache.tables_device(),
            torch.tensor([[3], [5]], device=dev), torch.tensor([20, 7], **i32),
            torch.ones(2, dtype=torch.bool, device=dev), cfg)
    kw = dict(block_size=16, horizon=4, budgets=torch.tensor([4, 2], **i32),
              eos_ids=torch.full((2,), -1, **i32))
    paged_decode_horizon(*args, **kw)  # builds the kernels, warms the libraries
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, emits, _, _ = paged_decode_horizon(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert emits.sum(dim=0).tolist() == [4, 2]
