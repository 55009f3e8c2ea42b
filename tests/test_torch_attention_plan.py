"""The work split of the port's paged-attention kernels, and their algorithm
written out in plain torch, on the CPU.

``kernels/paged_attention.py: attention_plan`` is what
``csrc/paged_attention.cu`` runs: fixed page chunks across blocks, each
chunk's pages shared out over the block's warps, a per-warp online softmax
over batches of ``batch_steps`` steps of ``rows_per_step`` rows, the
warps' states merged in warp order
and the chunks' in chunk order (empty ones skipped). The plan must take no
batch size and no lengths, and put the chunk boundaries at the same
positions for every table width. :func:`emulate` runs that algorithm step
for step in f32 and is held to the JAX reference
(``repro.kernels.ref.paged_attention_ref``; int8 pools quantized by
``repro.core.quantizers.quantize_kv_rows``, as the JAX package's own quant
tests take them) within ``1e-5 · max|ref|``: only the summation order
differs.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.quantizers import quantize_kv_rows  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.paged_attention import MAX_G, attention_plan  # noqa: E402
from repro_torch.kernels.quant_matmul import SMEM_OPTIN  # noqa: E402

from _torch_interop import torch_one_thread  # noqa: E402,F401

NEG_INF = -1e30
POOLS = (torch.float32, torch.bfloat16, torch.uint8)


def test_plan_takes_no_batch_and_no_lengths():
    assert list(inspect.signature(attention_plan).parameters) == [
        "mb", "bs", "dh", "g", "pool_dtype"]


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("bs", [4, 16])
def test_chunk_boundaries_fixed_for_every_mb(bs, pool):
    """The chunk size comes from the page size and static constants; a wider
    table only adds chunks past the old ones."""
    plans = [attention_plan(mb, bs, 128, 1, pool) for mb in range(1, 300)]
    chunk = plans[0]["chunk"]
    assert chunk == plans[0]["chunk_pages"] * bs
    assert chunk == plans[0]["warps"] * plans[0]["pages_per_warp"] * bs
    for mb, p in enumerate(plans, start=1):
        assert p["chunk"] == chunk
        assert p["chunks"] == -(-(mb * bs) // chunk)
        assert p["merge_smem_bytes"] == (8 * p["chunks"] if p["chunks"] > 1 else 0)
        per_chunk = ("chunks", "merge_smem_bytes")  # the only entries that follow mb
        assert {k: v for k, v in p.items() if k not in per_chunk} == \
            {k: v for k, v in plans[0].items() if k not in per_chunk}


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("dh", [32, 96, 128, 256])
def test_plan_fits_every_head_width(dh, pool):
    """Lanes per row are a power of two covering the row; the ring or the
    warps' merge area fits the card's shared memory at page 16, G up to 8."""
    for g in (1, 2, MAX_G):
        p = attention_plan(6, 16, dh, g, pool)
        lanes = p["lanes_per_row"]
        assert lanes & (lanes - 1) == 0 and lanes <= 32
        assert lanes * p["elems_per_lane"] >= dh > lanes // 2 * p["elems_per_lane"]
        assert p["rows_per_step"] * lanes == 32
        assert p["smem_bytes"] <= SMEM_OPTIN
        assert 1 <= p["stages"] <= p["pages_per_warp"]
        ring = 32 * 1024 if pool == torch.uint8 else 64 * 1024
        assert p["stages"] == 1 or p["warps"] * p["stages"] * p["stage_bytes"] <= ring


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "reduced"])
def test_port_configs_take_the_vector_loads(name):
    """Every config of the port has rows of a multiple of 16 bytes in every
    pool type, so the wrapper never refuses it."""
    cfg = get_config("moonshot-v1-16b-a3b")
    cfg = cfg.reduced() if name == "reduced" else cfg
    g = cfg.num_heads // cfg.num_kv_heads
    for pool in POOLS:
        elem = torch.empty((), dtype=pool).element_size()
        assert cfg.head_dim * elem % 16 == 0
        assert attention_plan(8, 16, cfg.head_dim, g, pool)["smem_bytes"] <= SMEM_OPTIN


def _merge(states):
    """Fixed-order merge of ``(acc [G, dh], m [G], l [G])`` states, empty
    ones (``None``) skipped: the max state enters as acc·1.0, l·1.0."""
    live = [s for s in states if s is not None]
    if not live:
        return None
    m_max = torch.stack([m for _, m, _ in live]).max(dim=0).values
    acc, l = None, None
    for a, m, lw in live:
        f = torch.exp(m - m_max)
        acc = a * f[:, None] if acc is None else acc + a * f[:, None]
        l = lw * f if l is None else l + lw * f
    return acc, m_max, l


def emulate(q, k, v, tables, lengths, window, pool_dtype=torch.float32):
    """The kernels' algorithm in f32 (``k``/``v`` already dequantized)."""
    b, hkv, g, dh = q.shape
    bs, mb = k.shape[1], tables.shape[1]
    plan = attention_plan(mb, bs, dh, g, pool_dtype)
    win = mb * bs + 1 if window is None else window
    rps, warps, ppw, cp = (plan[k_] for k_ in ("rows_per_step", "warps", "pages_per_warp",
                                               "chunk_pages"))
    rpb = rps * plan["batch_steps"]  # rows of a batch; row t0 + i is lane group i % rps
    group = torch.nn.functional.one_hot(torch.arange(rpb) % rps, rps).float()  # [rpb, rps]
    out = torch.empty_like(q)
    for bi in range(b):
        n = int(lengths[bi])
        first, last = max(0, n - win), min(n, mb * bs) - 1
        j_lo, j_hi = (0, mb - 1) if first > last else (first // bs, last // bs)
        for h in range(hkv):
            qs = q[bi, h] * dh ** -0.5
            parts = []
            for c in range(plan["chunks"]):
                lo, hi = max(j_lo, c * cp), min(j_hi, c * cp + cp - 1)
                states = []
                for w in range(warps if lo <= hi else 0):
                    pages = [j for j in (c * cp + w + i * warps for i in range(ppw))
                             if lo <= j <= hi]
                    if not pages:
                        states.append(None)
                        continue
                    m = torch.full((g,), NEG_INF)
                    l, acc = torch.zeros(rps, g), torch.zeros(rps, g, dh)
                    for j in pages:
                        page = int(tables[bi, j])
                        for t0 in range(0, bs, rpb):
                            t = torch.arange(t0, t0 + rpb)
                            exist = t < bs
                            rows = t.clamp(max=bs - 1)
                            s = k[page, rows, h] @ qs.T  # [rpb, G]
                            pos = j * bs + t
                            valid = exist & (pos < n) & (pos > n - 1 - win)
                            s = torch.where(valid[:, None], s, NEG_INF)
                            m_new = torch.maximum(m, s.max(dim=0).values)
                            alpha = torch.exp(m - m_new)
                            p = torch.where(exist[:, None], torch.exp(s - m_new), 0.0)
                            pv = p[..., None] * v[page, rows, h][:, None]  # [rpb, G, dh]
                            l = l * alpha + group.T @ p
                            pv = torch.einsum("rs,rgd->sgd", group, pv)
                            acc = acc * alpha[None, :, None] + pv
                            m = m_new
                    states.append((acc.sum(dim=0), m, l.sum(dim=0)))
                parts.append(_merge(states))
            acc, _, l = _merge(parts)
            out[bi, h] = acc / l.clamp(min=1e-30)[:, None]
    return out


def _problem(seed, g, dh, bs, mb, lengths):
    rng = np.random.default_rng(seed)
    b, hkv = len(lengths), 2
    nb = b * mb + 3
    q = rng.normal(size=(b, hkv, g, dh)).astype(np.float32)
    kf = rng.normal(size=(nb, bs, hkv, dh)).astype(np.float32)
    vf = rng.normal(size=(nb, bs, hkv, dh)).astype(np.float32)
    tables = rng.permutation(nb)[: b * mb].reshape(b, mb).astype(np.int32)
    return q, kf, vf, tables, np.asarray(lengths, np.int32)


# (G, dh, page, MB): chunk = 16 pages; lengths 0, 1, chunk-1, chunk, chunk+1
# and MB·BS, windows whose first valid position falls mid-chunk
SHAPES = [(1, 16, 4, 24), (2, 32, 4, 20), (2, 16, 4, 3)]
WINDOWS = [None, 20, 45]


def _lengths(bs, mb):
    chunk = attention_plan(mb, bs, 16, 1, torch.float32)["chunk"]
    return [n for n in (0, 1, chunk - 1, chunk, chunk + 1, mb * bs) if n <= mb * bs]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("g,dh,bs,mb", SHAPES)
@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_emulation_matches_reference(kind, g, dh, bs, mb, window):
    q, kf, vf, tables, lengths = _problem(7 + g + dh + mb, g, dh, bs, mb, _lengths(bs, mb))
    args = (jnp.asarray(tables), jnp.asarray(lengths))
    if kind == "fp":
        want = jref.paged_attention_ref(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), *args,
                                        window=window)
        k, v, pool = torch.from_numpy(kf), torch.from_numpy(vf), torch.float32
    else:
        kc, ks, kz = quantize_kv_rows(jnp.asarray(kf), 8)
        vc, vs, vz = quantize_kv_rows(jnp.asarray(vf), 8)
        want = jref.paged_attention_ref(jnp.asarray(q), kc, vc, *args, window=window,
                                        quant=(ks, kz, vs, vz))

        def deq(c, s, z):  # dequantize_kv_rows' expression, in f32
            c, s, z = (torch.from_numpy(np.array(a)) for a in (c, s, z))
            return (c.float() - z[..., None]) * s[..., None]

        k, v, pool = deq(kc, ks, kz), deq(vc, vs, vz), torch.uint8
    got = emulate(torch.from_numpy(q), k, v, torch.from_numpy(tables),
                  torch.from_numpy(lengths), window, pool)
    want = torch.from_numpy(np.array(want))
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
