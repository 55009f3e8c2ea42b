"""The port's paged serving path end to end against the JAX reference.

``moonshot-v1-16b-a3b.reduced()`` is compressed by the reference
``compress_for_serving`` (PMQ buckets, 4-bit attention and shared experts)
with stacked OTP routers, and carried into the port byte for byte by
``repro_torch.interop``. The port's prefill/decode logits must agree within
1e-4·max|logit| and its engine must emit the reference engine's greedy
tokens exactly. Also: the port imports neither ``jax`` nor ``repro``, and
refuses the settings this slice does not implement.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.kvcache import PagedKVCache as JCache  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import EngineConfig, PagedServingEngine, Request  # noqa: E402
from repro_torch.serving.kvcache import PagedKVCache as TCache  # noqa: E402

from _torch_interop import compressed_reference, flatten_reference  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.array_equal(got.astype(np.int64), np.asarray(want).astype(np.int64))


def test_port_config_matches_reference():
    assert dataclasses.asdict(tget_config("moonshot-v1-16b-a3b")) == dataclasses.asdict(
        jget_config("moonshot-v1-16b-a3b"))
    assert dataclasses.asdict(tget_config("moonshot-v1-16b-a3b").reduced()) == \
        dataclasses.asdict(jget_config("moonshot-v1-16b-a3b").reduced())


@pytest.fixture(scope="module")
def served_model():
    """(cfg, reference params, port params) of the compressed reduced model."""
    cfg = jget_config("moonshot-v1-16b-a3b").reduced()
    params_j = compressed_reference(cfg)
    flat, meta = flatten_reference(params_j)
    return cfg, params_j, interop.params_from_reference(flat, meta, device="cpu")


def test_interop_copies_bytes(served_model):
    cfg, params_j, params_t = served_model
    layer = params_t["layers"][1]
    wq = params_j["blocks"]["attn"]["wq"]["w"]
    assert np.array_equal(layer["attn"]["wq"]["w"].data.numpy(), np.asarray(wq.data)[1])
    assert np.array_equal(layer["attn"]["wq"]["w"].scale.numpy(), np.asarray(wq.scale)[1])
    jce = params_j["blocks"]["moe_ce"]
    tce = layer["moe_ce"]
    _eq(tce.slot_of_expert, np.asarray(jce.slot_of_expert)[1])
    for b, bucket in jce.arrays.items():
        for name, arrs in bucket.items():
            for key, a in arrs.items():
                assert np.array_equal(tce.arrays[b][name][key].numpy(), np.asarray(a)[1])
    assert np.array_equal(layer["otp"]["fc2"].numpy(), np.asarray(params_j["blocks"]["otp"]["fc2"])[1])


def test_prefill_and_decode_logits(served_model):
    """Two prefill chunks (the second right-padded) then one decode step
    over two slots: logits within 1e-4·max|logit|, dispatch counts and OTP
    activations identical."""
    cfg, params_j, params_t = served_model
    bs, chunk = 16, 16
    geo = dict(num_blocks=8, block_size=bs, max_slots=2, max_blocks_per_slot=4)
    jc = JCache.create(cfg, **geo)
    tc = TCache(cfg, device="cpu", **geo)
    for cache in (jc, tc):
        assert cache.acquire_slot(40) == 0 and cache.acquire_slot(30) == 1
    assert np.array_equal(tc.block_tables, jc.block_tables)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, size=20).astype(np.int32)
    jk, jv = jc.k, jc.v
    row = jc.block_tables[:1]
    for off in (0, 16):
        n = min(chunk, len(prompt) - off)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :n] = prompt[off:off + n]
        out, jl, jinfo = jtf.paged_prefill_chunk(
            params_j, {"k": jk, "v": jv, "block_tables": jnp.asarray(row)},
            jnp.asarray(toks), jnp.int32(off), jnp.int32(n), cfg)
        jk, jv = out["k"], out["v"]
        tl, tcounts = ttf.paged_prefill_chunk(
            params_t, tc.k, tc.v, torch.from_numpy(row), torch.from_numpy(toks.astype(np.int64)),
            off, n, cfg, block_size=bs)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-4 * np.abs(jl).max())
        _eq(tcounts, jinfo["slot_counts"])
    nb = geo["num_blocks"]
    np.testing.assert_allclose(tc.k[:, : nb * bs].reshape(np.asarray(jk).shape).numpy(),
                               np.asarray(jk), rtol=1e-5, atol=1e-5)
    token = np.array([[int(np.argmax(jl[0, -1]))], [5]], np.int32)
    positions = np.array([len(prompt), 0], np.int32)
    active = np.array([True, False])
    _, jlog, jinfo = jtf.paged_decode_step(
        params_j, {"k": jk, "v": jv, "block_tables": jnp.asarray(jc.block_tables),
                   "active": jnp.asarray(active)},
        jnp.asarray(token), jnp.asarray(positions), cfg)
    tlog, per_slot, tcounts = ttf._paged_decode_core(
        params_t, tc.k, tc.v, tc.tables_device(), torch.from_numpy(token.astype(np.int64)),
        torch.from_numpy(positions), torch.from_numpy(active), cfg, nb, bs, use_otp=True)
    jlog = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0, atol=1e-4 * np.abs(jlog).max())
    _eq(tcounts, jinfo["slot_counts"])
    act = float(ttf._masked_activation(per_slot, torch.from_numpy(active)))
    assert act == pytest.approx(float(jinfo["expert_activation"]), abs=1e-7)


def _prompts(cfg, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (20, 33, 7)]


@pytest.mark.parametrize("horizon", [1, 4])
def test_engine_greedy_tokens_match_reference(served_model, horizon):
    """Three requests on two slots (the third admitted mid-flight), chunked
    prefill, fp KV, reserve_full: identical greedy tokens."""
    cfg, params_j, params_t = served_model
    geo = dict(max_slots=2, block_size=16, num_blocks=16, max_blocks_per_slot=4,
               prefill_chunk=16, decode_horizon=horizon, reserve_full=True, use_otp=True)
    prompts = _prompts(cfg)
    want = JEngine(cfg, params_j, JEngineConfig(**geo)).serve(
        JRequest(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts))
    eng = PagedServingEngine(tget_config("moonshot-v1-16b-a3b").reduced(), params_t,
                             EngineConfig(**geo), device="cpu")
    got = eng.serve(Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts))
    assert got == want
    assert eng.cache.allocator.num_free == geo["num_blocks"]
    assert sorted(eng.cache.free_slots) == [0, 1]
    assert 0.0 < eng.summary()["expert_activation"] < 1.0  # OTP pruned some experts


def test_block_tables_match_reference():
    cfg = jget_config("moonshot-v1-16b-a3b").reduced()
    geo = dict(num_blocks=10, block_size=4, max_slots=3, max_blocks_per_slot=4)
    jc, tc = JCache.create(cfg, **geo), TCache(cfg, device="cpu", **geo)
    for op, arg in [("acq", 9), ("acq", 4), ("rel", 0), ("acq", 13), ("acq", 2), ("rel", 1)]:
        for c in (jc, tc):
            if op == "acq":
                c.acquire_slot(arg)
            else:
                c.release_slot(arg)
        assert np.array_equal(tc.block_tables, jc.block_tables)
        assert tc.allocator.num_free == jc.allocator.num_free
        assert tc.free_slots == jc.free_slots


def test_import_leaves_jax_and_repro_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every submodule was imported


def test_engine_refuses_later_slice_settings(served_model):
    _, _, params_t = served_model
    cfg = tget_config("moonshot-v1-16b-a3b").reduced()
    with pytest.raises(ValueError, match="reserve_full"):
        PagedServingEngine(cfg, params_t, EngineConfig(reserve_full=False), device="cpu")
    with pytest.raises(ValueError, match="decode_horizon"):
        PagedServingEngine(cfg, params_t, EngineConfig(decode_horizon=0), device="cpu")
    with pytest.raises(ValueError, match="layers"):
        PagedServingEngine(dataclasses.replace(cfg, num_layers=3), params_t, device="cpu")
    for later in ("temperature", "kv_bits", "prefix_cache", "preempt_mode",
                  "resident_experts", "trace_level", "policy", "ffn_backend"):
        with pytest.raises(TypeError):
            EngineConfig(**{later: 1})
    eng = PagedServingEngine(cfg, params_t, EngineConfig(max_blocks_per_slot=2), device="cpu")
    with pytest.raises(ValueError, match="exceed"):
        eng.submit(Request(rid=0, prompt=np.zeros(30, np.int32), max_new=4))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request(rid=1, prompt=np.zeros(0, np.int32), max_new=4))
    with pytest.raises(ValueError, match="unsupported device"):
        from repro_torch.kernels.quant_matmul import quant_matmul
        quant_matmul(torch.zeros(2, 128, device="meta"), None, None, None, bits=4)
