"""The port's paged serving path end to end against the JAX reference.

``moonshot-v1-16b-a3b.reduced()`` is compressed by the reference
``compress_for_serving`` (PMQ buckets, 4-bit attention and shared experts)
with stacked OTP routers, and carried into the port byte for byte by
``repro_torch.interop``. The port's prefill/decode logits must agree within
1e-4·max|logit| and its engine must emit the reference engine's greedy
tokens exactly. Also: the port imports neither ``jax`` nor ``repro``, and
refuses the settings its slices do not implement.
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
from repro_torch.serving import (  # noqa: E402
    EngineConfig, InvalidRequest, PagedServingEngine, Request)
from repro_torch.serving.kvcache import PagedKVCache as TCache  # noqa: E402

from _torch_interop import (  # noqa: E402,F401
    compressed_reference, flatten_reference, torch_one_thread)

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


def test_expert_activation_ignores_inactive_slots(served_model):
    """The decode step's activation metric counts active slots only (the
    port's mirror of ``tests/test_serving.py``'s regression test). The
    reference's OTP routers keep a constant share of experts for every token
    of this model, so the layers here get routers whose choice follows the
    token (the first top-k entries of ``fc2`` an identity): with slot 1
    active its token moves the metric across 10 tokens; with slot 1
    inactive the metric does not move."""
    _, _, params_t = served_model
    cfg = tget_config("moonshot-v1-16b-a3b").reduced()
    gen = torch.Generator().manual_seed(0)
    k = cfg.top_k

    def router():
        fc2 = torch.zeros(2 * k, k)
        fc2[:k] = torch.eye(k)
        return {"fc1": torch.randn(cfg.d_model, k, generator=gen), "fc2": fc2}

    params = dict(params_t, layers=[dict(layer, otp=router()) for layer in params_t["layers"]])
    cache = TCache(cfg, num_blocks=8, block_size=4, max_slots=2, max_blocks_per_slot=2,
                   device="cpu")
    cache.acquire_slot(2)
    cache.acquire_slot(2)
    positions = torch.zeros(2, dtype=torch.int32)

    def act_of(garbage, active):
        active = torch.tensor(active)
        _, per_slot, _ = ttf._paged_decode_core(
            params, cache.k, cache.v, cache.tables_device(), torch.tensor([[7], [garbage]]),
            positions, active, cfg, 8, 4, use_otp=True)
        return float(ttf._masked_activation(per_slot, active))

    unmasked = {act_of(g, [True, True]) for g in range(10)}
    masked = {act_of(g, [True, False]) for g in range(10)}
    assert len(unmasked) > 1  # slot 1's token moves the metric when it counts
    assert len(masked) == 1  # and not when slot 1 is inactive


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


@pytest.mark.parametrize("ffn_backend", ["grouped", "ref", "scan"])
def test_engine_ffn_backend_tokens_match_reference(served_model, ffn_backend):
    """``EngineConfig(ffn_backend=)`` on both sides: the port's ``grouped``
    (plain versions on the CPU), ``ref`` and ``scan`` serve the reference
    engine's tokens under the same backend."""
    cfg, params_j, params_t = served_model
    geo = dict(max_slots=2, block_size=16, num_blocks=16, max_blocks_per_slot=4,
               prefill_chunk=16, decode_horizon=4, reserve_full=True, use_otp=True,
               ffn_backend=ffn_backend)
    prompts = _prompts(cfg, seed=8)
    want = JEngine(cfg, params_j, JEngineConfig(**geo)).serve(
        JRequest(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts))
    eng = PagedServingEngine(tget_config("moonshot-v1-16b-a3b").reduced(), params_t,
                             EngineConfig(**geo), device="cpu")
    assert eng.serve(Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)) == want


def test_ffn_backend_env_sets_the_process_default(served_model, monkeypatch):
    """``REPRO_FFN_BACKEND`` is the default of an engine left at
    ``ffn_backend=None``, read as the reference reads it (``scan`` too); the
    refused ``interpret`` named there fails where it is resolved."""
    from repro.core.compressed_moe import default_ffn_backend as jdefault
    from repro_torch.core.compressed_moe import default_ffn_backend, resolve_ffn_backend

    cfg, params_j, params_t = served_model
    monkeypatch.setenv("REPRO_FFN_BACKEND", " Ref ")
    assert default_ffn_backend() == jdefault() == resolve_ffn_backend(None) == "ref"
    geo = dict(max_slots=2, block_size=16, num_blocks=16, max_blocks_per_slot=4,
               prefill_chunk=16, decode_horizon=4, reserve_full=True, use_otp=True)
    prompts = _prompts(cfg, seed=9)
    want = JEngine(cfg, params_j, JEngineConfig(**geo)).serve(
        JRequest(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts))
    eng = PagedServingEngine(tget_config("moonshot-v1-16b-a3b").reduced(), params_t,
                             EngineConfig(**geo), device="cpu")
    assert eng.serve(Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)) == want
    monkeypatch.setenv("REPRO_FFN_BACKEND", "scan")
    assert default_ffn_backend() == jdefault() == resolve_ffn_backend(None) == "scan"
    monkeypatch.setenv("REPRO_FFN_BACKEND", "interpret")
    with pytest.raises(ValueError, match="interpret.*not ported"):
        resolve_ffn_backend(None)


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
        "for m in ('models.registry', 'models.moe', 'configs.qwen3_14b', 'launch.fp_tokens',\n"
        "          'serving.offload', 'serving.tierstore', 'core.pipeline', 'core.gptq',\n"
        "          'core.pmq', 'core.significance', 'parallel.sharding',\n"
        "          'parallel.ep_shardmap', 'launch.mesh', 'runtime.elastic',\n"
        "          'optim.grad_compress', 'launch.steps', 'launch.specs',\n"
        "          'launch.step_ranks'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every submodule was imported


class _Elsewhere(torch.Tensor):
    """A ``[2, 128]`` tensor on a device no kernel wrapper takes (``xpu``);
    it runs no op."""

    @staticmethod
    def __new__(cls):
        return torch.Tensor._make_wrapper_subclass(cls, (2, 128), device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(func)


def test_engine_refuses_later_slice_settings(served_model):
    _, _, params_t = served_model
    cfg = tget_config("moonshot-v1-16b-a3b").reduced()
    # growth + swap preemption is the default, as in the reference
    assert (EngineConfig().reserve_full, EngineConfig().preempt_mode) == (False, "swap")
    with pytest.raises(ValueError, match="preempt_mode"):
        PagedServingEngine(cfg, params_t, EngineConfig(preempt_mode="drop"), device="cpu")
    with pytest.raises(ValueError, match="decode_horizon"):
        PagedServingEngine(cfg, params_t, EngineConfig(decode_horizon=0), device="cpu")
    with pytest.raises(ValueError, match="layers"):
        PagedServingEngine(dataclasses.replace(cfg, num_layers=3), params_t, device="cpu")
    # the reference's FFN backend knob: grouped, ref and scan are ported,
    # interpret (the Pallas interpreter) is refused by name
    for backend in ("grouped", "ref", "scan"):
        assert EngineConfig(ffn_backend=backend).ffn_backend == backend
    with pytest.raises(ValueError, match="interpret.*not ported"):
        EngineConfig(ffn_backend="interpret")
    with pytest.raises(ValueError, match="policy"):
        PagedServingEngine(cfg, params_t, EngineConfig(policy="lottery"), device="cpu")
    with pytest.raises(ValueError, match="trace level"):
        PagedServingEngine(cfg, params_t, EngineConfig(trace_level="verbose"), device="cpu")
    with pytest.raises(ValueError, match="kv_bits"):
        PagedServingEngine(cfg, params_t, EngineConfig(kv_bits=4), device="cpu")
    eng = PagedServingEngine(cfg, params_t, EngineConfig(max_blocks_per_slot=2), device="cpu")
    with pytest.raises(ValueError, match="exceed"):
        eng.submit(Request(rid=0, prompt=np.zeros(30, np.int32), max_new=4))
    with pytest.raises(InvalidRequest, match="empty prompt"):
        eng.submit(Request(rid=1, prompt=np.zeros(0, np.int32), max_new=4))
    with pytest.raises(InvalidRequest, match="max_new must be"):
        eng.submit(Request(rid=2, prompt=np.zeros(3, np.int32), max_new=0))
    # a kernel wrapper takes CPU (its plain version), CUDA (the kernel) and
    # meta (the dry run's count) tensors, and refuses any other device
    from repro_torch.kernels.quant_matmul import quant_matmul
    with pytest.raises(ValueError, match="unsupported device"):
        quant_matmul(_Elsewhere(), None, None, None, bits=4)
