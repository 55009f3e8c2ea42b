"""The reference's other transformer configs and the ``vlm`` family in the
port, against the JAX reference on the CPU (f32).

``tinyllama-1.1b``, ``gemma3-27b``, ``command-r-35b``,
``llava-next-mistral-7b`` and ``kimi-k2-1t-a32b``, each initialised once by
the reference ``init_lm`` (seed 0) and carried into the port byte for byte
by ``repro_torch.interop``. Held:

* the five configs equal the reference's field for field, full and reduced;
* for each reduced config, the dense-cache ``prefill`` and a ``decode_step``
  over its cache (``test_arch_smoke.py:85``) and decoding token 8 over the
  prefill of 8 (``:117``): logits within 1e-4·max|logit| of the
  reference's;
* reduced llava (8 patch tokens): the prefill with patches ahead of the
  prompt within 1e-4·max|logit|, ``cache["pos"]`` = S + 8, and 4 greedy
  decode steps after it with the reference's tokens; then the paged engine
  on tokens alone against the reference's engine: tokens, ``counters()``
  and the deterministic trace equal;
* gemma3 cut to 6 layers (layer 5 global; ``reduced()`` alone keeps 2 local
  layers) on 40-token prompts, past its window of 16: the reference engine's
  tokens and the port's dense-cache oracle's;
* reduced kimi-k2 with a fixed PMQ plan (``planned_reference``): the
  reference engine's tokens;
* the sliced expert build (``compressed_moe.SLICE_ELEMENTS``) byte-identical
  to the one-shot build, on the reduced moonshot and kimi-k2.

One engine geometry for the file (the reference compiles once per geometry).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as J  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch import serving as T  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core import compressed_moe as cm  # noqa: E402
from repro_torch.core.packing import PackedTensor  # noqa: E402
from repro_torch.core.synthetic import build_synthetic  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving.engine import dense_greedy_reference  # noqa: E402

from _torch_interop import (  # noqa: E402,F401
    flatten_reference, planned_reference, torch_one_thread)

ARCHS = ["command-r-35b", "gemma3-27b", "kimi-k2-1t-a32b", "llava-next-mistral-7b",
         "tinyllama-1.1b"]
GEO = dict(max_slots=2, block_size=8, num_blocks=12, max_blocks_per_slot=6, prefill_chunk=8,
           decode_horizon=4, reserve_full=True, trace_level="spans")
B, S = 2, 32
#: the fixed PMQ plan of the reduced kimi-k2 (8 experts)
KIMI_BITS = [2, 1, 2, 3, 2, 2, 3, 2]


def _reduced(arch, **kw):
    """The reduced config of ``arch`` in both packages (``kw`` replaced)."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **kw)
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _model(arch, num_layers=None, planned=False):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, tcfg = _reduced(arch, **({"num_layers": num_layers} if num_layers else {}))
    if planned:
        params_j = planned_reference(jcfg, KIMI_BITS)
    else:
        params_j = jget_model(jcfg).init(jax.random.PRNGKey(0))
    flat, meta = flatten_reference(params_j)
    return jcfg, tcfg, params_j, interop.params_from_reference(flat, meta, device="cpu")


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def _tokens(vocab, n, length, seed):
    return np.random.default_rng(seed).integers(0, vocab, (n, length)).astype(np.int32)


def _patches(cfg, b, seed=3):
    return np.random.default_rng(seed).normal(size=(b, cfg.num_patch_tokens,
                                                   cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert dataclasses.asdict(tget_config(arch)) == dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(tget_config(arch).reduced()) == dataclasses.asdict(
        jget_config(arch).reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_reference(arch):
    jcfg, tcfg, params_j, params_t = _model(arch)
    toks = _tokens(jcfg.vocab_size, B, S, 0)
    batch_j, batch_t = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks).long()}
    if jcfg.family == "vlm":
        patches = _patches(jcfg, B)
        batch_j["patch_embeds"] = jnp.asarray(patches)
        batch_t["patch_embeds"] = torch.as_tensor(patches)
    cache_j, logits_j = jtf.prefill(params_j, batch_j, jcfg)
    cache_t, logits_t = ttf.prefill(params_t, batch_t, tcfg)
    _close(logits_t, logits_j)
    assert cache_t["pos"] == int(cache_j["pos"])
    # decode over the prefill's cache, overwriting its last slot (test_arch_smoke.py:85)
    pos = cache_t["pos"] - 1
    tok = np.asarray(jnp.argmax(logits_j, axis=-1)).astype(np.int32)
    _, logits2_j = jtf.decode_step(params_j, cache_j, jnp.asarray(tok), jnp.int32(pos), jcfg)
    _, logits2_t = ttf.decode_step(params_t, cache_t, torch.as_tensor(tok).long(), pos, tcfg)
    _close(logits2_t, logits2_j)
    # token 8 decoded over the prefill of 8 equals its prefill (test_arch_smoke.py:117)
    t8 = _tokens(jcfg.vocab_size, 1, 8, 1)
    cache8_j, full_j = jtf.prefill(params_j, {"tokens": jnp.asarray(t8)}, jcfg)
    _, inc_j = jtf.decode_step(params_j, cache8_j, jnp.asarray(t8[:, 7:8]), jnp.int32(7), jcfg)
    cache8_t, full_t = ttf.prefill(params_t, {"tokens": torch.as_tensor(t8).long()}, tcfg)
    _, inc_t = ttf.decode_step(params_t, cache8_t, torch.as_tensor(t8[:, 7:8]).long(), 7, tcfg)
    _close(full_t, full_j)
    _close(inc_t, inc_j)
    np.testing.assert_allclose(inc_t.numpy(), full_t.numpy(), rtol=2e-3, atol=2e-3)


def test_vlm_patch_prefill_and_decode_match_reference():
    """Patches ahead of the prompt: logits, ``pos`` = S + P and 4 greedy
    decode steps at ``pos`` on, against the reference's."""
    jcfg, tcfg, params_j, params_t = _model("llava-next-mistral-7b")
    p, s, steps = jcfg.num_patch_tokens, 12, 4
    assert p == 8
    toks, patches = _tokens(jcfg.vocab_size, 1, s, 4), _patches(jcfg, 1, seed=5)
    cache_j, logits_j = jtf.prefill(
        params_j, {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)}, jcfg)
    cache_t, logits_t = ttf.prefill(
        params_t, {"tokens": torch.as_tensor(toks).long(),
                   "patch_embeds": torch.as_tensor(patches)}, tcfg)
    _close(logits_t, logits_j)
    assert cache_t["pos"] == int(cache_j["pos"]) == s + p and cache_t["k"].shape[2] == s + p
    pad = ((0, 0), (0, 0), (0, steps + 1), (0, 0), (0, 0))
    cache_j = dict(cache_j, k=jnp.pad(cache_j["k"], pad), v=jnp.pad(cache_j["v"], pad))
    want = []
    for step in range(steps + 1):
        cur = jnp.argmax(logits_j[:, -1], -1)[:, None].astype(jnp.int32)
        want.append(int(cur[0, 0]))
        if step < steps:
            cache_j, logits_j = jtf.decode_step(params_j, cache_j, cur,
                                                jnp.int32(s + p + step), jcfg)
    got, logits = dense_greedy_reference(tcfg, params_t, toks[0], steps + 1,
                                         patch_embeds=torch.as_tensor(patches), device="cpu")
    assert got == want
    np.testing.assert_array_equal(logits[0], logits_t[0, -1].numpy())


def _requests(pkg, prompts, max_new):
    return [pkg.Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]


def _both_engines(m, prompts, max_new):
    """The prompts through the reference's and the port's engine; asserts
    tokens, counters and the deterministic trace equal, returns the port's."""
    jcfg, tcfg, params_j, params_t = m
    je = J.PagedServingEngine(jcfg, params_j, J.EngineConfig(**GEO))
    je.serve(_requests(J, prompts, max_new))
    te = T.PagedServingEngine(tcfg, params_t, T.EngineConfig(**GEO), device="cpu")
    te.serve(_requests(T, prompts, max_new))
    assert te.results == je.results
    assert all(len(t) == max_new for t in te.results.values())
    assert te.metrics.counters() == je.metrics.counters()
    assert te.tracer.deterministic_jsonl() == je.tracer.deterministic_jsonl()
    return te


def test_vlm_served_on_tokens_like_the_reference():
    m = _model("llava-next-mistral-7b")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, m[0].vocab_size, size=n).astype(np.int32) for n in (9, 5, 13)]
    te = _both_engines(m, prompts, 5)
    for i, p in enumerate(prompts):
        assert te.results[i] == dense_greedy_reference(te.model_cfg, m[3], p, 5,
                                                       device="cpu")[0]


def test_gemma3_past_its_window_matches_reference():
    m = _model("gemma3-27b", num_layers=6)
    tcfg = m[1]
    assert tcfg.local_window == 16 and list(ttf.layer_windows_static(tcfg, 48)) == \
        [16] * 5 + [49]
    prompts = list(_tokens(tcfg.vocab_size, 2, 40, 7))
    te = _both_engines(m, prompts, 6)
    for i, p in enumerate(prompts):
        assert te.results[i] == dense_greedy_reference(te.model_cfg, m[3], p, 6,
                                                       device="cpu")[0]


def test_kimi_k2_planned_pmq_matches_reference():
    m = _model("kimi-k2-1t-a32b", planned=True)
    assert m[1].num_experts == 8 and "moe_ce" in m[3]["layers"][0]
    _both_engines(m, list(_tokens(m[0].vocab_size, 3, 11, 8)), 5)


def _leaves(params):
    """Every tensor of a ``build_synthetic`` tree, flattened in a fixed order."""
    out = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, cm.CompressedExperts):
            out.append(node.slot_of_expert)
            walk(node.arrays)
        elif isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])
        elif isinstance(node, (list, tuple)):
            for item in node:
                walk(item)
        elif isinstance(node, PackedTensor):
            walk((node.data, node.scale, node.zero))

    walk(params)
    return out


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"])
def test_sliced_expert_build_is_bytewise(arch, monkeypatch):
    """Buckets quantized in slices of 3 experts (the last one ragged) equal
    the one-shot build byte for byte: a bucket from tensors, and the whole
    ``build_synthetic`` tree from its seed."""
    cfg = tget_config(arch).reduced()
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    gen = torch.Generator().manual_seed(0)
    experts = {"w_gate": torch.randn(e, d, f, generator=gen),
               "w_up": torch.randn(e, d, f, generator=gen),
               "w_down": torch.randn(e, f, d, generator=gen)}
    bits = [1, 2, 2, 3, 2, 2, 2, 3][:e]
    makers = {k: (lambda w=w: w) for k, w in experts.items()}
    whole_ce = cm.build_compressed_experts(makers, bits)
    whole_tree = build_synthetic(cfg, seed=0, device="cpu")
    monkeypatch.setattr(cm, "SLICE_ELEMENTS", 3 * d * f)
    sliced_ce = cm.build_compressed_experts(makers, bits)
    sliced_tree = build_synthetic(cfg, seed=0, device="cpu")
    assert whole_ce.meta == sliced_ce.meta and max(m.count for m in whole_ce.meta) > 3
    for got, want in ((sliced_ce, whole_ce), (sliced_tree, whole_tree)):
        a, b = _leaves(got), _leaves(want)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
