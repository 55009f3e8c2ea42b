"""The port's dense and uncompressed-MoE serving against the JAX reference.

``TINY_DENSE`` (family ``dense``) and the uncompressed ``TINY_MOE`` are the
configs of ``tests/test_serving_sim.py``, initialised by the reference
``init_lm`` and carried into the port byte for byte by
``repro_torch.interop``. Held, f32 on the CPU:

* each ``_ffn_delta`` branch — the dense ``mlp`` and the uncompressed
  ``moe_layer`` — within 1e-5·max|Δx|, capacity dispatch ``dest``/``valid``
  byte-identical;
* the port's ``dense_greedy_reference`` against the reference's: identical
  tokens, per-step logits within 1e-4·max|logit|;
* the port's paged engine (``reserve_full=True``, H = 1 and 4) against the
  reference engine: identical greedy tokens and block tables, and the
  port's own dense oracle's tokens (paged == dense);
* a ``qk_norm`` config with 10 query and 2 KV heads (G = 5, as qwen3-14b's
  40 / 8) through both.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.engine import dense_greedy_reference as jdense_greedy  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import EngineConfig, PagedServingEngine, Request  # noqa: E402
from repro_torch.serving.engine import dense_greedy_reference  # noqa: E402

from _torch_interop import flatten_reference, torch_one_thread  # noqa: E402,F401

_SMALL = dict(dtype="float32", remat="none", logits_chunk=32)
TINY_DENSE = dict(name="tiny-sim-dense", family="dense", num_layers=2, d_model=32, num_heads=2,
                  num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64, attn_q_chunk=8,
                  attn_kv_chunk=8, **_SMALL)
TINY_MOE = dict(name="tiny-sim-moe", family="moe", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, head_dim=16, d_ff=128, d_ff_expert=64, vocab_size=128,
                num_experts=4, top_k=2, num_shared_experts=1, attn_q_chunk=16,
                attn_kv_chunk=16, **_SMALL)
TINY_QK_G5 = dict(name="tiny-qk-g5", family="dense", num_layers=2, d_model=40, num_heads=10,
                  num_kv_heads=2, head_dim=8, d_ff=96, vocab_size=96, qk_norm=True,
                  rope_theta=1e6, attn_q_chunk=8, attn_kv_chunk=8, **_SMALL)
MODELS = {"dense": TINY_DENSE, "moe": TINY_MOE, "qk_g5": TINY_QK_G5}
GEO = dict(max_slots=2, block_size=4, num_blocks=16, max_blocks_per_slot=6, prefill_chunk=4,
           reserve_full=True)
MAX_NEW = 5


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in (9, 5, 6)]


def _serve_with_tables(eng, prompts, make_request):
    """Serve ``prompts``: the outputs and each admission's ``(slot, block
    table row)``, recorded as the scheduler acquires the slot."""
    acquire, tables = eng.cache.acquire_slot, []

    def recorded(*args, **kw):
        slot = acquire(*args, **kw)
        tables.append((slot, np.asarray(eng.cache.block_tables)[slot].tolist()))
        return slot

    eng.cache.acquire_slot = recorded
    out = eng.serve(make_request(rid=i, prompt=p, max_new=MAX_NEW)
                    for i, p in enumerate(prompts))
    return out, tables


@pytest.fixture(scope="module", params=sorted(MODELS))
def served(request):
    """(reference cfg, port cfg, reference params, port params, the
    reference engine's outputs and admissions' block tables at H = 4) of
    one model."""
    jcfg, tcfg = ModelConfig(**MODELS[request.param]), TModelConfig(**MODELS[request.param])
    params_j = jget_model(jcfg).init(jax.random.PRNGKey(0))
    flat, meta = flatten_reference(params_j)
    params_t = interop.params_from_reference(flat, meta, device="cpu")
    jeng = JEngine(jcfg, params_j, JEngineConfig(decode_horizon=4, **GEO))
    out, tables = _serve_with_tables(jeng, _prompts(jcfg.vocab_size), JRequest)
    return jcfg, tcfg, params_j, params_t, out, tables


def test_qwen3_14b_config_matches_reference():
    assert dataclasses.asdict(tget_config("qwen3-14b")) == dataclasses.asdict(
        jget_config("qwen3-14b"))
    cfg = tget_config("qwen3-14b")
    assert cfg.num_heads // cfg.num_kv_heads == 5 and cfg.qk_norm


def test_interop_copies_uncompressed_bytes(served):
    jcfg, _, params_j, params_t, _, _ = served
    blocks = params_j["blocks"]
    layer = params_t["layers"][1]
    if jcfg.is_moe:
        for name in ("w_gate", "w_up", "w_down"):
            assert np.array_equal(layer["moe"]["experts"][name].numpy(),
                                  np.asarray(blocks["moe"]["experts"][name])[1])
        assert np.array_equal(layer["moe"]["router"]["w"].numpy(),
                              np.asarray(blocks["moe"]["router"]["w"])[1])
        assert np.array_equal(layer["moe"]["shared"]["w_down"]["w"].numpy(),
                              np.asarray(blocks["moe"]["shared"]["w_down"]["w"])[1])
        assert "moe_ce" not in layer
    else:
        assert np.array_equal(layer["mlp"]["w_up"]["w"].numpy(),
                              np.asarray(blocks["mlp"]["w_up"]["w"])[1])
    if jcfg.qk_norm:
        assert np.array_equal(layer["attn"]["k_norm"].numpy(),
                              np.asarray(blocks["attn"]["k_norm"])[1])


def _layer(params_j, l):
    return jax.tree.map(lambda a: a[l], params_j["blocks"])


def test_ffn_delta_matches_reference(served):
    """The branch of the model's family: Δx within 1e-5·max|Δx|, activation 1
    per token and empty dispatch counts, as the reference's; the aux term
    (which the port's ``_ffn_delta`` also returns, for ``train_loss``) 0 for
    a dense layer and the reference ``moe_layer``'s load-balance loss within
    1e-5 relative for an MoE one."""
    jcfg, tcfg, params_j, params_t, _, _ = served
    h = np.random.default_rng(1).standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    for l in range(jcfg.num_layers):
        want, jact, jcounts = jtf._ffn_delta(_layer(params_j, l), jnp.asarray(h), jcfg)
        got, act, counts, aux = ttf._ffn_delta(params_t["layers"][l], torch.from_numpy(h),
                                               tcfg)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
        assert np.array_equal(act.numpy(), np.asarray(jact))
        assert tuple(counts.shape) == tuple(jcounts.shape) == (0,)
        want_aux = (jmoe.moe_layer(_layer(params_j, l)["moe"], jnp.asarray(h), jcfg).aux_loss
                    if jcfg.is_moe else 0.0)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def moe_params():
    """(reference cfg, port cfg, reference params, port params) of the
    uncompressed TINY_MOE."""
    jcfg, tcfg = ModelConfig(**TINY_MOE), TModelConfig(**TINY_MOE)
    params_j = jget_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, params_j, interop.params_from_reference(*flatten_reference(params_j),
                                                                device="cpu")


@pytest.mark.parametrize("capacity_factor", [0.5, 4.0])
def test_moe_dispatch_byte_identical(moe_params, capacity_factor):
    """Uncompressed MoE routing and capacity dispatch, below the routed load
    (slots dropped) and at the drop-free capacity: ``dest``/``valid``
    byte-identical, the layer's output and expert FFN within 1e-5·max."""
    jcfg, tcfg, params_j, params_t = moe_params
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=capacity_factor)
    x = np.random.default_rng(2).standard_normal((3, 7, jcfg.d_model)).astype(np.float32)
    pj, pt = _layer(params_j, 0)["moe"], params_t["layers"][0]["moe"]
    x2 = x.reshape(-1, jcfg.d_model)
    _, jidx, jgates = jmoe.route_topk(pj["router"], jnp.asarray(x2), jcfg.top_k)
    _, idx, gates = tmoe.route_topk(pt["router"], torch.from_numpy(x2), tcfg.top_k)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    cap = tmoe.dispatch_capacity(tcfg, x2.shape[0])
    assert cap == jmoe.dispatch_capacity(jcfg, x2.shape[0])
    jxp, jdest, jvalid, _ = jmoe.capacity_dispatch(jnp.asarray(x2), jidx, jgates,
                                                   jcfg.num_experts, cap)
    xp, dest, valid, _ = tmoe.capacity_dispatch(torch.from_numpy(x2), idx, gates,
                                                tcfg.num_experts, cap)
    assert np.array_equal(dest.numpy().astype(np.int64), np.asarray(jdest).astype(np.int64))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    if capacity_factor < jcfg.num_experts:
        assert not valid.all()  # some slots dropped
    want = np.asarray(jmoe.expert_ffn(pj["experts"], jxp, jcfg.num_experts))
    got = tmoe.expert_ffn(pt["experts"], xp, tcfg.num_experts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    jout = jmoe.moe_layer(pj, jnp.asarray(x), jcfg)
    out = tmoe.moe_layer(pt, torch.from_numpy(x), tcfg)
    want = np.asarray(jout.y)
    np.testing.assert_allclose(out.y.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert float(out.aux_loss) == pytest.approx(float(jout.aux_loss), rel=1e-5)


def test_decode_attention_matches_reference(served):
    """One dense-cache decode step of attention: the new K/V row written at
    ``pos``, the output within 1e-5·max, with and without a window."""
    jcfg, tcfg, params_j, params_t, _, _ = served
    rng = np.random.default_rng(3)
    b, s = 2, 12
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((b, s, jcfg.num_kv_heads, jcfg.head_dim)).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    for pos, window in ((7, None), (9, 4)):
        want, (jk, jv) = jlayers.decode_attention(
            _layer(params_j, 0)["attn"], jnp.asarray(x), jcfg, k_cache=jnp.asarray(kc),
            v_cache=jnp.asarray(vc), pos=jnp.int32(pos), window=window)
        k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        got, (k_t, v_t) = tlayers.decode_attention(
            params_t["layers"][0]["attn"], torch.from_numpy(x), tcfg, k_cache=k_t, v_cache=v_t,
            pos=pos, window=window)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(k_t.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
        np.testing.assert_allclose(v_t.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


def test_dense_greedy_reference_matches_reference(served):
    """The dense-cache oracle: identical tokens, per-step logits within
    1e-4·max|logit|, at the engine's (drop-free) model config."""
    jcfg, tcfg, params_j, params_t, _, _ = served
    jm = JEngine(jcfg, params_j, JEngineConfig(**GEO)).model_cfg
    tm = PagedServingEngine(tcfg, params_t, EngineConfig(**GEO), device="cpu").model_cfg
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert (tm.moe_capacity_factor == tm.num_experts) if tcfg.is_moe else tm == tcfg
    prompt = _prompts(jcfg.vocab_size)[0]
    want_toks, want_logits = jdense_greedy(jm, params_j, prompt, MAX_NEW)
    toks, logits = dense_greedy_reference(tm, params_t, prompt, MAX_NEW, device="cpu")
    assert toks == want_toks
    for got, want in zip(logits, want_logits):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("horizon", [1, 4])
def test_engine_matches_reference_and_dense_oracle(served, horizon):
    """Three requests on two slots (the third admitted mid-flight), chunked
    prefill, fp KV, reserve_full: the reference engine's greedy tokens and
    block tables (each admission's slot and row), and the port's
    dense-cache oracle's tokens."""
    jcfg, tcfg, _, params_t, want, want_tables = served
    eng = PagedServingEngine(tcfg, params_t, EngineConfig(decode_horizon=horizon, **GEO),
                             device="cpu")
    prompts = _prompts(tcfg.vocab_size)
    got, tables = _serve_with_tables(eng, prompts, Request)
    assert got == want
    assert tables == want_tables and len(tables) == len(prompts)
    assert eng.cache.allocator.num_free == GEO["num_blocks"]
    s = eng.summary()
    assert s["expert_activation"] == 1.0 and s["decode_tokens"] == 3 * (MAX_NEW - 1)
    assert eng.last_slot_counts.shape == (horizon, tcfg.num_layers, 0)
    for i, p in enumerate(prompts):
        toks, _ = dense_greedy_reference(eng.model_cfg, params_t, p, MAX_NEW, device="cpu")
        assert got[i] == toks


def test_engine_families(served):
    """vlm is served (on tokens, as the reference's engine serves it), ssm is
    refused; drop-free expert capacity applies to MoE models only."""
    _, tcfg, _, params_t, _, _ = served
    eng = PagedServingEngine(tcfg, params_t, EngineConfig(**GEO), device="cpu")
    if tcfg.is_moe:
        assert eng.model_cfg.moe_capacity_factor == tcfg.num_experts
    else:
        assert eng.model_cfg is tcfg
    vcfg = dataclasses.replace(tcfg, family="vlm")
    prompt = _prompts(tcfg.vocab_size)[0]
    vlm = PagedServingEngine(vcfg, params_t, EngineConfig(**GEO), device="cpu")
    assert vlm.serve([Request(rid=0, prompt=prompt, max_new=MAX_NEW)]) == \
        eng.serve([Request(rid=0, prompt=prompt, max_new=MAX_NEW)])
    with pytest.raises(ValueError, match="families"):
        PagedServingEngine(dataclasses.replace(tcfg, family="ssm"), params_t, device="cpu")
