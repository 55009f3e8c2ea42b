"""The ``encdec`` (whisper-small), ``hybrid`` (recurrentgemma-2b) and ``ssm``
(xlstm-350m) families in the port, against the JAX reference on the CPU
(f32).

Each model is initialised once by the reference's ``init`` (seed 0) and
carried into the port byte for byte by ``repro_torch.interop``. Held, for
each reduced family and for two cases the reduced configs miss —
recurrentgemma at 5 layers (1 group and its 2 trailing recurrent blocks)
and xlstm on a 72-token prompt (the mLSTM's chunked scan):

* the configs equal the reference's field for field, full and reduced;
* ``prefill``: logits and every cache leaf within 1e-4·max of the
  reference's, ``pos`` equal;
* ``decode_step`` at ``pos − 1`` over the prefill's cache
  (``test_arch_smoke.py:85``): logits and cache within 1e-4·max; token 8
  decoded over the prefill of 8 (``:117``) within 1e-4·max;
* 4 greedy steps over the cache extended past the prompt (xlstm's cache
  has no ``k`` and needs none): the reference's tokens;
* ``train_loss`` within 1e-5 relative, every gradient within 1e-4·max of
  ``jax.grad``'s;
* the bundle's ``hidden`` gives the reference's prefill logits, and the
  teacher-forced forward over prompt and greedy tokens
  (``workload.teacher_forced_logits``) picks each token ``greedy_family``
  decoded, with its logits;
* the layers the families add: ``sinusoidal_positions``,
  ``attention(rope=False)`` and ``decode_attention(cross=True)``;
* the wave batcher (``BatchedServer``) on reduced recurrentgemma: the
  reference's tokens;
* ``params_from_checkpoint`` on checkpoints the reference wrote.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import workload  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.registry import get_model as tget_model  # noqa: E402
from repro_torch.models.transformer import extend_cache  # noqa: E402

from _torch_interop import torch_one_thread  # noqa: E402,F401

ARCHS = ["whisper-small", "recurrentgemma-2b", "xlstm-350m"]
#: (arch, layers or None for the reduced config's, prompt length)
CASES = [("whisper-small", None, 16), ("recurrentgemma-2b", None, 20),
         ("recurrentgemma-2b", 5, 20), ("xlstm-350m", None, 16), ("xlstm-350m", None, 72)]
CASE_IDS = ["whisper", "recurrentgemma", "recurrentgemma-tail", "xlstm", "xlstm-chunked"]
B, GREEDY = 2, 4


def _flat(tree, prefix=""):
    """``{path: np.ndarray}`` of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@functools.lru_cache(maxsize=None)
def _model(arch, num_layers=None):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = jget_config(arch).reduced()
    if num_layers:
        jcfg = dataclasses.replace(jcfg, num_layers=num_layers)
    params_j = jax.jit(jget_model(jcfg).init)(jax.random.PRNGKey(0))
    params_t = interop.params_from_reference(_flat(params_j), {}, device="cpu")
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg)), params_j, params_t


def _batches(cfg, s, seed=0, labels=False):
    """The same batch for both packages: tokens (and frames for whisper)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    host = {"tokens": toks}
    if cfg.family == "encdec":
        host["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if labels:
        host["labels"] = np.roll(toks, -1, axis=1)
    batch_j = {k: jnp.asarray(v) for k, v in host.items()}
    batch_t = {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
               for k, v in host.items()}
    return batch_j, batch_t


def _close(got, want, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if got.size:  # an empty leaf (recurrentgemma's tail without trailing blocks) has no max
        err = np.abs(got - want).max()
        assert err <= tol * np.abs(want).max(), err


def _close_cache(cache_t, cache_j):
    assert int(cache_t["pos"]) == int(cache_j["pos"])
    flat_t = _flat({k: v for k, v in cache_t.items() if k != "pos"})
    flat_j = _flat({k: v for k, v in cache_j.items() if k != "pos"})
    assert sorted(flat_t) == sorted(flat_j)
    for path, want in flat_j.items():
        _close(flat_t[path], want)


@functools.lru_cache(maxsize=None)
def _bundles(arch, num_layers):
    """(reference bundle with jitted members, port bundle, reference params,
    port params, reference cfg): one compile per shape, where the eager
    reference would retrace its scans on every call."""
    jcfg, tcfg, params_j, params_t = _model(arch, num_layers)
    jb = jget_model(jcfg)
    jb = dataclasses.replace(jb, prefill=jax.jit(jb.prefill),
                             decode_step=jax.jit(jb.decode_step),
                             train_loss=jax.jit(jb.train_loss))
    return jb, tget_model(tcfg), params_j, params_t, jcfg


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert dataclasses.asdict(tget_config(arch)) == dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(tget_config(arch).reduced()) == dataclasses.asdict(
        jget_config(arch).reduced())


@pytest.mark.parametrize("arch,layers,s", CASES, ids=CASE_IDS)
def test_prefill_matches_reference(arch, layers, s):
    jb, tb, params_j, params_t, cfg = _bundles(arch, layers)
    batch_j, batch_t = _batches(cfg, s)
    cache_j, logits_j = jb.prefill(params_j, batch_j)
    with torch.no_grad():
        cache_t, logits_t = tb.prefill(params_t, batch_t)
    _close(logits_t, logits_j)
    _close_cache(cache_t, cache_j)


@pytest.mark.parametrize("arch,layers,s", CASES, ids=CASE_IDS)
def test_decode_step_matches_reference(arch, layers, s):
    jb, tb, params_j, params_t, cfg = _bundles(arch, layers)
    batch_j, batch_t = _batches(cfg, s)
    cache_j, logits_j = jb.prefill(params_j, batch_j)
    with torch.no_grad():
        cache_t, _ = tb.prefill(params_t, batch_t)
        # decode over the prefill's cache, overwriting its last slot
        pos = cache_t["pos"] - 1
        tok = np.asarray(jnp.argmax(logits_j, axis=-1)).astype(np.int32)
        new_j, logits2_j = jb.decode_step(params_j, cache_j, jnp.asarray(tok), jnp.int32(pos))
        new_t, logits2_t = tb.decode_step(params_t, cache_t, torch.as_tensor(tok).long(), pos)
        _close(logits2_t, logits2_j)
        _close_cache(new_t, new_j)
        # token 8 decoded over the prefill of 8
        b8_j, b8_t = _batches(cfg, 8, seed=1)
        c8_j, full_j = jb.prefill(params_j, b8_j)
        _, inc_j = jb.decode_step(params_j, c8_j, b8_j["tokens"][:, 7:8], jnp.int32(7))
        c8_t, full_t = tb.prefill(params_t, b8_t)
        _, inc_t = tb.decode_step(params_t, c8_t, b8_t["tokens"][:, 7:8], 7)
    _close(full_t, full_j)
    _close(inc_t, inc_j)


@pytest.mark.parametrize("arch,layers,s", CASES, ids=CASE_IDS)
def test_greedy_over_extended_cache_matches_reference(arch, layers, s):
    jb, tb, params_j, params_t, cfg = _bundles(arch, layers)
    batch_j, batch_t = _batches(cfg, s, seed=2)
    cache_j, logits_j = jb.prefill(params_j, batch_j)
    with torch.no_grad():
        cache_t, logits_t = tb.prefill(params_t, batch_t)
    if "k" in cache_j:
        pad = ((0, 0), (0, 0), (0, GREEDY), (0, 0), (0, 0))
        cache_j = dict(cache_j, k=jnp.pad(cache_j["k"], pad), v=jnp.pad(cache_j["v"], pad))
        cache_t = extend_cache(cache_t, GREEDY)
    want, got = [], []
    for step in range(GREEDY):
        cur_j = jnp.argmax(logits_j[:, -1], -1)[:, None].astype(jnp.int32)
        cur_t = torch.argmax(logits_t[:, -1], dim=-1)[:, None]
        want.append(np.asarray(cur_j)[:, 0].tolist())
        got.append(cur_t[:, 0].tolist())
        cache_j, logits_j = jb.decode_step(params_j, cache_j, cur_j, jnp.int32(s + step))
        with torch.no_grad():
            cache_t, logits_t = tb.decode_step(params_t, cache_t, cur_t, s + step)
    assert got == want
    _close(logits_t, logits_j)


@pytest.mark.parametrize("arch,layers,s", CASES, ids=CASE_IDS)
def test_train_loss_and_gradients_match_jax_grad(arch, layers, s):
    jb, tb, params_j, params_t, cfg = _bundles(arch, layers)
    batch_j, batch_t = _batches(cfg, s, seed=3, labels=True)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: jb.train_loss(p, batch_j)[0]))(
        params_j)
    leaves = [t.detach().clone().requires_grad_() for t in tree_leaves(params_t)]
    loss_t, _ = tb.train_loss(tree_unflatten(params_t, leaves), batch_t)
    grads_t = torch.autograd.grad(loss_t, leaves)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    want = _flat(interop.params_from_reference(_flat(grads_j), {}, device="cpu"))
    got = _flat(tree_unflatten(params_t, grads_t))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        _close(got[path], w)


@pytest.mark.parametrize("arch,layers,s", CASES, ids=CASE_IDS)
def test_hidden_gives_the_reference_prefill_logits(arch, layers, s):
    jb, tb, params_j, params_t, cfg = _bundles(arch, layers)
    batch_j, batch_t = _batches(cfg, s, seed=4)
    _, logits_j = jb.prefill(params_j, batch_j)
    with torch.no_grad():
        hidden = tb.hidden(params_t, batch_t)
    assert tuple(hidden.shape) == (B, s, cfg.d_model)
    _close(hidden[:, -1:] @ params_t["embed"].t(), logits_j)


@pytest.mark.parametrize("arch,layers,s", CASES, ids=CASE_IDS)
def test_teacher_forced_logits_pick_the_greedy_tokens(arch, layers, s):
    _, tb, _, params_t, cfg = _bundles(arch, layers)
    _, batch_t = _batches(cfg, s, seed=5)
    toks, steps, _, _ = workload.greedy_family(cfg, params_t, batch_t, GREEDY)
    forced = workload.teacher_forced_logits(cfg, params_t, batch_t, toks)
    assert torch.equal(torch.argmax(forced, dim=-1), toks)
    _close(forced, steps.transpose(0, 1).numpy())


def test_sinusoidal_positions_match_reference():
    """Within 2e-4 absolute (the values lie in [−1, 1]): the exponents are
    equal, but torch's and XLA's f32 ``exp`` differ by an ulp on some
    frequencies, which moves the angle at position 1500 by up to 1500 ·
    2⁻²⁴ ≈ 9e-5 rad, beside the angle's own rounding (ulp(1500) / 2 ≈
    6e-5)."""
    pos = np.arange(0, 1500, 7, dtype=np.int32)
    for d in (128, 768):
        got = tlayers.sinusoidal_positions(torch.as_tensor(pos), d)
        want = jlayers.sinusoidal_positions(jnp.asarray(pos), d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)


def test_attention_without_rope_matches_reference():
    """Bidirectional attention without rotation, q and kv padded to their
    chunks (40 rows against chunks of 32), as whisper's encoder runs."""
    jcfg, tcfg, params_j, params_t = _model("whisper-small")
    p_j, p_t = params_j["enc_blocks"], params_t["enc_blocks"][0]
    p_j = jax.tree.map(lambda a: a[0], p_j)
    x = np.random.default_rng(4).normal(size=(B, 40, jcfg.d_model)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    for causal in (False, True):
        out_j, (k_j, v_j) = jlayers.attention(p_j["attn"], jnp.asarray(x), jcfg,
                                              positions=jnp.asarray(pos), causal=causal,
                                              rope=False)
        out_t, (k_t, v_t) = tlayers.attention(p_t["attn"], torch.as_tensor(x), tcfg,
                                              positions=torch.as_tensor(pos), causal=causal,
                                              rope=False)
        _close(out_t, out_j)
        _close(k_t, k_j)
        _close(v_t, v_j)


def test_cross_decode_attention_matches_reference():
    """``cross=True`` reads the cache only, over ``kv_len`` rows or all."""
    jcfg, tcfg, params_j, params_t = _model("whisper-small")
    p_j = jax.tree.map(lambda a: a[0], params_j["dec_blocks"]["cross"])
    p_t = params_t["dec_blocks"][0]["cross"]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    kc, vc = (rng.normal(size=(B, 16, jcfg.num_kv_heads, jcfg.head_dim)).astype(np.float32)
              for _ in range(2))
    for kv_len in (None, 11):
        out_j, (k_j, _) = jlayers.decode_attention(
            p_j, jnp.asarray(x), jcfg, k_cache=jnp.asarray(kc), v_cache=jnp.asarray(vc),
            pos=jnp.int32(3), cross=True, rope=False,
            kv_len=None if kv_len is None else jnp.int32(kv_len))
        k_t, v_t = torch.as_tensor(kc), torch.as_tensor(vc)
        out_t, (k_after, _) = tlayers.decode_attention(
            p_t, torch.as_tensor(x), tcfg, k_cache=k_t, v_cache=v_t, pos=3, cross=True,
            rope=False, kv_len=kv_len)
        _close(out_t, out_j)
        np.testing.assert_array_equal(k_after.numpy(), kc)  # read only


def test_wave_batcher_serves_recurrentgemma_like_the_reference():
    jcfg, tcfg, params_j, params_t = _model("recurrentgemma-2b")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32) for n in (20, 14, 9)]
    want = jserve.BatchedServer(jcfg, params_j, max_slots=2, prompt_len=20).serve(
        [jserve.Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)])
    got = tserve.BatchedServer(tcfg, params_t, max_slots=2, prompt_len=20, device="cpu").serve(
        [tserve.Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)])
    assert got == want


@pytest.mark.parametrize("arch,layers", [("xlstm-350m", None), ("recurrentgemma-2b", 5)])
def test_reference_checkpoint_opens_in_the_port(tmp_path, arch, layers):
    """A model the reference's checkpointer wrote reaches the port byte for
    byte (stacked groups and recurrentgemma's trailing list)."""
    _, _, params_j, params_t = _model(arch, layers)
    JCheckpointer(str(tmp_path), async_write=False).save(2, {"params": params_j})
    got = _flat(interop.params_from_checkpoint(Checkpointer(str(tmp_path)), 2, device="cpu"))
    want = _flat(params_t)
    assert sorted(got) == sorted(want)
    assert all(got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes()
               for k, w in want.items())
