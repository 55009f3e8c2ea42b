"""The port's training substrate against the reference on the CPU:
``optim`` (AdamW, 32- and 8-bit state; ``warmup_cosine``), ``models``
(``init_lm``, ``train_loss``, ``chunked_xent`` / ``chunked_kl``),
``data.pipeline``, ``checkpoint.checkpointer``,
``runtime.fault_tolerance`` and ``launch.train``.

Tolerances (f32 on both sides): one ``adamw_update`` within 1e-6 with the
8-bit state's int8 codes equal; ``train_loss`` within 1e-5 relative and
its gradients within 1e-4 · max|grad| per leaf on the reference's own
parameters (carried by ``interop``) for a ``dense`` and a ``moe`` model;
the chunked losses within 1e-5 relative; the synthetic tokens byte for
byte. The rest mirrors ``tests/test_substrate.py`` on the port.
"""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.schedule import warmup_cosine as jwarmup_cosine  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer, flatten_with_paths  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.registry import get_model as tget_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FailurePolicy,
    ResilientLoop,
    StragglerMonitor,
)

from _torch_interop import flatten_reference, torch_one_thread  # noqa: E402,F401

_SMALL = dict(dtype="float32", remat="none", logits_chunk=8, attn_q_chunk=8, attn_kv_chunk=8)
MODELS = {
    "dense": dict(name="tiny-train-dense", family="dense", num_layers=2, d_model=32,
                  num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64, **_SMALL),
    "moe": dict(name="tiny-train-moe", family="moe", num_layers=2, d_model=32, num_heads=2,
                num_kv_heads=2, head_dim=16, d_ff=64, d_ff_expert=32, vocab_size=64,
                num_experts=4, top_k=2, num_shared_experts=1, **_SMALL),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, tol):
    want = np.asarray(want)
    assert np.abs(got.detach().numpy() - want).max() <= tol * max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("state_bits", [32, 8])
def test_adamw_update_matches_reference(state_bits):
    rng = np.random.default_rng(0)
    shapes = {"a": (300,), "b": (7, 33)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    cfg_j = jadamw.AdamWConfig(lr=0.01, state_bits=state_bits)
    cfg_t = tadamw.AdamWConfig(lr=0.01, state_bits=state_bits)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    p_t = {k: _t(v) for k, v in params.items()}
    s_j, s_t = jadamw.adamw_init(p_j, cfg_j), tadamw.adamw_init(p_t, cfg_t)
    for step, g in enumerate(grads):
        scale = 0.5 + step
        p_j, s_j = jadamw.adamw_update(p_j, {k: jnp.asarray(v) for k, v in g.items()}, s_j,
                                       cfg_j, jnp.float32(scale))
        p_t, s_t = tadamw.adamw_update(p_t, {k: _t(v) for k, v in g.items()}, s_t, cfg_t,
                                       torch.tensor(scale))
    assert int(s_t["step"]) == int(s_j["step"]) == 2
    for k in shapes:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]), atol=1e-6)
        for m in ("m", "v"):
            got, want = s_t["per_param"][k][m], s_j["per_param"][k][m]
            if state_bits == 8:
                np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
                np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("state_bits", [32, 8])
def test_adamw_converges(state_bits):
    target = _t(np.random.default_rng(0).normal(size=(16,)).astype(np.float32))
    params = {"w": torch.zeros(16)}
    cfg = tadamw.AdamWConfig(lr=0.05, weight_decay=0.0, state_bits=state_bits)
    opt = tadamw.adamw_init(params, cfg)
    for _ in range(200):
        params, opt = tadamw.adamw_update(params, {"w": 2 * (params["w"] - target)}, opt, cfg)
    assert float(((params["w"] - target) ** 2).sum()) < 0.05


def test_adamw_master_copy_bf16():
    params = {"w": torch.zeros(8, dtype=torch.bfloat16)}
    cfg = tadamw.AdamWConfig(lr=0.01, master=True, weight_decay=0.0)
    opt = tadamw.adamw_init(params, cfg)
    assert opt["per_param"]["w"]["master"].dtype == torch.float32
    p2, opt2 = tadamw.adamw_update(params, {"w": torch.ones(8, dtype=torch.bfloat16)}, opt, cfg)
    assert p2["w"].dtype == torch.bfloat16
    assert float(opt2["per_param"]["w"]["master"].abs().sum()) > 0


def test_adamw_8bit_moments_diverge_as_the_reference_does():
    """8-bit moments quantize ``v`` linearly per 128-block (absmax / 127),
    so a small ``v`` beside a large one rounds to code 0 while its ``m``
    keeps a code; a step whose gradient there is 0 (an embedding row absent
    from the batch) then moves the weight by ``lr · m̂ / eps``. The
    reference does this, and the port with it: one such step jumps by more
    than 1e3 · lr on both sides alike, and a wide-vocabulary model trained
    at lr 1e-3 climbs on both (the 32-bit run tracks the reference's
    losses within 1e-5 relative for 16 steps; the 8-bit runs agree until
    the first jump, then part)."""
    g1 = np.zeros((2, 128), np.float32)
    g1[0] = np.geomspace(1.0, 1e-3, 128)  # one row with a wide range, one row absent
    zero = np.zeros_like(g1)
    moved = {}
    for bits in (32, 8):
        cfg_j = jadamw.AdamWConfig(lr=1e-3, state_bits=bits, weight_decay=0.0)
        cfg_t = tadamw.AdamWConfig(lr=1e-3, state_bits=bits, weight_decay=0.0)
        p_j, p_t = {"w": jnp.zeros((2, 128))}, {"w": torch.zeros(2, 128)}
        s_j, s_t = jadamw.adamw_init(p_j, cfg_j), tadamw.adamw_init(p_t, cfg_t)
        for g in (g1, zero):
            before = p_t["w"].clone()
            p_j, s_j = jadamw.adamw_update(p_j, {"w": jnp.asarray(g)}, s_j, cfg_j)
            p_t, s_t = tadamw.adamw_update(p_t, {"w": _t(g)}, s_t, cfg_t)
        np.testing.assert_allclose(p_t["w"].numpy(), np.asarray(p_j["w"]), rtol=1e-6)
        moved[bits] = float((p_t["w"] - before).abs().max())
    assert moved[32] < 10 * 1e-3 and moved[8] > 1e3 * 1e-3, moved

    spec = dict(name="tiny-wide-vocab", family="dense", num_layers=1, d_model=32, num_heads=2,
                num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=4096, dtype="float32",
                remat="none", logits_chunk=64, attn_q_chunk=32, attn_kv_chunk=32)
    jcfg, tcfg = JModelConfig(**spec), TModelConfig(**spec)
    jbundle, tbundle = jget_model(jcfg), tget_model(tcfg)
    params_j0 = jbundle.init(jax.random.PRNGKey(0))
    flat, meta = flatten_reference(params_j0)
    loader = jdata.HostDataLoader(vocab=jcfg.vocab_size, global_batch=4, seq_len=32, seed=0)
    steps = 16
    for bits in (32, 8):
        cfg_j = jadamw.AdamWConfig(lr=1e-3, state_bits=bits)
        cfg_t = tadamw.AdamWConfig(lr=1e-3, state_bits=bits)

        @jax.jit
        def step_j(p, s, b):
            loss, g = jax.value_and_grad(lambda q: jbundle.train_loss(q, b)[0])(p)
            lr_scale = jwarmup_cosine(s["step"], warmup=10, total=steps + 1)
            return (*jadamw.adamw_update(p, g, s, cfg_j, lr_scale), loss)

        p_j, s_j = params_j0, jadamw.adamw_init(params_j0, cfg_j)
        p_t = interop.params_from_reference(flat, meta, device="cpu")
        s_t = tadamw.adamw_init(p_t, cfg_t)
        losses_j, losses_t = [], []
        for i in range(steps):
            b = loader.batch_at(i)
            p_j, s_j, loss_j = step_j(p_j, s_j, {k: jnp.asarray(v) for k, v in b.items()})
            p_t, s_t, loss_t = ttrain.train_step(tbundle.train_loss, p_t, s_t,
                                                 ttrain.batch_to(b, "cpu"), cfg_t, warmup=10,
                                                 total=steps + 1)
            losses_j.append(float(loss_j))
            losses_t.append(float(loss_t))
        print(f"{bits}-bit moments, lr 1e-3: reference {np.round(losses_j, 4).tolist()}, "
              f"port {np.round(losses_t, 4).tolist()}")
        if bits == 32:
            np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
            assert max(losses_j) < losses_j[0] + 0.1
        else:
            np.testing.assert_allclose(losses_t[:5], losses_j[:5], rtol=1e-5)
            assert max(losses_j) > losses_j[0] + 2.0 and max(losses_t) > losses_t[0] + 2.0


def test_warmup_cosine_matches_reference():
    for step in (0, 3, 10, 11, 57, 100, 140):
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32), warmup=10, total=100)
        want = jwarmup_cosine(jnp.int32(step), warmup=10, total=100)
        assert abs(float(got) - float(want)) < 1e-7


# ----------------------------------------------------------------- models
@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    spec = MODELS[request.param]
    jcfg, tcfg = JModelConfig(**spec), TModelConfig(**spec)
    params_j = jget_model(jcfg).init(jax.random.PRNGKey(0))
    flat, meta = flatten_reference(params_j)
    params_t = interop.params_from_reference(flat, meta, device="cpu")
    loader = jdata.HostDataLoader(vocab=jcfg.vocab_size, global_batch=2, seq_len=16, seed=1)
    return dict(jcfg=jcfg, tcfg=tcfg, params_j=params_j, params_t=params_t,
                batch=loader.batch_at(0))


def test_init_lm_has_the_reference_layout(model):
    """The port's ``init_lm`` makes the reference's tree (per layer), with
    its shapes and dtypes and its scales to within sampling error."""
    params_t = tget_model(model["tcfg"]).init(torch.Generator().manual_seed(0))
    carried = model["params_t"]

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype
            if a.numel() > 256:
                assert abs(float(a.std()) / float(b.std()) - 1) < 0.2

    walk(params_t, carried)


def test_train_loss_and_grads_match_reference(model):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    batch_j = {k: jnp.asarray(v) for k, v in model["batch"].items()}
    (loss_j, aux_j), grads_j = jax.value_and_grad(
        lambda p: jget_model(jcfg).train_loss(p, batch_j), has_aux=True)(model["params_j"])
    params_t = tree_map(lambda p: p.clone().requires_grad_(), model["params_t"])
    leaves = tree_leaves(params_t)
    loss_t, aux_t = tget_model(tcfg).train_loss(params_t, ttrain.batch_to(model["batch"], "cpu"))
    grads_t = tree_unflatten(params_t, torch.autograd.grad(loss_t, leaves))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(aux_t["aux"].detach()), float(aux_j["aux"]), rtol=1e-5,
                               atol=1e-7)
    if jcfg.is_moe:
        assert float(aux_j["aux"]) > 0
    flat_j, _ = flatten_reference(grads_j)
    want = interop.params_from_reference(flat_j, {"num_layers": jcfg.num_layers,
                                                  "packed": {}}, device="cpu")
    tree_map(lambda g, w: _close(g, w.numpy(), 1e-4), grads_t, want)


def test_chunked_losses_match_reference():
    rng = np.random.default_rng(4)
    hs, ht = (rng.standard_normal((2, 12, 16)).astype(np.float32) for _ in range(2))
    emb = rng.standard_normal((40, 16)).astype(np.float32)
    labels = rng.integers(-1, 40, (2, 12)).astype(np.int32)
    for chunk in (4, 5, 512):
        want = jlayers.chunked_xent(jnp.asarray(hs), jnp.asarray(emb), jnp.asarray(labels),
                                    chunk)
        got = tlayers.chunked_xent(_t(hs), _t(emb), _t(labels).long(), chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        want = jlayers.chunked_kl(jnp.asarray(hs), jnp.asarray(ht), jnp.asarray(emb), chunk)
        got = tlayers.chunked_kl(_t(hs), _t(ht), _t(emb), chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the streamed cross-entropy's gradient is the full one's
    h = _t(hs).requires_grad_()
    (g,) = torch.autograd.grad(tlayers.chunked_xent(h, _t(emb), _t(labels).long(), 4), h)
    gj = jax.grad(lambda x: jlayers.chunked_xent(x, jnp.asarray(emb), jnp.asarray(labels), 4))(
        jnp.asarray(hs))
    _close(g, gj, 1e-5)


def test_hidden_gives_the_reference_prefill_logits(model):
    """The bundle's ``hidden`` at the last position, through the output
    embedding, is the reference's prefill logits."""
    tokens = model["batch"]["tokens"]
    _, logits_j = jget_model(model["jcfg"]).prefill(model["params_j"],
                                                    {"tokens": jnp.asarray(tokens)})
    params_t = model["params_t"]
    with torch.no_grad():
        hidden = tget_model(model["tcfg"]).hidden(params_t,
                                                  {"tokens": torch.as_tensor(tokens).long()})
    assert tuple(hidden.shape) == (*tokens.shape, model["tcfg"].d_model)
    out = params_t.get("unembed", params_t["embed"])
    _close(hidden[:, -1:] @ out.t(), logits_j, 1e-4)


def test_model_bundle_refuses_other_families():
    """An unknown family is refused; the whisper, recurrentgemma and xlstm
    families build bundles (their parity: ``test_torch_arch_families.py``)."""
    with pytest.raises(ValueError, match="unknown family"):
        tget_model(TModelConfig(**dict(MODELS["dense"], family="diffusion")))
    for arch in ("whisper-small", "recurrentgemma-2b", "xlstm-350m"):
        bundle = tget_model(tget_config(arch).reduced())
        assert all(callable(f) for f in (bundle.init, bundle.train_loss, bundle.prefill,
                                         bundle.decode_step, bundle.hidden))


# ------------------------------------------------------------------- data
def test_synthetic_tokens_are_the_reference_bytes():
    for seed, host, step in ((0, 0, 0), (3, 1, 7), (11, 0, 2)):
        kw = dict(vocab=97, global_batch=4, seq_len=24, host_id=host, num_hosts=2, seed=seed)
        got = tdata.HostDataLoader(**kw).batch_at(step)
        want = jdata.HostDataLoader(**kw).batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()
    got = tdata.make_calibration_tokens(211, 5, 17, seed=9, corpus_seed=2)
    want = jdata.make_calibration_tokens(211, 5, 17, seed=9, corpus_seed=2)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_data_deterministic_per_step_and_host():
    kw = dict(vocab=100, global_batch=8, seq_len=16, num_hosts=2)
    a = tdata.HostDataLoader(host_id=0, **kw).batch_at(7)
    b = tdata.HostDataLoader(host_id=0, **kw).batch_at(7)
    c = tdata.HostDataLoader(host_id=1, **kw).batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


def test_synthetic_corpus_is_learnable_structure():
    """H(next | prev) well below uniform: structure a model can learn."""
    from collections import Counter

    seq = tdata.SyntheticLM(vocab=64, seed=0).sample(np.random.default_rng(0), 64, 64)
    pairs = Counter(zip(seq[:, :-1].reshape(-1), seq[:, 1:].reshape(-1)))
    uni = Counter(seq.reshape(-1))
    n = sum(pairs.values())
    h2 = -sum(c / n * np.log2(c / n) for c in pairs.values())
    h1 = -sum(c / seq.size * np.log2(c / seq.size) for c in uni.values())
    assert h2 - h1 < 0.8 * np.log2(64)


# ------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(8.0), "b": {"c": torch.ones(3, 3, dtype=torch.bfloat16)},
            "l": [torch.tensor(3, dtype=torch.int32)]}
    ckpt.save(5, tree, blocking=True)
    out = ckpt.restore(5, tree_map(torch.zeros_like, tree))
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), out, tree)


def test_checkpoint_keep_last_k_and_latest(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"x": torch.full((4,), float(s))})
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    assert torch.equal(ckpt.restore(4, {"x": torch.zeros(4)})["x"], torch.full((4,), 4.0))


def test_checkpoint_async_writer(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=3, async_write=True)
    for s in range(3):
        ckpt.save(s, {"x": torch.full((2,), float(s))})
    ckpt.wait()
    assert ckpt.all_steps() == [0, 1, 2]


def test_checkpoint_crash_safety_tmp_invisible(tmp_path):
    os.makedirs(tmp_path / "step_00000007.tmp")
    assert Checkpointer(str(tmp_path), async_write=False).latest_step() is None


def test_reference_checkpoint_restores_into_the_port(tmp_path, model):
    """What the reference's trainer writes — ``{"params", "opt"}`` at 8-bit
    state — opens in the port: its params through ``interop``'s mapping,
    byte for byte, and its 8-bit moments keyed as the port names them."""
    jcfg = model["jcfg"]
    opt_j = jadamw.adamw_init(model["params_j"], jadamw.AdamWConfig(state_bits=8))
    JCheckpointer(str(tmp_path), async_write=False).save(3, {"params": model["params_j"],
                                                            "opt": opt_j})
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.latest_step() == 3
    got = interop.params_from_checkpoint(ckpt, 3, device="cpu")
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), got,
                    model["params_t"])
    opt_t = tadamw.adamw_init(got, tadamw.AdamWConfig(state_bits=8))
    want = {f"opt/{k}" for k in flatten_with_paths(opt_t) if not k.startswith("per_param/layers")}
    keys = set(ckpt.arrays(3))
    assert want <= keys and "opt/per_param/embed/m/.q" in keys
    assert jcfg.num_layers == len(got["layers"])


# -------------------------------------------------------- fault tolerance
def test_straggler_monitor_flags_slow_host():
    mon = StragglerMonitor(window=8, threshold=1.5)
    for _ in range(8):
        for host in range(4):
            mon.record(host, 1.0 if host != 2 else 2.5)
    assert mon.stragglers() == [2]


def test_resilient_loop_restores_and_shrinks():
    calls = {"restore": 0, "shrink": 0}
    fails_at = {3, 4}

    def step(i):
        if i in fails_at:
            fails_at.remove(i)
            raise RuntimeError("node died")
        return {"step": i}

    loop = ResilientLoop(FailurePolicy(
        max_restarts=3, shrink_after=2,
        restore_fn=lambda: calls.__setitem__("restore", calls["restore"] + 1),
        shrink_fn=lambda: calls.__setitem__("shrink", calls["shrink"] + 1)))
    assert loop.run(step, start=0, steps=8) == {"step": 7}
    assert calls == {"restore": 2, "shrink": 1}
    assert [e.get("action") for e in loop.events] == [None, "restore", None, "shrink",
                                                      "restore"]


def test_resilient_loop_gives_up():
    loop = ResilientLoop(FailurePolicy(max_restarts=1))

    def bad(i):
        raise RuntimeError("always")

    with pytest.raises(RuntimeError, match="max_restarts"):
        loop.run(bad, 0, 3)


# ------------------------------------------------------------------ train
def test_train_reduced_trains_checkpoints_and_resumes(tmp_path, capsys, monkeypatch):
    """A few ``train_reduced`` steps of the reduced ``tinyllama-1.1b`` on the
    CPU: the loss falls, the last step is checkpointed, and a second call
    resumes there and stops at once with the same params."""
    assert tget_config("tinyllama-1.1b").reduced().family == "dense"
    t0 = time.perf_counter()
    kw = dict(steps=8, batch=2, seq=16, lr=3e-3, ckpt_dir=str(tmp_path), ckpt_every=4,
              device="cpu", log_every=4)
    params, hist = ttrain.train_reduced("tinyllama-1.1b", **kw)
    assert len(hist) == 8 and all(np.isfinite(hist)) and hist[-1] < hist[0]
    assert Checkpointer(str(tmp_path)).all_steps() == [3, 7]
    again, hist2 = ttrain.train_reduced("tinyllama-1.1b", **kw)
    assert hist2 == []
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), again,
                    params)
    assert "step     4 loss" in capsys.readouterr().out
    assert time.perf_counter() - t0 < 60
    # --coordinator joins a process group of one (RANK / WORLD_SIZE unset:
    # 0 and 1) at a local address, trains, and leaves the group
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    hist3 = ttrain.main(["--arch", "tinyllama-1.1b", "--steps", "1", "--batch", "2", "--seq",
                         "16", "--device", "cpu", "--coordinator", f"127.0.0.1:{port}"])
    assert len(hist3) == 1 and np.isfinite(hist3[0]) and not dist.is_initialized()
