"""The port's rematerialization (``cfg.remat``), its flash-style attention
backward, the recurrences' O(S) backward and the loss chunks' logits,
held to the reference on the CPU:

* (a) each family reduced with ``remat="block"`` on both sides — the dense
  transformer, whisper, recurrentgemma (with a trailing block), xlstm (two
  recomputed mLSTM chunks) and the PMQ + OTP MoE transformer's Eq. 14
  step on the reference's uniforms: the port's loss and gradients against
  the reference's ``jax.value_and_grad`` within 1e-5 × each leaf's max, and
  equal bit for bit to the port's own ``"none"``;
* (b) the OTP loss with its Gumbel noise drawn from a ``torch.Generator``:
  ``"block"``'s router gradients equal ``"none"``'s bit for bit — the
  uniforms are drawn before the recomputed MoE half — and a block that
  hands the generator to the recomputed region (a planted redraw of the
  noise) does not;
  ``train_otp``'s forward (``pipeline.compressed_logits``) likewise;
* (d) the sLSTM's and the mLSTM's backward bytes, counted on ``meta``,
  grow linearly in S (at most 2.1× from S to 2S);
* (e) a bf16 loss chunk's logits allocate no f32 copy of the table, forward
  or backward (counted on ``meta``; the previous product does), equal the
  previous product within 1e-6 × max on the CPU (the gradients within one
  bf16 rounding), and keep their shape on an empty microbatch.

``tests/test_torch_op_analysis.py`` holds ``"block"``'s counts on ``meta``
to its counts on CPU tensors.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.op_analysis import analyze_step  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.models.registry import get_model as tget_model  # noqa: E402

from _torch_interop import flatten_reference, torch_one_thread  # noqa: E402,F401

B = 2
#: (arch, layers or None for the reduced config's, sequence): 32-row
#: attention chunks, so every sequence sweeps 2 × 2 chunk pairs
FAMILIES = [("tinyllama-1.1b", None, 64), ("whisper-small", None, 64),
            ("recurrentgemma-2b", 5, 64), ("xlstm-350m", None, 72)]
TOL = 1e-5


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


def _port_tree(tree_j, cfg):
    """A reference tree (parameters or their gradients) in the port's layout."""
    if cfg.family in ("dense", "moe", "vlm"):
        return interop.params_from_reference(*flatten_reference(tree_j), device="cpu")
    return interop.params_from_reference(_flat(tree_j), {}, device="cpu")


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    if want.size:
        err = np.abs(got - want).max()
        assert err <= TOL * np.abs(want).max(), (what, err, np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _case(arch, layers, s):
    """(reference cfg under ``"block"``, its params — N(0, 0.1²) from numpy,
    no compiled init —, a batch for both)."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), remat="block")
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    rng = np.random.default_rng(5)
    params_j = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)
                                                  * 0.1), jget_model(jcfg).param_shapes())
    host = {"tokens": rng.integers(0, jcfg.vocab_size, (B, s)).astype(np.int32)}
    host["labels"] = np.roll(host["tokens"], -1, axis=1)
    if jcfg.family == "encdec":
        host["frames"] = rng.normal(size=(B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    return jcfg, params_j, host


def _port_grads(cfg, params, host):
    batch = {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
             for k, v in host.items()}
    leaves = [t.detach().clone().requires_grad_() for t in tree_leaves(params)]
    loss, _ = tget_model(cfg).train_loss(tree_unflatten(params, leaves), batch)
    return loss.detach(), tree_unflatten(params, torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("arch,layers,s", FAMILIES,
                         ids=["dense", "whisper", "recurrentgemma-tail", "xlstm-chunked"])
def test_block_step_matches_jax_grad_and_none_bitwise(arch, layers, s):
    jcfg, params_j, host = _case(arch, layers, s)
    jb = jget_model(jcfg)
    batch_j = {k: jnp.asarray(v) for k, v in host.items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: jb.train_loss(p, batch_j)[0]))(
        params_j)
    tcfg = TModelConfig(**dataclasses.asdict(jcfg))
    params_t = _port_tree(params_j, jcfg)
    loss_b, grads_b = _port_grads(tcfg, params_t, host)
    np.testing.assert_allclose(loss_b.item(), float(loss_j), rtol=TOL)
    want, got = _flat(_port_tree(grads_j, jcfg)), _flat(grads_b)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        _close(got[path], w, path)
    loss_n, grads_n = _port_grads(dataclasses.replace(tcfg, remat="none"), params_t, host)
    assert torch.equal(loss_n, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads_n), tree_leaves(grads_b)))


# ------------------------------------------------------ PMQ + OTP (Eq. 14)
def _random_frozen(jcfg, rng):
    """The reference's concrete compressed tree with numpy-seeded values
    (codes, scales in [0.01, 0.03], zeros in [0, 1.5], float leaves N(0,
    0.05²))."""
    def fill(path, a):
        a = np.asarray(a)
        if a.dtype == np.uint8:
            return jnp.asarray(rng.integers(0, 256, a.shape, dtype=np.uint8))
        if a.dtype.kind in "iu":
            return jnp.asarray(a)
        name = str(getattr(path[-1], "name", getattr(path[-1], "key", "")))
        if name == "scale":
            v = rng.uniform(0.01, 0.03, a.shape)
        elif name == "zero":
            v = rng.uniform(0.0, 1.5, a.shape)
        else:
            v = rng.standard_normal(a.shape) * 0.05
        return jnp.asarray(v.astype(np.float32)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(
        fill, jspecs.make_compressed_moe_params(jcfg, concrete=True))


@pytest.fixture(scope="module")
def otp_case():
    """kimi-k2 reduced (the reference's OTP arch) under ``"block"``: its
    frozen compressed tree, routers, tokens and key, and the port's."""
    jcfg = dataclasses.replace(jget_config("kimi-k2-1t-a32b").reduced(), remat="block")
    rng = np.random.default_rng(0)
    frozen = _random_frozen(jcfg, rng)
    otp = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)
                                             * 0.3), jspecs.make_otp_stacked(jcfg))
    tok = rng.integers(0, jcfg.vocab_size, (B, 32)).astype(np.int32)
    flat, meta = flatten_reference(frozen)
    port = (interop.params_from_reference(flat, meta, device="cpu"),
            interop.otp_from_reference({k: np.asarray(v) for k, v in otp.items()}, device="cpu"),
            torch.from_numpy(tok))
    return jcfg, frozen, otp, tok, port


def test_otp_step_matches_jax_grad_and_none_bitwise(otp_case):
    """The reference's OTP loss (``launch/steps.py``'s, λ = 1) and its
    router gradients against the port's ``otp_gradients`` on the same
    uniforms (one ``[T, k]`` block from the key for every layer)."""
    jcfg, frozen, otp, tok, (frozen_t, otp_t, tok_t) = otp_case
    key = jax.random.PRNGKey(3)
    emb = frozen.get("unembed", frozen["embed"])

    def loss_fn(op):
        params_s = dict(frozen, blocks=dict(frozen["blocks"], otp=op))
        hs, mask_l1, _ = jtf.forward_hidden(params_s, jnp.asarray(tok), jcfg,
                                            moe_hooks={"otp_rng": key, "otp_tau": 1.0})
        ht, _, _ = jtf.forward_hidden(frozen, jnp.asarray(tok), jcfg, moe_hooks={"use_otp": False})
        kl = jL.chunked_kl(hs, jax.lax.stop_gradient(ht), emb, jcfg.logits_chunk)
        return kl + mask_l1 / jcfg.num_layers

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(otp)
    u = torch.from_numpy(np.asarray(jax.random.uniform(
        key, (tok.size, jcfg.top_k), minval=1e-6, maxval=1.0 - 1e-6)))
    tcfg = TModelConfig(**dataclasses.asdict(jcfg))
    got = {}
    for remat in ("block", "none"):
        loss, _, grads = tsteps.otp_gradients(dataclasses.replace(tcfg, remat=remat), None, otp_t,
                                              frozen_t, {"tokens": tok_t}, u)
        got[remat] = (loss, grads)
    loss_b, grads_b = got["block"]
    np.testing.assert_allclose(loss_b.item(), float(loss_j), rtol=TOL)
    for k in ("fc1", "fc2"):
        _close(torch.stack([g[k] for g in grads_b]).numpy(), np.asarray(grads_j[k]), k)
    loss_n, grads_n = got["none"]
    assert torch.equal(loss_n, loss_b)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(grads_n, grads_b) for k in a)


def _generator_otp_grads(cfg, frozen, otp, tokens, seed=7):
    """The routers' gradients of Eq. 14 with the student's Gumbel noise
    drawn from a ``torch.Generator`` seeded ``seed``."""
    live = [{k: v.detach().clone().requires_grad_() for k, v in o.items()} for o in otp]
    student = dict(frozen, layers=[dict(p, otp=o) for p, o in zip(frozen["layers"], live)])
    hs, mask_l1, _ = tf.forward_hidden(student, tokens, cfg,
                                       otp_rng=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        ht, _, _ = tf.forward_hidden(frozen, tokens, cfg, use_otp=False)
    emb = frozen.get("unembed", frozen["embed"])
    loss = L.chunked_kl(hs, ht, emb, cfg.logits_chunk, cfg.vocab_size) + mask_l1 / cfg.num_layers
    return torch.autograd.grad(loss, [t for o in live for t in o.values()])


def _recomputed_region_block(p, x, cfg, *, positions, window, ffn_backend=None, **hooks):
    """A planted fault: the whole block under the recompute, the generator
    handed to the region, which draws from it again in the backward."""
    def whole(p, x):
        x, kv = tf._attn_half(p, x, cfg, positions, window)
        return (*tf._ffn_half(p, x, cfg, ffn_backend, **hooks), kv)

    return L.remat_block(cfg, whole, p, x)


def test_otp_generator_noise_is_drawn_once_under_block(otp_case, monkeypatch):
    jcfg, _, _, _, (frozen_t, otp_t, tok_t) = otp_case
    tcfg = TModelConfig(**dataclasses.asdict(jcfg))
    none = _generator_otp_grads(dataclasses.replace(tcfg, remat="none"), frozen_t, otp_t, tok_t)
    block = _generator_otp_grads(tcfg, frozen_t, otp_t, tok_t)
    assert all(torch.equal(a, b) for a, b in zip(none, block))
    monkeypatch.setattr(tf, "_block", _recomputed_region_block)
    redrawn = _generator_otp_grads(tcfg, frozen_t, otp_t, tok_t)
    assert not all(torch.equal(a, b) for a, b in zip(none, redrawn))


def test_compressed_forward_block_is_none_bitwise(otp_case):
    """``train_otp``'s forward (``pipeline.compressed_logits``), each layer's
    noise from a generator of its own: the routers' gradients of the
    student's logits under ``"block"`` equal ``"none"``'s bit for bit."""
    jcfg, _, _, _, (frozen_t, otp_t, tok_t) = otp_case
    blocks = frozen_t["layers"]
    top = {k: v for k, v in frozen_t.items() if k != "layers"}
    got = []
    for remat in ("none", "block"):
        cfg = dataclasses.replace(TModelConfig(**dataclasses.asdict(jcfg)), remat=remat)
        live = [{k: v.detach().clone().requires_grad_() for k, v in o.items()} for o in otp_t]
        gens = [torch.Generator().manual_seed(10 + l) for l in range(len(blocks))]
        logits, masks = pipeline.compressed_logits(blocks, top, tok_t, cfg, otp_params=live,
                                                   otp_rngs=gens, collect_masks=True)
        loss = logits.logsumexp(-1).mean() + torch.cat([m.reshape(-1) for m in masks]).mean()
        got.append(torch.autograd.grad(loss, [t for o in live for t in o.values()]))
    assert all(torch.equal(a, b) for a, b in zip(*got))


# ------------------------------------------------------ O(S) recurrences
def _meta(*shape):
    return torch.empty(shape, device="meta").requires_grad_()


def _backward_bytes(fn, args) -> float:
    """HBM bytes of ``fn``'s backward on ``meta``: forward and backward
    counted, less the forward."""
    def both(*a):
        return torch.autograd.grad(fn(*a).sum(), a)

    return analyze_step(both, args).hbm_bytes - analyze_step(fn, args).hbm_bytes


@pytest.mark.parametrize("block", ["slstm", "mlstm"])
def test_recurrent_backward_bytes_grow_linearly(block):
    """From S = 256 to 512 steps (4 to 8 recomputed mLSTM chunks) the
    backward's bytes grow at most 2.1×; a step that indexes the whole
    sequence would write a whole-sequence gradient a step (~4×)."""
    def run(s):
        if block == "slstm":
            args = tuple(_meta(2, s, 256) for _ in range(4))
            return _backward_bytes(lambda *a: X._slstm_seq(*a)[0], args)
        args = (_meta(2, s, 4, 64), _meta(2, s, 4, 64), _meta(2, s, 4, 64), _meta(2, s, 4),
                _meta(2, s, 4))
        return _backward_bytes(lambda *a: X._mlstm_scan(*a)[0], args)

    assert run(512) / run(256) <= 2.1


# ------------------------------------------------------ loss chunk logits
class _Allocs(TorchDispatchMode):
    """Every tensor an op makes: ``(shape, dtype)``."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.made += [(tuple(t.shape), t.dtype) for t in tree_flatten(out)[0]
                      if isinstance(t, torch.Tensor)]
        return out


def _previous_logits(h, w):
    """The loss chunks' product before: the whole table cast to f32."""
    return torch.matmul(h.to(w.dtype).float(), w.float().t())


@pytest.mark.parametrize("logits", [L._chunk_logits, _previous_logits],
                         ids=["chunk_logits", "previous"])
def test_chunk_logits_copy_no_f32_table(logits):
    """On ``meta``, forward and backward: no f32 tensor of the table's
    size is made (the previous product makes one, which this check sees)."""
    v, d = 20000, 256
    h = torch.empty(2, 8, d, dtype=torch.bfloat16, device="meta").requires_grad_()
    w = torch.empty(v, d, dtype=torch.bfloat16, device="meta").requires_grad_()
    with _Allocs() as seen:
        out = logits(h, w)
        torch.autograd.grad(out.logsumexp(-1).sum(), (h, w))
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 8, v)
    table = [s for s, dt in seen.made if dt == torch.float32 and int(np.prod(s)) >= v * d]
    assert (table == []) == (logits is L._chunk_logits), table


def test_chunk_logits_equal_the_previous_product():
    """bf16 operands on the CPU, three vocabulary blocks (the last one
    short): the f32 logits within 1e-6 × max; both bf16 gradients within
    one bf16 rounding at their max (2⁻⁸ × max: the f32 sums before the
    rounding run over the blocks in another order)."""
    gen = torch.Generator().manual_seed(0)
    v, d = 2 * L.VOCAB_BLOCK + 3616, 64
    h = torch.randn(2, 8, d, generator=gen).to(torch.bfloat16).requires_grad_()
    w = torch.randn(v, d, generator=gen).to(torch.bfloat16).requires_grad_()
    g = torch.randn(2, 8, v, generator=gen)
    got, want = L._chunk_logits(h, w), _previous_logits(h, w)
    assert got.dtype == torch.float32
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    for a, b in zip(torch.autograd.grad(got, (h, w), g), torch.autograd.grad(want, (h, w), g)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert (a.float() - b.float()).abs().max() <= 2**-8 * b.float().abs().max()


def test_chunk_logits_of_an_empty_microbatch():
    """A rank without rows of a microbatch runs its loss chunks empty: the
    bf16 logits are ``[0, c, V]`` on the CPU and on ``meta``."""
    for dev in ("cpu", "meta"):
        h = torch.zeros(0, 8, 64, dtype=torch.bfloat16, device=dev)
        w = torch.zeros(100, 64, dtype=torch.bfloat16, device=dev)
        assert tuple(L._chunk_logits(h, w).shape) == (0, 8, 100)
