"""OTP router training in the port (``repro_torch.core.otp``,
``repro_torch.core.otp_train``) against the reference on the CPU.

One reference model, the reduced ``moonshot-v1-16b-a3b`` compressed with a
fixed PMQ plan (``planned_blocks``: 1/2/2/3/2/2/3/2 bits, 4-bit attention
and shared experts), is built once and carried into the port byte for
byte. jax's random bits cannot be drawn in torch, so the port is handed
the reference's uniforms: the port's sampling takes either the uniforms or
a generator. Tolerances (f32 on both sides):

* ``sample_mask_gumbel``, the sampling branch of ``otp_mask`` and
  ``otp_losses`` on identical inputs and uniforms: masks equal, values
  within 1e-6;
* the router gradients of one Eq. 14 loss against ``jax.grad`` of the
  reference's ``loss_fn``: within 1e-4 · max|grad| per leaf;
* 3 ``train_otp`` steps on the reference's draws (its ``PRNGKey`` /
  ``split`` sequence replayed here): routers within 1e-4, history within
  1e-4 relative;
* ``tests/test_otp.py``'s properties, and a port-only mirror of
  ``test_otp_training_increases_mask_ratio_and_keeps_kl_low`` (the port's
  own pipeline compresses the port's own model): the mask ratio rises over
  30 steps and the KL stays finite.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core import otp as jotp  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.otp_train import OTPTrainConfig as JOTPTrainConfig  # noqa: E402
from repro.core.otp_train import init_otp_params as jinit_otp_params  # noqa: E402
from repro.core.otp_train import train_otp as jtrain_otp  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core import otp as totp  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core.otp_train import OTPTrainConfig, train_otp  # noqa: E402
from repro_torch.models.registry import get_model as tget_model  # noqa: E402

from _torch_interop import flatten_reference, planned_blocks, torch_one_thread  # noqa: E402,F401

ARCH = "moonshot-v1-16b-a3b"
BITS = [1, 2, 2, 3, 2, 2, 3, 2]
U_MIN, U_MAX = 1e-6, 1 - 1e-6


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _uniforms(key, shape) -> np.ndarray:
    return np.asarray(jax.random.uniform(key, shape, minval=U_MIN, maxval=U_MAX))


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config(ARCH).reduced()
    tcfg = tget_config(ARCH).reduced()
    _, blocks_j, top_j = planned_blocks(jcfg, BITS)
    stacked = dict(top_j, blocks=jtf.restack_blocks(blocks_j))
    params_t = interop.params_from_reference(*flatten_reference(stacked), device="cpu")
    top_t = {k: v for k, v in params_t.items() if k != "layers"}
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (6, 16)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, blocks_j=blocks_j, top_j=top_j,
                blocks_t=params_t["layers"], top_t=top_t, tokens=tokens)


# ------------------------------------------------------- Eq. 13 sampling
def test_sample_mask_gumbel_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((64, 6)).astype(np.float32) * 2
    key = jax.random.PRNGKey(4)
    u = _uniforms(key, logits.shape)
    for tau in (0.5, 1.0, 3.0):
        y_j, m_j = jotp.sample_mask_gumbel(key, jnp.asarray(logits), 6, tau)
        y_t, m_t = totp.sample_mask_gumbel(_t(u), _t(logits), 6, tau)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-6)
        np.testing.assert_array_equal(m_t.numpy() > 0.5, np.asarray(m_j) > 0.5)
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=1e-6)
        # the straight-through gradient: soft one-hot's, through the mask
        w = rng.standard_normal((64, 6)).astype(np.float32)
        g_j = jax.grad(lambda lg: jnp.sum(jotp.sample_mask_gumbel(key, lg, 6, tau)[1] * w))(
            jnp.asarray(logits))
        lt = _t(logits).requires_grad_()
        (g_t,) = torch.autograd.grad((totp.sample_mask_gumbel(_t(u), lt, 6, tau)[1]
                                      * _t(w)).sum(), lt)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-5)


def test_otp_mask_sampling_branch_matches_reference():
    rng = np.random.default_rng(1)
    t, d, k = 48, 32, 4
    p_j = jotp.init_otp_router(jax.random.PRNGKey(2), d, k)
    p_t = {n: _t(v) for n, v in p_j.items()}
    x2 = rng.standard_normal((t, d)).astype(np.float32)
    gates = rng.dirichlet(np.ones(k), size=t).astype(np.float32)
    idx = np.tile(np.arange(k), (t, 1)).astype(np.int32)
    key = jax.random.PRNGKey(5)
    m_j = jotp.otp_mask(p_j, jnp.asarray(x2), jnp.asarray(idx), jnp.asarray(gates),
                        rng=key, tau=0.7)
    m_t = totp.otp_mask(p_t, _t(x2), _t(idx), _t(gates), rng=_t(_uniforms(key, (t, k))),
                        tau=0.7)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=1e-6)
    assert 0 < float(m_t.mean()) < 1


def test_otp_losses_match_reference():
    rng = np.random.default_rng(2)
    s = rng.standard_normal((4, 8, 32)).astype(np.float32)
    t = rng.standard_normal((4, 8, 32)).astype(np.float32)
    m = rng.uniform(size=(100,)).astype(np.float32)
    loss_j, aux_j = jotp.otp_losses(jnp.asarray(s), jnp.asarray(t), jnp.asarray(m), lam=1.5)
    loss_t, aux_t = totp.otp_losses(_t(s), _t(t), _t(m), lam=1.5)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for key in ("kl", "mask_l1", "mask_ratio"):
        np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]), rtol=1e-6, atol=1e-7)
    assert abs(float(totp.mask_ratio(_t(m))) - float(jotp.mask_ratio(jnp.asarray(m)))) < 1e-6


# --------------------------------------------------- Eq. 14 gradients
def test_router_gradients_match_jax_grad(model):
    """One Eq. 14 loss as the reference's ``train_otp.loss_fn`` builds it:
    the student with Gumbel masks, the teacher without, under
    ``stop_gradient``; the routers' gradients on both sides."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    routers = jinit_otp_params(jax.random.PRNGKey(7), jcfg)
    batch = model["tokens"][:2]
    keys = jax.random.split(jax.random.PRNGKey(11), jcfg.num_layers)
    lam, tau = 2.0, 1.0

    def loss_fn(op):
        student, masks = jpipe.compressed_logits(
            model["blocks_j"], model["top_j"], jnp.asarray(batch), jcfg, otp_params=op,
            otp_rngs=list(keys), otp_tau=tau, collect_masks=True)
        teacher, _ = jpipe.compressed_logits(model["blocks_j"], model["top_j"],
                                             jnp.asarray(batch), jcfg)
        teacher = jax.lax.stop_gradient(teacher)
        mask_cat = jnp.concatenate([m.reshape(-1) for m in masks])
        return jotp.otp_losses(student, teacher, mask_cat, lam)[0]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(routers)
    t = batch.size
    ops_t = [{n: _t(v).requires_grad_() for n, v in p.items()} for p in routers]
    us = [_t(_uniforms(k, (t, jcfg.top_k))) for k in keys]
    tt = torch.as_tensor(batch, dtype=torch.long)
    student, masks = tpipe.compressed_logits(model["blocks_t"], model["top_t"], tt, tcfg,
                                             otp_params=ops_t, otp_rngs=us, otp_tau=tau,
                                             collect_masks=True)
    teacher, _ = tpipe.compressed_logits(model["blocks_t"], model["top_t"], tt, tcfg)
    assert not teacher.requires_grad
    loss_t, _ = totp.otp_losses(student, teacher, torch.cat([m.reshape(-1) for m in masks]),
                                lam)
    grads_t = torch.autograd.grad(loss_t, [v for p in ops_t for v in p.values()])
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    flat_j = [np.asarray(v) for p in grads_j for v in p.values()]
    for g_t, g_j in zip(grads_t, flat_j):
        assert np.abs(g_j).max() > 0
        assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max()


class ReplayDraws:
    """The reference ``train_otp``'s draws, replayed: ``PRNGKey(seed)`` split
    into the routers' key and then, per step, ``(rng, ks, kb)`` — the batch
    indices from ``kb``, each layer's uniforms from ``split(ks, L)``."""

    def __init__(self, jcfg, tcfg_j, n: int, seq: int):
        rng = jax.random.PRNGKey(tcfg_j.seed)
        rng, k0 = jax.random.split(rng)
        self._routers = [{n_: _t(v) for n_, v in p.items()}
                         for p in jinit_otp_params(k0, jcfg)]
        self._steps = []
        t = tcfg_j.batch * seq
        for _ in range(tcfg_j.steps):
            rng, ks, kb = jax.random.split(rng, 3)
            sel = np.asarray(jax.random.randint(kb, (tcfg_j.batch,), 0, n))
            us = [_t(_uniforms(k, (t, jcfg.top_k)))
                  for k in jax.random.split(ks, jcfg.num_layers)]
            self._steps.append((torch.from_numpy(sel.astype(np.int64)), us))

    def routers(self, cfg):
        return self._routers

    def step(self, step, n, batch, t, k, num_layers):
        sel, us = self._steps[step]
        assert len(sel) == batch and tuple(us[0].shape) == (t, k) and len(us) == num_layers
        return sel, us


def test_train_otp_replays_reference_draws(model):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    tokens = model["tokens"]
    kw = dict(steps=3, batch=2, lr=5e-3, lam=2.0, tau=1.0, seed=0)
    routers_j, hist_j = jtrain_otp(model["blocks_j"], model["top_j"], jcfg, tokens,
                                   JOTPTrainConfig(**kw))
    draws = ReplayDraws(jcfg, JOTPTrainConfig(**kw), *tokens.shape)
    routers_t, hist_t = train_otp(model["blocks_t"], model["top_t"], tcfg, tokens,
                                  OTPTrainConfig(**kw), draws=draws)
    for p_t, p_j in zip(routers_t, routers_j):
        assert not any(v.requires_grad for v in p_t.values())
        for name in ("fc1", "fc2"):
            np.testing.assert_allclose(p_t[name].numpy(), np.asarray(p_j[name]), atol=1e-4)
    for h_t, h_j in zip(hist_t, hist_j):
        assert h_t["step"] == h_j["step"]
        for key in ("loss", "kl", "mask_ratio"):
            np.testing.assert_allclose(h_t[key], h_j[key], rtol=1e-4, atol=1e-6)


def test_train_otp_default_draws_are_seeded(model):
    """Without replayed draws, one seed gives one run and another seed a
    different one; the routers come back detached."""
    kw = dict(steps=2, batch=2, lr=5e-3, lam=2.0)
    run = [train_otp(model["blocks_t"], model["top_t"], model["tcfg"], model["tokens"],
                     OTPTrainConfig(seed=s, **kw))[1] for s in (0, 0, 1)]
    assert run[0] == run[1] and run[0] != run[2]


# ------------------------------------------- tests/test_otp.py, in torch
def test_candidate_masks_eq10():
    expect = np.tril(np.ones((6, 6), np.float32))[::-1]
    np.testing.assert_array_equal(totp.candidate_masks(6).numpy(), expect)


def test_gumbel_tau_limit_approaches_onehot():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[2.0, 0.5, -1.0, 0.0]])
    u = totp.gumbel_uniforms(gen, logits.shape)
    for tau in (5.0, 0.01):
        y, _ = totp.sample_mask_gumbel(u, logits, 4, tau=tau)
        assert torch.allclose(y.sort(dim=-1).values[..., -1], torch.ones(1), atol=1e-5)
    g = -torch.log(-torch.log(u))
    soft_hi = torch.softmax((logits + g) / 5.0, -1)
    soft_lo = torch.softmax((logits + g) / 0.01, -1)
    assert soft_lo.max() > soft_hi.max() and soft_lo.max() > 0.999


def test_mask_sampling_distribution_follows_logits():
    logits = torch.tensor([[3.0, 0.0, 0.0, -3.0]]).repeat(4096, 1)
    _, mask = totp.sample_mask_gumbel(torch.Generator().manual_seed(1), logits, 4, tau=1.0)
    assert float(mask.mean()) > 0.7


def test_otp_mask_unsorts_back_to_slot_order():
    p = {"fc1": torch.zeros(8, 3), "fc2": torch.zeros(6, 3)}
    p["fc2"][:, -1] = 100.0  # the last candidate: keep only the strongest
    gates = torch.tensor([[0.2, 0.5, 0.3]])
    idx = torch.tensor([[4, 2, 7]])
    for rng in (None, torch.Generator().manual_seed(0)):
        mask = totp.otp_mask(p, torch.zeros(1, 8), idx, gates, rng=rng)
        np.testing.assert_array_equal(mask.detach().numpy(), [[0.0, 1.0, 0.0]])


def test_otp_losses_lambda_monotone():
    rng = np.random.default_rng(0)
    s, t = (_t(rng.normal(size=(4, 8, 16)).astype(np.float32)) for _ in range(2))
    m = _t(rng.uniform(size=(100,)).astype(np.float32))
    assert float(totp.otp_losses(s, t, m, lam=2.0)[0]) > float(totp.otp_losses(s, t, m, 1.0)[0])
    assert float(totp.otp_losses(s, s, m, lam=0.0)[0]) < 1e-5


def test_learnable_router_prefers_pruning_under_sparsity_pressure():
    gen = torch.Generator().manual_seed(3)
    k = 4
    p = {n: v.requires_grad_() for n, v in totp.init_otp_router(gen, 16, k).items()}
    x2 = torch.randn(64, 16, generator=gen)
    gates = torch.softmax(torch.randn(64, k, generator=gen), -1)
    gs = torch.gather(gates, -1, torch.argsort(-gates, dim=-1, stable=True))

    zero = torch.zeros(1, 2)

    def loss_fn(params, seed):  # the pure sparsity objective, Eq. 14's ℓ1 term
        logits = totp.dm_logits(params, x2, gs)
        _, mask = totp.sample_mask_gumbel(torch.Generator().manual_seed(seed), logits, k)
        return totp.otp_losses(zero, zero, mask, lam=1.0)[0]

    r0 = float(loss_fn(p, 0))
    for i in range(60):
        grads = torch.autograd.grad(loss_fn(p, i), list(p.values()))
        with torch.no_grad():
            for v, g in zip(p.values(), grads):
                v -= 0.5 * g
    assert float(loss_fn(p, 999)) < r0 - 0.1


CFG = dict(name="test-moe", family="moe", num_layers=2, d_model=128, num_heads=4,
           num_kv_heads=2, head_dim=32, d_ff=128, d_ff_expert=128, vocab_size=256,
           num_experts=8, top_k=2, num_shared_experts=1, dtype="float32", remat="none",
           logits_chunk=32, attn_q_chunk=32, attn_kv_chunk=32, moe_capacity_factor=2.0)


def test_otp_training_increases_mask_ratio_and_keeps_kl_low():
    """The port alone, as ``tests/test_compression_pipeline.py`` does it:
    the port's model (torch seed 0), calibrated, planned at 2 bits and
    compressed by the port's pipeline; 30 steps at λ = 2."""
    assert JModelConfig(**CFG).num_experts == TModelConfig(**CFG).num_experts
    cfg = TModelConfig(**CFG)
    params = tget_model(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)), dtype=torch.long)
    calib = tpipe.calibrate(params, tokens, cfg)
    eps = tpipe.compute_eps(params, calib, cfg)
    plan = tpipe.run_pmq(calib, eps, cfg, 2.0)
    blocks_c, top = tpipe.compress_model(params, calib, plan, cfg, use_gptq=False)
    data = np.random.default_rng(1).integers(0, cfg.vocab_size, (32, 32)).astype(np.int32)
    _, hist = train_otp(blocks_c, top, cfg, data,
                        OTPTrainConfig(steps=30, batch=4, lr=5e-3, lam=2.0, seed=0))
    r_first = np.mean([h["mask_ratio"] for h in hist[:5]])
    r_last = np.mean([h["mask_ratio"] for h in hist[-5:]])
    assert r_last > r_first, (r_first, r_last)
    assert np.isfinite(hist[-1]["kl"])
