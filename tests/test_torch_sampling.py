"""Temperature sampling in the port's engine.

torch's generator cannot give ``jax.random``'s bits, so sampled tokens are
held within the port, on the CPU:

* ``temperature = 0`` is the greedy path: the reference engine's greedy
  tokens on ``tests/test_serving_sim.py``'s dense model (carried by
  ``interop``), whatever ``sample_seed`` says;
* the Gumbel-max draw follows ``softmax(logits / T)`` (chi-square over
  20,000 draws from a fixed 8-logit vector; the card's draws are held in
  ``tests/test_torch_kernels_cuda.py``);
* one seed gives the same tokens in two engines, another seed other tokens;
* a sampled run with host-offloaded experts (miss replays) gives the
  all-resident sampled run's tokens, since a replay re-seeds its draws;
* a sampled run's ``counters()`` are the reference engine's at the same
  temperature (with ``eos_id = -1`` the schedule ignores the tokens);
* a negative temperature is refused.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from scipy import stats  # noqa: E402

from repro.configs.base import ModelConfig  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core.synthetic import build_synthetic  # noqa: E402
from repro_torch.models.transformer import sample_gumbel  # noqa: E402
from repro_torch.serving import EngineConfig, PagedServingEngine, Request  # noqa: E402

from _torch_interop import flatten_reference, torch_one_thread  # noqa: E402,F401

TINY_DENSE = dict(name="tiny-sim-dense", family="dense", num_layers=2, d_model=32, num_heads=2,
                  num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64, attn_q_chunk=8,
                  attn_kv_chunk=8, dtype="float32", remat="none", logits_chunk=32)
GEO = dict(max_slots=2, block_size=4, num_blocks=12, max_blocks_per_slot=6, prefill_chunk=4,
           decode_horizon=4)
MAX_NEW = 8


@pytest.fixture(scope="module")
def dense():
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = ModelConfig(**TINY_DENSE)
    params_j = jget_model(jcfg).init(jax.random.PRNGKey(0))
    params_t = interop.params_from_reference(*flatten_reference(params_j), device="cpu")
    return jcfg, TModelConfig(**TINY_DENSE), params_j, params_t


@pytest.fixture(scope="module")
def pmq():
    """The reduced compressed model (PMQ buckets + OTP), port only."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    return cfg, build_synthetic(cfg, seed=0, device="cpu")


def _prompts(vocab, lengths=(9, 5, 6)):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


def _serve(cfg, params, **kw):
    eng = PagedServingEngine(cfg, params, EngineConfig(**dict(GEO, **kw)), device="cpu")
    out = eng.serve(Request(rid=i, prompt=p, max_new=MAX_NEW)
                    for i, p in enumerate(_prompts(cfg.vocab_size)))
    return out, eng


def test_temperature_zero_is_the_greedy_path(dense):
    jcfg, tcfg, params_j, params_t = dense
    want = JEngine(jcfg, params_j, JEngineConfig(**GEO)).serve(
        JRequest(rid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(_prompts(64)))
    for seed in (0, 5):
        got, _ = _serve(tcfg, params_t, temperature=0.0, sample_seed=seed)
        assert got == want
    assert EngineConfig().temperature == 0.0 and EngineConfig().sample_seed == 0


def test_gumbel_max_draws_follow_the_softmax():
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.25])
    t, n = 0.8, 20_000
    gen = torch.Generator().manual_seed(0)
    draws = sample_gumbel(logits.expand(n, 8), t, gen)
    observed = np.bincount(draws.numpy(), minlength=8)
    expected = torch.softmax(logits.double() / t, dim=-1).numpy() * n
    p = stats.chisquare(observed, expected).pvalue
    assert p > 1e-3, (observed, expected, p)


def test_sampling_is_deterministic_per_seed(dense):
    _, tcfg, _, params_t = dense
    a, _ = _serve(tcfg, params_t, temperature=0.8, sample_seed=0)
    b, _ = _serve(tcfg, params_t, temperature=0.8, sample_seed=0)
    c, _ = _serve(tcfg, params_t, temperature=0.8, sample_seed=1)
    greedy, _ = _serve(tcfg, params_t)
    assert a == b
    assert a != c and a != greedy
    assert all(len(v) == MAX_NEW for v in a.values())


def test_sampled_offload_replays_draw_the_resident_tokens(pmq):
    cfg, params = pmq
    resident, _ = _serve(cfg, params, temperature=0.8, sample_seed=3, decode_horizon=2)
    offloaded, eng = _serve(cfg, params, temperature=0.8, sample_seed=3, decode_horizon=2,
                            resident_experts=3)
    c = eng.metrics.counters()
    assert c["expert_miss_uploads"] > 0 and c["decode_replays"] > 0  # replays happened
    assert offloaded == resident


def test_sampled_counters_are_the_reference_schedule(dense):
    jcfg, tcfg, params_j, params_t = dense
    kw = dict(num_blocks=6, reserve_full=False, temperature=0.8, sample_seed=2)
    jeng = JEngine(jcfg, params_j, JEngineConfig(**dict(GEO, **kw)))
    jeng.serve(JRequest(rid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(_prompts(64)))
    _, teng = _serve(tcfg, params_t, **kw)
    want, got = jeng.metrics.counters(), teng.metrics.counters()
    assert got == want
    assert got["preemptions"]  # the short pool made the schedule preempt


def test_negative_temperature_is_refused(dense):
    _, tcfg, _, params_t = dense
    with pytest.raises(ValueError, match="temperature"):
        PagedServingEngine(tcfg, params_t, EngineConfig(temperature=-0.5), device="cpu")
    assert dataclasses.replace(EngineConfig(), temperature=0.5).temperature == 0.5
