"""The port's MC# compression pipeline against the JAX reference.

The model is ``tests/test_compression_pipeline.py``'s config (2 layers,
d_model 128, 8 experts top-2, one shared expert, f32, capacity factor 2.0),
initialised by the reference ``init_lm`` and carried into the port byte for
byte by ``repro_torch.interop``; both sides calibrate on the same 4 × 64
tokens (numpy seed 0). Held, on the CPU:

* ``calibrate``: phi byte-equal; w, the MoE inputs and the final hidden
  states within 1e-5·max;
* ``compute_eps`` (128 tokens) within 1e-3 relative;
* ``allocate_block_dp`` / ``allocate_block_milp`` / ``allocate_model`` at
  targets 1.6 / 2.0 / 2.5 with ``layer_adaptive`` off and on: the
  reference's bits exactly, on the reference's eps and on the port's;
* the fake quantization of Eq. 6 (``quantize_to_packed(refine=False)``
  then ``PackedTensor.dequantize``), ``dequantize_affine`` and
  ``dequantize_binary``: byte-equal at 1-4 bits, K ending mid-group;
* ``gptq_quantize`` at 1-4 bits, groups 32 and 128, dead rows and K not a
  multiple of 128: codes byte-equal, scales and zeros within 1e-6;
* ``compress_model`` with and without GPTQ: every packed leaf equal and
  ``model_weight_bytes`` equal; ``compressed_forward`` within 1e-4·max,
  without and with argmax OTP routers;
* ``compress_for_serving``: the port's tree is the reference's (through
  ``interop``) and the port engine's greedy tokens on it are the reference
  engine's on the reference tree;
* ``serve --pmq --device cpu`` compresses with the pipeline and prints the
  plan (the reduced model's layer-0 budget is 17 bits over 8 experts).
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig  # noqa: E402
from repro.core import gptq as jgptq  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import pmq as jpmq  # noqa: E402
from repro.core import quantizers as jquant  # noqa: E402
from repro.core.compressed_moe import CompressedExperts as JCE  # noqa: E402
from repro.core.packing import PackedTensor as JPT  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core import gptq as tgptq  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import pmq as tpmq  # noqa: E402
from repro_torch.core import quantizers as tquant  # noqa: E402
from repro_torch.core.packing import PackedTensor as TPT  # noqa: E402
from repro_torch.serving import EngineConfig, PagedServingEngine, Request  # noqa: E402

from _torch_interop import flatten_reference, torch_one_thread  # noqa: E402,F401

CFG = dict(name="test-moe", family="moe", num_layers=2, d_model=128, num_heads=4,
           num_kv_heads=2, head_dim=32, d_ff=128, d_ff_expert=128, vocab_size=256,
           num_experts=8, top_k=2, num_shared_experts=1, dtype="float32", remat="none",
           logits_chunk=32, attn_q_chunk=32, attn_kv_chunk=32, moe_capacity_factor=2.0)
JCFG, TCFG = ModelConfig(**CFG), TModelConfig(**CFG)


@pytest.fixture(scope="module")
def model():
    """Both sides' params, calibration and Eq. 6 tables, built once."""
    params_j = jget_model(JCFG).init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, JCFG.vocab_size, (4, 64)).astype(np.int32)
    calib_j = jpipe.calibrate(params_j, jnp.asarray(tokens), JCFG)
    params_t = interop.params_from_reference(*flatten_reference(params_j), device="cpu")
    calib_t = tpipe.calibrate(params_t, torch.as_tensor(tokens, dtype=torch.long), TCFG)
    eps_j = jpipe.compute_eps(params_j, calib_j, JCFG, eps_tokens=128)
    eps_t = tpipe.compute_eps(params_t, calib_t, TCFG, eps_tokens=128)
    return dict(tokens=tokens, params_j=params_j, params_t=params_t, calib_j=calib_j,
                calib_t=calib_t, eps_j=eps_j, eps_t=eps_t)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def test_calibrate_matches_reference(model):
    cj, ct = model["calib_j"], model["calib_t"]
    assert np.array_equal(ct.phi, cj.phi)
    assert _rel(ct.w, cj.w) < 1e-5
    assert len(ct.moe_inputs) == len(cj.moe_inputs) == 2
    for got, want in zip(ct.moe_inputs, cj.moe_inputs):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert _rel(got.numpy(), want) < 1e-5
    assert _rel(ct.hidden_final.numpy(), cj.hidden_final) < 1e-5


def test_eps_matches_reference(model):
    eps_j, eps_t = model["eps_j"], model["eps_t"]
    assert eps_t.shape == eps_j.shape == (2, 8, 3)
    assert np.isfinite(eps_t).all()
    assert float(np.max(np.abs(eps_t - eps_j) / np.abs(eps_j))) < 1e-3
    assert (eps_t[..., 0] >= eps_t[..., 2]).mean() > 0.9  # more bits, less error


@pytest.mark.parametrize("layer_adaptive", [False, True])
@pytest.mark.parametrize("target", [1.6, 2.0, 2.5])
def test_pmq_plans_match_reference(model, target, layer_adaptive):
    cj, ct = model["calib_j"], model["calib_t"]
    for eps in (model["eps_j"], model["eps_t"]):
        want = jpmq.allocate_model(cj.phi, cj.w, eps, target, layer_adaptive=layer_adaptive)
        same = tpmq.allocate_model(cj.phi, cj.w, eps, target, layer_adaptive=layer_adaptive)
        own = tpmq.allocate_model(ct.phi, ct.w, eps, target, layer_adaptive=layer_adaptive)
        for got in (same, own):
            assert [b.tolist() for b in got.bits] == [b.tolist() for b in want.bits]
            assert got.layer_budgets.tolist() == want.layer_budgets.tolist()
            assert got.avg_bits == want.avg_bits
        assert same.objective == want.objective  # the same costs, the same sums
        for l in range(2):
            costs = tpmq.pmq_costs(cj.phi[l], cj.w[l], eps[l])
            budget = int(want.layer_budgets[l])
            for jfn, tfn in ((jpmq.allocate_block_dp, tpmq.allocate_block_dp),
                             (jpmq.allocate_block_milp, tpmq.allocate_block_milp)):
                assert tfn(costs, budget).tolist() == jfn(costs, budget).tolist()


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_fake_quant_matches_reference(bits):
    """What ``compute_eps`` substitutes for one expert, and the dequant
    helpers, at K = 200 (the last group is ragged)."""
    w = (np.random.default_rng(bits).standard_normal((200, 72)) * 0.1).astype(np.float32)
    want = jquant.quantize_to_packed(jnp.asarray(w), bits, group=128, refine=False)
    got = tquant.quantize_to_packed(torch.as_tensor(w), bits, group=128, refine=False)
    assert np.array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))
    assert got.dequantize(torch.bfloat16).dtype == torch.bfloat16
    codes, scale, zero = jquant.quantize_affine(jnp.asarray(w), max(bits, 2), 128)
    assert np.array_equal(
        tquant.dequantize_affine(*(torch.tensor(np.array(a)) for a in (codes, scale, zero)),
                                 128).numpy(),
        np.asarray(jquant.dequantize_affine(codes, scale, zero, 128)))
    b01, alpha = jquant.quantize_binary(jnp.asarray(w))
    assert np.array_equal(
        tquant.dequantize_binary(torch.tensor(np.array(b01)), torch.tensor(np.array(alpha)))
        .numpy(), np.asarray(jquant.dequantize_binary(b01, alpha)))


@pytest.mark.parametrize("k", [256, 200])
@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_gptq_matches_reference(bits, group, k):
    """Dead rows (never-activated inputs) and, at K = 200, a K that is not a
    multiple of the 128-row block or the group."""
    rng = np.random.default_rng(bits * 1000 + group + k)
    x = rng.standard_normal((300, k)).astype(np.float32)
    x[:, [5, 77]] = 0.0
    w = (rng.standard_normal((k, 96)) * 0.1).astype(np.float32)
    h = jgptq.hessian_from_inputs(x)
    assert np.array_equal(tgptq.hessian_from_inputs(torch.as_tensor(x)).numpy(), h)
    want = jgptq.gptq_quantize(w, h, bits, group)
    got = tgptq.gptq_quantize(torch.as_tensor(w), torch.as_tensor(h), bits, group)
    differ = int((got.codes.numpy() != want.codes).sum())
    print(f"bits {bits} group {group} K {k}: {differ} of {want.codes.size} codes differ")
    assert differ == 0
    assert got.scale.dtype == torch.float32 and got.codes.dtype == torch.uint8
    np.testing.assert_allclose(got.scale.numpy(), want.scale, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.zero.numpy(), want.zero, rtol=0, atol=1e-6)
    assert got.quant_error == pytest.approx(want.quant_error, rel=1e-9)


def _leaf_diffs(a, b) -> int:
    """Entries that differ between a reference tree and the port's (packed
    data, scales, zeros, bucket layout and plain tensors)."""
    if isinstance(a, JPT):
        assert isinstance(b, TPT) and (a.bits, tuple(a.shape), a.group) == (b.bits, b.shape,
                                                                            b.group)
        pairs = list(zip(a.data, b.data)) if a.bits == 3 else [(a.data, b.data)]
        pairs += [(a.scale, b.scale), (a.zero, b.zero)]
        return sum(int((np.asarray(x) != y.numpy()).sum()) for x, y in pairs)
    if isinstance(a, JCE):
        assert [(m.bits, m.start, m.count) for m in a.meta] == \
            [(m.bits, m.start, m.count) for m in b.meta]
        n = int((np.asarray(a.slot_of_expert) != b.slot_of_expert.numpy()).sum())
        for bk, bucket in a.arrays.items():
            for name, leaves in bucket.items():
                assert set(leaves) == set(b.arrays[bk][name])
                n += sum(int((np.asarray(v) != b.arrays[bk][name][key].numpy()).sum())
                         for key, v in leaves.items())
        return n
    if isinstance(a, dict):
        assert set(a) == set(b)
        return sum(_leaf_diffs(a[key], b[key]) for key in a)
    return int((np.asarray(a) != b.numpy()).sum())


@pytest.mark.parametrize("use_gptq", [False, True])
def test_compress_model_matches_reference(model, use_gptq):
    plan_j = jpipe.run_pmq(model["params_j"], model["calib_j"], JCFG, target_avg_bits=2.0,
                           eps=model["eps_j"])
    plan_t = tpipe.run_pmq(model["calib_t"], model["eps_t"], TCFG, 2.0)
    assert [b.tolist() for b in plan_t.bits] == [b.tolist() for b in plan_j.bits]
    blocks_j, top_j = jpipe.compress_model(model["params_j"], model["calib_j"], plan_j, JCFG,
                                           use_gptq=use_gptq, gptq_tokens=256)
    blocks_t, top_t = tpipe.compress_model(model["params_t"], model["calib_t"], plan_t, TCFG,
                                           use_gptq=use_gptq)
    assert sum(_leaf_diffs(a, b) for a, b in zip(blocks_j, blocks_t)) == 0
    assert _leaf_diffs(top_j, top_t) == 0
    assert tpipe.model_weight_bytes(blocks_t, top_t) == jpipe.model_weight_bytes(blocks_j, top_j)
    tokens = model["tokens"][:2]
    h_j, _ = jpipe.compressed_forward(blocks_j, top_j, jnp.asarray(tokens), JCFG)
    h_t, _ = tpipe.compressed_forward(blocks_t, top_t,
                                      torch.as_tensor(tokens, dtype=torch.long), TCFG)
    assert _rel(h_t.numpy(), h_j) < 1e-4
    lg_t, _ = tpipe.compressed_logits(blocks_t, top_t, torch.as_tensor(tokens, dtype=torch.long),
                                      TCFG)
    assert tuple(lg_t.shape) == (2, 64, JCFG.vocab_size) and torch.isfinite(lg_t).all()


def test_compressed_forward_argmax_otp_matches_reference(model):
    """``compressed_forward(otp_params=)``: per-layer OTP routers (numpy seed
    9) prune by their argmax mask as the reference's do; the routers drop
    some experts, so the hidden states move off the unpruned forward's."""
    plan_j = jpipe.run_pmq(model["params_j"], model["calib_j"], JCFG, target_avg_bits=2.0,
                           eps=model["eps_j"])
    plan_t = tpipe.run_pmq(model["calib_t"], model["eps_t"], TCFG, 2.0)
    blocks_j, top_j = jpipe.compress_model(model["params_j"], model["calib_j"], plan_j, JCFG,
                                           use_gptq=False)
    blocks_t, top_t = tpipe.compress_model(model["params_t"], model["calib_t"], plan_t, TCFG,
                                           use_gptq=False)
    rng = np.random.default_rng(9)
    d, k = JCFG.d_model, JCFG.top_k
    otp = [{"fc1": rng.standard_normal((d, k)).astype(np.float32),
            "fc2": (rng.standard_normal((2 * k, k)) * 4.0).astype(np.float32)}
           for _ in range(JCFG.num_layers)]
    tokens = model["tokens"][:2]
    h_j, masks = jpipe.compressed_forward(
        blocks_j, top_j, jnp.asarray(tokens), JCFG, collect_masks=True,
        otp_params=[{n: jnp.asarray(v) for n, v in p.items()} for p in otp])
    assert 0 < float(np.mean([np.asarray(m).mean() for m in masks])) < 1
    tt = torch.as_tensor(tokens, dtype=torch.long)
    h_t, masks_t = tpipe.compressed_forward(
        blocks_t, top_t, tt, TCFG, collect_masks=True,
        otp_params=[{n: torch.from_numpy(v) for n, v in p.items()} for p in otp])
    assert _rel(h_t.numpy(), h_j) < 1e-4
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(masks_t, masks))
    assert _rel(tpipe.compressed_forward(blocks_t, top_t, tt, TCFG)[0].numpy(), h_j) > 1e-3


def test_compress_for_serving_serves_the_reference_tokens(model):
    params_j, avg_j = jpipe.compress_for_serving(model["params_j"], model["calib_j"], JCFG)
    params_t, avg_t = tpipe.compress_for_serving(model["params_t"], model["calib_t"], TCFG)
    assert avg_t == avg_j == 17 / 8  # layer 0's budget round(2.05 · 16) // 2 + 1 over 8
    assert "otp" not in params_t["layers"][0]
    carried = interop.params_from_reference(*flatten_reference(params_j), device="cpu")
    for got, want in zip(params_t["layers"], carried["layers"]):
        assert _tree_equal(got, want)
    geo = dict(max_slots=2, block_size=16, num_blocks=16, max_blocks_per_slot=4,
               prefill_chunk=16, decode_horizon=4, reserve_full=True)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, JCFG.vocab_size, size=n).astype(np.int32) for n in (20, 33, 7)]
    want = JEngine(JCFG, params_j, JEngineConfig(**geo)).serve(
        JRequest(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts))
    got = PagedServingEngine(TCFG, params_t, EngineConfig(**geo), device="cpu").serve(
        Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts))
    assert got == want


def _tree_equal(a, b) -> bool:
    """Port trees equal leaf for leaf (packed leaves, buckets, tensors)."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, TPT):
        ta = list(a.data) if a.bits == 3 else [a.data]
        tb = list(b.data) if b.bits == 3 else [b.data]
        return (a.bits, a.shape, a.group) == (b.bits, b.shape, b.group) and all(
            torch.equal(x, y) for x, y in zip(ta + [a.scale, a.zero], tb + [b.scale, b.zero]))
    if hasattr(a, "meta"):  # CompressedExperts
        return a.meta == b.meta and torch.equal(a.slot_of_expert, b.slot_of_expert) and \
            _tree_equal(a.arrays, b.arrays)
    return torch.equal(a, b)


def test_serve_cli_pmq_compresses_with_the_pipeline(monkeypatch, capsys):
    """``--pmq --device cpu``: the reduced model from seed 0 is calibrated and
    compressed by the pipeline, not drawn by ``build_synthetic``; the plan is
    layer 0's 17 bits over 8 experts in both layers, 2.125 bits."""
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--pmq", "--requests", "2", "--max-new", "4",
                                      "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    plan = next(line for line in out.splitlines() if line.startswith("PMQ plan"))
    assert plan.endswith("average 2.1250 bits"), plan
    hist = eval(plan.split("histogram ")[1].split(", average")[0])
    assert sum(hist.values()) == 16 and sum(b * n for b, n in hist.items()) == 34, plan
    assert out.count("request ") >= 2
