"""The port's routing, OTP and compressed MoE layer against the JAX
reference on the CPU: integer artefacts (top-k ids, dispatch
``dest``/``valid``, slot fill and dispatch counts, OTP masks, packed expert
buckets) byte-equal, the layer output within 1e-5. The whole model is held
to the reference in ``test_torch_engine.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core import compressed_moe as jcm  # noqa: E402
from repro.core import otp as jotp  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.core import compressed_moe as tcm  # noqa: E402
from repro_torch.core import otp as totp  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

from _torch_interop import torch_one_thread  # noqa: E402,F401

T, D, E, K = 12, 32, 8, 3


def _routing_inputs(seed):
    rng = np.random.default_rng(seed)
    x2 = rng.standard_normal((T, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) * D**-0.5).astype(np.float32)
    otp = {"fc1": (rng.standard_normal((D, K)) * D**-0.5).astype(np.float32),
           "fc2": (rng.standard_normal((2 * K, K)) * (2 * K) ** -0.5).astype(np.float32)}
    return x2, router, otp


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.array_equal(got.astype(np.int64), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routing_dispatch_and_otp_byte_equal(seed):
    x2, router, otp = _routing_inputs(seed)
    jp, ji, jg = jmoe.route_topk({"w": jnp.asarray(router)}, jnp.asarray(x2), K)
    tp, ti, tg = tmoe.route_topk({"w": torch.from_numpy(router)}, torch.from_numpy(x2), K)
    _eq(ti, ji)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    # the same gates on both sides from here on, so masks compare exactly
    gates = np.array(jg)
    jm = jotp.otp_mask({k: jnp.asarray(v) for k, v in otp.items()}, jnp.asarray(x2), ji,
                       jnp.asarray(gates))
    tm = totp.otp_mask({k: torch.from_numpy(v) for k, v in otp.items()}, torch.from_numpy(x2),
                       ti, torch.from_numpy(gates))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert 0 < tm.numpy().mean() < 1  # the mask prunes something and keeps something
    for cap in (8, 16):
        jxp, jd, jv, jgf = jmoe.capacity_dispatch(jnp.asarray(x2), ji, jnp.asarray(gates), E,
                                                  cap, jm)
        txp, td, tv, tgf = tmoe.capacity_dispatch(torch.from_numpy(x2), ti,
                                                  torch.from_numpy(gates), E, cap, tm)
        _eq(td, jd)
        _eq(tv, jv)
        assert np.array_equal(txp.numpy(), np.asarray(jxp))
        assert np.array_equal(tgf.numpy(), np.asarray(jgf))
        _eq(tmoe.slot_fill_counts(td, tv, E, cap), jmoe.slot_fill_counts(jd, jv, E, cap))


def test_route_topk_ties_break_to_lower_index():
    """Exact ties in the router probabilities pick the lower expert id, as
    ``lax.top_k`` does."""
    x2 = np.ones((4, D), np.float32)
    router = np.zeros((D, E), np.float32)
    router[:, [1, 5]] = 0.1  # experts 1 and 5 tie for first, the rest tie
    _, ji, _ = jmoe.route_topk({"w": jnp.asarray(router)}, jnp.asarray(x2), K)
    _, ti, _ = tmoe.route_topk({"w": torch.from_numpy(router)}, torch.from_numpy(x2), K)
    _eq(ti, ji)


def _experts(rng, e, d, f):
    return {
        "w_gate": (rng.standard_normal((e, d, f)) * d**-0.5).astype(np.float32),
        "w_up": (rng.standard_normal((e, d, f)) * d**-0.5).astype(np.float32),
        "w_down": (rng.standard_normal((e, f, d)) * f**-0.5).astype(np.float32),
    }


@pytest.mark.parametrize("use_otp", [False, True])
def test_compressed_moe_layer(use_otp):
    cfg = dataclasses.replace(jget_config("moonshot-v1-16b-a3b").reduced(), d_model=D,
                              d_ff_expert=64, num_experts=E, top_k=K,
                              moe_capacity_factor=float(E))
    rng = np.random.default_rng(7)
    ex = _experts(rng, E, D, 64)
    bits = [1, 3, 2, 2, 4, 1, 3, 2]
    jce = jcm.build_compressed_experts(ex, bits, group=32, ep=1, refine=False)
    makers = {k: (lambda v=v: torch.from_numpy(v)) for k, v in ex.items()}
    tce = tcm.build_compressed_experts(makers, bits, group=32, refine=False)
    _eq(tce.slot_of_expert, jce.slot_of_expert)
    assert [dataclasses.astuple(m) for m in tce.meta] == [dataclasses.astuple(m)
                                                           for m in jce.meta]
    for b, bucket in jce.arrays.items():
        for name, arrs in bucket.items():
            for key, a in arrs.items():
                got = tce.arrays[b][name][key].numpy()
                assert np.array_equal(got, np.asarray(a)), (b, name, key)
    x2, router, otp = _routing_inputs(11)
    shared = {n: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
              for n, s in (("w_gate", (D, 64)), ("w_up", (D, 64)), ("w_down", (64, D)))}
    jp = {"router": {"w": jnp.asarray(router)},
          "shared": {n: {"w": jnp.asarray(w)} for n, w in shared.items()}}
    tp = {"router": {"w": torch.from_numpy(router)},
          "shared": {n: {"w": torch.from_numpy(w)} for n, w in shared.items()}}
    x = x2.reshape(2, T // 2, D)
    cw = np.arange(T) % 5 != 0
    jotp_params = {k: jnp.asarray(v) for k, v in otp.items()} if use_otp else None
    jy, jinfo = jax.jit(lambda xx: jcm.compressed_moe_layer(
        jp, jce, xx, cfg, otp_params=jotp_params, count_weight=jnp.asarray(cw),
        ffn_backend="ref"))(jnp.asarray(x))
    ty, tinfo = tcm.compressed_moe_layer(
        tp, tce, torch.from_numpy(x), cfg,
        otp_params={k: torch.from_numpy(v) for k, v in otp.items()} if use_otp else None,
        count_weight=torch.from_numpy(cw))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    _eq(tinfo["idx"], jinfo["idx"])
    _eq(tinfo["slot_counts"], jinfo["slot_counts"])
    if use_otp:
        assert np.array_equal(tinfo["mask"].numpy(), np.asarray(jinfo["mask"]))
