"""Test helpers shared by the ``test_torch_*`` files: flatten the JAX
package's serving parameters into the numpy form ``repro_torch.interop``
takes, build the seeded reference models both sides serve, and keep each
port test module on one torch thread (:func:`torch_one_thread`, imported
by the modules that compute on the CPU)."""
from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compressed_moe import BucketMeta, CompressedExperts
from repro.core.otp import init_otp_router
from repro.core.packing import PackedTensor


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """Run a port test module on one torch thread. A parallel test run
    (pytest-xdist) puts several workers on one machine; torch's default
    pool of one thread per core then oversubscribes the cores, and its
    threads spin after every small op, slowing every worker's tests many
    times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flatten_reference(params) -> Tuple[Dict[str, np.ndarray], Dict]:
    """``(flat, meta)`` of a stacked reference serving tree (see
    :mod:`repro_torch.interop` for the key scheme)."""
    flat: Dict[str, np.ndarray] = {}
    meta: Dict = {"packed": {}, "num_layers": int(params["blocks"]["ln1"].shape[0])}

    def walk(node, path):
        if isinstance(node, PackedTensor):
            meta["packed"][path] = {"bits": node.bits, "shape": list(node.shape),
                                    "group": node.group}
            if node.bits == 3:
                flat[f"{path}/hi"], flat[f"{path}/lo"] = map(np.asarray, node.data)
            else:
                flat[f"{path}/data"] = np.asarray(node.data)
            flat[f"{path}/scale"] = np.asarray(node.scale)
            flat[f"{path}/zero"] = np.asarray(node.zero)
        elif isinstance(node, CompressedExperts):
            if node.resident_map is not None:
                raise ValueError("host-offloaded buckets are a later slice")
            meta["moe_ce"] = {
                "buckets": [[m.bits, m.start, m.count] for m in node.meta],
                "num_slots": node.num_slots, "group": node.group,
                "d_model": node.d_model, "d_ff": node.d_ff,
            }
            flat[f"{path}/slot_of_expert"] = np.asarray(node.slot_of_expert)
            walk(node.arrays, path)
        elif isinstance(node, dict):
            for key, value in node.items():
                walk(value, f"{path}/{key}" if path else key)
        else:
            flat[path] = np.asarray(node)

    walk(params, "")
    return flat, meta


def compressed_reference(cfg, seed: int = 0):
    """``cfg`` initialized from ``seed``, compressed by the reference
    ``compress_for_serving`` (calibrated layer-uniform PMQ, 4-bit attention
    and shared experts), with stacked OTP routers as ``tests/test_serving.py``
    builds them."""
    from repro.core import pipeline
    from repro.models.registry import get_model

    params = get_model(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32))
    calib = pipeline.calibrate(params, tokens, cfg)
    params_c, _ = pipeline.compress_for_serving(params, calib, cfg)
    return _with_otp(params_c, cfg)


def planned_blocks(cfg, bits, seed: int = 0, ep: int = 1):
    """``(params, blocks_c, top)``: ``cfg`` initialized from ``seed`` and its
    per-layer compressed blocks from the reference ``compress_model`` with
    the fixed layer-uniform PMQ plan ``bits`` (one width per expert; RTN +
    HQQ, no GPTQ, so no calibration pass), 4-bit attention and shared
    experts — the layout ``compressed_forward`` and ``train_otp`` take.
    ``ep`` pads the buckets to its multiples (expert parallelism)."""
    import types

    from repro.core import pipeline, pmq
    from repro.models.registry import get_model

    params = get_model(cfg).init(jax.random.PRNGKey(seed))
    bits = np.asarray(bits)
    plan = pmq.PMQPlan(bits=[bits] * cfg.num_layers, target_avg_bits=float(bits.mean()),
                       objective=0.0, layer_budgets=np.zeros(cfg.num_layers))
    no_calib = types.SimpleNamespace(
        moe_inputs=[np.zeros((1, cfg.d_model), np.float32)] * cfg.num_layers)
    blocks_c, top = pipeline.compress_model(params, no_calib, plan, cfg, use_gptq=False, ep=ep)
    return params, blocks_c, top


def planned_reference(cfg, bits, seed: int = 0, ep: int = 1):
    """The blocks of :func:`planned_blocks` in the stacked serving layout with
    OTP routers — the serving tree of :func:`compressed_reference` without
    its calibration and LP, at a third of the cost."""
    from repro.models import transformer as tf

    _, blocks_c, top = planned_blocks(cfg, bits, seed, ep)
    params_c = dict(top, blocks=tf.restack_blocks(blocks_c))
    return _with_otp(params_c, cfg)


def _with_otp(params_c, cfg):
    """Stacked OTP routers, as ``tests/test_serving.py`` builds them."""
    otps = [init_otp_router(jax.random.PRNGKey(100 + l), cfg.d_model, cfg.top_k)
            for l in range(cfg.num_layers)]
    params_c["blocks"]["otp"] = jax.tree.map(lambda *xs: jnp.stack(xs), *otps)
    return params_c


def reference_experts(ce):
    """The reference's ``CompressedExperts`` over the packed bytes of the
    port's ``ce`` (all-resident; the two builders are held byte for byte in
    ``tests/test_torch_ep.py``)."""
    return CompressedExperts(
        meta=tuple(BucketMeta(m.bits, m.start, m.count) for m in ce.meta),
        slot_of_expert=jnp.asarray(ce.slot_of_expert.numpy().astype(np.int32)),
        arrays={b: {n: {k: jnp.asarray(t.numpy()) for k, t in w.items()} for n, w in bw.items()}
                for b, bw in ce.arrays.items()},
        num_slots=ce.num_slots, group=ce.group, d_model=ce.d_model, d_ff=ce.d_ff)
