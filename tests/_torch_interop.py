"""Test helpers shared by the ``test_torch_*`` files: flatten the JAX
package's serving parameters into the numpy form ``repro_torch.interop``
takes, and build the seeded reference models both sides serve."""
from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.compressed_moe import CompressedExperts
from repro.core.otp import init_otp_router
from repro.core.packing import PackedTensor


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
    otps = [init_otp_router(jax.random.PRNGKey(100 + l), cfg.d_model, cfg.top_k)
            for l in range(cfg.num_layers)]
    params_c["blocks"]["otp"] = jax.tree.map(lambda *xs: jnp.stack(xs), *otps)
    return params_c
