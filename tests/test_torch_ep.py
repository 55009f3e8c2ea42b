"""The port's expert-parallel pieces in one process, against the JAX reference.

Byte for byte: ``param_spec_for_path`` over every registered config's
reduced parameter tree (``jax.eval_shape`` of the reference's ``init``) and
the compressed tree's packed leaves, ``make_param_shardings`` on a 2 × 4
mesh shape, ``cache_pspec``, ``activation_rules``, ``_slot_tables``,
``build_compressed_experts(ep=4)`` (meta, ``slot_of_expert``, packed
leaves) and ``quantize_grad``. Within tolerance: the ``scan`` expert FFN on
the fuzzed cases of ``tests/test_moe_grouped.py:61``, the ``ep > 1`` reshape
against ``ep = 1`` (``:147``); ``_ep_fallback``'s warning and its
``REPRO_STRICT_EP=1`` error. Also: ``interop`` carries padded buckets; a
reference checkpoint restores with ``shardings=`` into each rank's slices;
the engine serves the reference's ``scan`` tokens all-resident and
offloaded; ``launch.train --coordinator`` trains at world size 1.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core import compressed_moe as jcm  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.parallel import ep_shardmap as jep  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import compressed_moe as tcm  # noqa: E402
from repro_torch.core.tree import tree_paths  # noqa: E402
from repro_torch.models.moe import capacity_dispatch, slot_fill_counts  # noqa: E402
from repro_torch.optim import grad_compress as tgc  # noqa: E402
from repro_torch.parallel import ep_shardmap as tep  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.serving import EngineConfig, PagedServingEngine, Request  # noqa: E402

from _torch_interop import (  # noqa: E402,F401
    flatten_reference, planned_reference, reference_experts, torch_one_thread)

SRC = Path(__file__).resolve().parents[1] / "src"
MODEL_BITS = [1, 2, 2, 2, 2, 3, 3, 2]


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jsh._path_str(path), leaf) for path, leaf in flat]


def _stacked(path: str) -> bool:
    return any(path.startswith(p) for p in jsh.STACKED_PREFIXES)


@pytest.fixture(scope="module")
def shapes():
    """Each registered config's reduced parameter tree, as shapes."""
    return {a: jax.eval_shape(jget_model(jget_config(a).reduced()).init, jax.random.PRNGKey(0))
            for a in ARCH_IDS}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_for_path_matches_reference(shapes, arch):
    for path, leaf in _ref_paths(shapes[arch]):
        want = tuple(jsh.param_spec_for_path(path, leaf.ndim, _stacked(path)))
        assert tsh.param_spec_for_path(path, leaf.ndim, _stacked(path)) == want, path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_param_shardings_match_reference_on_2x4(shapes, arch):
    """Every leaf's spec on a ``data=2 × model=4`` mesh shape, replicated
    where a dim does not divide, as the reference's."""
    want = {p: tuple(s.spec) for p, s in _ref_paths(
        jsh.make_param_shardings(AbstractMesh((2, 4), ("data", "model")), shapes[arch]))}
    got = tsh.make_param_shardings(tsh.Mesh(("data", "model"), (2, 4)), shapes[arch])
    assert {"/".join(map(str, p)): s.spec for p, s in tree_paths(got)} == want


@pytest.fixture(scope="module")
def padded_model():
    """The reduced moonshot compressed by the reference with ``ep=4`` (PMQ
    1 / 5 / 2 experts padded to buckets of 4 / 8 / 4), with OTP routers, and
    its port carried by ``interop``."""
    cfg = jget_config("moonshot-v1-16b-a3b").reduced()
    params_j = planned_reference(cfg, MODEL_BITS, ep=4)
    flat, meta = flatten_reference(params_j)
    return cfg, params_j, interop.params_from_reference(flat, meta, device="cpu")


def test_param_spec_for_packed_leaves_matches_reference(padded_model):
    """The compressed serving tree: PackedTensor children (``/0``, ``/1``)
    and the buckets (``moe_ce/...``)."""
    _, params_j, _ = padded_model
    paths = _ref_paths(params_j)
    assert any(p.endswith("wq/w/0") for p, _ in paths)
    assert any("moe_ce/1/b0/w_gate" in p for p, _ in paths)
    for path, leaf in paths:
        want = tuple(jsh.param_spec_for_path(path, leaf.ndim, _stacked(path)))
        assert tsh.param_spec_for_path(path, leaf.ndim, _stacked(path)) == want, path


class _StubMesh:
    """A mesh shape for the reference's ``cache_pspec`` and
    ``activation_rules`` (no devices)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = [{"data": 2, "model": 4}, {"data": 4, "model": 2}, {"data": 1, "model": 4},
          {"pod": 2, "data": 2, "model": 4}]


@pytest.mark.parametrize("shape", MESHES)
def test_cache_pspec_and_activation_rules_match_reference(shape):
    jm, tm = _StubMesh(shape), tsh.Mesh(tuple(shape), tuple(shape.values()))
    for sp in (True, False):
        want = {k: tuple(v) for k, v in jsh.activation_rules(jm, sp).items()}
        assert tsh.activation_rules(tm, sp) == want
    for cache in [(2, 8, 64, 8, 32), (2, 8, 64, 3, 32), (2, 8, 63, 3, 32), (2, 1, 64, 8, 32),
                  (2, 1, 64, 3, 32), (2, 1, 66, 3, 32), (2, 1, 63, 3, 32), (2, 3, 64, 8, 32)]:
        for prefer in ("batch", "sequence"):
            assert tsh.cache_pspec(tm, cache, prefer) == \
                tuple(jsh.cache_pspec(jm, cache, prefer)), (cache, prefer)


def _experts(e, d, f, seed=0):
    rng = np.random.default_rng(seed)
    return {"w_gate": rng.normal(size=(e, d, f)).astype(np.float32),
            "w_up": rng.normal(size=(e, d, f)).astype(np.float32),
            "w_down": rng.normal(size=(e, f, d)).astype(np.float32)}


def _tbuild(experts, bits, **kw):
    return tcm.build_compressed_experts(
        {k: (lambda k=k: torch.from_numpy(experts[k].copy())) for k in experts}, bits, **kw)


def test_build_compressed_experts_ep_matches_reference():
    """``ep=4`` pads each bucket with copies of its last expert: meta,
    ``slot_of_expert`` and every packed leaf byte for byte."""
    experts = _experts(8, 64, 128, seed=2)
    bits = np.array([1, 2, 2, 2, 2, 3, 3, 2])
    want = jcm.build_compressed_experts(experts, bits, group=64, ep=4, refine=False)
    got = _tbuild(experts, bits, group=64, ep=4, refine=False)
    assert [(m.bits, m.start, m.count) for m in got.meta] == \
        [(m.bits, m.start, m.count) for m in want.meta] == [(1, 0, 4), (2, 4, 8), (3, 12, 4)]
    assert got.num_slots == want.num_slots == 16
    np.testing.assert_array_equal(got.slot_of_expert.numpy(), np.asarray(want.slot_of_expert))
    for b, bw in want.arrays.items():
        for n, w in bw.items():
            for k, a in w.items():
                np.testing.assert_array_equal(got.arrays[b][n][k].numpy(), np.asarray(a))
    b0 = got.arrays["b0"]["w_gate"]["data"]  # the 1-bit bucket: one expert, three clones
    assert all(torch.equal(b0[i], b0[0]) for i in range(4))


@pytest.mark.parametrize("model", [1, 2, 4])
def test_slot_tables_match_reference(model):
    meta = (tcm.BucketMeta(1, 0, 4), tcm.BucketMeta(2, 4, 8), tcm.BucketMeta(3, 12, 4))
    jmeta = tuple(jcm.BucketMeta(m.bits, m.start, m.count) for m in meta)
    for got, want in zip(tep._slot_tables(meta, model), jep._slot_tables(jmeta, model)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_quantize_grad_matches_reference():
    g = np.random.default_rng(0).normal(size=(3, 301)).astype(np.float32)
    g[0, :7] = 0.0
    q, s = tgc.quantize_grad(torch.from_numpy(g))
    jq, js = jgc.quantize_grad(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tgc.dequantize_grad(q, s, g.shape).numpy(),
                                  np.asarray(jgc.dequantize_grad(jq, js, g.shape)))
    res = np.full_like(g, 1e-3)
    (_, _), deq, new = tgc.ef_compress(torch.from_numpy(g), torch.from_numpy(res))
    (_, _), jdeq, jnew = jgc.ef_compress(jnp.asarray(g), jnp.asarray(res))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))


def _routed(ce, t, k, cap, seed, mask_p=0.0):
    """Random routing into ``ce``'s capacity layout (the port's dispatch,
    held to the reference's elsewhere) → ``(xp, slot_fill)``."""
    rng = np.random.default_rng(seed)
    x2 = torch.from_numpy(rng.normal(size=(t, ce.d_model)).astype(np.float32))
    slots = torch.from_numpy(rng.integers(0, ce.num_slots, size=(t, k)))
    gates = torch.softmax(torch.from_numpy(rng.normal(size=(t, k)).astype(np.float32)), -1)
    mask = None
    if mask_p > 0:
        mask = torch.from_numpy((rng.random((t, k)) > mask_p).astype(np.float32))
    xp, dest, valid, _ = capacity_dispatch(x2, slots, gates, ce.num_slots, cap, mask)
    return xp, slot_fill_counts(dest, valid, ce.num_slots, cap)


@given(bits_seed=st.integers(0, 1000), t=st.integers(6, 28), k=st.integers(1, 3),
       cap=st.sampled_from([8, 16, 24]), mask_p=st.sampled_from([0.0, 0.4]))
@settings(max_examples=10, deadline=None)
def test_scan_matches_reference_fuzzed(bits_seed, t, k, cap, mask_p):
    """``backend="scan"`` (one ``quant_matmul_parts`` per expert matrix)
    against the reference's scan and the port's grouped ``ref`` path."""
    rng = np.random.default_rng(bits_seed)
    e = int(rng.integers(3, 7))
    bits = [int(b) for b in rng.choice([1, 2, 3, 4], size=e)]
    ce = _tbuild(_experts(e, 32, 48, seed=bits_seed), bits, group=16, refine=False)
    xp, fill = _routed(ce, t, k, cap, bits_seed, mask_p)
    y = tcm.compressed_expert_ffn(ce, xp, cap, fill, backend="scan").numpy()
    want = jcm.compressed_expert_ffn(reference_experts(ce), jnp.asarray(xp.numpy()), cap,
                                     backend="scan")
    np.testing.assert_allclose(y, np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        y, tcm.compressed_expert_ffn(ce, xp, cap, fill, backend="ref").numpy(),
        rtol=2e-4, atol=2e-4)


def test_scan_gathers_resident_rows():
    """A host-offloaded bucket (rows stored reversed behind a resident
    map) runs the scan on the gathered full layout: the all-resident
    result, bit for bit."""
    ce = _tbuild(_experts(4, 32, 48, seed=3), [1, 2, 2, 3], group=16, refine=False)
    xp, fill = _routed(ce, 12, 2, 8, seed=4)
    full = tcm.compressed_expert_ffn(ce, xp, 8, fill, backend="scan")
    arrays = dict(ce.arrays)
    arrays["b1"] = {n: {k: t.flip(0) for k, t in w.items()} for n, w in ce.arrays["b1"].items()}
    rmap = {f"b{i}": torch.arange(m.count, dtype=torch.int32) for i, m in enumerate(ce.meta)}
    rmap["b1"] = torch.tensor([1, 0], dtype=torch.int32)
    res = dataclasses.replace(ce, arrays=arrays, resident_map=rmap)
    assert torch.equal(tcm.compressed_expert_ffn(res, xp, 8, fill, backend="scan"), full)


@pytest.mark.parametrize("backend", ["ref", "scan"])
def test_ep_reshape_equivalent(monkeypatch, backend):
    """``ep > 1`` (the model axis of a mesh) splits each bucket over its
    shards: the ``ep = 1`` result (``tests/test_moe_grouped.py:147``)."""
    ce = _tbuild(_experts(4, 32, 32, seed=5), [2, 2, 2, 2], group=16, ep=2, refine=False)
    xp, fill = _routed(ce, 14, 2, 16, seed=6)
    y1 = tcm.compressed_expert_ffn(ce, xp, 16, fill, backend=backend)
    monkeypatch.setattr(tcm, "model_axis_size", lambda: 2)
    y2 = tcm.compressed_expert_ffn(ce, xp, 16, fill, backend=backend)
    np.testing.assert_allclose(y2.numpy(), y1.numpy(), rtol=2e-5, atol=2e-5)


def test_ep_fallback_warns_then_strict_raises(monkeypatch):
    """A bucket of 3 experts under a model axis of 2: the reference's
    warning, and its error under ``REPRO_STRICT_EP=1``."""
    ce = _tbuild(_experts(4, 32, 32, seed=7), [2, 2, 2, 3], group=16, refine=False)
    xp, fill = _routed(ce, 8, 2, 8, seed=8)
    monkeypatch.setattr(tcm, "model_axis_size", lambda: 2)
    monkeypatch.delenv("REPRO_STRICT_EP", raising=False)
    with pytest.warns(RuntimeWarning, match="padded experts is not divisible by the "
                                            "model-axis size 2") as rec:
        tcm.compressed_expert_ffn(ce, xp, 8, fill, backend="ref")
    monkeypatch.setattr(jcm, "model_axis_size", lambda: 2)
    with pytest.warns(RuntimeWarning) as jrec:
        jcm._ep_fallback(3, 2)
    assert str(rec[0].message) == str(jrec[0].message)
    monkeypatch.setenv("REPRO_STRICT_EP", "1")
    with pytest.raises(AssertionError, match="REPRO_STRICT_EP=1"):
        tcm.compressed_expert_ffn(ce, xp, 8, fill, backend="ref")


def test_interop_carries_padded_buckets(padded_model):
    """A reference tree built with ``ep=4``: padded counts, dummy slots that
    clone their bucket's last expert, bytes equal."""
    cfg, params_j, params_t = padded_model
    for l, layer in enumerate(params_t["layers"]):
        ce, jce = layer["moe_ce"], params_j["blocks"]["moe_ce"]
        assert [m.count for m in ce.meta] == [m.count for m in jce.meta] == [4, 8, 4]
        np.testing.assert_array_equal(ce.slot_of_expert.numpy(),
                                      np.asarray(jce.slot_of_expert[l]))
        np.testing.assert_array_equal(ce.arrays["b2"]["w_down"]["lo"].numpy(),
                                      np.asarray(jce.arrays["b2"]["w_down"]["lo"][l]))
        assert torch.equal(ce.arrays["b2"]["w_up"]["scale"][3], ce.arrays["b2"]["w_up"]["scale"][1])


def test_reference_checkpoint_restores_into_rank_slices():
    """A checkpoint the reference wrote, restored with ``shardings=`` on a
    1 × 4 mesh: each rank coordinate gets its slices."""
    embed = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    wq = np.random.default_rng(0).normal(size=(2, 4, 8)).astype(np.float32)
    tree = {"embed": torch.from_numpy(embed), "blocks": {"attn": {"wq": {"w": torch.from_numpy(wq)}}}}
    with tempfile.TemporaryDirectory() as d:
        ck = JCheckpointer(d, async_write=False)
        ck.save(0, {"embed": jnp.asarray(embed), "blocks": {"attn": {"wq": {"w": jnp.asarray(wq)}}}})
        for m in range(4):
            mesh = tsh.Mesh(("data", "model"), (1, 4), coord=(0, m))
            got = Checkpointer(d, async_write=False).restore(
                0, tree, shardings=tsh.make_param_shardings(mesh, tree))
            np.testing.assert_array_equal(got["embed"].numpy(), embed[2 * m:2 * m + 2])
            np.testing.assert_array_equal(got["blocks"]["attn"]["wq"]["w"].numpy(),
                                          wq[:, :, 2 * m:2 * m + 2])


ENGINE = dict(max_slots=2, block_size=16, num_blocks=16, max_blocks_per_slot=4, prefill_chunk=16,
              decode_horizon=4, reserve_full=True, use_otp=True)


@pytest.mark.parametrize("resident", [None, 6])
def test_engine_scan_serves_reference_scan_tokens(padded_model, resident):
    """``ffn_backend="scan"`` on the padded model, all-resident and with 6
    of its 16 slots resident: the reference's ``scan`` engine's tokens and
    the port's ``grouped`` engine's (``tests/test_moe_grouped.py:260``)."""
    cfg, params_j, params_t = padded_model
    geo = dict(ENGINE, resident_experts=resident)
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, n).astype(np.int32)
               for i, n in enumerate((20, 9, 14))]
    want = JEngine(cfg, params_j, JEngineConfig(**geo, ffn_backend="scan")).serve(
        JRequest(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts))
    tcfg = tget_config("moonshot-v1-16b-a3b").reduced()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        outs = {b: PagedServingEngine(tcfg, params_t, EngineConfig(**geo, ffn_backend=b),
                                      device="cpu").serve(
            Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts))
            for b in ("scan", "grouped")}
    assert outs["scan"] == want == outs["grouped"]


def test_train_coordinator_at_world_size_1(tmp_path):
    """``--coordinator HOST:PORT`` joins a process group of one (RANK 0,
    WORLD_SIZE 1) and trains as without it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(SRC), RANK="0", WORLD_SIZE="1", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "tinyllama-1.1b",
         "--steps", "2", "--batch", "2", "--seq", "32", "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}"],
        env=env, capture_output=True, text=True, timeout=240, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"last_loss"' in out.stdout
