"""The port's expert parallelism on 8 CPU ranks (gloo) against the JAX
reference's no-mesh outputs.

One spawn of 8 processes (``tests/_torch_ep_worker.py``, a ``FileStore`` in
``tmp_path``, its own timeout) runs every case; the reference's outputs are
computed here. It mirrors ``tests/test_ep_shardmap.py`` on a ``data=2 ×
model=4`` mesh — bf16 experts within 2e-4, PMQ + OTP within 5e-4 (``mask_l1``
within 1e-5), ETP ``gather_weights`` within 5e-4 — and adds the ``scan``
backend inside the region, each rank's dispatch (``dest``, ``valid``,
``slot_fill``, ``sel``) equal to the reference's ``capacity_dispatch`` on
that rank's selection, two runs bit-identical, the typed errors where the
reference leaves the region, the reduced PMQ + OTP model (buckets padded by
``ep=4``) prefilled and decoded 8 greedy steps on ``data=1 × model=4``
sub-meshes (tokens equal, logits within 5e-4), and the elastic restore of
``tests/test_mesh_and_elastic.py`` onto a shrunk 1 × 4 mesh with
``compressed_psum`` over the data axis.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core import otp as jotp  # noqa: E402
from repro.core.compressed_moe import compressed_moe_layer as jcmoe  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.parallel import ep_shardmap as jep  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core.compressed_moe import build_compressed_experts as tbuild  # noqa: E402

from _torch_interop import (  # noqa: E402,F401
    flatten_reference, planned_reference, reference_experts, torch_one_thread)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
SPAWN_TIMEOUT_S = 300
CFG_KW = dict(name="eptest", family="moe", num_layers=1, d_model=64, num_heads=2,
              num_kv_heads=2, head_dim=32, d_ff=128, d_ff_expert=128, vocab_size=128,
              num_experts=8, top_k=2, num_shared_experts=1, dtype="float32", remat="none",
              moe_capacity_factor=4.0, logits_chunk=32, attn_q_chunk=32, attn_kv_chunk=32)
BITS = np.array([1, 2, 2, 2, 2, 3, 3, 2])
MODEL_BITS = [1, 2, 2, 2, 2, 3, 3, 2]
STEPS = 8


def _port_layer(p, otp):
    """The reference's one-layer MoE params and OTP router carried into the
    port through :mod:`repro_torch.interop` (stacked over one layer)."""
    blocks = {"ln1": jnp.zeros((1, CFG_KW["d_model"])),
              "moe": jax.tree.map(lambda a: a[None], p),
              "otp": jax.tree.map(lambda a: a[None], otp)}
    flat, meta = flatten_reference({"blocks": blocks})
    return interop.params_from_reference(flat, meta, device="cpu")["layers"][0]


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """``(ref, outs)``: the reference's outputs and each rank's results."""
    d = tmp_path_factory.mktemp("ep_ranks")
    jcfg = JModelConfig(**CFG_KW)
    p = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, CFG_KW["d_model"]))
    experts = {k: (lambda k=k: torch.from_numpy(np.array(p["experts"][k])))
               for k in ("w_gate", "w_up", "w_down")}
    ce4_t = tbuild(experts, BITS, group=64, ep=4, refine=False)
    ce1_t = tbuild(experts, BITS, group=64, ep=1, refine=False)
    ce4 = reference_experts(ce4_t)
    otp = jotp.init_otp_router(jax.random.PRNGKey(3), CFG_KW["d_model"], CFG_KW["top_k"])
    # the no-mesh layers (jitted: eager, their first calls compile op by op)
    ref = {"jcfg": jcfg, "p": p, "x": x, "ce4": ce4, "otp": otp,
           "bf16": np.asarray(jax.jit(lambda p, x: jmoe.moe_layer(p, x, jcfg).y)(p, x))}
    y, mask_l1 = jax.jit(lambda p, x, otp: (lambda o: (o[0], o[1]["mask_l1"]))(
        jcmoe(p, ce4, x, jcfg, otp_params=otp)))(p, x, otp)
    ref["pmq"], ref["mask_l1"] = np.asarray(y), float(mask_l1)
    ref["nootp"] = np.asarray(jax.jit(lambda p, x: jcmoe(p, ce4, x, jcfg)[0])(p, x))

    mcfg = jget_config("moonshot-v1-16b-a3b").reduced()
    params_j = planned_reference(mcfg, MODEL_BITS, ep=4)
    prompts = np.random.default_rng(5).integers(0, mcfg.vocab_size, (4, 12)).astype(np.int32)
    cache, logits = jtf.prefill(params_j, {"tokens": jnp.asarray(prompts)}, mcfg)
    pad = ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0))
    cache = dict(cache, k=jnp.pad(cache["k"], pad), v=jnp.pad(cache["v"], pad))
    toks, steps = [], [np.asarray(logits[:, -1])]
    decode = jax.jit(lambda c, t, pos: jtf.decode_step(params_j, c, t, pos, mcfg))
    for i in range(STEPS):
        cur = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(cur))
        cache, logits = decode(cache, cur, jnp.int32(12 + i))
        steps.append(np.asarray(logits[:, -1]))
    ref["greedy_tokens"] = np.concatenate(toks, axis=1)
    ref["greedy_logits"] = np.stack(steps, axis=1)
    flat, meta = flatten_reference(params_j)
    ref["model_meta"] = meta["moe_ce"]

    layer = _port_layer(p, otp)
    torch.save({
        "cfg": TModelConfig(**CFG_KW), "p": layer["moe"], "x": torch.from_numpy(np.array(x)),
        "otp": layer["otp"], "ce1": ce1_t, "ce4": ce4_t,
        "model": {"cfg": tget_config("moonshot-v1-16b-a3b").reduced(),
                  "params": interop.params_from_reference(flat, meta, device="cpu"),
                  "prompts": torch.from_numpy(prompts).long(), "steps": STEPS},
    }, d / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_ep_worker.py"),
                               str(r), str(WORLD), str(d)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    bad = [(r, proc.returncode, log[-2000:]) for r, (proc, log) in enumerate(zip(procs, logs))
           if proc.returncode != 0]
    assert not bad, bad
    outs = [torch.load(d / f"out_{r}.pt", weights_only=False) for r in range(WORLD)]
    return ref, outs


def _block(a, out):
    """The reference's rows of ``out``'s data shard (2 of the 4 rows)."""
    d = out["coord"]["data"]
    return a[2 * d:2 * d + 2]


def test_ranks_hold_their_coordinates(spawn):
    _, outs = spawn
    assert [(o["coord"]["data"], o["coord"]["model"]) for o in outs] == \
        [(r // 4, r % 4) for r in range(WORLD)]
    # each rank holds 16 / 4 = 4 slots of the padded buckets (4 / 8 / 4)
    assert len({o["expert_bytes"] for o in outs}) == 1


def test_bf16_region_matches_reference(spawn):
    ref, outs = spawn
    for o in outs:
        np.testing.assert_allclose(o["bf16"].numpy(), _block(ref["bf16"], o), rtol=2e-4,
                                   atol=2e-4)
        assert o["bf16_aux"].shape == ()
        # the experts cut to the rank's 2 rows by shard_params: the same result
        assert o["bf16_rows"] == 2 and torch.equal(o["bf16_cut"], o["bf16"])


def test_bf16_region_with_tensor_parallel_shared_mlp_matches_reference(spawn):
    """The layer as ``shard_params`` cuts it on ``2 × 4``: the experts to the
    rank's 2 rows and the shared MLP to its 32 of 128 columns (run by
    ``mlp``'s tensor-parallel branch): the reference's result within 2e-4."""
    ref, outs = spawn
    for o in outs:
        assert o["bf16_tp_cols"] == 32
        np.testing.assert_allclose(o["bf16_tp"].numpy(), _block(ref["bf16"], o), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("key", ["pmq", "pmq_scan"])
def test_pmq_otp_region_matches_reference(spawn, key):
    """The PMQ + OTP region (ETP ``replicate_tokens``: 32 tokens) through
    the grouped GEMMs and through the per-expert scan."""
    ref, outs = spawn
    for o in outs:
        np.testing.assert_allclose(o[key].numpy(), _block(ref["pmq"], o), rtol=5e-4, atol=5e-4)
        assert abs(float(o["pmq_mask_l1"]) - ref["mask_l1"]) < 1e-5
        assert o["dispatch_replicate"]["tokens"] == 32  # ETP replicate_tokens


def test_gather_weights_region_matches_reference(spawn):
    ref, outs = spawn
    for o in outs:
        assert o["dispatch_gather"]["tokens"] == 16  # ETP gather_weights: its shard's
        np.testing.assert_allclose(o["gather"].numpy(), _block(ref["nootp"], o), rtol=5e-4,
                                   atol=5e-4)


def test_two_runs_are_bit_identical(spawn):
    assert all(o["pmq_bitwise"] for o in spawn[1])


@pytest.mark.parametrize("mode", ["replicate", "gather"])
def test_each_rank_dispatch_is_the_reference_capacity_dispatch(spawn, mode):
    """``dest``/``valid``/``slot_fill``/``sel`` of each rank equal the
    reference's ``capacity_dispatch`` on that rank's selection (its tokens:
    all 32 when replicated, its data shard's 16 otherwise)."""
    ref, outs = spawn
    jcfg, p, ce4 = ref["jcfg"], ref["p"], ref["ce4"]
    model = 4
    shard_of, local_of = (jnp.asarray(a) for a in jep._slot_tables(ce4.meta, model))
    eploc = ce4.num_slots // model

    @jax.jit
    def dispatch(x2, m):
        t = x2.shape[0]
        _, idx, gates = jmoe.route_topk(p["router"], x2, CFG_KW["top_k"])
        sidx = ce4.slot_of_expert[idx]
        sel = (shard_of[sidx] == m).astype(jnp.float32)
        if mode == "replicate":
            sel = sel * jotp.otp_mask(ref["otp"], x2, idx, gates)
        cap = jmoe.dispatch_capacity(jcfg, t)
        _, dest, valid, _ = jmoe.capacity_dispatch(x2, local_of[sidx], gates, eploc, cap,
                                                   gate_mask=sel)
        return sel, local_of[sidx], dest, valid, jmoe.slot_fill_counts(dest, valid, eploc, cap)

    for o in outs:
        rec = o[f"dispatch_{mode}"]
        x = ref["x"] if mode == "replicate" else _block(ref["x"], o)
        x2 = x.reshape(-1, CFG_KW["d_model"])
        assert rec["cap"] == jmoe.dispatch_capacity(jcfg, x2.shape[0])
        for key, want in zip(("sel", "local_idx", "dest", "valid", "slot_fill"),
                             dispatch(x2, o["coord"]["model"])):
            np.testing.assert_array_equal(rec[key].numpy(), np.asarray(want), err_msg=key)


def test_typed_errors_where_the_reference_leaves_the_region(spawn):
    for o in spawn[1]:
        assert "bucket counts [1, 5, 2] are not multiples of model=4" in o["error_counts"]
        assert "expert_ffn_fn" in o["error_hook"]


def test_reduced_model_greedy_on_model4_submeshes(spawn):
    """Buckets built with ``ep=4`` (1 / 5 / 2 padded to 4 / 8 / 4), carried
    through ``interop``; dense-cache prefill + 8 greedy steps on two
    ``data=1 × model=4`` replicas: the reference's tokens, logits within
    5e-4."""
    ref, outs = spawn
    assert [b[2] for b in ref["model_meta"]["buckets"]] == [4, 8, 4]
    for o in outs:
        np.testing.assert_array_equal(o["greedy_tokens"].numpy(), ref["greedy_tokens"])
        np.testing.assert_allclose(o["greedy_logits"].numpy(), ref["greedy_logits"],
                                   rtol=5e-4, atol=5e-4)


def test_elastic_restore_onto_a_shrunk_mesh(spawn):
    """``tests/test_mesh_and_elastic.py`` on 8 ranks: specs, placement, a
    checkpoint restored with the shrunk 1 × 4 mesh's shardings, the
    production mesh refused on a world of 8."""
    _, outs = spawn
    embed = np.arange(32.0).reshape(8, 4)
    for r, o in enumerate(outs):
        m = o["coord"]["model"]
        assert o["specs"] == (("model", None), (None, None, "model"))
        np.testing.assert_array_equal(o["placed_embed"].numpy(), embed[2 * m:2 * m + 2])
        assert tuple(o["small"][0]) == (1, 4)
        if r < 4:
            assert o["small"][1] == {"data": 0, "model": r}
            emb, wq = o["restored"]
            np.testing.assert_array_equal(emb.numpy(), embed[2 * r:2 * r + 2])
            assert tuple(wq.shape) == (2, 4, 2)
        else:
            assert o["small"][1] is None and "restored" not in o
        assert "256" in o["production_error"]


def test_compressed_psum_over_the_data_axis(spawn):
    _, outs = spawn
    parts = {}
    for r in range(WORLD):
        g = torch.randn(300, generator=torch.Generator().manual_seed(r)).numpy()
        res = (torch.randn(300, generator=torch.Generator().manual_seed(100 + r)) * 1e-3).numpy()
        _, deq, new_res = jgc.ef_compress(jnp.asarray(g), jnp.asarray(res))
        parts[r] = (np.asarray(deq), np.asarray(new_res))
    for r, o in enumerate(outs):
        red, new_res = o["psum"]
        m = r % 4
        np.testing.assert_allclose(red.numpy(), parts[m][0] + parts[4 + m][0], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(new_res.numpy(), parts[r][1], rtol=1e-6, atol=1e-7)
