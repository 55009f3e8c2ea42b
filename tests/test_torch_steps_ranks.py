"""Training across ranks: the port on 8 CPU ranks (gloo) against the JAX
reference's ``jax.grad`` and the port's single process.

One spawn of 8 processes (``tests/_torch_steps_worker.py``, a ``FileStore``
in ``tmp_path``, its own timeout) runs every case on a ``data=2 × model=4``
mesh; the reference's gradients under its own 2 × 4 ``shard_map`` come from
one subprocess with 8 forced host devices, as ``tests/test_ep_shardmap.py``
runs it. Held:

* gradients through the bf16 expert region (``x``, router, experts, shared
  experts; loss ``sum(y · w) + aux``) within 2e-4 × max, and through the
  compressed region in both ETP modes (``x``, router, shared experts, OTP
  routers under the reference's Gumbel draws; loss ``sum(y · w) +
  mask_l1``) within 5e-4 × max, as ``tests/test_ep_shardmap.py`` holds the
  outputs;
* tensor-parallel ``train_loss`` and its gradients (attention by heads, MLPs
  by columns; the ranks' blocks concatenated, summed over data): a dense
  model on 2 × 4 against ``jax.grad`` and the single process, an MoE model
  on 1 × 4 against both and on 2 × 4 against ``jax.grad`` under the
  reference's mesh (its load-balance term is per data shard there), loss
  within 1e-5, gradients 2e-4 × max;
* the vocabulary split over ``model`` (``embed``, ``unembed``,
  ``chunked_xent``, the OTP step's ``chunked_kl``) where it divides: a
  quarter of the rows a rank in the dense and MoE cases;
* the other families' ``train_loss`` and gradients on 2 × 4 against
  ``jax.grad`` under the reference's mesh and the single process (loss
  1e-5, gradients 2e-4 × max): whisper (``cross`` and ``attn`` a head a
  rank, a vocabulary of 513 that stays whole), recurrentgemma (the RG-LRU
  and MLPs a quarter a rank, its one-KV-head attention whole) and xlstm (a
  head a rank, the ``[u | z]`` halves cut half by half); each rank's shapes
  and parameter bytes, the reference's specs' share but for the leaves kept
  whole;
* the OTP loss's vocabulary-parallel ``chunked_kl`` and its gradients
  against ``jax.grad`` under the reference's mesh;
* a greedy decode of the dense model on 2 × 4, the logits gathered over
  the vocabulary shards: the single process's tokens, a tie planted across
  the first shard boundary taken by the lower index;
* ``build_step`` train steps (``accum=2``, ZeRO-1, 32- and 8-bit moments) of
  the dense model, of the MoE model on 1 × 4 (its experts two a rank over
  ``model``; on 2 × 4 too, there with each rank's expert moments non-zero
  alone, its load-balance term being each data shard's), and one OTP step of a PMQ model (tensor-parallel 4-bit
  attention and shared experts, ETP experts): the ranks' parameters,
  all-gathered, and their optimizer-state blocks, concatenated, against the
  single process's step — loss 1e-5, parameters and moments 1e-4 × max,
  8-bit codes at most one apart (gradients summed in another order); each
  rank's 32-bit state an eighth of the whole but for the norms, which only
  ``data`` splits; the ZeRO-1 update alone, fed the single process's
  gradients, equal to it byte for byte;
* a bf16 decode of the MoE model on one sequence, a batch that does not
  divide over data: the cache's batch whole, its KV heads split over
  model; logits and cache the single process's;
* one-row microbatches (the dense model, batch 2, ``accum`` 2) over
  ``data`` = 2: each rank's block one row, a microbatch run by the rank that
  holds it and empty on the other; loss, gradients and update the single
  process's.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core.synthetic import build_synthetic  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim.adamw import Q8, AdamWConfig, adamw_init  # noqa: E402

from _torch_interop import flatten_reference, torch_one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
SPAWN_TIMEOUT_S = 300
CFG_KW = dict(name="eptest", family="moe", num_layers=1, d_model=64, num_heads=2,
              num_kv_heads=2, head_dim=32, d_ff=128, d_ff_expert=128, vocab_size=128,
              num_experts=8, top_k=2, num_shared_experts=1, dtype="float32", remat="none",
              moe_capacity_factor=4.0, logits_chunk=32, attn_q_chunk=32, attn_kv_chunk=32)
#: the reduced models with their KV heads widened so that model = 4 splits them
DENSE, MOE = "tinyllama-1.1b", "moonshot-v1-16b-a3b"
WIDE = dict(num_kv_heads=4)
#: the other families, reduced: whisper with 4 KV heads (``cross`` and
#: ``attn`` one head a rank) and a vocabulary of 513 that does not divide
#: (it stays whole, as whisper-small's 51865); recurrentgemma with its one
#: KV head (its attention stays whole); xlstm as it is
FAMILIES = {"whisper": ("whisper-small", dict(num_kv_heads=4, vocab_size=513)),
            "recurrentgemma": ("recurrentgemma-2b", {}),
            "xlstm": ("xlstm-350m", {})}
#: the shape of the families' batch (``build_step``'s xlstm step)
FAMILY_SHAPE = ShapeConfig("train_4k", 16, 4, "train")
#: the greedy decode's tie: two equal unembedding rows either side of the
#: first vocabulary shard boundary at model = 4, scaled so they win
TIE_ROW = 512 // 4 - 1

_SNIPPET = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, "tests")
from repro.configs.base import ModelConfig
from repro.configs.registry import get_config
from repro.core.compressed_moe import build_compressed_experts, compressed_moe_layer
from repro.core.otp import init_otp_router
from repro.models.moe import init_moe, moe_layer
from repro.models.registry import get_model
from repro.parallel.sharding import activation_rules, sharding_rules
from _torch_interop import flatten_reference

out, cfg_kw, moe_arch, wide = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3], json.loads(sys.argv[4])
CFG = ModelConfig(**cfg_kw)
p = init_moe(jax.random.PRNGKey(0), CFG)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, CFG.d_model))
w = jax.random.normal(jax.random.PRNGKey(2), (4, 8, CFG.d_model))
otp = init_otp_router(jax.random.PRNGKey(3), CFG.d_model, CFG.top_k)
key = jax.random.PRNGKey(4)
experts = {k: np.asarray(p["experts"][k]) for k in ("w_gate", "w_up", "w_down")}
ce4 = build_compressed_experts(experts, np.array([1, 2, 2, 2, 2, 3, 3, 2]), group=64, ep=4,
                               refine=False)
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
res = {"x": np.asarray(x), "w": np.asarray(w),
       "u_replicate": np.asarray(jax.random.uniform(key, (32, 2), minval=1e-6, maxval=1 - 1e-6)),
       "u_gather": np.asarray(jax.random.uniform(key, (16, 2), minval=1e-6, maxval=1 - 1e-6))}
flat, meta = flatten_reference({"blocks": {"ln1": jnp.zeros((1, CFG.d_model)),
                                           "moe": jax.tree.map(lambda a: a[None], p),
                                           "otp": jax.tree.map(lambda a: a[None], otp),
                                           "moe_ce": jax.tree.map(lambda a: a[None], ce4)}})
res.update({"layer/" + k: v for k, v in flat.items()})
res["layer_meta"] = np.array(json.dumps(meta))

def put(prefix, tree):
    f, _ = flatten_reference({"blocks": {"ln1": jnp.zeros((1, 1)), "g": jax.tree.map(lambda a: a[None], tree)}})
    res.update({prefix + k[len("blocks/g/"):]: v[0] for k, v in f.items() if k.startswith("blocks/g/")})

def bf16_loss(p, x):
    o = moe_layer(p, x, CFG)
    return (o.y * w).sum() + o.aux_loss

with mesh, sharding_rules(mesh, activation_rules(mesh)):
    gp, gx = jax.jit(jax.grad(bf16_loss, argnums=(0, 1)))(p, x)
put("bf16/", gp)
res["bf16/x"] = np.asarray(gx)
pr = {"router": p["router"], "shared": p["shared"]}

def c_loss(pr, o, x):
    y, info = compressed_moe_layer(pr, ce4, x, CFG, otp_params=o, otp_rng=key)
    return (y * w).sum() + info["mask_l1"]

for mode in ("replicate", "gather"):
    if mode == "gather":
        os.environ["REPRO_ETP_REPLICATE_MAX"] = "1"
    with mesh, sharding_rules(mesh, activation_rules(mesh)):
        gp, go, gx = jax.jit(jax.grad(c_loss, argnums=(0, 1, 2)))(pr, otp, x)
    put(mode + "/", gp)
    put(mode + "/otp/", go)
    res[mode + "/x"] = np.asarray(gx)

mcfg = dataclasses.replace(get_config(moe_arch).reduced(), **wide)
params = get_model(mcfg).init(jax.random.PRNGKey(0))
tok = np.random.default_rng(7).integers(0, mcfg.vocab_size, (4, 16)).astype(np.int32)
batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(np.roll(tok, -1, 1))}
with mesh, sharding_rules(mesh, activation_rules(mesh)):
    loss, g = jax.jit(jax.value_and_grad(lambda q: get_model(mcfg).train_loss(q, batch)[0]))(params)
res["moe_mesh/loss"] = np.asarray(loss)
gf, _ = flatten_reference(g)
res.update({"moe_mesh/" + k: v for k, v in gf.items()})

def flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(v)
            for path, v in leaves}

from repro.models import layers as Lx
krng = np.random.default_rng(13)
kl_in = {n: (krng.standard_normal(shape) * sc).astype(np.float32)
         for n, shape, sc in (("hs", (4, 16, 64), 1.0), ("ht", (4, 16, 64), 1.0),
                              ("emb", (512, 64), 0.3))}
with mesh, sharding_rules(mesh, activation_rules(mesh)):
    kl, (g_hs, g_emb) = jax.jit(jax.value_and_grad(
        lambda h, e: Lx.chunked_kl(h, jnp.asarray(kl_in["ht"]), e, 8), argnums=(0, 1)))(
        jnp.asarray(kl_in["hs"]), jnp.asarray(kl_in["emb"]))
res.update({f"kl/{n}": v for n, v in kl_in.items()})
res.update({"kl/loss": np.asarray(kl), "kl/g_hs": np.asarray(g_hs), "kl/g_emb": np.asarray(g_emb)})

for name, (arch, kw) in json.loads(sys.argv[5]).items():
    fcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    fparams = jax.jit(get_model(fcfg).init)(jax.random.PRNGKey(0))
    frng = np.random.default_rng(7)
    ftok = frng.integers(0, fcfg.vocab_size, (4, 16)).astype(np.int32)
    fbatch = {"tokens": jnp.asarray(ftok), "labels": jnp.asarray(np.roll(ftok, -1, 1))}
    if fcfg.family == "encdec":
        fbatch["frames"] = jnp.asarray(frng.normal(size=(4, fcfg.encoder_seq, fcfg.d_model))
                                       .astype(np.float32))
    with mesh, sharding_rules(mesh, activation_rules(mesh)):
        loss, g = jax.jit(jax.value_and_grad(
            lambda q: get_model(fcfg).train_loss(q, fbatch)[0]))(fparams)
    res[f"fam_{name}/loss"] = np.asarray(loss)
    res.update({f"fam_{name}/{k}": v for k, v in flat(g).items()})
np.savez(out, **res)
print("OK")
"""


def _jax_mesh_reference(d: Path) -> dict:
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/root"), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", _SNIPPET, str(d / "ref.npz"), json.dumps(CFG_KW),
                        MOE, json.dumps(WIDE), json.dumps(FAMILIES)], capture_output=True,
                       text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(d / "ref.npz"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _model(arch):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **WIDE)
    tcfg = dataclasses.replace(tget_config(arch).reduced(), **WIDE)
    params = jget_model(jcfg).init(jax.random.PRNGKey(0))
    flat, meta = flatten_reference(params)
    tok = np.random.default_rng(7).integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    return jcfg, tcfg, params, interop.params_from_reference(flat, meta, device="cpu"), batch


def _jax_grads(jcfg, params, batch):
    loss, g = jax.jit(jax.value_and_grad(lambda q: jget_model(jcfg).train_loss(
        q, {k: jnp.asarray(v) for k, v in batch.items()})[0]))(params)
    return float(loss), flatten_reference(g)[0]


def _port_grads(tcfg, params, batch):
    """The single process's loss and gradients, by stacked path."""
    flat = tsteps._requires_grad(tsteps.stack_tree(params))
    loss, _ = ttf.train_loss(tsteps.unstack_tree(params, flat),
                             {k: _t(v).long() for k, v in batch.items()}, tcfg)
    leaves = [t for v in flat.values() for t in v]
    gs = iter(torch.autograd.grad(loss, leaves))
    return float(loss), {p: (torch.stack([next(gs) for _ in v]) if p.startswith("blocks/")
                             else next(gs)).numpy() for p, v in flat.items()}


def _train_inputs():
    jcfg, tcfg, _, params, _ = _model(DENSE)
    tok = np.random.default_rng(8).integers(0, tcfg.vocab_size, (8, 16)).astype(np.int32)
    batch = {"tokens": _t(tok).long(), "labels": _t(np.roll(tok, -1, 1)).long()}
    shape = ShapeConfig("train_4k", 16, 8, "train")
    single = {}
    for bits in (32, 8):
        art = tsteps.build_step(tcfg, shape, accum=2, state_bits=bits)
        opt = tsteps.init_opt_blocks(art, "cpu")
        # the step writes into its donated arguments: it gets copies
        single[bits] = (art.fn(tsteps._own(params), tsteps._own(opt), batch), opt)
    _, g = _port_grads(tcfg, params, {k: v.numpy() for k, v in batch.items()})
    # the first two rows at accum 2: one-row microbatches over data = 2
    micro = {"shape": ShapeConfig("train_4k", 16, 2, "train"),
             "batch": {k: v[:2].clone() for k, v in batch.items()}}
    art = tsteps.build_step(tcfg, micro["shape"], accum=2)
    micro["opt"] = tsteps.init_opt_blocks(art, "cpu")
    micro["grads"] = art.grads(params, micro["batch"])[1]
    single["micro"] = (art.fn(tsteps._own(params), tsteps._own(micro["opt"]), micro["batch"]),
                       micro["opt"])
    return ({"cfg": tcfg, "shape": shape, "params": params, "batch": batch,
             "opt32": single[32][1], "opt8": single[8][1],
             "grads": {p: torch.from_numpy(v) for p, v in g.items()}, "micro": micro}, single)


def _moe_inputs(tcfg, params):
    """The reduced MoE model's inputs (8 experts, two a rank at model = 4)
    and the single process's results: a ``build_step`` train step at each
    state width, and a bf16 decode of one sequence after its prefill."""
    rng = np.random.default_rng(10)
    tok = rng.integers(0, tcfg.vocab_size, (8, 16)).astype(np.int32)
    batch = {"tokens": _t(tok).long(), "labels": _t(np.roll(tok, -1, 1)).long()}
    shape = ShapeConfig("train_4k", 16, 8, "train")
    inp, single = {"cfg": tcfg, "shape": shape, "params": params, "batch": batch}, {}
    for bits in (32, 8):
        art = tsteps.build_step(tcfg, shape, accum=2, state_bits=bits)
        inp[f"opt{bits}"] = tsteps.init_opt_blocks(art, "cpu")
        single[bits] = art.fn(tsteps._own(params), tsteps._own(inp[f"opt{bits}"]), batch)
    s = 16
    pre = tsteps.build_step(tcfg, ShapeConfig("prefill_32k", s, 1, "prefill"), precision="bf16")
    dshape = ShapeConfig("decode_32k", s, 1, "decode")
    dec = tsteps.build_step(tcfg, dshape, precision="bf16")
    cache, logits = pre.fn(params, {"tokens": _t(rng.integers(0, tcfg.vocab_size, (1, s - 1))
                                                 .astype(np.int32))})
    pad = (0, 0, 0, 0, 0, 1)  # one more row on the sequence axis for the decoded token
    cache = dict(cache, k=torch.nn.functional.pad(cache["k"], pad),
                 v=torch.nn.functional.pad(cache["v"], pad))
    token = logits[:, -1].argmax(-1, keepdim=True).int()
    pos = torch.tensor(s - 1, dtype=torch.int32)
    inp["decode"] = {"shape": dshape, "cache": cache, "token": token, "pos": pos}
    single["decode"] = dec.fn(params, tsteps._own(cache), token, pos)
    return inp, single


def _otp_inputs():
    cfg = dataclasses.replace(tget_config(MOE).reduced(), **WIDE)
    cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, group=32))
    params = build_synthetic(cfg, seed=0, device="cpu", ep=4)
    otp = [p.pop("otp") for p in params["layers"]]
    tok = np.random.default_rng(9).integers(0, cfg.vocab_size, (8, 16)).astype(np.int64)
    shape = ShapeConfig("train_4k", 16, 8, "train")
    art = tsteps.build_step(cfg, shape, train_mode="otp", accum=2)
    u = torch.rand(tuple(art.arg_specs[4].shape), generator=torch.Generator().manual_seed(3))
    u = u * (1 - 2e-6) + 1e-6
    opt = adamw_init([{k: torch.stack([o[k] for o in otp]) for k in ("fc1", "fc2")}][0],
                     AdamWConfig(lr=2e-3, weight_decay=0.0))
    inp = {"cfg": cfg, "shape": shape, "otp": otp, "opt": opt, "frozen": params,
           "batch": {"tokens": torch.from_numpy(tok)}, "u": u}
    return inp, art.fn(tsteps._own(otp), tsteps._own(opt), params, inp["batch"], u)


def _flat(tree, prefix=""):
    """``{path: np.ndarray}`` of a tree of dicts, lists and tuples."""
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _family_inputs():
    """Each family's reduced model (the reference's init, carried across),
    its batch and the port's single-process loss and gradients."""
    out = {}
    for name, (arch, kw) in FAMILIES.items():
        jcfg = dataclasses.replace(jget_config(arch).reduced(), **kw)
        tcfg = TModelConfig(**dataclasses.asdict(jcfg))
        jparams = jax.jit(jget_model(jcfg).init)(jax.random.PRNGKey(0))
        params = interop.params_from_reference(_flat(jparams), {}, device="cpu")
        rng = np.random.default_rng(7)
        tok = rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
        batch = {"tokens": _t(tok).long(), "labels": _t(np.roll(tok, -1, 1)).long()}
        if jcfg.family == "encdec":
            batch["frames"] = _t(rng.normal(size=(4, jcfg.encoder_seq, jcfg.d_model))
                                 .astype(np.float32))
        loss, grads = tsteps.tree_gradients(tcfg, params, batch)
        out[name] = {"cfg": tcfg, "params": params, "batch": batch,
                     "port": (float(loss), grads)}
    # one build_step ZeRO-1 step of xlstm (its halves leaves) at each state
    # width: the zero state the ranks cut, and the single process's step
    x = out["xlstm"]
    x["zero1"], x["single"], x["shape"] = {}, {}, FAMILY_SHAPE
    for bits in (32, 8):
        art = tsteps.build_step(x["cfg"], FAMILY_SHAPE, state_bits=bits)
        x["zero1"][bits] = tsteps.init_opt_blocks(art, "cpu")
        x["single"][bits] = art.fn(tsteps._own(x["params"]), tsteps._own(x["zero1"][bits]),
                                   x["batch"])
    return out


def _greedy_inputs():
    """The reduced dense model with unembedding rows ``TIE_ROW`` and
    ``TIE_ROW + 1`` equal and scaled, and its single-process greedy tokens."""
    from repro_torch.launch import workload

    _, tcfg, _, params, _ = _model(DENSE)
    unembed = params["unembed"].clone()
    unembed[TIE_ROW] = unembed[TIE_ROW + 1] = 8 * unembed[TIE_ROW + 1]
    params = dict(params, unembed=unembed)
    tok = np.random.default_rng(12).integers(0, tcfg.vocab_size, (4, 8))
    batch = {"tokens": _t(tok).long()}
    toks, _, _, _ = workload.greedy_family(tcfg, params, batch, 6)
    return {"cfg": tcfg, "params": params, "batch": batch, "steps": 6}, toks


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    d = tmp_path_factory.mktemp("steps_ranks")
    ref = {"mesh": _jax_mesh_reference(d)}
    flat = {k[len("layer/"):]: v for k, v in ref["mesh"].items() if k.startswith("layer/")}
    layer = interop.params_from_reference(flat, json.loads(str(ref["mesh"]["layer_meta"])),
                                          device="cpu")["layers"][0]
    cfg = TModelConfig(**CFG_KW)
    ep = {"cfg": cfg, "p": layer["moe"], "otp": layer["otp"], "ce4": layer["moe_ce"],
          "x": _t(ref["mesh"]["x"]), "w": _t(ref["mesh"]["w"]),
          "u_replicate": _t(ref["mesh"]["u_replicate"]), "u_gather": _t(ref["mesh"]["u_gather"])}
    tp = {}
    for name, arch in (("dense", DENSE), ("moe", MOE)):
        jcfg, tcfg, jparams, params, batch = _model(arch)
        tp[name] = {"cfg": tcfg, "params": params,
                    "batch": {k: _t(v).long() for k, v in batch.items()}}
        ref[name] = {"jax": _jax_grads(jcfg, jparams, batch),
                     "port": _port_grads(tcfg, params, batch)}
    moe, ref["moe_steps"] = _moe_inputs(tp["moe"]["cfg"], tp["moe"]["params"])
    train, ref["train"] = _train_inputs()
    otp, ref["otp"] = _otp_inputs()
    families = _family_inputs()
    greedy, ref["greedy"] = _greedy_inputs()
    kl = {n: _t(ref["mesh"][f"kl/{n}"]) for n in ("hs", "ht", "emb")}
    ref["families"] = {name: f.pop("port") for name, f in families.items()}
    ref["family_steps"] = families["xlstm"].pop("single")
    torch.save({"ep": ep, "tp": tp, "train": train, "otp": otp, "families": families,
                "greedy": greedy, "kl": kl, "moe": moe}, d / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_steps_worker.py"),
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
    bad = [(r, proc.returncode, log[-3000:]) for r, (proc, log) in enumerate(zip(procs, logs))
           if proc.returncode != 0]
    assert not bad, bad
    outs = [torch.load(d / f"out_{r}.pt", weights_only=False) for r in range(WORLD)]
    ref["family_inputs"] = families
    return ref, outs, train, otp


def _close(got, want, tol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()) + 1e-12,
                               err_msg=msg)


def _line(outs, data=None, model=None):
    return [o for o in outs if (data is None or o["coord"]["data"] == data)
            and (model is None or o["coord"]["model"] == model)]


# ------------------------------------------------------------ EP regions
def _region_case(outs, ref, key, name, tol):
    """A gradient whole on every rank of a model line: equal along the line,
    summed over data against the reference's; ``x`` the rank's block."""
    if name == "x":
        for o in outs:
            d = o["coord"]["data"]
            _close(o[key]["x"], ref[f"{key}/x"][2 * d:2 * d + 2], tol, f"{key} x")
        return
    for d in range(2):
        line = _line(outs, data=d)
        for o in line[1:]:
            assert torch.equal(o[key][name], line[0][key][name]), (key, name)
    total = sum(o[key][name] for o in _line(outs, model=0))
    _close(total, ref[f"{key}/{name}"], tol, f"{key} {name}")


def test_bf16_region_gradients_match_jax_grad_under_its_mesh(spawn):
    ref, outs, _, _ = spawn
    r = ref["mesh"]
    for name in ("x", "router/w", "shared/w_gate/w", "shared/w_up/w", "shared/w_down/w"):
        _region_case(outs, r, "bf16", name, 2e-4)
    for name in ("experts/w_gate", "experts/w_up", "experts/w_down"):
        # each rank's gradient has its experts' rows; all ranks sum to the reference's
        _close(sum(o["bf16"][name] for o in outs), r[f"bf16/{name}"], 2e-4, name)


@pytest.mark.parametrize("mode", ["replicate", "gather"])
def test_compressed_region_gradients_match_jax_grad_under_its_mesh(spawn, mode):
    ref, outs, _, _ = spawn
    r = ref["mesh"]
    for name in ("x", "router/w", "shared/w_gate/w", "shared/w_up/w", "shared/w_down/w",
                 "otp/fc1", "otp/fc2"):
        _region_case(outs, r, mode, name, 5e-4)
    assert np.abs(r[f"{mode}/otp/fc1"]).max() > 0  # the draws reach the routers


# --------------------------------------------------- tensor parallelism
def _gather_tp(outs, key, path, shape):
    """A gradient whole: each data line's blocks along the axis they cut
    (a leaf the line holds whole: equal on it), summed over data."""
    total = 0
    for d in sorted({o["coord"]["data"] for o in outs}):
        line = sorted(_line(outs, data=d), key=lambda o: o["coord"]["model"])
        gs = [o[key]["grads"][path] for o in line]
        if tuple(gs[0].shape) == tuple(shape):
            assert all(torch.equal(g, gs[0]) for g in gs), (key, path)
            total = total + gs[0]
        else:
            ax = [i for i, (a, b) in enumerate(zip(gs[0].shape, shape)) if a != b][0]
            total = total + torch.cat(gs, dim=ax)
    return total


def _tp_check(outs, key, want_loss, want, tol=2e-4):
    for o in outs:
        assert abs(o[key]["loss"] - want_loss) <= 1e-5, (key, o[key]["loss"], want_loss)
    for path, w in want.items():
        _close(_gather_tp(outs, key, path, w.shape), w, tol, f"{key} {path}")


def test_tp_dense_loss_and_gradients(spawn):
    ref, outs, _, _ = spawn
    assert outs[0]["tp_dense"]["plan"] == {"attn": True, "mlp": True}
    # one head of 32 a rank, a quarter of the MLP's columns
    assert tuple(outs[0]["tp_dense"]["grads"]["blocks/attn/wq/w"].shape) == (2, 128, 32)
    assert tuple(outs[0]["tp_dense"]["grads"]["blocks/mlp/w_down/w"].shape) == (2, 64, 128)
    for want_loss, want in (ref["dense"]["jax"], ref["dense"]["port"]):
        _tp_check(outs, "tp_dense", want_loss, want)


def test_tp_moe_loss_and_gradients(spawn):
    """1 × 4 against the single process and ``jax.grad``; 2 × 4 against
    ``jax.grad`` under the reference's mesh. Each rank holds its experts'
    rows, gathered in model order like a tensor-parallel block."""
    ref, outs, _, _ = spawn
    assert outs[0]["tp_moe"]["plan"] == {"attn": True, "moe/shared": True}
    sub = [dict(o, coord=o["sub"]) for o in outs[:4]]
    for want_loss, want in (ref["moe"]["jax"], ref["moe"]["port"]):
        _tp_check(sub, "tp_moe_sub", want_loss, want)
    r = ref["mesh"]
    want = {k[len("moe_mesh/"):]: v for k, v in r.items() if k.startswith("moe_mesh/blocks")
            or k[len("moe_mesh/"):] in ("embed", "unembed", "final_norm")}
    _tp_check(outs, "tp_moe", float(r["moe_mesh/loss"]), want)


#: each family's pairs on model = 4 (whisper's decoder blocks, the others'
#: first group) and a rank's shape of some leaves ([] for a leaf kept whole)
FAMILY_PLANS = {
    "whisper": {"attn": True, "cross": True, "mlp": True},
    "recurrentgemma": {"rg1": True, "rg1/mlp": True, "rg2": True, "rg2/mlp": True,
                       "attn/attn": False, "attn/mlp": True},
    "xlstm": {"m": True, "s": True, "s/ffn": True},
}
FAMILY_SHAPES = {
    "whisper": {"embed": (513, 128), "dec_blocks/0/cross/wq/w": (128, 32),
                "dec_blocks/0/cross/wo/w": (32, 128), "enc_blocks/0/mlp/w_down/w": (64, 128)},
    "recurrentgemma": {"embed": (128, 128), "groups/0/rg1/proj_in/w": (128, 32),
                       "groups/0/rg1/wa/w": (128, 32), "groups/0/rg1/proj_out/w": (32, 128),
                       "groups/0/rg1/conv": (4, 128), "groups/0/attn/attn/wk/w": (128, 32),
                       "groups/0/attn/attn/wq/w": (128, 128)},
    "xlstm": {"embed": (128, 128), "groups/0/m/proj_in/w": (128, 128),
              "groups/0/m/wq/w": (256, 64), "groups/0/m/w_if/w": (256, 2),
              "groups/0/m/proj_out/w": (64, 128), "groups/0/s/w_if/w": (128, 64),
              "groups/0/s/ffn/proj_in/w": (128, 96)},
}


#: the leaves the reference's specs cut that the port keeps whole
#: (``ROADMAP.md`` §3): recurrentgemma's attention, whose one KV head the
#: reference's ``P(None, "model")`` cuts inside the head
KEPT_WHOLE = re.compile(r"^groups/\d+/attn/attn/w[qkvo]/w$")


def _cut_for(tree, cfg, data, model):
    """``tree`` (a whole parameter or gradient tree) as rank ``(data,
    model)`` of the 2 × 4 mesh holds it (``shard_params``)."""
    from repro_torch.parallel.ep_shardmap import shard_params
    from repro_torch.parallel.sharding import Mesh

    return shard_params(tree, Mesh(("data", "model"), (2, 4), coord=(data, model)), cfg)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_tp_family_loss_and_gradients(spawn, name):
    """whisper (``cross`` and ``attn`` a head a rank, the MLPs by F, the
    vocabulary of 513 whole), recurrentgemma (the RG-LRU and MLPs a quarter
    a rank, the attention with its one KV head whole, the vocabulary split)
    and xlstm (a head a rank, the ``[u | z]`` halves cut half by half, the
    sLSTM by channel, the vocabulary split) on 2 × 4: each rank's loss
    within 1e-5 of ``jax.grad``'s under the reference's mesh and of the
    single process's; each rank's gradients, summed over data, its share of
    theirs within 2e-4 × max; its shapes those of its share."""
    from repro_torch.core.tree import tree_leaves, tree_paths

    ref, outs, _, _ = spawn
    r = ref["mesh"]
    cfg = ref["family_inputs"][name]["cfg"]
    flat = {k[len(f"fam_{name}/"):]: v for k, v in r.items() if k.startswith(f"fam_{name}/")}
    jloss = float(flat.pop("loss"))
    jgrads = interop.params_from_reference(flat, {}, device="cpu")
    ploss, pgrads = ref["families"][name]
    assert outs[0]["families"][name]["plan"] == FAMILY_PLANS[name]
    for o in outs:
        got = o["families"][name]
        assert abs(got["loss"] - jloss) <= 1e-5 and abs(got["loss"] - ploss) <= 1e-5, name
    for m in range(4):
        line = [o for o in outs if o["coord"]["model"] == m]
        total = [sum(ts) for ts in zip(*(tree_leaves(o["families"][name]["grads"])
                                         for o in line))]
        shapes = {"/".join(map(str, p)): tuple(t.shape)
                  for p, t in tree_paths(line[0]["families"][name]["grads"])}
        for path, shape in FAMILY_SHAPES[name].items():
            assert shapes[path] == shape, (name, path, shapes[path])
        for want in (jgrads, pgrads):
            for got, w, (path, _) in zip(total, tree_leaves(_cut_for(want, cfg, 0, m)),
                                         tree_paths(pgrads)):
                _close(got, w.numpy(), 2e-4, f"{name} {path}")


def test_vocab_parallel_shares_and_whole_vocabulary(spawn):
    """The dense and MoE models' vocabularies (512) split a quarter a rank —
    embed, unembed and their gradients —, whisper's 513 stays whole on every
    rank; each rank's parameter bytes of a family the whole's share but for
    the leaves kept whole."""
    ref, outs, _, _ = spawn
    assert tuple(outs[0]["tp_dense"]["grads"]["embed"].shape) == (128, 128)
    assert tuple(outs[0]["tp_dense"]["grads"]["unembed"].shape) == (128, 128)
    assert tuple(outs[0]["tp_moe"]["grads"]["embed"].shape) == (128, 128)
    whisper = ref["family_inputs"]["whisper"]["params"]
    for o in outs:
        emb = o["families"]["whisper"]["grads"]["embed"]
        assert tuple(emb.shape) == tuple(whisper["embed"].shape) == (513, 128)
    from repro_torch.launch.step_ranks import _share_bytes
    from repro_torch.parallel.sharding import Mesh

    for name, f in ref["family_inputs"].items():
        shares = _share_bytes(f["params"], Mesh(("data", "model"), (2, 4), coord=(0, 0)))
        want = sum(whole if KEPT_WHOLE.search(path) else share
                   for path, (whole, share) in shares.items())
        for o in outs:
            assert o["families"][name]["bytes"] == want, (name, o["coord"])


def test_vocab_parallel_kl_matches_jax_grad_under_its_mesh(spawn):
    """The OTP distillation loss's ``chunked_kl`` with the vocabulary split
    a quarter a rank (512 rows, chunks of 8 positions) on 2 × 4: each rank's
    loss within 1e-5 of the reference's under its mesh, the gradient of its
    batch rows' student states, and of its vocabulary rows summed over
    data, within 2e-4 × max of ``jax.grad``'s."""
    ref, outs, _, _ = spawn
    r = ref["mesh"]
    for o in outs:
        d, m = o["coord"]["data"], o["coord"]["model"]
        got = o["kl"]
        assert abs(got["loss"] - float(r["kl/loss"])) <= 1e-5
        assert tuple(got["emb"].shape) == (128, 64)
        _close(got["hs"], r["kl/g_hs"][2 * d:2 * d + 2], 2e-4, "hs")
    for m in range(4):
        total = sum(o["kl"]["emb"] for o in outs if o["coord"]["model"] == m)
        _close(total, r["kl/g_emb"][128 * m:128 * (m + 1)], 2e-4, f"emb rows of rank {m}")


def test_greedy_decode_on_the_ranks_matches_one_process(spawn):
    """Greedy decoding (dense-cache prefill and decode steps) of the dense
    model on 2 × 4, the logits gathered over the vocabulary shards: each
    rank's tokens are the single process's for its batch block, with a tie
    planted across the first shard boundary (rows 127 and 128 equal) taken
    by the lower index, as one process's argmax takes it."""
    ref, outs, _, _ = spawn
    want = ref["greedy"]
    assert (want == TIE_ROW).any() and not (want == TIE_ROW + 1).any()
    for o in outs:
        d = o["coord"]["data"]
        assert torch.equal(o["greedy"], want[2 * d:2 * d + 2]), (o["coord"], o["greedy"])


# ------------------------------------------------------------ the steps
def _assemble(outs, get, spec, halves=1):
    """The whole tensor from the ranks' blocks under ``spec`` (replicas:
    the first rank's; a halves leaf's parts put back in order)."""
    from repro_torch.parallel.sharding import Mesh

    blocks, sizes = {}, {}
    for o in outs:
        m = Mesh(("data", "model"), o.get("mesh_shape", (2, 4)),
                 coord=(o["coord"]["data"], o["coord"]["model"]))
        key = tuple(0 if n is None else m.index(n) for n in spec)
        sizes = {ax: m.extent(n) for ax, n in enumerate(spec) if n is not None}
        blocks.setdefault(key, get(o))

    def build(prefix):
        ax = len(prefix)
        if ax == len(spec):
            return blocks[prefix]
        parts = [build(prefix + (i,)) for i in range(sizes.get(ax, 1))]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=ax)

    whole = build(())
    if halves > 1:  # [a_0 b_0 | a_1 b_1 | ...] -> [a_0 a_1 ... | b_0 b_1 ...]
        ax = next(ax for ax, n in enumerate(spec) if n is not None and "model" in n)
        m = sizes[ax]
        whole = whole.unflatten(ax, (m, halves, whole.shape[ax] // (m * halves)))
        whole = whole.transpose(ax, ax + 1).flatten(ax, ax + 2)
    return whole


def _state_leaves(tree, prefix=""):
    """``{path: leaf}`` of an AdamW state or its shardings (a Q8's fields)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_state_leaves(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, Q8):
        out[f"{prefix}/q"], out[f"{prefix}/scale"] = tree.q, tree.scale
    else:
        out[prefix] = tree
    return out


def _stacked(flat, path):
    v = flat[path]
    return torch.stack(v) if path.startswith("blocks/") else v[0]


def _spec_halves(entry):
    """``(spec, halves)`` of a worker's spec entry (a bare spec: 1)."""
    if len(entry) == 2 and isinstance(entry[1], int):
        return entry
    return entry, 1


def _check_state(outs, key, specs, want, exact=False, get=None):
    sh = _state_leaves(specs)
    get = get or (lambda o: o[key])
    for path, w in _state_leaves(want).items():
        spec, halves = _spec_halves(sh[path])
        got = _assemble(outs, lambda o, p=path: _state_leaves(get(o)["opt"])[p], spec, halves)
        if exact:
            assert torch.equal(got, w), path
        elif w.dtype == torch.int8:
            assert (got.int() - w.int()).abs().max() <= 1, path
        else:
            _close(got, w.numpy(), 1e-4, path)


def _check_train_step(outs, key, specs, single):
    """The ranks' train step ``o[key]`` (``specs``: its parameter and state
    shardings) against the single process's: loss within 1e-5, parameters
    and moments 1e-4 × max."""
    (params1, opt1, loss1), _ = single
    for o in outs:
        assert abs(o[key]["loss"] - float(loss1)) <= 1e-5
    p_sh = tsteps.stack_tree(specs[0])
    want = {p: _stacked(tsteps.stack_tree(params1), p) for p in p_sh}
    scale = max(float(v.abs().max()) for v in want.values())
    for path, w in want.items():
        spec = p_sh[path][0]
        spec = ((None,) + tuple(spec)) if path.startswith("blocks/") else tuple(spec)
        got = _assemble(outs, lambda o, p=path: _stacked(o[key]["params"], p), spec)
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=path)
    _check_state(outs, key, specs[1], opt1)


@pytest.mark.parametrize("bits", [32, 8])
def test_train_step_on_the_mesh_matches_one_process(spawn, bits):
    _, outs, train, single = spawn[0], spawn[1], spawn[2], spawn[0]["train"]
    key = f"train{bits}"
    _check_train_step(outs, key, outs[0][f"specs{bits}"], single[bits])
    (_, opt1, _), _ = single[bits]
    if bits == 32:  # ZeRO-1 over data × model: an eighth of each moment, data only for norms
        mine = _state_leaves(outs[0][key]["opt"]["per_param"])
        whole = _state_leaves(opt1["per_param"])
        for path, w in whole.items():
            norm = any(n in path for n in ("ln1", "ln2", "final_norm"))
            assert mine[path].numel() * (2 if norm else 8) == w.numel(), path


def test_one_row_microbatches_are_cut_not_replicated(spawn):
    """Two rows at ``accum`` 2 over ``data`` = 2: each rank's batch block is
    its one row of the batch, which is the whole of one microbatch and none
    of the other (a rank with no row runs its microbatch empty and joins the
    collectives); the loss, each rank's gradient block (``art.grads``, the
    ZeRO-1 state's layout) and the update equal the single process's."""
    ref, outs, _, _ = spawn
    single = ref["train"]["micro"]
    for o in outs:
        mi, d = o["micro"], o["coord"]["data"]
        assert mi["rows"] == (1, 16)
        assert mi["micro_rows"] == ([(0, 1), (1, 1)] if d == 0 else [(0, 0), (0, 1)])
        assert abs(mi["grads_loss"] - float(single[0][2])) <= 1e-5
        scale = max(float(w.abs().max()) for w in mi["want"].values())
        for path, g in mi["grads"].items():
            np.testing.assert_allclose(g.numpy(), mi["want"][path].numpy(), rtol=0,
                                       atol=1e-4 * scale, err_msg=path)
    _check_train_step(outs, "micro", outs[0]["micro"]["specs"], single)


@pytest.mark.parametrize("bits", [32, 8])
def test_dry_run_counts_each_ranks_collectives(spawn, bits):
    """Each rank's train step (``accum=2``) recorded its collectives by kind
    as it ran them over gloo; the dry run of the same step on ``meta`` at
    that rank's coordinate of a ``2 × 4`` view without processes counts the
    same calls and operand bytes to the byte (a reduce-scatter that gloo
    composes of an all-reduce counted as the reduce-scatter it is)."""
    from repro_torch.launch.op_analysis import analyze_step
    from repro_torch.parallel.sharding import Mesh

    _, outs, train, _ = spawn
    for o in outs:
        mesh = Mesh(("data", "model"), (2, 4), coord=(o["coord"]["data"], o["coord"]["model"]))
        with torch.device("meta"):
            art = tsteps.build_step(train["cfg"], train["shape"], mesh, accum=2, state_bits=bits)
            s = analyze_step(art.fn, tsteps.shard_args(art, art.arg_specs, mesh, train["cfg"]))
        assert (s.collective_bytes, s.num_collectives) == o[f"ledger{bits}"], o["coord"]
    # ZeRO-1's gradient reduction: a reduce-scatter a leaf on 32-bit state,
    # an all-reduce of the whole leaf for 8-bit moments' chunks
    assert ("reduce-scatter" in outs[0][f"ledger{bits}"][1]) == (bits == 32)


@pytest.mark.parametrize("bits", [32, 8])
def test_zero1_update_on_the_mesh_is_one_process_bytewise(spawn, bits):
    _, outs, train, _ = spawn
    cfg = train["cfg"]
    mesh = tsteps._one_rank()
    plans, _ = tsteps._train_layout(tsteps.get_model(cfg).param_shapes(), mesh, cfg, bits)
    grads = {p: tsteps._reduce(train["grads"][p], plan, mesh) for p, plan in plans.items()}
    new, nst = tsteps._zero1_update(plans, tsteps.stack_tree(tsteps._own(train["params"])),
                                    grads, tsteps._own(train[f"opt{bits}"]),
                                    AdamWConfig(state_bits=bits), mesh)
    key = f"zero1_{bits}"
    p_sh = tsteps.stack_tree(outs[0][f"specs{bits}"][0])
    for path in plans:
        spec = p_sh[path][0]
        spec = ((None,) + tuple(spec)) if path.startswith("blocks/") else tuple(spec)
        got = _assemble(outs, lambda o, p=path: _stacked(o[key]["params"], p), spec)
        assert torch.equal(got, _stacked(new, path)), path
    _check_state(outs, key, outs[0][f"specs{bits}"][1], nst, exact=True)


@pytest.mark.parametrize("bits", [32, 8])
def test_family_zero1_step_on_the_mesh_matches_one_process(spawn, bits):
    """xlstm's ``build_step`` train step on 2 × 4 against the single
    process's: its ``groups/...`` stacked, the halves leaves (``[u | z]``,
    ``[ĩ | f̃]``, ``[u | v]``) cut part by part with their 32-bit state
    following the parameter's block, their 8-bit moments whole on every
    rank; loss within 1e-5, parameters 1e-4 × max, moments as the dense
    step's."""
    ref, outs, _, _ = spawn
    params1, opt1, loss1 = ref["family_steps"][bits]
    got = [o["family_steps"][bits] for o in outs]
    for g in got:
        assert abs(g["loss"] - float(loss1)) <= 1e-5
    p_sh = tsteps.stack_tree(got[0]["specs"][0])
    stacked = tsteps.stacked_paths(params1)
    flat1 = tsteps.stack_tree(params1)
    want = {p: torch.stack(v) if p in stacked else v[0] for p, v in flat1.items()}
    scale = max(float(v.abs().max()) for v in want.values())
    halved = 0
    for path, w in want.items():
        spec, halves = _spec_halves(p_sh[path][0])
        spec = ((None,) + tuple(spec)) if path in stacked else tuple(spec)
        halved += halves > 1
        g = _assemble(outs, lambda o, p=path: tsteps._stack(
            o["family_steps"][bits]["params"][p], p in stacked), spec, halves)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4 * scale, err_msg=path)
    assert halved == 4  # the mLSTM's proj_in and w_if, the sLSTM's w_if, its FFN's proj_in
    _check_state(outs, None, got[0]["specs"][1], opt1, get=lambda o: o["family_steps"][bits])


def _expert_moments(opt):
    """The first moments of a state's expert leaves (8-bit: their codes)."""
    return {p: t for p, t in _state_leaves(opt).items()
            if "/moe/experts/" in p and (p.endswith("/m") or p.endswith("/m/q"))}


@pytest.mark.parametrize("bits", [32, 8])
def test_moe_train_step_on_the_mesh_matches_one_process(spawn, bits):
    """The MoE model's ``build_step`` train step (``accum=2``), its experts
    two a rank over ``model`` as ``shard_params`` cuts them. On 1 × 4 (each
    half of the world a replica) against the single process's: loss within
    1e-5, parameters 1e-4 × max, moments as the dense step's. On 2 × 4 the
    load-balance term is each data shard's (the reference's under its mesh,
    ``test_tp_moe_loss_and_gradients``), so the step is not the single
    process's there. On both, every rank's expert moments are non-zero (the
    experts' gradients reach the rank that holds them)."""
    ref, outs, _, _ = spawn
    params1, opt1, loss1 = ref["moe_steps"][bits]
    sub = [dict(o, coord=o["sub"], mesh_shape=(1, 4), moe=o["moe_steps"]["sub", bits])
           for o in outs[:4]]
    for o in sub:
        assert abs(o["moe"]["loss"] - float(loss1)) <= 1e-5
    p_sh = tsteps.stack_tree(sub[0]["moe"]["specs"][0])
    assert p_sh["blocks/moe/experts/w_gate"][0] == (("model", None, None), 1)
    stacked = tsteps.stacked_paths(params1)
    want = {p: torch.stack(v) if p in stacked else v[0]
            for p, v in tsteps.stack_tree(params1).items()}
    scale = max(float(v.abs().max()) for v in want.values())
    for path, w in want.items():
        spec, halves = _spec_halves(p_sh[path][0])
        spec = ((None,) + tuple(spec)) if path in stacked else tuple(spec)
        g = _assemble(sub, lambda o, p=path: tsteps._stack(o["moe"]["params"][p], p in stacked),
                      spec, halves)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4 * scale, err_msg=path)
    _check_state(sub, "moe", sub[0]["moe"]["specs"][1], opt1)
    assert len(_expert_moments(opt1)) == 3
    got = [o["moe"] for o in sub]
    if bits == 32:
        got += [o["moe_steps"]["mesh", 32] for o in outs]
    for g in got:
        assert np.isfinite(g["loss"])
        for path, m in _expert_moments(g["opt"]).items():
            assert m.numel() and bool(m.ne(0).any()), path


def test_moe_decode_of_a_batch_that_does_not_divide(spawn):
    """A decode of one sequence on 2 × 4: the batch does not divide over
    data, so the cache's batch stays whole and its KV heads still split over
    model, a head a rank; the logits and the updated cache are the single
    process's (1e-4 × max)."""
    ref, outs, _, _ = spawn
    cache1, logits1 = ref["moe_steps"]["decode"]
    for o in outs:
        _close(o["moe_decode"]["logits"], logits1.numpy(), 1e-4)
    specs = outs[0]["moe_decode"]["specs"]
    assert tuple(specs["k"]) == tuple(specs["v"]) == (None, None, None, "model", None)
    for key in ("k", "v"):
        got = _assemble(outs, lambda o, k=key: o["moe_decode"]["cache"][k], specs[key])
        _close(got, cache1[key].numpy(), 1e-4, key)


def test_otp_step_on_the_mesh_matches_one_process(spawn):
    _, outs, inp, _ = spawn[0], spawn[1], spawn[3], None
    otp1, opt1, loss1, kl1 = spawn[0]["otp"]
    for o in outs:
        assert abs(o["otp"]["loss"] - float(loss1)) <= 1e-5
        assert abs(o["otp"]["kl"] - float(kl1)) <= 1e-5
        for l, r in enumerate(o["otp"]["otp"]):
            for k in ("fc1", "fc2"):
                _close(r[k], otp1[l][k].numpy(), 1e-4, f"layer {l} {k}")
    _check_state(outs, "otp", outs[0]["otp"]["specs"], opt1)
    assert any(otp1[0]["fc1"].ne(inp["otp"][0]["fc1"]).flatten().tolist())


def test_collective_routes(spawn):
    routes = spawn[1][0]["routes"]
    assert routes[("reduce_scatter", "gloo", "cpu")] == "composed"
    assert routes[("all_gather", "gloo", "cpu")] == "direct"
