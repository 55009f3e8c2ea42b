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
* ``build_step`` train steps (``accum=2``, ZeRO-1, 32- and 8-bit moments) of
  the dense model and one OTP step of a PMQ model (tensor-parallel 4-bit
  attention and shared experts, ETP experts): the ranks' parameters,
  all-gathered, and their optimizer-state blocks, concatenated, against the
  single process's step — loss 1e-5, parameters and moments 1e-4 × max,
  8-bit codes at most one apart (gradients summed in another order); each
  rank's 32-bit state an eighth of the whole but for the norms, which only
  ``data`` splits; the ZeRO-1 update alone, fed the single process's
  gradients, equal to it byte for byte.
"""
import dataclasses
import json
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
np.savez(out, **res)
print("OK")
"""


def _jax_mesh_reference(d: Path) -> dict:
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/root"), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", _SNIPPET, str(d / "ref.npz"), json.dumps(CFG_KW),
                        MOE, json.dumps(WIDE)], capture_output=True, text=True, timeout=600,
                       env=env, cwd=ROOT)
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
    return ({"cfg": tcfg, "shape": shape, "params": params, "batch": batch,
             "opt32": single[32][1], "opt8": single[8][1],
             "grads": {p: torch.from_numpy(v) for p, v in g.items()}}, single)


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
    train, ref["train"] = _train_inputs()
    otp, ref["otp"] = _otp_inputs()
    torch.save({"ep": ep, "tp": tp, "train": train, "otp": otp}, d / "inputs.pt")
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


# ------------------------------------------------------------ the steps
def _assemble(outs, get, spec):
    """The whole tensor from the ranks' blocks under ``spec`` (replicas:
    the first rank's)."""
    from repro_torch.parallel.sharding import Mesh

    blocks, sizes = {}, {}
    for o in outs:
        m = Mesh(("data", "model"), (2, 4), coord=(o["coord"]["data"], o["coord"]["model"]))
        key = tuple(0 if n is None else m.index(n) for n in spec)
        sizes = {ax: m.extent(n) for ax, n in enumerate(spec) if n is not None}
        blocks.setdefault(key, get(o))

    def build(prefix):
        ax = len(prefix)
        if ax == len(spec):
            return blocks[prefix]
        parts = [build(prefix + (i,)) for i in range(sizes.get(ax, 1))]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=ax)

    return build(())


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


def _check_state(outs, key, specs, want, exact=False):
    sh = _state_leaves(specs)
    for path, w in _state_leaves(want).items():
        got = _assemble(outs, lambda o, p=path: _state_leaves(o[key]["opt"])[p], sh[path])
        if exact:
            assert torch.equal(got, w), path
        elif w.dtype == torch.int8:
            assert (got.int() - w.int()).abs().max() <= 1, path
        else:
            _close(got, w.numpy(), 1e-4, path)


@pytest.mark.parametrize("bits", [32, 8])
def test_train_step_on_the_mesh_matches_one_process(spawn, bits):
    _, outs, train, single = spawn[0], spawn[1], spawn[2], spawn[0]["train"]
    (params1, opt1, loss1), _ = single[bits]
    key = f"train{bits}"
    for o in outs:
        assert abs(o[key]["loss"] - float(loss1)) <= 1e-5
    p_sh = tsteps.stack_tree(outs[0][f"specs{bits}"][0])
    want = {p: _stacked(tsteps.stack_tree(params1), p) for p in p_sh}
    scale = max(float(v.abs().max()) for v in want.values())
    for path, w in want.items():
        spec = p_sh[path][0]
        spec = ((None,) + tuple(spec)) if path.startswith("blocks/") else tuple(spec)
        got = _assemble(outs, lambda o, p=path: _stacked(o[key]["params"], p), spec)
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=path)
    _check_state(outs, key, outs[0][f"specs{bits}"][1], opt1)
    if bits == 32:  # ZeRO-1 over data × model: an eighth of each moment, data only for norms
        mine = _state_leaves(outs[0][key]["opt"]["per_param"])
        whole = _state_leaves(opt1["per_param"])
        for path, w in whole.items():
            norm = any(n in path for n in ("ln1", "ln2", "final_norm"))
            assert mine[path].numel() * (2 if norm else 8) == w.numel(), path


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
