"""One rank of the training spawn of ``tests/test_torch_steps_ranks.py``.

    python tests/_torch_steps_worker.py RANK WORLD DIR

Joins a gloo group of ``WORLD`` ranks through a ``FileStore`` in ``DIR``,
reads ``DIR/inputs.pt`` (the port's tensors, written by the test process),
runs every case on its mesh and writes its results to ``DIR/out_<RANK>.pt``:
gradients through both expert-parallel regions, tensor-parallel
``train_loss`` gradients (the dense and MoE models, and the ``encdec``,
``hybrid`` and ``ssm`` families), the vocabulary-parallel ``chunked_kl``,
a greedy decode with vocabulary-parallel logits, ``build_step`` train and OTP steps (the
train steps' collectives recorded by kind; the MoE model's experts over
``model``), an MoE decode of one sequence, the ZeRO-1 update on given gradients. It imports torch and the port only.
"""
from __future__ import annotations

import os
import sys

import torch


def _leaves(tree, prefix=""):
    """``{path: tensor}`` of the float tensors of a tree of dicts."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            out[path] = v
    return out


def _with_grad(tree):
    return {k: _with_grad(v) if isinstance(v, dict) else
            (v.detach().clone().requires_grad_() if isinstance(v, torch.Tensor)
             and v.is_floating_point() else v) for k, v in tree.items()}


def _specs(tree, halves=False):
    """A tree of shardings as their specs (a mesh holds process groups,
    which do not pickle); with ``halves`` each as ``(spec, halves)``."""
    from repro_torch.optim.adamw import Q8
    from repro_torch.parallel.sharding import NamedSharding

    if isinstance(tree, NamedSharding):
        return (tree.spec, tree.halves) if halves else tree.spec
    if isinstance(tree, dict):
        return {k: _specs(v, halves) for k, v in tree.items()}
    if isinstance(tree, Q8):
        return Q8(*(_specs(v, halves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_specs(v, halves) for v in tree)
    return tree


def _grads(loss, named):
    names = list(named)
    gs = torch.autograd.grad(loss, [named[n] for n in names], allow_unused=True)
    return {n: (torch.zeros_like(named[n]) if g is None else g) for n, g in zip(names, gs)}


def _block(t, mesh, b):
    d = mesh.coord["data"]
    return t[d * b:(d + 1) * b]


def _regions(inp, mesh):
    """Gradients of ``sum(y · w) + aux`` (bf16 region) and ``sum(y · w) +
    mask_l1`` (compressed region, ``replicate_tokens`` and
    ``gather_weights``) on this rank's batch block."""
    from repro_torch.core.compressed_moe import compressed_moe_layer
    from repro_torch.models.moe import moe_layer
    from repro_torch.parallel.ep_shardmap import shard_experts
    from repro_torch.parallel.sharding import sharding_rules

    ep = inp["ep"]
    cfg, x, w = ep["cfg"], ep["x"], ep["w"]
    b = x.shape[0] // mesh.shape["data"]
    out = {}
    xl = _block(x, mesh, b).clone().requires_grad_()
    wl = _block(w, mesh, b)
    p = _with_grad(ep["p"])
    with sharding_rules(mesh):
        mo = moe_layer(p, xl, cfg)
        loss = (mo.y * wl).sum() + mo.aux_loss
    out["bf16"] = _grads(loss, {"x": xl, **_leaves(p)})
    ce = shard_experts(ep["ce4"], mesh)
    for mode in ("replicate", "gather"):
        p = _with_grad({k: v for k, v in ep["p"].items() if k != "experts"})
        otp = _with_grad(ep["otp"])
        xl = _block(x, mesh, b).clone().requires_grad_()
        if mode == "gather":
            os.environ["REPRO_ETP_REPLICATE_MAX"] = "1"
            u = ep["u_gather"]
        else:
            u = _block(ep["u_replicate"].reshape(x.shape[0], -1, 2), mesh, b).reshape(-1, 2)
        try:
            with sharding_rules(mesh):
                y, info = compressed_moe_layer(p, ce, xl, cfg, otp_params=otp, otp_rng=u)
                loss = (y * wl).sum() + info["mask_l1"]
        finally:
            os.environ.pop("REPRO_ETP_REPLICATE_MAX", None)
        out[mode] = _grads(loss, {"x": xl, **_leaves(p), **_leaves(otp, "otp")})
        out[f"{mode}_mask_l1"] = float(info["mask_l1"])
    return out


def _tp_loss(case, mesh):
    """``train_loss`` and its gradients (this rank's blocks, by the
    reference's stacked path) on the rank's batch block, the parameters cut
    by ``shard_params`` with the config."""
    from repro_torch.launch.steps import stack_tree
    from repro_torch.models.transformer import train_loss
    from repro_torch.parallel.ep_shardmap import shard_params, tp_plan
    from repro_torch.parallel.sharding import sharding_rules

    cfg, params, batch = case["cfg"], case["params"], case["batch"]
    local = shard_params(params, mesh, cfg)
    local = dict(_with_grad({k: v for k, v in local.items() if k != "layers"}),
                 layers=[_with_grad(p) for p in local["layers"]])
    b = batch["tokens"].shape[0] // mesh.shape["data"]
    with sharding_rules(mesh):
        loss, _ = train_loss(local, {k: _block(v, mesh, b) for k, v in batch.items()}, cfg)
    flat = stack_tree(local)
    leaves = [t for v in flat.values() for t in v]
    gs = iter(torch.autograd.grad(loss, leaves))
    grads = {p: torch.stack([next(gs) for _ in v]) if p.startswith("blocks/") else next(gs)
             for p, v in flat.items()}
    return {"loss": float(loss), "grads": grads, "plan": tp_plan(params["layers"][0], mesh, cfg)}


def _families(inp, mesh):
    """Each family's ``train_loss`` and its gradients (a tree like the
    parameters: the rank's share of each) on the rank's batch block, the
    parameters cut by ``shard_params`` with the config; the rank's
    parameter shapes and the plan of its first block."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.steps import tree_gradients
    from repro_torch.parallel.ep_shardmap import shard_params, tp_plan

    out = {}
    for name, case in inp["families"].items():
        cfg, params, batch = case["cfg"], case["params"], case["batch"]
        local = shard_params(params, mesh, cfg)
        b = batch["tokens"].shape[0] // mesh.shape["data"]
        loss, grads = tree_gradients(cfg, local, {k: _block(v, mesh, b)
                                                  for k, v in batch.items()}, mesh)
        first = next(params[k][0] for k in ("dec_blocks", "groups", "layers") if k in params)
        out[name] = {"loss": float(loss), "grads": grads, "plan": tp_plan(first, mesh, cfg),
                     "bytes": sum(t.numel() * t.element_size() for t in tree_leaves(local))}
    return out


def _kl(inp, mesh):
    """``chunked_kl`` with the vocabulary split over ``model``: the loss and
    the gradients of the rank's student states and vocabulary rows."""
    from repro_torch.models import layers as L
    from repro_torch.parallel.ep_shardmap import shard_params
    from repro_torch.parallel.sharding import sharding_rules

    k = inp["kl"]
    b = k["hs"].shape[0] // mesh.shape["data"]
    hs = _block(k["hs"], mesh, b).clone().requires_grad_()
    emb = shard_params({"embed": k["emb"]}, mesh, _Vocab(k["emb"].shape[0]))["embed"]
    emb = emb.clone().requires_grad_()
    with sharding_rules(mesh):
        loss = L.chunked_kl(hs, _block(k["ht"], mesh, b), emb, 8, k["emb"].shape[0])
    g_hs, g_emb = torch.autograd.grad(loss, [hs, emb])
    return {"loss": float(loss), "hs": g_hs, "emb": g_emb}


class _Vocab:
    """The one field of a config :func:`shard_params` reads of a tree that
    holds only an embedding."""

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size


def _greedy(inp, mesh):
    """Greedy tokens of the dense model (a tie planted across a vocabulary
    shard boundary) decoded on the rank's batch block."""
    from repro_torch.launch import workload
    from repro_torch.parallel.ep_shardmap import shard_params
    from repro_torch.parallel.sharding import sharding_rules

    g = inp["greedy"]
    local = shard_params(g["params"], mesh, g["cfg"])
    b = g["batch"]["tokens"].shape[0] // mesh.shape["data"]
    with sharding_rules(mesh):
        toks, _, _, _ = workload.greedy_family(
            g["cfg"], local, {k: _block(v, mesh, b) for k, v in g["batch"].items()}, g["steps"])
    return toks


def _steps(inp, mesh, sub):
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamWConfig

    out = {}
    tr = inp["train"]
    for bits in (32, 8):
        art = steps.build_step(tr["cfg"], tr["shape"], mesh, accum=2, state_bits=bits)
        whole = (tr["params"], tr[f"opt{bits}"], tr["batch"])
        ledger = steps.shd.CollectiveLedger()
        with steps.shd.counting(ledger):  # recorded as the step runs them
            params, opt, loss = art.fn(*steps.shard_args(art, whole, mesh, tr["cfg"]))
        out[f"ledger{bits}"] = (ledger.bytes, ledger.counts)
        out[f"train{bits}"] = {"params": steps.stack_tree(params), "opt": opt,
                               "loss": float(loss)}
        # the sharded update alone, fed the same gradients as one process
        args = steps.shard_args(art, whole, mesh, tr["cfg"])
        plans, _ = steps._train_layout(art.arg_specs[0], mesh, tr["cfg"], bits)
        grads = {}
        for path, plan in plans.items():
            g = tr["grads"][path]
            grads[path] = (steps._chunk(g.reshape(-1), plan, mesh) if plan.flat is not None
                           else steps.shd.shard_tensor(g, plan.state_spec, mesh))
        new, nst = steps._zero1_update(plans, steps.stack_tree(args[0]), grads, args[1],
                                       AdamWConfig(state_bits=bits), mesh)
        out[f"zero1_{bits}"] = {"params": new, "opt": nst}
        out[f"specs{bits}"] = _specs(art.in_shardings[:2])
    mi = tr["micro"]
    art = steps.build_step(tr["cfg"], mi["shape"], mesh, accum=2)
    args = steps.shard_args(art, (tr["params"], mi["opt"], mi["batch"]), mesh, tr["cfg"])
    grads_loss, grads = art.grads(args[0], args[2])
    plans, _ = steps._train_layout(art.arg_specs[0], mesh, tr["cfg"], 32)
    want = {p: steps.shd.shard_tensor(mi["grads"][p], plan.state_spec, mesh)
            for p, plan in plans.items()}
    rows = steps._micro_rows(mi["batch"]["tokens"].shape[0], 2, mesh)
    params, opt, loss = art.fn(*args)
    out["micro"] = {"rows": tuple(args[2]["tokens"].shape),
                    "micro_rows": [(r.start, r.stop) for r in rows],
                    "grads_loss": float(grads_loss), "grads": grads, "want": want,
                    "params": steps.stack_tree(params), "opt": opt, "loss": float(loss),
                    "specs": _specs(art.in_shardings[:2])}
    x = inp["families"]["xlstm"]
    out["family_steps"] = {}
    for bits, opt in x["zero1"].items():
        art = steps.build_step(x["cfg"], x["shape"], mesh, state_bits=bits)
        params, opt, loss = art.fn(*steps.shard_args(art, (x["params"], opt, x["batch"]), mesh,
                                                     x["cfg"]))
        out["family_steps"][bits] = {"params": steps.stack_tree(params), "opt": opt,
                                     "loss": float(loss),
                                     "specs": _specs(art.in_shardings[:2], halves=True)}
    mo = inp["moe"]
    out["moe_steps"] = {}
    for key, m, bits in (("sub", sub, 32), ("sub", sub, 8), ("mesh", mesh, 32)):
        art = steps.build_step(mo["cfg"], mo["shape"], m, accum=2, state_bits=bits)
        params, opt, loss = art.fn(*steps.shard_args(
            art, (mo["params"], mo[f"opt{bits}"], mo["batch"]), m, mo["cfg"]))
        out["moe_steps"][key, bits] = {"params": steps.stack_tree(params), "opt": opt,
                                       "loss": float(loss),
                                       "specs": _specs(art.in_shardings[:2], halves=True)}
    dec = mo["decode"]
    art = steps.build_step(mo["cfg"], dec["shape"], mesh, precision="bf16")
    cache, logits = art.fn(*steps.shard_args(
        art, (mo["params"], dec["cache"], dec["token"], dec["pos"]), mesh, mo["cfg"]))
    out["moe_decode"] = {"cache": cache, "logits": logits, "specs": _specs(art.in_shardings[1])}
    ot = inp["otp"]
    art = steps.build_step(ot["cfg"], ot["shape"], mesh, train_mode="otp", accum=2)
    args = steps.shard_args(art, (ot["otp"], ot["opt"], ot["frozen"], ot["batch"], ot["u"]),
                            mesh, ot["cfg"])
    otp, opt, loss, kl = art.fn(*args)
    out["otp"] = {"otp": otp, "opt": opt, "loss": float(loss), "kl": float(kl),
                  "specs": _specs(art.in_shardings[1])}
    return out


def _cases(rank: int, d: str) -> dict:
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import ROUTES

    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    mesh = make_test_mesh(data=2, model=4)
    sub = make_test_mesh(data=1, model=4)
    out = {"coord": dict(mesh.coord), "sub": dict(sub.coord)}
    out.update(_regions(inp, mesh))
    out["tp_dense"] = _tp_loss(inp["tp"]["dense"], mesh)
    out["tp_moe"] = _tp_loss(inp["tp"]["moe"], mesh)
    out["tp_moe_sub"] = _tp_loss(inp["tp"]["moe"], sub)
    out["families"] = _families(inp, mesh)
    out["greedy"] = _greedy(inp, mesh)
    out["kl"] = _kl(inp, mesh)
    build.reset_launches()
    out.update(_steps(inp, mesh, sub))
    out["routes"] = dict(ROUTES)
    return out


def main() -> int:
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}",
                            rank=rank, world_size=world)
    try:
        out = _cases(rank, d)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(d, f"out_{rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
