"""Training across processes on one machine: ``W`` ranks over gloo, each
running the step builders' steps (:mod:`repro_torch.launch.steps`) on its
blocks of the arguments.

:func:`run` spawns the ranks (:func:`~repro_torch.launch.mesh.spawn_ranks`;
the whole arguments reach them as shared tensors — CUDA IPC on the card,
shared memory on the CPU — and each rank cuts its blocks with
``steps.shard_args``) and returns each rank's results, as numpy arrays and
plain values:

* ``otp``: the OTP step (``train_mode="otp"``) of a PMQ-compressed model
  on a ``data=1 × model=W`` mesh — expert parallelism, tensor-parallel
  attention and shared experts where :func:`~repro_torch.parallel.ep_shardmap.tp_plan`
  splits them —, on the given routers, state, tokens and Gumbel draws:
  first, for the check, the routers' gradients (``steps.otp_gradients``,
  summed over the batch axes) and the sharded AdamW update alone, fed the
  single process's gradients (``grads``), against its updated routers
  (``otp1``) bit for bit; then the step itself: the updated routers, loss
  and KL, the launches of each kernel and the seconds of the step alone,
  and the plan;
* ``train``: full training (``accum``, ZeRO-1, 32-bit moments) of an f32
  model on a ``data=2 × model=W/2`` mesh from the given parameters: the
  first step's gradients on the rank's state blocks against the single
  process's (``grads``, whole; largest difference and largest
  ``|grads|``); the sharded update alone, fed those gradients, against the
  single process's first step (``params1``) bit for bit; then ``steps``
  steps: each one's loss and seconds, the largest difference of the rank's
  parameter blocks from those of ``final`` (the single process's after the
  same steps), the largest ``|final|``, the count of elements more than
  1e-4 of it apart, and the rank's optimizer-state bytes;
* :func:`run_families`, for each model of its list (the ``encdec``,
  ``hybrid`` and ``ssm`` families, f32) one training step's loss and gradients
  (``steps.tree_gradients``) on a ``data=1 × model=W`` mesh, the
  parameters cut by ``shard_params`` with the config: the loss, the
  largest difference of the rank's gradients from its share of the single
  process's (``grads``, cut by the same ``shard_params``) and the largest
  ``|grads|``, the seconds of the step, and the rank's parameter bytes
  beside the whole's and the share the reference's specs give
  (``make_param_shardings``), with the leaves where the two differ;
* each rank's peak device memory, the route each collective took and its
  coordinates.

The kernels must be built before the ranks start: a rank on the card loads
the library and never builds it. ``chip_smoke.py``'s ``STEPS`` path runs
this with four ranks sharing one card.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import torch

__all__ = ["run", "run_families"]


def _bytes(node) -> int:
    if isinstance(node, torch.Tensor):
        return node.numel() * node.element_size()
    if isinstance(node, dict):
        return sum(_bytes(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return sum(_bytes(v) for v in node)
    return 0


def _otp(payload: Dict, mesh, sync) -> Dict:
    from ..kernels import build
    from ..parallel import sharding as shd
    from ..parallel.ep_shardmap import tp_plan
    from . import steps

    a = payload["otp"]
    cfg = a["cfg"]
    art = steps.build_step(cfg, a["shape"], mesh, train_mode="otp")
    otp, opt, frozen, batch, draws = steps.shard_args(
        art, (a["otp"], a["opt"], a["frozen"], a["batch"], a["draws"]), mesh, cfg)
    # the check's work, before the step: the gradients, and the update alone
    # on copies of the routers and state, fed the single process's gradients
    _, _, grads = steps.otp_gradients(cfg, mesh, otp, frozen, batch, draws)
    grads = [{k: v.float().cpu().numpy() for k, v in g.items()} for g in grads]
    plans, _ = steps._train_layout(art.arg_specs[0], mesh, cfg, 32)
    given = steps.stack_tree(a["grads"])
    given = {p: shd.shard_tensor(torch.stack(given[p]), plan.state_spec, mesh)
             for p, plan in plans.items()}
    with torch.no_grad():
        new, _ = steps._zero1_update(plans, steps.stack_tree(steps._own(otp)), given,
                                     steps._own(opt), steps.OTP_ADAMW, mesh)
    want = steps.stack_tree(a["otp1"])
    update_bitwise = all(
        torch.equal(torch.stack(new[p]), shd.shard_tensor(torch.stack(want[p]),
                                                          plan.param_spec, mesh))
        for p, plan in plans.items())
    del new, given
    sync()
    build.reset_launches()
    t0 = time.perf_counter()
    new, _, loss, kl = art.fn(otp, opt, frozen, batch, draws)
    sync()
    step_s = time.perf_counter() - t0
    return {"grads": grads, "update_bitwise": update_bitwise,
            "otp": [{k: v.float().cpu().numpy() for k, v in o.items()} for o in new],
            "loss": float(loss), "kl": float(kl), "launches": dict(build.LAUNCHES),
            "step_s": step_s, "plan": tp_plan(a["frozen"]["layers"][0], mesh, cfg),
            "coord": dict(mesh.coord)}


def _train(payload: Dict, mesh, sync) -> Dict:
    from ..optim.adamw import AdamWConfig
    from ..parallel import sharding as shd
    from ..parallel.ep_shardmap import shard_params
    from . import steps

    t = payload["train"]
    cfg = t["cfg"]
    art = steps.build_step(cfg, t["shape"], mesh, accum=t["accum"])
    params, _, batch = steps.shard_args(art, (t["params"], None, t["batch"]), mesh, cfg)
    opt = steps.init_opt_blocks(art, t["batch"]["tokens"].device)
    plans, _ = steps._train_layout(art.arg_specs[0], mesh, cfg, 32)
    given = {p: shd.shard_tensor(t["grads"][p], plan.state_spec, mesh) for p, plan in plans.items()}
    with torch.no_grad():  # the sharded update alone, on the single process's gradients
        new, _ = steps._zero1_update(plans, steps.stack_tree(steps._own(params)), given,
                                     steps.init_opt_blocks(art, opt["step"].device),
                                     AdamWConfig(), mesh)
    want = steps.stack_tree(shard_params(t["params1"], mesh, cfg))
    update_bitwise = all(torch.equal(a, b) for p in want for a, b in zip(new[p], want[p]))
    del new, want
    if t["batch"]["tokens"].is_cuda:  # the copies' blocks go back to the card
        gc.collect()
        torch.cuda.empty_cache()
    losses, times = [], []
    # the first step as the step makes it — its gradients, held to the single
    # process's, then its update — and the others through ``art.fn``
    sync()
    t0 = time.perf_counter()
    loss, grads = art.grads(params, batch)
    grad_err = max(float((grads[p] - given[p]).abs().max()) for p in plans)
    grad_scale = max(float(g.abs().max()) for g in given.values())
    del given
    with torch.no_grad():
        steps._zero1_update(plans, steps.stack_tree(params), grads, opt, AdamWConfig(), mesh)
    del grads
    for i in range(t["steps"]):
        if i:
            params, opt, loss = art.fn(params, opt, batch)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        t0 = time.perf_counter()
    want = steps.stack_tree(shard_params(t["final"], mesh, cfg))
    got = steps.stack_tree(params)
    err = max(float((g - w).abs().max()) for p in want for g, w in zip(got[p], want[p]))
    scale = max(float(w.abs().max()) for p in want for w in want[p])
    lr2 = 2 * AdamWConfig().lr * len(times)
    beyond = sum(int(((g - w).abs() > 1e-4 * scale).sum()) for p in want
                 for g, w in zip(got[p], want[p]))
    return {"losses": losses, "step_s": times, "max_err": err, "scale": scale,
            "beyond": beyond, "update_bound": lr2, "grad_err": grad_err,
            "grad_scale": grad_scale, "update_bitwise": update_bitwise,
            "state_bytes": _bytes(opt["per_param"]), "coord": dict(mesh.coord)}


def _share_bytes(params, mesh) -> Dict[str, tuple]:
    """``{path: (whole bytes, the reference's share)}`` of every tensor of a
    whole per-layer tree under the reference's specs (``_PARAM_RULES``,
    replicated where a spec does not divide)."""
    from ..core.tree import tree_paths
    from ..parallel import sharding as shd

    specs = dict(tree_paths(shd.make_param_shardings(mesh, params, stacked_prefixes=())))
    out = {}
    for path, t in tree_paths(params):
        n = t.numel() * t.element_size()
        ext = math.prod(mesh.extent(e) for e in specs[path].spec if e is not None)
        out["/".join(map(str, path))] = (n, n // ext)
    return out


def _families(payload: Dict, mesh, sync) -> Dict:
    from ..core.tree import tree_leaves, tree_paths
    from ..parallel.ep_shardmap import shard_params, tp_plan
    from . import steps

    out = {}
    for case in payload["families"]:
        cfg = case["cfg"]
        local = shard_params(case["params"], mesh, cfg)
        sync()
        t0 = time.perf_counter()
        loss, grads = steps.tree_gradients(cfg, local, case["batch"], mesh)
        sync()
        step_s = time.perf_counter() - t0
        want = shard_params(case["grads"], mesh, cfg)
        err = max(float((g - w).abs().max()) for g, w in zip(tree_leaves(grads),
                                                              tree_leaves(want)) if g.numel())
        scale = max(float(w.abs().max()) for w in tree_leaves(case["grads"]) if w.numel())
        shares = _share_bytes(case["params"], mesh)
        mine = {"/".join(map(str, p)): t.numel() * t.element_size()
                for p, t in tree_paths(local)}
        block = case["params"].get("layers") or case["params"].get("dec_blocks") or \
            case["params"]["groups"]
        out[case["name"]] = {
            "loss": float(loss), "grad_err": err, "grad_scale": scale, "step_s": step_s,
            "bytes": sum(mine.values()), "whole": sum(b for b, _ in shares.values()),
            "reference": sum(r for _, r in shares.values()),
            "differ": sorted(p for p, b in mine.items() if b != shares[p][1]),
            "plan": tp_plan(block[0], mesh, cfg)}
        del local, grads, want
    return out


def _cases(rank: int, world: int, payload: Dict) -> Dict:
    from ..parallel.sharding import ROUTES
    from .mesh import load_rank_kernels, make_test_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = payload["train"]["batch"]["tokens"].device
    load_rank_kernels(rank, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def peak():
        return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    mesh_otp = make_test_mesh(data=1, model=world)
    mesh_train = make_test_mesh(data=2, model=world // 2)
    out = {"otp": _otp(payload, mesh_otp, sync), "otp_peak": peak()}
    if device.type == "cuda":  # the OTP step's cached blocks go back to the card
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    out["train"] = _train(payload, mesh_train, sync)
    out["train_peak"] = peak()
    out["routes"] = dict(ROUTES)
    return out


def _family_cases(rank: int, world: int, payload: Dict) -> Dict:
    from ..parallel.sharding import ROUTES
    from .mesh import make_test_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = payload["families"][0]["batch"]["tokens"].device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {"families": _families(payload, make_test_mesh(data=1, model=world), sync),
           "peak": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None}
    out["routes"] = dict(ROUTES)
    return out


def run_families(payload: Dict, *, world: int) -> List[Dict]:
    """Spawn ``world`` ranks over ``{"families": [{name, cfg, params, batch,
    grads}, ...]}`` (whole tensors; ``grads`` the single process's, a tree
    like ``params``) and return each rank's ``families`` results, its peak
    device memory and its routes, by rank."""
    from .mesh import spawn_ranks

    return spawn_ranks(_family_cases, payload, world=world, name="family step")


def run(payload: Dict, *, world: int) -> List[Dict]:
    """Spawn ``world`` ranks over ``payload`` (``{"otp": {cfg, shape, otp,
    opt, frozen, batch, draws, grads, otp1}, "train": {cfg, shape, accum,
    steps, params, grads, params1, final, batch}}``, whole tensors) and
    return their results, by rank
    (:func:`~repro_torch.launch.mesh.spawn_ranks`: fails if a rank fails or
    misses the deadline; every rank process is ended before it returns)."""
    from .mesh import spawn_ranks

    return spawn_ranks(_cases, payload, world=world, name="step")
