"""Where the OTP step's router gradients on four ranks part from one
process's (``chip_smoke.py``'s ``STEPS`` (a)), taken apart layer by layer.

    PYTHONPATH=src python -m repro_torch.launch.probe_otp_grads [--device cpu] [--reduced]

``STEPS`` (a) holds the OTP step's router gradients on ``data=1 × model=4``
to one process's within a fixed ``0.1 × max``. This probe builds the same
model and inputs — the PMQ + OTP model's first ``workload.CUT_LAYERS``
layers built with ``ep=4`` (seed 0), 4 × 64 tokens and the Gumbel uniforms
of generator 21 — and runs the OTP loss (``steps._otp_loss_fn``) three ways:
one process with the grouped GEMMs (the reference run), one process with
``ffn_backend="scan"``, and four ranks over gloo on the same device. Each
run records, layer by layer of the student's forward, the attention's output
(after its all-reduce over ``model`` on the ranks), the OTP router's logits,
its hard Gumbel mask and the FFN's output, then the student's final states;
then the routers' gradients of the KL term (the loss at ``lam`` = 0) and of
the whole loss (``lam`` = 1), the mask-ℓ1 term's being their difference.

It prints one JSON line: for the scan run and each rank, per layer and per
quantity, ``max|Δ| / max|reference|`` against the reference run, the mask
entries that differ, each gradient term's departure, and the first forward
quantity, in the order the forward makes them, that departs by more than the
scan run's whole-loss gradients do. ``--reduced`` runs the reduced config
(a rehearsal on the CPU).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
from typing import Dict, List

import numpy as np
import torch

__all__ = ["main", "trace"]

#: the quantities of a layer, in the order the student's forward makes them
ORDER = ("attention", "router", "otp_logits", "mask", "ffn")


@contextlib.contextmanager
def _recording(rec: List):
    """Append ``(quantity, tensor)`` of the student's forward (the pass with
    a graph; the teacher's runs without one) to ``rec``: each layer's
    outermost attention output, router probabilities, OTP logits, hard mask
    and FFN output, and the final states that the KL reads."""
    from ..core import compressed_moe as cm
    from ..core import otp as otp_mod
    from ..models import layers as L
    from ..models import moe as moe_mod
    from ..models import transformer as tf

    attention, route, logits, mask, ffn, kl = (L.attention, moe_mod.route_topk,
                                               otp_mod.dm_logits, otp_mod.otp_mask,
                                               tf._ffn_delta, L.chunked_kl)
    depth = [0]

    def keep(name, t):
        if torch.is_grad_enabled():
            rec.append((name, t.detach().float().cpu()))

    def attention_(*a, **k):
        depth[0] += 1
        try:
            out = attention(*a, **k)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            keep("attention", out[0])
        return out

    def route_(*a, **k):
        out = route(*a, **k)
        keep("router", out[0])
        return out

    def logits_(*a, **k):
        out = logits(*a, **k)
        keep("otp_logits", out)
        return out

    def mask_(*a, **k):
        out = mask(*a, **k)
        keep("mask", out)
        return out

    def ffn_(*a, **k):
        out = ffn(*a, **k)
        keep("ffn", out[0])
        return out

    def kl_(hs, *a, **k):
        keep("final", hs)
        return kl(hs, *a, **k)

    def patch(fns):
        (L.attention, moe_mod.route_topk, cm.route_topk, otp_mod.dm_logits, otp_mod.otp_mask,
         tf._ffn_delta, L.chunked_kl) = fns

    patch((attention_, route_, route_, logits_, mask_, ffn_, kl_))
    try:
        yield rec
    finally:
        patch((attention, route, route, logits, mask, ffn, kl))


def trace(cfg, mesh, otp, frozen, batch, draws) -> Dict:
    """One run of the OTP loss on ``mesh`` (this rank's blocks): the student's
    forward records (:func:`_recording`, from the ``lam`` = 0 pass) and the
    routers' gradients of the KL term and of the whole loss, numpy on the
    host."""
    from . import steps

    out: Dict = {}
    for lam, key in ((0.0, "kl"), (1.0, "total")):
        live = [{k: v.detach().requires_grad_() for k, v in o.items()} for o in otp]
        student = dict(frozen, layers=[dict(p, otp=o) for p, o in zip(frozen["layers"], live)])
        rec: List = []
        with _recording(rec) if lam == 0.0 else contextlib.nullcontext():
            loss, _ = steps._otp_loss_fn(cfg, mesh, student, frozen, draws, lam=lam)(batch)
        leaves = [t for o in live for t in o.values()]
        gs = torch.autograd.grad(loss, leaves)
        out[key] = [g.float().cpu().numpy() for g in gs]
        if rec:
            out["forward"] = [(name, t.numpy()) for name, t in rec]
    out["mask_l1"] = [t - k for t, k in zip(out["total"], out["kl"])]
    return out


def _rank(rank: int, world: int, payload: Dict) -> Dict:
    from . import steps
    from .mesh import load_rank_kernels, make_test_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    a = payload
    load_rank_kernels(rank, a["batch"]["tokens"].device)
    mesh = make_test_mesh(data=1, model=world)
    art = steps.build_step(a["cfg"], a["shape"], mesh, train_mode="otp")
    otp, _, frozen, batch, draws = steps.shard_args(
        art, (a["otp"], a["opt"], a["frozen"], a["batch"], a["draws"]), mesh, a["cfg"])
    return trace(a["cfg"], mesh, otp, frozen, batch, draws)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _top_sets(probs: np.ndarray, k: int) -> np.ndarray:
    return np.sort(np.argsort(-probs, axis=-1, kind="stable")[:, :k], axis=-1)


def compare(run: Dict, ref: Dict, layers: int, k: int) -> Dict:
    """``run`` against ``ref``: each forward quantity per layer (``max|Δ| /
    max|ref|``; the mask entries that differ; the tokens whose top-``k``
    experts differ, and the least gap of ``ref``'s k-th and (k+1)-th
    probabilities among them, over the k-th), each gradient term over all
    the routers' leaves and per layer (2 leaves a layer: ``fc1``, ``fc2``)."""
    out: Dict = {"layers": []}
    per = len(ORDER)
    for i in range(layers):
        row = {}
        for (name, g), (_, w) in zip(run["forward"][i * per:(i + 1) * per],
                                     ref["forward"][i * per:(i + 1) * per]):
            row[name] = _rel(g, w)
            if name == "mask":  # straight-through values: the hard mask ± rounding
                row["mask_differ"] = int((np.abs(g - w) > 0.5).sum())
            if name == "router":
                flip = (_top_sets(g, k) != _top_sets(w, k)).any(-1)
                row["router_differ"] = int(flip.sum())
                if flip.any():
                    top = -np.sort(-w[flip], axis=-1)
                    row["router_gap"] = float(((top[:, k - 1] - top[:, k]) / top[:, k - 1]).min())
        for term in ("kl", "mask_l1", "total"):
            row[f"grad_{term}"] = max(_rel(g, w) for g, w in zip(run[term][2 * i:2 * i + 2],
                                                                  ref[term][2 * i:2 * i + 2]))
        out["layers"].append(row)
    out["final"] = _rel(run["forward"][-1][1], ref["forward"][-1][1])
    for term in ("kl", "mask_l1", "total"):
        scale = max(float(np.abs(w).max()) for w in ref[term])
        out[f"grad_{term}"] = max(float(np.abs(g - w).max())
                                  for g, w in zip(run[term], ref[term])) / scale
    return out


def first_departure(cmp: Dict, limit: float):
    """The first ``(layer, quantity, departure)`` of the forward, in the order
    it is made, above ``limit``; None if none is."""
    for i, row in enumerate(cmp["layers"]):
        for name in ORDER:
            if row.get(name, 0.0) > limit:
                return i, name, row[name]
    return None


def main(argv=None) -> None:
    from ..configs import ShapeConfig, get_config
    from ..core import otp as otp_mod
    from ..core.synthetic import build_synthetic
    from ..optim.adamw import adamw_init
    from . import probe_otp_grads, steps, workload
    from .mesh import spawn_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (4 KV heads, quant group 32), 2 layers, 16 tokens")
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        from ..kernels import build

        build.timed_build()
    if args.reduced:
        cfg = dataclasses.replace(get_config(workload.ARCH).reduced(), num_kv_heads=4)
        cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, group=32))
        seq = 16
    else:
        cfg = dataclasses.replace(get_config(workload.ARCH), num_layers=workload.CUT_LAYERS)
        seq = workload.PROMPT_LEN
    frozen = build_synthetic(cfg, seed=0, device=dev, ep=args.world)
    otp = [p.pop("otp") for p in frozen["layers"]]
    opt = adamw_init({k: torch.stack([o[k] for o in otp]) for k in ("fc1", "fc2")},
                     steps.OTP_ADAMW)
    gen = torch.Generator().manual_seed(21)
    shape = ShapeConfig("train_4k", seq, 4, "train")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, seq), generator=gen).to(dev)}
    draws = otp_mod.gumbel_uniforms(gen, (4 * seq, cfg.top_k), dev)
    one = steps._one_rank()
    ref = trace(cfg, one, otp, frozen, batch, draws)
    os.environ["REPRO_FFN_BACKEND"] = "scan"
    try:
        scan = trace(cfg, one, otp, frozen, batch, draws)
    finally:
        os.environ.pop("REPRO_FFN_BACKEND")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    payload = {"cfg": cfg, "shape": shape, "otp": otp, "opt": opt, "frozen": frozen,
               "batch": batch, "draws": draws}
    # the module by its name, so that the spawned ranks can import the function
    ranks = spawn_ranks(probe_otp_grads._rank, payload, world=args.world,
                        name="probe_otp_grads")
    layers = cfg.num_layers
    scan_cmp = compare(scan, ref, layers, cfg.top_k)
    out = {"config": f"{cfg.name}, {layers} layers, 4 x {seq} tokens, {dev.type}",
           "scan": scan_cmp, "ranks": [compare(r, ref, layers, cfg.top_k) for r in ranks]}
    limit = scan_cmp["grad_total"]
    out["first_departure_above_scan"] = [first_departure(c, limit) for c in out["ranks"]]
    out["scan_first_departure_above_scan"] = first_departure(scan_cmp, limit)
    if dev.type == "cuda":
        out["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
