"""One rank of the expert-parallel spawn of ``tests/test_torch_ep_ranks.py``.

    python tests/_torch_ep_worker.py RANK WORLD DIR

Joins a gloo group of ``WORLD`` ranks through a ``FileStore`` in ``DIR``,
reads ``DIR/inputs.pt`` (the port's tensors, written by the test process),
runs every case under its mesh and writes its results to
``DIR/out_<RANK>.pt``. It imports torch and the port only; the reference's
outputs are computed in the test process.
"""
from __future__ import annotations

import contextlib
import os
import sys
import tempfile

import torch


@contextlib.contextmanager
def _recording(moe_mod):
    """Record the region's capacity dispatch (its inputs ``local_idx``,
    ``sel``, ``cap`` and the token count; its ``dest``, ``valid`` and the
    ``slot_fill`` counted from them) while the block runs."""
    rec = {}
    dispatch, fill = moe_mod.capacity_dispatch, moe_mod.slot_fill_counts

    def dispatch_logged(x2, idx, gates, num, cap, gate_mask=None):
        out = dispatch(x2, idx, gates, num, cap, gate_mask=gate_mask)
        rec.update(tokens=x2.shape[0], local_idx=idx, sel=gate_mask, cap=cap, dest=out[1],
                   valid=out[2])
        return out

    def fill_logged(*args):
        rec["slot_fill"] = fill(*args)
        return rec["slot_fill"]

    moe_mod.capacity_dispatch, moe_mod.slot_fill_counts = dispatch_logged, fill_logged
    try:
        yield rec
    finally:
        moe_mod.capacity_dispatch, moe_mod.slot_fill_counts = dispatch, fill


def _cases(rank: int, d: str) -> dict:
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.compressed_moe import compressed_moe_layer
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.models import transformer as ttf
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.moe import moe_layer
    from repro_torch.optim.grad_compress import compressed_psum
    from repro_torch.parallel.ep_shardmap import shard_experts, shard_params
    from repro_torch.parallel.sharding import (
        EPRegionError,
        make_param_shardings,
        sharding_rules,
    )
    from repro_torch.runtime.elastic import reshard_tree, shrink_mesh

    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    cfg = inp["cfg"]
    p, x, otp = inp["p"], inp["x"], inp["otp"]
    ce1, ce4 = inp["ce1"], inp["ce4"]
    out = {}

    # ---- data=2 × model=4: the reference test's three cases and more
    mesh = make_test_mesh(data=2, model=4)
    out["coord"] = dict(mesh.coord)
    b_loc = x.shape[0] // mesh.shape["data"]
    xl = x[mesh.coord["data"] * b_loc:(mesh.coord["data"] + 1) * b_loc]
    ce4_local = shard_experts(ce4, mesh)
    out["expert_bytes"] = ce4_local.weight_bytes
    # the experts alone cut (the shared MLP whole), then the whole layer as
    # shard_params cuts it: the shared MLP too, by columns
    p_tp = shard_params({"layers": [{"moe": p}]}, mesh, cfg)["layers"][0]["moe"]
    p_local = dict(p, experts=p_tp["experts"])
    out["bf16_rows"] = p_local["experts"]["w_gate"].shape[0]
    out["bf16_tp_cols"] = p_tp["shared"]["w_gate"]["w"].shape[1]
    with sharding_rules(mesh):
        mo = moe_layer(p, xl, cfg)
        out["bf16"], out["bf16_aux"] = mo.y, mo.aux_loss
        out["bf16_cut"] = moe_layer(p_local, xl, cfg).y
        out["bf16_tp"] = moe_layer(p_tp, xl, cfg).y
        y, info = compressed_moe_layer(p, ce4_local, xl, cfg, otp_params=otp)
        out["pmq"], out["pmq_mask_l1"] = y, info["mask_l1"]
        y2, _ = compressed_moe_layer(p, ce4_local, xl, cfg, otp_params=otp)
        out["pmq_bitwise"] = torch.equal(y, y2)
        out["pmq_scan"], _ = compressed_moe_layer(p, ce4, xl, cfg, otp_params=otp,
                                                  ffn_backend="scan")
        with _recording(moe_mod) as rec:
            compressed_moe_layer(p, ce4, xl, cfg, otp_params=otp)
        out["dispatch_replicate"] = rec
        try:
            compressed_moe_layer(p, ce1, xl, cfg)
        except EPRegionError as e:
            out["error_counts"] = str(e)
        try:
            moe_layer(p, xl, cfg, expert_ffn_fn=lambda xp: xp)
        except EPRegionError as e:
            out["error_hook"] = str(e)
        os.environ["REPRO_ETP_REPLICATE_MAX"] = "1"
        out["gather"], _ = compressed_moe_layer(p, ce4_local, xl, cfg)
        with _recording(moe_mod) as rec:
            compressed_moe_layer(p, ce4, xl, cfg)
        out["dispatch_gather"] = rec
        del os.environ["REPRO_ETP_REPLICATE_MAX"]

    # ---- data=1 × model=4 sub-meshes: the reduced PMQ + OTP model decoded
    sub = make_test_mesh(data=1, model=4)
    m = inp["model"]
    mcfg = m["cfg"]
    local = shard_params(m["params"], sub, mcfg)
    with sharding_rules(sub):
        cache, logits = ttf.prefill(local, {"tokens": m["prompts"]}, mcfg)
        cache = ttf.extend_cache(cache, m["steps"])
        pos = m["prompts"].shape[1]
        toks, steps = [], [logits[:, -1]]
        for i in range(m["steps"]):
            cur = logits[:, -1].argmax(-1)[:, None]
            toks.append(cur)
            cache, logits = ttf.decode_step(local, cache, cur, pos + i, mcfg)
            steps.append(logits[:, -1])
    out["greedy_tokens"] = torch.cat(toks, dim=1)
    out["greedy_logits"] = torch.stack(steps, dim=1)

    # ---- elastic: 2 × 4 → shrunk to 1 × 4, restored from a checkpoint
    params = {"embed": torch.arange(32.0).reshape(8, 4),
              "blocks": {"attn": {"wq": {"w": torch.ones(2, 4, 8)}}}}
    sh = make_param_shardings(mesh, params)
    out["specs"] = (sh["embed"].spec, sh["blocks"]["attn"]["wq"]["w"].spec)
    out["placed_embed"] = reshard_tree(params, sh)["embed"].clone()
    ck = Checkpointer(os.path.join(d, "ckpt"), async_write=False)
    if rank == 0:
        ck.save(0, params)
    dist.barrier()
    small = shrink_mesh(mesh, 1)
    out["small"] = (small.ranks.shape, small.coord)
    if small.coord is not None:
        restored = ck.restore(0, params, shardings=make_param_shardings(small, params))
        out["restored"] = (restored["embed"], restored["blocks"]["attn"]["wq"]["w"])
    g = torch.randn(300, generator=torch.Generator().manual_seed(rank))
    res = torch.randn(300, generator=torch.Generator().manual_seed(100 + rank)) * 1e-3
    out["psum"] = compressed_psum(g, mesh, "data", res)
    try:
        make_production_mesh()
    except ValueError as e:
        out["production_error"] = str(e)
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
    tmp = tempfile.NamedTemporaryFile(dir=d, delete=False)
    torch.save(out, tmp)
    tmp.close()
    os.replace(tmp.name, os.path.join(d, f"out_{rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
