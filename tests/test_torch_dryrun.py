"""The port's dry run (``repro_torch.launch.dryrun``) on ``meta`` tensors.

* ``run_cell`` on the reduced configs (4 × 64 tokens) on a process-less
  ``2 × 4`` view, for the reference's four dry-run cells
  (``tests/test_dryrun_cells.py``: tinyllama train, moonshot's quantized
  decode, kimi-k2's OTP train, xlstm ``long_500k``) and for whisper's and
  recurrentgemma's ``train_4k`` (the MoE configs with 64 experts, so that
  their PMQ buckets split over model = 4): the step names are the reference
  ``build_step``'s, the JSON has the reference's keys where the quantity
  is the same (``flops_per_dev`` for ``hlo_flops_per_dev``, ``trace_s`` for
  ``lower_s``/``compile_s``, ``fits_80gb`` for ``fits_16gb``), FLOPs are
  positive, the argument bytes are the sum of the rank's ``shard_args``
  blocks, and the quantized decode counts its kernels;
* ``production_view``: the reference's shapes and a rank's coordinate, no
  process groups;
* one CLI run at full width (tinyllama-1.1b ``train_4k`` on the single-pod
  mesh) writes its JSON.

The 8-rank spawn of ``tests/test_torch_steps_ranks.py`` holds the ledger's
collective bytes to a real step's on every rank.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import production_view  # noqa: E402
from repro_torch.parallel.sharding import Mesh  # noqa: E402

from _torch_interop import torch_one_thread  # noqa: E402,F401

#: the MoE cells' reduced configs with 64 experts: ``synthetic_compressed_experts``
#: then cuts buckets in multiples of 16 that split over model = 4 (8 experts
#: give buckets of 1, 4 and 3, which the port's EP region refuses where the
#: reference would leave its region: ``ROADMAP.md`` §3)
EXPERTS = {"moonshot-v1-16b-a3b": 64, "kimi-k2-1t-a32b": 64}
CELLS = [("tinyllama-1.1b", "train_4k"), ("moonshot-v1-16b-a3b", "decode_32k"),
         ("kimi-k2-1t-a32b", "train_4k"), ("xlstm-350m", "long_500k"),
         ("whisper-small", "train_4k"), ("recurrentgemma-2b", "train_4k")]
KEYS = {"arch", "shape", "mesh", "chips", "step", "meta", "trace_s", "flops_per_dev",
        "flops_by_dtype", "hbm_bytes_per_dev", "collective_bytes_per_dev",
        "collective_counts", "launches", "memory", "compute_term_s", "memory_term_s",
        "collective_term_s", "dominant"}
MEMORY = {"argument", "output", "temp", "alias", "per_device_total", "fits_80gb"}


def _arg_bytes(art, mesh, cfg):
    with torch.device("meta"):
        args = steps.shard_args(art, art.arg_specs, mesh, cfg)
    return sum(t.untyped_storage().nbytes() for t in {
        id(t.untyped_storage()): t for t in dryrun._leaves(args)}.values())


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_run_cell_on_a_rank_view(arch, shape_name, torch_one_thread):
    jcfg, cfg = jreg.get_config(arch).reduced(), treg.get_config(arch).reduced()
    if arch in EXPERTS:
        cfg = dataclasses.replace(cfg, num_experts=EXPERTS[arch])
    shape = dataclasses.replace(tbase.SHAPES[shape_name], seq_len=64, global_batch=4)
    jshape = dataclasses.replace(jbase.SHAPES[shape_name], seq_len=64, global_batch=4)
    mesh = Mesh(("data", "model"), (2, 4), coord=(0, 0))
    r = dryrun.run_cell(arch, shape_name, False, cfg=cfg, shape=shape, mesh=mesh, out_dir=None,
                        quiet=True)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    assert r["step"] == jsteps.build_step(jcfg, jshape, jmesh).name
    assert set(r) == KEYS and set(r["memory"]) == MEMORY
    assert r["flops_per_dev"] > 0 and r["hbm_bytes_per_dev"] > 0 and r["chips"] == 8
    art = steps.build_step(cfg, shape, mesh)
    last = Mesh(("data", "model"), (2, 4), coord=(1, 3))
    assert r["memory"]["argument"] == _arg_bytes(art, mesh, cfg) >= _arg_bytes(art, last, cfg)
    assert r["memory"]["per_device_total"] == r["memory"]["argument"] + r["memory"]["temp"]
    assert r["dominant"] in ("compute_term_s", "memory_term_s", "collective_term_s")
    if r["meta"].get("precision") == "quant":  # PMQ: every dense linear and expert GEMM
        assert set(r["launches"]) == {"quant_matmul", "moe_gmm_swiglu", "moe_gmm"}
    if r["step"] == "train_step":  # ZeRO-1 and the batch sums over data
        assert r["collective_counts"].get("reduce-scatter", 0) > 0
    if r["step"] == "otp_train_step":
        assert r["launches"]["moe_gmm"] == r["launches"]["moe_gmm_swiglu"] > 0


def test_production_view_is_a_rank_without_processes():
    m = production_view()
    assert (m.axis_names, tuple(m.shape.values())) == (("data", "model"), (16, 16))
    assert m.coord == {"data": 0, "model": 0} and not m._groups
    m = production_view(multi_pod=True, coord=(1, 2, 3))
    assert (m.axis_names, tuple(m.shape.values())) == (("pod", "data", "model"), (2, 16, 16))
    assert m.index(("pod", "data")) == 18 and m.extent(("data", "model")) == 256


def test_cli_writes_a_full_width_cell(tmp_path, torch_one_thread):
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--mesh", "single",
                 "--out", str(tmp_path)])
    r = json.loads((tmp_path / "tinyllama-1.1b_train_4k_single.json").read_text())
    assert r["chips"] == 256 and r["step"] == "train_step" and r["flops_per_dev"] > 0
    assert set(r) == KEYS and r["memory"]["fits_80gb"] in (True, False)
    assert set(r["collective_bytes_per_dev"]) <= {"all-reduce", "all-gather", "reduce-scatter"}
