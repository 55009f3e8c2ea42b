"""The port's op counter (``repro_torch.launch.op_analysis``), the counterpart
of ``tests/test_hlo_analysis.py``, held to hand counts:

* a plain matmul: FLOPs exact, bytes at least operands plus result;
* a loop of 7 layers counts 7× (run, and as a ``launch.counting.scan``
  that runs two of them on ``meta``, forward and backward alike), and the
  scan on ``meta`` counts what it counts on CPU tensors — FLOPs, bytes and
  peak;
* nested loops of 5 × 3, as scans too;
* a scan whose backward fails, or runs its exit but not its entry,
  fails its own count alone: the next counts 1×;
* a process-less ``2 × 4`` rank view (``launch.mesh.production_view``'s
  kind of mesh): per-rank FLOPs ``4·2·4·256·64`` and collective bytes by
  kind to the byte, nothing sent;
* each kernel wrapper's ``meta`` route: the plain version's output shape
  and dtype, one launch, and bytes equal to ``nbytes`` of its tensors at
  ``PERF.md`` §6's shapes (the grouped GEMMs at their static capacity); a
  CPU tensor still runs the plain version and counts nothing;
* a train step of each reduced family counted on ``meta`` as on CPU
  tensors (FLOPs equal, peak and HBM bytes within 5 %), under
  ``remat="none"`` and ``"block"``; ``"block"``'s counted peak below
  ``"none"``'s where the activations make the peak; and the multi-pod
  batch block of command-r's ``train_4k``: 8 rows a rank, each microbatch
  the reference's rows;
* FLOP parity with the reference's ``analyze_hlo`` of ``jit(train_loss)``
  and ``jit(value_and_grad(train_loss, has_aux=True))`` without a mesh, on
  the five reduced families (4 × 64 tokens), each built once a file: the
  forward equal within 1e-3 (xlstm's mLSTM computes ``n · q`` as a product
  and a sum, which the reference's dot counts: 0.9995 of its count; the
  rest exact); forward and backward within [1.0, 1.06] of the reference's
  (the port recomputes every loss chunk's logits in the backward, where
  XLA keeps the last chunk's forward, and xlstm's scan adds its
  recurrence's backward products).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.binary_matmul import binary_matmul  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_swiglu  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_quant  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.launch import counting  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import production_view  # noqa: E402
from repro_torch.launch.op_analysis import analyze_step  # noqa: E402
from repro_torch.models.registry import get_model as tget_model  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

from _torch_interop import torch_one_thread  # noqa: E402,F401

FAMILIES = ["tinyllama-1.1b", "moonshot-v1-16b-a3b", "whisper-small", "recurrentgemma-2b",
            "xlstm-350m"]


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_plain_matmul_flops():
    s = analyze_step(lambda a, b: a @ b, (meta(64, 128), meta(128, 32)))
    assert s.flops == 2 * 64 * 128 * 32
    assert s.hbm_bytes >= (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert s.dot_flops_by_comp == {"mm": 2 * 64 * 128 * 32}
    assert s.flops_by_dtype == {"float32": 2 * 64 * 128 * 32}
    assert s.peak_bytes == 64 * 32 * 4 and s.launches == {}


def _layers(w, x):
    for wl in w:
        x = torch.tanh(x @ wl)
    return x


def _scanned(w, x):
    """:func:`_layers` as a :func:`~repro_torch.launch.counting.scan`."""
    (x,), _ = counting.scan(len(w), lambda i, c, w: ((torch.tanh(c[0] @ w[i]),), None), (x,),
                            (w,))
    return x


def _grads(body):
    def fn(w, x):
        w, x = w.detach().requires_grad_(), x.detach().requires_grad_()
        return torch.autograd.grad(body(w, x).sum(), (w, x))
    return fn


def _on_cpu(*shapes):
    gen = torch.Generator().manual_seed(0)
    return tuple(torch.randn(s, generator=gen) for s in shapes)


def _same_count(a, b):
    assert (a.flops, a.hbm_bytes, a.peak_bytes) == (b.flops, b.hbm_bytes, b.peak_bytes)


def test_loop_multiplies_body_flops():
    """Seven layers run: 7× one layer's FLOPs and bytes, each layer's weight
    read; the same loop as a ``scan`` (two iterations run on ``meta``) counts
    the same, and so does its backward; on ``meta`` the scan counts what it
    counts on CPU tensors, where all seven run — FLOPs, bytes and peak."""
    w, x = meta(7, 64, 64), meta(8, 64)
    s = analyze_step(_layers, (w, x))
    expect = 7 * 2 * 8 * 64 * 64
    assert s.flops == expect
    assert s.hbm_bytes >= 7 * 64 * 64 * 4
    once = analyze_step(_scanned, (w, x))
    assert once.flops == s.flops and once.hbm_bytes == s.hbm_bytes
    full = analyze_step(_grads(_layers), (w, x))
    rep = analyze_step(_grads(_scanned), (w, x))
    assert full.flops == 3 * expect  # forward, and the x and w products back
    assert rep.flops == full.flops
    for fn in (_scanned, _grads(_scanned)):
        _same_count(analyze_step(fn, (w, x)), analyze_step(fn, _on_cpu((7, 64, 64), (8, 64))))
    assert counting.trips() == 1


def _nested_scan(x):
    def inner(x):
        return counting.scan(3, lambda i, c: ((torch.tanh(c[0] @ c[0]),), None), (x,))[0][0]

    return counting.scan(5, lambda i, c: ((inner(c[0]),), None), (x,))[0][0]


def test_nested_loops():
    def f(x):
        for _ in range(5):
            for _ in range(3):
                x = torch.tanh(x @ x)
        return x

    expect = 5 * 3 * 2 * 32 * 32 * 32
    assert analyze_step(f, (meta(32, 32),)).flops == expect
    assert analyze_step(_nested_scan, (meta(32, 32),)).flops == expect
    back = _grads(lambda w, x: _nested_scan(x @ w[0]))
    _same_count(analyze_step(_nested_scan, (meta(32, 32),)),
                analyze_step(_nested_scan, _on_cpu((32, 32))))
    _same_count(analyze_step(back, (meta(1, 32, 32), meta(32, 32))),
                analyze_step(back, _on_cpu((1, 32, 32), (32, 32))))


class _Raises(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("backward failed")


def test_a_failed_or_unbalanced_region_leaves_the_next_count_at_one():
    """A scan's backward that raises inside it (its exit run, its entry
    not) fails that count alone; so does a backward that needs the scan's
    exit but not its entry (a gradient of tensors the body closes over,
    none of its carry's), which raises instead of multiplying what is
    counted after it. The next count is 1×."""
    w, x = meta(7, 64, 64), meta(8, 64)

    def raising(w, x):
        w, x = w.detach().requires_grad_(), x.detach().requires_grad_()
        (y,), _ = counting.scan(7, lambda i, c, w: ((_Raises.apply(torch.tanh(c[0] @ w[i])),),
                                                    None), (x,), (w,))
        return torch.autograd.grad(y.sum(), (w, x))

    def unbalanced(w, x):
        w, x = w.detach().requires_grad_(), x.detach().requires_grad_()
        (y,), _ = counting.scan(7, lambda i, c: ((torch.tanh(x @ w[0]),), None), (x,))
        return torch.autograd.grad(y.sum(), (w,))

    for fn, msg in ((raising, "backward failed"), (unbalanced, "still open")):
        with pytest.raises(RuntimeError, match=msg):
            analyze_step(fn, (w, x))
        assert counting.trips() == 1
        assert analyze_step(lambda a, b: a @ b, (meta(64, 128), meta(128, 32))).flops == \
            2 * 64 * 128 * 32


def test_rank_view_flops_and_collectives():
    """``tests/test_hlo_analysis.py``'s SPMD case on one rank of a ``2 × 4``
    view without processes: W ``[4, 256, 256]`` split over ``model`` on its
    columns, x ``[8, 256]`` over ``data``; each layer's product on the
    rank's block, its columns gathered over ``model``, the global sum
    reduced over both axes."""
    mesh = shd.Mesh(("data", "model"), (2, 4), coord=(1, 2))

    def f(w, x):
        for wl in w:
            x = shd.all_gather(torch.tanh(x @ wl), mesh, "model", 1)
        return shd.all_reduce(x.sum(), mesh, ("data", "model"))

    s = analyze_step(f, (meta(4, 256, 64), meta(4, 256)))
    assert s.flops == 4 * 2 * 4 * 256 * 64
    assert s.collective_bytes == {"all-gather": 4 * 4 * 64 * 4, "all-reduce": 4}
    assert s.num_collectives == {"all-gather": 4, "all-reduce": 1}
    assert s.total_collective_bytes == 4 * 4 * 64 * 4 + 4
    assert tuple(s.result.shape) == ()


# ------------------------------------------------------- kernels on meta
def _packed(e, k, n, bits, group=128):
    per = {1: 8, 2: 4, 4: 2}[bits]
    lead = (e,) if e else ()
    return (meta(*lead, -(-k // per), n, dtype=torch.uint8), meta(*lead, -(-k // group), n),
            meta(*lead, -(-k // group), n))


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _cases():
    """``(name, call, expected bytes, output shape)`` at ``PERF.md`` §6's
    shapes, bf16 activations."""
    bf = torch.bfloat16
    out = []
    x = meta(4, 2048, dtype=bf)
    w = _packed(0, 2048, 2048, 4)
    out.append(("quant_matmul", lambda: quant_matmul(x, *w, bits=4),
                _nbytes(x, *w) + 4 * 2048 * 2, (4, 2048)))
    # the 59-expert 2-bit bucket at capacity 24: 177 row blocks of 8
    xg, be, na = meta(1416, 2048, dtype=bf), meta(177, dtype=torch.int32), \
        meta(1, dtype=torch.int32)
    wg, wu = _packed(59, 2048, 1408, 2), _packed(59, 2048, 1408, 2)
    out.append(("moe_gmm_swiglu", lambda: moe_gmm_swiglu(xg, wg[0], wu[0], wg[1], wg[2], wu[1],
                                                         wu[2], be, na, bits=2, bm=8),
                _nbytes(xg, *wg, *wu) + 1416 * 1408 * 2, (1416, 1408)))
    xd = meta(1416, 1408, dtype=bf)
    wd = _packed(59, 1408, 2048, 2)
    out.append(("moe_gmm", lambda: moe_gmm(xd, *wd, be, na, bits=2, bm=8),
                _nbytes(xd, *wd) + 1416 * 2048 * 2, (1416, 2048)))
    # B = 4, 16 KV heads, dh = 128, pages of 16, 6 pages a sequence: every row
    q, tables, lens = meta(4, 16, 1, 128, dtype=bf), meta(4, 6, dtype=torch.int32), \
        meta(4, dtype=torch.int32)
    kp, vp = meta(24, 16, 16, 128, dtype=bf), meta(24, 16, 16, 128, dtype=bf)
    rows = 4 * 6 * 16
    io = 2 * _nbytes(q) + _nbytes(tables, lens)
    out.append(("paged_attention", lambda: paged_attention(q, kp, vp, tables, lens),
                rows * 16 * 128 * 2 * 2 + io, (4, 16, 1, 128)))
    kc, vc = meta(24, 16, 16, 128, dtype=torch.uint8), meta(24, 16, 16, 128, dtype=torch.uint8)
    tabs = [meta(24, 16, 16) for _ in range(4)]
    out.append(("paged_attention_quant",
                lambda: paged_attention_quant(q, kc, vc, *tabs, tables, lens),
                rows * 16 * (2 * 128 + 16) + io, (4, 16, 1, 128)))
    xb, bp, alpha = meta(16, 2048, dtype=bf), meta(256, 1408, dtype=torch.uint8), meta(1, 1408)
    out.append(("binary_matmul", lambda: binary_matmul(xb, bp, alpha),
                _nbytes(xb, bp, alpha) + 16 * 1408 * 2, (16, 1408)))
    return out


@pytest.mark.parametrize("case", range(6))
def test_kernel_meta_route(case):
    name, call, want_bytes, shape = _cases()[case]
    sink = []
    before = dict(build.LAUNCHES)
    with counting.recording(sink):
        y = call()
    assert y.device.type == "meta" and tuple(y.shape) == shape and y.dtype == torch.bfloat16
    assert [(n, w.bytes) for n, w, _ in sink] == [(name, want_bytes)]
    assert sink[0][1].flops > 0 and sink[0][1].dtype == torch.bfloat16
    assert dict(build.LAUNCHES) == before  # no kernel ran: LAUNCHES counts launches only
    s = analyze_step(call, ())
    assert s.launches == {name: 1} and s.hbm_bytes == want_bytes


def test_cpu_tensors_run_the_plain_version_and_count_nothing():
    """On CPU tensors the wrappers run their plain versions (the outputs
    equal them) and nothing reaches the sink; their ``meta`` twins give the
    same shape and dtype."""
    from repro_torch.core.quantizers import quantize_parts

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 256, generator=gen).to(torch.bfloat16)
    data, s, z = quantize_parts(torch.randn(1, 256, 96, generator=gen), 4, 128, refine=False)
    data, s, z = data[0], s[0], z[0]
    sink = []
    before = dict(build.LAUNCHES)
    with counting.recording(sink):
        y = quant_matmul(x, data, s, z, bits=4)
        ym = quant_matmul(x.to("meta"), data.to("meta"), s.to("meta"), z.to("meta"), bits=4)
    assert torch.equal(y, ref.quant_matmul_ref(x, data, s, z, bits=4))
    assert (ym.shape, ym.dtype) == (y.shape, y.dtype)
    assert [n for n, _, _ in sink] == ["quant_matmul"]  # the meta call's alone
    assert dict(build.LAUNCHES) == before


def test_grad_path_counts_on_meta():
    """The OTP step differentiates through ``QuantMatmul`` and the grouped
    GEMMs' Functions: on meta the forward is the counted launch and the
    plain backward (all experts and blocks: the static capacity) runs."""
    from repro_torch.kernels import ops

    x = meta(16, 256).requires_grad_()
    w = _packed(0, 256, 96, 4)
    be, na = meta(2, dtype=torch.int32), meta(1, dtype=torch.int32)
    wg = _packed(3, 256, 64, 2)

    def step(x):
        y = ops.quant_matmul_parts(x, *w, bits=4).sum()
        y = y + ops.moe_gmm(x, *wg, be, na, bits=2, bm=8).sum()
        return torch.autograd.grad(y, x)

    s = analyze_step(step, (x,))
    assert s.launches == {"quant_matmul": 1, "moe_gmm": 1}
    assert tuple(s.result[0].shape) == (16, 256)
    assert s.dot_flops_by_comp["quant_matmul"] == 2 * 16 * 256 * 96
    assert s.dot_flops_by_comp["moe_gmm"] == 2 * 16 * 256 * 64
    assert s.dot_flops_by_comp["mm"] == 2 * 16 * 96 * 256  # the plain backward's x gradient


# ------------------------------------------------- parity with the reference
@pytest.fixture(scope="module")
def reference_counts():
    """``arch -> (forward FLOPs, forward + backward FLOPs)`` of the
    reference's ``analyze_hlo`` without a mesh: each model built once a
    file, its ``train_loss`` and its ``value_and_grad`` compiled once each."""
    cache = {}

    def counts(arch):
        if arch not in cache:
            jb = jget_model(jreg.get_config(arch).reduced())
            ps = jb.param_shapes()
            batch = jb.batch_specs(jbase.ShapeConfig("train_4k", 64, 4, "train"), "train")
            both = analyze_hlo(jax.jit(lambda p, b: jax.value_and_grad(
                jb.train_loss, has_aux=True)(p, b)).lower(ps, batch).compile().as_text())
            fwd = analyze_hlo(jax.jit(lambda p, b: jb.train_loss(p, b)[0]).lower(
                ps, batch).compile().as_text())
            cache[arch] = (fwd.flops, both.flops)
        return cache[arch]

    return counts


@pytest.mark.parametrize("arch", FAMILIES)
def test_flops_match_the_reference_analyzer(arch, reference_counts, torch_one_thread):
    jfwd, jboth = reference_counts(arch)
    tb = tget_model(treg.get_config(arch).reduced())
    shape = tbase.ShapeConfig("train_4k", 64, 4, "train")
    params, batch = tb.param_shapes(), tb.batch_specs(shape, "train")
    fwd = analyze_step(lambda p, b: tb.train_loss(p, b)[0], (params, batch))

    def both(p, b):
        live = tree_map(lambda t: t.detach().requires_grad_() if t.is_floating_point() else t, p)
        loss = tb.train_loss(live, b)[0]
        return torch.autograd.grad(loss, [t for t in tree_leaves(live) if t.is_floating_point()])

    bwd = analyze_step(both, (params, batch))
    assert abs(fwd.flops / jfwd - 1) <= 1e-3, (fwd.flops, jfwd)
    assert 1.0 <= bwd.flops / jboth <= 1.06, (bwd.flops, jboth)
    assert fwd.flops_by_dtype == {"float32": fwd.flops}  # the reduced configs run f32


# ------------------------------------------- a train step: meta against CPU
#: ``(batch, seq)`` of each family's train step counted on ``meta`` and on
#: CPU tensors: every loop runs more than the two iterations a ``scan`` runs
#: on ``meta`` (32-token attention chunks: 3 × 3 chunk pairs; xlstm: 3
#: recomputed chunks of 64 mLSTM steps, 192 sLSTM steps)
COUNTED_STEPS = {"tinyllama-1.1b": (1, 96), "moonshot-v1-16b-a3b": (1, 96),
                 "whisper-small": (1, 96), "recurrentgemma-2b": (1, 96),
                 "xlstm-350m": (1, 192)}


@pytest.mark.parametrize("arch,remat", [pytest.param(a, "none", id=a) for a in FAMILIES]
                         + [pytest.param(a, "block", id=f"{a}-block") for a in FAMILIES])
def test_train_step_counts_on_meta_as_on_cpu(arch, remat, torch_one_thread):
    """``build_step``'s f32 train step of each reduced family counted on its
    ``meta`` argument specs and on CPU tensors of the same shapes, where
    every loop iteration runs: FLOPs equal, peak live bytes and HBM bytes
    within 5 % — with the config's ``"none"`` and with ``remat="block"``
    (each block a ``torch.utils.checkpoint``, its recomputation stopped
    early, on ``meta`` as on the CPU)."""
    cfg = dataclasses.replace(treg.get_config(arch).reduced(), remat=remat)
    b, s = COUNTED_STEPS[arch]
    art = tsteps.build_step(cfg, tbase.ShapeConfig("train_4k", s, b, "train"))
    on_meta = analyze_step(art.fn, art.arg_specs)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, tuple(v.shape)))
             if not v.is_floating_point() else
             torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
             for k, v in art.arg_specs[2].items()}
    params = tget_model(cfg).init(torch.Generator().manual_seed(0))
    on_cpu = analyze_step(art.fn, (params, tsteps.init_opt_blocks(art, "cpu"), batch))
    assert on_meta.flops == on_cpu.flops
    assert abs(on_meta.peak_bytes / on_cpu.peak_bytes - 1) <= 0.05, \
        (on_meta.peak_bytes, on_cpu.peak_bytes)
    assert abs(on_meta.hbm_bytes / on_cpu.hbm_bytes - 1) <= 0.05, \
        (on_meta.hbm_bytes, on_cpu.hbm_bytes)


#: ``(layers, batch, seq)`` of each family's train step whose peak is its
#: activations' (at the reduced depth and 1 × 96 the optimizer's update
#: is the peak, the same under either mode)
LOWER_PEAK = {"tinyllama-1.1b": (4, 2, 128), "moonshot-v1-16b-a3b": (2, 4, 256),
              "whisper-small": (4, 2, 128), "recurrentgemma-2b": (6, 2, 128),
              "xlstm-350m": (4, 2, 128)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_block_remat_lowers_the_counted_peak(arch, torch_one_thread):
    """A reduced family's train step counted on ``meta``: its peak under
    ``remat="block"`` below its peak under ``"none"``, FLOPs above
    (the blocks' forwards run again)."""
    layers, b, s = LOWER_PEAK[arch]
    got = {}
    for remat in ("none", "block"):
        cfg = dataclasses.replace(treg.get_config(arch).reduced(), remat=remat,
                                  num_layers=layers)
        art = tsteps.build_step(cfg, tbase.ShapeConfig("train_4k", s, b, "train"))
        got[remat] = analyze_step(art.fn, art.arg_specs)
    assert got["block"].peak_bytes < got["none"].peak_bytes
    assert got["block"].flops > got["none"].flops


def test_multi_pod_microbatches_are_cut_not_replicated():
    """command-r-35b's ``train_4k`` on the multi-pod view (the reference's
    ``accum`` 16: 16-row microbatches over 32 batch ranks), on ``meta`` specs
    only, no step run: each rank's batch block is its 8 rows of the 256, and
    over the 32 ranks each microbatch is the reference's rows ``[16m, 16m +
    16)``, every row on one rank alone."""
    cfg = treg.get_config("command-r-35b")
    mesh = production_view(True)
    with torch.device("meta"):
        art = tsteps.build_step(cfg, tbase.SHAPES["train_4k"], mesh, accum=0)
        block = tsteps._cut_batch(art.arg_specs[2], art.in_shardings[2], art.meta["accum"])
    rows, accum = art.arg_specs[2]["tokens"].shape[0], art.meta["accum"]
    assert (rows, accum) == (256, 16)
    assert {k: tuple(v.shape) for k, v in block.items()} == {"tokens": (8, 4096),
                                                             "labels": (8, 4096)}
    held = [[] for _ in range(accum)]
    for pod in range(2):
        for data in range(16):
            view = production_view(True, coord=(pod, data, 0))
            r = view.index(("pod", "data"))
            for m, sl in enumerate(tsteps._micro_rows(rows, accum, view)):
                held[m] += [8 * r + i for i in range(sl.start, sl.stop)]
    assert held == [list(range(16 * m, 16 * m + 16)) for m in range(accum)]
