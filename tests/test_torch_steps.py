"""The port's step builders (``repro_torch.launch.steps``), specs and shape
configs against the JAX reference, in one process.

* ``ShapeConfig``/``SHAPES``/``supported_shapes``/``all_cells`` equal the
  reference's;
* ``ModelBundle.param_shapes``/``batch_specs``/``input_specs`` (meta
  tensors) give the reference's ``jax.eval_shape`` shapes and dtypes for
  every reduced arch × supported shape, the port's per-layer trees stacked
  as the reference's;
* ``launch/specs.py``'s trees equal the reference's;
* ``build_step``'s names and ``meta`` equal the reference's on the four
  cells of ``tests/test_dryrun_cells.py``;
* on the reference's one-device ``Auto`` mesh, the port's steps match
  ``build_step(...).fn``: full training (``accum`` 1 with 32-bit moments,
  ``accum`` 2 with 8-bit; loss within 1e-5, parameters within 1e-4 × the
  tree's max |parameter| — Adam's first steps normalize gradients near
  ``eps``, where float noise moves an update by a fraction of ``lr`` —,
  moments within 1e-4 × max, 8-bit codes at most one apart), the OTP step
  on the replayed Gumbel draws (loss 1e-5, routers 1e-4 × max), prefill and
  decode (logits 1e-4 × max); and the ZeRO-1 update fed the reference's
  gradients gives its parameters (1e-6) and its int8 codes byte for byte.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core.compressed_moe import CompressedExperts  # noqa: E402
from repro_torch.core.packing import PackedTensor  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.registry import get_model as tget_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, Q8  # noqa: E402

from _torch_interop import flatten_reference, torch_one_thread  # noqa: E402,F401

DTYPES = {jnp.dtype("float32"): torch.float32, jnp.dtype("bfloat16"): torch.bfloat16,
          jnp.dtype("int32"): torch.int32, jnp.dtype("uint8"): torch.uint8,
          jnp.dtype("int8"): torch.int8}
#: the roots a reference tree stacks over blocks, and the port's name of each
STACKED = {"layers": "blocks", "enc_blocks": "enc_blocks", "dec_blocks": "dec_blocks",
           "groups": "groups"}
CELLS = [("tinyllama-1.1b", "train_4k"), ("moonshot-v1-16b-a3b", "decode_32k"),
         ("kimi-k2-1t-a32b", "train_4k"), ("xlstm-350m", "long_500k")]


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def ref_flat(tree):
    """``{path: (shape, dtype)}`` of a reference pytree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = []
        for p in path:
            keys.append(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))))
        out["/".join(keys)] = (tuple(leaf.shape), DTYPES[jnp.dtype(leaf.dtype)])
    return out


def port_flat(tree):
    """``{path: (shape, dtype)}`` of a port tree in the reference's layout:
    per-block lists under a stacked root stacked on axis 0, a PackedTensor's
    and a CompressedExperts' children by their pytree index (``data`` — a
    3-bit ``(hi, lo)`` pair —, ``scale``, ``zero``; ``slot_of_expert``, the
    bucket arrays)."""
    out = {}

    def leaf_items(node, path):
        if isinstance(node, PackedTensor):
            data = {"0/0": node.data[0], "0/1": node.data[1]} if node.bits == 3 else \
                {"0": node.data}
            for k, t in {**data, "1": node.scale, "2": node.zero}.items():
                yield f"{path}/{k}", t
        elif isinstance(node, CompressedExperts):
            yield f"{path}/0", node.slot_of_expert
            yield from leaf_items(node.arrays, f"{path}/1")
        elif isinstance(node, dict):
            for k, v in node.items():
                yield from leaf_items(v, f"{path}/{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from leaf_items(v, f"{path}/{i}")
        else:
            yield path, node

    for key, node in tree.items():
        if key in STACKED and isinstance(node, list) and node:
            per = [dict(leaf_items(layer, STACKED[key])) for layer in node]
            for path, t in per[0].items():
                out[path] = ((len(per),) + tuple(t.shape), t.dtype)
        else:
            for path, t in leaf_items(node, key):
                out[path] = (tuple(getattr(t, "shape", ())), getattr(t, "dtype", None))
    return out


# ------------------------------------------------------------- configs
def test_shape_configs_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert [f.name for f in dataclasses.fields(tbase.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ShapeConfig)]
    for name in treg.ARCH_IDS:
        assert tbase.supported_shapes(treg.get_config(name)) == \
            jbase.supported_shapes(jreg.get_config(name))
    assert list(treg.all_cells()) == list(jreg.all_cells())
    assert treg.ARCH_IDS == jreg.ARCH_IDS


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_bundle_specs_are_the_reference_eval_shapes(arch, torch_one_thread):
    jcfg, tcfg = jreg.get_config(arch).reduced(), treg.get_config(arch).reduced()
    jb, tb = jget_model(jcfg), tget_model(tcfg)
    assert port_flat(tb.param_shapes()) == ref_flat(jb.param_shapes())
    for shape_name in jbase.supported_shapes(jcfg):
        jkind, jkw = jb.input_specs(jbase.SHAPES[shape_name])
        tkind, tkw = tb.input_specs(tbase.SHAPES[shape_name])
        assert tkind == jkind
        assert port_flat(tkw) == ref_flat(jkw), shape_name
        for kind in ("train", "prefill"):
            assert port_flat(tb.batch_specs(tbase.SHAPES[shape_name], kind)) == \
                ref_flat(jb.batch_specs(jbase.SHAPES[shape_name], kind))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"])
def test_compressed_specs_equal_the_reference(arch):
    jcfg, tcfg = jreg.get_config(arch).reduced(), treg.get_config(arch).reduced()
    for with_otp in (False, True):
        want = ref_flat(jspecs.make_compressed_moe_params(jcfg, with_otp=with_otp))
        got = port_flat(tspecs.make_compressed_moe_params(tcfg, with_otp=with_otp))
        assert got == want
        conc = tspecs.make_compressed_moe_params(tcfg, concrete=True, device="cpu")
        assert conc["embed"].device.type == "cpu" and not conc["embed"].any()
    assert port_flat({"layers": tspecs.make_otp_stacked(tcfg, concrete=False)}) == \
        {f"blocks/{k}": v for k, v in ref_flat(jspecs.make_otp_stacked(jcfg, concrete=False)).items()}


def test_uniform_quantized_spec_equals_the_reference():
    cfg = dataclasses.replace(jreg.get_config("qwen3-14b").reduced(), d_model=256, d_ff=512)
    tcfg = dataclasses.replace(treg.get_config("qwen3-14b").reduced(), d_model=256, d_ff=512)
    want = ref_flat(jspecs.quantize_dense_param_tree(jget_model(cfg).param_shapes(), cfg))
    got = port_flat(tspecs.quantize_dense_param_tree(tget_model(tcfg).param_shapes(), tcfg))
    assert got == want
    assert any(p.endswith("wq/w/0") for p in got)


def test_step_names_and_meta_on_the_dryrun_cells():
    mesh = _auto_mesh()
    for arch, shape_name in CELLS:
        shape = dataclasses.replace(jbase.SHAPES[shape_name], seq_len=64, global_batch=4)
        tshape = dataclasses.replace(tbase.SHAPES[shape_name], seq_len=64, global_batch=4)
        want = jsteps.build_step(jreg.get_config(arch).reduced(), shape, mesh)
        got = tsteps.build_step(treg.get_config(arch).reduced(), tshape)
        assert (got.name, got.meta, got.donate_argnums) == \
            (want.name, want.meta, want.donate_argnums), arch
        for accum in (0, 3):
            w = jsteps.build_step(jreg.get_config(arch).reduced(), shape, mesh, accum=accum)
            g = tsteps.build_step(treg.get_config(arch).reduced(), tshape, accum=accum)
            assert g.meta == w.meta


# ------------------------------------------------------- the steps, 1 × 1
def flat_tree(node, prefix=""):
    """A reference tree (dicts, lists and NamedTuples) as ``{path: numpy}``."""
    out = {}
    if isinstance(node, dict):
        for k, v in node.items():
            out.update(flat_tree(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            out.update(flat_tree(v, f"{prefix}/{i}" if prefix else str(i)))
    elif hasattr(node, "_fields"):
        for f in node._fields:
            out.update(flat_tree(getattr(node, f), f"{prefix}/{f}"))
    else:
        out[prefix] = np.asarray(node)
    return out


def port_state(tree, prefix=""):
    """The port's AdamW state as ``{path: numpy}`` (a Q8's ``q``/``scale``)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(port_state(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, Q8):
        out[f"{prefix}/q"], out[f"{prefix}/scale"] = tree.q.numpy(), tree.scale.numpy()
    else:
        out[prefix] = tree.detach().numpy()
    return out


def stacked_numpy(params):
    stacked = tsteps.stacked_paths(params)
    return {p: (torch.stack(v) if p in stacked else v[0]).detach().float().numpy()
            for p, v in tsteps.stack_tree(params).items()}


def check_params(got, want):
    scale = max(float(np.abs(v).max()) for v in want.values())
    for p, w in want.items():
        np.testing.assert_allclose(got[p], w, rtol=0, atol=1e-4 * scale, err_msg=p)


def check_state(got, want):
    for p, w in want.items():
        if w.dtype == np.int8:  # codes of moments from float-noisy gradients
            assert np.abs(got[p].astype(np.int32) - w.astype(np.int32)).max() <= 1, p
        else:
            np.testing.assert_allclose(got[p], w, rtol=0, atol=1e-4 * float(np.abs(w).max()),
                                       err_msg=p)


#: layers of a reduced config where the default misses a block list
#: (recurrentgemma's two trailing blocks, ``tail/0`` and ``tail/1``)
LAYERS = {"recurrentgemma-2b": 5}


def _train_case(arch, accum, bits):
    jcfg, tcfg = jreg.get_config(arch).reduced(), treg.get_config(arch).reduced()
    if arch in LAYERS:
        jcfg = dataclasses.replace(jcfg, num_layers=LAYERS[arch])
        tcfg = dataclasses.replace(tcfg, num_layers=LAYERS[arch])
    shape = jbase.ShapeConfig("train_4k", 32, 4, "train")
    art = jsteps.build_step(jcfg, shape, _auto_mesh(), accum=accum, state_bits=bits)
    tart = tsteps.build_step(tcfg, tbase.ShapeConfig("train_4k", 32, 4, "train"),
                             accum=accum, state_bits=bits)
    params = jget_model(jcfg).init(jax.random.PRNGKey(0))
    state = jadamw.adamw_init(params, jadamw.AdamWConfig(state_bits=bits))
    rng = np.random.default_rng(1)
    tok = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    spec = jget_model(jcfg).batch_specs(shape, "train")
    if "frames" in spec:  # whisper's encoder input
        batch["frames"] = rng.standard_normal(spec["frames"].shape).astype(np.float32)
    return jcfg, tcfg, art, tart, params, state, batch


@pytest.mark.parametrize("arch,accum,bits", [("tinyllama-1.1b", 1, 32),
                                             ("moonshot-v1-16b-a3b", 2, 8),
                                             ("whisper-small", 1, 32),
                                             ("recurrentgemma-2b", 1, 32),
                                             ("xlstm-350m", 1, 32),
                                             ("xlstm-350m", 2, 8)])
def test_train_step_matches_the_reference(arch, accum, bits, torch_one_thread):
    """Every family's full training: the transformers' ``blocks/...``, whisper's
    ``enc_blocks``/``dec_blocks``, recurrentgemma's ``groups`` and its list
    ``tail``, xlstm's ``groups`` — stacked paths and flatten order the
    reference's."""
    jcfg, tcfg, art, tart, params, state, batch = _train_case(arch, accum, bits)
    jp, jst, jloss = jax.jit(art.fn)(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    if "blocks" in params:
        flat, meta = flatten_reference(params)
        want = flatten_reference(jp)[0]
    else:
        flat, meta, want = flat_tree(params), {}, flat_tree(jp)
    tp = interop.params_from_reference(flat, meta, device="cpu")
    tst = interop.opt_state_from_reference(flat_tree(state), device="cpu")
    tp, tst, tloss = tart.fn(tp, tst, {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    assert abs(float(tloss) - float(jloss)) <= 1e-5
    check_params(stacked_numpy(tp), want)
    order = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(tsteps.stack_tree(tp)) == order  # the reference's flatten order
    check_state(port_state(tst), flat_tree(jst))
    assert int(tst["step"]) == 1


@pytest.fixture(scope="module")
def moonshot_grads():
    """The reference's gradients of the reduced moonshot's ``train_loss`` at
    :func:`_train_case`'s parameters and batch (the same at either state
    width), compiled once a file."""
    jcfg, _, _, _, params, _, batch = _train_case("moonshot-v1-16b-a3b", 1, 32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(jax.grad(lambda p: jget_model(jcfg).train_loss(p, jbatch)[0]))(params)


@pytest.mark.parametrize("bits", [32, 8])
def test_zero1_update_is_the_reference_adamw_bytewise(bits, moonshot_grads, torch_one_thread):
    """The reference's gradients fed to the port's sharded update (on one
    rank, its blocks are the leaves): parameters within 1e-6 and moments
    1e-6 relative, as ``test_torch_substrate.py`` holds one
    ``adamw_update``; int8 codes byte for byte."""
    jcfg, tcfg, art, tart, params, state, batch = _train_case("moonshot-v1-16b-a3b", 1, bits)
    grads = moonshot_grads
    ocfg = jadamw.AdamWConfig(state_bits=bits)
    jp, jst = jadamw.adamw_update(params, grads, state, ocfg)  # eager: op by op, unfused
    flat, meta = flatten_reference(params)
    tp = interop.params_from_reference(flat, meta, device="cpu")
    tst = interop.opt_state_from_reference(flat_tree(state), device="cpu")
    gflat, _ = flatten_reference(grads)
    plans, _ = tsteps._train_layout(tget_model(tcfg).param_shapes(), tsteps._one_rank(),
                                    tcfg, bits)
    mesh = tsteps._one_rank()
    g = {p: tsteps._reduce(torch.from_numpy(gflat[p].copy()), plan, mesh)
         for p, plan in plans.items()}
    new, nst = tsteps._zero1_update(plans, tsteps.stack_tree(tp), g, tst,
                                    AdamWConfig(state_bits=bits), mesh)
    got = {p: (torch.stack(v) if plans[p].stacked else v[0]).numpy() for p, v in new.items()}
    want = flatten_reference(jp)[0]
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=0, atol=1e-6, err_msg=p)
    js, ts = flat_tree(jst), port_state(nst)
    for p in js:
        if js[p].dtype == np.int8:
            np.testing.assert_array_equal(ts[p], js[p], err_msg=p)
        else:
            np.testing.assert_allclose(ts[p], js[p], rtol=1e-6, atol=1e-9, err_msg=p)


def _random_frozen(jcfg, rng):
    """The reference's concrete compressed tree with numpy-seeded values:
    random codes, scales in [0.01, 0.03], zeros in [0, 1.5], float leaves
    N(0, 0.05²); ``slot_of_expert`` as built."""
    def fill(path, a):
        a = np.asarray(a)
        if a.dtype == np.uint8:
            return jnp.asarray(rng.integers(0, 256, a.shape, dtype=np.uint8))
        if a.dtype.kind in "iu":
            return jnp.asarray(a)
        name = str(getattr(path[-1], "name", getattr(path[-1], "key", "")))
        if name == "scale":
            v = rng.uniform(0.01, 0.03, a.shape)
        elif name == "zero":
            v = rng.uniform(0.0, 1.5, a.shape)
        else:
            v = rng.standard_normal(a.shape) * 0.05
        return jnp.asarray(v.astype(np.float32)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(
        fill, jspecs.make_compressed_moe_params(jcfg, concrete=True))


def test_otp_train_step_matches_the_reference(torch_one_thread):
    arch, accum, s = "kimi-k2-1t-a32b", 2, 16
    jcfg, tcfg = jreg.get_config(arch).reduced(), treg.get_config(arch).reduced()
    art = jsteps.build_step(jcfg, jbase.ShapeConfig("train_4k", s, 4, "train"), _auto_mesh(),
                            accum=accum)
    tart = tsteps.build_step(tcfg, tbase.ShapeConfig("train_4k", s, 4, "train"), accum=accum)
    assert (art.name, tart.name) == ("otp_train_step", "otp_train_step")
    rng = np.random.default_rng(0)
    frozen = _random_frozen(jcfg, rng)
    otp = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)
                                             * 0.3), jspecs.make_otp_stacked(jcfg))
    state = jadamw.adamw_init(otp, jadamw.AdamWConfig(lr=2e-3, weight_decay=0.0))
    tok = rng.integers(0, jcfg.vocab_size, (4, s)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    jo, jst, jl, jkl = jax.jit(art.fn)(otp, state, frozen, {"tokens": jnp.asarray(tok)}, key)
    # the reference draws one [T_micro, k] block from the key for every layer and microbatch
    u = np.asarray(jax.random.uniform(key, tuple(tart.arg_specs[4].shape), minval=1e-6,
                                      maxval=1.0 - 1e-6))
    flat, meta = flatten_reference(frozen)
    po, pst, pl, pkl = tart.fn(
        interop.otp_from_reference({k: np.asarray(v) for k, v in otp.items()}, device="cpu"),
        interop.opt_state_from_reference(flat_tree(state), device="cpu"),
        interop.params_from_reference(flat, meta, device="cpu"),
        {"tokens": torch.from_numpy(tok)}, torch.from_numpy(u))
    assert abs(float(pl) - float(jl)) <= 1e-5 and abs(float(pkl) - float(jkl)) <= 1e-5
    for k in ("fc1", "fc2"):
        want = np.asarray(jo[k])
        got = torch.stack([o[k] for o in po]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    check_state(port_state(pst), flat_tree(jst))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "moonshot-v1-16b-a3b"])
def test_prefill_and_decode_steps_match_the_reference(arch, torch_one_thread):
    """bf16 prefill + decode of the dense model; PMQ (``precision='quant'``)
    of the MoE model on numpy-seeded compressed weights."""
    jcfg, tcfg = jreg.get_config(arch).reduced(), treg.get_config(arch).reduced()
    mesh = _auto_mesh()
    s, b = 16, 2
    jpre = jsteps.build_step(jcfg, jbase.ShapeConfig("prefill_32k", s, b, "prefill"), mesh)
    jdec = jsteps.build_step(jcfg, jbase.ShapeConfig("decode_32k", s, b, "decode"), mesh)
    tpre = tsteps.build_step(tcfg, tbase.ShapeConfig("prefill_32k", s, b, "prefill"))
    tdec = tsteps.build_step(tcfg, tbase.ShapeConfig("decode_32k", s, b, "decode"))
    assert tpre.meta == jpre.meta and tdec.meta == jdec.meta
    rng = np.random.default_rng(2)
    if jcfg.is_moe:
        params = _random_frozen(jcfg, rng)
    else:
        params = jget_model(jcfg).init(jax.random.PRNGKey(0))
    tok = rng.integers(0, jcfg.vocab_size, (b, s - 1)).astype(np.int32)
    jcache, jlog = jax.jit(jpre.fn)(params, {"tokens": jnp.asarray(tok)})
    flat, meta = flatten_reference(params)
    tp = interop.params_from_reference(flat, meta, device="cpu")
    tcache, tlog = tpre.fn(tp, {"tokens": torch.from_numpy(tok)})
    want = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    pad = ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))
    jcache = dict(jcache, k=jnp.pad(jcache["k"], pad), v=jnp.pad(jcache["v"], pad))
    tcache = {"k": torch.nn.functional.pad(tcache["k"], (0, 0, 0, 0, 0, 1)),
              "v": torch.nn.functional.pad(tcache["v"], (0, 0, 0, 0, 0, 1)),
              "pos": tcache["pos"]}
    nxt = np.argmax(want[:, -1], -1)[:, None].astype(np.int32)
    _, jl2 = jax.jit(jdec.fn)(params, jcache, jnp.asarray(nxt), jnp.int32(s - 1))
    _, tl2 = tdec.fn(tp, tcache, torch.from_numpy(nxt), torch.tensor(s - 1, dtype=torch.int32))
    want = np.asarray(jl2)
    np.testing.assert_allclose(tl2.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


# ------------------------------------------------- tensor-parallel slices
def _mesh(model, m=0):
    from repro_torch.parallel.sharding import Mesh

    return Mesh(("data", "model"), (1, model), coord=(0, m))


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_packed_slices_are_the_packed_slices_bytewise(bits):
    """A column or row slice of a PackedTensor equals packing that slice of
    the logical codes, with that slice of the scales and zeros."""
    from repro_torch.core.packing import pack_bits, unpack_bits
    from repro_torch.core.quantizers import quantize_to_packed

    w = torch.randn(256, 96, generator=torch.Generator().manual_seed(bits))
    pt = quantize_to_packed(w, bits, group=32, refine=False)
    codes = unpack_bits(pt.data, bits, axis=0)[:256]
    for n0, n1 in ((0, 24), (24, 48), (72, 96)):
        cut = pt.slice_cols(n0, n1)
        want = pack_bits(codes[:, n0:n1].contiguous(), bits, axis=0)
        for got, ref in zip(cut.data if bits == 3 else (cut.data,),
                            want if bits == 3 else (want,)):
            assert torch.equal(got, ref)
        assert torch.equal(cut.scale, pt.scale[:, n0:n1]) and cut.shape == (256, n1 - n0)
        assert torch.equal(cut.dequantize(), pt.dequantize()[:, n0:n1])
    for k0, k1 in ((0, 64), (64, 128), (192, 256)):
        cut = pt.slice_rows(k0, k1)
        want = pack_bits(codes[k0:k1].contiguous(), bits, axis=0)
        for got, ref in zip(cut.data if bits == 3 else (cut.data,),
                            want if bits == 3 else (want,)):
            assert torch.equal(got, ref)
        assert torch.equal(cut.zero, pt.zero[k0 // 32:k1 // 32]) and cut.shape == (k1 - k0, 96)
        assert torch.equal(cut.dequantize(), pt.dequantize()[k0:k1])
    with pytest.raises(ValueError, match="boundary"):
        pt.slice_rows(0, 48)


@pytest.mark.parametrize("arch,model,want", [
    ("moonshot-v1-16b-a3b", 4, {"attn": True, "moe/shared": False}),  # 704-row halves
    ("tinyllama-1.1b", 2, {"attn": True, "mlp": True}),
    ("tinyllama-1.1b", 4, {"attn": True, "mlp": True}),
    ("tinyllama-1.1b", 8, {"attn": False, "mlp": True}),  # 4 KV heads
])
def test_tp_plan_at_full_width(arch, model, want):
    from repro_torch.parallel.ep_shardmap import tp_plan

    cfg = treg.get_config(arch)
    if cfg.is_moe:
        layer = tspecs.make_compressed_moe_params(cfg)["layers"][0]
    else:
        layer = tget_model(cfg).param_shapes()["layers"][0]
    assert tp_plan(layer, _mesh(model), cfg) == want


def test_shard_params_cuts_whole_heads_and_columns():
    """Each rank's attention heads and MLP columns of a reduced model,
    float and 4-bit, concatenate to the whole."""
    from repro_torch.parallel.ep_shardmap import shard_params

    cfg = dataclasses.replace(treg.get_config("tinyllama-1.1b").reduced(), num_kv_heads=4)
    params = tget_model(cfg).init(torch.Generator().manual_seed(0))
    qcfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, group=32))
    packed = tspecs.quantize_dense_param_tree(params, qcfg)
    for tree in (params, packed):
        ranks = [shard_params(tree, _mesh(4, m), cfg)["layers"][0] for m in range(4)]
        whole = tree["layers"][0]
        for path, cols, row in (("attn", ("wq", "wk", "wv"), "wo"),
                                ("mlp", ("w_gate", "w_up"), "w_down")):
            for name, dim in [(c, 1) for c in cols] + [(row, 0)]:
                parts = [r[path][name]["w"] for r in ranks]
                got = torch.cat([p.dequantize() if isinstance(p, PackedTensor) else p
                                 for p in parts], dim=dim)
                w = whole[path][name]["w"]
                assert torch.equal(got, w.dequantize() if isinstance(w, PackedTensor) else w)
        assert ranks[1]["attn"]["wk"]["w"].shape[1] == cfg.head_dim  # one KV head a rank
        assert ranks[0]["ln1"] is whole["ln1"]  # norms stay whole, shared
