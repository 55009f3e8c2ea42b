"""Time the paged-attention kernels of one checkout on one GPU, at the
decode shape and at a long context.

    python3 src/repro_torch/launch/probe_attention.py [--root DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: the checkout this file
lies in), so the same script times an older tree's kernels beside this
one's in one call: their wrappers take the same arguments. Run it as a file,
not with ``-m``, or the package of the current directory is imported first.

Shapes: B=4 sequences, head_dim 128, 16-token pages, bf16 q, permuted
physical pages; 16 KV heads at G=1 (``moonshot-v1-16b-a3b``) with every
sequence at length 80 (``decode``: 6-page tables, the full-width serving
shape mid-decode) or 4096 (``long``: 256-page tables), 8 KV heads at G=5
(``qwen3-14b``) at length 80 (``decode_g5``), 16 KV heads at G=2 at length
1104 under a window of 1024 (``window_g2``: ``gemma3-27b``'s local layers
mid-decode; only the window's rows count in the bound) and 8 KV heads at
G=8 (``kimi-k2-1t-a32b``) at length 80 (``decode_g8``). For ``paged_attention``
(bf16 pools) and ``paged_attention_quant`` (uint8 pools + f32 row tables) at
each shape it measures the kernel, its plain version and
``scaled_dot_product_attention`` over the gathered (for int8: dequantized
bf16) pages, each the median, min and max of 50 launches with the L2 flushed
before each, the SM clock read before and after the kernel's timing; and the
byte bound of the pages visited at 3.35 TB/s. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_BF16_OPS_PER_S = 989e12
#: name -> (length, KV heads, G, window)
SHAPES = {"decode": (80, 16, 1, None), "long": (4096, 16, 1, None),
          "decode_g5": (80, 8, 5, None), "window_g2": (1104, 16, 2, 1024),
          "decode_g8": (80, 8, 8, None)}
B, DH, BS = 4, 128, 16


def time_ms(fn, iters: int = 50):
    """Median, min and max device time of ``fn`` in ms (CUDA events), the
    50 MB L2 flushed before each launch and the stream held by a device
    sleep while the host enqueues, so the events bracket device work only."""
    dev = torch.device("cuda")
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for _ in range(3):
        fn()
    ts = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        scrub.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts), min(ts), max(ts)


def sm_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def load(root: Path) -> SimpleNamespace:
    """The attention wrappers, their count of a launch's work, plain version
    and KV quantizer of the ``repro_torch`` under ``root/src`` (a tree with
    ``paged_attention_work``)."""
    sys.path.insert(0, str(root / "src"))
    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    ref = importlib.import_module("repro_torch.kernels.ref")
    quant = importlib.import_module("repro_torch.core.quantizers")
    return SimpleNamespace(paged_attention=pa.paged_attention,
                           paged_attention_quant=pa.paged_attention_quant,
                           work=pa.paged_attention_work,
                           ref=ref.paged_attention_ref,
                           quantize_kv_rows=quant.quantize_kv_rows,
                           dequantize_kv_rows=quant.dequantize_kv_rows)


def attention_case(mods, kind: str, length: int, gen, hkv: int = 16, g: int = 1,
                   window=None) -> dict:
    """Inputs at ``length`` (``hkv`` KV heads of ``g`` queries each; the
    last ``window`` positions attended, if given) and three callables on
    them — ``kernel``, ``plain`` and ``library`` (SDPA over the gathered
    pages) — with the bytes the kernel must move (the attended rows) and
    the products it does. The inputs are made on ``gen``'s device."""
    dev = gen.device
    mb = -(-length // BS) + (1 if length == SHAPES["decode"][0] else 0)  # decode: 6 pages
    nb = B * mb
    q = torch.randn((B, hkv, g, DH), generator=gen, device=dev).to(torch.bfloat16)
    rows = [torch.randn((nb, BS, hkv, DH), generator=gen, device=dev) for _ in range(2)]
    tables = torch.randperm(nb, generator=gen, device=dev).reshape(B, mb).to(torch.int32)
    lens = torch.full((B,), length, dtype=torch.int32, device=dev)
    phys = (tables.long()[:, :, None] * BS + torch.arange(BS, device=dev)).reshape(B, -1)
    # attended rows: whole pages without a window (80 and 4096 are whole)
    kv_rows = B * (min(length, window) if window else -(-length // BS) * BS)
    if kind == "paged_attention":
        kp, vp = (r.to(torch.bfloat16) for r in rows)
        k_g, v_g = (p.reshape(-1, hkv, DH)[phys] for p in (kp, vp))
        kernel = lambda: mods.paged_attention(q, kp, vp, tables, lens, window=window)  # noqa: E731
        plain = lambda: mods.ref(q, kp, vp, tables, lens, window=window)  # noqa: E731
        work = mods.work(q, kp, tables, kv_rows=kv_rows)
    else:
        (kc, ks, kz), (vc, vs, vz) = (mods.quantize_kv_rows(r * 2) for r in rows)
        quant = (ks, kz, vs, vz)
        gs = [t.reshape(-1, hkv)[phys] for t in quant]
        k_g = mods.dequantize_kv_rows(kc.reshape(-1, hkv, DH)[phys], gs[0], gs[1])
        v_g = mods.dequantize_kv_rows(vc.reshape(-1, hkv, DH)[phys], gs[2], gs[3])
        k_g, v_g = k_g.to(torch.bfloat16), v_g.to(torch.bfloat16)
        kernel = lambda: mods.paged_attention_quant(q, kc, vc, *quant, tables, lens,  # noqa: E731
                                                    window=window)
        plain = lambda: mods.ref(q, kc, vc, tables, lens, window=window,  # noqa: E731
                                 quant=quant)
        # per attended row and KV head: dh code bytes of K and of V, 4 f32 table entries
        work = mods.work(q, kc, tables, quant=True, kv_rows=kv_rows)
    k_g, v_g = k_g.permute(0, 2, 1, 3), v_g.permute(0, 2, 1, 3)
    pos = torch.arange(mb * BS, device=dev)[None, :]
    mask = pos < lens[:, None].long()
    if window:
        mask &= pos > lens[:, None].long() - 1 - window
    mask = mask[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if g > 1:  # SDPA's grouped-query form: the query heads of a KV head side by side
        library = lambda: sdpa(q.reshape(B, hkv * g, 1, DH), k_g, v_g,  # noqa: E731
                               attn_mask=mask, enable_gqa=True)
    else:
        library = lambda: sdpa(q, k_g, v_g, attn_mask=mask)  # noqa: E731
    return dict(kernel=kernel, plain=plain, library=library, bytes=work.bytes, ops=work.flops)


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure(mods, kind: str, shape: str, gen) -> dict:
    length, hkv, g, window = SHAPES[shape]
    c = attention_case(mods, kind, length, gen, hkv, g, window)
    before = sm_clock()
    med, lo, hi = time_ms(c["kernel"])
    after = sm_clock()
    b_ms, b_by = bound_ms(c["bytes"], c["ops"])
    return dict(ms=med, ms_min=lo, ms_max=hi, sm_clock=[before, after],
                plain_ms=time_ms(c["plain"])[0], library_ms=time_ms(c["library"])[0],
                bound_ms=b_ms, bound_by=b_by,
                shape=f"B={B} Hkv={hkv} G={g} dh={DH} BS={BS} len={length}"
                      + (f" window={window}" if window else "") + " bf16 q")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[3],
                    help="checkout whose src/repro_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_attention measures the GPU; no CUDA device found")
    mods = load(args.root.resolve())
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(args.root)}
    for kind in ("paged_attention", "paged_attention_quant"):
        for name in SHAPES:
            out[f"{kind} {name}"] = measure(mods, kind, name, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out["device"] = smi
    print(json.dumps(out))


if __name__ == "__main__":
    main()
