"""Quickstart: the full MC# pipeline on a pocket-size MoE LM, on the PyTorch
port (the port's counterpart of ``quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card unless ``--device cpu``:

1. builds a small 8-expert MoE LM,
2. runs PMQ: calibration → significance (Eq. 6) → LP bit allocation
   (Eq. 7) → GPTQ quantization → bit-bucketed compressed model,
3. runs OTP: Gumbel-Softmax router distillation (Eq. 14),
4. compares weight bytes, activated experts and output agreement.
"""
import argparse

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import pipeline
from repro_torch.core.otp_train import OTPTrainConfig, train_otp
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import make_calibration_tokens
from repro_torch.models import transformer as tf
from repro_torch.models.registry import get_model

CFG = ModelConfig(
    name="quickstart-moe",
    family="moe",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=128,
    d_ff_expert=128,
    vocab_size=512,
    num_experts=8,
    top_k=2,
    num_shared_experts=1,
    dtype="float32",
    remat="none",
    logits_chunk=64,
    attn_q_chunk=64,
    attn_kv_chunk=64,
    moe_capacity_factor=2.0,
)


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a * b).sum() / (a.norm() * b.norm()))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()
    dev = torch.device(args.device)

    print("=== MC# quickstart (PyTorch port) ===")
    params = get_model(CFG).init(torch.Generator(device=dev).manual_seed(0))
    fp_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"model: {CFG.num_experts} experts x {CFG.num_layers} layers, "
          f"{fp_bytes / 1e6:.1f} MB fp32, on {dev}")

    # --- PMQ ---------------------------------------------------------
    calib_tokens = torch.as_tensor(make_calibration_tokens(CFG.vocab_size, n=8, seq=64),
                                   dtype=torch.long, device=dev)
    calib = pipeline.calibrate(params, calib_tokens, CFG)
    print(f"calibration: phi[0] = {[round(float(v), 3) for v in calib.phi[0]]}")
    eps = pipeline.compute_eps(params, calib, CFG, eps_tokens=256)
    plan = pipeline.run_pmq(calib, eps, CFG, target_avg_bits=2.25)
    print(f"PMQ plan: avg {plan.avg_bits:.3f} bits, histogram {plan.histogram()}, "
          f"per-layer budgets {plan.layer_budgets.tolist()}")
    blocks_c, top = pipeline.compress_model(params, calib, plan, CFG, use_gptq=True)
    c_bytes = pipeline.model_weight_bytes(blocks_c, top)
    print(f"compressed: {c_bytes / 1e6:.1f} MB ({fp_bytes / c_bytes:.1f}x smaller)")

    # fidelity
    test_tokens = calib_tokens[:2]
    with torch.no_grad():
        h_fp, _, _ = tf.forward_hidden(params, test_tokens, CFG)
        h_c, _ = pipeline.compressed_forward(blocks_c, top, test_tokens, CFG)
    print(f"hidden-state cosine vs fp32: {_cosine(h_fp, h_c):.4f}")

    # --- OTP ---------------------------------------------------------
    data = make_calibration_tokens(CFG.vocab_size, n=64, seq=32, seed=7)
    otp_params, hist = train_otp(blocks_c, top, CFG, data,
                                 OTPTrainConfig(steps=40, batch=4, lr=5e-3, lam=1.5))
    print(f"OTP: mask ratio {hist[0]['mask_ratio']:.3f} → "
          f"{hist[-1]['mask_ratio']:.3f}, final KL {hist[-1]['kl']:.4f}")

    # --- comparison --------------------------------------------------
    with torch.no_grad():
        h_otp, masks = pipeline.compressed_forward(blocks_c, top, test_tokens, CFG,
                                                   otp_params=otp_params, collect_masks=True)
    active = float(torch.stack([m.float().mean() for m in masks]).mean())
    print(f"activated experts: {active * CFG.top_k:.2f} of top-{CFG.top_k} a token "
          f"({1 - active:.1%} pruned); hidden-state cosine vs fp32 "
          f"{_cosine(h_fp, h_otp):.4f}")
    print("=== done ===")


if __name__ == "__main__":
    main()
