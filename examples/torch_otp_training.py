"""OTP router training on a PMQ-compressed checkpoint, on the PyTorch port
(the port's counterpart of ``otp_training.py``, paper §3.4).

    PYTHONPATH=src python examples/torch_otp_training.py \
        --ckpt results/ckpt_moe100m_torch [--device cpu]

Loads the 100M MoE checkpoint — one written by ``torch_train_moe_100m.py``,
or one the reference's ``train_moe_100m.py`` wrote (its stacked params are
carried into the port by ``repro_torch.interop.params_from_checkpoint``) —
or falls back to a random model; compresses it with the port's PMQ
pipeline, trains the per-layer DM routers at each sparsity weight λ and
reports the mask-ratio trajectories (paper Fig. 13).
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core.otp_train import OTPTrainConfig, train_otp  # noqa: E402
from repro_torch.data.pipeline import make_calibration_tokens  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from torch_train_moe_100m import CFG_100M  # noqa: E402


def load_params(ckpt_dir, device):
    params = get_model(CFG_100M).init(torch.Generator(device=device).manual_seed(0))
    if os.path.isdir(ckpt_dir):
        ckpt = Checkpointer(ckpt_dir)
        last = ckpt.latest_step()
        if last is not None:
            print(f"loaded checkpoint step {last}")
            if any(k.startswith("params/blocks/") for k in ckpt.arrays(last)):
                return interop.params_from_checkpoint(ckpt, last, device=device)
            opt = adamw_init(params, AdamWConfig())
            return ckpt.restore(last, {"params": params, "opt": opt})["params"]
    print("WARNING: no checkpoint found — using random init")
    return params


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default="results/ckpt_moe100m_torch")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--lams", default="0.5,1.0,2.0")
    p.add_argument("--bits", type=float, default=2.25)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()

    cfg = CFG_100M
    params = load_params(args.ckpt, args.device)
    calib_tokens = torch.as_tensor(make_calibration_tokens(cfg.vocab_size, 8, 128),
                                   device=args.device).long()
    calib = pipeline.calibrate(params, calib_tokens, cfg)
    eps = pipeline.compute_eps(params, calib, cfg, eps_tokens=512)
    plan = pipeline.run_pmq(calib, eps, cfg, args.bits)
    print(f"PMQ: avg {plan.avg_bits:.3f} bits {plan.histogram()}")
    blocks_c, top = pipeline.compress_model(params, calib, plan, cfg, use_gptq=False)
    data = make_calibration_tokens(cfg.vocab_size, 128, 64, seed=3)
    out = {}
    for lam in [float(x) for x in args.lams.split(",")]:
        tcfg = OTPTrainConfig(steps=args.steps, batch=4, lr=5e-3, lam=lam)
        _, hist = train_otp(blocks_c, top, cfg, data, tcfg)
        traj = [h["mask_ratio"] for h in hist]
        out[lam] = {"final_mask_ratio": traj[-1], "final_kl": hist[-1]["kl"]}
        print(f"λ={lam}: mask ratio {traj[0]:.3f} → {traj[-1]:.3f} "
              f"(KL {hist[-1]['kl']:.4f})")
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
