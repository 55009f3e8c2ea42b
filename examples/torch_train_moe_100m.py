"""Train a ~100M-param MoE LM on the synthetic corpus with checkpoint/restart,
on the PyTorch port (the port's counterpart of ``train_moe_100m.py``).

    PYTHONPATH=src python examples/torch_train_moe_100m.py --steps 300 [--device cpu]

~100M params: 6 layers x 512 d_model x 16 experts (top-2) x 1024 d_ff + 32k
vocab, f32. Each step is ``repro_torch.launch.train.train_step`` (AdamW,
``warmup_cosine`` over 20 warmup steps); a checkpoint every 100 steps and at
the end, in the reference's on-disk format, resumed from the latest.
``torch_otp_training.py`` compresses the result and trains its OTP routers.
"""
import argparse
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import HostDataLoader
from repro_torch.launch.train import batch_to, train_step
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init

CFG_100M = ModelConfig(
    name="moe-100m",
    family="moe",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    head_dim=64,
    d_ff=1024,
    d_ff_expert=1024,
    vocab_size=32768,
    num_experts=16,
    top_k=2,
    num_shared_experts=1,
    dtype="float32",
    remat="none",
    logits_chunk=64,
    attn_q_chunk=128,
    attn_kv_chunk=128,
    moe_capacity_factor=1.5,
)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=6e-4)
    p.add_argument("--ckpt-dir", default="results/ckpt_moe100m_torch")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()

    cfg = CFG_100M
    bundle = get_model(cfg)
    print(f"params: {cfg.param_count() / 1e6:.0f}M "
          f"(active/token {cfg.active_param_count() / 1e6:.0f}M)")
    params = bundle.init(torch.Generator(device=args.device).manual_seed(0))
    ocfg = AdamWConfig(lr=args.lr)
    opt_state = adamw_init(params, ocfg)
    loader = HostDataLoader(vocab=cfg.vocab_size, global_batch=args.batch, seq_len=args.seq)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    start = 0
    last = ckpt.latest_step()
    if last is not None:
        st = ckpt.restore(last, {"params": params, "opt": opt_state})
        params, opt_state = st["params"], st["opt"]
        start = last + 1
        print(f"resumed from step {last}")

    t0 = time.time()
    for step in range(start, args.steps):
        params, opt_state, loss = train_step(bundle.train_loss, params, opt_state,
                                             batch_to(loader.batch_at(step), args.device), ocfg,
                                             warmup=20, total=args.steps)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.4f}  ({time.time() - t0:.0f}s)")
        if (step + 1) % 100 == 0:
            ckpt.save(step, {"params": params, "opt": opt_state})
    ckpt.wait()
    ckpt.save(args.steps - 1, {"params": params, "opt": opt_state}, blocking=True)
    print("checkpoint:", args.ckpt_dir)


if __name__ == "__main__":
    main()
