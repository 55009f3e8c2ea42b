"""PyTorch + CUDA port of the MC# serving path (PMQ bit buckets + OTP
pruning through the paged engine) for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports neither
``jax`` nor anything of ``repro``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on a CPU tensor every kernel wrapper runs
its plain PyTorch version (``repro_torch.kernels.ref``), on a CUDA tensor
it launches the hand-written Hopper kernel or raises.
"""
