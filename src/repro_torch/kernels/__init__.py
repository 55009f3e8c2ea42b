"""The port's kernels: hand-written Hopper CUDA (``csrc/``), their wrappers
(device routing, checks, launch counters) and plain PyTorch versions
(``ref``). Nothing here builds or imports CUDA code at import time."""
