"""tpinn_torch.kernels — hand-written Hopper kernels for the hot paths.

CUDA sources live in ``csrc/`` and are compiled with ``nvcc`` at first
use (``_build``); importing these modules builds nothing, so the CPU test
suite imports them freely and runs each kernel's plain PyTorch version.
"""
