"""PyTorch/CUDA port of kinpoly_tpu.

The JAX package ``kinpoly_tpu`` stays the reference; this package mirrors it
module for module in PyTorch, with hand-written CUDA kernels (``csrc/``) in
place of its Pallas TPU kernels. It imports torch, numpy and the standard
library only (scipy inside the SMPL archive reader, for a sparse
regressor). ``parallel/`` holds the data parallelism over
torch.distributed. One JAX module has no counterpart:
``utils/visualizer.py`` is MuJoCo's renderer, which the port does not
import (``utils/html_viewer.py`` views a motion instead).
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    something else. Never falls back to the CPU: asking for CUDA (or asking
    for nothing) without a GPU raises.

    On CUDA, float32 matmuls and convolutions are pinned to full precision
    (no TF32): the 75x75 mass-matrix factorisation breaks at reduced
    precision, which is also why the JAX package forces HIGHEST precision in
    its substep."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
