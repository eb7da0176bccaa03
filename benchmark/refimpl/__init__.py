"""The benchmark's plain reference: the UHC env, its physics, the MCP
policy, the value net and the PPO update in plain PyTorch, run in float64,
with plain solves (``physics/*_cuda.py``) in place of the program's CUDA
kernels. It was copied from ``kinpoly_tpu_torch``'s plain paths and then
frozen: it imports nothing of that package, of JAX or of the JAX package,
and later changes to the program do not reach it. Its agreement with the
JAX package rests on the program's own tests, which held those paths to
``kinpoly_tpu`` in float64 when it was copied; ``benchmark/tests`` hold it
to the program on the CPU.
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
