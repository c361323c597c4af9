"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  Asking for
``cuda`` where there is none raises: nothing moves to the CPU silently.  The
kernel wrappers (``ops/*_cuda.py``) need no switch of their own: a CPU tensor
takes the plain PyTorch version, a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch.cuda.is_available() is "
            "False; pass device=cpu to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_fp32_math() -> None:
    """Keep float32 products and convolutions in full float32.

    PyTorch defaults ``torch.backends.cuda.matmul.allow_tf32`` to False but
    ``torch.backends.cudnn.allow_tf32`` to True, so a float32 convolution
    would round its inputs to TF32 on the card.  The JAX reference computes
    float32 work in float32, so both switches are set off where a model starts.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
