"""The one place where the port decides which device a run uses."""

from __future__ import annotations

import torch


def resolve_device(name="cuda") -> torch.device:
    """The device of a run: the card unless the caller asks for the CPU.
    CUDA must be present when asked for (it raises, it never falls back to the
    CPU).  Float32 stays float32: TF32 is switched off for cuDNN and matmuls,
    so the plain convs and the kernels compute the same thing."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r}: no CUDA device is available (pass device='cpu', --device cpu "
                "on the command line, to run the plain PyTorch versions on the CPU)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device
