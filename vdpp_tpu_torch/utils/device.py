"""Device resolution for the port's entry points.

The port runs on a CUDA device unless the caller asks for the CPU. Without a
CUDA device an entry point raises instead of carrying on on the CPU: the CPU
path exists for tests, which pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device must exist; ``"cpu"`` and
    ``"meta"`` are taken as asked.

    Also pins fp32 matmuls and convolutions to full fp32 (no TF32), the
    precision the JAX reference computes them in.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
