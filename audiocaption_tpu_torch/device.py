"""Device selection shared by every entry point of the port.

Entry points default to ``device="cuda"``.  There is no silent CPU
fallback: asking for CUDA on a machine without it raises, and the CPU
runs only when the caller passes ``device="cpu"``.

Parity stance on the card: float32 convolutions and matmuls run in full
float32, not TF32.  cuDNN convolutions default to TF32 (about three
decimal digits), which would move the encoder's output away from the
JAX reference, so :func:`resolve_device` switches TF32 off for both
cuDNN and cuBLAS whenever it hands out a CUDA device.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def set_parity_precision() -> None:
    """Full-float32 convolutions and matmuls on the card (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Validate ``device``; raise if CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "port on the CPU")
        set_parity_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
