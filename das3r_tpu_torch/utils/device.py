"""Device selection shared by the port's entry points."""
from __future__ import annotations

import subprocess

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: raise when CUDA is absent rather than carry
    on on the CPU. Any named device (``"cpu"``, ``"cuda:1"``) is taken as
    given.

    It also turns TF32 off for cuBLAS matmuls and cuDNN convolutions (the
    latter is on by default): every entry point resolves its device here,
    so the port computes in IEEE float32 as the JAX package's
    ``precision="highest"`` does, and what is measured is what runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def on_device(x, device, dtype=None):
    """``x`` (tensor, numpy array, number or None) as a tensor on
    ``device``. A numpy array is copied: it may be a read-only view of
    another framework's buffer, which cannot back a tensor."""
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        x = np.array(x)
    return torch.as_tensor(x, dtype=dtype, device=device)


def card_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` gives them (None
    where it cannot be run): the line every measurement is reported
    beside."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None
