"""Device selection shared by the port's entry points."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: raise when CUDA is absent rather than carry
    on on the CPU. Any named device (``"cpu"``, ``"cuda:1"``) is taken as
    given."""
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
