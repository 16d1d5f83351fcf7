"""Plain PyTorch version of the batched GEMM (the counterpart of
``src/repro/kernels/supsup/ref.py``)."""
from __future__ import annotations

import torch


def gemm_batched_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (E, nr, k) @ b (E, k, m) → (E, nr, m)."""
    return torch.matmul(a, b)
