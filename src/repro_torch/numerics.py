"""Elementwise helpers that keep IEEE semantics on every device.

PyTorch's CUDA division by a Python number multiplies by the number's
reciprocal, and ``number / tensor`` is computed as ``tensor.reciprocal() *
number`` on every device; both can differ from a true division in the last
bit.  The reference divides, so the port divides by a 0-d tensor instead.
"""
from __future__ import annotations

import torch


def div(a, b):
    """``a / b`` as an IEEE division; either side may be a Python number."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)
