"""CUDA wrapper of the per-port inactivity histogram kernel
(``csrc/hist_update.cu``; replaces the TPU kernel
``repro/kernels/hist_update.py:hist_update_pallas``)."""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build

# the reference kernel's event cap, kept so both packages accept the same
# inputs
MAX_E = 8192
SMEM_BYTES = 227 * 1024   # dynamic shared memory one block may use on Hopper
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P, _P, _P) + (_I,) * 5 + (_F,) * 4 + (_P,)


def threads_for(n_bins: int) -> int:
    """Ports per block: 64 where both (B, T) accumulators fit in shared
    memory, else 32; raises when even 32 do not fit."""
    for t in (64, 32):
        if 2 * n_bins * t * 4 <= SMEM_BYTES:
            return t
    raise ValueError(f"n_bins={n_bins} is too large for the histogram "
                     f"kernel's shared-memory accumulators")


def hist_update_cuda(gaps, *, n_bins, bin_width, log_bins=False,
                     log_min=1e-7, log_max=10.0):
    """gaps: (E, P) f32 on a CUDA device.  Returns (counts (P,B),
    sums (P,B)) f32.  Adds one to ``hist_update_cuda.launches`` per
    launch."""
    dev = gaps.device
    if dev.type != "cuda":
        raise ValueError(f"hist_update_cuda needs CUDA tensors, got {dev}")
    E, P = gaps.shape
    if E > MAX_E:
        raise ValueError(f"E={E} exceeds the kernel cap MAX_E={MAX_E}")
    _build.expect("gaps", gaps, (E, P), dev)
    threads = threads_for(n_bins)
    # the TPU kernel's weakly typed constants: f32(lo), f32(hi - lo)
    lo, hi = math.log(log_min), math.log(log_max)
    lo32, den32 = float(np.float32(lo)), float(np.float32(hi - lo))
    counts = torch.empty((P, n_bins), dtype=torch.float32, device=dev)
    sums = torch.empty((P, n_bins), dtype=torch.float32, device=dev)
    fn = _build.load("hist_update", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(gaps.data_ptr(), counts.data_ptr(), sums.data_ptr(), E, P,
                 n_bins, threads, int(bool(log_bins)), bin_width, log_min,
                 lo32, den32, _build.stream_of(dev))
    _build.check("hist_update", err)
    hist_update_cuda.launches += 1
    return counts, sums


hist_update_cuda.launches = 0
