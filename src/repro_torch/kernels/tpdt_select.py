"""CUDA wrapper of PerfBound's t_PDT selection kernel
(``csrc/tpdt_select.cu``; replaces the TPU kernel
``repro/kernels/tpdt_select.py:tpdt_select_pallas``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 6 + (_I, _I, _F, _F, _P)


def tpdt_select_cuda(counts, sums, N, total, centers, *, max_tpdt,
                     tpdt_init):
    """counts/sums: (P,B) f32 on a CUDA device; N/total: (P,); centers:
    (B,).  Returns (P,) f32.  Adds one to ``tpdt_select_cuda.launches``
    per launch."""
    dev = counts.device
    if dev.type != "cuda":
        raise ValueError(f"tpdt_select_cuda needs CUDA tensors, got {dev}")
    P, B = counts.shape
    for what, t, shape in (("counts", counts, (P, B)), ("sums", sums, (P, B)),
                           ("N", N, (P,)), ("total", total, (P,)),
                           ("centers", centers, (B,))):
        _build.expect(what, t, shape, dev)
    out = torch.empty((P,), dtype=torch.float32, device=dev)
    fn = _build.load("tpdt_select", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(counts.data_ptr(), sums.data_ptr(), N.data_ptr(),
                 total.data_ptr(), centers.data_ptr(), out.data_ptr(), P, B,
                 max_tpdt, tpdt_init, _build.stream_of(dev))
    _build.check("tpdt_select", err)
    tpdt_select_cuda.launches += 1
    return out


tpdt_select_cuda.launches = 0
