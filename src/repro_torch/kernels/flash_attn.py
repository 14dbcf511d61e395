"""CUDA wrapper of the flash-attention forward kernel
(``csrc/flash_attn_fwd.cu``; replaces the TPU kernel
``repro/kernels/flash_attn.py:flash_attention_fwd_pallas``)."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

# the head dims of the repository's configs (configs/*.py)
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the score of a masked position, as in the TPU kernel
NEG = -0.7 * float(torch.finfo(torch.float32).max)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 5 + (_I,) * 9 + (_F, _F, _P)


def check_forward_only(*ts):
    """The kernel has no backward yet: refuse inputs that need one rather
    than differentiate through something else."""
    if any(t.requires_grad for t in ts):
        raise RuntimeError(
            "flash attention is forward-only: an input requires grad (the "
            "backward kernels come with the training path, ROADMAP Queue 2 "
            "item 5)")


def flash_attention_fwd_cuda(q, k, v, *, causal=True, window=None):
    """q: (B, Sq, H, dh); k/v: (B, Skv, Hkv, dh), contiguous, float32 or
    bfloat16 on a CUDA device, ``H % Hkv == 0``, dh in ``HEAD_DIMS``;
    bfloat16 runs on the tensor cores, float32 on the CUDA cores.
    Masks: causal ``k_pos <= q_pos``, window ``q_pos - k_pos < window``.
    Returns ``(o, lse)``: ``o`` (B, Sq, H, dh) in q's dtype and ``lse``
    (B*Hkv, H/Hkv, Sq) float32.  Adds one to
    ``flash_attention_fwd_cuda.launches`` per launch."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_fwd_cuda needs CUDA tensors, "
                         f"got {dev}")
    check_forward_only(q, k, v)
    if q.dtype not in DTYPES:
        raise ValueError(f"flash attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q and k/v must be (B, S, heads, dh)")
    B, Sq, H, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not supported; the kernel takes "
                         f"{HEAD_DIMS}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    _build.expect("q", q, (B, Sq, H, dh), dev, q.dtype)
    _build.expect("k", k, (B, Skv, Hkv, dh), dev, q.dtype)
    _build.expect("v", v, (B, Skv, Hkv, dh), dev, q.dtype)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("the bf16 kernel reads 16-byte rows: q, k and v "
                         "must start on a 16-byte boundary")
    o = torch.empty_like(q)
    lse = torch.empty((B * Hkv, H // Hkv, Sq), dtype=torch.float32,
                      device=dev)
    fn = _build.load("flash_attn_fwd", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), DTYPES[q.dtype], B, Sq, Skv, H, Hkv, dh,
                 int(bool(causal)), 0 if window is None else int(window),
                 1.0 / math.sqrt(dh), NEG, _build.stream_of(dev))
    _build.check("flash_attn_fwd", err)
    flash_attention_fwd_cuda.launches += 1
    return o, lse


flash_attention_fwd_cuda.launches = 0
