"""CUDA wrapper of the decoupled per-port energy replay kernel
(``csrc/port_energy.cu``; replaces the TPU kernel
``repro/kernels/port_energy.py:port_energy_pallas``)."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

# the reference kernel's event cap, kept so both packages accept the same
# inputs
MAX_E = 8192
KEYS = ("time_wake", "time_sleep", "time_sleep2", "n_wake", "hits",
        "misses", "n_deep")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_P,) * 7 + (_I, _I) + (_F,) * 4 + (_P,)


def port_energy_cuda(gaps, durs, tpdt, tail, *, t_w, t_s, t_w2=0.0,
                     t_s2=0.0, t_dst=None, hold=None):
    """gaps/durs: (E, P) f32 on a CUDA device; tpdt/tail: (P,) f32;
    ``t_dst``/``hold``: scalar or (P,), None = +inf / 0.  Returns a dict of
    seven (P,) f32 accounts.  Adds one to ``port_energy_cuda.launches``
    per launch."""
    dev = gaps.device
    if dev.type != "cuda":
        raise ValueError(f"port_energy_cuda needs CUDA tensors, got {dev}")
    E, P = gaps.shape
    if E > MAX_E:
        raise ValueError(f"E={E} exceeds the kernel cap MAX_E={MAX_E}")
    if t_dst is None:
        t_dst = math.inf
    if hold is None:
        hold = 0.0
    # demotion cannot precede the first down transition: clamp t_dst >= t_s
    tds = torch.maximum(torch.as_tensor(t_dst, dtype=torch.float32,
                                        device=dev),
                        torch.tensor(t_s, dtype=torch.float32, device=dev))
    tds = tds.broadcast_to((P,)).contiguous()
    hld = torch.as_tensor(hold, dtype=torch.float32, device=dev) \
        .broadcast_to((P,)).contiguous()
    for what, t, shape in (("gaps", gaps, (E, P)), ("durs", durs, (E, P)),
                           ("tpdt", tpdt, (P,)), ("tail", tail, (P,))):
        _build.expect(what, t, shape, dev)
    out = torch.empty((len(KEYS), P), dtype=torch.float32, device=dev)
    fn = _build.load("port_energy", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(gaps.data_ptr(), durs.data_ptr(), tpdt.data_ptr(),
                 tds.data_ptr(), hld.data_ptr(), tail.data_ptr(),
                 out.data_ptr(), E, P, t_w, t_s, t_w2, t_s2,
                 _build.stream_of(dev))
    _build.check("port_energy", err)
    port_energy_cuda.launches += 1
    return dict(zip(KEYS, out))


port_energy_cuda.launches = 0
