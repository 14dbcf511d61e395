"""Dispatching wrappers for the decoupled-path kernels.

The contract of the reference's ``kernels/ops.py``: operands are cast to
float32; a tensor on a CUDA device launches the hand-written kernel (which
raises on anything it cannot take); a tensor on the CPU, or
``use_ref=True`` on either device, takes the plain PyTorch version.  There
is no fallback from a failed kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.hist_update import hist_update_cuda
from repro_torch.kernels.port_energy import port_energy_cuda
from repro_torch.kernels.tpdt_select import tpdt_select_cuda

KERNELS = {"port_energy": port_energy_cuda, "hist_update": hist_update_cuda,
           "tpdt_select": tpdt_select_cuda}


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def _f32(x):
    return x.to(torch.float32).contiguous()


def _plain(x, use_ref):
    return use_ref or x.device.type == "cpu"


def tpdt_select_op(counts, sums, N, total, centers, *, max_tpdt, tpdt_init,
                   use_ref=False):
    args = [_f32(a) for a in (counts, sums, N, total, centers)]
    kw = dict(max_tpdt=max_tpdt, tpdt_init=tpdt_init)
    if _plain(counts, use_ref):
        return ref.tpdt_select_ref(*args, **kw)
    return tpdt_select_cuda(*args, **kw)


def hist_update_op(gaps, *, n_bins, bin_width, log_bins=False, log_min=1e-7,
                   log_max=10.0, use_ref=False):
    kw = dict(n_bins=n_bins, bin_width=bin_width, log_bins=log_bins,
              log_min=log_min, log_max=log_max)
    if _plain(gaps, use_ref):
        return ref.hist_update_ref(_f32(gaps), **kw)
    return hist_update_cuda(_f32(gaps), **kw)


def port_energy_op(gaps, durs, tpdt, tail, t_dst=None, hold=None, *, t_w,
                   t_s, t_w2=0.0, t_s2=0.0, use_ref=False):
    """Per-port energy replay; the dual-mode row (t_w2/t_s2) engages for
    gaps past ``tpdt + max(t_dst, t_s)`` (None -> +inf -> single-state).
    ``hold`` is the predictive hold-at-source row (None -> 0 -> off)."""
    kw = dict(t_w=t_w, t_s=t_s, t_w2=t_w2, t_s2=t_s2, t_dst=t_dst, hold=hold)
    args = [_f32(a) for a in (gaps, durs, tpdt, tail)]
    if _plain(gaps, use_ref):
        return ref.port_energy_ref(*args, **kw)
    return port_energy_cuda(*args, **kw)
