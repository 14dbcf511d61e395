"""Plain PyTorch versions of the three decoupled-path kernels.

Shape for shape and operation for operation the reference's oracles
(``repro/kernels/ref.py``), apart from the log-bin index, which follows the
Pallas kernel (see ``hist_update_ref``).  The CPU path of ``ops`` runs them, the tests
hold them against the reference, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  Python-number operands enter float32
arithmetic rounded to float32, as the reference's weakly typed scalars do.
"""
from __future__ import annotations

import math

import torch

from repro_torch.numerics import div

_F32 = torch.float32


def tpdt_select_ref(counts, sums, N, total, centers, *, max_tpdt, tpdt_init):
    """PerfBound bin selection.  counts/sums: (P,B) f32; N/total: (P,).

    From the top bin downwards accumulate counts; choose the leftmost bin
    whose tail accumulation is <= N; t_PDT = mean of that bin (value sum /
    count, falling back to the bin center when empty).
    """
    rcum = torch.flip(torch.cumsum(torch.flip(counts, (1,)), 1), (1,))
    feas = rcum <= N[:, None]
    found = feas.any(1)
    j = torch.argmax(feas.to(torch.uint8), 1)[:, None]  # first True
    cj = counts.gather(1, j)[:, 0]
    sj = sums.gather(1, j)[:, 0]
    ctr = centers[j[:, 0]]
    mean = torch.where(cj > 0, torch.div(sj, torch.clamp_min(cj, 1e-30)),
                       ctr)
    t = torch.where(found, mean, max_tpdt)
    return torch.where(total > 0, t, tpdt_init).to(counts.dtype)


def hist_update_ref(gaps, *, n_bins, bin_width, log_bins=False,
                    log_min=1e-7, log_max=10.0):
    """Batched histogram build.  gaps: (E,P) f32 (<=0 entries ignored).
    Returns (counts (P,B), sums (P,B)).

    The log index follows the Pallas kernel, which the reference's
    decoupled path runs, rather than its oracle: float32 arithmetic against
    the edges ``log(log_min)`` and ``log(log_max) - log(log_min)`` rounded
    to float32 (the oracle keeps them in float64), as the CUDA kernel does,
    so that the port bins alike on every device.  The float index is
    clamped to [0, B-1] before the integer cast (a cast beyond the int
    range is undefined in PyTorch; the reference's saturating cast clips to
    the last bin)."""
    E, P = gaps.shape
    valid = gaps > 0
    if log_bins:
        lo, hi = math.log(log_min), math.log(log_max)
        lo32, den32 = (torch.tensor(v, dtype=_F32, device=gaps.device)
                       for v in (lo, hi - lo))
        x = div(torch.log(torch.clamp_min(gaps, log_min)) - lo32, den32)
        b = torch.clamp(x * n_bins, 0, n_bins - 1).to(torch.int64)
    else:
        b = torch.clamp(div(gaps, bin_width), 0, n_bins - 1).to(torch.int64)
    port = torch.arange(P, device=gaps.device)
    flat = (port * n_bins + b)[valid]
    g = gaps[valid]
    counts = torch.zeros(P * n_bins, dtype=_F32, device=gaps.device)
    sums = torch.zeros(P * n_bins, dtype=_F32, device=gaps.device)
    counts.index_put_((flat,), torch.ones_like(g), accumulate=True)
    sums.index_put_((flat,), g, accumulate=True)
    return counts.view(P, n_bins), sums.view(P, n_bins)


def log_bin_near_edge(gaps, *, n_bins, log_min, log_max, ulps=4):
    """Mask of the positive gaps whose log-bin index may differ between two
    float32 implementations of the binning (whose logs and divisions may
    differ in the last bit): those whose exact bin position lies
    within ``ulps`` float32 ulps of the log, and of the position itself,
    from an inner bin edge."""
    lo, hi = math.log(log_min), math.log(log_max)
    lo32, den32 = float(torch.tensor(lo, dtype=_F32)), \
        float(torch.tensor(hi - lo, dtype=_F32))
    L = torch.log(torch.clamp_min(gaps.double(), log_min))
    pos = (L - lo32) / den32 * n_bins

    def ulp(v):
        return torch.exp2(torch.floor(torch.log2(
            torch.clamp_min(v.abs(), 2.0 ** -126))) - 23)

    margin = ulps * (ulp(L) * n_bins / den32 + ulp(pos))
    k = torch.round(pos)                 # the nearest edge; 0 and B clip
    return (((pos - k).abs() <= margin) & (k >= 1) & (k <= n_bins - 1)
            & (gaps > 0))


def port_energy_ref(gaps, durs, tpdt, tail, *, t_w, t_s,
                    t_w2=0.0, t_s2=0.0, t_dst=None, hold=None):
    """Decoupled per-port EEE/PDT replay (fixed per-port t_PDT) with the
    dual-mode sleep ladder: gaps past ``tpdt + max(t_dst, t_s)`` demote to
    the deep row (t_w2/t_s2); ``t_dst`` is a scalar or (P,) timer —
    None/inf is the single-state lowering.  ``hold`` is the predictive
    hold-at-source row: a frame that finds its port asleep defers by up to
    ``hold`` seconds, stretching the effective gap (None/0 = off).

    gaps/durs: (E,P) f32 — idle gap before each busy interval and its
    duration (duration 0 = padding).  tpdt/tail: (P,).
    Returns dict of (P,) tensors: time_wake, time_sleep, time_sleep2,
    n_wake, hits, misses, n_deep.
    """
    E, P = gaps.shape
    dev = gaps.device
    if t_dst is None:
        t_dst = math.inf
    if hold is None:
        hold = 0.0
    tds = torch.maximum(torch.as_tensor(t_dst, dtype=_F32, device=dev),
                        torch.tensor(t_s, dtype=_F32, device=dev))
    hld = torch.as_tensor(hold, dtype=_F32, device=dev)

    z = torch.zeros((P,), dtype=_F32, device=dev)
    wake, sleep, sleep2, nw, hit, miss, nd = (z.clone() for _ in range(7))
    for e in range(E):
        g, d = gaps[e], durs[e]
        act = d > 0
        asleep = act & (g >= tpdt)
        ge = g + torch.where(asleep, hld, 0.0)
        deep = act & (ge >= tpdt + tds)
        wake_add = torch.where(
            asleep, torch.where(deep, tpdt + t_s + t_s2 + t_w2 + d,
                                tpdt + t_s + t_w + d), g + d)
        sleep_add = torch.where(
            asleep, torch.where(deep, tds - t_s,
                                torch.clamp_min(ge - tpdt - t_s, 0.0)), 0.0)
        sleep2_add = torch.where(
            deep, torch.clamp_min(ge - tpdt - tds - t_s2, 0.0), 0.0)
        wake = wake + torch.where(act, wake_add, 0.0)
        sleep = sleep + torch.where(act, sleep_add, 0.0)
        sleep2 = sleep2 + sleep2_add
        nw = nw + asleep.to(_F32)
        hit = hit + (act & ~asleep).to(_F32)
        miss = miss + asleep.to(_F32)
        nd = nd + deep.to(_F32)
    # close-out tail
    tail_sleeps = tail >= tpdt + t_s
    tail_deep = tail >= tpdt + tds + t_s2
    wake = wake + torch.where(
        tail_sleeps, tpdt + t_s + torch.where(tail_deep, t_s2, 0.0), tail)
    sleep = sleep + torch.where(
        tail_sleeps, torch.where(tail_deep, tds - t_s, tail - tpdt - t_s),
        0.0)
    sleep2 = sleep2 + torch.where(tail_deep, tail - tpdt - tds - t_s2, 0.0)
    return {"time_wake": wake, "time_sleep": sleep, "time_sleep2": sleep2,
            "n_wake": nw, "hits": hit, "misses": miss, "n_deep": nd}
