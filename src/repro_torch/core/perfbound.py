"""PerfBound predictor state and binning (paper §2.5, §3.4).

This slice of the port carries the parts the non-adaptive replay and the
decoupled fast path need: the numeric parameter vector, the inactivity
histogram binning (``bin_index``/``bin_centers``) and the predictor state
of the non-adaptive kinds, which is the per-link ``tpdt`` vector alone.
The histogram, hop and shift-register updates of the adaptive kinds
(``record_gaps`` … ``forecast_update``) are not ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.eee import policy_params
from repro_torch.device import resolve_device
from repro_torch.numerics import div

MAXH = 7  # hop-count histogram rows 0..6 (Megafly max 5, fat-tree 6)


def _params(policy, params):
    """Numeric parameter vector: the policy's own scalars by default, or a
    caller-supplied dict.  Static structure always comes from ``policy``."""
    return policy_params(policy) if params is None else params


def _log(x):
    # python floats keep the exact libm value of the serial path
    return math.log(x) if isinstance(x, (int, float)) else torch.log(x)


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------


def bin_index(gap, policy, params=None):
    """gap (seconds, a tensor) -> int64 bin id in [0, B).

    The float index is clamped to [0, B-1] before the integer cast: a cast
    of a float beyond the int range is undefined in PyTorch, where the
    reference's saturating cast clips to the last bin."""
    p = _params(policy, params)
    B = policy.hist_bins
    if policy.hist_log_bins:
        lo, hi = _log(p["hist_log_min"]), _log(p["hist_log_max"])
        x = div(torch.log(torch.clamp_min(gap, p["hist_log_min"])) - lo,
                hi - lo)
        return torch.clamp(x * B, 0, B - 1).to(torch.int64)
    return torch.clamp(div(gap, p["hist_bin_width"]), 0, B - 1) \
        .to(torch.int64)


def bin_centers(policy, params=None, device=None):
    """(B,) float64 bin centres: the arithmetic centre of a linear bin, the
    geometric centre of a log bin."""
    dev = resolve_device(device)
    p = _params(policy, params)
    B = policy.hist_bins
    if policy.hist_log_bins:
        lo, hi = math.log(p["hist_log_min"]), math.log(p["hist_log_max"])
        edges = np.exp(np.linspace(lo, hi, B + 1))
        return torch.as_tensor(np.sqrt(edges[:-1] * edges[1:]), device=dev)
    return (torch.arange(B, dtype=torch.float64, device=dev) + 0.5) \
        * p["hist_bin_width"]


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def init_state(n_links, policy, params=None, device=None):
    """Predictor state for ``n_links`` (+dummy) rows: the ``tpdt`` vector,
    which is all the non-adaptive kinds carry."""
    if policy.adaptive or policy.record_hist:
        raise NotImplementedError(
            f"policy kind {policy.kind!r} (record_hist="
            f"{policy.record_hist}) needs the PerfBound predictors, which "
            "are not ported yet (ROADMAP.md, Queue 1: the rest of "
            "core/perfbound.py)")
    dev = resolve_device(device)
    return {"tpdt": torch.full((n_links,), _initial_tpdt(policy, params),
                               dtype=torch.float64, device=dev)}


def _initial_tpdt(policy, params=None):
    p = _params(policy, params)
    if policy.kind == "none":
        return math.inf
    if policy.kind in ("fixed", "dual", "coalesce", "precoalesce", "predict"):
        # predict starts dual-like: the forecaster takes over per port as
        # soon as the first gap lands in its histogram
        return p["t_pdt"]
    return p["tpdt_init"]
