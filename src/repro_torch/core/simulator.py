"""Coupled network power simulator: a per-message loop of device ops.

Each message walks its (<=5-hop) minimal route with a cut-through timing
model, checks/updates every traversed link's EEE FSM (PDT timers, the
Fast Wake -> Deep Sleep demotion ladder, coalescing deferrals, wake
penalties), and integrates per-link wake/sleep/deep-sleep time for energy
accounting.

Layout: the per-link row state lives in one float64 ``(F, P)`` tensor and
one int64 ``(4, P)`` tensor; the ``net`` dict hands out row views of them,
and a dummy row (index ``n_links``) stays in the layout as in the
reference.  A message gathers its links' rows in one indexing op, runs the
hop chain on 0-d tensors, and writes the rows back in one op (a route
never repeats a link, so the row indices are unique).  State is updated in
place.

Only the message's active slots run: a route's real hops form a prefix of
its slot row, and the reference sends every inactive slot to the dummy
row, which no real row ever reads.  Every real row therefore gets the
reference's arithmetic operand for operand.

Execution-time semantics come from the phase-structured replay
(``simulate_trace_reference``): per-node ready times advance across trace
steps with message-delivery dependencies.

This slice covers the non-adaptive kinds (``none``, ``fixed``, ``dual``,
``coalesce``, ``precoalesce``); the PerfBound predictors of the adaptive
kinds are not ported yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import perfbound as pb
from repro_torch.core.eee import Policy, PowerModel
from repro_torch.device import resolve_device
from repro_torch.numerics import div
from repro_torch.traffic.plan import pad_message_table

_F64 = torch.float64
_I64 = torch.int64
# int64 row block: (n_wake, n_miss, n_hit, n_deep)
_COUNT_KEYS = ("n_wake", "n_miss", "n_hit", "n_deep")


def _check_kind(policy: Policy):
    if policy.adaptive or policy.record_hist:
        raise NotImplementedError(
            f"policy kind {policy.kind!r} (record_hist="
            f"{policy.record_hist}) needs the PerfBound predictors "
            "(perfbound.record_gaps ... forecast_update), which are not "
            "ported yet (ROADMAP.md, Queue 1: the rest of core/perfbound.py "
            "and core/simulator.py)")


def _defer_keys(policy: Policy):
    if policy.kind == "coalesce":
        return ("coal_n", "coal_prev", "coal_release")
    if policy.kind == "precoalesce":
        return ("pre_n", "pre_prev", "pre_release")
    return ()


# float64 row block: these rows, then the coalescing kinds' cycle triple
_BASE_ROWS = ("last_end", "deadline", "deadline2", "time_wake", "time_sleep",
              "time_sleep2", "tpdt")


def _row_keys(policy: Policy):
    """float64 row block layout, in gather/scatter order."""
    return _BASE_ROWS + _defer_keys(policy)


# ---------------------------------------------------------------------------
# Network state
# ---------------------------------------------------------------------------


def init_net(n_links, policy: Policy, params=None, device=None):
    """Zeroed network state with the PDT timers armed at t=0.

    The returned dict holds views into two packed row blocks (kept under
    ``"_rows"`` and ``"_counts"``); ``net["pred"]["tpdt"]`` is a row of the
    float block."""
    _check_kind(policy)
    dev = resolve_device(device)
    P = n_links + 1  # +1 dummy row, as in the reference layout
    # PDT timers are armed at t=0 (ports start awake, counting down).  The
    # demotion deadline sits a (clamped) t_dst past the sleep deadline; for
    # single-state kinds t_dst = +inf keeps the deep row unreachable.
    p = pb._params(policy, params)
    dl0 = pb._initial_tpdt(policy, params)
    dl2_0 = dl0 + max(p["t_dst"], p["t_s"])
    keys = _row_keys(policy)
    rows = torch.zeros((len(keys), P), dtype=_F64, device=dev)
    counts = torch.zeros((len(_COUNT_KEYS), P), dtype=_I64, device=dev)
    net = {"dir_free": torch.zeros((2 * n_links + 1,), dtype=_F64,
                                   device=dev),
           "_rows": rows, "_counts": counts}
    net.update(zip(keys, rows))
    net.update(zip(_COUNT_KEYS, counts))
    net["deadline"].fill_(dl0)
    net["deadline2"].fill_(dl2_0)
    net["tpdt"].fill_(dl0)
    net["pred"] = {"tpdt": net.pop("tpdt")}
    return net


# ---------------------------------------------------------------------------
# One message
# ---------------------------------------------------------------------------


def _slot_rows(links, dirs, nhops, valid, n_links):
    """Per-slot row ids: (active mask, link row ``lp``, directed row ``dp``).
    Inactive slots land on the dummy rows (``n_links`` / ``2*n_links``)."""
    H = links.shape[-1]
    active = (torch.arange(H, device=links.device) < nhops[..., None]) \
        & valid[..., None] & (links >= 0)
    lp = torch.where(active, links, n_links)
    dp = torch.where(active, 2 * links + dirs, 2 * n_links)
    return active, lp, dp


def _slot_compute(g, t_inj, t_ser, policy: Policy, pm: PowerModel,
                  params=None):
    """FSM + energy arithmetic of one message over its active slots, as an
    elementwise function of the gathered row state ``g`` (``(h,)`` views:
    ``free``, ``last``, ``dl``, ``dl2`` and, for the coalescing kinds, the
    ``coal`` triple).  ``t_inj``/``t_ser`` are 0-d tensors."""
    p = pb._params(policy, params)
    t_w = p["t_w"] + p["sync_overhead"]
    t_s = p["t_s"]
    # FSM row 2 (Deep Sleep): reachable only past ``deadline2``, which
    # single-state kinds pin to +inf — every row-2 branch then selects the
    # row-1 value.
    t_w2 = p["t_w2"] + p["sync_overhead"]
    t_s2 = p["t_s2"]
    coal = policy.kind == "coalesce"
    pre = policy.kind == "precoalesce"
    defer_on = coal or pre

    free, last, dl, dl2 = g["free"], g["last"], g["dl"], g["dl2"]
    H = free.shape[0]
    dl_ts = dl + t_s
    dl2_ts2 = dl2 + t_s2
    if defer_on:
        # wake deferral for the frame that would wake a sleeping port (see
        # the reference): full delay, scaled down when the previous
        # cycle's burst overran the queue bound.  precoalesce defers at
        # the injection hop only.
        d_delay = p["max_delay"] if coal else p["hold_delay"]
        d_frames = p["max_frames"] if coal else p["hold_frames"]
        coal_n_g, coal_prev_g, coal_release_g = g["coal"]
        prev_burst = torch.where(coal_n_g > 0, coal_n_g, coal_prev_g)
        if d_frames > 1.0:
            defer_full = div(d_delay * d_frames,
                             torch.clamp_min(prev_burst, d_frames))
        else:
            defer_full = torch.zeros_like(prev_burst)
        at_src = torch.arange(H, device=free.device) == 0 if pre \
            else torch.ones(H, dtype=torch.bool, device=free.device)
        defer_amt = torch.where(at_src, defer_full, 0.0)

    # ---- hop chain on 0-d tensors -----------------------------------------
    # The reference's in_down masks are folded into the penalty selects:
    # pen_fast is only read when asleep and pen_deep only when deep, where
    # the masks reduce to the comparisons below.
    t_head = t_inj
    t_avail, t_start, t_arr = [], [], []
    for h in range(H):
        ta = torch.maximum(t_head, free[h])
        asleep = ta >= dl[h]
        tae = ta + torch.where(asleep, defer_amt[h], 0.0) if defer_on \
            else ta
        deep = tae >= dl2[h]
        pen_fast = torch.where(tae < dl_ts[h], dl_ts[h] - tae, 0.0) + t_w
        pen_deep = torch.where(tae < dl2_ts2[h], dl2_ts2[h] - tae, 0.0) \
            + t_w2
        pen = torch.where(asleep, torch.where(deep, pen_deep, pen_fast), 0.0)
        ts_ = tae + pen
        t_avail.append(ta)
        t_start.append(ts_)
        if defer_on:
            # pre-occupancy arrival: the coalescing-cycle join test uses
            # the moment the frame reaches the port's queue
            t_arr.append(t_head)
        t_head = ts_ + pm.switch_latency
    t_avail = torch.stack(t_avail)
    t_start = torch.stack(t_start)
    t_end = t_start + t_ser

    asleep = t_avail >= dl
    tae = t_avail + torch.where(asleep, defer_amt, 0.0) if defer_on \
        else t_avail
    deep = tae >= dl2
    in_down = asleep & (tae < dl_ts)
    in_down2 = deep & (tae < dl2_ts2)
    gap = t_avail - last
    new_last = torch.maximum(last, t_end)

    # ---- energy time integration (frontier scheme, as in the reference) --
    base = (dl - last) + t_s
    wake_fast = base + t_w + t_ser
    wake_deep = base + t_s2 + t_w2 + t_ser
    wake_add = torch.where(asleep, torch.where(deep, wake_deep, wake_fast),
                           torch.clamp_min(new_last - last, 0.0))
    sleep_add = torch.where(asleep & ~in_down,
                            torch.where(deep, dl2 - dl_ts,
                                        torch.clamp_min(tae - dl_ts, 0.0)),
                            0.0)
    sleep2_add = torch.where(deep & ~in_down2,
                             torch.clamp_min(tae - dl2_ts2, 0.0), 0.0)

    out = dict(asleep=asleep, deep=deep, gap=gap, t_avail=t_avail,
               t_start=t_start, t_end=t_end, new_last=new_last,
               wake_add=wake_add, sleep_add=sleep_add, sleep2_add=sleep2_add,
               delivery=t_end[-1])
    if defer_on:
        # precoalesce: the cycle state advances only at the injection hop;
        # downstream rows write their gathered values back unchanged
        t_arr = torch.stack(t_arr)
        miss = asleep & at_src
        join = at_src & ~asleep & (coal_n_g > 0) & (t_arr <= coal_release_g)
        roll = torch.where(coal_n_g > 0, coal_n_g, coal_prev_g)
        out["coal_new"] = (
            torch.where(miss, 1.0,
                        torch.where(join, coal_n_g + 1.0, coal_n_g)),
            torch.where(miss, roll, coal_prev_g),
            torch.where(miss, t_start, coal_release_g),
        )
    return out


def _message_step(net, lp, dp, t_inj, t_ser, policy: Policy, pm: PowerModel,
                  params=None):
    """Advance ``net`` in place by one message whose active slots have link
    rows ``lp`` and directed rows ``dp`` (``(h,)`` int64, h >= 1).

    Returns ``(delivery, t_start, t_end)``.  Every accumulating row keeps
    the reference's scatter-add form ``old + delta``; in particular the
    deadline update ``dl + (new_dl - dl)`` turns the always-on baseline's
    ``inf`` deadlines into NaN, as the reference does (every comparison
    with NaN is False in both, so results agree)."""
    p = pb._params(policy, params)
    t_s = p["t_s"]
    defer_on = policy.kind in ("coalesce", "precoalesce")
    rows = net["_rows"]
    gathered = rows.index_select(1, lp)
    last, dl, dl2, tw, ts, ts2, tpdt_now = gathered[:len(_BASE_ROWS)]
    free = net["dir_free"].index_select(0, dp)
    g = {"free": free, "last": last, "dl": dl, "dl2": dl2}
    if defer_on:
        g["coal"] = tuple(gathered[len(_BASE_ROWS):])

    ns = _slot_compute(g, t_inj, t_ser, policy, pm, params)
    asleep, deep, t_end = ns["asleep"], ns["deep"], ns["t_end"]
    new_last = ns["new_last"]

    # deadline = end of PDT countdown after the latest transmission;
    # deadline2 = the demotion point a (clamped) t_dst further out, a
    # masked SET in the reference
    new_dl = new_last + tpdt_now
    new_dl2 = new_dl + max(p["t_dst"], t_s)
    new_rows = [last + (new_last - last), dl + (new_dl - dl), new_dl2,
                tw + ns["wake_add"], ts + ns["sleep_add"],
                ts2 + ns["sleep2_add"], tpdt_now]
    if defer_on:
        new_rows += list(ns["coal_new"])
    rows.index_copy_(1, lp, torch.stack(new_rows))
    net["_counts"].index_add_(
        1, lp, torch.stack((asleep, asleep, ~asleep, deep)).to(_I64))
    net["dir_free"].index_copy_(0, dp, free + torch.clamp_min(t_end - free,
                                                               0.0))
    return ns["delivery"], ns["t_start"], t_end


def sim_chunk(net, msgs, policy, pm, n_links, collect_events=False,
              params=None):
    """Replay one padded message table in order.

    msgs: tuple of device tensors ``(links (M,H), dirs, nhops, t_inj,
    bytes, valid)``.  Returns ``(net, (delivery, lat))`` and, with
    ``collect_events``, ``(net, (delivery, lat, (lp, t_start, t_end,
    active)))`` with ``(M, H)`` event tensors (inactive slots hold 0).

    The per-message hop counts are read to the host once, before the loop;
    the loop itself runs device ops only and never synchronises."""
    links, dirs, nhops, t_inj, nbytes, valid = msgs
    M, H = links.shape
    active, lp, dp = _slot_rows(links, dirs, nhops, valid, n_links)
    n_act = active.sum(1)
    prefix = torch.arange(H, device=links.device) < n_act[:, None]
    if not bool(torch.equal(active, prefix)):
        raise ValueError("a route's active slots must form a prefix")
    n_act = n_act.tolist()
    params = pb._params(policy, params)
    t_ser = div(nbytes, pm.link_bandwidth)
    delivery = t_inj.clone()
    if collect_events:
        ev_start = torch.zeros((M, H), dtype=_F64, device=links.device)
        ev_end = torch.zeros((M, H), dtype=_F64, device=links.device)
    for i, h in enumerate(n_act):
        if h == 0:  # padding, src == dst: the reference touches the dummy only
            continue
        d, ts_, te_ = _message_step(net, lp[i, :h], dp[i, :h], t_inj[i],
                                    t_ser[i], policy, pm, params)
        delivery[i] = d
        if collect_events:
            ev_start[i, :h] = ts_
            ev_end[i, :h] = te_
    lat = torch.where(valid & (nhops > 0), delivery - t_inj, 0.0)
    if collect_events:
        return net, (delivery, lat, (lp, ev_start, ev_end, active))
    return net, (delivery, lat)


# ---------------------------------------------------------------------------
# Close-out + energy summary
# ---------------------------------------------------------------------------


def close_out(net, t_end_sim, policy: Policy, n_links: int):
    """Integrate every link's tail (last transmission .. end of sim) at the
    FSM row it ends in: awake, row-1 sleep past ``deadline``, row-2 sleep
    past ``deadline2`` (never reached by single-state kinds).  Returns
    (time_wake, time_sleep, time_sleep2)."""
    st, st2 = policy.state, policy.deep
    last = net["last_end"][:n_links]
    dl = net["deadline"][:n_links]
    dl2 = net["deadline2"][:n_links]
    t_end_sim = torch.maximum(
        torch.full((), t_end_sim, dtype=_F64, device=last.device),
        last.max())
    sleeps = dl + st.t_s < t_end_sim
    deeps = dl2 + st2.t_s < t_end_sim
    # elapsed part of the second down transition (wake power, like every
    # transition): full t_s2 once demoted, partial if the sim ends
    # mid-transition, 0 for single-state rows (dl2 = +inf)
    down2 = torch.clamp(t_end_sim - dl2, 0.0, st2.t_s)
    wake_extra = torch.where(
        sleeps, (dl - last) + st.t_s + down2, t_end_sim - last)
    sleep_extra = torch.where(
        sleeps, torch.where(deeps, dl2 - (dl + st.t_s),
                            torch.minimum(t_end_sim, dl2) - dl - st.t_s),
        0.0)
    sleep2_extra = torch.where(deeps, t_end_sim - dl2 - st2.t_s, 0.0)
    return (net["time_wake"][:n_links] + torch.clamp_min(wake_extra, 0.0),
            net["time_sleep"][:n_links] + torch.clamp_min(sleep_extra, 0.0),
            net["time_sleep2"][:n_links]
            + torch.clamp_min(sleep2_extra, 0.0))


@dataclass
class SimResult:
    makespan: float
    mean_latency: float
    max_latency: float
    n_messages: int
    link_energy: float
    switch_energy: float
    node_energy: float
    total_energy: float
    asleep_frac: float          # mean fraction of time links spent asleep
    deep_frac: float            # fraction of link time in the deep FSM row
    n_wake_transitions: int
    hits: int
    misses: int
    deep_misses: int            # arrivals that found their port demoted

    def as_dict(self):
        return dataclasses.asdict(self)


def summarize(net, t_end, busy_node_secs, lat_sum, lat_max, n_msgs,
              policy: Policy, pm: PowerModel, topo) -> SimResult:
    tw, ts_, ts2 = close_out(net, t_end, policy, topo.n_links)
    frac = policy.state.power_frac
    frac2 = policy.deep.power_frac
    link_e = float(2 * pm.port_power
                   * (tw.sum() + frac * ts_.sum() + frac2 * ts2.sum()))
    switch_e = float(pm.switch_power * topo.n_switches * t_end)
    node_e = float(pm.node_power_min * topo.n_nodes * t_end
                   + (pm.node_power_max - pm.node_power_min) * busy_node_secs)
    total_t = tw.sum() + ts_.sum() + ts2.sum()
    denom = torch.clamp_min(total_t, 1e-30)
    counts = net["_counts"][:, :topo.n_links].sum(1).tolist()
    n = dict(zip(_COUNT_KEYS, counts))
    return SimResult(
        makespan=float(t_end),
        mean_latency=float(lat_sum / max(n_msgs, 1)),
        max_latency=float(lat_max),
        n_messages=int(n_msgs),
        link_energy=link_e,
        switch_energy=switch_e,
        node_energy=node_e,
        total_energy=link_e + switch_e + node_e,
        asleep_frac=float(torch.div(ts_.sum() + ts2.sum(), denom)),
        deep_frac=float(torch.div(ts2.sum(), denom)),
        n_wake_transitions=int(n["n_wake"]),
        hits=int(n["n_hit"]),
        misses=int(n["n_miss"]),
        deep_misses=int(n["n_deep"]),
    )


# ---------------------------------------------------------------------------
# Phase-structured trace replay (execution-time semantics)
# ---------------------------------------------------------------------------


def _pad_msgs(links, dirs, nhops, t_inj, nbytes, bucket_min=64, device=None):
    """Serial front-end of the shared padder: host arrays in, device
    ``(links, dirs, nhops, t_inj, nbytes, valid)`` tuple out (int64 ids)."""
    dev = resolve_device(device)
    out = pad_message_table(links, dirs, nhops, t_inj, nbytes,
                            bucket_min=bucket_min)
    return tuple(torch.as_tensor(a.astype(np.int64) if a.dtype.kind == "i"
                                 else a, device=dev) for a in out)


def simulate_trace_reference(trace, topo, policy: Policy,
                             pm: PowerModel | None = None,
                             collect_events=False, device=None):
    """Replay a Trace (see repro_torch.traffic.trace) under a policy.

    One ``sim_chunk`` per trace step with host-side stable injection
    sorting, route lookup and ``ready``-clock bookkeeping, and one readback
    of the step's deliveries.  Returns (SimResult, events) — events is a
    list of per-step host arrays (link, t_start, t_end) when
    ``collect_events``, else None.
    """
    _check_kind(policy)
    dev = resolve_device(device)
    pm = pm or PowerModel()
    net = init_net(topo.n_links, policy, device=dev)
    ready = np.zeros(topo.n_nodes, np.float64)
    busy = 0.0
    lat_sum, lat_max, n_msgs = 0.0, 0.0, 0
    all_events = [] if collect_events else None

    for step in trace.steps:
        if step.compute_nodes is not None and len(step.compute_nodes):
            ready[step.compute_nodes] += step.compute_secs
            busy += float(step.compute_secs.sum())
        if step.msgs is not None and len(step.msgs):
            src = step.msgs[:, 0]
            dst = step.msgs[:, 1]
            nbytes = step.msgs[:, 2].astype(np.float64)
            t_inj = ready[src]
            order = np.argsort(t_inj, kind="stable")
            src, dst, nbytes, t_inj = (src[order], dst[order],
                                       nbytes[order], t_inj[order])
            links, dirs, nhops = topo.routes(src, dst)
            msgs = _pad_msgs(links, dirs, nhops, t_inj, nbytes, device=dev)
            net, out = sim_chunk(net, msgs, policy, pm, topo.n_links,
                                 collect_events)
            n = len(src)
            delivery, lat = torch.stack(out[:2])[:, :n].cpu().numpy()
            np.maximum.at(ready, dst, delivery)
            lat_sum += float(lat.sum())
            lat_max = max(lat_max, float(lat.max(initial=0.0)))
            n_msgs += n
            if collect_events:
                lp, ts_, te_, act = (x[:n].cpu().numpy() for x in out[2])
                all_events.append((lp[act].astype(np.int32), ts_[act],
                                   te_[act]))
        if step.barrier:
            nodes = trace.nodes
            ready[nodes] = ready[nodes].max()

    t_end = float(ready[trace.nodes].max()) if len(trace.nodes) else 0.0
    res = summarize(net, t_end, busy, lat_sum, lat_max, n_msgs,
                    policy, pm, topo)
    return res, all_events


def unused_key(mapping: dict, base: str = "__baseline__") -> str:
    """A key not present in ``mapping`` (prefixing underscores as needed) —
    lets a hidden baseline lane ride in a user-named policy grid."""
    while base in mapping:
        base = "_" + base
    return base


def relative_rows(base: SimResult, results: dict,
                  baseline: str = "baseline") -> dict:
    """The §4 table protocol: each result as a dict row with overhead /
    saving percentages vs ``base`` (which leads the rows, reporting
    zeros).  Degenerate baselines (empty traces) report 0 instead of
    dividing by zero."""
    out = {baseline: dict(base.as_dict(), exec_overhead_pct=0.0,
                          latency_overhead_pct=0.0, energy_saved_pct=0.0,
                          link_energy_saved_pct=0.0)}
    for name, r in results.items():
        out[name] = dict(
            r.as_dict(),
            exec_overhead_pct=100 * (r.makespan / base.makespan - 1)
            if base.makespan else 0.0,
            latency_overhead_pct=100 * (r.mean_latency / base.mean_latency - 1)
            if base.mean_latency else 0.0,
            energy_saved_pct=100 * (1 - r.total_energy / base.total_energy)
            if base.total_energy else 0.0,
            link_energy_saved_pct=100 * (1 - r.link_energy / base.link_energy)
            if base.link_energy else 0.0,
        )
    return out
