#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases (each prints its own lines; any failure exits non-zero):
  1. device   the card's name and power limit (nvidia-smi)
  2. build    the three CUDA kernels from src/repro_torch/kernels/csrc
  3. kernels  each kernel against its plain PyTorch version on the card at
              the main path's shapes (E=2048, P=10,400, B=200), with times
  4. main     the paper's Megafly (4,160 nodes) and AlexNet on 64 nodes:
              coupled baseline replay -> event streams -> decoupled sweeps
              and the PerfBound snapshot on the kernels, plus one coupled
              fixed-PDT replay for the decoupled energy error; the kernels'
              launch counts over this phase must all be > 0
  5. check    the same path on a small input, on the card against the
              host's plain versions
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM float32 rate outside the tensor cores
TPDT_GRID = [0.0, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0]
E_K, P_K, B_K = 2048, 10_400, 200   # kernel-phase shapes (main path: E<=1,926)
ALEXNET_ITERS = 10                  # the paper's AlexNet depth, uncut


class SmokeFailure(Exception):
    pass


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps, warmup=2):
    """Median device time of ``fn()`` over ``reps`` calls, each between
    its own pair of CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def close(a, b, rtol, atol):
    import torch
    return bool(torch.all((a - b).abs() <= atol + rtol * b.abs()))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    log(line)
    return line


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.nvcc_path()}, flags {' '.join(_build.NVCC_FLAGS)})")
    for name, (secs, text) in built.items():
        usage = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"build: {name} {secs:.1f} s; " + " | ".join(usage))


def phase_kernels(rng):
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.hist_update import hist_update_cuda
    from repro_torch.kernels.port_energy import port_energy_cuda
    from repro_torch.kernels.tpdt_select import tpdt_select_cuda

    dev = torch.device("cuda")
    E, P, B = E_K, P_K, B_K
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    rows = {}

    # ---- port_energy: single-state, dual ladder, hold-at-source ----------
    gaps = f32(rng.uniform(0, 2e-3, (E, P)))
    durs_np = rng.uniform(0, 1e-4, (E, P))
    durs_np[rng.random((E, P)) < 0.2] = 0.0
    durs = f32(durs_np)
    tpdt = f32(rng.uniform(0, 1e-3, P))
    tail = f32(rng.uniform(0, 1.0, P))
    hold = f32(rng.uniform(0, 5e-4, P))
    ds = dict(t_w=4.48e-6, t_s=2e-6)
    ladder = dict(t_w=375e-9, t_s=200e-9, t_w2=4.48e-6, t_s2=2e-6)
    variants = {"single": dict(ds), "dual": dict(ladder, t_dst=2e-4),
                "hold": dict(ladder, t_dst=2e-4, hold=hold)}
    err = 0.0
    for name, kw in variants.items():
        got = port_energy_cuda(gaps, durs, tpdt, tail, **kw)
        want = ref.port_energy_ref(gaps, durs, tpdt, tail, **kw)
        torch.cuda.synchronize()
        for k in got:
            e = max_err(got[k], want[k])
            err = max(err, e)
            require(close(got[k], want[k], 1e-5, 1e-8),
                    f"port_energy[{name}].{k} disagrees: max |err| {e:.3g}")
        log(f"kernels: port_energy[{name}] == plain (rtol 1e-5, atol 1e-8)")
    ms = cuda_ms(lambda: port_energy_cuda(gaps, durs, tpdt, tail, **ds), 20)
    plain_ms = cuda_ms(lambda: ref.port_energy_ref(gaps, durs, tpdt, tail,
                                                   **ds), 3, warmup=1)
    nbytes = (2 * E * P + 4 * P + 7 * P) * 4
    rows["port_energy"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        bound=bound(nbytes, 30 * E * P),
        source="src/repro_torch/kernels/csrc/port_energy.cu",
        replaces="src/repro/kernels/port_energy.py:114")

    # ---- hist_update: linear bins exact, log bins up to edge samples -----
    g_np = rng.uniform(-1e-5, 5e-3, (E, P)).astype(np.float32)
    g = f32(g_np)
    lin = dict(n_bins=B, bin_width=10e-6)
    gc, gs = hist_update_cuda(g, **lin)
    wc, ws = ref.hist_update_ref(g, **lin)
    torch.cuda.synchronize()
    require(torch.equal(gc, wc), "hist_update (linear) counts disagree")
    require(close(gs, ws, 1e-5, 1e-9), "hist_update (linear) sums disagree")
    err = max(max_err(gc, wc), max_err(gs, ws))
    log("kernels: hist_update[linear] counts == plain, sums rtol 1e-5")
    logkw = dict(n_bins=B, bin_width=10e-6, log_bins=True, log_min=1e-7,
                 log_max=10.0)
    gc, gs = hist_update_cuda(g, **logkw)
    wc, ws = ref.hist_update_ref(g, **logkw)
    torch.cuda.synchronize()
    # both bin in float32 against float32 edges; samples within 4 ulps of a
    # bin edge may still land in either neighbour bin if the two logs differ
    near = ref.log_bin_near_edge(g, n_bins=B, log_min=1e-7, log_max=10.0)
    n_near = int(near.sum())
    moved = int((gc - wc).abs().sum())
    log(f"kernels: hist_update[log] samples within 4 ulp of a bin edge: "
        f"{n_near}; count mass in other bins: {moved}")
    require(torch.equal(gc.sum(1), wc.sum(1)), "log-bin count totals differ")
    require(moved <= 2 * n_near,
            f"hist_update (log) counts disagree beyond the {n_near} "
            f"near-edge samples: {moved}")
    # every other sample: counts exact and sums per bin, on both sides
    g_far = torch.where(near, 0.0, g)
    gc, gs = hist_update_cuda(g_far, **logkw)
    wc, ws = ref.hist_update_ref(g_far, **logkw)
    torch.cuda.synchronize()
    require(torch.equal(gc, wc), "hist_update (log) counts disagree away "
            "from bin edges")
    require(close(gs, ws, 1e-5, 1e-9), "hist_update (log) sums disagree")
    err = max(err, max_err(gc, wc), max_err(gs, ws))
    log("kernels: hist_update[log] away from edges: counts == plain, sums "
        "rtol 1e-5")
    ms = cuda_ms(lambda: hist_update_cuda(g, **lin), 20)
    plain_ms = cuda_ms(lambda: ref.hist_update_ref(g, **lin), 5)
    valid = g > 0
    flat = (torch.arange(P, device=dev) * B
            + torch.clamp(g / 10e-6, 0, B - 1).long())[valid]
    wts = g[valid]

    def library():
        torch.bincount(flat, minlength=P * B)
        torch.bincount(flat, weights=wts, minlength=P * B)

    library_ms = cuda_ms(library, 20)
    rows["hist_update"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound=bound(E * P * 4 + 2 * P * B * 4, 4 * E * P),
        source="src/repro_torch/kernels/csrc/hist_update.cu",
        replaces="src/repro/kernels/hist_update.py:60")

    # ---- tpdt_select -------------------------------------------------------
    counts = rng.integers(0, 20, (P, B)).astype(np.float32)
    centers_np = (np.arange(B) + 0.5) * 1e-5
    sums = counts * centers_np[None, :] * rng.uniform(0.9, 1.1, (P, B))
    N = rng.uniform(0, counts.sum(1) + 5)
    counts, sums, N = f32(counts), f32(sums), f32(N)
    total, centers = counts.sum(1), f32(centers_np)
    kw = dict(max_tpdt=10e-3, tpdt_init=1e-3)
    got = tpdt_select_cuda(counts, sums, N, total, centers, **kw)
    want = ref.tpdt_select_ref(counts, sums, N, total, centers, **kw)
    torch.cuda.synchronize()
    require(close(got, want, 1e-6, 0.0), "tpdt_select disagrees")
    log("kernels: tpdt_select == plain (rtol 1e-6)")
    ms = cuda_ms(lambda: tpdt_select_cuda(counts, sums, N, total, centers,
                                          **kw), 20)
    plain_ms = cuda_ms(lambda: ref.tpdt_select_ref(counts, sums, N, total,
                                                   centers, **kw), 20)
    rows["tpdt_select"] = dict(
        max_abs_err=max_err(got, want), ms=ms, plain_ms=plain_ms,
        library_ms=None,
        # all of counts; of sums only the chosen bin, one 32-byte sector
        # per port; N, total, centers and the output
        bound=bound(P * B * 4 + P * 32 + (3 * P + B) * 4, 2 * P * B),
        source="src/repro_torch/kernels/csrc/tpdt_select.cu",
        replaces="src/repro/kernels/tpdt_select.py:68")
    for name, r in rows.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"kernels: {name} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}) "
            f"library_ms={lib}")
    ops.reset_launch_counts()
    return rows


def _hop_mean(trace, topo):
    import numpy as np
    msgs = [s.msgs for s in trace.steps if s.msgs is not None and len(s.msgs)]
    allm = np.concatenate(msgs)
    nh = topo.routes(allm[:, 0], allm[:, 1])[2]
    return float(nh.mean())


def replay_busy_share(trace, topo, pm, n_steps=24):
    """Device-busy share of the coupled replay over its first ``n_steps``
    trace steps, under torch.profiler: summed kernel time over wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import simulator as S
    from repro_torch.core.eee import Policy
    from repro_torch.traffic.trace import Trace

    window = Trace(nodes=trace.nodes, steps=trace.steps[:n_steps])
    pol = Policy(kind="none")
    S.simulate_trace_reference(window, topo, pol, pm)    # warm
    torch.cuda.synchronize()
    n_msgs = window.n_messages
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        S.simulate_trace_reference(window, topo, pol, pm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(e, "device_time_total", 0) for e in kernels)
    if busy_us <= 0:
        log(f"profile: coupled replay window ({n_msgs} messages): no device "
            "time in the profile; busy share not measured")
        return None
    log(f"profile: coupled replay window ({n_msgs} messages, under the "
        f"profiler): wall {wall:.3f} s, {len(kernels)} kernels "
        f"({len(kernels) / n_msgs:.1f} per message), device busy "
        f"{busy_us / 1e6:.3f} s = {100 * busy_us / 1e6 / wall:.1f}% of wall, "
        f"mean kernel {busy_us / max(len(kernels), 1):.2f} us")
    return busy_us / 1e6 / wall


def phase_main(iters):
    import torch
    from repro_torch.core import decoupled as D
    from repro_torch.core import simulator as S
    from repro_torch.core.eee import Policy, PowerModel
    from repro_torch.kernels import ops
    from repro_torch.topology.megafly import paper_topology
    from repro_torch.traffic.generators import alexnet

    pm = PowerModel()
    topo = paper_topology()
    trace = alexnet(topo, n_nodes=64, iters=iters)
    log(f"main: Megafly {topo.n_nodes} nodes / {topo.n_links} links, "
        f"AlexNet 64 nodes x {iters} iterations: {trace.n_messages} "
        f"messages in {sum(s.msgs is not None for s in trace.steps)} "
        f"message steps")
    stages = {}
    ops.reset_launch_counts()

    t0 = time.perf_counter()
    res0, events = S.simulate_trace_reference(
        trace, topo, Policy(kind="none"), pm, collect_events=True)
    torch.cuda.synchronize()
    stages["coupled_baseline_s"] = time.perf_counter() - t0
    n_ev = sum(len(e[0]) for e in events)
    log(f"main: coupled baseline replay {stages['coupled_baseline_s']:.2f} s "
        f"({trace.n_messages / stages['coupled_baseline_s']:.0f} msg/s); "
        f"makespan {res0.makespan:.6f} s, {n_ev} link traversals, link "
        f"energy {res0.link_energy:.6g} J")

    t0 = time.perf_counter()
    gaps, durs, tail = D.events_to_streams(events, topo.n_links,
                                           res0.makespan)
    torch.cuda.synchronize()
    stages["events_to_streams_s"] = time.perf_counter() - t0
    E = gaps.shape[0]
    log(f"main: events_to_streams {stages['events_to_streams_s']:.2f} s; "
        f"streams ({E}, {gaps.shape[1]}) f32")

    t0 = time.perf_counter()
    sweeps = {st: D.sweep_policies(events, topo.n_links, res0.makespan,
                                   TPDT_GRID, Policy(kind="fixed",
                                                     sleep_state=st), pm)
              for st in ("deep_sleep", "fast_wake")}
    dual_pol = Policy(kind="dual", t_pdt=1e-5, t_dst=1e-4,
                      sleep_state="fast_wake", deep_state="deep_sleep")
    dual = D.evaluate_fixed(gaps, durs, tail, dual_pol.t_pdt, dual_pol, pm)
    torch.cuda.synchronize()
    stages["decoupled_sweeps_s"] = time.perf_counter() - t0
    log(f"main: sweep_policies x2 + one dual evaluation "
        f"({2 * len(TPDT_GRID) + 1} policies, each sweep rebuilding the "
        f"streams on the host) {stages['decoupled_sweeps_s']:.2f} s")

    t0 = time.perf_counter()
    hop_mean = _hop_mean(trace, topo)
    pb_pol = Policy(kind="perfbound", bound=0.01, sleep_state="deep_sleep")
    tpdt = D.perfbound_snapshot_tpdt(gaps, res0.makespan, hop_mean, pb_pol)
    torch.cuda.synchronize()
    stages["perfbound_snapshot_s"] = time.perf_counter() - t0
    pb_eval = D.evaluate_fixed(gaps, durs, tail, tpdt, pb_pol, pm)
    log(f"main: perfbound snapshot {stages['perfbound_snapshot_s']:.2f} s "
        f"(hop_mean {hop_mean:.3f}); t_PDT median "
        f"{float(tpdt.median()):.3g} s, link energy "
        f"{pb_eval['link_energy']:.6g} J")

    t0 = time.perf_counter()
    fx_pol = Policy(kind="fixed", t_pdt=1e-5, sleep_state="deep_sleep")
    coupled, _ = S.simulate_trace_reference(trace, topo, fx_pol, pm)
    torch.cuda.synchronize()
    stages["coupled_fixed_s"] = time.perf_counter() - t0
    dec = sweeps["deep_sleep"][1e-5]
    energy_err = abs(dec["link_energy"] - coupled.link_energy) \
        / coupled.link_energy
    wake_err = abs(float(dec["n_wake"].sum()) - coupled.n_wake_transitions)
    log(f"main: coupled fixed replay {stages['coupled_fixed_s']:.2f} s; "
        f"decoupled t=1e-05 energy_err={100 * energy_err:.2f}% "
        f"wake_err={wake_err:.0f} (coupled {coupled.link_energy:.6g} J, "
        f"decoupled {dec['link_energy']:.6g} J)")
    launches = ops.launch_counts()
    log("kernels: " + json.dumps(launches))
    for name, n in launches.items():
        require(n > 0, f"the main path launched {name} no time")
    # evaluation alone, over the streams already built (after the counts)
    ds_pol = Policy(kind="fixed", sleep_state="deep_sleep")
    t0 = time.perf_counter()
    for t in TPDT_GRID:
        D.evaluate_fixed(gaps, durs, tail, t, ds_pol, pm)
    stages["decoupled_eval_per_policy_s"] = \
        (time.perf_counter() - t0) / len(TPDT_GRID)
    log(f"main: decoupled evaluation over built streams "
        f"{1e3 * stages['decoupled_eval_per_policy_s']:.3f} ms per policy "
        f"({len(TPDT_GRID)} policies)")
    stages["replay_busy_share"] = replay_busy_share(trace, topo, pm)

    # ---- outputs are well formed -----------------------------------------
    n_busy = float((durs > 0).sum())
    require(res0.n_messages == trace.n_messages, "baseline lost messages")
    require(res0.misses == 0 and res0.hits == n_ev,
            "always-on baseline must hit on every traversal")
    for r in (res0, coupled):
        require(all(math.isfinite(v) for v in r.as_dict().values()),
                "non-finite SimResult")
    require(all(torch.isfinite(t).all() for t in (gaps, durs, tail)),
            "non-finite streams")
    require(bool((durs >= 0).all()) and bool((tail >= 0).all()),
            "negative stream entries")
    rows = [("always-on (coupled)", res0.link_energy)]
    for st, sw in sweeps.items():
        for t, out in sw.items():
            require(math.isfinite(out["link_energy"]), "non-finite energy")
            require(float((out["hits"] + out["misses"]).sum()) == n_busy,
                    "hits + misses != busy intervals")
            rows.append((f"fixed {st} t={t:g}", out["link_energy"]))
    rows.append(("dual fw->ds t=1e-05 t_dst=1e-04", dual["link_energy"]))
    rows.append(("perfbound snapshot", pb_eval["link_energy"]))
    for name, e in rows:
        log(f"main: {name:34s} link energy {e:.6g} J "
            f"({100 * (1 - e / res0.link_energy):+.2f}% saved)")
    require(energy_err < 0.10, "decoupled energy far from the coupled replay")
    return launches, stages


def phase_check():
    """Small input, on the card against the host's plain versions."""
    import numpy as np
    import torch
    from repro_torch.core import decoupled as D
    from repro_torch.core import simulator as S
    from repro_torch.core.eee import Policy, PowerModel
    from repro_torch.topology.megafly import small_topology
    from repro_torch.traffic.generators import small_apps

    pm = PowerModel()
    topo = small_topology()
    trace = small_apps(topo, n_nodes=8)["alexnet"]
    base = Policy(kind="none")
    for pol in (base, Policy(kind="coalesce", t_pdt=2e-5, t_dst=2e-4,
                             max_delay=5e-5, max_frames=4,
                             sleep_state="fast_wake")):
        a, ea = S.simulate_trace_reference(trace, topo, pol, pm, True, "cuda")
        b, eb = S.simulate_trace_reference(trace, topo, pol, pm, True, "cpu")
        for k, v in b.as_dict().items():
            require(math.isclose(a.as_dict()[k], v, rel_tol=1e-9,
                                 abs_tol=1e-12),
                    f"{pol.kind}: cuda {k}={a.as_dict()[k]} != cpu {v}")
        for x, y in zip(ea, eb):
            require(np.array_equal(x[0], y[0])
                    and np.allclose(x[1], y[1], rtol=1e-9, atol=1e-12)
                    and np.allclose(x[2], y[2], rtol=1e-9, atol=1e-12),
                    f"{pol.kind}: event lists differ")
    sw_cuda = D.sweep_policies(eb, topo.n_links, b.makespan, TPDT_GRID,
                               Policy(kind="fixed"), pm, device="cuda")
    sw_cpu = D.sweep_policies(eb, topo.n_links, b.makespan, TPDT_GRID,
                              Policy(kind="fixed"), pm, device="cpu")
    for t in TPDT_GRID:
        for k in ("link_energy", "wake_time", "sleep_time"):
            require(math.isclose(sw_cuda[t][k], sw_cpu[t][k], rel_tol=1e-5,
                                 abs_tol=1e-9),
                    f"sweep t={t} {k}: cuda {sw_cuda[t][k]} cpu "
                    f"{sw_cpu[t][k]}")
    pol = Policy(kind="perfbound", bound=0.01)
    g = D.events_to_streams(eb, topo.n_links, b.makespan, device="cpu")[0]
    t_cuda = D.perfbound_snapshot_tpdt(g, b.makespan, 3.0, pol).cpu()
    t_cpu = D.perfbound_snapshot_tpdt(g, b.makespan, 3.0, pol, device="cpu")
    require(torch.allclose(t_cuda, t_cpu, rtol=1e-6, atol=0),
            "perfbound snapshot: cuda != cpu")
    log("check: small input (80-node Megafly, AlexNet 8 nodes) on the card "
        "== host plain versions (SimResult rtol 1e-9, decoupled rtol 1e-5)")


def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: the repro_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        smi = phase_device()
        log(f"device: {torch.cuda.get_device_name(0)} "
            f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
        phase_build()
        rows = phase_kernels(np.random.default_rng(0))
        launches, stages = phase_main(ALEXNET_ITERS)
        phase_check()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    kernels = [dict(name=name, route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                    bound_by=r["bound"][1], library_ms=r["library_ms"])
               for name, r in rows.items()]
    busy = stages["replay_busy_share"]
    busy = "not measured" if busy is None else f"{100 * busy:.1f}%"
    log(f"total: {time.perf_counter() - t_start:.1f} s; coupled replay "
        f"device-busy share {busy}; {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
