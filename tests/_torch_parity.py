"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``):
the reference policy set and the carriers that hand the JAX package's
objects to the port as plain data."""
import dataclasses

import numpy as np

from repro.core.eee import Policy

from repro_torch import convert

POLICIES = {
    "none": Policy(kind="none"),
    "fixed": Policy(kind="fixed", t_pdt=5e-5, sleep_state="deep_sleep"),
    "fixed_fw": Policy(kind="fixed", t_pdt=1e-5, sleep_state="fast_wake"),
    "perfbound": Policy(kind="perfbound", bound=0.02,
                        sleep_state="fast_wake"),
    "perfbound_correct": Policy(kind="perfbound_correct", bound=0.01,
                                hist_mode="circular", ring_n=32),
    "dual": Policy(kind="dual", t_pdt=2e-5, t_dst=2e-4,
                   sleep_state="fast_wake", deep_state="deep_sleep"),
    "coalesce": Policy(kind="coalesce", t_pdt=2e-5, t_dst=2e-4,
                       max_delay=5e-5, max_frames=4,
                       sleep_state="fast_wake", deep_state="deep_sleep"),
    "perfbound_dual": Policy(kind="perfbound_dual", bound=0.02,
                             sleep_state="fast_wake",
                             deep_state="deep_sleep"),
    "precoalesce": Policy(kind="precoalesce", t_pdt=2e-5, t_dst=2e-4,
                          hold_delay=5e-5, hold_frames=4,
                          sleep_state="fast_wake", deep_state="deep_sleep"),
    "predict": Policy(kind="predict", t_pdt=2e-5, t_dst=2e-4,
                      forecast_weight=0.5, forecast_margin=2.0,
                      sleep_state="fast_wake", deep_state="deep_sleep"),
}
# the kinds the port's coupled replay covers in this slice
NON_ADAPTIVE = ("none", "fixed", "fixed_fw", "dual", "coalesce",
                "precoalesce")
ADAPTIVE = ("perfbound", "perfbound_correct", "perfbound_dual", "predict")

SIM_FIELDS = ("makespan", "mean_latency", "max_latency", "n_messages",
              "link_energy", "switch_energy", "node_energy", "total_energy",
              "asleep_frac", "deep_frac", "n_wake_transitions", "hits",
              "misses", "deep_misses")
COUNTERS = ("n_messages", "n_wake_transitions", "hits", "misses",
            "deep_misses")


def port_policy(p):
    return convert.policy(dataclasses.asdict(p))


def port_pm(pm):
    return convert.power_model(dataclasses.asdict(pm))


def port_topo(topo):
    return convert.megafly(dataclasses.asdict(topo))


def port_trace(tr):
    return convert.trace(tr.nodes, [dataclasses.asdict(s) for s in tr.steps],
                         tr.name)


def assert_sim_results_match(got, want, label=""):
    """SimResult floats at the reference-vs-compiled tolerance
    (tests/test_plan.py), counters exact."""
    g, w = got.as_dict(), want.as_dict()
    for k in SIM_FIELDS:
        if k in COUNTERS:
            assert g[k] == w[k], f"{label}.{k}: {g[k]} != {w[k]}"
        else:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-9, atol=1e-12,
                                       err_msg=f"{label}.{k}")


def assert_events_match(got, want, label=""):
    assert len(got) == len(want), label
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a[0], np.asarray(b[0]),
                                      err_msg=f"{label} step {i} links")
        for j in (1, 2):
            np.testing.assert_allclose(a[j], np.asarray(b[j]), rtol=1e-9,
                                       atol=1e-12,
                                       err_msg=f"{label} step {i} col {j}")
