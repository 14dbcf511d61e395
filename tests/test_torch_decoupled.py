"""PyTorch port, decoupled fast path on the CPU: event streams bitwise
equal to the JAX package's, the kernel-backed evaluations at ``rtol=1e-5``,
and the whole slice — coupled baseline replay then decoupled evaluation —
port against reference."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import decoupled as JD  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.core.eee import Policy as JPolicy  # noqa: E402
from repro.core.eee import PowerModel as JPowerModel  # noqa: E402
from repro.topology.megafly import small_topology as jsmall  # noqa: E402
from repro.traffic.generators import small_apps  # noqa: E402

from _torch_parity import (port_pm, port_policy, port_topo,  # noqa: E402
                           port_trace)
from repro_torch.core import decoupled as TD  # noqa: E402
from repro_torch.core import simulator as TS  # noqa: E402

JT = jsmall()
TT = port_topo(JT)
PM = JPowerModel()
TPDT_GRID = [0.0, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0]
EVAL_POLICIES = {
    "fixed_fw": JPolicy(kind="fixed", sleep_state="fast_wake"),
    "fixed_ds": JPolicy(kind="fixed", sleep_state="deep_sleep"),
    "dual": JPolicy(kind="dual", t_dst=1e-4, sleep_state="fast_wake",
                    deep_state="deep_sleep"),
    "precoalesce": JPolicy(kind="precoalesce", t_dst=1e-4, hold_delay=5e-5,
                           sleep_state="fast_wake", deep_state="deep_sleep"),
}
SCALARS = ("link_energy", "wake_time", "sleep_time", "sleep2_time")
ARRAYS = ("time_wake", "time_sleep", "time_sleep2", "n_wake", "hits",
          "misses", "n_deep")


@pytest.fixture(scope="module")
def baseline():
    """JAX coupled baseline of a small LAMMPS run: (result, events)."""
    tr = small_apps(JT, n_nodes=8)["lammps"]
    return JS.simulate_trace(tr, JT, JPolicy(kind="none"), PM,
                             collect_events=True)


def _assert_eval_match(got, want, label):
    for k in SCALARS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-9,
                                   err_msg=f"{label}.{k}")
    for k in ARRAYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-8,
                                   err_msg=f"{label}.{k}")


def test_events_to_streams_bitwise(baseline):
    res, events = baseline
    want = JD.events_to_streams(events, JT.n_links, res.makespan)
    got = TD.events_to_streams(events, TT.n_links, res.makespan,
                               device="cpu")
    oracle = TD._events_to_streams_ref(events, TT.n_links, res.makespan)
    jor = JD._events_to_streams_ref(events, JT.n_links, res.makespan)
    for g, w, o, jo in zip(got, want, oracle, jor):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(g.numpy(), o)


def test_events_to_streams_empty_and_overlapping():
    events = [(np.array([3, 3, 3, 1]), np.array([1.0, 1.5, 1.6, 0.2]),
               np.array([2.0, 1.7, 2.5, 0.3]))]
    for evs in (events, []):
        got = TD.events_to_streams(evs, 5, 4.0, device="cpu")
        want = JD.events_to_streams(evs, 5, 4.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", list(EVAL_POLICIES))
def test_evaluate_fixed_matches(baseline, name):
    res, events = baseline
    jg = JD.events_to_streams(events, JT.n_links, res.makespan)
    tg = TD.events_to_streams(events, TT.n_links, res.makespan, device="cpu")
    jp = EVAL_POLICIES[name]
    for t in (1e-5, 1e-3):
        want = JD.evaluate_fixed(*jg, t, jp, PM)
        got = TD.evaluate_fixed(*tg, t, port_policy(jp), port_pm(PM),
                                device="cpu")
        _assert_eval_match(got, want, f"{name}@{t}")
        ref = TD.evaluate_fixed(*tg, t, port_policy(jp), port_pm(PM),
                                use_ref=True, device="cpu")
        assert got["link_energy"] == ref["link_energy"]


@pytest.mark.parametrize("log_bins", [False, True])
def test_perfbound_snapshot_matches(baseline, log_bins):
    res, events = baseline
    jg = JD.events_to_streams(events, JT.n_links, res.makespan)[0]
    jp = JPolicy(kind="perfbound", bound=0.01, hist_log_bins=log_bins)
    for t_elapsed in (res.makespan, 1e-3):
        want = JD.perfbound_snapshot_tpdt(jg, t_elapsed, 3.0, jp)
        got = TD.perfbound_snapshot_tpdt(np.array(jg), t_elapsed, 3.0,
                                         port_policy(jp), device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5)


def test_sweep_policies_matches(baseline):
    res, events = baseline
    jp = JPolicy(kind="fixed", sleep_state="deep_sleep")
    want = JD.sweep_policies(events, JT.n_links, res.makespan, TPDT_GRID, jp,
                             PM)
    got = TD.sweep_policies(events, TT.n_links, res.makespan, TPDT_GRID,
                            port_policy(jp), port_pm(PM), device="cpu")
    assert list(got) == list(want)
    for t in TPDT_GRID:
        _assert_eval_match(got[t], want[t], f"t={t}")


def test_whole_slice_matches_reference():
    """Port coupled baseline -> port decoupled, against JAX coupled
    baseline -> JAX decoupled, on the small AlexNet."""
    jtr = small_apps(JT, n_nodes=8)["alexnet"]
    jres, jev = JS.simulate_trace_reference(jtr, JT, JPolicy(kind="none"),
                                            PM, collect_events=True)
    tres, tev = TS.simulate_trace_reference(port_trace(jtr), TT,
                                            port_policy(JPolicy(kind="none")),
                                            port_pm(PM), collect_events=True,
                                            device="cpu")
    jp = JPolicy(kind="fixed", sleep_state="fast_wake")
    want = JD.sweep_policies(jev, JT.n_links, jres.makespan, TPDT_GRID, jp,
                             PM)
    got = TD.sweep_policies(tev, TT.n_links, tres.makespan, TPDT_GRID,
                            port_policy(jp), port_pm(PM), device="cpu")
    for t in TPDT_GRID:
        _assert_eval_match(got[t], want[t], f"slice t={t}")
    pbp = JPolicy(kind="perfbound", bound=0.01)
    jg = JD.events_to_streams(jev, JT.n_links, jres.makespan)[0]
    tg = TD.events_to_streams(tev, TT.n_links, tres.makespan,
                              device="cpu")[0]
    np.testing.assert_allclose(
        TD.perfbound_snapshot_tpdt(tg, tres.makespan, 3.0, port_policy(pbp),
                                   device="cpu").numpy(),
        np.asarray(JD.perfbound_snapshot_tpdt(jg, jres.makespan, 3.0, pbp)),
        rtol=1e-5)


def test_decoupled_entry_points_default_to_cuda(baseline):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res, events = baseline
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.events_to_streams(events, TT.n_links, res.makespan)
    with pytest.raises(RuntimeError):
        TD.sweep_policies(events, TT.n_links, res.makespan, [0.0],
                          port_policy(JPolicy(kind="fixed")))
