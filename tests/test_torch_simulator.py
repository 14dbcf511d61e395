"""PyTorch port, coupled replay on the CPU: ``simulate_trace_reference``
against the JAX package's for the non-adaptive kinds (SimResult floats at
``rtol=1e-9, atol=1e-12``, counters ``==``, event lists at the same
tolerance), single-message net state, and the slice's guards."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as JS  # noqa: E402
from repro.core.eee import PowerModel as JPowerModel  # noqa: E402
from repro.topology.megafly import small_topology as jsmall  # noqa: E402
from repro.traffic.generators import small_apps  # noqa: E402
from repro.traffic.trace import Trace  # noqa: E402

from _torch_parity import (ADAPTIVE, NON_ADAPTIVE, POLICIES,  # noqa: E402
                           assert_events_match, assert_sim_results_match,
                           port_pm, port_policy, port_topo, port_trace)
from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.core.eee import Policy  # noqa: E402

JT = jsmall()
TT = port_topo(JT)
PM = JPowerModel()


def _random_trace(seed, n_total):
    """Phase-structured trace from a seed: computes, message rounds (with
    src == dst and repeated pairs), barriers, in random interleavings."""
    rng = np.random.default_rng(seed)
    nodes = np.sort(rng.choice(n_total, 6, replace=False)).astype(np.int64)
    tr = Trace(nodes=nodes, name=f"rand{seed}")
    for _ in range(12):
        op = rng.choice(["compute", "msgs", "msgs", "msgs_barrier",
                         "barrier"])
        if op == "compute":
            tr.compute(rng.uniform(1e-6, 2e-3, len(nodes)))
        elif op == "barrier":
            tr.barrier()
        else:
            m = int(rng.integers(1, 90))
            msgs = np.stack([rng.choice(nodes, m), rng.choice(nodes, m),
                             rng.integers(1, 1 << 18, m)], 1)
            tr.messages(msgs, barrier=op == "msgs_barrier")
    return tr


def _both(jtrace, name, collect=True):
    jp = POLICIES[name]
    want = JS.simulate_trace_reference(jtrace, JT, jp, PM,
                                       collect_events=collect)
    got = TS.simulate_trace_reference(port_trace(jtrace), TT,
                                      port_policy(jp), port_pm(PM),
                                      collect_events=collect, device="cpu")
    return got, want


@pytest.mark.parametrize("name", NON_ADAPTIVE)
def test_replay_matches_reference_on_alexnet(name):
    jtr = small_apps(JT, n_nodes=8)["alexnet"]
    (got, gev), (want, wev) = _both(jtr, name)
    assert_sim_results_match(got, want, name)
    assert_events_match(gev, wev, name)
    if name != "none":
        assert got.misses > 0


@pytest.mark.parametrize("name", ["fixed", "coalesce", "precoalesce"])
@pytest.mark.parametrize("seed", [0, 1])
def test_replay_matches_reference_on_random_traces(name, seed):
    jtr = _random_trace(seed, JT.n_nodes)
    (got, gev), (want, wev) = _both(jtr, name)
    assert_sim_results_match(got, want, f"{name}/{seed}")
    assert_events_match(gev, wev, f"{name}/{seed}")


@pytest.mark.parametrize("name", ["none", "dual", "coalesce", "precoalesce"])
def test_message_step_state_matches_reference(name):
    """Net state after a few hand-placed messages, row for row.  Under
    ``none`` the deadlines of touched rows turn NaN in both (inf - inf in
    the scatter-add), so rows compare with equal_nan."""
    jp = POLICIES[name]
    src = np.array([0, 0, 1, 17, 3], np.int64)
    dst = np.array([17, 17, 2, 0, 3], np.int64)     # incl. src == dst
    nbytes = np.array([4096, 1 << 20, 512, 65536, 100], np.float64)
    t_inj = np.array([0.0, 1e-6, 3e-4, 3e-4, 1.0])
    links, dirs, nhops = JT.routes(src, dst)
    jmsgs = JS._pad_msgs(links, dirs, nhops, t_inj, nbytes)
    jnet, jout = JS.sim_chunk(JS.init_net(JT.n_links, jp), jmsgs, jp, PM,
                              JT.n_links, True)
    tp = port_policy(jp)
    tmsgs = TS._pad_msgs(links, dirs, nhops, t_inj, nbytes, device="cpu")
    tnet, tout = TS.sim_chunk(TS.init_net(TT.n_links, tp, device="cpu"),
                              tmsgs, tp, port_pm(PM), TT.n_links, True)
    n = TT.n_links
    keys = [k for k in jnet if k != "pred"]
    assert set(keys) <= set(tnet)
    for k in keys:
        rows = 2 * n if k == "dir_free" else n
        np.testing.assert_allclose(tnet[k][:rows].numpy(),
                                   np.asarray(jnet[k])[:rows], rtol=1e-12,
                                   atol=0, equal_nan=True, err_msg=k)
    if name == "none":
        touched = np.unique(links[links >= 0])
        assert np.isnan(tnet["deadline"][touched].numpy()).all()
    for g, w in zip(tout[:2], jout[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    act = np.asarray(jout[2][3])
    np.testing.assert_array_equal(tout[2][3].numpy(), act)
    for j in (0, 1, 2):
        np.testing.assert_allclose(tout[2][j].numpy()[act],
                                   np.asarray(jout[2][j])[act], rtol=1e-12)


def test_close_out_summary_and_rows_match():
    jtr = small_apps(JT, n_nodes=8)["patmos"]
    (base, _), (jbase, _) = _both(jtr, "none", collect=False)
    (fx, _), (jfx, _) = _both(jtr, "fixed", collect=False)
    got = TS.relative_rows(base, {"fx": fx})
    want = JS.relative_rows(jbase, {"fx": jfx})
    assert got.keys() == want.keys()
    for r in got:
        for k, v in want[r].items():
            np.testing.assert_allclose(got[r][k], v, rtol=1e-9, atol=1e-9,
                                       err_msg=f"{r}.{k}")
    assert TS.unused_key({"__baseline__": 1}) \
        == JS.unused_key({"__baseline__": 1}) == "___baseline__"


@pytest.mark.parametrize("name", ADAPTIVE)
def test_adaptive_kinds_are_not_ported(name):
    tp = port_policy(POLICIES[name])
    tr = port_trace(small_apps(JT, n_nodes=8)["alexnet"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TS.simulate_trace_reference(tr, TT, tp, device="cpu")
    with pytest.raises(NotImplementedError):
        TS.init_net(TT.n_links, tp, device="cpu")


def test_record_hist_is_not_ported():
    with pytest.raises(NotImplementedError):
        TS.init_net(TT.n_links, Policy(kind="fixed", record_hist=True),
                    device="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tr = port_trace(small_apps(JT, n_nodes=8)["alexnet"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.simulate_trace_reference(tr, TT, Policy(kind="none"))
    with pytest.raises(RuntimeError):
        TS.init_net(TT.n_links, Policy(kind="none"))
