"""PyTorch port, host-side modules: the EEE policy lowering, Megafly
routing, traces and collectives, message padding and PerfBound binning
are equal (``==``) to the JAX package's on the same inputs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import eee as jeee  # noqa: E402
from repro.core import perfbound as jpb  # noqa: E402
from repro.topology.megafly import Megafly as JMegafly  # noqa: E402
from repro.topology.megafly import small_topology as jsmall  # noqa: E402
from repro.traffic import collectives as jcoll  # noqa: E402
from repro.traffic import generators as jgen  # noqa: E402
from repro.traffic import plan as jplan  # noqa: E402

from _torch_parity import (ADAPTIVE, NON_ADAPTIVE, POLICIES,  # noqa: E402
                           port_pm, port_policy, port_topo, port_trace)
from repro_torch.core import eee as teee  # noqa: E402
from repro_torch.core import perfbound as tpb  # noqa: E402
from repro_torch.topology.megafly import Megafly  # noqa: E402
from repro_torch.topology.megafly import small_topology  # noqa: E402
from repro_torch.traffic import collectives as tcoll  # noqa: E402
from repro_torch.traffic import generators as tgen  # noqa: E402
from repro_torch.traffic import plan as tplan  # noqa: E402

KINDS = ("none", "fixed", "perfbound", "perfbound_correct", "dual",
         "coalesce", "perfbound_dual", "precoalesce", "predict")


@pytest.mark.parametrize("name", KINDS)
def test_policy_lowering_matches_reference(name):
    jp = POLICIES[name]
    tp = port_policy(jp)
    assert teee.policy_params(tp) == jeee.policy_params(jp)
    assert teee.static_key(tp) == jeee.static_key(jp)
    assert dataclasses.asdict(teee.canonical_proto(tp)) \
        == dataclasses.asdict(jeee.canonical_proto(jp))
    assert (tp.adaptive, tp.dual_capable) == (jp.adaptive, jp.dual_capable)


def test_field_classification_and_power_table_match():
    assert teee.PARAM_FIELDS == jeee.PARAM_FIELDS
    assert teee.STATIC_FIELDS == jeee.STATIC_FIELDS
    assert {k: dataclasses.asdict(v) for k, v in teee.EEE_STATES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jeee.EEE_STATES.items()}
    jpm = jeee.PowerModel()
    assert port_pm(jpm).static_table(Megafly()) \
        == jpm.static_table(JMegafly())


def _assert_routes_equal(ttopo, jtopo, src, dst):
    got = ttopo.routes(src, dst)
    want = jtopo.routes(src, dst)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(ttopo.routes_cached(src, dst), want):
        np.testing.assert_array_equal(g, w)


def test_routes_match_on_small_topology_all_pairs():
    jt, tt = jsmall(), small_topology()
    assert port_topo(jt) == tt
    n = jt.n_nodes
    src, dst = (a.ravel() for a in np.meshgrid(np.arange(n), np.arange(n)))
    _assert_routes_equal(tt, jt, src, dst)
    assert tt.signature() == jt.signature()


def test_routes_match_on_paper_megafly_random_pairs(rng):
    jt, tt = JMegafly(), Megafly()
    assert (tt.n_nodes, tt.n_links, tt.n_switches, tt.n_ports) \
        == (jt.n_nodes, jt.n_links, jt.n_switches, jt.n_ports) \
        == (4160, 10400, 1040, 20800)
    src = rng.integers(0, jt.n_nodes, 4096)
    dst = rng.integers(0, jt.n_nodes, 4096)
    _assert_routes_equal(tt, jt, src, dst)
    np.testing.assert_array_equal(tt.hop_distance(src[:64], dst[:64]),
                                  jt.hop_distance(src[:64], dst[:64]))


def test_route_cache_lru_bounds():
    tt = small_topology(n_groups=3, leaves=2, spines=2, nodes_per_leaf=2)
    tt.clear_route_cache()
    for i in range(tt.route_cache_size + 5):      # distinct keys
        src = np.arange(i + 1) % tt.n_nodes
        tt.routes_cached(src, src[::-1])
    info = tt.route_cache_info()
    assert info["entries"] == info["capacity"]
    a = tt.routes_cached(np.array([0, 1]), np.array([2, 3]))
    assert tt.routes_cached(np.array([0, 1]), np.array([2, 3])) is a


def _assert_traces_equal(t, j):
    assert t.name == j.name and len(t.steps) == len(j.steps)
    np.testing.assert_array_equal(t.nodes, j.nodes)
    for a, b in zip(t.steps, j.steps):
        assert a.barrier == b.barrier
        for f in ("compute_nodes", "compute_secs", "msgs"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y)
    assert (t.n_messages, t.total_bytes) == (j.n_messages, j.total_bytes)


def test_generated_traces_match():
    jt, tt = jsmall(), small_topology()
    japps, tapps = jgen.small_apps(jt, n_nodes=8), tgen.small_apps(tt, 8)
    assert tapps.keys() == japps.keys()
    for name in japps:
        _assert_traces_equal(tapps[name], japps[name])
        _assert_traces_equal(port_trace(japps[name]), japps[name])
    _assert_traces_equal(tgen.alexnet(Megafly(), n_nodes=64, iters=1),
                         jgen.alexnet(JMegafly(), n_nodes=64, iters=1))
    np.testing.assert_array_equal(
        tgen.allocate(Megafly(), 64, mapping="random", seed=3),
        jgen.allocate(JMegafly(), 64, mapping="random", seed=3))


@pytest.mark.parametrize("fn", ["allreduce", "broadcast", "reduce", "gather",
                                "allgather", "alltoall", "p2p_halo"])
def test_collective_rounds_match(fn):
    nodes = np.arange(16, dtype=np.int64) * 3 + 1
    got = getattr(tcoll, fn)(nodes, 1 << 20)
    want = getattr(jcoll, fn)(nodes, 1 << 20)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_message_padding_matches(rng):
    for M in (0, 1, 2, 63, 64, 65, 200):
        for bmin in (1, 64):
            assert tplan.bucket_cap(M, bmin) == jplan.bucket_cap(M, bmin)
    M = 37
    links = rng.integers(-1, 100, (M, 5)).astype(np.int32)
    dirs = rng.integers(0, 2, (M, 5)).astype(np.int32)
    nhops = rng.integers(0, 6, M).astype(np.int32)
    t_inj, nbytes = rng.random(M), rng.integers(1, 1 << 20, M)
    got = tplan.pad_message_table(links, dirs, nhops, t_inj, nbytes)
    want = jplan.pad_message_table(links, dirs, nhops, t_inj, nbytes)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("log_bins", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bin_index_and_centers_match(log_bins, dtype, rng):
    pol = jeee.Policy(kind="perfbound", hist_bins=50, hist_bin_width=1e-4,
                      hist_log_bins=log_bins)
    gaps = np.concatenate([rng.uniform(0, 6e-3, 500),
                           10.0 ** rng.uniform(-8, 1, 500),
                           [0.0, 5e-5, 1.23e-4, 4.9e-3, 1e9]]).astype(dtype)
    want = np.asarray(jpb.bin_index(jnp.asarray(gaps), pol))
    got = tpb.bin_index(torch.as_tensor(gaps), port_policy(pol)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tpb.bin_centers(port_policy(pol), device="cpu").numpy(),
        np.asarray(jpb.bin_centers(pol)))


@pytest.mark.parametrize("name", NON_ADAPTIVE)
def test_init_state_matches_for_non_adaptive_kinds(name):
    jp = POLICIES[name]
    got = tpb.init_state(9, port_policy(jp), device="cpu")
    want = jpb.init_state(9, jp)
    assert got.keys() == want.keys() == {"tpdt"}
    np.testing.assert_array_equal(got["tpdt"].numpy(),
                                  np.asarray(want["tpdt"]))
    assert tpb._initial_tpdt(port_policy(jp)) == jpb._initial_tpdt(jp)


@pytest.mark.parametrize("name", ADAPTIVE)
def test_init_state_of_adaptive_kinds_is_not_ported(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpb.init_state(9, port_policy(POLICIES[name]), device="cpu")
