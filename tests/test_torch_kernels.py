"""PyTorch port, decoupled-path kernels on the CPU: the plain versions
(``repro_torch.kernels.ref``, reached through ``ops`` with CPU tensors) are
held against the reference Pallas kernels (interpret mode) and the
reference oracles on the shape grids and tolerances of
``tests/test_kernels.py``; the CPU side of the ``ops`` dispatch contract.
The CUDA kernels themselves are tested on the card
(``tests/test_torch_cuda.py``, marker ``cuda``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import perfbound as jpb  # noqa: E402
from repro.core.eee import Policy  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from _torch_parity import port_policy  # noqa: E402
from repro_torch.core import perfbound as tpb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.hist_update import (hist_update_cuda,  # noqa: E402
                                             threads_for)
from repro_torch.kernels.port_energy import port_energy_cuda  # noqa: E402
from repro_torch.kernels.tpdt_select import tpdt_select_cuda  # noqa: E402

SHAPE_SWEEP_P = [1, 3, 64, 128, 130, 257]
T = torch.as_tensor


def _np(x):
    return {k: _np(v) for k, v in x.items()} if isinstance(x, dict) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# tpdt_select
# ---------------------------------------------------------------------------


def _rand_hist(rng, P, B):
    counts = rng.integers(0, 20, (P, B)).astype(np.float32)
    centers = (np.arange(B) + 0.5) * 1e-5
    sums = counts * centers[None, :] * rng.uniform(0.9, 1.1, (P, B))
    sums = sums.astype(np.float32)
    N = rng.uniform(0, counts.sum(1) + 5).astype(np.float32)
    total = counts.sum(1).astype(np.float32)
    return counts, sums, N, total, centers.astype(np.float32)


@pytest.mark.parametrize("P", SHAPE_SWEEP_P)
@pytest.mark.parametrize("B", [100, 200, 256])
def test_tpdt_select_matches_reference(P, B, rng):
    args = _rand_hist(rng, P, B)
    kw = dict(max_tpdt=10e-3, tpdt_init=1e-3)
    got = ops.tpdt_select_op(*(T(a) for a in args), **kw).numpy()
    pallas = np.asarray(jops.tpdt_select_op(*args, **kw))
    oracle = np.asarray(jref.tpdt_select_ref(
        *(jnp.asarray(a, jnp.float32) for a in args), **kw))
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tpdt_select_casts_operands(dtype, rng):
    args = _rand_hist(rng, 64, 200)
    kw = dict(max_tpdt=10e-3, tpdt_init=1e-3)
    got = ops.tpdt_select_op(*(T(a.astype(dtype)) for a in args), **kw)
    want = jops.tpdt_select_op(*(a.astype(dtype) for a in args), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_tpdt_select_empty_and_infeasible():
    B = 200
    counts = np.zeros((2, B), np.float32)
    counts[1, B - 1] = 50.0
    centers = (np.arange(B) + 0.5).astype(np.float32)
    out = ops.tpdt_select_op(T(counts), T(counts * 1.0), T(np.zeros(2,
                             np.float32)), T(counts.sum(1)), T(centers),
                             max_tpdt=7.0, tpdt_init=3.0).numpy()
    assert out[0] == 3.0 and out[1] == 7.0


# ---------------------------------------------------------------------------
# hist_update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,P", [(1, 1), (7, 3), (64, 128), (100, 130),
                                 (513, 64)])
@pytest.mark.parametrize("log_bins", [False, True])
def test_hist_update_matches_reference(E, P, log_bins, rng):
    gaps = rng.uniform(-1e-5, 5e-3, (E, P)).astype(np.float32)
    kw = dict(n_bins=200, bin_width=10e-6, log_bins=log_bins,
              log_min=1e-7, log_max=1.0)
    gc, gs = (x.numpy() for x in ops.hist_update_op(T(gaps), **kw))
    for want in (jops.hist_update_op(gaps, **kw),
                 jops.hist_update_op(gaps, use_ref=True, **kw)):
        wc, ws = _np(want)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-9)


def test_hist_update_log_bins_agree_away_from_bin_edges(rng):
    # log-uniform gaps over every bin, plus gaps within three float32 steps
    # of every bin edge; float32 logs and divisions of two frameworks may
    # put a near-edge gap in either neighbour bin, any other gap in the
    # same bin (the plain version uses the Pallas kernel's float32 edges)
    edges = dict(n_bins=200, log_min=1e-7, log_max=1.0)
    kw = dict(edges, bin_width=10e-6, log_bins=True)
    lo, hi = np.log(1e-7), np.log(1.0)
    edge = np.exp(np.float32(lo) + np.float32(hi - lo)
                  * np.arange(1, 200) / 200).astype(np.float32)
    rows = [edge]
    for direction in (np.float32(np.inf), np.float32(0)):
        g = edge
        for _ in range(3):
            g = np.nextafter(g, direction)
            rows.append(g)
    at_edge = np.stack(rows)
    spread = np.exp(rng.uniform(np.log(1e-8), np.log(2.0),
                                (64, edge.size))).astype(np.float32)
    gaps = np.concatenate([at_edge, spread])
    near = ref.log_bin_near_edge(T(gaps), **edges).numpy()
    assert near[:len(rows)].all() and near[len(rows):].mean() < 0.01
    gc, _ = ops.hist_update_op(T(gaps), **kw)
    for want in (jops.hist_update_op(gaps, **kw),
                 jops.hist_update_op(gaps, use_ref=True, **kw)):
        np.testing.assert_array_equal(gc.sum(1).numpy(),
                                      np.asarray(want[0]).sum(1))
    far = np.where(near, np.float32(0), gaps)
    gc, gs = (x.numpy() for x in ops.hist_update_op(T(far), **kw))
    for want in (jops.hist_update_op(far, **kw),
                 jops.hist_update_op(far, use_ref=True, **kw)):
        wc, ws = _np(want)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-9)


def test_hist_update_agrees_with_perfbound_binning():
    pol = Policy(kind="perfbound", hist_bins=50, hist_bin_width=1e-4)
    gaps = np.array([5e-5, 1.23e-4, 4.9e-3, 1e9], np.float32).reshape(4, 1)
    counts, _ = ops.hist_update_op(T(gaps), n_bins=50, bin_width=1e-4)
    want = np.asarray(jpb.bin_index(jnp.asarray(gaps[:, 0]), pol))
    got = tpb.bin_index(T(gaps[:, 0]), port_policy(pol)).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(set(want.tolist())) \
        == np.nonzero(counts.numpy()[0])[0].tolist()


def test_hist_update_threads_fit_shared_memory():
    assert threads_for(200) == 64
    assert threads_for(600) == 32
    with pytest.raises(ValueError, match="too large"):
        threads_for(1000)


# ---------------------------------------------------------------------------
# port_energy
# ---------------------------------------------------------------------------


def _streams(rng, E, P, durs_lo=0.0):
    gaps = rng.uniform(0, 2e-3, (E, P)).astype(np.float32)
    durs = rng.uniform(durs_lo, 1e-4, (E, P)).astype(np.float32)
    if durs_lo == 0.0:
        durs[rng.random((E, P)) < 0.2] = 0.0  # padding rows
    tpdt = rng.uniform(0, 1e-3, (P,)).astype(np.float32)
    tail = rng.uniform(0, 1.0, (P,)).astype(np.float32)
    return gaps, durs, tpdt, tail


def _assert_energy_match(got, want):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("E,P", [(1, 1), (16, 64), (100, 128), (257, 130)])
def test_port_energy_matches_reference(E, P, rng):
    args = _streams(rng, E, P)
    kw = dict(t_w=4.48e-6, t_s=2e-6)
    got = ops.port_energy_op(*(T(a) for a in args), **kw)
    _assert_energy_match(got, jops.port_energy_op(*args, **kw))
    _assert_energy_match(got, jops.port_energy_op(*args, use_ref=True, **kw))


@pytest.mark.parametrize("E,P", [(1, 1), (16, 64), (100, 130)])
def test_port_energy_hold_and_ladder_match_reference(E, P, rng):
    args = _streams(rng, E, P)
    hold = rng.uniform(0, 5e-4, (P,)).astype(np.float32)
    kw = dict(t_w=4.48e-6, t_s=2e-6, t_w2=1e-4, t_s2=1e-5, t_dst=2e-4)
    got = ops.port_energy_op(*(T(a) for a in args), hold=T(hold), **kw)
    _assert_energy_match(got, jops.port_energy_op(*args, hold=hold, **kw))
    _assert_energy_match(got, jops.port_energy_op(*args, hold=hold,
                                                  use_ref=True, **kw))


def test_port_energy_hold_zero_is_identity(rng):
    args = [T(a) for a in _streams(rng, 32, 64, durs_lo=1e-6)]
    kw = dict(t_w=4.48e-6, t_s=2e-6, t_w2=1e-4, t_s2=1e-5, t_dst=2e-4)
    a = ops.port_energy_op(*args, **kw)
    b = ops.port_energy_op(*args, hold=0.0, **kw)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the CPU side of the dispatch contract
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(rng):
    ops.reset_launch_counts()
    gaps, durs, tpdt, tail = (T(a) for a in _streams(rng, 16, 8))
    kw = dict(t_w=4.48e-6, t_s=2e-6)
    got = ops.port_energy_op(gaps, durs, tpdt, tail, **kw)
    want = ref.port_energy_ref(gaps, durs, tpdt, tail, **kw)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    hkw = dict(n_bins=32, bin_width=1e-4)
    for x, y in zip(ops.hist_update_op(gaps, **hkw),
                    ref.hist_update_ref(gaps, **hkw)):
        assert torch.equal(x, y)
    counts, sums = ref.hist_update_ref(gaps, **hkw)
    N, total = torch.full((8,), 3.0), counts.sum(1)
    centers = (torch.arange(32) + 0.5) * 1e-4
    assert torch.equal(
        ops.tpdt_select_op(counts, sums, N, total, centers, max_tpdt=1.0,
                           tpdt_init=2.0, use_ref=True),
        ref.tpdt_select_ref(counts, sums, N, total, centers, max_tpdt=1.0,
                            tpdt_init=2.0))
    assert ops.launch_counts() == {"port_energy": 0, "hist_update": 0,
                                   "tpdt_select": 0}


def test_cuda_wrappers_refuse_host_tensors(rng):
    """The kernel wrappers never run a plain version: a CPU tensor is an
    error there, and nothing is counted."""
    ops.reset_launch_counts()
    gaps, durs, tpdt, tail = (T(a) for a in _streams(rng, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        port_energy_cuda(gaps, durs, tpdt, tail, t_w=1e-6, t_s=1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        hist_update_cuda(gaps, n_bins=8, bin_width=1e-4)
    counts = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tpdt_select_cuda(counts, counts, tail, tail, torch.zeros(8),
                         max_tpdt=1.0, tpdt_init=1.0)
    assert sum(ops.launch_counts().values()) == 0
