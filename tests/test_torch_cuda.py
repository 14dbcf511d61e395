"""The port's CUDA kernels on the card, against their plain versions, and
the CUDA side of the ``ops`` dispatch contract.  Marked ``cuda``: they skip
without a card.  This file imports neither JAX nor the JAX package, so it
runs on a machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attention_fwd_cuda  # noqa: E402,E501
from repro_torch.kernels.port_energy import port_energy_cuda  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


@pytest.mark.parametrize("E,P", [(1, 1), (16, 64), (257, 130)])
@pytest.mark.parametrize("ladder", [False, True])
def test_port_energy_kernel_matches_plain(dev, E, P, ladder):
    rng = np.random.default_rng(E * 1000 + P)
    gaps = _t(rng.uniform(0, 2e-3, (E, P)), dev)
    durs_np = rng.uniform(0, 1e-4, (E, P))
    durs_np[rng.random((E, P)) < 0.2] = 0.0
    durs, tpdt = _t(durs_np, dev), _t(rng.uniform(0, 1e-3, P), dev)
    tail = _t(rng.uniform(0, 1.0, P), dev)
    kw = dict(t_w=4.48e-6, t_s=2e-6)
    if ladder:
        kw.update(t_w2=1e-4, t_s2=1e-5, t_dst=2e-4,
                  hold=_t(rng.uniform(0, 5e-4, P), dev))
    ops.reset_launch_counts()
    got = ops.port_energy_op(gaps, durs, tpdt, tail, **kw)
    want = ops.port_energy_op(gaps, durs, tpdt, tail, use_ref=True, **kw)
    assert ops.launch_counts()["port_energy"] == 1
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("E,P", [(1, 1), (7, 3), (513, 64)])
@pytest.mark.parametrize("B", [8, 200, 600])
def test_hist_update_kernel_matches_plain(dev, E, P, B):
    rng = np.random.default_rng(E + P + B)
    gaps = _t(rng.uniform(-1e-5, 5e-3, (E, P)), dev)
    kw = dict(n_bins=B, bin_width=10e-6)
    gc, gs = ops.hist_update_op(gaps, **kw)
    wc, ws = ops.hist_update_op(gaps, use_ref=True, **kw)
    assert torch.equal(gc, wc)
    torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("E,P", [(7, 3), (513, 64), (2048, 10400)])
def test_hist_update_kernel_log_bins_match_plain(dev, E, P):
    rng = np.random.default_rng(E + P)
    g = np.exp(rng.uniform(np.log(1e-8), np.log(20.0), (E, P)))
    g[rng.random((E, P)) < 0.1] = -1.0                  # ignored entries
    gaps = _t(g, dev)
    edges = dict(n_bins=200, log_min=1e-7, log_max=10.0)
    kw = dict(edges, bin_width=10e-6, log_bins=True)
    gc, _ = ops.hist_update_op(gaps, **kw)
    wc, _ = ops.hist_update_op(gaps, use_ref=True, **kw)
    assert torch.equal(gc.sum(1), wc.sum(1))
    # away from bin edges both bin every sample alike
    far = torch.where(ref.log_bin_near_edge(gaps, **edges), 0.0, gaps)
    gc, gs = ops.hist_update_op(far, **kw)
    wc, ws = ops.hist_update_op(far, use_ref=True, **kw)
    assert torch.equal(gc, wc)
    torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("P", [1, 130, 10400])
def test_tpdt_select_kernel_matches_plain(dev, P):
    rng = np.random.default_rng(P)
    B = 200
    counts = rng.integers(0, 20, (P, B)).astype(np.float32)
    centers = (np.arange(B) + 0.5) * 1e-5
    sums = counts * centers * rng.uniform(0.9, 1.1, (P, B))
    N = rng.uniform(0, counts.sum(1) + 5)
    args = [_t(a, dev) for a in (counts, sums, N, counts.sum(1), centers)]
    kw = dict(max_tpdt=10e-3, tpdt_init=1e-3)
    torch.testing.assert_close(ops.tpdt_select_op(*args, **kw),
                               ref.tpdt_select_ref(*args, **kw), rtol=1e-6,
                               atol=0)


def test_kernels_refuse_what_they_cannot_take(dev):
    g = torch.zeros((4, 3), device=dev)
    p = torch.zeros(3, device=dev)
    with pytest.raises(ValueError, match="float32"):
        port_energy_cuda(g, g.double(), p, p, t_w=1e-6, t_s=1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        port_energy_cuda(g, torch.zeros((3, 4), device=dev).t(), p, p,
                         t_w=1e-6, t_s=1e-6)
    with pytest.raises(ValueError, match="MAX_E"):
        ops.hist_update_op(torch.zeros((9000, 2), device=dev), n_bins=8,
                           bin_width=1.0)


# (B, Sq, Skv, H, Hkv, dh, causal, window): the five cases of the
# reference's kernel tests, other head dims, and a prefill longer than a
# few tiles with Skv != Sq
FLASH_CASES = [
    (2, 128, 128, 4, 2, 32, True, None),
    (1, 96, 96, 4, 4, 16, True, None),       # ragged, MHA
    (2, 64, 64, 8, 2, 32, False, None),      # non-causal
    (1, 128, 128, 4, 2, 32, True, 48),       # sliding window
    (1, 64, 64, 8, 1, 16, True, None),       # MQA
    (2, 77, 77, 4, 2, 64, True, None),
    (1, 150, 150, 4, 2, 112, True, 40),
    (1, 70, 70, 2, 1, 256, True, None),
    (1, 300, 333, 12, 2, 128, True, None),
    (2, 50, 90, 6, 3, 128, False, 30),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,dh,causal,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(dev, B, Sq, Skv, H, Hkv, dh,
                                              causal, window, dtype):
    rng = np.random.default_rng(Sq * 7 + dh)
    q, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev).to(dtype)
               for shape in ((B, Sq, H, dh), (B, Skv, Hkv, dh),
                             (B, Skv, Hkv, dh)))
    kw = dict(causal=causal, window=window)
    ops.reset_launch_counts()
    o, lse = ops.flash_attention_fwd_op(q, k, v, **kw)
    wo, wlse = ops.flash_attention_fwd_op(q, k, v, use_ref=True, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attn_fwd"] == 1
    assert o.dtype == dtype and lse.shape == (B * Hkv, H // Hkv, Sq)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), wo.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, wlse, rtol=tol, atol=tol)


def test_flash_attention_kernel_refuses(dev):
    q = torch.zeros((1, 8, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention_fwd_cuda(q, q[:, :, :1], q[:, :, :1])
    q = torch.zeros((1, 8, 2, 32), device=dev, requires_grad=True)
    kv = torch.zeros((1, 8, 1, 32), device=dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention_op(q, kv, kv)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_fwd_cuda(q.detach().half(), kv.half(), kv.half())
