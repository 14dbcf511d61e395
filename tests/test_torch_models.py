"""The port's dense decoder (layers, forward, prefill cache, decode,
greedy generation) against the JAX package on the same weights: the
reference's ``init_params`` tree, perturbed with numpy so that biases and
norm scales are not zero, carried across with ``convert.model_params``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.serve import generate as jgenerate  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ModelConfig, get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import serve  # noqa: E402

DENSE = ["qwen2-1.5b", "qwen1.5-4b", "nemotron-4-15b", "gemma3-4b"]


def _cfgs(**kw):
    """The qwen2-1.5b smoke config, for the reference and the port."""
    jc = dataclasses.replace(jget_config("qwen2-1.5b").smoke(), **kw)
    return jc, ModelConfig(**dataclasses.asdict(jc))


def _perturbed(tree, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), tree)


def _both(tree):
    """(reference params as jnp arrays, port params as tensors)."""
    return jax.tree.map(jnp.asarray, tree), convert.model_params(tree)


@pytest.fixture(scope="module")
def weights():
    jc, _ = _cfgs()
    return _both(_perturbed(JM.init_params(jc, jax.random.PRNGKey(0))))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def test_config_carries_across_and_counts_match():
    for name in DENSE + ["dbrx-132b", "zamba2-7b", "whisper-tiny"]:
        j = jget_config(name)
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j)
    for name in DENSE:
        assert M.count_params(get_config(name)) == \
            JM.count_params(jget_config(name))
    assert get_config("qwen2-1.5b").param_count() == 1_543_714_304


def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    s = rng.normal(0, 0.3, 16).astype(np.float32)
    _close(L.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(s)), 1e-5)
    pos = np.arange(100, 109)
    for p in (pos, np.stack([pos, pos + 7])):
        _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(p), 1e6),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(p), 1e6), 1e-5)


@pytest.mark.parametrize("impl", ["jax", "pallas"])
@pytest.mark.parametrize("cached", [False, True])
def test_attention_block_matches(weights, impl, cached):
    jc, tc = _cfgs(attn_impl=impl)
    jp, tp = weights
    ja = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    ta = M._layer(tp["blocks"], 0)["attn"]
    x = np.random.default_rng(2).normal(size=(2, 12, 64)).astype(np.float32)
    pos = np.arange(12)
    kw = dict(causal=True, window=None)
    if cached:
        shape = (2, 20, jc.num_kv_heads, jc.head_dim)
        jcache = {"k": jnp.zeros(shape, jnp.float32),
                  "v": jnp.zeros(shape, jnp.float32)}
        tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
        want, wc = JL.attention_block(jnp.asarray(x), ja, jc,
                                      positions=jnp.asarray(pos),
                                      cache=jcache, cache_len=0, **kw)
        got, gc = L.attention_block(torch.from_numpy(x), ta, tc,
                                    positions=torch.from_numpy(pos),
                                    cache=tcache, cache_len=0, **kw)
        for n in ("k", "v"):
            _close(gc[n], wc[n], 1e-5)
    else:
        want, _ = JL.attention_block(jnp.asarray(x), ja, jc,
                                     positions=jnp.asarray(pos), **kw)
        got, _ = L.attention_block(torch.from_numpy(x), ta, tc,
                                   positions=torch.from_numpy(pos), **kw)
    _close(got, want, 1e-5)


def test_chunked_attention_matches():
    jc, tc = _cfgs(attn_direct_max_seq=1)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 21, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 21, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 21, 2, 16)).astype(np.float32)
    pos = np.tile(np.arange(21), (2, 1))
    for causal, window in ((True, None), (False, None), (True, 6)):
        kw = dict(causal=causal, window=window)
        want = JL.attention_op(*map(jnp.asarray, (q, k, v, pos, pos)),
                               cfg=jc, **kw)
        got = L.attention_op(*map(torch.from_numpy, (q, k, v, pos, pos)),
                             cfg=tc, **kw)
        _close(got, want, 1e-5)


@pytest.mark.parametrize("act", ["swiglu", "sq_relu", "gelu"])
def test_mlp_block_matches(act):
    jc, tc = _cfgs(act=act)
    tree = _perturbed(JL.mlp_params(jax.random.PRNGKey(1), jc))
    x = np.random.default_rng(3).normal(size=(2, 5, 64)).astype(np.float32)
    _close(L.mlp_block(torch.from_numpy(x), convert.model_params(tree), tc),
           JL.mlp_block(jnp.asarray(x), jax.tree.map(jnp.asarray, tree), jc),
           1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["jax", "pallas"])
def test_forward_train_and_prefill_match(weights, impl):
    # S = 40 > attn_direct_max_seq: the 'jax' path runs chunked attention
    jc, tc = _cfgs(attn_impl=impl)
    jp, tp = weights
    toks = _tokens((2, 40))
    batch_j, batch_t = {"tokens": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks)}
    for mode in ("train", "prefill"):
        want = JM.forward(jp, batch_j, jc, mode=mode)
        got = M.forward(tp, batch_t, tc, mode=mode)
        _close(got["logits"], want["logits"], 1e-4)
        if mode == "prefill":
            assert got["cache"]["len"] == int(want["cache"]["len"]) == 40
            for n in ("k", "v"):
                _close(got["cache"][n], want["cache"][n], 1e-4)


def test_flash_forward_matches_chunked_reference(weights):
    """The port's flash path against the reference's chunked path: the
    implementations differ, so the tolerance of test_kernels.py:353."""
    jc, _ = _cfgs(attn_impl="jax", attn_direct_max_seq=1)
    _, tc = _cfgs(attn_impl="pallas")
    jp, tp = weights
    toks = _tokens((2, 32), seed=4)
    want = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jc)["logits"]
    got = M.forward(tp, {"tokens": torch.from_numpy(toks)}, tc)["logits"]
    _close(got, want, 1e-3)


def test_decode_step_matches(weights):
    jc, tc = _cfgs(attn_impl="pallas")
    jp, tp = weights
    toks = _tokens((2, 10), seed=6)
    jcache = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jc,
                        mode="prefill")["cache"]
    tcache = M.forward(tp, {"tokens": torch.from_numpy(toks)}, tc,
                       mode="prefill")["cache"]
    # room for two more tokens
    pad = [(0, 0), (0, 0), (0, 2), (0, 0), (0, 0)]
    jcache = dict(jcache, k=jnp.pad(jcache["k"], pad),
                  v=jnp.pad(jcache["v"], pad))
    tcache = serve.grow_cache(tcache, 12)
    for step in range(2):
        nxt = _tokens((2, 1), seed=7 + step)
        want, jcache = JM.decode_step(jp, jcache, jnp.asarray(nxt), jc)
        got, tcache = M.decode_step(tp, tcache, torch.from_numpy(nxt), tc)
        assert tcache["len"] == int(jcache["len"]) == 11 + step
        _close(got, want, 1e-4)
    for n in ("k", "v"):
        _close(tcache[n], jcache[n], 1e-4)


@pytest.mark.parametrize("impl", ["jax", "pallas"])
@pytest.mark.parametrize("cache_len", [None, 40])
def test_generate_tokens_equal(weights, impl, cache_len):
    jc, tc = _cfgs(attn_impl=impl)
    jp, tp = weights
    prompt = _tokens((2, 24), seed=8)
    want = jgenerate(jp, jc, jnp.asarray(prompt), 6, cache_len=cache_len)
    got = serve.generate(tp, tc, torch.from_numpy(prompt), 6,
                         cache_len=cache_len)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_rejects_small_cache_and_serve_steps_agree(weights):
    _, tc = _cfgs(attn_impl="pallas")
    _, tp = weights
    prompt = torch.from_numpy(_tokens((2, 24), seed=8))
    with pytest.raises(ValueError, match="cache_len"):
        serve.generate(tp, tc, prompt, 6, cache_len=29)
    toks = serve.generate(tp, tc, prompt, 3)
    first, cache = serve.make_prefill_step(tc)(tp, {"tokens": prompt})
    cache = serve.grow_cache(cache, 27)
    step = serve.make_serve_step(tc)
    nxt, cache = step(tp, cache, first[:, None])
    nxt2, _ = step(tp, cache, nxt)
    np.testing.assert_array_equal(
        torch.cat([first[:, None], nxt, nxt2], 1).numpy(), toks.numpy())


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_params(get_config("dbrx-132b").smoke(), device="cpu")
    g = get_config("gemma3-4b").smoke()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_cache(g, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        L.attention_op(*(torch.zeros((1, 4, 2, 16)),) * 3,
                       torch.arange(4)[None], torch.arange(4)[None],
                       causal=True, window=None,
                       cfg=dataclasses.replace(g, attn_impl="stub"))
