"""The port's flash-attention forward (plain version, the CPU side of the
CUDA kernel) against the JAX package's Pallas kernel in interpret mode and
its oracle, on the same inputs made with numpy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_attn import flash_attention_fwd_pallas  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attention_fwd_cuda  # noqa: E402,E501

# the five cases of tests/test_kernels.py's flash-attention test
CASES = [
    (2, 128, 4, 2, 32, True, None),
    (1, 96, 4, 4, 16, True, None),      # ragged seq vs 32-blocks, MHA
    (2, 64, 8, 2, 32, False, None),     # non-causal (encoder)
    (1, 128, 4, 2, 32, True, 48),       # sliding window (gemma3-style)
    (1, 64, 8, 1, 16, True, None),      # MQA
]


def _qkv(rng, B, Sq, H, Hkv, dh, dtype=np.float32):
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((B, Sq, H, dh), (B, Sq, Hkv, dh),
                           (B, Sq, Hkv, dh)))


@pytest.mark.parametrize("B,Sq,H,Hkv,dh,causal,window", CASES)
def test_plain_flash_forward_matches_pallas_and_oracle(B, Sq, H, Hkv, dh,
                                                       causal, window):
    rng = np.random.default_rng(Sq + dh)
    q, k, v = _qkv(rng, B, Sq, H, Hkv, dh)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kw = dict(causal=causal, window=window)
    want_kernel = jops.flash_attention_op(jq, jk, jv, block_q=32,
                                          block_kv=32, **kw)
    want_oracle = jops.flash_attention_op(jq, jk, jv, use_ref=True, **kw)
    want_lse = flash_attention_fwd_pallas(jq, jk, jv, block_q=32,
                                          block_kv=32, interpret=True,
                                          **kw)[1][..., :Sq]
    o, lse = ops.flash_attention_fwd_op(*map(torch.from_numpy, (q, k, v)),
                                        **kw)
    assert o.dtype == torch.float32 and lse.shape == (B * Hkv, H // Hkv, Sq)
    for want in (want_kernel, want_oracle):
        np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-5,
                               atol=2e-5)
    # the oracle itself, ported
    np.testing.assert_allclose(
        ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                **kw).numpy(),
        np.asarray(want_oracle), rtol=2e-5, atol=2e-5)


def test_plain_flash_forward_bf16_matches_pallas():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 64, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jops.flash_attention_op(jq, jk, jv, block_q=32, block_kv=32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    o = ops.flash_attention_op(tq, tk, tv)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_flash_op_contract_on_the_host():
    q = torch.zeros((1, 8, 2, 16))
    kv = torch.zeros((1, 8, 1, 16))
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention_op(q.requires_grad_(), kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd_cuda(q.detach(), kv, kv)
    assert ops.launch_counts()["flash_attn_fwd"] == 0
