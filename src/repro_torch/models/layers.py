"""Model building blocks of the dense decoder, plain PyTorch.

The dense subset of the reference's ``repro/models/layers.py``, operation
for operation: norms, RoPE, grouped-query attention (direct, chunked, or
the flash kernel of ``repro_torch.kernels``) with a linear KV cache, and
the MLP.

Conventions, as in the reference: activations are ``(B, S, ...)``;
weights live in plain dicts of tensors; the compute dtype is
``cfg.dtype``; softmax and normalisation run in float32.  Where the
reference asks for float32 products of bf16 operands
(``preferred_element_type``), the operands are widened to float32 first,
which is exact.  The sharding constraints of the reference
(``distributed/ctx.constrain``) are the identity on one device and are
left out.

Left for later slices: the shift cache of sliding-window layers, MoE,
Mamba2 and RWKV (ROADMAP Queue 1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.numerics import div

_F32 = torch.float32
_NEG = -0.7 * float(torch.finfo(_F32).max)
# the position of a key that no query may see (an unwritten cache slot)
FAR = 2 ** 30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps=1e-6):
    x32 = x.to(_F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(_F32))).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    x32 = x.to(_F32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(_F32) + bias.to(_F32)).to(x.dtype)


def norm(x, p, kind):
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def norm_params(d, kind, *, device=None):
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=_F32, device=device),
                "bias": torch.zeros((d,), dtype=_F32, device=device)}
    return {"scale": torch.zeros((d,), dtype=_F32, device=device)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim, theta, device=None):
    half = head_dim // 2
    e = torch.arange(0, half, dtype=_F32, device=device) / half
    return div(1.0, theta ** e)


def apply_rope(x, positions, theta):
    """x: (B, S, H, dh); positions: (B, S) or (S,).  Half-split rotation
    in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (dh/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(_F32) * freqs             # (B, S, dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _mask_bias(q_pos, k_pos, *, causal, window):
    """(..., Sq, Sk) additive float32 bias from position grids."""
    qp, kp = q_pos[..., :, None], k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= qp - kp < window
    return torch.where(ok, 0.0, _NEG).to(_F32)


def _direct_attention(q, k, v, q_pos, k_pos, *, causal, window, scale):
    """q: (B,Sq,H,dh), k/v: (B,Sk,Hkv,dh).  GQA by head grouping."""
    B, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(_F32), k.to(_F32)) * scale
    s = s + _mask_bias(q_pos, k_pos, causal=causal,
                       window=window)[:, None, None]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(_F32), v.to(_F32))
    return o.reshape(B, Sq, H, dh).to(q.dtype)


def _chunked_attention(q, k, v, q_pos, k_pos, *, causal, window, scale,
                       chunk_q, chunk_kv):
    """Flash-style attention: a loop over KV chunks with online softmax
    for each query chunk.  Memory is O(chunk_q * chunk_kv), never S^2."""
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    cq, ckv = min(chunk_q, Sq), min(chunk_kv, Sk)
    nq, nk = -(-Sq // cq), -(-Sk // ckv)
    pad_q, pad_k = nq * cq - Sq, nk * ckv - Sk
    q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    q_pos = F.pad(q_pos, (0, pad_q), value=-1)
    k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    # padded keys get a position no causal query reaches
    k_pos = F.pad(k_pos, (0, pad_k), value=FAR)
    outs = []
    for i in range(nq):
        qg = q[:, i * cq:(i + 1) * cq].reshape(B, cq, Hkv, G, dh).to(_F32)
        qpi = q_pos[:, i * cq:(i + 1) * cq]
        m = torch.full((B, Hkv, G, cq), _NEG, dtype=_F32, device=q.device)
        l = torch.zeros((B, Hkv, G, cq), dtype=_F32, device=q.device)
        acc = torch.zeros((B, Hkv, G, cq, dh), dtype=_F32, device=q.device)
        for j in range(nk):
            kj = k[:, j * ckv:(j + 1) * ckv]
            vj = v[:, j * ckv:(j + 1) * ckv]
            kpj = k_pos[:, j * ckv:(j + 1) * ckv]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj.to(_F32)) * scale
            kp, qp = kpj[:, None, None, None, :], qpi[:, None, None, :, None]
            ok = (kp <= qp) if causal else (kp < FAR)
            if window is not None:
                ok = ok & (qp - kp < window)
            s = torch.where(ok, s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None]) * ok
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd",
                              p.to(vj.dtype).to(_F32), vj.to(_F32))
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, cq, H, dh)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Sq]


def attention_op(q, k, v, q_pos, k_pos, *, causal, window, cfg,
                 use_ref=False):
    """Self-attention of q over k/v.  ``cfg.attn_impl == "pallas"`` sends
    a fresh sequence (Sq > 1) through the flash kernel; ``use_ref=True``
    takes the kernel's plain version instead, on any device."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq > 1 and cfg.attn_impl != "jax":
        # fresh-sequence fast paths (train / from-scratch prefill only:
        # q_pos/k_pos are plain aranges there, which these paths assume)
        if cfg.attn_impl == "pallas":
            return ops.flash_attention_op(q, k, v, causal=causal,
                                          window=window,
                                          block_q=cfg.attn_chunk_q,
                                          block_kv=cfg.attn_chunk_kv,
                                          use_ref=use_ref)
        if cfg.attn_impl == "stub":
            raise NotImplementedError(
                "attn_impl='stub' is the dry-run's HBM stand-in; the dry-run "
                "is not ported yet (ROADMAP Queue 1, launch/dryrun.py)")
    if max(Sq, Sk) <= cfg.attn_direct_max_seq or Sq == 1:
        return _direct_attention(q, k, v, q_pos, k_pos, causal=causal,
                                 window=window, scale=scale)
    return _chunked_attention(q, k, v, q_pos, k_pos, causal=causal,
                              window=window, scale=scale,
                              chunk_q=cfg.attn_chunk_q,
                              chunk_kv=cfg.attn_chunk_kv)


def attn_params(normal, cfg):
    """``normal(shape)`` draws standard normal float32 tensors."""
    d = cfg.d_model
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    p = {"wq": normal((d, H * dh)) * s,
         "wk": normal((d, Hkv * dh)) * s,
         "wv": normal((d, Hkv * dh)) * s,
         "wo": normal((H * dh, d)) / math.sqrt(H * dh)}
    dev = p["wq"].device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * dh,), dtype=_F32, device=dev)
        p["bk"] = torch.zeros((Hkv * dh,), dtype=_F32, device=dev)
        p["bv"] = torch.zeros((Hkv * dh,), dtype=_F32, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((dh,), dtype=_F32, device=dev)
        p["k_norm"] = torch.zeros((dh,), dtype=_F32, device=dev)
    return p


def attention_block(x, p, cfg, *, positions, causal, window, cache=None,
                    cache_len=None, use_ref=False):
    """Self-attention.  x: (B, S, D); positions: (B, S) or (S,).

    ``cache``: optional linear cache ``{"k", "v"}``, each (B, Smax, Hkv,
    dh), written in place at ``cache_len`` (a host int, so placing the
    write needs no device sync); entries past ``cache_len + S`` are
    masked.  Returns ``(out, cache)``, ``cache`` None without one."""
    B, S, D = x.shape
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, S, H, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    k = k.reshape(B, S, Hkv, dh)
    v = v.reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q_pos = positions if positions.dim() == 2 else \
        positions[None].expand(B, S)

    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        Smax = ck.shape[1]
        ck[:, cache_len:cache_len + S] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + S] = v.to(cv.dtype)
        k_pos = torch.arange(Smax, device=x.device)
        k_pos = torch.where(k_pos < cache_len + S, k_pos, FAR)
        k_pos = k_pos[None].expand(B, Smax)
        k, v = ck.to(x.dtype), cv.to(x.dtype)
    else:
        k_pos = torch.arange(S, device=x.device)[None].expand(B, S)

    o = attention_op(q, k, v, q_pos, k_pos, causal=causal, window=window,
                     cfg=cfg, use_ref=use_ref)
    out = o.reshape(B, S, H * dh) @ p["wo"].to(x.dtype)
    return out, cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_params(normal, cfg):
    d = cfg.d_model
    f = cfg.d_ff
    s1, s2 = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"w1": normal((d, f)) * s1, "w2": normal((f, d)) * s2}
    if cfg.act == "swiglu":
        p["w3"] = normal((d, f)) * s1
    return p


def mlp_block(x, p, cfg):
    h = x @ p["w1"].to(x.dtype)
    if cfg.act == "swiglu":
        h = F.silu(h) * (x @ p["w3"].to(x.dtype))
    elif cfg.act == "sq_relu":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    return h @ p["w2"].to(x.dtype)
