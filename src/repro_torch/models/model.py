"""Model assembly of the dense decoder: init, forward, prefill, decode.

The ``dense`` family of the reference's ``repro/models/model.py`` with a
uniform attention pattern (every layer global, or every layer the same
sliding window).  Parameters keep the reference's pytree layout, a dict
whose ``blocks`` entry stacks every layer's tensors on a leading axis, so
a reference parameter tree carries across as numpy arrays
(``repro_torch.convert.model_params``).  The stacks are Python loops over
the layers; PyTorch runs eagerly, so no remat and no scan.

The KV cache is ``{"k", "v": (L, B, Smax, Hkv, dh), "len": int}``; prefill
and decode write it in place (the reference returns a new one) and return
it with the new length.  The length stays on the host, so a decode step
places its write without a device sync.

Other families (moe, vlm, encdec, hybrid, ssm) and the mixed
local/global stack raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name) -> torch.dtype:
    return DTYPES[name] if isinstance(name, str) else name


def _require_dense(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port has the "
            f"dense decoder (ROADMAP Queue 1: remaining families)")


def _require_uniform(cfg):
    if cfg.sliding_window > 0 and not layer_is_global(cfg).all():
        raise NotImplementedError(
            "the mixed local/global stack (gemma3) is not ported yet "
            "(ROADMAP Queue 1: remaining families and the mixed "
            "local/global cache)")


# ---------------------------------------------------------------------------
# Layer pattern helpers
# ---------------------------------------------------------------------------


def layer_is_global(cfg) -> np.ndarray:
    """Per-layer flag: True => full (global) attention."""
    n = cfg.num_layers
    if cfg.sliding_window and cfg.global_layer_every:
        i = np.arange(n)
        return (i % cfg.global_layer_every) == (cfg.global_layer_every - 1)
    return np.ones(n, bool)


def _layer(tree, i):
    """Layer ``i`` of a stacked parameter dict (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_params(cfg, seed=0, *, device=None):
    """Random float32 parameters at ``cfg``'s widths, with the reference's
    shapes and scales (``init_params``, ``attn_params``, ``mlp_params``),
    drawn from a ``torch.Generator`` seeded with ``seed`` (the numbers
    differ from the reference's JAX keys).  ``device="meta"`` allocates
    nothing."""
    _require_dense(cfg)
    dev = torch.device("meta") if device == "meta" else \
        resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    Lr, Vp, D = cfg.num_layers, cfg.padded_vocab, cfg.d_model

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev)

    def stacked(shape):
        return normal((Lr, *shape))

    def norms():
        p = L.norm_params(D, cfg.norm, device=dev)
        return {k: v.expand(Lr, D).clone() for k, v in p.items()}

    def stack_dict(p):
        return {k: (v.expand(Lr, *v.shape).clone() if v.dim() == 1 else v)
                for k, v in p.items()}

    params = {"embed": normal((Vp, D)) * 0.02,
              "final_norm": L.norm_params(D, cfg.norm, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, Vp)) * 0.02
    params["blocks"] = {"ln1": norms(),
                        "attn": stack_dict(L.attn_params(stacked, cfg)),
                        "ln2": norms(),
                        "mlp": L.mlp_params(stacked, cfg)}
    return params


def count_params(cfg, active_only=False) -> int:
    """Parameter count of ``init_params(cfg)``, on the meta device."""
    shapes = init_params(cfg, device="meta")

    def leaves(t):
        for v in t.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))

    return sum(int(x.numel()) for x in leaves(shapes))


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_tokens(params, tokens, cfg):
    return params["embed"][tokens].to(dtype_of(cfg.dtype))


def logits_out(params, x, cfg):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.arange(cfg.padded_vocab, device=x.device) \
            < cfg.vocab_size
        logits = torch.where(mask, logits, -1e30)
    return logits


# ---------------------------------------------------------------------------
# The attention stack
# ---------------------------------------------------------------------------


def _attn_block_apply(x, bp, cfg, *, positions, window, causal, cache=None,
                      cache_len=None, use_ref=False):
    """One transformer block.  Returns ``(x, cache)``; a dense block has
    no auxiliary loss."""
    h, cache = L.attention_block(
        L.norm(x, bp["ln1"], cfg.norm), bp["attn"], cfg,
        positions=positions, causal=causal, window=window, cache=cache,
        cache_len=cache_len, use_ref=use_ref)
    x = x + h
    if cfg.num_experts:
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP "
                                  "Queue 1: remaining families)")
    h = L.mlp_block(L.norm(x, bp["ln2"], cfg.norm), bp["mlp"], cfg)
    return x + h, cache


def _stack_train(x, blocks, cfg, positions, *, causal=True, use_ref=False):
    """Every layer in order, no cache."""
    _require_uniform(cfg)
    for i in range(cfg.num_layers):
        x, _ = _attn_block_apply(x, _layer(blocks, i), cfg,
                                 positions=positions,
                                 window=cfg.sliding_window or None,
                                 causal=causal, use_ref=use_ref)
    return x


def _stack_with_cache(x, blocks, cfg, positions, cache, *, use_ref=False):
    """Every layer in order, writing its KV cache (prefill S > 1 or decode
    S = 1).  Returns ``(x, cache)``."""
    _require_uniform(cfg)
    clen = cache["len"]
    for i in range(cfg.num_layers):
        x, _ = _attn_block_apply(
            x, _layer(blocks, i), cfg, positions=positions,
            window=cfg.sliding_window or None, causal=True,
            cache={"k": cache["k"][i], "v": cache["v"][i]}, cache_len=clen,
            use_ref=use_ref)
    return x, dict(cache, len=clen + x.shape[1])


# ---------------------------------------------------------------------------
# Public API: forward / caches / decode
# ---------------------------------------------------------------------------


def forward(params, batch, cfg, mode="train", *, use_ref=False):
    """batch: ``{"tokens": (B, S)}``.  Returns ``{"logits", "aux_loss"}``
    and, when ``mode == "prefill"``, also ``"cache"`` (sized ``S``).
    ``use_ref=True`` runs attention's flash path on the kernel's plain
    version."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device)
    out = {}
    if mode == "prefill":
        cache = init_cache(cfg, B, S, dtype=cfg.dtype, device=tokens.device)
        x, out["cache"] = _stack_with_cache(
            x, params["blocks"], cfg, positions, cache, use_ref=use_ref)
    else:
        x = _stack_train(x, params["blocks"], cfg, positions,
                         use_ref=use_ref)
    x = L.norm(x, params["final_norm"], cfg.norm)
    out.update(logits=logits_out(params, x, cfg),
               aux_loss=torch.zeros((), dtype=torch.float32,
                                    device=x.device))
    return out


def init_cache(cfg, batch, max_len, dtype=torch.bfloat16, *, device=None):
    """Zero KV cache sized for ``max_len`` total positions."""
    _require_dense(cfg)
    _require_uniform(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dt = dtype_of(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "len": 0}


def decode_step(params, cache, tokens, cfg):
    """One decode step.  tokens: (B, 1).  Returns ``(logits (B, 1, Vp),
    cache)``; the cache is written in place."""
    _require_dense(cfg)
    B = tokens.shape[0]
    x = embed_tokens(params, tokens, cfg)
    positions = torch.full((B, 1), cache["len"], dtype=torch.int64,
                           device=tokens.device)
    x, cache = _stack_with_cache(x, params["blocks"], cfg, positions, cache)
    x = L.norm(x, params["final_norm"], cfg.norm)
    return logits_out(params, x, cfg), cache
