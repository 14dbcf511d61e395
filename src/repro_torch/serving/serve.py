"""Serving: prefill + batched greedy decode with a linear KV cache.

The reference's ``repro/serving/serve.py`` for the dense decoder.  Greedy
decoding takes the first maximal logit, as ``argmax`` does in both
frameworks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import model as M


def make_prefill_step(cfg):
    """``(params, batch) -> (first tokens (B,) int32, cache)``."""
    def prefill_step(params, batch):
        out = M.forward(params, batch, cfg, mode="prefill")
        last = out["logits"][:, -1]
        return torch.argmax(last, dim=-1).to(torch.int32), out["cache"]
    return prefill_step


def make_serve_step(cfg):
    """One decode step: ``(params, cache, tokens (B, 1)) -> (next (B, 1)
    int32, cache)``."""
    def serve_step(params, cache, tokens):
        logits, cache = M.decode_step(params, cache, tokens, cfg)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], cache
    return serve_step


def grow_cache(cache, cache_len):
    """The linear caches padded with zeros to ``cache_len`` positions."""
    pad = cache_len - cache["k"].shape[2]
    return dict(cache, **{n: F.pad(cache[n], (0, 0, 0, 0, 0, pad))
                          for n in ("k", "v")})


def generate(params, cfg, prompt, steps, cache_len=None):
    """Prefill a prompt, then greedy-decode.

    prompt: (B, S) int32.  Returns (B, steps) generated tokens in the
    prompt's dtype.

    ``cache_len`` sizes the linear KV caches (sequence axis) instead of
    the tight fit of ``S + steps``: serving stacks allocate one bucketed
    cache length and reuse it across requests.  It must hold the whole
    generation; the extra slots are inert (attention masks positions past
    the write cursor).
    """
    B, S = prompt.shape
    max_len = S + steps
    if cache_len is None:
        cache_len = max_len
    if cache_len < max_len:
        raise ValueError(
            f"cache_len={cache_len} cannot hold prompt ({S}) + "
            f"generated ({steps}) tokens; need >= {max_len}")
    out = M.forward(params, {"tokens": prompt}, cfg, mode="prefill")
    cache = grow_cache(out["cache"], cache_len)
    tok = torch.argmax(out["logits"][:, -1], dim=-1).to(prompt.dtype)[:, None]
    del out
    outs = [tok]
    step = make_serve_step(cfg)
    for _ in range(steps - 1):
        tok, cache = step(params, cache, tok)
        tok = tok.to(prompt.dtype)
        outs.append(tok)
    return torch.cat(outs, dim=1)
