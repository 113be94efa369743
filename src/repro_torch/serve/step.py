"""Serving steps (port of ``src/repro/serve/step.py``): prefill (cache
build), single-token decode, and the greedy ``generate`` loop."""
from __future__ import annotations

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model, max_len: int):
    def prefill_step(params, batch):
        logits, cache = model.apply(params, batch, mode="prefill", max_len=max_len)
        return logits, cache

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, tokens):
        """tokens (B,1) → (next_token (B,1), logits (B,1,V), new_cache).
        The cache is updated in place."""
        logits, new_cache = model.apply(params, {"tokens": tokens}, mode="decode",
                                        cache=cache)
        return _greedy(logits), logits, new_cache

    return decode_step


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


@torch.inference_mode()
def generate(model: Model, params, prompt_tokens, *, steps: int, max_len: int,
             kv_store=None):
    """Greedy generation loop; tokens (B, steps) int32 on the prompt's device.

    With ``kv_store`` (a ``repro_torch.serve.kvstore.KvCacheStore``) the
    loop runs disaggregated: if the store already holds a cache for this
    exact prompt the prefill is skipped (decode attaches and streams it back
    from OffloadFS); otherwise prefill runs, the cache is offloaded under a
    write lease, the local copy is dropped, and decode proceeds from the
    fetched copy.
    """
    batch = {"tokens": prompt_tokens}
    prefill = make_prefill_step(model, max_len)
    decode = make_decode_step(model)
    if kv_store is not None and kv_store.contains(prompt_tokens):
        cache = kv_store.fetch(prompt_tokens)
        tok = kv_store.first_token(prompt_tokens)
        if tok is None:
            logits, _ = prefill(params, batch)
            tok = _greedy(logits)
    else:
        logits, cache = prefill(params, batch)
        tok = _greedy(logits)
        if kv_store is not None:
            kv_store.put(prompt_tokens, cache, first_token=tok)
            del cache  # decode must run from the offloaded copy
            cache = kv_store.fetch(prompt_tokens)
    out = [tok]
    for _ in range(steps - 1):
        tok, _, cache = decode(params, cache, tok)
        out.append(tok)
    return torch.cat(out, dim=1)
