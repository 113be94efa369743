"""Serving steps (port of ``src/repro/serve/step.py``): prefill (cache
build), single-token decode, and the greedy ``generate`` loop."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.model import Model
from repro_torch.sharding import lac
from repro_torch.spans import span


def make_prefill_step(model: Model, max_len: int):
    def prefill_step(params, batch):
        with span("serve.prefill"):
            logits, cache, _ = model.apply(params, batch, mode="prefill", max_len=max_len)
        return logits, cache

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, tokens):
        """tokens (B,1) → (next_token (B,1), logits (B,1,V), new_cache).
        The cache is updated in place."""
        logits, new_cache, _ = model.apply(params, {"tokens": tokens}, mode="decode",
                                           cache=cache)
        return _greedy(logits), logits, new_cache

    return decode_step


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    # over vocab-sharded DTensor logits the argmax reads the whole row: the
    # last position's logits are gathered over the vocab first
    last = lac(logits[:, -1], "batch", None)
    return torch.argmax(last, dim=-1).to(torch.int32)[:, None]


@torch.inference_mode()
def generate(model: Model, params, prompt_tokens, *, steps: int, max_len: int,
             batch_extra: Optional[Dict[str, Any]] = None, kv_store=None):
    """Greedy generation loop; tokens (B, steps) int32 on the prompt's device.
    ``batch_extra`` joins the prefill's batch (a vision model's
    ``{"frontend": (B,F,D)}``).

    With ``kv_store`` (a ``repro_torch.serve.kvstore.KvCacheStore``) the
    loop runs disaggregated: if the store already holds a cache for this
    exact prompt the prefill is skipped (decode attaches and streams it back
    from OffloadFS); otherwise prefill runs, the cache is offloaded under a
    write lease, the local copy is dropped, and decode proceeds from the
    fetched copy.
    """
    batch = {"tokens": prompt_tokens}
    if batch_extra:
        batch.update(batch_extra)
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
