"""Top-level model (port of ``src/repro/models/model.py``): embeddings,
stack, head; ``apply`` in three modes.

  * ``train``   — tokens (B,S) → logits (B,S,V)
  * ``prefill`` — builds the decode cache, returns last-position logits
  * ``decode``  — one token per sequence against the cache

Parameters are plain nested dicts/tuples of tensors with the JAX package's
tree structure (``models.bridge`` converts a JAX tree into one).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import transformer as T
from repro_torch.models.layers import apply_norm, norm_spec
from repro_torch.models.schema import ParamSpec, init_tree, param_count
from repro_torch.tree import tree_map


class Model:
    def __init__(self, cfg):
        if cfg.encoder_decoder or cfg.frontend != "none":
            raise NotImplementedError("encoder–decoder and frontend models "
                                      "are not ported yet")
        self.cfg = cfg

    # ------------------------------------------------------------- params
    def spec(self) -> dict:
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_size
        spec: Dict[str, Any] = {
            "embed": ParamSpec((v, d), ("vocab_table", "embed_shard"), scale=1.0,
                               fan_in_axis=-1),
            "stack": T.stack_spec(cfg),
            "final_ln": norm_spec(cfg),
        }
        if not cfg.tie_embeddings:
            spec["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
        return spec

    def init(self, gen: torch.Generator):
        """Random parameters on ``gen.device``, drawn from ``gen``."""
        return init_tree(self.spec(), gen, self.cfg.param_dtype)

    def n_params(self) -> int:
        return param_count(self.spec())

    # -------------------------------------------------------------- cache
    def cache_spec(self, batch: int, max_len: int):
        return {
            "stack": T.stack_cache_spec(self.cfg, batch, max_len),
            "pos": ((batch,), torch.int32),
        }

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        return tree_map(lambda s: torch.zeros(s[0], dtype=s[1], device=device),
                        self.cache_spec(batch, max_len), is_leaf=T._is_shape_dtype)

    # ------------------------------------------------------------ forward
    def _embed(self, params, tokens):
        # gather, then cast: the same values as casting the table first
        return F.embedding(tokens, params["embed"]).to(self.cfg.compute_dtype)

    def _head(self, params, x):
        cfg = self.cfg
        x = apply_norm(params["final_ln"], x)
        if cfg.tie_embeddings:
            return x @ params["embed"].to(cfg.compute_dtype).T
        return x @ params["lm_head"].to(cfg.compute_dtype)

    def apply(self, params: dict, batch: Dict[str, torch.Tensor], *,
              mode: str = "train", cache: Optional[dict] = None,
              max_len: Optional[int] = None):
        """Returns (logits, new_cache). batch: {"tokens": (B,S) int}; decode
        takes tokens (B,1) and the cache, which it updates in place."""
        tokens = batch["tokens"]
        B = tokens.shape[0]
        x = self._embed(params, tokens)
        S = x.shape[1]
        if mode == "decode":
            if cache is None:
                raise ValueError("decode needs a cache")
            positions = cache["pos"][:, None]  # (B,1)
        else:
            positions = torch.arange(S, device=x.device)[None, :].expand(B, S)

        x, new_stack_cache = T.apply_stack(
            params["stack"], self.cfg, x, positions=positions,
            caches=cache["stack"] if cache is not None else None,
            mode=mode, max_len=max_len,
        )
        new_cache = None
        if mode == "prefill":
            logits = self._head(params, x[:, -1:])  # last position only
            new_cache = {
                "stack": new_stack_cache,
                "pos": torch.full((B,), S, dtype=torch.int32, device=x.device),
            }
        elif mode == "decode":
            logits = self._head(params, x)
            new_cache = {"stack": new_stack_cache, "pos": cache["pos"] + 1}
        else:
            logits = self._head(params, x)
        return logits, new_cache


def build_model(cfg) -> Model:
    return Model(cfg)
