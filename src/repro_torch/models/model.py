"""Top-level model (port of ``src/repro/models/model.py``): embeddings,
stack, head, loss; ``apply`` in three modes.

  * ``train``   — tokens (B,S) [+ stub frontend embeddings] → logits (B,S,V)
  * ``prefill`` — builds the decode cache, returns last-position logits
  * ``decode``  — one token per sequence against the cache

``train_loss`` runs the stack in train mode and the head and
cross-entropy over sequence chunks (``chunked_lm_loss``), never holding
the (B, S, V) logits, and adds the MoE aux losses. A vision model takes
its stub frontend embeddings (B, frontend_seq, D) as ``batch["frontend"]``,
prepended to the tokens outside decode; its loss covers the text positions
only. An audio encoder–decoder takes them as the encoder's input
(``encode``, outside decode); the decoder's cross-attention reads the
encoder's output, and the encoder's aux losses come back ``enc_``-prefixed
and join the loss.

Parameters are plain nested dicts/tuples of tensors with the JAX package's
tree structure (``models.bridge`` converts a JAX tree into one), or the
same trees of DTensors placed by ``repro_torch.sharding`` rules; the
embedding, the head and every layer's residual output then carry the
reference's activation constraints (``lac``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import transformer as T
from repro_torch.models.layers import apply_norm, norm_spec, remat
from repro_torch.models.schema import (ParamSpec, abstract_tree, axes_tree, init_tree,
                                       param_count)
from repro_torch.sharding import lac, lac_grad
from repro_torch.spans import span
from repro_torch.tree import tree_map


class Model:
    def __init__(self, cfg):
        self.cfg = cfg

    # ------------------------------------------------------------- params
    def spec(self) -> dict:
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_size
        spec: Dict[str, Any] = {
            "embed": ParamSpec((v, d), ("vocab_table", "embed_shard"), scale=1.0,
                               fan_in_axis=-1),
            "stack": T.stack_spec(cfg, decoder=cfg.encoder_decoder),
            "final_ln": norm_spec(cfg),
        }
        if not cfg.tie_embeddings:
            spec["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
        if cfg.encoder_decoder:
            spec["enc_stack"] = T.stack_spec(cfg, cfg.num_encoder_layers)
            spec["enc_ln"] = norm_spec(cfg)
        return spec

    def init(self, gen: torch.Generator):
        """Random parameters on ``gen.device``, drawn from ``gen``."""
        return init_tree(self.spec(), gen, self.cfg.param_dtype)

    def abstract_params(self):
        """The params as ``meta`` tensors: shapes and dtypes, no storage."""
        return abstract_tree(self.spec(), self.cfg.param_dtype)

    def param_axes(self):
        return axes_tree(self.spec())

    def n_params(self) -> int:
        return param_count(self.spec())

    # -------------------------------------------------------------- cache
    def cache_spec(self, batch: int, max_len: int):
        return {
            "stack": T.stack_cache_spec(self.cfg, batch, max_len,
                                        decoder=self.cfg.encoder_decoder),
            "pos": ((batch,), torch.int32),
        }

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        return tree_map(lambda s: torch.zeros(s[0], dtype=s[1], device=device),
                        self.cache_spec(batch, max_len), is_leaf=T._is_shape_dtype)

    def cache_axes(self):
        return {
            "stack": T.stack_cache_axes(self.cfg, decoder=self.cfg.encoder_decoder),
            "pos": ("cache_batch",),
        }

    # ------------------------------------------------------------ forward
    def _embed(self, params, tokens):
        with span("model.embed"):
            # gather, then cast: the same values as casting the table first
            x = embed_lookup(tokens, params["embed"])
            return lac(x, "batch", "act_seq", "embed_shard").to(self.cfg.compute_dtype)

    def _head(self, params, x):
        cfg = self.cfg
        with span("model.head"):
            x = apply_norm(params["final_ln"], x)
            if cfg.tie_embeddings:
                logits = x @ params["embed"].to(cfg.compute_dtype).T
            else:
                logits = x @ params["lm_head"].to(cfg.compute_dtype)
            # the product's gradient returns as the product made it, whole
            # along the sequence, not at the logits' placements (``lac_grad``)
            logits = lac_grad(logits, "batch", "seq", "logit_vocab")
            return lac(logits, "batch", "act_seq", "logit_vocab")

    def encode(self, params, frames):
        """frames (B,F,D) stub embeddings → (enc_out (B,F,D), aux). The
        encoder's stack runs in train mode with non-causal self-attention,
        as JAX's; above the flash threshold that attention launches the
        flash kernel unless autograd records (``layers.apply_attention``)."""
        cfg = self.cfg
        x = frames.to(cfg.compute_dtype)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        x, _, aux = T.apply_stack(params["enc_stack"], cfg, x, positions=pos,
                                  mode="train", causal=False)
        return apply_norm(params["enc_ln"], x), aux

    def _encoded(self, params, batch, mode):
        """(enc_out, {"enc_…": aux}) of an encoder–decoder outside decode,
        else (None, {})."""
        if not self.cfg.encoder_decoder or mode == "decode":
            return None, {}
        enc_out, enc_aux = self.encode(params, batch["frontend"])
        return enc_out, {f"enc_{k}": v for k, v in enc_aux.items()}

    def _inputs(self, params, batch, mode):
        """Embedded tokens, with the vision frontend prepended outside
        decode, and their positions."""
        tokens = batch["tokens"]
        B = tokens.shape[0]
        x = self._embed(params, tokens)
        if self.cfg.frontend == "vision" and mode != "decode":
            fe = batch["frontend"].to(self.cfg.compute_dtype)  # (B,F,D) patches
            x = torch.cat([fe, x], 1)
        S = x.shape[1]
        return x, torch.arange(S, device=x.device)[None, :].expand(B, S)

    def apply(self, params: dict, batch: Dict[str, torch.Tensor], *,
              mode: str = "train", cache: Optional[dict] = None,
              max_len: Optional[int] = None):
        """Returns (logits, new_cache, aux). batch: {"tokens": (B,S) int},
        and for a vision or audio model {"frontend": (B,F,D)} outside
        decode; decode takes tokens (B,1) and the cache, which it updates in
        place. aux: the MoE losses summed over the layers (0 without MoE),
        and an encoder–decoder's encoder's under ``enc_`` keys."""
        enc_out, aux = self._encoded(params, batch, mode)
        x, positions = self._inputs(params, batch, mode)
        B, S = x.shape[:2]
        if mode == "decode":
            if cache is None:
                raise ValueError("decode needs a cache")
            positions = cache["pos"][:, None]  # (B,1)

        with span("model.stack"):
            x, new_stack_cache, saux = T.apply_stack(
                params["stack"], self.cfg, x, positions=positions,
                caches=cache["stack"] if cache is not None else None,
                mode=mode, enc_out=enc_out, max_len=max_len,
            )
        aux.update(saux)
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
        return logits, new_cache, aux

    def train_loss(self, params: dict, batch: Dict[str, torch.Tensor], *,
                   chunk: int = 1024):
        """Memory-lean train loss: the stack in train mode, then the head and
        cross-entropy over rematerialised sequence chunks, plus the MoE aux
        losses (an encoder–decoder's encoder's too). batch: tokens and labels
        (B,S) int, optional loss_mask (B,S), and a vision or audio model's
        frontend (B,F,D). Returns (loss, metrics)."""
        enc_out, aux = self._encoded(params, batch, "train")
        x, positions = self._inputs(params, batch, "train")
        x, _, saux = T.apply_stack(params["stack"], self.cfg, x, positions=positions,
                                   mode="train", enc_out=enc_out)
        aux.update(saux)
        if self.cfg.frontend == "vision":
            x = x[:, self.cfg.frontend_seq:]  # loss over text positions only
        loss, metrics = chunked_lm_loss(self, params, x, batch["labels"],
                                        batch.get("loss_mask"), chunk=chunk)
        for k in ("moe_aux", "moe_z", "enc_moe_aux", "enc_moe_z"):
            if k in aux:
                loss = loss + aux[k]
                metrics[k] = aux[k]
        return loss, metrics


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``. Over a vocab-sharded DTensor table it
    is the reference's partitioned gather: each shard looks up the tokens
    that fall in its rows and zeroes the rest, a partial sum that the
    caller's ``lac`` reduces (``local_map``, whose backward writes each
    shard's rows; DTensor's own embedding gives a masked partial that the
    ops after it and its backward cannot take). A table sharded over its
    feature dim is gathered there first (tokens own that mesh dim)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    tab_pl = tuple(Replicate() if p == Shard(1) else p for p in table.placements)
    tok_pl = tuple(Replicate() if tp == Shard(0) else p
                   for p, tp in zip(tokens.placements, tab_pl))
    table = table.redistribute(mesh, tab_pl)
    tokens = tokens.redistribute(mesh, tok_pl)
    out_pl = [Partial() if tp == Shard(0) else p for p, tp in zip(tok_pl, tab_pl)]
    # a shard's table grad sums its own tokens' rows only: a partial sum over
    # each mesh dim that splits the tokens
    grad_pl = tuple(Partial() if isinstance(p, Shard) else tp for p, tp in zip(tok_pl, tab_pl))
    rows, (lo, _) = compute_local_shape_and_global_offset(table.shape, mesh, tab_pl)

    def lookup(tok, tab):
        rel = tok.long() - lo
        hit = (rel >= 0) & (rel < rows[0])
        out = F.embedding(torch.where(hit, rel, 0), tab)
        return torch.where(hit[..., None], out, 0)

    return local_map(lookup, out_placements=out_pl, in_placements=(tok_pl, tab_pl),
                     in_grad_placements=(tok_pl, grad_pl), device_mesh=mesh)(tokens, table)


def build_model(cfg) -> Model:
    return Model(cfg)


# ------------------------------------------------------------------- loss
def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim, as log Σ exp(x − max) + max with the max
    held constant (its gradient cancels): over vocab-sharded logits it takes
    two reductions of (B, S) across the shards where ``torch.logsumexp``
    would gather the logits."""
    m = lac(x.detach().amax(-1, keepdim=True), "batch", "act_seq", None)
    return lac((x - m).exp().sum(-1), "batch", "act_seq").log() + m[..., 0]


def _label_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The logit of each label in f32: the value JAX's one-hot einsum
    picks, gathered instead."""
    picked = logits.gather(-1, labels.long()[..., None])
    # over a vocab-sharded DTensor the gather is a masked partial sum that
    # must be reduced before any other op reads it
    return lac(picked, "batch", "act_seq", None)[..., 0].float()


def chunked_lm_loss(model: Model, params: dict, x: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, *, chunk: int = 1024,
                    z_weight: float = 1e-4):
    """Head + cross-entropy over sequence chunks, each rematerialised: the
    (B, chunk, V) logits exist only transiently. z-loss z_weight·lse²;
    S % chunk != 0 falls back to one chunk. Returns (loss, {ce, zloss})."""
    B, S, _ = x.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    if S % chunk != 0:
        chunk = S  # fallback: single chunk

    def one(xx, ll, mm):
        # the chunk whole along its sequence into the head's product, as a
        # sublayer's input: a split sequence would flatten into a strided
        # shard in the product's backward
        logits = model._head(params, lac(xx, "batch", "seq", None))  # (B,chunk,V)
        lse = _logsumexp(logits.float())
        ce = ((lse - _label_logits(logits, ll)) * mm).sum()
        zz = ((lse ** 2) * mm).sum()
        return ce, zz, mm.sum()

    parts = [remat(one, x[:, c:c + chunk], labels[:, c:c + chunk],
                   mask[:, c:c + chunk].float()) for c in range(0, S, chunk)]
    ces, zzs, cnts = (torch.stack(t) for t in zip(*parts))
    denom = torch.clamp_min(cnts.sum(), 1.0)
    loss = ces.sum() / denom
    zloss = z_weight * zzs.sum() / denom
    return loss + zloss, {"ce": loss, "zloss": zloss}


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None, z_weight: float = 1e-4):
    """Cross-entropy of (B,S,V) logits at labels (B,S), with the z-loss;
    mask (B,S) {0,1}. Returns (loss, {ce, zloss})."""
    lse = _logsumexp(logits.float())  # (B,S)
    ce = lse - _label_logits(logits, labels)
    mask = torch.ones_like(ce) if mask is None else mask.float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = (ce * mask).sum() / denom
    zloss = z_weight * ((lse ** 2) * mask).sum() / denom
    return loss + zloss, {"ce": loss, "zloss": zloss}
