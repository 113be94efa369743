"""The port's model stack (``repro_torch.models``) against ``repro.models``
on the same weights: JAX's qwen3-1.7b:smoke parameters, bridged through
numpy. Compute in f32 on both sides, so the tolerance (1e-4, atol and rtol)
covers only summation order; the port runs its plain kernel versions here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.config import get_config as jax_config
from repro.models.model import build_model as jax_model
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.config import get_config
from repro_torch.models.model import build_model
from repro_torch.tree import tree_leaves, tree_map

TOL = 1e-4


_PAIRS = {}


def _pair(scan_layers=False):
    """(jax model, jax params, port model, port params) on the same weights:
    qwen3-1.7b:smoke (2 layers) at f32 compute, built once per layout."""
    if scan_layers not in _PAIRS:
        jcfg = jax_config("qwen3-1.7b:smoke").with_(
            scan_layers=scan_layers, compute_dtype=jnp.float32)
        tcfg = get_config("qwen3-1.7b:smoke").with_(
            scan_layers=scan_layers, compute_dtype=torch.float32)
        jm = jax_model(jcfg)
        jp = jax.jit(jm.init)(jax.random.key(0))
        tm = build_model(tcfg)
        tp = from_jax_params(jax.device_get(jp), tcfg, device="cpu")
        _PAIRS[scan_layers] = (jm, jp, tm, tp)
    return _PAIRS[scan_layers]


def _japply(jm, jp, tokens, *, mode, cache=None, max_len=None):
    """The JAX model's ``apply``, jitted (one compile instead of op-by-op)."""
    fn = jax.jit(lambda p, t, c: jm.apply(p, {"tokens": t}, mode=mode, cache=c,
                                          max_len=max_len))
    return fn(jp, jnp.asarray(tokens), cache)


def _tokens(B, S, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _sorted(t):
    """The tree with dict keys sorted: jax.tree.leaves' leaf order."""
    if isinstance(t, dict):
        return {k: _sorted(t[k]) for k in sorted(t)}
    if isinstance(t, (tuple, list)):
        return type(t)(_sorted(x) for x in t)
    return t


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_config_fields_match_jax():
    for name in ("qwen3-1.7b", "qwen3-1.7b:smoke"):
        jc, tc = jax_config(name), get_config(name)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "vocab_size", "head_dim", "qk_norm", "rope_theta", "mlp_kind",
                  "norm_kind", "scan_layers", "tie_embeddings"):
            assert getattr(jc, f) == getattr(tc, f), (name, f)
    assert build_model(get_config("qwen3-1.7b")).n_params() == \
        jax_model(jax_config("qwen3-1.7b")).n_params()


@pytest.mark.parametrize("scan_layers", [False, True])
def test_bridge_round_trips_jax_params(scan_layers):
    jm, jp, tm, tp = _pair(scan_layers=scan_layers)
    assert ("scan" in tp["stack"]) == scan_layers
    flat_j = jax.tree.leaves(jax.device_get(jp))
    flat_t = tree_leaves(_sorted(tp))
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        assert b.dtype == torch.float32 and np.array_equal(np.asarray(a), b.numpy())
    # the bridged tree has the port's own spec structure and shapes
    spec_shapes = tree_map(lambda s: s.shape, tm.spec(),
                           is_leaf=lambda x: hasattr(x, "init"))
    tree_map(lambda shp, t: None if tuple(t.shape) == shp else pytest.fail(
        f"{tuple(t.shape)} != {shp}"), spec_shapes, tp,
        is_leaf=lambda x: isinstance(x, tuple) and all(isinstance(i, int) for i in x))
    with pytest.raises(ValueError):
        from_jax_params({"embed": np.zeros((3, 3), np.float32)}, tm.cfg, device="cpu")


@pytest.mark.parametrize("scan_layers", [False, True])
def test_train_logits_match_jax(scan_layers):
    jm, jp, tm, tp = _pair(scan_layers=scan_layers)
    toks = _tokens(2, 24, seed=1)
    want, _, _ = _japply(jm, jp, toks, mode="train")
    got, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, mode="train")
    _close(got, want)


def test_prefill_then_decode_match_jax():
    jm, jp, tm, tp = _pair()
    toks = _tokens(2, 17, seed=2)
    jl, jc, _ = _japply(jm, jp, toks[:, :16], mode="prefill", max_len=24)
    tl, tc = tm.apply(tp, {"tokens": torch.from_numpy(toks[:, :16])}, mode="prefill",
                      max_len=24)
    _close(tl, jl)
    # the two caches agree by value, leaf for leaf
    for a, b in zip(jax.tree.leaves(jax.device_get(jc)),
                    tree_leaves(_sorted(tc))):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   atol=TOL, rtol=TOL)
    nxt = toks[:, 16:]
    jd, _, _ = _japply(jm, jp, nxt, mode="decode", cache=jc)
    td, tc2 = tm.apply(tp, {"tokens": torch.from_numpy(nxt)}, mode="decode", cache=tc)
    _close(td, jd)
    assert tc2["pos"].tolist() == [17, 17]


def test_prefill_past_flash_threshold_matches_jax():
    """S = 2304 > FLASH_THRESHOLD: JAX runs _flash_attention_qchunked, the
    port its flash entry point (the plain version on the CPU)."""
    S = L.FLASH_THRESHOLD + 256
    jm, jp, tm, tp = _pair()
    toks = _tokens(1, S, seed=3)
    before = fa.LAUNCHES
    calls = []
    real = L.ops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    L.ops.flash_attention = spy
    try:
        tl, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, mode="prefill",
                         max_len=S + 4)
    finally:
        L.ops.flash_attention = real
    assert len(calls) == tm.cfg.num_layers and fa.LAUNCHES == before
    jl, _, _ = _japply(jm, jp, toks, mode="prefill", max_len=S + 4)
    _close(tl, jl)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_decode_matches_train(scan_layers):
    """Port of tests/test_arch_smoke.py::test_decode_matches_train."""
    cfg = get_config("qwen3-1.7b:smoke").with_(
        num_layers=4, scan_layers=scan_layers, compute_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    B, S = 2, 32
    toks = torch.from_numpy(_tokens(B, S, seed=4))
    full, _ = model.apply(params, {"tokens": toks}, mode="train")
    plog, cache = model.apply(params, {"tokens": toks[:, : S - 1]}, mode="prefill",
                              max_len=S + 4)
    dlog, _ = model.apply(params, {"tokens": toks[:, S - 1:]}, mode="decode",
                          cache=cache)
    assert float((plog[:, -1] - full[:, -2]).abs().max()) < 1e-3
    assert float((dlog[:, -1] - full[:, -1]).abs().max()) < 1e-3


def test_init_cache_layout_and_unported_families():
    cfg = get_config("qwen3-1.7b:smoke").with_(num_layers=4, scan_layers=True)
    c = build_model(cfg).init_cache(2, 8, device="cpu")
    assert c["stack"]["scan"][0]["kv"]["k"].shape == (4, 2, 8, 2, 16)
    assert c["pos"].dtype == torch.int32
    with pytest.raises(NotImplementedError):
        build_model(cfg.with_(block_pattern=("mamba",))).spec()
    with pytest.raises(NotImplementedError):
        build_model(cfg.with_(encoder_decoder=True))
