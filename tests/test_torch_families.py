"""The model families of the port (the vision frontend, MoE, Mamba-2
SSD, xLSTM and the audio encoder–decoder) against the JAX package on the
same weights: phi-3-vision-4.2b, granite-moe-3b-a800m, grok-1-314b,
jamba-1.5-large-398b, xlstm-125m and seamless-m4t-large-v2, each at
``:smoke``, with the JAX parameters bridged through numpy, at f32 compute
on both sides, so that the tolerance (1e-4, atol and rtol, as
``tests/test_torch_archs.py`` uses) covers only summation order.

Per arch: the config fields and the full-width ``n_params``; ``apply`` in
train, prefill and decode (logits, cache and the MoE aux losses, decode
both from the port's own prefill cache and from the JAX cache bridged by
``from_jax_cache``); ``train_loss`` and its metrics; one AdamW step's
params and moments; greedy ``generate`` (phi-3-vision's and seamless's
with ``batch_extra``). Then: the gelu MLP against ``jax.nn.gelu``; the flash
branch at the full-width head shapes these archs bring (head_dim 96 with
GQA group 1, group 3 at 64, group 6 at 128 with softcap 30); and the KV
store's cache key, which both packages take from the prompt tokens only,
so a vision or audio request with the same text and another frontend is
served the first one's cache (a fault of the reference that the port keeps for
parity). ``tests/test_torch_kernels.py`` holds the flash kernel at those
head shapes against its plain version on the card.
"""
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockDevice as JBlockDevice
from repro.core import OffloadFS as JOffloadFS
from repro.models import layers as JL
from repro.models.config import get_config as jax_config
from repro.models.model import build_model as jax_model
from repro.serve import generate as jax_generate
from repro.serve.kvstore import KvCacheStore as JKvCacheStore
from repro.train import optim as jopt
from repro.train import step as jstep
from repro_torch.core import BlockDevice, OffloadFS
from repro_torch.kernels import build
from repro_torch.models import layers as L
from repro_torch.models.bridge import from_jax_cache, from_jax_params, from_jax_state
from repro_torch.models.config import get_config
from repro_torch.models.model import build_model
from repro_torch.serve import KvCacheStore, generate
from repro_torch.train import optim
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves

TOL = 1e-4
ARCHS = ["phi-3-vision-4.2b", "granite-moe-3b-a800m", "grok-1-314b", "jamba-1.5-large-398b",
         "xlstm-125m", "seamless-m4t-large-v2"]
# the JAX package's n_params() at full width (computed on the CPU)
N_PARAMS = {"phi-3-vision-4.2b": 3_821_079_552, "granite-moe-3b-a800m": 3_374_295_552,
            "grok-1-314b": 213_410_125_824, "jamba-1.5-large-398b": 397_644_798_720,
            "xlstm-125m": 188_954_184, "seamless-m4t-large-v2": 1_632_256_000}
FIELDS = ("name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
          "vocab_size", "head_dim", "qk_norm", "rope_theta", "rotary_pct", "mlp_kind",
          "norm_kind", "attn_logit_softcap", "tie_embeddings", "scan_layers", "remat",
          "max_seq_len", "block_pattern", "frontend", "frontend_seq", "encoder_decoder",
          "num_encoder_layers", "moe_every", "moe_offset", "sub_quadratic")
# prompt lengths: a multiple of jamba:smoke's SSD chunk (32), as prefill needs
# (xlstm's mLSTM chunk is min(64, S))
PROMPT, DECODE = 32, 3

_PAIRS = {}


def _pair(arch):
    """(jax model, jax params, port model, port params) on the same weights,
    ``arch:smoke`` at f32 compute, built once."""
    if arch not in _PAIRS:
        jcfg = jax_config(f"{arch}:smoke").with_(compute_dtype=jnp.float32)
        tcfg = get_config(f"{arch}:smoke").with_(compute_dtype=torch.float32)
        jm, tm = jax_model(jcfg), build_model(tcfg)
        jp = jax.jit(jm.init)(jax.random.key(0))
        _PAIRS[arch] = (jm, jp, tm, from_jax_params(jax.device_get(jp), tcfg, device="cpu"))
    return _PAIRS[arch]


def _tokens(B, S, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _batch(cfg, B, S, seed):
    """numpy batch: tokens, and a vision or audio model's frontend
    embeddings."""
    b = {"tokens": _tokens(B, S, seed)}
    if cfg.frontend != "none":
        b["frontend"] = np.random.default_rng(seed + 100).standard_normal(
            (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _sorted(t):
    """The tree with dict keys sorted: jax.tree.leaves' leaf order."""
    if isinstance(t, dict):
        return {k: _sorted(t[k]) for k in sorted(t)}
    if isinstance(t, (tuple, list)):
        return type(t)(_sorted(x) for x in t)
    return t


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().double().numpy(),
                               np.asarray(want, np.float64), atol=tol, rtol=tol)


def _close_trees(got, want):
    want = jax.tree.leaves(jax.device_get(want))
    got = tree_leaves(_sorted(got))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def _aux_keys(cfg, decode=False):
    """aux's keys: the MoE losses, and an encoder's outside decode."""
    keys = {"moe_aux", "moe_z"}
    return keys | {f"enc_{k}" for k in keys} if cfg.encoder_decoder and not decode else keys


def _prepended(cfg):
    """Frontend positions that sit before the text in the decoder's
    sequence: a vision model's; an audio model's go to the encoder."""
    return cfg.frontend_seq if cfg.frontend == "vision" else 0


def _close_aux(got, want, cfg, decode=False):
    assert set(got) == set(want) == _aux_keys(cfg, decode)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_full_width_n_params_match_jax(arch):
    for name in (arch, f"{arch}:smoke"):
        jc, tc = jax_config(name), get_config(name)
        for f in FIELDS:
            assert getattr(jc, f) == getattr(tc, f), (name, f)
        for sub in ("moe", "mamba", "xlstm"):
            a, b = getattr(jc, sub), getattr(tc, sub)
            assert (a is None) == (b is None), (name, sub)
            if a is not None:
                # JAX's fields equal; the port's own past them at their defaults
                # (dropless, shared_d_ff; conv_bias), which change nothing
                assert vars(a) == {k: v for k, v in vars(b).items() if k in vars(a)}, (name, sub)
                assert all(getattr(b, f.name) == f.default for f in dataclasses.fields(b)
                           if f.name not in vars(a)), (name, sub)
        assert tc.param_dtype == torch.float32 and tc.compute_dtype == torch.bfloat16
    full = build_model(get_config(arch)).n_params()
    assert full == jax_model(jax_config(arch)).n_params() == N_PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_and_aux_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    assert len(tree_leaves(tp)) == len(jax.tree.leaves(jp))
    b = _batch(tm.cfg, 2, PROMPT, seed=1)
    jl, _, jaux = jax.jit(lambda p, b: jm.apply(p, b, mode="train"))(jp, _jb(b))
    tl, tc, taux = tm.apply(tp, _tb(b), mode="train")
    assert tc is None and tl.shape == (2, _prepended(tm.cfg) + PROMPT, 256)
    _close(tl, jl)
    _close_aux(taux, jaux, tm.cfg)
    if tm.cfg.moe is not None:
        assert float(taux["moe_aux"]) > 0 and float(taux["moe_z"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax(arch):
    """Prefill: last logits, every cache leaf, aux. Then DECODE steps, each
    from the port's own cache and from the JAX cache bridged into the
    port's layout (for jamba: mamba conv and SSM states beside one
    attention layer's KV)."""
    jm, jp, tm, tp = _pair(arch)
    cfg = tm.cfg
    b = _batch(cfg, 2, PROMPT + DECODE, seed=2)
    pre = dict(b, tokens=b["tokens"][:, :PROMPT])
    S0 = _prepended(cfg) + PROMPT
    max_len = S0 + 8
    jfn = jax.jit(lambda p, b, c, mode: jm.apply(p, b, mode=mode, cache=c, max_len=max_len),
                  static_argnums=3)
    jl, jc, jaux = jfn(jp, _jb(pre), None, "prefill")
    tl, tc, taux = tm.apply(tp, _tb(pre), mode="prefill", max_len=max_len)
    _close(tl, jl)
    _close_trees(tc, jc)
    _close_aux(taux, jaux, tm.cfg)
    bridged = from_jax_cache(jax.device_get(jc), cfg, 2, max_len, device="cpu")
    for t in range(PROMPT, PROMPT + DECODE):
        nxt = {"tokens": b["tokens"][:, t:t + 1]}
        jl, jc, jaux = jfn(jp, _jb(nxt), jc, "decode")
        tl, tc, taux = tm.apply(tp, _tb(nxt), mode="decode", cache=tc)
        bl, bridged, _ = tm.apply(tp, _tb(nxt), mode="decode", cache=bridged)
        _close(tl, jl)
        _close(bl, jl)
        _close_trees(tc, jc)
        _close_aux(taux, jaux, tm.cfg, decode=True)
    assert tc["pos"].tolist() == [S0 + DECODE] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_metrics_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    b = _batch(tm.cfg, 2, PROMPT + 1, seed=3)
    b = dict(b, tokens=b["tokens"][:, :-1], labels=b["tokens"][:, 1:])
    jl, jmet = jax.jit(jm.train_loss)(jp, _jb(b))
    tl, tmet = tm.train_loss(tp, _tb(b))
    _close(tl, jl)
    assert set(tmet) == set(jmet) == {"ce", "zloss"} | _aux_keys(tm.cfg)
    for k in jmet:
        _close(tmet[k], jmet[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches_jax(arch):
    """One AdamW step (lr 3e-4) from the same init on one batch: loss,
    grad_norm, the aux metrics, every param and both moments.

    AdamW's eps is 1e-6 here, not its default 1e-8: a first step moves a
    param by lr·g/(|g| + eps), and an MoE expert that few tokens reach has
    gradient entries of ~1e-9, at the noise of f32 summation order, whose
    sign that quotient would turn into a move of up to lr either way."""
    jm, jp, tm, tp = _pair(arch)
    jo, to = jopt.adamw(lr=3e-4, eps=1e-6), optim.adamw(lr=3e-4, eps=1e-6)
    js = jstep.init_state(jm, jo, params=jp)
    ts = from_jax_state(jax.device_get(js), tm.cfg, device="cpu")
    b = _batch(tm.cfg, 4, PROMPT + 1, seed=5)
    b = dict(b, tokens=b["tokens"][:, :-1], labels=b["tokens"][:, 1:])
    js, jmet = jax.jit(jstep.make_train_step(jm, jo))(js, _jb(b))
    ts, tmet = make_train_step(tm, to)(ts, _tb(b))
    assert int(ts["step"]) == int(js["step"]) == 1
    for k in ("loss", "grad_norm", "ce", "zloss", *_aux_keys(tm.cfg)):
        _close(tmet[k], jmet[k])
    _close_trees(ts["params"], js["params"])
    for k in ("m", "v"):
        _close_trees(ts["opt"][k], js["opt"][k])


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    b = _batch(tm.cfg, 2, PROMPT, seed=6)
    extra = {k: v for k, v in b.items() if k != "tokens"}
    max_len = _prepended(tm.cfg) + PROMPT + 8
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(b["tokens"]), steps=6,
                                   max_len=max_len, batch_extra=_jb(extra) or None))
    got = generate(tm, tp, torch.from_numpy(b["tokens"]), steps=6, max_len=max_len,
                   batch_extra=_tb(extra) or None)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch,layers", [("jamba-1.5-large-398b", 16),
                                         ("granite-moe-3b-a800m", 2),
                                         ("xlstm-125m", 8),
                                         ("seamless-m4t-large-v2", 3)])
def test_stacked_layout_matches_jax(arch, layers):
    """``scan_layers``, as the full-width configs set it: every leaf stacked
    over the periods in one ``{"scan": period}`` tuple (jamba's period of 8
    mixes mamba and attention, MoE and dense layers; xlstm's of 4 three
    mLSTM and one sLSTM block, whose caches hold tuples of states;
    seamless's decoder and encoder stacks of 3 layers each, the decoder's
    with its cross half). The bridge checks each leaf's shape and dtype;
    train logits and aux, the prefill's stacked cache and a decode step in
    it equal JAX's."""
    depth = dict(num_layers=layers, scan_layers=True)
    if arch == "seamless-m4t-large-v2":
        depth["num_encoder_layers"] = layers
    jcfg = jax_config(f"{arch}:smoke").with_(compute_dtype=jnp.float32, **depth)
    tcfg = get_config(f"{arch}:smoke").with_(compute_dtype=torch.float32, **depth)
    jm, tm = jax_model(jcfg), build_model(tcfg)
    jp = jax.jit(jm.init)(jax.random.key(2))
    tp = from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    assert set(tp["stack"]) == {"scan"} and set(tp.get("enc_stack", {"scan": 0})) == {"scan"}
    assert {tuple(sorted(layer)) for layer in tp["stack"]["scan"]} <= {
        ("attn", "ln1", "ln2", "mlp"), ("attn", "ln1", "ln2", "moe"),
        ("ln1", "ln2", "mamba", "mlp"), ("ln1", "ln2", "mamba", "moe"),
        ("ln1", "mlstm"), ("ln1", "slstm"), ("attn", "cross", "ln1", "ln2", "lnx", "mlp")}
    b = _batch(tcfg, 2, PROMPT + 1, seed=11)
    pre = dict(b, tokens=b["tokens"][:, :PROMPT])
    jl, _, jaux = jax.jit(lambda p, b: jm.apply(p, b, mode="train"))(jp, _jb(pre))
    tl, _, taux = tm.apply(tp, _tb(pre), mode="train")
    _close(tl, jl)
    _close_aux(taux, jaux, tm.cfg)
    jfn = jax.jit(lambda p, b, c, mode: jm.apply(p, b, mode=mode, cache=c, max_len=40),
                  static_argnums=3)
    _, jc, _ = jfn(jp, _jb(pre), None, "prefill")
    _, tc, _ = tm.apply(tp, _tb(pre), mode="prefill", max_len=40)
    _close_trees(tc, jc)
    nxt = {"tokens": b["tokens"][:, PROMPT:]}
    jl, jc, _ = jfn(jp, _jb(nxt), jc, "decode")
    tl, tc, _ = tm.apply(tp, _tb(nxt), mode="decode", cache=tc)
    _close(tl, jl)
    _close_trees(tc, jc)


def test_vision_frontend_sits_before_the_text():
    """phi-3-vision: the frontend rows come first, decode takes none, and
    the train loss counts the text positions only (labels of the text's
    length)."""
    _, _, tm, tp = _pair("phi-3-vision-4.2b")
    cfg = tm.cfg
    b = _tb(_batch(cfg, 1, 8, seed=7))
    full, _, _ = tm.apply(tp, b, mode="train")
    changed = dict(b, frontend=b["frontend"].clone())
    changed["frontend"][:, -1] += 1.0  # the last patch: every text row sees it
    moved, _, _ = tm.apply(tp, changed, mode="train")
    assert torch.equal(full[:, :-9], moved[:, :-9])
    assert not torch.allclose(full[:, -8:], moved[:, -8:])
    loss, _ = tm.train_loss(tp, dict(b, labels=b["tokens"]))
    assert torch.isfinite(loss)


def test_gelu_mlp_matches_jax():
    """mlp_kind "gelu": jax.nn.gelu's tanh approximation, not the exact
    erf form that is torch's default."""
    jc = jax_config("grok-1-314b:smoke").with_(compute_dtype=jnp.float32)
    tc = get_config("grok-1-314b:smoke").with_(compute_dtype=torch.float32)
    spec = L.mlp_spec(tc, d_ff=96)
    assert set(spec) == {"wi", "wo"} and spec["wi"].shape == (64, 96)
    rng = np.random.default_rng(8)
    p = {k: (rng.standard_normal(s.shape) / 4).astype(np.float32) for k, s in spec.items()}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jc, jnp.asarray(x))
    got = L.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()}, tc, torch.from_numpy(x))
    _close(got, want, 1e-5)
    h = torch.from_numpy(x * 3)
    _close(L.gelu(h), jax.nn.gelu(jnp.asarray(x * 3)), 1e-6)
    assert (torch.nn.functional.gelu(h) - L.gelu(h)).abs().max() > 1e-4


# the full-width head shapes of these archs at smoke width otherwise:
# phi-3-vision's MHA at head_dim 96 (group 1), granite-moe's 24 over 8 KV
# heads (group 3) at 64, grok-1's 48 over 8 (group 6) at 128, softcap 30
FULL_HEADS = {"phi-3-vision-4.2b": dict(num_heads=4, num_kv_heads=4, head_dim=96),
              "granite-moe-3b-a800m": dict(num_heads=6, num_kv_heads=2, head_dim=64),
              "grok-1-314b": dict(num_heads=6, num_kv_heads=1, head_dim=128)}


@pytest.mark.parametrize("arch", sorted(FULL_HEADS))
def test_prefill_past_flash_threshold_matches_jax(arch):
    """S past FLASH_THRESHOLD: JAX runs _flash_attention_qchunked, the port
    its flash entry point (the plain version on the CPU) once a layer, at
    the arch's full-width head_dim and GQA group."""
    kw = FULL_HEADS[arch]
    jcfg = jax_config(f"{arch}:smoke").with_(compute_dtype=jnp.float32, **kw)
    tcfg = get_config(f"{arch}:smoke").with_(compute_dtype=torch.float32, **kw)
    full = get_config(arch)
    assert (full.head_dim, full.q_per_kv) == (tcfg.head_dim, tcfg.q_per_kv)
    jm, tm = jax_model(jcfg), build_model(tcfg)
    jp = jax.jit(jm.init)(jax.random.key(1))
    tp = from_jax_params(jax.device_get(jp), tcfg, device="cpu")
    S = L.FLASH_THRESHOLD + 64 - tcfg.frontend_seq
    b = _batch(tcfg, 1, S, seed=9)
    calls, real = [], L.ops.flash_attention

    def spy(*a, **kw):
        calls.append((tuple(a[0].shape), kw.get("softcap")))
        return real(*a, **kw)

    before = build.LAUNCHES["fa_forward"]
    L.ops.flash_attention = spy
    try:
        tl, _, _ = tm.apply(tp, _tb(b), mode="prefill", max_len=S + tcfg.frontend_seq + 4)
    finally:
        L.ops.flash_attention = real
    S_all = S + tcfg.frontend_seq
    shape = (1, S_all, tcfg.num_kv_heads, tcfg.q_per_kv, tcfg.head_dim)
    assert calls == [(shape, tcfg.attn_logit_softcap)] * tcfg.num_layers
    assert build.LAUNCHES["fa_forward"] == before
    jl, _, _ = jax.jit(lambda p, b: jm.apply(p, b, mode="prefill", max_len=S_all + 4))(
        jp, _jb(b))
    _close(tl, jl)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "seamless-m4t-large-v2"])
def test_kv_store_keys_a_vlm_cache_by_its_text_alone(arch):
    """Both packages key a stored cache by the prompt tokens only
    (``kvstore.py``'s ``put``/``contains``), so a second request with the
    same text and another image (phi-3-vision) or other audio frames
    (seamless, whose encoder output the cache's cross half holds) finds the
    first one's cache and is served its tokens. Recorded, not repaired: the
    port keeps the reference's behaviour."""
    jm, jp, tm, tp = _pair(arch)
    b = _batch(tm.cfg, 1, 16, seed=10)
    if tm.cfg.frontend == "vision":  # the same text, another image
        other = dict(b, frontend=b["frontend"][:, ::-1].copy())
    else:  # other frames: reversed ones would encode to the same keys, in another order
        other = dict(b, frontend=_batch(tm.cfg, 1, 16, seed=11)["frontend"])
    max_len = _prepended(tm.cfg) + 16 + 8

    def jgen(batch, store):
        return np.asarray(jax_generate(jm, jp, jnp.asarray(batch["tokens"]), steps=4,
                                       max_len=max_len,
                                       batch_extra={"frontend": jnp.asarray(batch["frontend"])},
                                       kv_store=store))

    def tgen(batch, store):
        return generate(tm, tp, torch.from_numpy(batch["tokens"]), steps=4, max_len=max_len,
                        batch_extra={"frontend": torch.from_numpy(batch["frontend"])},
                        kv_store=store).numpy()

    jstore = JKvCacheStore(JOffloadFS(JBlockDevice(num_blocks=1 << 14), node="init0"))
    tstore = KvCacheStore(OffloadFS(BlockDevice(num_blocks=1 << 14), node="init0"),
                          device="cpu")
    first_j, first_t = jgen(b, jstore), tgen(b, tstore)
    assert np.array_equal(first_j, first_t)
    own_j, own_t = jgen(other, None), tgen(other, None)
    assert np.array_equal(own_j, own_t) and not np.array_equal(own_t, first_t)
    assert jstore.contains(b["tokens"]) and tstore.contains(other["tokens"])
    assert np.array_equal(jgen(other, jstore), first_j)  # served the first image's cache
    assert np.array_equal(tgen(other, tstore), first_t)
    assert jstore.stats.puts == tstore.stats.puts == 1
