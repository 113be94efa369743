"""The three other dense archs of the port (glm4-9b, granite-3-8b,
mistral-nemo-12b) against the JAX package on the same weights: each
``:smoke`` config's JAX parameters, bridged through numpy, at f32 compute
on both sides, so the tolerance (1e-4, atol and rtol, as
``tests/test_torch_model.py`` and ``tests/test_torch_train.py`` use) covers
only summation order. Their shapes are what qwen3-1.7b's are not: GQA
groups of 2 over 2 KV heads at smoke width (16 over 2 on glm4-9b, 4 over 8
on the other two at full width), partial rotary on glm4-9b (``rotary_pct``
0.5: the first half of each head rotates, in interleaved pairs),
``head_dim`` 128 below ``d_model / num_heads`` on mistral-nemo-12b, and no
q/k norm. The port runs its plain kernel versions here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models.config import get_config as jax_config
from repro.models.model import build_model as jax_model
from repro.train import optim as jopt
from repro.train import step as jstep
from repro_torch.kernels import build
from repro_torch.models import layers as L
from repro_torch.models.bridge import from_jax_params, from_jax_state
from repro_torch.models.config import get_config
from repro_torch.models.model import build_model
from repro_torch.train import optim
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves

TOL = 1e-4
ARCHS = ["glm4-9b", "granite-3-8b", "mistral-nemo-12b"]
# the JAX package's n_params() at full width (computed on the CPU)
N_PARAMS = {"glm4-9b": 9_399_767_040, "granite-3-8b": 8_372_187_136,
            "mistral-nemo-12b": 12_247_782_400}
FIELDS = ("name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
          "vocab_size", "head_dim", "qk_norm", "rope_theta", "rotary_pct", "mlp_kind",
          "norm_kind", "attn_logit_softcap", "tie_embeddings", "scan_layers", "remat",
          "max_seq_len", "block_pattern", "frontend", "encoder_decoder")

# each arch's full-width heads (32 over 2 or 8 KV heads: GQA groups of 16
# and 4) at smoke width otherwise
FULL_HEADS = {"glm4-9b": dict(num_heads=32, num_kv_heads=2, head_dim=16),
              "granite-3-8b": dict(num_heads=32, num_kv_heads=8, head_dim=16),
              "mistral-nemo-12b": dict(num_heads=32, num_kv_heads=8, head_dim=16)}

_PAIRS = {}


def _pair(arch, full_heads=False):
    """(jax model, jax params, port model, port params) on the same weights:
    ``arch:smoke`` at f32 compute (with ``full_heads``, at the arch's
    full-width heads), built once per case."""
    key = (arch, full_heads)
    if key not in _PAIRS:
        kw = dict(FULL_HEADS[arch]) if full_heads else {}
        jcfg = jax_config(f"{arch}:smoke").with_(compute_dtype=jnp.float32, **kw)
        tcfg = get_config(f"{arch}:smoke").with_(compute_dtype=torch.float32, **kw)
        jm, tm = jax_model(jcfg), build_model(tcfg)
        jp = jax.jit(jm.init)(jax.random.key(0))
        _PAIRS[key] = (jm, jp, tm, from_jax_params(jax.device_get(jp), tcfg, device="cpu"))
    return _PAIRS[key]


def _japply(jm, jp, tokens, *, mode, cache=None, max_len=None):
    fn = jax.jit(lambda p, t, c: jm.apply(p, {"tokens": t}, mode=mode, cache=c,
                                          max_len=max_len))
    return fn(jp, jnp.asarray(tokens), cache)


def _tokens(B, S, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_full_width_n_params_match_jax(arch):
    for name in (arch, f"{arch}:smoke"):
        jc, tc = jax_config(name), get_config(name)
        for f in FIELDS:
            assert getattr(jc, f) == getattr(tc, f), (name, f)
        assert tc.param_dtype == torch.float32 and jnp.dtype(jc.param_dtype).name == "float32"
        assert tc.compute_dtype == torch.bfloat16
        assert jnp.dtype(jc.compute_dtype).name == "bfloat16"
    full = build_model(get_config(arch)).n_params()
    assert full == jax_model(jax_config(arch)).n_params() == N_PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    assert len(tree_leaves(tp)) == len(jax.tree.leaves(jp))
    toks = _tokens(2, 24, seed=1)
    want, _, _ = _japply(jm, jp, toks, mode="train")
    got, _, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, mode="train")
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches_jax(arch):
    """One AdamW step (lr 3e-4) from the same init on one batch: loss,
    grad_norm and every param after it."""
    jm, jp, tm, tp = _pair(arch)
    jo, to = jopt.adamw(lr=3e-4), optim.adamw(lr=3e-4)
    js = jstep.init_state(jm, jo, params=jp)
    ts = from_jax_state(jax.device_get(js), tm.cfg, device="cpu")
    t = np.random.default_rng(5).integers(0, 256, (4, 33)).astype(np.int32)
    b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    js, jmet = jax.jit(jstep.make_train_step(jm, jo))(js, {k: jnp.asarray(v)
                                                          for k, v in b.items()})
    ts, tmet = make_train_step(tm, to)(ts, {k: torch.from_numpy(np.ascontiguousarray(v))
                                            for k, v in b.items()})
    assert int(ts["step"]) == int(js["step"]) == 1
    for k in ("loss", "grad_norm", "ce", "zloss"):
        _close(tmet[k], jmet[k])
    want = jax.tree.leaves(jax.device_get(js["params"]))
    got = tree_leaves(_sorted(ts["params"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    toks = _tokens(2, 17, seed=2)
    jl, jc, _ = _japply(jm, jp, toks[:, :16], mode="prefill", max_len=24)
    tl, tc, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks[:, :16])}, mode="prefill",
                         max_len=24)
    _close(tl, jl)
    for a, b in zip(jax.tree.leaves(jax.device_get(jc)), tree_leaves(_sorted(tc))):
        _close(b, a)
    nxt = toks[:, 16:]
    jd, _, _ = _japply(jm, jp, nxt, mode="decode", cache=jc)
    td, tc2, _ = tm.apply(tp, {"tokens": torch.from_numpy(nxt)}, mode="decode", cache=tc)
    _close(td, jd)
    assert tc2["pos"].tolist() == [17, 17]


@pytest.mark.parametrize("scan_layers", [False, True])
def test_glm4_decode_matches_train(scan_layers):
    """Port of tests/test_arch_smoke.py::test_decode_matches_train for
    glm4-9b (partial rotary), in both layer layouts."""
    cfg = get_config("glm4-9b:smoke").with_(scan_layers=scan_layers,
                                            compute_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    B, S = 2, 32
    toks = torch.from_numpy(_tokens(B, S, seed=4))
    full, _, _ = model.apply(params, {"tokens": toks}, mode="train")
    plog, cache, _ = model.apply(params, {"tokens": toks[:, : S - 1]}, mode="prefill",
                                 max_len=S + 4)
    dlog, _, _ = model.apply(params, {"tokens": toks[:, S - 1:]}, mode="decode", cache=cache)
    assert float((plog[:, -1] - full[:, -2]).abs().max()) < 1e-3
    assert float((dlog[:, -1] - full[:, -1]).abs().max()) < 1e-3


def test_glm4_partial_rotary_matches_jax():
    """Only the first ``rotary_pct`` of each head turns: the JAX and port
    RoPE agree on q and k shapes of the model, and the tail passes
    through untouched."""
    cfg = get_config("glm4-9b:smoke")
    jcfg = jax_config("glm4-9b:smoke")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 2, 2, cfg.head_dim)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    jc, js = JL.rope_freqs(jcfg, jnp.asarray(pos))
    tc, ts = L.rope_freqs(cfg, torch.from_numpy(pos))
    assert tc.shape[-1] == cfg.head_dim // 4  # rot = head_dim / 2, in pairs
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jc, js))
    got = L.apply_rope(torch.from_numpy(x), tc, ts).numpy()
    _close(got, want, 1e-6)
    rot = cfg.head_dim // 2
    assert np.array_equal(got[..., rot:], x[..., rot:])
    assert not np.allclose(got[:, 1:, ..., :rot], x[:, 1:, ..., :rot])


@pytest.mark.parametrize("arch,full_heads", [("glm4-9b", False), ("glm4-9b", True),
                                             ("granite-3-8b", True),
                                             ("mistral-nemo-12b", True)])
def test_prefill_past_flash_threshold_matches_jax(arch, full_heads):
    """S = 2,304 > FLASH_THRESHOLD: JAX runs _flash_attention_qchunked, the
    port its flash entry point (the plain version on the CPU): glm4-9b on
    partially rotated q and k, and each arch at its full-width GQA group
    (16 for glm4-9b, 4 for the other two), the shapes the kernel takes on
    the card."""
    S = L.FLASH_THRESHOLD + 256
    jm, jp, tm, tp = _pair(arch, full_heads)
    toks = _tokens(1, S, seed=3)
    before = build.LAUNCHES["fa_forward"]
    calls = []
    real = L.ops.flash_attention

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    L.ops.flash_attention = spy
    try:
        tl, _, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, mode="prefill",
                            max_len=S + 4)
    finally:
        L.ops.flash_attention = real
    cfg = tm.cfg
    assert calls == [(1, S, cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim)] * cfg.num_layers
    if full_heads:
        assert cfg.q_per_kv == jax_config(arch).num_heads // jax_config(arch).num_kv_heads
    assert build.LAUNCHES["fa_forward"] == before
    jl, _, _ = _japply(jm, jp, toks, mode="prefill", max_len=S + 4)
    _close(tl, jl)
