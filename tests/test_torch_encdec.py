"""The port's encoder–decoder pieces against the JAX package's on the same
numpy inputs and parameters, at f32 on both sides (tolerance 1e-4, atol
and rtol, as ``tests/test_torch_families.py`` uses):

  * ``apply_norm`` with a LayerNorm's scale and bias (``norm_kind``
    layernorm), beside the RMSNorm it had;
  * ``apply_cross_attention`` in train, prefill and decode, the decode
    passing the cross cache through with no write into it;
  * ``apply_attention(kv_src=)`` in train and prefill;
  * ``apply_attention(causal=False)`` below the flash threshold (einsum)
    and above it, where JAX runs its chunked twin and the port the flash
    entry point while autograd does not record (the plain version on the
    CPU) and its own twin while it does;
  * seamless-m4t-large-v2:smoke with its encoder past the flash threshold
    (2,304 frames): the encoder's attention calls
    ``ops.flash_attention(causal=False)`` once a layer in a prefill (the
    decoder's short prompt the causal one) and never in a training
    forward, which runs the twin; the prefill's logits equal JAX's.

The whole arch (train, prefill and decode, loss, an AdamW step,
``generate``, the stacked layout, the store's cache key) is in
``tests/test_torch_families.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models.config import get_config as jax_config
from repro.models.model import build_model as jax_model
from repro_torch.kernels import build
from repro_torch.models import layers as L
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.config import get_config
from repro_torch.models.model import build_model
from repro_torch.train.step import value_and_grad

TOL = 1e-4
ARCH = "seamless-m4t-large-v2"


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().double().numpy(),
                               np.asarray(want, np.float64), atol=tol, rtol=tol)


def _cfgs(**kw):
    return (jax_config(f"{ARCH}:smoke").with_(compute_dtype=jnp.float32, **kw),
            get_config(f"{ARCH}:smoke").with_(compute_dtype=torch.float32, **kw))


def _params(spec, rng):
    """numpy params for a flat spec dict, each leaf N(0, 1/fan_in)."""
    return {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
            for k, s in spec.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("norm_kind", ["layernorm", "rmsnorm"])
def test_apply_norm_matches_jax(norm_kind):
    jc, tc = _cfgs(norm_kind=norm_kind)
    spec = L.norm_spec(tc)
    assert set(spec) == set(JL.norm_spec(jc)) == (
        {"scale", "bias"} if norm_kind == "layernorm" else {"scale"})
    rng = np.random.default_rng(1)
    p = {k: (rng.standard_normal(s.shape) + (k == "scale")).astype(np.float32)
         for k, s in spec.items()}
    x = (rng.standard_normal((2, 7, tc.d_model)) * 3 + 1).astype(np.float32)
    jp, tp = _both(p)
    _close(L.apply_norm(tp, torch.from_numpy(x)), JL.apply_norm(jp, jnp.asarray(x)))


def test_cross_attention_matches_jax_and_decode_leaves_its_cache_alone():
    jc, tc = _cfgs()
    spec = L.attention_spec(tc, cross=True)
    assert set(spec) == set(JL.attention_spec(jc, cross=True)) == {"wq", "wk", "wv", "wo"}
    rng = np.random.default_rng(2)
    jp, tp = _both(_params(spec, rng))
    x = rng.standard_normal((2, 6, tc.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 11, tc.d_model)).astype(np.float32)
    for mode in ("train", "prefill"):
        jy, jcache = JL.apply_cross_attention(jp, jc, jnp.asarray(x), jnp.asarray(enc),
                                              mode=mode)
        ty, tcache = L.apply_cross_attention(tp, tc, torch.from_numpy(x),
                                             torch.from_numpy(enc), mode=mode)
        _close(ty, jy)
        assert (tcache is None) == (jcache is None) == (mode == "train")
    assert set(tcache) == {"k", "v"} and tcache["k"].shape == (2, 11, tc.num_kv_heads,
                                                              tc.head_dim)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    before = {k: v.clone() for k, v in tcache.items()}
    for _ in range(3):
        xt = rng.standard_normal((2, 1, tc.d_model)).astype(np.float32)
        jy, jcache = JL.apply_cross_attention(jp, jc, jnp.asarray(xt), None, cache=jcache,
                                              mode="decode")
        ty, out = L.apply_cross_attention(tp, tc, torch.from_numpy(xt), None, cache=tcache,
                                          mode="decode")
        _close(ty, jy)
        assert out is tcache
    assert all(torch.equal(tcache[k], before[k]) for k in before)
    with pytest.raises(ValueError, match="enc_out"):
        L.apply_cross_attention(tp, tc, torch.from_numpy(x), None, mode="prefill")


@pytest.mark.parametrize("S", [40, L.FLASH_THRESHOLD + 256])
@pytest.mark.parametrize("records", [False, True])
def test_noncausal_self_attention_matches_jax(S, records):
    """Non-causal self-attention (the encoder's) in train mode. Past the
    threshold JAX runs its chunked twin; the port runs the flash entry
    point (on the CPU its plain version) when autograd does not record and
    its twin, with gradients, when it does."""
    jc, tc = _cfgs()
    spec = L.attention_spec(tc)
    rng = np.random.default_rng(3)
    jp, tp = _both(_params(spec, rng))
    x = rng.standard_normal((1, S, tc.d_model)).astype(np.float32)
    pos = np.arange(S)[None]
    jy, _, jsf = JL.apply_attention(jp, jc, jnp.asarray(x), positions=jnp.asarray(pos),
                                    causal=False, mode="train")
    calls, real = [], L.ops.flash_attention

    def spy(*a, **kw):
        calls.append(kw["causal"])
        return real(*a, **kw)

    L.ops.flash_attention = spy
    try:
        with torch.set_grad_enabled(records):
            tx = torch.from_numpy(x).requires_grad_(records)
            ty, cache, tsf = L.apply_attention(tp, tc, tx, positions=torch.from_numpy(pos),
                                               causal=False, mode="train")
    finally:
        L.ops.flash_attention = real
    _close(ty, jy)
    assert cache is None and tsf == jsf
    past = S > L.FLASH_THRESHOLD
    assert calls == ([False] if past and not records else [])
    assert ty.requires_grad == records


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_attention_over_a_kv_source_matches_jax(mode):
    """``apply_attention(kv_src=)``: keys and values from another sequence
    (no RoPE on either side), the einsum path whatever the length, and in
    prefill a cache of the source's length plus the headroom."""
    jc, tc = _cfgs(rotary_pct=1.0)
    rng = np.random.default_rng(6)
    jp, tp = _both(_params(L.attention_spec(tc), rng))
    x = rng.standard_normal((2, 5, tc.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 9, tc.d_model)).astype(np.float32)
    pos = np.arange(5)[None]
    jy, jcache, _ = JL.apply_attention(jp, jc, jnp.asarray(x), positions=jnp.asarray(pos),
                                       kv_src=jnp.asarray(src), causal=False, mode=mode,
                                       max_len=8)
    ty, tcache, tsf = L.apply_attention(tp, tc, torch.from_numpy(x),
                                        positions=torch.from_numpy(pos),
                                        kv_src=torch.from_numpy(src), causal=False,
                                        mode=mode, max_len=8)
    _close(ty, jy)
    assert tsf == 0.0 and (tcache is None) == (mode == "train")
    if tcache is not None:
        assert tcache["k"].shape == jcache["k"].shape == (2, 12, tc.num_kv_heads, tc.head_dim)
        for k in ("k", "v", "len"):
            _close(tcache[k], jcache[k])


def test_encoder_attention_launches_flash_only_when_no_gradient_is_recorded():
    """seamless:smoke with 2,304 stub frames: in a prefill (no gradient
    recorded) every encoder layer calls ``ops.flash_attention`` with
    ``causal=False`` and none runs the twin; the decoder's 16 tokens, under
    the threshold, take it causally at a head dim it takes (64); the logits
    equal JAX's. In a training forward,
    which records, the encoder runs the twin once a layer and never the
    flash entry point; no kernel launches on the CPU."""
    F = L.FLASH_THRESHOLD + 256
    jc, tc = _cfgs(frontend_seq=F)
    jm, tm = jax_model(jc), build_model(tc)
    jp = jax.jit(jm.init)(jax.random.key(4))
    tp = from_jax_params(jax.device_get(jp), tc, device="cpu")
    rng = np.random.default_rng(5)
    b = {"tokens": rng.integers(0, 256, (1, 17)).astype(np.int32),
         "frontend": rng.standard_normal((1, F, tc.d_model)).astype(np.float32)}
    pre = {"tokens": torch.from_numpy(b["tokens"][:, :16]),
           "frontend": torch.from_numpy(b["frontend"])}
    flash, twin = [], []
    real_flash, real_twin = L.ops.flash_attention, L._flash_attention_qchunked

    def flash_spy(q, k, v, **kw):
        flash.append((tuple(q.shape), kw["causal"]))
        return real_flash(q, k, v, **kw)

    def twin_spy(q, k, v, **kw):
        twin.append((tuple(q.shape), kw["causal"]))
        return real_twin(q, k, v, **kw)

    before = build.LAUNCHES["fa_forward"]
    L.ops.flash_attention, L._flash_attention_qchunked = flash_spy, twin_spy
    try:
        with torch.inference_mode():
            tl, _, _ = tm.apply(tp, pre, mode="prefill", max_len=24)
        shape = (1, F, tc.num_kv_heads, tc.q_per_kv, tc.head_dim)
        dec = (1, 16, tc.num_kv_heads, tc.q_per_kv, tc.head_dim)
        assert flash == ([(shape, False)] * tc.num_encoder_layers
                         + [(dec, True)] * tc.num_layers) and twin == []
        flash.clear()
        batch = dict(pre, labels=torch.from_numpy(b["tokens"][:, 1:]))
        value_and_grad(tm.train_loss, tp, batch)
        assert flash == [] and twin == [(shape, False)] * tc.num_encoder_layers
    finally:
        L.ops.flash_attention, L._flash_attention_qchunked = real_flash, real_twin
    assert build.LAUNCHES["fa_forward"] == before
    jl, _, _ = jax.jit(lambda p, b: jm.apply(p, b, mode="prefill", max_len=24))(
        jp, {"tokens": jnp.asarray(b["tokens"][:, :16]), "frontend": jnp.asarray(b["frontend"])})
    _close(tl, jl)
