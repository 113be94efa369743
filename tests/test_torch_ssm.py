"""The port's Mamba-2 SSD layer (``repro_torch.models.ssm``) against the
JAX package's (``repro.models.ssm``) on the same numpy inputs and the same
parameters, at f32 on both sides (tolerance 1e-4, atol and rtol, as
``tests/test_torch_archs.py`` uses; it covers summation order, the
cross-chunk loop against JAX's associative scan included):

  * ``ssd_chunked`` at 1, 2, 3 and 4 chunks, with and without an entering
    state, its output and its final state;
  * ``_causal_conv`` without and with a decode state, and
    ``_gated_rmsnorm``;
  * ``apply_mamba`` (jamba-1.5-large-398b:smoke widths) in train mode, in
    prefill and in 4 decode steps from the prefill's cache;
  * the ``identity_conv`` and ``trunc`` inits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro.models.config import get_config as jax_config
from repro.models.schema import ParamSpec as JParamSpec
from repro.models.schema import materialize as jax_materialize
from repro_torch.models import ssm as S
from repro_torch.models.config import get_config
from repro_torch.models.schema import ParamSpec, materialize

TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(got).double().numpy(),
                               np.asarray(want, np.float64), atol=tol, rtol=tol)


def _ssd_inputs(B, Sq, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, Sq, H, P)).astype(np.float32)
    dt = rng.uniform(0.05, 0.8, (B, Sq, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    a_log = (dt * A).astype(np.float32)
    Bm = rng.standard_normal((B, Sq, N)).astype(np.float32)
    Cm = rng.standard_normal((B, Sq, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return x, dt, a_log, Bm, Cm, h0


@pytest.mark.parametrize("nc", [1, 2, 3, 4])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(nc, with_h0):
    L = 16
    x, dt, a_log, Bm, Cm, h0 = _ssd_inputs(2, L * nc, 3, 8, 4, seed=nc)
    h0 = h0 if with_h0 else None
    jy, jh = JS.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_log, Bm, Cm)), L,
                            None if h0 is None else jnp.asarray(h0))
    ty, th = S.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, a_log, Bm, Cm)), L,
                           None if h0 is None else torch.from_numpy(h0))
    assert ty.dtype == th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)


def test_ssd_chunked_refuses_a_ragged_sequence():
    x, dt, a_log, Bm, Cm, _ = _ssd_inputs(1, 24, 2, 4, 4, seed=0)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        S.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, a_log, Bm, Cm)), 16)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(3)
    xBC = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    jo, js = JS._causal_conv(jnp.asarray(xBC), jnp.asarray(w),
                             None if st is None else jnp.asarray(st))
    to, ts = S._causal_conv(torch.from_numpy(xBC), torch.from_numpy(w),
                            None if st is None else torch.from_numpy(st))
    _close(to, jo)
    _close(ts, js)


def test_gated_rmsnorm_matches_jax():
    rng = np.random.default_rng(4)
    y, z = (rng.standard_normal((2, 5, 32)).astype(np.float32) for _ in range(2))
    sc = rng.standard_normal(32).astype(np.float32)
    _close(S._gated_rmsnorm(*(torch.from_numpy(a) for a in (y, z, sc))),
           JS._gated_rmsnorm(*(jnp.asarray(a) for a in (y, z, sc))))


def _mamba_pair(seed=0):
    """jamba:smoke at f32 compute; random params (every leaf, so the conv,
    the decay and the skip are all non-trivial), as numpy and tensors."""
    jc = jax_config("jamba-1.5-large-398b:smoke").with_(compute_dtype=jnp.float32)
    tc = get_config("jamba-1.5-large-398b:smoke").with_(compute_dtype=torch.float32)
    rng = np.random.default_rng(seed)
    spec = S.mamba_spec(tc)
    jp = {k: (0.3 * rng.standard_normal(s.shape)).astype(np.float32) for k, s in spec.items()}
    return jc, tc, jp, {k: torch.from_numpy(v.copy()) for k, v in jp.items()}


def test_apply_mamba_train_matches_jax():
    jc, tc, jp, tp = _mamba_pair()
    x = np.random.default_rng(5).standard_normal((2, 64, tc.d_model)).astype(np.float32)
    jy, jcache = JS.apply_mamba(jp, jc, jnp.asarray(x), mode="train")
    ty, tcache = S.apply_mamba(tp, tc, torch.from_numpy(x), mode="train")
    assert jcache is None and tcache is None
    _close(ty, jy)


def test_apply_mamba_prefill_then_4_decode_steps_match_jax():
    jc, tc, jp, tp = _mamba_pair(seed=1)
    x = np.random.default_rng(6).standard_normal((2, 68, tc.d_model)).astype(np.float32)
    fn = jax.jit(lambda p, x, c, mode: JS.apply_mamba(p, jc, x, cache=c, mode=mode),
                 static_argnums=3)
    jy, jcache = fn(jp, jnp.asarray(x[:, :64]), None, "prefill")
    ty, tcache = S.apply_mamba(tp, tc, torch.from_numpy(x[:, :64]), mode="prefill")
    _close(ty, jy)
    spec = S.mamba_cache_spec(tc, 2)
    for k in ("conv", "ssm"):
        assert tuple(tcache[k].shape) == spec[k][0] and tcache[k].dtype == spec[k][1]
        _close(tcache[k], jcache[k])
    for t in range(64, 68):
        jy, jcache = fn(jp, jnp.asarray(x[:, t:t + 1]), jcache, "decode")
        ty, tcache = S.apply_mamba(tp, tc, torch.from_numpy(x[:, t:t + 1]),
                                   cache=tcache, mode="decode")
        _close(ty, jy)
        for k in ("conv", "ssm"):
            _close(tcache[k], jcache[k])


def test_mamba_dims_and_spec_match_jax():
    for name in ("jamba-1.5-large-398b", "jamba-1.5-large-398b:smoke"):
        jc, tc = jax_config(name), get_config(name)
        assert S.mamba_dims(tc) == JS.mamba_dims(jc)
        js, ts = JS.mamba_spec(jc), S.mamba_spec(tc)
        assert {k: (v.shape, v.init) for k, v in ts.items()} == {
            k: (v.shape, v.init) for k, v in js.items()}
        assert S.ssd_scan_flops(2, 4096, 256, 64, 64, 256) == JS.ssd_scan_flops(
            2, 4096, 256, 64, 64, 256)


def test_identity_conv_and_trunc_inits():
    """identity_conv: the JAX package's impulse at the last tap, exactly.
    trunc: a normal cut at ±3 standard deviations, times ``scale``, drawn
    from the caller's generator (the same seed, the same values)."""
    got = materialize(ParamSpec((4, 6), ("conv", "inner"), init="identity_conv"),
                      torch.Generator("cpu").manual_seed(0), torch.float32)
    want = jax_materialize(JParamSpec((4, 6), ("conv", "inner"), init="identity_conv"),
                           jax.random.key(0), jnp.float32)
    assert np.array_equal(got.numpy(), np.asarray(want))
    spec = ParamSpec((200, 100), ("a", "b"), init="trunc", scale=0.02)
    a, b = (materialize(spec, torch.Generator("cpu").manual_seed(7), torch.float32)
            for _ in range(2))
    assert torch.equal(a, b) and float(a.abs().max()) <= 3 * 0.02
    assert abs(float(a.std()) - 0.02 * 0.9866) < 0.001  # a ±3σ cut keeps std 0.9866σ
