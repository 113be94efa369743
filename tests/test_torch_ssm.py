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
  * the ``identity_conv`` and ``trunc`` inits;
  * ``ops.ssd_scan``'s plain CPU version (the SSD kernel's decomposition:
    dt on the decay side, the D skip and the rounding to x's dtype last)
    against the JAX ``ssd_chunked`` plus the D skip, and ``apply_mamba``'s
    prefill the same whichever way its dispatch goes.
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
from repro_torch.kernels import ops, ref
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


@pytest.mark.parametrize("nc", [1, 2, 3, 4])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_plain_matches_jax(nc, with_h0, dtype):
    """``ops.ssd_scan`` on CPU tensors (the plain version) against JAX's
    ``ssd_chunked`` plus D·x, on ``test_ssd_chunked_matches_jax``'s shapes:
    in f32 at its tolerance; with x, B and C in bf16, y rounded once to bf16
    from the same sums (within half a bf16 ulp of JAX's f32 value, give or
    take 1e-5 of the largest)."""
    L = 16
    x, dt, a_log, Bm, Cm, h0 = _ssd_inputs(2, L * nc, 3, 8, 4, seed=nc)
    A = (a_log / dt).mean((0, 1)).astype(np.float32)  # the one A a head that made a_log
    a_log = (dt * A).astype(np.float32)
    D = np.random.default_rng(nc).standard_normal(3).astype(np.float32)
    x, Bm, Cm = (torch.from_numpy(a).to(dtype).float().numpy() for a in (x, Bm, Cm))
    h0 = h0 if with_h0 else None
    jy, jh = JS.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_log, Bm, Cm)), L,
                            None if h0 is None else jnp.asarray(h0))
    want = np.asarray(jy) + x * D[None, None, :, None]
    ty, th = ops.ssd_scan(*(torch.from_numpy(a).to(dtype) for a in (x,)),
                          torch.from_numpy(dt), torch.from_numpy(A),
                          *(torch.from_numpy(a).to(dtype) for a in (Bm, Cm)),
                          torch.from_numpy(D), chunk=L,
                          h0=None if h0 is None else torch.from_numpy(h0))
    assert ty.dtype == dtype and th.dtype == torch.float32
    _close(th, jh)
    if dtype == torch.float32:
        _close(ty, want)
    else:
        w = torch.from_numpy(want)
        err = (ty.float() - w).abs()
        assert bool((err <= ref.half_ulp_bf16(w) + 1e-5 * w.abs().max()).all())


def test_ssd_scan_plain_is_nearer_f64_than_the_f32_path():
    """The plain version keeps its sums of dt·A in f64 and enters f32 only
    as exponents, as the kernel does: its state is far nearer an f64
    evaluation than ``ssd_chunked``'s f32 one, on the benchmark's draws
    (dt = softplus(N(0, 2)), A = −exp(N(0, 1)))."""
    g = torch.Generator().manual_seed(0)
    B, Sq, H, P, N, L = 1, 1024, 4, 16, 32, 256
    x = torch.randn((B, Sq, H, P), generator=g).bfloat16()
    Bm, Cm = (torch.randn((B, Sq, N), generator=g).bfloat16() for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((B, Sq, H), generator=g) * 2**0.5)
    A = -torch.exp(torch.randn((H,), generator=g))
    D = torch.randn((H,), generator=g)
    _, h = ref.ssd_scan_ref(x, dt, A, Bm, Cm, D, chunk=L)
    _, h64 = ref.ssd_scan_ref(x, dt, A, Bm, Cm, D, chunk=L, compute=torch.float64)
    _, hf = S.ssd_chunked(x.float(), dt, dt * A, Bm.float(), Cm.float(), L)
    rel = lambda a: ((a.double() - h64).norm() / h64.norm()).item()  # noqa: E731
    assert rel(h) < 3e-7 < rel(hf) < ref.SSD_STATE_REL_TOL


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


def _forced_pair(monkeypatch, dtype, mode="prefill", S_=64):
    """apply_mamba on jamba:smoke (chunk 32) at ``dtype`` compute, once as
    the CPU dispatch goes (``ssd_chunked``) and once with ``ops.ssd_takes``
    forced true (``ops.ssd_scan``'s plain version, as the kernel computes)."""
    _, tc, _, tp = _mamba_pair(seed=2)
    tc = tc.with_(compute_dtype=dtype)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, S_, tc.d_model)).astype(np.float32))
    calls = []
    real = ops.ssd_scan
    out = [S.apply_mamba(tp, tc, x, mode=mode)]
    monkeypatch.setattr(ops, "ssd_takes", lambda *a: True)
    monkeypatch.setattr(ops, "ssd_scan", lambda *a, **k: calls.append(1) or real(*a, **k))
    out.append(S.apply_mamba(tp, tc, x, mode=mode))
    return out, calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_mamba_prefill_alike_whichever_path(monkeypatch, dtype):
    """The prefill's output and cache are the same on both paths: the conv
    state bit for bit, the SSM state to 1e-5, and the output to f32's
    tolerance, or in bf16 to that of a bf16 rounding of the scan's output
    carried through the gated norm and the out-projection."""
    ((y0, c0), (y1, c1)), calls = _forced_pair(monkeypatch, dtype)
    assert calls == [1]
    assert y1.dtype == y0.dtype == dtype
    assert torch.equal(c0["conv"], c1["conv"])
    assert ((c1["ssm"] - c0["ssm"]).norm() / c0["ssm"].norm()).item() <= 1e-5
    if dtype == torch.float32:
        _close(y1, y0, tol=1e-5)
    else:
        assert ((y1.float() - y0.float()).norm() / y0.float().norm()).item() <= 1e-2


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_apply_mamba_train_and_decode_keep_their_paths(monkeypatch, mode):
    """Train mode and decode never call ``ops.ssd_scan``, whatever the
    dispatch says: train keeps ``ssd_chunked``, decode its one-step update."""
    _, tc, _, tp = _mamba_pair(seed=3)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 64, tc.d_model)).astype(np.float32))
    _, cache = S.apply_mamba(tp, tc, x, mode="prefill")
    want = (S.apply_mamba(tp, tc, x, mode="train") if mode == "train" else
            S.apply_mamba(tp, tc, x[:, :1], cache=cache, mode="decode"))

    def refuse(*a, **k):
        raise AssertionError("ops.ssd_scan called")

    monkeypatch.setattr(ops, "ssd_takes", lambda *a: True)
    monkeypatch.setattr(ops, "ssd_scan", refuse)
    got = (S.apply_mamba(tp, tc, x, mode="train") if mode == "train" else
           S.apply_mamba(tp, tc, x[:, :1], cache=cache, mode="decode"))
    assert torch.equal(got[0], want[0])
