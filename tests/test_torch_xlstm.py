"""The port's xLSTM blocks (``repro_torch.models.xlstm``) and its scan-FLOP
accounting (``repro_torch.models.accounting``) against the JAX package's on
the same numpy inputs and parameters, at f32 on both sides (tolerance
1e-4, atol and rtol, as ``tests/test_torch_families.py`` uses; it covers
summation order, the port's chunk and time loops against JAX's
``lax.scan`` and its in-chunk cumulative sum as a triangular product):

  * ``mlstm_cell`` at xlstm-125m's full-width head sizes (4 heads of 384)
    over 1 and 2 chunks, with and without an entering state, its output
    and its final (C, n, m); ``mlstm_decode_step`` over 4 steps;
  * ``_slstm_step`` at the full-width sLSTM heads (4 of 192), 4 steps;
  * ``apply_mlstm`` and ``apply_slstm`` at xlstm-125m's full widths in
    train mode, in prefill and in 4 decode steps from the prefill's cache;
  * the chunkwise mLSTM against its own recurrence (the port alone);
  * the scan FLOPs that a whole forward declares, for xlstm-125m:smoke and
    for seamless-m4t-large-v2:smoke at S 2,304 (past the flash threshold),
    in the unrolled and the stacked layout, equal to JAX's
    ``measure_scan_flops`` of the same call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as JX
from repro.models.accounting import measure_scan_flops
from repro.models.config import get_config as jax_config
from repro.models.model import build_model as jax_model
from repro_torch.models import accounting
from repro_torch.models import layers as L
from repro_torch.models import xlstm as X
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.config import get_config
from repro_torch.models.model import build_model

TOL = 1e-4
B = 2


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(got).double().numpy(),
                               np.asarray(want, np.float64), atol=tol, rtol=tol)


def _close_state(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


def _cfgs(**kw):
    """xlstm-125m at full width, f32 compute, in both packages."""
    return (jax_config("xlstm-125m").with_(compute_dtype=jnp.float32, **kw),
            get_config("xlstm-125m").with_(compute_dtype=torch.float32, **kw))


def _params(spec, seed):
    """numpy params for a spec dict: normal leaves at 1/sqrt(fan_in) times
    their scale; ones, zeros and the identity conv perturbed, so that
    every leaf matters."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in spec.items():
        noise = 0.1 * rng.standard_normal(s.shape)
        if s.init == "normal":
            v = rng.standard_normal(s.shape) * s.scale / np.sqrt(s.shape[s.fan_in_axis])
        elif s.init == "ones":
            v = 1.0 + noise
        elif s.init == "identity_conv":
            v = noise
            v[-1] += 1.0
        else:
            v = noise
        out[k] = v.astype(np.float32)
    return out


def _cell_inputs(S, H, P, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, P)).astype(np.float32) for _ in range(3))
    logi = rng.standard_normal((B, S, H)).astype(np.float32)
    logf = np.asarray(jax.nn.log_sigmoid(rng.standard_normal((B, S, H)) + 2.0), np.float32)
    return q, k, v, logi, logf


def _mlstm_state(H, P, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, P, P)).astype(np.float32),
            rng.standard_normal((B, H, P)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


def _j(arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _t(arrs):
    return tuple(torch.from_numpy(np.array(a)) for a in arrs)  # writable copies


@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_cell_matches_jax_at_full_width_heads(S, with_state):
    H, P = 4, 384
    ins = _cell_inputs(S, H, P, seed=S)
    st = _mlstm_state(H, P, seed=1) if with_state else None
    jh, jst = JX.mlstm_cell(*_j(ins), None if st is None else _j(st))
    th, tst = X.mlstm_cell(*_t(ins), None if st is None else _t(st))
    assert th.dtype == torch.float32 and th.shape == (B, S, H, P)
    _close(th, jh)
    _close_state(tst, jst)


def test_mlstm_decode_steps_match_jax():
    H, P = 4, 384
    q, k, v, logi, logf = _cell_inputs(4, H, P, seed=3)
    jst, tst = _j(_mlstm_state(H, P, seed=2)), _t(_mlstm_state(H, P, seed=2))
    for t in range(4):
        step = (q[:, t], k[:, t], v[:, t], logi[:, t], logf[:, t])
        jh, jst = JX.mlstm_decode_step(*_j(step), jst)
        th, tst = X.mlstm_decode_step(*_t(step), tst)
        _close(th, jh)
        _close_state(tst, jst)


def test_mlstm_chunkwise_form_equals_its_recurrence():
    """The chunkwise cell over 2 chunks and the decode recurrence token by
    token give the same outputs and final state from the same entering
    state: what the card's full-width check holds at 4,096 tokens."""
    H, P, S = 4, 32, 128
    q, k, v, logi, logf = _t(_cell_inputs(S, H, P, seed=4))
    st = _t(_mlstm_state(H, P, seed=5))
    h, end = X.mlstm_cell(q, k, v, logi, logf, st)
    hs = []
    for t in range(S):
        ht, st = X.mlstm_decode_step(q[:, t], k[:, t], v[:, t], logi[:, t], logf[:, t], st)
        hs.append(ht)
    _close(h, torch.stack(hs, 1))
    # the stabiliser m differs by construction; C and n carry its scale
    for a, b in ((end[0], st[0]), (end[1], st[1])):
        _close(a * torch.exp(end[2]).reshape((B, H) + (1,) * (a.dim() - 2)),
               b * torch.exp(st[2]).reshape((B, H) + (1,) * (b.dim() - 2)), 1e-3)


def test_slstm_steps_match_jax_at_full_width_heads():
    H, dh = 4, 192
    rng = np.random.default_rng(6)
    r = (rng.standard_normal((4, H, dh, dh)) * 0.7 / np.sqrt(dh)).astype(np.float32)
    st = tuple(rng.standard_normal((B, H, dh)).astype(np.float32) for _ in range(4))
    st = (st[0], st[1], np.abs(st[2]) + 0.5, st[3])  # n > 0
    jst, tst = _j(st), _t(st)
    for _ in range(4):
        wx = rng.standard_normal((B, 4 * H * dh)).astype(np.float32)
        jst = JX._slstm_step(jnp.asarray(r), jst, jnp.asarray(wx))
        tst = X._slstm_step(torch.from_numpy(r), tst, torch.from_numpy(wx))
        _close_state(tst, jst)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_train_prefill_decode_match_jax(kind):
    """One block at xlstm-125m's full widths (d_model 768, 4 heads; mLSTM
    inner 1,536 with heads of 384, sLSTM heads of 192 and its 4/3 MLP):
    train mode over S 128, then a prefill over the first 64 positions (one
    mLSTM chunk) and 4 decode steps from its cache: outputs and every cache
    leaf."""
    jc, tc = _cfgs()
    spec = {"mlstm": X.mlstm_spec, "slstm": X.slstm_spec}[kind](tc)
    p = _params(spec, seed=7)
    japply = {"mlstm": JX.apply_mlstm, "slstm": JX.apply_slstm}[kind]
    tapply = {"mlstm": X.apply_mlstm, "slstm": X.apply_slstm}[kind]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    x = (np.random.default_rng(8).standard_normal((B, 128, tc.d_model)) / 2).astype(np.float32)
    jy, jcache = japply(jp, jc, jnp.asarray(x), mode="train")
    ty, tcache = tapply(tp, tc, torch.from_numpy(x), mode="train")
    assert jcache is None and tcache is None
    _close(ty, jy)
    jy, jcache = japply(jp, jc, jnp.asarray(x[:, :64]), mode="prefill")
    ty, tcache = tapply(tp, tc, torch.from_numpy(x[:, :64]), mode="prefill")
    _close(ty, jy)
    for t in range(64, 68):
        jy, jcache = japply(jp, jc, jnp.asarray(x[:, t:t + 1]), cache=jcache, mode="decode")
        ty, tcache = tapply(tp, tc, torch.from_numpy(x[:, t:t + 1]), cache=tcache,
                            mode="decode")
        _close(ty, jy)
        assert set(tcache) == set(jcache) == {"conv", kind}
        _close(tcache["conv"], jcache["conv"])
        _close_state(tcache[kind], jcache[kind])
    want = {"mlstm": X.mlstm_cache_spec, "slstm": X.slstm_cache_spec}[kind](tc, B)
    assert tuple(tcache["conv"].shape) == want["conv"][0]
    assert [tuple(t.shape) for t in tcache[kind]] == [s for s, _ in want[kind]]


def _flops_pair(arch, scan, S):
    """(jax model, jax params, port model, port params, batch) for
    ``arch:smoke`` in the stacked (``scan``) or unrolled layout."""
    depth = {"num_layers": 8} if arch == "xlstm-125m" else {
        "num_layers": 2, "num_encoder_layers": 2, "frontend_seq": S}
    kw = dict(compute_dtype=jnp.float32, scan_layers=scan, **depth)
    jc = jax_config(f"{arch}:smoke").with_(**kw)
    tc = get_config(f"{arch}:smoke").with_(**dict(kw, compute_dtype=torch.float32))
    jm, tm = jax_model(jc), build_model(tc)
    jp = jax.jit(jm.init)(jax.random.key(0))
    tp = from_jax_params(jax.device_get(jp), tc, device="cpu")
    rng = np.random.default_rng(9)
    b = {"tokens": rng.integers(0, 256, (1, S)).astype(np.int32)}
    if tc.encoder_decoder:
        b["frontend"] = rng.standard_normal((1, S, tc.d_model)).astype(np.float32)
    return jm, jp, tm, tp, b


@pytest.mark.parametrize("arch,S", [("xlstm-125m", 128),
                                    ("seamless-m4t-large-v2", L.FLASH_THRESHOLD + 256)])
@pytest.mark.parametrize("scan", [False, True])
def test_declared_scan_flops_match_jax(arch, S, scan):
    """The port runs every period of a stacked layout as a loop iteration
    that declares its own FLOPs, where JAX traces the period once under
    ``scan_scope(n)``: the totals must agree, in both layouts. seamless at
    S 2,304: the encoder's non-causal and the decoder's causal chunked
    attention (the port declares them whichever path runs)."""
    jm, jp, tm, tp, b = _flops_pair(arch, scan, S)
    assert ("scan" in tp["stack"]) == scan
    want = measure_scan_flops(lambda p, b: jm.apply(p, b, mode="train"), jp,
                              {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        got = accounting.count_scan_flops(
            tm.apply, tp, {k: torch.from_numpy(v) for k, v in b.items()}, mode="train")
    assert want > 0 and got == want


def test_scan_scope_multiplies_what_is_declared_inside():
    def declare():
        accounting.add_scan_flops(3.0)
        with accounting.scan_scope(4):
            accounting.add_scan_flops(2.0)
            with accounting.scan_scope(2):
                accounting.add_scan_flops(1.0)

    assert accounting.count_scan_flops(declare) == 3.0 + 8.0 + 8.0
    accounting.add_scan_flops(5.0)  # outside a count: nothing to add to
