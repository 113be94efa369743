"""The port's kernels (``repro_torch.kernels``) against the JAX Pallas
kernels, run as ``tests/test_kernels.py`` runs them (interpret mode on the
CPU through ``repro.kernels.ops``).

On the CPU the port's wrappers take their plain versions; the CUDA kernels
themselves are held against those plain versions by the ``gpu``-marked
tests at the end (and by ``chip_smoke.py``), which skip without a card.
Inputs are made with numpy from a seed and handed to both packages.
Against JAX, tolerances are those of ``tests/test_kernels.py``: 2e-5 in
f32, 2e-2 in bf16 (one bf16 rounding of the output either side). On the
card, a bf16 kernel is held tighter, relative to the f32 plain output over
the tensor and over every row (``ref.flash_attention_check``). The f32
kernel's arithmetic (3xTF32 products on the tensor cores) is emulated on
the CPU and held against the Pallas kernel at the f32 tolerance.
"""
import math
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import ssd as kssd

try:  # the JAX reference; the machine with the card has no jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jnp = jops = jref = None

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _need_jax():
    if jops is None:
        pytest.skip("needs jax for the JAX reference kernels")


def _qkv(B, Sq, Sk, KV, G, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, KV, G, D), dtype=np.float32)
    k = rng.standard_normal((B, Sk, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KV, D), dtype=np.float32)
    return q, k, v


def _both(arrs, dtype):
    """numpy f32 → (jax arrays, torch tensors) of ``dtype``; both round to
    bf16 the same way (nearest even)."""
    _need_jax()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(dtype) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------ flash
@pytest.mark.parametrize("S,KV,G,D,blk", [
    (128, 2, 1, 64, 64),
    (128, 1, 2, 128, 64),
    (128, 2, 4, 64, 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas(S, KV, G, D, blk, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, S, S, KV, G, D, seed=S + G), dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=blk, block_kv=blk)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == dtype and got.shape == (2, S, KV, G, D)
    _close(got, want, TOL[dtype])


# the model families' head shapes: head_dim 96 with group 1
# (phi-3-vision), group 3 at 64 (granite-moe), group 6 at 128 with softcap
# 30 (grok-1)
FAMILY_HEADS = [(4, 1, 96, 0.0), (2, 3, 64, 0.0), (1, 6, 128, 30.0)]


@pytest.mark.parametrize("KV,G,D,softcap", FAMILY_HEADS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_family_heads_match_pallas(KV, G, D, softcap, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 128, 128, KV, G, D, seed=D + G), dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True, softcap=softcap,
                                block_q=64, block_kv=64)
    got = ops.flash_attention(tq, tk, tv, causal=True, softcap=softcap)
    assert got.dtype == dtype and got.shape == (2, 128, KV, G, D)
    _close(got, want, TOL[dtype])


# softcap 30 at D 64, and at grok-1's group 6 at D 128 with q as drawn and
# scaled by 8, which drives the scores past the cap (|s| up to about 44)
@pytest.mark.parametrize("KV,G,D,qscale", [(2, 2, 64, 1.0), (1, 6, 128, 1.0),
                                           (1, 6, 128, 8.0)])
def test_flash_softcap_matches_pallas(KV, G, D, qscale):
    q, k, v = _qkv(1, 128, 128, KV, G, D, seed=5)
    (jq, jk, jv), (tq, tk, tv) = _both((q * qscale, k, v), torch.float32)
    want = jops.flash_attention(jq, jk, jv, causal=True, softcap=30.0,
                                block_q=64, block_kv=64)
    got = ops.flash_attention(tq, tk, tv, causal=True, softcap=30.0)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("Sq,Sk", [(100, 100), (37, 150)])
def test_flash_ragged_matches_jax_ref(Sq, Sk):
    """Lengths the Pallas kernel's divisibility assert refuses: held against
    the JAX plain version in its (B·H, S, D) layout."""
    _need_jax()
    B, KV, G, D = 2, 2, 2, 64
    q, k, v = _qkv(B, Sq, Sk, KV, G, D, seed=Sq)
    want = jref.flash_attention_ref(
        jnp.asarray(q.transpose(0, 2, 3, 1, 4).reshape(B * KV * G, Sq, D)),
        jnp.asarray(k.transpose(0, 2, 1, 3).reshape(B * KV, Sk, D)),
        jnp.asarray(v.transpose(0, 2, 1, 3).reshape(B * KV, Sk, D)), causal=True)
    want = np.asarray(want).reshape(B, KV, G, Sq, D).transpose(0, 3, 1, 2, 4)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    _close(got, want, 2e-5)


def _flash_bf16_emulated(q, k, v, drop):
    """Causal attention as a bf16 kernel computes it (P rounded to bf16
    before P·V, f32 sums, bf16 output), leaving out the keys where
    ``drop(qpos, kpos)`` holds."""
    D = q.shape[-1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) / D ** 0.5
    qp, kp = torch.arange(q.shape[1])[:, None], torch.arange(k.shape[1])[None, :]
    s = s.masked_fill(~((qp >= kp) & ~drop(qp, kp)), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bkgqs,bskd->bqkgd", p.bfloat16().float(), v.float())
    return (o / p.sum(-1, keepdim=True).permute(0, 3, 1, 2, 4)).bfloat16()


def test_flash_bf16_check_holds_late_rows():
    """The check the bf16 kernel is held to on the card passes a kernel
    that rounds as a bf16 kernel must, and fails one that leaves a single
    key out of each late row's sum. Late causal rows average thousands of
    values, so their outputs are small, and an error there is far below
    the per-element 2e-2 that the largest early rows need."""
    S = 2048
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, S, S, 1, 2, 128, seed=4))
    good = _flash_bf16_emulated(q, k, v, lambda qp, kp: (qp < 0) & (kp < 0))
    errs, ok = ref.flash_attention_check(good, q, k, v, causal=True)
    assert ok, errs
    late = _flash_bf16_emulated(q, k, v, lambda qp, kp: (qp >= S // 2) & (kp == 100))
    errs, ok = ref.flash_attention_check(late, q, k, v, causal=True)
    assert not ok and errs["row_rel_err"] > 10 * ref.FLASH_BF16_ROW_REL_TOL, errs


def _tf32(x):
    """f32 rounded to tf32 as ``cvt.rna.tf32.f32`` rounds it: half a tf32
    ulp added to the magnitude bits, the low 13 bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the f32 kernel forms it on the tensor cores: each operand
    split into hi = tf32(x) and lo = tf32(x - hi), the two small products
    and then hi·hi, with f32 sums (lo·lo is left out)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _flash_3xtf32_emulated(q, k, v, *, causal=True, softcap=0.0, mm=_mm_3xtf32):
    """Attention in f32 as the f32 kernel computes it: Q Kᵀ and P V through
    ``mm`` (q, k, P and v split into tf32 hi and lo), the softcap as tanh of
    the scaled score, the causal mask's -1e30 fill, the softmax in base 2
    with scale·log₂e folded into one multiply-add, and the division by the
    row sum clamped at 1e-30."""
    D = q.shape[-1]
    qp, kp = torch.arange(q.shape[1])[:, None], torch.arange(k.shape[1])[None, :]
    s = mm(q.permute(0, 2, 3, 1, 4), k.permute(0, 2, 3, 1)[:, :, None])  # (B,KV,G,Sq,Sk)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    if softcap:
        s = torch.tanh(s * (scale / softcap))
    mul = (torch.tensor(softcap, dtype=torch.float32) if softcap else scale) * math.log2(math.e)
    if causal:
        s = torch.where(qp >= kp, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s * mul - m * mul)
    o = mm(p, v.permute(0, 2, 1, 3)[:, :, None]) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4)


# the f32 shapes of test_flash_matches_pallas (causal and not), FAMILY_HEADS,
# and softcap 30 at grok-1's group 6 with q × 1 and q × 8
_3XTF32_CASES = (
    [(128, KV, G, D, causal, 0.0, 1.0) for KV, G, D in ((2, 1, 64), (1, 2, 128), (2, 4, 64))
     for causal in (True, False)]
    + [(128, KV, G, D, True, cap, 1.0) for KV, G, D, cap in FAMILY_HEADS]
    + [(128, 1, 6, 128, True, 30.0, qs) for qs in (1.0, 8.0)])


@pytest.mark.parametrize("S,KV,G,D,causal,softcap,qscale", _3XTF32_CASES)
def test_flash_3xtf32_emulation_matches_pallas(S, KV, G, D, causal, softcap, qscale):
    """3xTF32, the f32 kernel's products, holds the f32 tolerance against
    the Pallas kernel (interpret mode) before any card runs it."""
    q, k, v = _qkv(2, S, S, KV, G, D, seed=S + G + D)
    (jq, jk, jv), (tq, tk, tv) = _both((q * qscale, k, v), torch.float32)
    want = jops.flash_attention(jq, jk, jv, causal=causal, softcap=softcap,
                                block_q=64, block_kv=64)
    got = _flash_3xtf32_emulated(tq, tk, tv, causal=causal, softcap=softcap)
    assert got.dtype == torch.float32 and got.shape == (2, S, KV, G, D)
    _close(got, want, 2e-5)


def test_flash_1xtf32_misses_f32_tolerance():
    """One TF32 product (about three digits) does not hold 2e-5: what the
    3xTF32 emulation's pass above is worth."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 128, 128, 1, 2, 128, seed=7))
    want = ref.flash_attention_ref(q, k, v, causal=True)
    assert torch.allclose(_flash_3xtf32_emulated(q, k, v), want, atol=2e-5, rtol=2e-5)
    one = _flash_3xtf32_emulated(q, k, v, mm=_mm_1xtf32)
    assert not torch.allclose(one, want, atol=2e-5, rtol=2e-5)


def test_flash_wrapper_checks_and_strides():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 64, 64, 2, 2, 64, seed=1))
    before = build.LAUNCHES["fa_forward"]
    ops.flash_attention(q, k, v)
    assert build.LAUNCHES["fa_forward"] == before  # the plain version is no kernel launch
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :1], v)
    # meta tensors take the op's registered abstract implementation (the
    # dry run traces on meta shards): the output's shape, no launch
    out = ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    assert build.LAUNCHES["fa_forward"] == before
    # the model layout walks in place; a layout the kernel cannot walk is
    # refused on either device, never copied behind the caller's back
    assert fa._walk(q) == (64 * 4 * 64, 4 * 64, 64)
    assert fa._walk(k) == (64 * 2 * 64, 2 * 64, 64)
    qt = q.transpose(2, 3)
    assert fa._walk(qt) is None
    with pytest.raises(ValueError, match="cannot walk"):
        ops.flash_attention(qt, k, v)
    with pytest.raises(ValueError, match="cannot walk"):
        ops.flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3), v)


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("t,strides", [
    # the model layout: q (B, S, KV, G, D), k/v (B, S, KV, D), contiguous
    (_bf16((2, 300, 8, 2, 128)), (300 * 2048, 2048, 128)),
    (_bf16((2, 300, 8, 128)), (300 * 1024, 1024, 128)),
    # KV = 1, G = 1, B = 1: a dim of size 1 is never stepped, and is given
    # 16 bytes (8 bf16), the least stride a TMA map takes
    (_bf16((2, 77, 1, 1, 64)), (77 * 64, 64, 8)),
    (_bf16((1, 77, 1, 4, 64)), (8, 256, 64)),
    (_bf16((3, 50, 1, 64)), (50 * 64, 64, 8)),
    # q sliced out of a fused projection (q heads, then as many others):
    # heads walk in place, rows step over the others
    (torch.zeros((2, 64, 4, 2, 128), dtype=torch.bfloat16)[:, :, :2], (64 * 1024, 1024, 128)),
])
def test_flash_tensor_map_geometry(t, strides):
    """The (b, s, h) element strides the wrapper hands the kernel, from
    which the bf16 kernel encodes its (D, heads, S, B) tensor maps."""
    assert fa._strides("q", t) == strides
    assert all(s * t.element_size() % 16 == 0 for s in strides)


def test_flash_tensor_map_geometry_head_dim_96():
    """head_dim 96: rows of 192 bytes, 16-byte multiples; the bf16 kernel
    loads them as three 32-column boxes under the 64-byte swizzle, a
    native 96-column layout with no padding columns, so the wrapper walks
    the model layout in place, no copy."""
    q, kv = _bf16((2, 300, 32, 1, 96)), _bf16((2, 300, 32, 96))
    assert fa._strides("q", q) == (300 * 3072, 3072, 96)
    assert fa._strides("k", kv) == (300 * 3072, 3072, 96)
    assert 96 in fa._HEAD_DIMS


@pytest.mark.parametrize("t", [
    # a row of 68 bf16 is 136 bytes: not a 16-byte multiple
    torch.zeros((1, 10, 2, 68), dtype=torch.bfloat16)[..., :64],
    # D not contiguous
    torch.zeros((1, 10, 64, 2), dtype=torch.bfloat16).transpose(2, 3),
    # q whose (KV, G) pair does not merge into one head dim
    torch.zeros((1, 10, 2, 3, 64), dtype=torch.bfloat16)[:, :, :, :2],
])
def test_flash_tensor_map_refuses(t):
    with pytest.raises(ValueError, match="cannot walk"):
        fa._strides("k", t)


# ------------------------------------------------------------ merge
def _pairs(keys, vals):
    return Counter(zip(np.asarray(keys).tolist(), np.asarray(vals).tolist()))


def _merge_both(a, b):
    """Keys exactly as JAX's; (key, payload) pairs equal to the inputs' as
    multisets, and to JAX's wherever the key is finite."""
    _need_jax()
    av = np.arange(len(a), dtype=np.int32)
    bv = np.arange(len(a), len(a) + len(b), dtype=np.int32)
    jk, jv = jops.merge_sorted(jnp.asarray(a), jnp.asarray(av),
                               jnp.asarray(b), jnp.asarray(bv))
    tk, tv = ops.merge_sorted(*(torch.from_numpy(x) for x in (a, av, b, bv)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert _pairs(tk, tv) == _pairs(np.concatenate([a, b]), np.concatenate([av, bv]))
    fin = np.isfinite(np.asarray(jk, np.float64))
    assert _pairs(tk.numpy()[fin], tv.numpy()[fin]) == _pairs(
        np.asarray(jk)[fin], np.asarray(jv)[fin])
    # stricter than the bitonic contract: ties take a first, in run order
    order = np.argsort(np.concatenate([a, b]), kind="stable")
    np.testing.assert_array_equal(tv.numpy(), np.concatenate([av, bv])[order])


@pytest.mark.parametrize("na,nb", [(0, 5), (5, 0), (1, 1), (3, 17), (37, 100),
                                   (255, 257)])
def test_merge_matches_pallas_ragged(na, nb):
    rng = np.random.default_rng(na * 1000 + nb)
    a = np.sort(rng.integers(0, 64, na).astype(np.int32))  # many ties
    b = np.sort(rng.integers(0, 64, nb).astype(np.int32))
    _merge_both(a, b)


def test_merge_matches_pallas_float_inf():
    """Real +inf keys come back with their own payloads. (The JAX wrapper
    pads with +inf sentinels whose payload is 0, and the unstable bitonic
    network may return a sentinel's 0 in place of a real +inf key's
    payload: its keys agree, its +inf payloads need not.)"""
    rng = np.random.default_rng(3)
    a = np.append(np.sort(rng.random(40, dtype=np.float32)), np.inf).astype(np.float32)
    b = np.append(np.sort(rng.random(25, dtype=np.float32)), [np.inf, np.inf]).astype(np.float32)
    _merge_both(a, b)


def test_merge_matches_pallas_past_max_run():
    """Runs past MERGE_MAX_RUN take the JAX wrapper's merge-path tiling."""
    _need_jax()
    rng = np.random.default_rng(11)
    n = jops.MERGE_MAX_RUN + 1000
    a = np.sort(rng.integers(0, 1 << 20, n).astype(np.int32))
    b = np.sort(rng.integers(0, 1 << 20, 3000).astype(np.int32))
    _merge_both(a, b)


def test_merge_wrapper_checks():
    k = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.merge_sorted(k, k.to(torch.int64), k, k)
    with pytest.raises(ValueError):
        ops.merge_sorted(k.to(torch.int64), k, k.to(torch.int64), k)
    before = build.LAUNCHES["merge_sorted"]
    mk, mv = ops.merge_sorted(k, k, k[:0], k[:0])
    assert build.LAUNCHES["merge_sorted"] == before and torch.equal(mk, k)
    u = torch.tensor([1, 3, 2**32 - 2], dtype=torch.uint32)
    mk, _ = ops.merge_sorted(u, k[:3], u, k[:3])
    assert mk.to(torch.int64).tolist() == [1, 1, 3, 3, 2**32 - 2, 2**32 - 2]


# ------------------------------------------------------ k-way merge
def _runs(lengths, rng, hi, dtype=np.int32):
    """Ascending runs of the given lengths, back to back, with their k + 1
    offsets and payloads that name each element's place in the input."""
    runs = [np.sort(rng.integers(0, hi, n)).astype(dtype) for n in lengths]
    keys = np.concatenate(runs) if runs else np.zeros(0, dtype)
    return keys, np.arange(len(keys), dtype=np.int32), np.cumsum([0, *lengths])


def _fold(merge, keys, vals, offsets):
    """The path's old merge: fold a two-run merge over the runs in order."""
    mk, mv = keys[:offsets[1]], vals[:offsets[1]]
    for a, b in zip(offsets[1:-1], offsets[2:]):
        mk, mv = merge(mk, mv, keys[a:b], vals[a:b])
    return mk, mv


@pytest.mark.parametrize("lengths", [[5, 3], [40, 1, 17, 9], [1] * 60, [100, 0, 57, 0, 3]])
def test_merge_runs_matches_pallas_fold(lengths):
    """Unique keys: one k-way merge gives the fold of the JAX package's
    ``merge_sorted`` (Pallas, interpret mode), key and payload."""
    _need_jax()
    rng = np.random.default_rng(sum(lengths))
    keys = rng.permutation(4 * sum(lengths))[:sum(lengths)].astype(np.int32)
    offsets = np.cumsum([0, *lengths])
    for a, b in zip(offsets[:-1], offsets[1:]):
        keys[a:b] = np.sort(keys[a:b])
    vals = np.arange(len(keys), dtype=np.int32)
    jk, jv = _fold(lambda *r: jops.merge_sorted(*(jnp.asarray(x) for x in r)),
                   keys, vals, offsets)
    tk, tv = ops.merge_runs(torch.from_numpy(keys), torch.from_numpy(vals), offsets)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _inf_runs(rng):
    runs = [np.append(np.sort(rng.random(n, dtype=np.float32)), [np.inf] * m)
            for n, m in ((30, 1), (0, 2), (12, 0), (7, 3))]
    runs[2][:5] = runs[0][:5]  # ties across runs
    runs[2].sort()
    keys = np.concatenate(runs).astype(np.float32)
    return keys, np.arange(len(keys), dtype=np.int32), np.cumsum([0, *map(len, runs)])


@pytest.mark.parametrize("case", ["ties", "empty_runs", "float_inf", "one_run", "900_of_one",
                                  "uint32", "fetch_shape"])
def test_merge_runs_matches_plain_fold(case):
    """Payload for payload equal to folding the plain two-run merge over the
    runs in order (ties by run, then position), where ties, empty runs and
    ``+inf`` make the order matter."""
    rng = np.random.default_rng(len(case))
    if case == "ties":
        keys, vals, off = _runs([50, 31, 64, 2, 40], rng, 8)
    elif case == "empty_runs":
        keys, vals, off = _runs([0, 9, 0, 0, 13, 0], rng, 5)
    elif case == "float_inf":
        keys, vals, off = _inf_runs(rng)
    elif case == "one_run":
        keys, vals, off = _runs([77], rng, 10)
    elif case == "900_of_one":
        keys, vals, off = _runs([1] * 900, rng, 300)
    elif case == "uint32":
        keys, vals, off = _runs([20, 33, 7], rng, 2**32 - 1, np.uint32)
        keys[0] = 2**32 - 2
        keys[:20].sort()
    else:  # 900 chunk indices dealt out to 72 ascending runs, as a fetch sees them
        idx = np.arange(900, dtype=np.int32)
        keys = np.concatenate([idx[r::72] for r in range(72)])
        vals, off = np.arange(900, dtype=np.int32), np.cumsum([0] + [len(idx[r::72])
                                                                     for r in range(72)])
    k, v = torch.from_numpy(keys), torch.from_numpy(vals)
    gk, gv = ops.merge_runs(k, v, off)
    wk, wv = _fold(ref.merge_sorted_ref, k, v, off)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    order = np.argsort(keys.astype(np.float64), kind="stable")
    np.testing.assert_array_equal(gv.numpy(), vals[order])


def test_merge_runs_wrapper_checks():
    k = torch.arange(6, dtype=torch.int32)
    for bad in ([0, 7], [1, 6], [0, 4, 2, 6], [0], torch.tensor([0, 6]).to("meta")):
        with pytest.raises(ValueError):
            ops.merge_runs(k, k, bad)
    with pytest.raises(ValueError):
        ops.merge_runs(k.to(torch.int64), k, [0, 6])
    with pytest.raises(ValueError):
        ops.merge_runs(k, k.to(torch.int16), [0, 6])
    with pytest.raises(ValueError):
        ops.merge_runs(k, k[:5], [0, 6])
    before = build.LAUNCHES["merge_runs"]
    mk, mv = ops.merge_runs(k[:0], k[:0], [0, 0, 0])
    assert mk.numel() == 0 and build.LAUNCHES["merge_runs"] == before
    mk, mv = ops.merge_runs(k, k, torch.tensor([0, 3, 6]))
    assert mk.tolist() == [0, 1, 2, 3, 4, 5] and build.LAUNCHES["merge_runs"] == before


@pytest.mark.parametrize("causal", [True, False])
def test_attention_scale_reaches_the_einsum_path_the_twin_and_the_wrapper(causal):
    """granite-4.0-h-small's logits scale, 1/128 where 1/sqrt(D) would be
    1/sqrt(128), at D 128 and KV 2 x G 4: the einsum path, the chunked twin
    (in q and KV blocks) and ``ops.flash_attention``'s plain version agree
    with the plain version at that scale, which differs from the default."""
    from repro_torch.models import layers as L

    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 300, 300, 2, 4, 128, seed=3))
    want = ref.flash_attention_ref(q, k, v, causal=causal, scale=1 / 128)
    got = [L._einsum_attention(q, k, v, causal=causal, softcap=0.0, scale=1 / 128),
           L._flash_attention_qchunked(q, k, v, causal=causal, softcap=0.0, scale=1 / 128,
                                       block_q=128, block_kv=64),
           ops.flash_attention(q, k, v, causal=causal, scale=1 / 128)]
    for g in got:
        _close(g, want, TOL[torch.float32])
    default = ref.flash_attention_ref(q, k, v, causal=causal)
    assert (default - want).abs().max() > 1e-2
    _close(ops.flash_attention(q, k, v, causal=causal), default, TOL[torch.float32])


def _grouped_case(device, dtype):
    """``torch._grouped_mm``, the dropless MoE dispatch's one grouped
    product (``models/moe.py``), over rows sorted by expert with an expert
    that gets no rows, against one product an expert, on ``device``."""
    g = torch.Generator().manual_seed(14)
    counts = torch.tensor([5, 0, 17, 9, 1, 16])
    offs = torch.cumsum(counts, 0).to(torch.int32)
    a = torch.randn((int(counts.sum()), 32), generator=g)
    w = torch.randn((6, 32, 16), generator=g)
    got = torch._grouped_mm(a.to(device, dtype), w.to(device, dtype), offs=offs.to(device))
    assert got.dtype == dtype and got.shape == (a.shape[0], 16)
    a, w = a.to(dtype).float(), w.to(dtype).float()  # the inputs as the product sees them
    for e, (lo, hi) in enumerate(zip([0] + offs[:-1].tolist(), offs.tolist())):
        _close(got[lo:hi].cpu(), (a[lo:hi] @ w[e]).numpy(), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_product_equals_one_product_an_expert(dtype):
    """The dropless dispatch's grouped product on the CPU, where the CPU
    tests of the MoE and of the benchmark's granite cell run it."""
    _grouped_case("cpu", dtype)


# ------------------------------------------------------------ SSD scan
SSD_TAKEN = dict(device_type="cuda", records=False, dtype=torch.bfloat16, head_dim=64,
                 d_state=128, chunk=256, seq=7680)


@pytest.mark.parametrize("change,takes", [
    ({}, True),
    ({"d_state": 64, "seq": 256}, True),
    ({"device_type": "cpu"}, False),
    ({"records": True}, False),
    ({"dtype": torch.float32}, False),
    ({"head_dim": 16}, False),
    ({"d_state": 16}, False),
    ({"chunk": 32}, False),
    ({"seq": 7680 + 24}, False),
], ids=["granite", "jamba", "device", "grad", "dtype", "head_dim", "d_state", "chunk",
        "ragged_seq"])
def test_ssd_takes_one_rule_each(change, takes):
    """The kernel serves a scan only where every rule holds: CUDA, no
    gradient recorded, bf16, P 64, N 64 or 128, chunks of 256, S a whole
    number of chunks (an entering state is no rule: the kernel takes one)."""
    assert kssd.takes(**{**SSD_TAKEN, **change}) is takes


@pytest.mark.parametrize("grad", [False, True])
def test_ops_ssd_takes_reads_the_operands(monkeypatch, grad):
    seen = []
    monkeypatch.setattr(kssd, "takes", lambda *a: seen.append(a) or True)
    x = torch.zeros((1, 512, 4, 64), dtype=torch.bfloat16, requires_grad=grad)
    dt = torch.zeros((1, 512, 4))
    Bm = Cm = torch.zeros((1, 512, 128), dtype=torch.bfloat16)
    assert ops.ssd_takes(x, dt, Bm, Cm, 256)
    assert seen == [("cpu", grad, torch.bfloat16, 64, 128, 256, 512)]
    monkeypatch.undo()
    assert not ops.ssd_takes(x, dt, Bm, Cm, 256)  # a CPU tensor keeps ssd_chunked


def test_ssd_wrapper_reads_the_model_views():
    """x, B and C as the model hands them (views of the conv's output: a
    token stride of H·P + 2N) are read in place; a head dim or a token that
    is not contiguous is refused."""
    xbc = torch.zeros((2, 512, 4 * 64 + 2 * 128), dtype=torch.bfloat16)
    x = xbc[..., :256].reshape(2, 512, 4, 64)
    Bm, Cm = xbc[..., 256:384], xbc[..., 384:]
    assert kssd._rows("x", x) == (512 * 512, 512)
    assert kssd._rows("B", Bm) == kssd._rows("C", Cm) == (512 * 512, 512)
    with pytest.raises(ValueError, match="cannot read in place"):
        kssd._rows("x", x.transpose(2, 3))
    with pytest.raises(ValueError, match="cannot read in place"):
        kssd._rows("B", xbc[..., 1:129])  # a token's row starts off 16 bytes


# ------------------------------------------------------ on the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("S,KV,G,D,dtype,causal,softcap", [
    (256, 2, 2, 64, torch.float32, True, 0.0),
    (300, 1, 4, 128, torch.float32, False, 30.0),
    (1000, 8, 2, 128, torch.bfloat16, True, 0.0),
    (77, 2, 1, 64, torch.bfloat16, False, 0.0),
])
def test_flash_kernel_matches_plain_on_card(S, KV, G, D, dtype, causal, softcap):
    _need_cuda()
    q, k, v = (torch.from_numpy(a).to("cuda", dtype)
               for a in _qkv(2, S, S, KV, G, D, seed=S))
    before = build.LAUNCHES["fa_forward"]
    got = ops.flash_attention(q, k, v, causal=causal, softcap=softcap)
    errs, ok = ref.flash_attention_check(got, q, k, v, causal=causal, softcap=softcap)
    assert build.LAUNCHES["fa_forward"] == before + 1
    assert ok, errs


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,KV,G,D,causal,softcap,qscale", [
    (77, 77, 2, 2, 64, True, 0.0, 1.0),        # shorter than one 128-row tile
    (1000, 1000, 2, 2, 128, True, 0.0, 1.0),   # ragged last tile
    (2049, 2049, 8, 2, 128, True, 0.0, 1.0),   # the first length on the flash path
    (37, 150, 2, 2, 64, True, 0.0, 1.0),       # Sq < Sk
    (150, 37, 2, 2, 128, True, 0.0, 1.0),      # Sq > Sk
    (300, 300, 1, 1, 128, True, 0.0, 1.0),     # G = 1, KV = 1
    (300, 300, 1, 8, 64, True, 0.0, 1.0),      # G = 8
    (333, 333, 2, 2, 64, False, 0.0, 1.0),
    (333, 333, 2, 2, 128, False, 0.0, 1.0),
    (256, 256, 2, 4, 128, True, 30.0, 1.0),    # softcap in bf16
    # D 96: three 32-column boxes under the 64-byte swizzle
    (77, 77, 2, 1, 96, True, 0.0, 1.0),        # shorter than one tile
    (1000, 1000, 2, 2, 96, True, 0.0, 1.0),    # ragged last tile, G = 2
    (37, 150, 2, 2, 96, True, 0.0, 1.0),       # Sq < Sk
    (150, 37, 2, 4, 96, True, 0.0, 1.0),       # Sq > Sk, G = 4
    (1000, 1000, 2, 2, 96, False, 0.0, 1.0),   # non-causal, ragged
    (300, 300, 1, 4, 96, True, 0.0, 1.0),      # KV = 1, G = 4
    # D 64: 192-row q tiles of three consumer warpgroups
    (191, 191, 2, 2, 64, True, 0.0, 1.0),      # one row short of a tile
    (193, 193, 2, 2, 64, True, 0.0, 1.0),      # one row into the second tile
    (385, 385, 2, 3, 64, True, 0.0, 1.0),      # one row into the third
    (385, 385, 2, 3, 64, False, 0.0, 1.0),
    (3072, 3072, 16, 1, 64, False, 0.0, 1.0),  # seamless's encoder at full width
    # grok-1's softcap with q scaled by 8: scores past the cap
    (700, 700, 2, 6, 128, True, 30.0, 8.0),
    (1000, 1000, 2, 6, 128, False, 30.0, 8.0),  # ragged, non-causal
])
def test_flash_bf16_kernel_edges_on_card(Sq, Sk, KV, G, D, causal, softcap, qscale):
    _need_cuda()
    q, k, v = _qkv(2, Sq, Sk, KV, G, D, seed=Sq + Sk + G)
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in (q * qscale, k, v))
    before = build.LAUNCHES["fa_forward"]
    got = ops.flash_attention(q, k, v, causal=causal, softcap=softcap)
    errs, ok = ref.flash_attention_check(got, q, k, v, causal=causal, softcap=softcap)
    assert build.LAUNCHES["fa_forward"] == before + 1
    assert ok, errs


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,KV,G,D,causal,softcap,qscale", [
    (1000, 1000, 2, 2, 128, True, 0.0, 1.0),    # ragged last q tile and K/V tile
    (1000, 1000, 2, 2, 64, False, 0.0, 1.0),
    (37, 150, 2, 2, 64, True, 0.0, 1.0),        # Sq < Sk
    (150, 37, 2, 2, 128, True, 0.0, 1.0),       # Sq > Sk
    (300, 300, 1, 8, 64, True, 0.0, 1.0),       # G = 8
    (1000, 1000, 2, 2, 96, False, 0.0, 1.0),    # D 96, non-causal
    (700, 700, 2, 6, 128, True, 30.0, 8.0),     # softcap, q scaled by 8: scores past the cap
    (2304, 2304, 2, 2, 64, True, 0.0, 1.0),     # the card-against-CPU check's shape
])
def test_flash_f32_kernel_edges_on_card(Sq, Sk, KV, G, D, causal, softcap, qscale):
    """The f32 kernel (3xTF32) against the plain version at its tolerance."""
    _need_cuda()
    q, k, v = _qkv(2, Sq, Sk, KV, G, D, seed=Sq + Sk + G)
    q, k, v = (torch.from_numpy(a).to("cuda") for a in (q * qscale, k, v))
    before = build.LAUNCHES["fa_forward"]
    got = ops.flash_attention(q, k, v, causal=causal, softcap=softcap)
    errs, ok = ref.flash_attention_check(got, q, k, v, causal=causal, softcap=softcap)
    assert build.LAUNCHES["fa_forward"] == before + 1
    assert ok, errs


# the prefills of the benchmark's short-batch cells: one block of lengths,
# B = 16,384 // S, which the model sends to the kernel below FLASH_THRESHOLD
SHORT_BATCH_S = (512, 640, 768, 896, 1152, 1280, 1536, 1920)


@pytest.mark.gpu
@pytest.mark.parametrize("KV,G", [(2, 16), (8, 4)], ids=["kv2_g16", "kv8_g4"])
@pytest.mark.parametrize("S", SHORT_BATCH_S)
def test_flash_kernel_at_short_batch_shapes_on_card(S, KV, G):
    """bf16, causal, D 128 at glm4-9b's (KV 2 × G 16) and mistral-nemo-12b's
    (KV 8 × G 4) heads."""
    _need_cuda()
    B, D = 16384 // S, 128
    g = torch.Generator("cuda").manual_seed(S + G)
    q = torch.randn((B, S, KV, G, D), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, S, KV, D), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, S, KV, D), generator=g, device="cuda").bfloat16()
    before = build.LAUNCHES["fa_forward"]
    got = ops.flash_attention(q, k, v, causal=True)
    errs, ok = ref.flash_attention_check(got, q, k, v, causal=True)
    assert build.LAUNCHES["fa_forward"] == before + 1
    assert ok, errs


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1000, 2304, 7680])
def test_flash_kernel_at_attention_scale_on_card(S):
    """granite-4.0-h-small's attention layers: bf16, causal, D 128, KV 8 x
    G 4, logits times 1/128 in place of 1/sqrt(128): within the kernel's
    tolerance of the plain version and of the einsum path in f32."""
    _need_cuda()
    from repro_torch.models import layers as L

    g = torch.Generator("cuda").manual_seed(S)
    q = torch.randn((1, S, 8, 4, 128), generator=g, device="cuda").bfloat16()
    k = torch.randn((1, S, 8, 128), generator=g, device="cuda").bfloat16()
    v = torch.randn((1, S, 8, 128), generator=g, device="cuda").bfloat16()
    before = build.LAUNCHES["fa_forward"]
    got = ops.flash_attention(q, k, v, causal=True, scale=1 / 128)
    assert build.LAUNCHES["fa_forward"] == before + 1
    errs, ok = ref.flash_attention_check(got, q, k, v, causal=True, scale=1 / 128)
    assert ok, errs
    want = L._einsum_attention(q.float(), k.float(), v.float(), causal=True, softcap=0.0,
                               scale=1 / 128)
    assert (got.float() - want).norm() / want.norm() <= ref.FLASH_BF16_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_product_equals_one_product_an_expert_on_card(dtype):
    """The same on the card, in f32 as in bf16: the dispatch takes the one
    grouped product on every device and dtype."""
    _need_cuda()
    _grouped_case("cuda", dtype)


@pytest.mark.gpu
def test_flash_f32_kernel_past_65535_heads_on_card():
    """B·H = 65,540 (past a grid's y extent, which the f32 kernel once
    refused): every (batch, head) is computed."""
    _need_cuda()
    g = torch.Generator("cuda").manual_seed(3)
    B, S, KV, G, D = 2, 64, 16385, 2, 64
    q = torch.randn((B, S, KV, G, D), generator=g, device="cuda")
    k = torch.randn((B, S, KV, D), generator=g, device="cuda")
    v = torch.randn((B, S, KV, D), generator=g, device="cuda")
    got = ops.flash_attention(q, k, v, causal=True)
    errs, ok = ref.flash_attention_check(got, q, k, v, causal=True)
    assert ok, errs


@pytest.mark.gpu
@pytest.mark.parametrize("S,KV,G,D,dtype,softcap", [
    (1100, 4, 1, 96, torch.bfloat16, 0.0),   # phi-3-vision: head_dim 96, MHA
    (77, 2, 1, 96, torch.bfloat16, 0.0),     # D 96 shorter than one tile
    (300, 2, 2, 96, torch.float32, 0.0),     # D 96 in f32
    (1000, 2, 3, 64, torch.bfloat16, 0.0),   # granite-moe: group 3
    (700, 2, 6, 128, torch.bfloat16, 30.0),  # grok-1: group 6, softcap 30
])
def test_flash_kernel_family_shapes_on_card(S, KV, G, D, dtype, softcap):
    _need_cuda()
    q, k, v = (torch.from_numpy(a).to("cuda", dtype)
               for a in _qkv(2, S, S, KV, G, D, seed=S + G + D))
    before = build.LAUNCHES["fa_forward"]
    got = ops.flash_attention(q, k, v, causal=True, softcap=softcap)
    errs, ok = ref.flash_attention_check(got, q, k, v, causal=True, softcap=softcap)
    assert build.LAUNCHES["fa_forward"] == before + 1
    assert ok, errs


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True])
def test_flash_bf16_kernel_reads_model_views_on_card(rope):
    """q as the model makes it: the projection's einsum output (a strided
    view), then RoPE; k/v sliced out of a wider tensor."""
    _need_cuda()
    from repro_torch.models import layers
    from repro_torch.models.config import get_config

    cfg = get_config("qwen3-1.7b")
    B, S, KV, G, D = 1, 600, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((B, S, 256), dtype=np.float32)).to(
        "cuda", torch.bfloat16)
    wq = torch.from_numpy(rng.standard_normal((256, KV, G, D), dtype=np.float32) / 16).to(
        "cuda", torch.bfloat16)
    q = torch.einsum("bsd,dkgh->bskgh", x, wq)
    if rope:
        cos, sin = layers.rope_freqs(cfg, torch.arange(S, device="cuda"))
        q = layers.apply_rope(q, cos, sin)
    kv = torch.from_numpy(rng.standard_normal((B, S, KV, 3 * D), dtype=np.float32)).to(
        "cuda", torch.bfloat16)
    k, v = kv[..., :D], kv[..., D:2 * D]
    got = ops.flash_attention(q, k, v, causal=True)
    errs, ok = ref.flash_attention_check(got, q, k, v, causal=True)
    assert ok, errs


@pytest.mark.gpu
@pytest.mark.parametrize("na,nb,dtype", [(0, 5, torch.int32), (1003, 777, torch.int32),
                                         (5000, 1, torch.float32),
                                         ((1 << 19) + 1, (1 << 19) + 2, torch.int32)])
def test_merge_kernel_matches_plain_on_card(na, nb, dtype):
    _need_cuda()
    rng = np.random.default_rng(na + nb)
    a = torch.from_numpy(np.sort(rng.integers(0, 1000, na))).to("cuda", dtype)
    b = torch.from_numpy(np.sort(rng.integers(0, 1000, nb))).to("cuda", dtype)
    av = torch.arange(na, dtype=torch.int32, device="cuda")
    bv = torch.arange(na, na + nb, dtype=torch.int32, device="cuda")
    before = build.LAUNCHES["merge_sorted"]
    got = ops.merge_sorted(a, av, b, bv)
    want = ref.merge_sorted_ref(a, av, b, bv)
    torch.cuda.synchronize()
    assert build.LAUNCHES["merge_sorted"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["fetch_72", "900_of_one", "scan_4", "ties_empty", "float_inf",
                                  "uint32", "one_run"])
def test_merge_runs_kernel_matches_plain_on_card(case):
    """The k-way kernel against its plain version, bit for bit, at the
    fetch's shape (900 chunk indices in 72 runs, and in 900 runs of one),
    the pushdown scan's (4 streams of about 50,000 keys tied on few
    values) and at the edges."""
    _need_cuda()
    rng = np.random.default_rng(len(case))
    if case == "fetch_72":
        perm = rng.permutation(900)
        cuts = np.sort(rng.choice(np.arange(1, 900), 71, replace=False))
        runs = [np.sort(r) for r in np.split(perm, cuts)]
        keys = np.concatenate(runs).astype(np.int32)
        vals, off = np.arange(900, dtype=np.int32), np.cumsum([0, *map(len, runs)])
    elif case == "900_of_one":
        keys, vals, off = _runs([1] * 900, rng, 900)
    elif case == "scan_4":
        keys, vals, off = _runs([49_740, 50_780, 50_112, 50_368], rng, 3)
    elif case == "ties_empty":
        keys, vals, off = _runs([0, 300, 0, 1, 5000, 0, 17], rng, 40)
    elif case == "float_inf":
        keys, vals, off = _inf_runs(rng)
    elif case == "uint32":
        keys, vals, off = _runs([1000, 3, 2000], rng, 2**32 - 1, np.uint32)
    else:
        keys, vals, off = _runs([4097], rng, 100)
    k, v = torch.from_numpy(keys).cuda(), torch.from_numpy(vals).cuda()
    before = build.LAUNCHES["merge_runs"]
    got = ops.merge_runs(k, v, off)
    want = ref.merge_runs_ref(k, v, torch.as_tensor(off))
    torch.cuda.synchronize()
    assert build.LAUNCHES["merge_runs"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    order = np.argsort(keys.astype(np.float64), kind="stable")
    np.testing.assert_array_equal(got[1].cpu().numpy(), vals[order])


def _ssd_operands(H, N, B, S, with_h0, seed):
    """The scan's operands as the model hands them, on the card: x, B and C
    bf16 views of one (B, S, H·P + 2N) tensor, dt = softplus(N(0, 2)),
    A = −exp(N(0, 1)), D N(0, 1), h0 N(0, 1) f32."""
    g = torch.Generator("cuda").manual_seed(seed)
    xbc = torch.randn((B, S, H * 64 + 2 * N), generator=g, device="cuda").bfloat16()
    x = xbc[..., :H * 64].reshape(B, S, H, 64)
    Bm, Cm = xbc[..., H * 64:H * 64 + N], xbc[..., H * 64 + N:]
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g, device="cuda") * 2**0.5)
    A = -torch.exp(torch.randn((H,), generator=g, device="cuda"))
    D = torch.randn((H,), generator=g, device="cuda")
    h0 = torch.randn((B, H, N, 64), generator=g, device="cuda") if with_h0 else None
    return x, dt, A, Bm, Cm, D, h0


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "h0"])
@pytest.mark.parametrize("S", [256, 2304, 7680])
@pytest.mark.parametrize("H,N", [(128, 128), (256, 64)], ids=["granite", "jamba"])
def test_ssd_kernel_matches_the_f32_path_on_card(H, N, S, with_h0):
    """``ops.ssd_scan`` against ``ssd_chunked`` in f32 + the D skip on the
    same operands: y within one bf16 rounding of that f32 value, the final
    state to a relative 1e-5 (``ref.ssd_scan_check``)."""
    _need_cuda()
    ops_in = _ssd_operands(H, N, 1, S, with_h0, seed=S + N + with_h0)
    x, dt, A, Bm, Cm, D, h0 = ops_in
    before = build.LAUNCHES["ssd_forward"]
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256, h0=h0)
    assert build.LAUNCHES["ssd_forward"] == before + 1
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    errs, ok = ref.ssd_scan_check(y, h, *ops_in[:6], chunk=256, h0=h0)
    assert ok, errs


@pytest.mark.gpu
def test_ssd_kernel_is_deterministic_on_card():
    _need_cuda()
    x, dt, A, Bm, Cm, D, h0 = _ssd_operands(128, 128, 2, 2304, True, seed=5)
    y1, h1 = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256, h0=h0)
    y2, h2 = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256, h0=h0)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.gpu
def test_ssd_kernel_refuses_what_it_does_not_take_on_card():
    _need_cuda()
    x, dt, A, Bm, Cm, D, _ = _ssd_operands(8, 128, 1, 512, False, seed=1)
    with pytest.raises(ValueError, match="does not take"):
        ops.ssd_scan(x.float(), dt, A, Bm, Cm, D, chunk=256)
    with pytest.raises(ValueError, match="does not take"):
        ops.ssd_scan(x[:, :300], dt[:, :300], A, Bm[:, :300], Cm[:, :300], D, chunk=256)
    with pytest.raises(ValueError, match="contiguous float32"):
        ops.ssd_scan(x, dt.double(), A, Bm, Cm, D, chunk=256)


# ------------------------------------------------------------- RMSNorm
@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,layout,scale_dtype", [
    (1, 4096, "rows", torch.bfloat16),        # the head's last position, a decode step
    (2304, 4096, "rows", torch.bfloat16),     # the shortest long prompt
    (7680, 4096, "rows", torch.bfloat16),     # glm4-9b and granite at the longest
    (7680, 5120, "rows", torch.bfloat16),     # mistral-nemo-12b at the longest
    (16384, 5120, "rows", torch.bfloat16),    # a short batch's 16,384 tokens
    (51, 4096, "rows", torch.bfloat16),       # a ragged last block
    (16, 5120, "head_view", torch.bfloat16),  # x[:, -1:] of a batch of 16: strided rows
    (300, 4096, "rows", torch.float32),       # f32 params, bf16 compute (chip_smoke's archs)
    (33, 2056, "rows", torch.bfloat16),       # d 8 · 257: a lane's last vector past the row
    (5, 24, "rows", torch.bfloat16),          # narrower than a warp's loads
], ids=lambda v: str(v).replace("torch.", ""))
def test_rms_norm_kernel_against_the_plain_formula_on_card(rows, d, layout, scale_dtype):
    """``ops.rms_norm`` against ``ref.rms_norm_ref`` on the card, on the
    same bf16 input (values N(0, 9), a scale 1 + N(0, 0.01)): every output
    within one bf16 ulp, at least 99 % bit-equal (``ref.rms_norm_check``),
    and the same bits on a second call; one launch a call."""
    _need_cuda()
    g = torch.Generator("cuda").manual_seed(rows + d)
    if layout == "head_view":
        x = (3 * torch.randn((rows, 7, d), generator=g, device="cuda")).bfloat16()[:, -1:]
    else:
        x = (3 * torch.randn((rows, d), generator=g, device="cuda")).bfloat16()
    scale = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(scale_dtype)
    before = build.LAUNCHES["rms_norm"]
    y = ops.rms_norm(x, scale)
    y2 = ops.rms_norm(x, scale)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rms_norm"] == before + 2
    assert y.shape == x.shape and y.dtype == torch.bfloat16 and y.is_contiguous()
    errs, ok = ref.rms_norm_check(y, x, scale)
    assert ok, errs
    assert torch.equal(y, y2)


@pytest.mark.gpu
def test_rms_norm_kernel_refuses_what_it_does_not_take_on_card():
    _need_cuda()
    x = torch.randn((4, 64), device="cuda").bfloat16()
    s = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        ops.rms_norm(x.float(), s)
    with pytest.raises(ValueError, match="does not take"):
        ops.rms_norm(x[:, :60], s[:60])
    with pytest.raises(ValueError, match="does not take"):
        ops.rms_norm(x.requires_grad_(), s)
    with pytest.raises(ValueError, match="scale"):
        ops.rms_norm(x.detach(), s[:32])
