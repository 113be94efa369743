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
the tensor and over every row (``ref.flash_attention_check``).
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kvmerge, ops, ref

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


def test_flash_softcap_matches_pallas():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 128, 128, 2, 2, 64, seed=5),
                                       torch.float32)
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


def test_flash_wrapper_checks_and_strides():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 64, 64, 2, 2, 64, seed=1))
    before = fa.LAUNCHES
    ops.flash_attention(q, k, v)
    assert fa.LAUNCHES == before  # the plain version is no kernel launch
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :1], v)
    with pytest.raises(ValueError):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
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
    before = kvmerge.LAUNCHES
    mk, mv = ops.merge_sorted(k, k, k[:0], k[:0])
    assert kvmerge.LAUNCHES == before and torch.equal(mk, k)
    u = torch.tensor([1, 3, 2**32 - 2], dtype=torch.uint32)
    mk, _ = ops.merge_sorted(u, k[:3], u, k[:3])
    assert mk.to(torch.int64).tolist() == [1, 1, 3, 3, 2**32 - 2, 2**32 - 2]


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
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal, softcap=softcap)
    errs, ok = ref.flash_attention_check(got, q, k, v, causal=causal, softcap=softcap)
    assert fa.LAUNCHES == before + 1
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
    before = kvmerge.LAUNCHES
    got = ops.merge_sorted(a, av, b, bv)
    want = ref.merge_sorted_ref(a, av, b, bv)
    torch.cuda.synchronize()
    assert kvmerge.LAUNCHES == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
