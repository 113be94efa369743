"""The port's kernel entry points take the reference's signatures
(``src/repro/kernels/ops.py``): ``ops.flash_attention`` accepts the Pallas
tile sizes ``block_q`` and ``block_kv``, which the Hopper kernel does not
read (it picks its own tiles), so the result does not depend on them; the
calls of ``tests/test_kernels.py``'s flash sweep and softcap case run on
the port unchanged and agree with the JAX package's reference at that
file's tolerances. On the CPU the wrapper takes its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import build, ops


def _inputs(B, S, KV, G, D, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(B, S, KV, G, D), (B, S, KV, D), (B, S, KV, D)])
    return tuple(torch.from_numpy(a).to(dtype) for a in (q, k, v))


def _jax_ref(q, k, v, *, causal, softcap=0.0):
    """``tests/test_kernels.py``'s reference: the JAX package's
    ``ref.flash_attention_ref`` over the flattened heads, in f32."""
    B, S, KV, G, D = q.shape
    qf, kf, vf = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    qf = qf.transpose(0, 2, 3, 1, 4).reshape(B * KV * G, S, D)
    kf = kf.transpose(0, 2, 1, 3).reshape(B * KV, S, D)
    vf = vf.transpose(0, 2, 1, 3).reshape(B * KV, S, D)
    o = jref.flash_attention_ref(qf, kf, vf, causal=causal, softcap=softcap)
    return np.asarray(o.reshape(B, KV, G, S, D).transpose(0, 3, 1, 2, 4))


@pytest.mark.parametrize("causal,softcap", [(True, 0.0), (False, 0.0), (True, 30.0)])
def test_block_sizes_do_not_change_the_result(causal, softcap):
    q, k, v = _inputs(2, 200, 2, 4, 64, seed=0)
    want = ops.flash_attention(q, k, v, causal=causal, softcap=softcap)
    before = build.LAUNCHES["fa_forward"]
    for bq, bkv in [(64, 128), (256, 256), (128, 64)]:
        got = ops.flash_attention(q, k, v, causal=causal, softcap=softcap,
                                  block_q=bq, block_kv=bkv)
        assert torch.equal(got, want)
    assert build.LAUNCHES["fa_forward"] == before  # CPU tensors: the plain version


@pytest.mark.parametrize("S,KV,G,D,blk", [
    (128, 1, 1, 64, 64),
    (256, 2, 4, 64, 128),
    (256, 4, 1, 128, 64),
    (512, 2, 2, 32, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_reference_flash_sweep_call_runs_on_the_port(S, KV, G, D, blk, dtype, causal):
    """``tests/test_kernels.py::test_flash_attention_sweep``'s call."""
    B = 2
    q, k, v = _inputs(B, S, KV, G, D, seed=S + KV + G, dtype=dtype)
    o = ops.flash_attention(q, k, v, causal=causal, block_q=blk, block_kv=blk)
    assert o.dtype == dtype and o.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(o.float().numpy(), _jax_ref(q, k, v, causal=causal),
                               atol=tol, rtol=tol)


def test_reference_softcap_call_runs_on_the_port():
    """``tests/test_kernels.py::test_flash_attention_softcap``'s call."""
    q, k, v = _inputs(1, 128, 2, 2, 64, seed=7)
    o = ops.flash_attention(q, k, v, causal=True, softcap=30.0, block_q=64, block_kv=64)
    np.testing.assert_allclose(o.numpy(), _jax_ref(q, k, v, causal=True, softcap=30.0),
                               atol=2e-5, rtol=2e-5)


def test_block_sizes_are_keyword_only_as_in_the_reference():
    import inspect

    from repro.kernels import ops as jops

    want = inspect.signature(jops.flash_attention.__wrapped__).parameters
    got = inspect.signature(ops.flash_attention).parameters
    # the port's own ``scale`` (None: 1/sqrt(D)) follows JAX's parameters
    assert list(got) == list(want) + ["scale"]
    for name in want:
        assert got[name].kind == want[name].kind and got[name].default == want[name].default
    assert got["scale"].kind == inspect.Parameter.KEYWORD_ONLY and got["scale"].default is None
    q, k, v = _inputs(1, 16, 1, 1, 64, seed=1)
    with pytest.raises(TypeError):
        ops.flash_attention(q, k, v, True, 0.0, 64, 64)
