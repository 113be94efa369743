"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the same numpy inputs and the same
parameters, at f32 on both sides, so that the tolerance (1e-4, atol and
rtol, as ``tests/test_torch_archs.py`` uses) covers only summation order:

  * ``apply_moe``'s output and both aux losses, swiglu experts
    (granite-moe-3b-a800m:smoke) and gelu experts (grok-1-314b:smoke);
  * a capacity that drops most (token, k) pairs: the same pairs are kept,
    so the tokens whose every pair was dropped come out exactly 0 on both
    sides;
  * ties in the router's probabilities go to the lower expert index, as
    ``jax.lax.top_k`` breaks them;
  * ``_capacity`` and ``moe_active_flops`` equal JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.config import get_config as jax_config
from repro.models.schema import init_tree as jax_init_tree
from repro_torch.models import moe as M
from repro_torch.models.config import MoEConfig, get_config

TOL = 1e-4


def _cfgs(arch, moe=None):
    """(JAX config, port config) of ``arch:smoke`` at f32 compute, with the
    MoE fields ``moe`` (a dict) where given."""
    jc = jax_config(f"{arch}:smoke").with_(compute_dtype=jnp.float32)
    tc = get_config(f"{arch}:smoke").with_(compute_dtype=torch.float32)
    if moe:
        jc, tc = jc.with_(moe=JMoEConfig(**moe)), tc.with_(moe=MoEConfig(**moe))
    return jc, tc


def _params(jc, seed=0):
    """JAX's moe params (its own init) and the same values as tensors."""
    jp = jax.device_get(jax_init_tree(JM.moe_spec(jc), jax.random.key(seed)))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(got).double().numpy(),
                               np.asarray(want, np.float64), atol=tol, rtol=tol)


def _both(jc, tc, jp, tp, x):
    jy, jaux = jax.jit(lambda p, x: JM.apply_moe(p, jc, x))(jp, jnp.asarray(x))
    ty, taux = M.apply_moe(tp, tc, torch.from_numpy(x))
    return (np.asarray(jy), {k: float(v) for k, v in jaux.items()}), (ty, taux)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "grok-1-314b"])
def test_apply_moe_matches_jax(arch):
    jc, tc = _cfgs(arch)
    assert ("wg" in M.moe_spec(tc)) == (tc.mlp_kind == "swiglu")
    jp, tp = _params(jc)
    x = _x(2, 40, tc.d_model, seed=1)
    (jy, jaux), (ty, taux) = _both(jc, tc, jp, tp, x)
    assert ty.shape == (2, 40, tc.d_model)
    _close(ty, jy)
    assert set(taux) == set(jaux) == {"moe_aux", "moe_z"}
    for k in jaux:
        _close(taux[k], jaux[k])


def test_capacity_drops_the_same_pairs_as_jax():
    """capacity_factor 0.1 at S 96: C = 8 slots an expert for 192 pairs
    over 8 experts, so most pairs are dropped. A token whose pairs were all
    dropped gets exactly 0, on both sides, for the same tokens."""
    jc, tc = _cfgs("granite-moe-3b-a800m", moe=dict(
        num_experts=8, experts_per_token=2, expert_d_ff=64, capacity_factor=0.1))
    assert M._capacity(96, tc) == JM._capacity(96, jc) == 8
    jp, tp = _params(jc, seed=3)
    x = _x(2, 96, tc.d_model, seed=4)
    (jy, _), (ty, _) = _both(jc, tc, jp, tp, x)
    _close(ty, jy)
    j_zero = np.all(jy == 0.0, axis=-1)
    t_zero = torch.all(ty == 0.0, dim=-1).numpy()
    assert np.array_equal(j_zero, t_zero)
    assert 0 < int(t_zero.sum()) < t_zero.size  # some tokens dropped whole, not all


def test_top_k_ties_go_to_the_lower_index():
    """Probabilities on a few levels, so that most rows tie: the port's
    top k equals ``jax.lax.top_k``'s values and indices exactly."""
    rng = np.random.default_rng(5)
    probs = (rng.integers(0, 3, (4, 50, 8)) / 4.0).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = M.top_k(torch.from_numpy(probs), 3)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ti.numpy(), np.asarray(ji))


def test_router_tie_dispatches_as_jax():
    """A zero router gives every expert the same probability: every token
    goes to experts 0..k-1 with equal gates, on both sides."""
    jc, tc = _cfgs("grok-1-314b")
    jp, tp = _params(jc, seed=6)
    jp = dict(jp, router=np.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(2, 16, tc.d_model, seed=7)
    _, eidx = M.top_k(torch.softmax(torch.from_numpy(x) @ tp["router"], -1),
                      tc.moe.experts_per_token)
    assert torch.equal(eidx, torch.arange(tc.moe.experts_per_token).expand_as(eidx))
    (jy, jaux), (ty, taux) = _both(jc, tc, jp, tp, x)
    _close(ty, jy)
    for k in jaux:
        _close(taux[k], jaux[k])


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "grok-1-314b"])
def test_capacity_and_active_flops_match_jax(arch):
    for S in (1, 7, 96, 4096):
        jc, tc = jax_config(arch), get_config(arch)
        assert M._capacity(S, tc) == JM._capacity(S, jc)
        assert M.moe_active_flops(2, S, tc) == JM.moe_active_flops(2, S, jc)
