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


# ---- the port's own options: dropless dispatch, the shared expert, counters
def _port(moe, **over):
    """granite-moe-3b-a800m:smoke at f32 with the MoE fields ``moe``, and
    parameters drawn from a seed."""
    tc = get_config("granite-moe-3b-a800m:smoke").with_(
        compute_dtype=torch.float32, moe=MoEConfig(**moe), **over)
    from repro_torch.models.schema import init_tree

    return tc, init_tree(M.moe_spec(tc), torch.Generator().manual_seed(11))


BASE = dict(num_experts=8, experts_per_token=2, expert_d_ff=64)


@pytest.mark.parametrize("shared", [0, 48])
def test_dropless_equals_the_capacity_path_where_nothing_overflows(shared):
    """capacity_factor E/k gives C = S slots an expert, so no pair can be
    dropped: the dropless dispatch (sorted rows, one grouped product) gives
    the same output and losses, with and without the shared expert, and
    both dispatches' counters read no pair dropped and the same load."""
    cap, p = _port(dict(BASE, capacity_factor=4.0, shared_d_ff=shared))
    drop, _ = _port(dict(BASE, capacity_factor=4.0, shared_d_ff=shared, dropless=True))
    assert M._capacity(40, cap) == 40 and ("shared" in p) == bool(shared)
    x = torch.from_numpy(_x(3, 40, cap.d_model, seed=12))
    y0, a0 = M.apply_moe(p, cap, x)
    y1, a1 = M.apply_moe(p, drop, x)
    _close(y1, y0.numpy(), 1e-5)
    assert set(a0) == set(a1) == {"moe_aux", "moe_z"}
    for k in a0:
        _close(a1[k], float(a0[k]), 1e-6)
    _, eidx, _ = M._route(p, cap, x)
    c0, c1 = M.dispatch_counters(cap, eidx), M.dispatch_counters(drop, eidx)
    assert float(c0["moe_dropped"]) == float(c1["moe_dropped"]) == 0.0
    assert float(c0["moe_load_max"]) == float(c1["moe_load_max"]) >= 1.0
    if shared:
        want = M.apply_mlp(p["shared"], cap, x)
        y2, _ = M.apply_moe({k: v for k, v in p.items() if k != "shared"}, drop, x)
        _close(y1, (y2 + want).numpy(), 1e-5)


def _expert_sum(p, x, gate, eidx, keep):
    """The plain sum over each token's k experts of gate times SwiGLU, over
    the (token, k) pairs that ``keep`` (B,S,K) marks."""
    want = torch.zeros_like(x)
    for e in range(p["router"].shape[1]):
        g = (gate * ((eidx == e) & keep)).sum(-1, keepdim=True)
        h = torch.nn.functional.silu(x @ p["wg"][e]) * (x @ p["wi"][e])
        want += g * (h @ p["wo"][e])
    return want


def test_a_forced_imbalance_drops_pairs_only_on_the_capacity_path():
    """A router that sends nearly every token to experts 0 and 1: the
    capacity path computes only each expert's first C pairs of a sequence,
    in (token, k) order, and ``moe_dropped`` counts the rest; the dropless
    path computes every pair and drops none; both read the same load."""
    cap, p = _port(dict(BASE, capacity_factor=1.25))
    drop, _ = _port(dict(BASE, capacity_factor=1.25, dropless=True))
    p = dict(p, router=p["router"].clone())
    p["router"][:, :2] += 5.0
    x = torch.from_numpy(_x(2, 64, cap.d_model, seed=13)).abs()  # the bias wins
    y0, _ = M.apply_moe(p, cap, x)
    y1, _ = M.apply_moe(p, drop, x)
    gate, eidx, _ = M._route(p, drop, x)
    B, S, K = eidx.shape
    C = M._capacity(S, cap)
    # each pair's place in its expert's queue of the sequence
    ef = eidx.reshape(B, S * K)
    place = (torch.cumsum(torch.nn.functional.one_hot(ef, 8), 1) - 1).gather(-1, ef[..., None])
    keep = (place[..., 0] < C).reshape(B, S, K)
    c0, c1 = M.dispatch_counters(cap, eidx), M.dispatch_counters(drop, eidx)
    assert float(c0["moe_dropped"]) == float((~keep).sum()) >= 2 * (2 * S - 2 * C) * 0.9
    assert float(c1["moe_dropped"]) == 0.0
    assert float(c0["moe_load_max"]) == float(c1["moe_load_max"]) > 3.0  # of 8 at most 4
    _close(y0, _expert_sum(p, x, gate, eidx, keep).numpy(), 1e-5)
    _close(y1, _expert_sum(p, x, gate, eidx, torch.ones_like(keep)).numpy(), 1e-5)
    assert not torch.allclose(y0, y1, atol=1e-3)


def test_granite_4_config_from_the_benchmark_file_has_the_published_widths():
    """``ModelConfig`` built from ``bench/configs/granite-4.0-h-small.json``'s
    widths (as the benchmark builds it: dicts for the MoE and Mamba fields,
    a list for the pattern) holds every published width, and 32.2 B
    parameters."""
    import json
    from pathlib import Path

    from repro_torch.models.config import MambaConfig
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import period_layout

    path = Path(__file__).resolve().parents[1] / "bench/configs/granite-4.0-h-small.json"
    spec = json.loads(path.read_text())
    cfg = get_config(spec["port"]["arch"]).with_(**spec["widths"])
    assert cfg == get_config("granite-4.0-h-small")
    assert (cfg.d_model, cfg.vocab_size, cfg.tie_embeddings) == (4096, 100352, True)
    assert cfg.moe == MoEConfig(num_experts=72, experts_per_token=10, expert_d_ff=768,
                                dropless=True, shared_d_ff=1536)
    assert isinstance(cfg.mamba, MambaConfig) and cfg.mamba.conv_bias
    di = cfg.mamba.expand * cfg.d_model
    assert (di // cfg.mamba.head_dim, cfg.mamba.head_dim, cfg.mamba.d_state) == (128, 64, 128)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.rotary_pct) == (32, 8, 128, 0.0)
    kinds = [cfg.block_kind(i) for i in range(cfg.num_layers)]
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [5, 15, 25, 35]
    assert kinds == ["attn" if t == "attention" else t for t in spec["layer_types"]]
    assert len(period_layout(cfg)) == 10 and all(m for _, m in period_layout(cfg))
    assert (cfg.embedding_multiplier, cfg.residual_multiplier, cfg.attn_scale,
            cfg.logits_scaling) == (12, 0.22, 1 / 128, 16)
    n = build_model(cfg).n_params()
    assert n == 32_207_337_984 and abs(n / 32.2e9 - 1) < 0.001
