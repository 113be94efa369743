"""The port's sharding rules (``repro_torch.sharding``), the axes half of its
schema and model, its ZeRO-1 specs and its scan-FLOP count on abstract
inputs, against the JAX package's on the CPU. Every comparison is exact:

  * ``make_rules`` and ``spec`` on JAX's ``AbstractMesh`` and the port's,
    for all ten archs at full width on both production meshes (16×16 and
    2×16×16), and the three cases of ``tests/test_sharding_and_train.py``;
  * ``param_axes``, ``cache_axes`` and ``abstract_params`` leaf by leaf
    (path, shape, dtype, axes), and the cache's shapes and dtypes;
  * ``zero1_state_specs`` for adamw, adafactor and sgd;
  * ``measure_scan_flops`` on abstract inputs for xlstm-125m:smoke and
    jamba-1.5-large-398b:smoke;
  * ``lac`` without rules, and with rules on plain tensors, leaves
    qwen3-1.7b:smoke's logits bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.launch.specs import ALL_ARCHS
from repro.models.accounting import measure_scan_flops as jax_measure
from repro.models.config import get_config as jax_config
from repro.models.model import build_model as jax_model
from repro.sharding import make_rules as jax_rules
from repro.train import optim as jax_optim
from repro_torch.models import accounting
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.config import get_config
from repro_torch.models.model import build_model
from repro_torch.sharding import (AbstractMesh, PartitionSpec as P, is_spec, lac,
                                  make_rules, use_rules)
from repro_torch.train import optim
from repro_torch.tree import tree_flatten_with_path, tree_map

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return jax.sharding.AbstractMesh(shape, axes), AbstractMesh(shape, axes)


def _jax_flat(tree, is_leaf=None):
    """{path: leaf} of a JAX tree, paths as tuples of plain keys."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path): leaf
            for path, leaf in flat}


class _Leaf:
    def __init__(self, v):
        self.v = v


def _port_flat(tree, is_leaf):
    """{path: leaf} of a port tree whose leaves ``is_leaf`` picks (specs and
    axes are tuples, so they are boxed first)."""
    boxed = tree_map(_Leaf, tree, is_leaf=is_leaf)
    return {path: leaf.v for path, leaf in tree_flatten_with_path(boxed)}


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _is_jax_axes(x):
    return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)


def _is_port_axes(x):
    return isinstance(x, tuple) and not is_spec(x) and all(
        e is None or isinstance(e, str) for e in x)


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_rules_and_param_specs_match_jax(arch, mesh):
    """The rule table and every param's spec at full width, and the specs
    of arbitrary axes with and without shapes."""
    jm, tm = _meshes(mesh)
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jr, tr = jax_rules(jm, jcfg), make_rules(tm, tcfg)
    assert tr.rules == jr.rules
    jmodel, tmodel = jax_model(jcfg), build_model(tcfg)
    want = _jax_flat(jr.tree_specs(jmodel.param_axes(), jmodel.abstract_params()),
                     is_leaf=lambda x: isinstance(x, JP))
    got = _port_flat(tr.tree_specs(tmodel.param_axes(), tmodel.abstract_params()), is_spec)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k
    for axes, shape in [(("batch", "act_seq", "embed_shard"), (256, 4096, tcfg.d_model)),
                        (("batch", None, "kv_heads", "q_per_kv", None), (32, 7, 8, 2, 128)),
                        (("experts", "embed", "expert_mlp"), (8, 6144, 32768)),
                        (("cache_batch", "kv_seq", "kv_heads", "head_dim"),
                         (128, 32768, 8, 128))]:
        assert tuple(tr.spec(axes, shape)) == tuple(jr.spec(axes, shape))
        assert tuple(tr.spec(axes)) == tuple(jr.spec(axes))


def _fake4():
    shape, axes = (4, 4), ("data", "model")
    return jax.sharding.AbstractMesh(shape, axes), AbstractMesh(shape, axes)


def test_rules_divisibility_fallback():
    """``tests/test_sharding_and_train.py``'s first case, in both packages."""
    jm, tm = _fake4()
    jr, tr = jax_rules(jm, jax_config("glm4-9b")), make_rules(tm, get_config("glm4-9b"))
    assert tr.rules["kv_heads"] is None and tr.rules["q_per_kv"] == "model"
    sp = tr.spec(("batch", "mlp"), (6, 13696))
    assert sp == P(None, "model") and tuple(sp) == tuple(jr.spec(("batch", "mlp"), (6, 13696)))


def test_rules_dedupe_one_axis_per_tensor():
    jm, tm = _fake4()
    jr = jax_rules(jm, jax_config("grok-1-314b"))
    tr = make_rules(tm, get_config("grok-1-314b"))
    axes, shape = ("experts", "embed", "expert_mlp"), (8, 6144, 32768)
    assert tr.spec(axes, shape) == P("model")
    assert tuple(tr.spec(axes, shape)) == tuple(jr.spec(axes, shape))


def test_zero1_specs_extend_dp():
    jm, tm = _fake4()
    jcfg, tcfg = jax_config("qwen3-1.7b"), get_config("qwen3-1.7b")
    jmodel, tmodel = jax_model(jcfg), build_model(tcfg)
    jabs, tabs = jmodel.abstract_params(), tmodel.abstract_params()
    jsp = jax_rules(jm, jcfg).tree_specs(jmodel.param_axes(), jabs)
    tsp = make_rules(tm, tcfg).tree_specs(tmodel.param_axes(), tabs)
    want = jax_optim.zero1_state_specs(jax_optim.adamw(), jsp, jabs, jm, ("data",))
    got = optim.zero1_state_specs(optim.adamw(), tsp, tabs, tm, ("data",))
    leaf = got["m"]["stack"]["scan"][0]["mlp"]["wi"]
    assert any(e == "data" or (isinstance(e, tuple) and "data" in e) for e in leaf)
    assert tuple(leaf) == tuple(want["m"]["stack"]["scan"][0]["mlp"]["wi"])


@pytest.mark.parametrize("arch,optname", [("qwen3-1.7b", "adamw"), ("qwen3-1.7b", "sgd"),
                                          ("grok-1-314b", "adafactor"),
                                          ("jamba-1.5-large-398b", "adafactor")])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero1_state_specs_match_jax(arch, optname, mesh):
    jm, tm = _meshes(mesh)
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jmodel, tmodel = jax_model(jcfg), build_model(tcfg)
    jabs, tabs = jmodel.abstract_params(), tmodel.abstract_params()
    jsp = jax_rules(jm, jcfg).tree_specs(jmodel.param_axes(), jabs)
    tsp = make_rules(tm, tcfg).tree_specs(tmodel.param_axes(), tabs)
    dp = ("pod", "data")
    make = {"adamw": "adamw", "sgd": "sgd_momentum", "adafactor": "adafactor"}[optname]
    want = _jax_flat(jax_optim.zero1_state_specs(getattr(jax_optim, make)(), jsp, jabs, jm, dp),
                     is_leaf=lambda x: isinstance(x, JP))
    got = _port_flat(optim.zero1_state_specs(getattr(optim, make)(), tsp, tabs, tm, dp),
                     is_spec)
    assert got.keys() == want.keys() and len(got) > 0
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k


# --------------------------------------------------------- axes and shapes
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_axes_cache_axes_and_abstract_params_match_jax(arch):
    jmodel, tmodel = jax_model(jax_config(arch)), build_model(get_config(arch))
    want_axes = _jax_flat(jmodel.param_axes(), is_leaf=_is_jax_axes)
    got_axes = _port_flat(tmodel.param_axes(), _is_port_axes)
    want_abs = _jax_flat(jmodel.abstract_params())
    got_abs = _port_flat(tmodel.abstract_params(), lambda x: isinstance(x, torch.Tensor))
    assert got_axes == want_axes
    assert got_abs.keys() == want_abs.keys()
    for k, w in want_abs.items():
        g = got_abs[k]
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape) and _dtype(g.dtype) == _dtype(w.dtype), k
    want_c = _jax_flat(jmodel.cache_axes(), is_leaf=_is_jax_axes)
    got_c = _port_flat(tmodel.cache_axes(), _is_port_axes)
    assert got_c == want_c
    want_cs = _jax_flat(jmodel.cache_spec(4, 96))
    got_cs = _port_flat(tmodel.cache_spec(4, 96),
                        lambda x: isinstance(x, tuple) and len(x) == 2
                        and isinstance(x[1], torch.dtype))
    assert got_cs.keys() == want_cs.keys() == got_c.keys()
    for k, w in want_cs.items():
        assert tuple(got_cs[k][0]) == tuple(w.shape) and _dtype(got_cs[k][1]) == _dtype(w.dtype)


# ------------------------------------------------------------- scan flops
@pytest.mark.parametrize("arch,S", [("xlstm-125m", 128), ("jamba-1.5-large-398b", 2304)])
def test_measure_scan_flops_on_abstract_inputs_matches_jax(arch, S):
    """JAX's ``measure_scan_flops`` evaluates abstractly; the port's runs
    under a FakeTensorMode on ``meta`` params and batch: the same total,
    and nothing allocated (the params are the model's abstract ones)."""
    jmodel, tmodel = jax_model(jax_config(f"{arch}:smoke")), build_model(
        get_config(f"{arch}:smoke"))
    want = jax_measure(lambda p, b: jmodel.apply(p, b, mode="train"),
                       jmodel.abstract_params(),
                       {"tokens": jax.ShapeDtypeStruct((2, S), jnp.int32)})
    got = accounting.measure_scan_flops(
        lambda p, b: tmodel.apply(p, b, mode="train"), tmodel.abstract_params(),
        {"tokens": torch.empty((2, S), dtype=torch.int32, device="meta")})
    assert want > 0 and got == want


# -------------------------------------------------------------------- lac
def test_lac_leaves_plain_logits_bit_equal():
    """Without rules ``lac`` returns its input; with rules installed it
    leaves a tensor that is not a DTensor alone, so qwen3-1.7b:smoke's
    logits are bit-equal either way."""
    cfg = get_config("qwen3-1.7b:smoke").with_(compute_dtype=torch.float32)
    jcfg = jax_config("qwen3-1.7b:smoke").with_(compute_dtype=jnp.float32)
    jp = jax.jit(jax_model(jcfg).init)(jax.random.key(0))
    params = from_jax_params(jax.device_get(jp), cfg, device="cpu")
    model = build_model(cfg)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 40)).astype(np.int32))
    x = torch.randn(2, 3, 4)
    assert lac(x, "batch", None, "mlp") is x
    with torch.no_grad():
        plain, _, _ = model.apply(params, {"tokens": tokens})
        _, tm = _meshes("16x16")
        with use_rules(make_rules(tm, cfg)):
            assert lac(x, "batch", None, "mlp") is x
            ruled, _, _ = model.apply(params, {"tokens": tokens})
    assert torch.equal(plain, ruled)


def test_remat_recomputes_under_the_forwards_rules_on_another_thread():
    """On a CUDA device the backward, and a rematerialised block's
    recomputation in it, run on autograd's own thread, which does not see
    the caller's context: ``remat`` carries the forward's rules there."""
    import threading

    from repro_torch.models.layers import remat
    from repro_torch.sharding import current_rules, make_rules, use_rules

    seen = []

    def fn(x):
        seen.append(current_rules())
        return torch.exp(x)  # its backward reads its output: a recomputation

    rules = make_rules(AbstractMesh((2, 2), ("data", "model")))
    x = torch.ones(3, requires_grad=True)
    with use_rules(rules):
        y = remat(fn, x).sum()
    t = threading.Thread(target=y.backward)
    t.start()
    t.join()
    assert seen == [rules, rules] and torch.equal(x.grad, torch.exp(torch.ones(3)))
