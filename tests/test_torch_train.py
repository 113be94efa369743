"""The port's training path (``repro_torch.train`` and the losses and
attention twin of ``repro_torch.models``) against the JAX package.

Inputs are made with numpy from a seed; model parameters are JAX's, carried
over by ``models.bridge``. Both sides compute in f32 (as
``tests/test_sharding_and_train.py`` does), so the tolerances cover only
the order of f32 sums: 1e-4 (atol and rtol) for losses, gradients, the
attention twin and train states after 1 and 3 steps, and 1e-6 for
optimizer updates from given gradients (one, then a second from the
carried state). On the CPU the flash wrapper takes
its plain version; training must not reach it at all (it is forward only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import get_config as jax_config
from repro.models.model import build_model as jax_model
from repro.train import optim as jopt
from repro.train import step as jstep
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.bridge import from_jax_params, from_jax_state
from repro_torch.models.config import get_config
from repro_torch.models.model import build_model
from repro_torch.train import optim
from repro_torch.train.step import make_eval_step, make_train_step, value_and_grad
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_unflatten

TOL = 1e-4
OPT_TOL = 1e-6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().double().numpy(),
                               np.asarray(want, np.float64), atol=tol, rtol=tol)


def _same_tree(port_tree, jax_tree, tol=TOL):
    """Leaf for leaf in ``jax.tree_util``'s order (sorted dict keys)."""
    got = tree_flatten_with_path(port_tree)
    want = jax.tree_util.tree_flatten_with_path(jax.device_get(jax_tree))[0]
    assert len(got) == len(want)
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.detach().double().numpy(), np.asarray(w, np.float64),
                                   atol=tol, rtol=tol, err_msg="/".join(map(str, path)))


def _configs(arch):
    """(jax cfg, port cfg) at smoke width, f32 compute. qwen3 in the stacked
    layout with remat (the full config's), paper-lm unrolled without."""
    if arch == "qwen3":
        kw = dict(scan_layers=True, remat="block")
        return (jax_config("qwen3-1.7b:smoke").with_(compute_dtype=jnp.float32, **kw),
                get_config("qwen3-1.7b:smoke").with_(compute_dtype=torch.float32, **kw))
    kw = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
              vocab_size=256)
    return (jax_config("paper-lm-100m").with_(compute_dtype=jnp.float32, **kw),
            get_config("paper-lm-100m").with_(compute_dtype=torch.float32, **kw))


_PAIRS = {}


def _pair(arch):
    """(jax model, jax params, port model, port params) on the same weights,
    built once per arch."""
    if arch not in _PAIRS:
        jcfg, tcfg = _configs(arch)
        jm, tm = jax_model(jcfg), build_model(tcfg)
        jp = jax.jit(jm.init)(jax.random.key(0))
        _PAIRS[arch] = (jm, jp, tm, from_jax_params(jax.device_get(jp), tcfg, device="cpu"))
    return _PAIRS[arch]


def _tokens(B, S, vocab, seed):
    t = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 9, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.6).astype(np.float32) if masked else None
    want, wm = JM.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask))
    got, gm = M.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    _close(got, want)
    for k in ("ce", "zloss"):
        _close(gm[k], wm[k])


@pytest.mark.parametrize("masked,chunk", [(False, 8), (True, 8), (True, 7)])
def test_chunked_lm_loss_matches_jax(masked, chunk):
    """chunk 8 splits S 32 in four; 7 does not divide it (one chunk)."""
    jm, jp, tm, tp = _pair("qwen3")
    tcfg = tm.cfg
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    mask = (rng.random((2, 32)) < 0.7).astype(np.float32) if masked else None
    want, wm = jax.jit(lambda p, x, y, m: JM.chunked_lm_loss(jm, p, x, y, m, chunk=chunk))(
        jp, jnp.asarray(x), jnp.asarray(labels), None if mask is None else jnp.asarray(mask))
    got, gm = M.chunked_lm_loss(tm, tp, torch.from_numpy(x), torch.from_numpy(labels),
                                None if mask is None else torch.from_numpy(mask),
                                chunk=chunk)
    _close(got, want)
    for k in ("ce", "zloss"):
        _close(gm[k], wm[k])


# ------------------------------------------------------ the attention twin
@pytest.mark.parametrize("block_q,causal,softcap", [
    (JL.FLASH_BLOCK_Q, True, 0.0),  # Sq <= block_q: KV blocks of 384
    (1024, True, 0.0),  # q blocks of 768 below Sq
    (1024, False, 30.0),
])
def test_chunked_attention_twin_matches_jax(block_q, causal, softcap):
    """Forward and the gradients of <out, dout> w.r.t. q, k and v (jax.grad
    against autograd) at S 2,304, the first length past the threshold."""
    B, S, KV, G, D = 1, L.FLASH_THRESHOLD + 256, 2, 2, 16
    rng = np.random.default_rng(2)
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32)
                     for s in [(B, S, KV, G, D), (B, S, KV, D), (B, S, KV, D),
                               (B, S, KV, G, D)])

    def jfn(q, k, v):
        out = JL._flash_attention_qchunked(q, k, v, causal=causal, softcap=softcap,
                                           block_q=block_q)
        return jnp.sum(out * dout), out

    (_, want), wgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = L._flash_attention_qchunked(tq, tk, tv, causal=causal, softcap=softcap,
                                      block_q=block_q)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dout))
    _close(got, want)
    for g, w in zip(grads, wgrads):
        _close(g, w)


def test_flash_attention_refuses_inputs_that_require_grad():
    """The kernel is forward only: while autograd records through q, k or v
    the wrapper raises on either device, here on the CPU."""
    B, S, KV, G, D = 1, 8, 1, 2, 64
    q = torch.randn(B, S, KV, G, D, requires_grad=True)
    k, v = torch.randn(B, S, KV, D), torch.randn(B, S, KV, D)
    for fn in (ops.flash_attention, fa.flash_attention):
        with pytest.raises(ValueError, match="forward-only"):
            fn(q, k, v)
        with pytest.raises(ValueError, match="forward-only"):
            fn(q.detach(), k.requires_grad_(), v)
        k.requires_grad_(False)
        with torch.no_grad():
            assert fn(q, k, v).shape == q.shape  # nothing recorded: the plain version


def test_value_and_grad_refuses_a_param_the_loss_does_not_reach():
    """A param cut off from the loss, as by a forward-only kernel's output,
    raises naming it instead of training with a zero gradient."""
    params = {"a": torch.ones(3), "blocks": [{"w": torch.ones(2)}, {"w": torch.ones(2)}]}

    def loss_fn(p, _):
        out = (p["a"] * 2).sum() + p["blocks"][0]["w"].sum() + p["blocks"][1]["w"].detach().sum()
        return out, {}

    with pytest.raises(ValueError, match=r"\['blocks/1/w'\]"):
        value_and_grad(loss_fn, params, {})
    loss, _, grads = value_and_grad(lambda p, b: (p["a"].sum(), {}), {"a": torch.ones(3)}, {})
    assert float(loss) == 3 and torch.equal(grads[0], torch.ones(3))


def test_train_grad_through_chunked_attention_matches_jax():
    """At smoke width and S 2,304 the port's train loss takes the chunked
    twin, never the flash entry point, and the gradient of every layer's
    wq equals JAX's."""
    jm, jp, tm, tp = _pair("qwen3")
    tcfg = tm.cfg
    b = _tokens(1, L.FLASH_THRESHOLD + 256, tcfg.vocab_size, seed=3)
    (wl, _), wg = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True))(jp, _jb(b))
    calls = []
    real = L.ops.flash_attention
    L.ops.flash_attention = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        gl, _, grads = value_and_grad(tm.train_loss, tp, _tb(b))
    finally:
        L.ops.flash_attention = real
    assert not calls
    _close(gl, wl)
    gtree = tree_unflatten(tp, grads)
    got = gtree["stack"]["scan"][0]["attn"]["wq"]
    want = wg["stack"]["scan"][0]["attn"]["wq"]
    assert float(np.abs(np.asarray(want)).max()) > 0
    _close(got, want)
    assert len(tree_leaves(gtree)) == len(jax.tree.leaves(wg))


# -------------------------------------------------------------- optimizers
def _opt_problem(seed=4):
    """Params with 1-D, 2-D and 3-D leaves, gradients and a step of 5."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "s": (3, 4, 2)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.standard_normal(s) * 2).astype(np.float32) for k, s in shapes.items()}
    return p, g


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_one_optimizer_update_matches_jax(name):
    sched = (jopt.cosine_schedule(3, 20), optim.cosine_schedule(3, 20))
    make = {"adamw": lambda m, s: m.adamw(lr=1e-2, schedule=s),
            "adafactor": lambda m, s: m.adafactor(lr=1e-2, weight_decay=0.1, schedule=s),
            "sgd": lambda m, s: m.sgd_momentum(lr=0.1, grad_clip=1.0)}[name]
    jo, to = make(jopt, sched[0]), make(optim, sched[1])
    p, g = _opt_problem()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = jo.init(jp)
    # a second update, so that the state carries into it
    for _ in range(2):
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                           jnp.asarray(5, jnp.int32))
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = to.init(tp)
    for _ in range(2):
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp,
                           torch.tensor(5, dtype=torch.int32))
    _same_tree(tp, jp, OPT_TOL)
    _same_tree(ts, js, OPT_TOL)


def test_cosine_schedule_and_for_config_match_jax():
    jf, tf = jopt.cosine_schedule(10, 100, 0.2), optim.cosine_schedule(10, 100, 0.2)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        _close(tf(torch.tensor(s, dtype=torch.int32)), jf(jnp.asarray(s, jnp.int32)),
               OPT_TOL)
    for name in ("qwen3-1.7b", "paper-lm-100m"):
        assert optim.for_config(get_config(name)).name == \
            jopt.for_config(jax_config(name)).name == "adamw"


# ------------------------------------------------------------- train steps
_RUNS = {}


def _steps(arch, microbatches):
    """Three AdamW steps (lr 3e-4, the for_config default) from the same
    JAX init on one TokenPipeline-shaped batch stream, in JAX and in the
    port: each step's metrics and params. Cached per case."""
    key = (arch, microbatches)
    if key not in _RUNS:
        jcfg, tcfg = _configs(arch)
        jm, tm = jax_model(jcfg), build_model(tcfg)
        jo, to = jopt.adamw(lr=3e-4), optim.adamw(lr=3e-4)
        js = jstep.init_state(jm, jo, params=_pair(arch)[1])
        ts = from_jax_state(jax.device_get(js), tcfg, device="cpu")
        jf = jax.jit(jstep.make_train_step(jm, jo, microbatches=microbatches))
        tf = make_train_step(tm, to, microbatches=microbatches)
        out = []
        for i in range(3):
            b = _tokens(4, 32, tcfg.vocab_size, seed=10 + i)
            js, jmet = jf(js, _jb(b))
            ts, tmet = tf(ts, _tb(b))
            out.append((jax.device_get(jmet), {k: v.clone() for k, v in tmet.items()},
                        jax.device_get(js["params"]),
                        {"params": [t.clone() for _, t in
                                    tree_flatten_with_path(ts["params"])]},
                        int(js["step"]), int(ts["step"])))
        _RUNS[key] = out
    return _RUNS[key]


@pytest.mark.parametrize("arch", ["qwen3", "paper-lm"])
@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(arch, microbatches, n_steps):
    jmet, tmet, jparams, tparams, jstep_, tstep_ = _steps(arch, microbatches)[n_steps - 1]
    assert jstep_ == tstep_ == n_steps
    for k in ("loss", "grad_norm", "ce", "zloss"):
        _close(tmet[k], jmet[k])
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(want) == len(tparams["params"])
    for (path, w), g in zip(want, tparams["params"]):
        np.testing.assert_allclose(g.double().numpy(), np.asarray(w, np.float64),
                                   atol=TOL, rtol=TOL, err_msg=str(path))


def test_eval_step_matches_jax():
    jm, jp, tm, tp = _pair("paper-lm")
    b = _tokens(2, 16, tm.cfg.vocab_size, seed=5)
    want = jax.jit(jstep.make_eval_step(jm))(jp, _jb(b))
    got = make_eval_step(tm)(tp, _tb(b))
    for k in ("loss", "ce", "zloss"):
        _close(got[k], want[k])
