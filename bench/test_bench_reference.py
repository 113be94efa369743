"""The plain reference against the program at small sizes on the CPU: the
same weights (the benchmark's, from a seed) and prompts, the program in
float32, the last position's logits and every layer's cached k and v."""
import pytest
import torch

from bench import harness, weights
from bench.reference import dense_gqa


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU runs on one intra-op thread, so that a parallel test run
    keeps its cores for the other workers and their timing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SMALL = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 256}


def program(arch, scan, dtype=torch.float32, **over):
    from repro_torch.models.config import get_config
    from repro_torch.models.model import build_model

    cfg = get_config(f"{arch}:smoke").with_(scan_layers=scan, param_dtype=dtype,
                                            compute_dtype=dtype, **over)
    return cfg, build_model(cfg)


def widths(cfg):
    return {"num_layers": cfg.num_layers, "d_model": cfg.d_model, "num_heads": cfg.num_heads,
            "num_kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
            "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
            "rotary_pct": cfg.rotary_pct}


@pytest.mark.parametrize("arch,scan,seq,rows,over", [
    ("glm4-9b", False, 64, 2, {}),  # G 2, rotary on half of each head
    ("glm4-9b", True, 48, 3, {}),  # the stacked layout the cells run
    ("mistral-nemo-12b", True, 40, 2, {"head_dim": 32}),  # head_dim ≠ d/heads
    ("mistral-nemo-12b", False, 2100, 1, {"num_kv_heads": 1}),  # past the flash threshold, G 4
])
def test_reference_matches_the_program_in_f32(arch, scan, seq, rows, over):
    cfg, model = program(arch, scan, **over)
    params = weights.make(model.abstract_params(), 2**31 + 3, "cpu", torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (rows, seq),
                         generator=torch.Generator().manual_seed(5), dtype=torch.int32)
    with torch.inference_mode():
        logits, cache = harness.program_step(model, seq)(params, {"tokens": toks})
        kv = harness.program_kv(cache)
        got = []
        ref = dense_gqa.prefill(params, widths(cfg), toks, attn_block=16,
                                on_kv=lambda i, k, v: got.append((k, v)))
    assert len(got) == len(kv) == cfg.num_layers
    scale = ref.abs().max()
    assert (logits[:, -1].float() - ref).abs().max() <= 2e-5 * scale
    for (pk, pv), (rk, rv) in zip(kv, got):
        assert pk.shape == rk.shape and pv.shape == rv.shape
        assert (pk - rk).abs().max() <= 2e-5 * rk.abs().max()
        assert (pv - rv).abs().max() <= 2e-5 * rv.abs().max()


def test_control_precision_departs_and_f32_does_not():
    cfg, model = program("glm4-9b", True)
    params = weights.make(model.abstract_params(), 7, "cpu", torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    f32 = dense_gqa.prefill(params, widths(cfg), toks)
    again = dense_gqa.prefill(params, widths(cfg), toks, attn_block=7)
    fp8 = dense_gqa.prefill(params, widths(cfg), toks, precision="fp8")
    assert torch.allclose(f32, again, rtol=1e-5, atol=1e-5)  # blocks change no answer
    rel = (fp8 - f32).norm() / f32.norm()
    assert 0.01 < rel < 0.5
    with pytest.raises(ValueError):
        dense_gqa.Precision("int4")


def test_fp8_round_keeps_three_mantissa_bits():
    x = torch.tensor([[1.0, 1.0625, 1.125, -448.0, 0.5]])
    y = dense_gqa.fp8_round(x, -1)
    assert y[0, 0] == 1.0 and y[0, 2] == 1.125 and y[0, 3] == -448.0
    assert y[0, 1] in (1.0, 1.125)  # 1 + 1/16 is not representable


def test_weights_are_seeded_views_with_unit_norm_scales():
    cfg, model = program("glm4-9b", True, dtype=torch.bfloat16)
    a = weights.make(model.abstract_params(), 11, "cpu")
    b = weights.make(model.abstract_params(), 11, "cpu")
    c = weights.make(model.abstract_params(), 12, "cpu")
    wq = a["stack"]["scan"][0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (2, 64, 2, 2, 128)  # smoke keeps head_dim 128
    assert torch.equal(wq, b["stack"]["scan"][0]["attn"]["wq"])
    assert not torch.equal(wq, c["stack"]["scan"][0]["attn"]["wq"])
    scales = torch.cat([a["final_ln"]["scale"].float(),
                        a["stack"]["scan"][0]["ln1"]["scale"].float().flatten(),
                        a["stack"]["scan"][0]["ln2"]["scale"].float().flatten()])
    assert scales.mean().item() == pytest.approx(1.0, abs=0.03)  # 1 + N(0, 0.1²)
    assert scales.std().item() == pytest.approx(weights.SCALE_SD, rel=0.25)
    assert not torch.equal(a["final_ln"]["scale"], c["final_ln"]["scale"])
    unit = weights.with_unit_scales(a)
    assert torch.all(unit["final_ln"]["scale"] == 1)
    assert unit["stack"]["scan"][0]["attn"]["wq"] is wq
    assert wq.float().std().item() == pytest.approx(64 ** -0.5, rel=0.1)
    wo = a["stack"]["scan"][0]["attn"]["wo"]
    assert wo.float().std().item() == pytest.approx(512 ** -0.5, rel=0.1)  # fan-in 2·2·128
    assert a["embed"].float().std().item() == pytest.approx(1.0, rel=0.1)
    assert wq.storage_offset() % weights.ALIGN == 0  # 128-byte starts in one buffer
    n = sum(t.numel() for t in (a["embed"], a["lm_head"], wq, wo))
    assert n < model.n_params()
