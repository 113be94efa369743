"""The paper's evaluation on the port (``benchmarks_torch``, ``examples_torch``)
against the JAX package's (``benchmarks``, ``examples``) on the CPU:

  * the figures copied verbatim, or with only the device passed to each
    OffloadDB, equal their sources once the imports are rewritten and the
    history notes cut, under their one-line header;
  * each figure of ``SMOKE_MODULES`` but fig2 (pure DES, 30 s, a verbatim
    copy) runs as the port's module with the CPU device and as the JAX
    module twice: every functional claim PASSes in all three runs, and
    every row but the named ones that read the wall clock or thread timing
    (``torch_bench_util.RACY``) is printed, in order, identically by both
    JAX runs and by the port, value for value (name and value alone where
    only its text reads thread timing, ``VALUE_ONLY``);
  * ``benchmarks_torch.run`` keeps the reference's flags and exit code,
    adds ``--device``, and refuses a CUDA device without a card;
  * ``tools.reprolint`` finds nothing in the two new trees, and each
    ``examples_torch`` script exits 0 with ``--device cpu``.

fig20, fig21 and fig22 and fig20's full-width path are in
``test_torch_benchmarks_serving.py``.
"""
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
from torch_bench_util import ROOT, TC, compare_with_reference, rows

# the copies: verbatim, and those whose only change passes the device
VERBATIM = ["fig2_fs_overhead", "fig7a_offload_levels", "fig7b_prep_ratio",
            "fig8_db_scalability", "fig9_prep_scalability", "fig10_designs",
            "fig11_latency_throughput", "fig19_router_failover", "fig22_memtier"]
DEVICE_ONLY = ["fig12_cache_timeline", "fig13_cache_pollution", "fig14_sharded_plane",
               "fig15_async_wal", "fig16_striped_extents", "fig17_rebalance"]

def rewrite(src: str) -> str:
    """A reference source as the copies carry it: imports rewritten to the
    port's packages, the history notes "(…, PR n)" and "PR n's" cut."""
    src = re.sub(r"\bbenchmarks\.", "benchmarks_torch.", re.sub(r"\brepro\.", "repro_torch.", src))
    return re.sub(r"PR \d+'s ", "the ", re.sub(r", PR \d+\)", ")", src))


def body(path: Path) -> str:
    """A copy without its header comment."""
    lines = path.read_text(encoding="utf-8").split("\n")
    while lines and lines[0].startswith("#"):
        lines.pop(0)
    return "\n".join(lines)


@pytest.mark.parametrize("name", VERBATIM + DEVICE_ONLY)
def test_copies_equal_their_sources(name):
    copy = ROOT / "benchmarks_torch" / f"{name}.py"
    assert copy.read_text(encoding="utf-8").startswith(f"# Copied from benchmarks/{name}.py; ")
    got = body(copy)
    if name in DEVICE_ONLY:
        assert got.count("device=device()") >= 1
        got = got.replace(", device=device()", "").replace("check, device, emit", "check, emit")
    assert got == rewrite((ROOT / "benchmarks" / f"{name}.py").read_text(encoding="utf-8"))


def test_common_is_the_reference_plus_the_device():
    got = body(ROOT / "benchmarks_torch" / "common.py")
    want = rewrite((ROOT / "benchmarks" / "common.py").read_text(encoding="utf-8"))
    assert got.startswith(want)
    added = got[len(want):]
    assert re.findall(r"^(?:def )?(\w+)", added, re.M) == ["DEVICE", "device", "sync",
                                                          "WALL_CLOCK"]


@pytest.mark.parametrize("name", ["fig14_sharded_plane", "fig15_async_wal",
                                  "fig16_striped_extents", "fig17_rebalance",
                                  "fig18_prep_pipeline", "fig19_router_failover",
                                  "roofline_report"])
def test_smoke_figure_rows_match_the_reference(name, monkeypatch):
    compare_with_reference(name, monkeypatch)


def test_roofline_report_reads_the_ports_dry_run(tmp_path, monkeypatch):
    from benchmarks_torch import roofline_report

    out = tmp_path / "dryrun_torch.jsonl"
    out.write_text(
        '{"arch": "qwen3-1.7b", "cell": "long_500k", "mesh": "16x16", "status": "SKIP",'
        ' "reason": "full attention at 500k", "torch": "2.13.0"}\n'
        '{"arch": "qwen3-1.7b", "cell": "decode_32k", "mesh": "16x16", "status": "OK",'
        ' "torch": "2.13.0", "t_compute_ms": 0.5, "t_memory_ms": 0.25,'
        ' "t_collective_ms": 11.7, "bottleneck": "collective", "mem_per_dev_GiB": 1.89,'
        ' "useful_ratio": 0.5, "coll_bytes_per_dev": 5.836e8}\n', encoding="utf-8")
    monkeypatch.setattr(roofline_report, "RESULTS", [str(out)])
    got = rows(TC, roofline_report, ["roofline_report"], monkeypatch)
    assert got[0] == ("roofline/qwen3-1.7b/decode_32k/16x16", "11.70",
                      "bottleneck=collective tc=0.50ms tm=0.25ms tx=11.70ms mem=1.89GiB "
                      "useful=0.50 coll_GB=0.5836 torch=2.13.0")
    assert got[1][:2] == ("roofline/qwen3-1.7b/long_500k/16x16", "SKIP")
    assert got[2] == ("roofline/cells_ok", "1", "skipped=1")


# ------------------------------------------------------------ the harness
def test_run_keeps_the_modules_and_flags_and_adds_device(monkeypatch, capsys):
    pytest.importorskip("jax")
    from benchmarks import run as jax_run
    from benchmarks_torch import run

    assert run.MODULES == [m.replace("benchmarks.", "benchmarks_torch.") for m in jax_run.MODULES]
    assert run.SMOKE_MODULES == [m.replace("benchmarks.", "benchmarks_torch.")
                                 for m in jax_run.SMOKE_MODULES]
    assert run.main(["--help"]) == 0 and "--device" in capsys.readouterr().out
    assert run.main(["--out"]) == 2 and run.main(["--device"]) == 2
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    monkeypatch.setattr(TC, "DEVICE", "cuda")
    monkeypatch.setattr(sys, "argv", ["run"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["--smoke", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.device()  # a figure run alone, without --device


def test_run_exit_code_counts_failed_claims_and_crashes(monkeypatch):
    from benchmarks_torch import run

    def good():
        TC.check("x/holds", True)

    def bad():
        TC.check("x/fails", False)

    def crash():
        raise ValueError("boom")

    mods = {"m_good": good, "m_bad": bad, "m_crash": crash}
    for name, fn in mods.items():
        mod = types.ModuleType(name)
        mod.main = fn
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setattr(run, "SMOKE_MODULES", list(mods))
    monkeypatch.setattr(TC, "FAILURES", 0)
    assert run.main(["--smoke", "--device", "cpu"]) == 2


# ---------------------------------------------------------- lint, examples
def test_reprolint_finds_nothing_in_the_new_trees():
    from tools.reprolint import run

    res = run([ROOT / "benchmarks_torch", ROOT / "examples_torch"], baseline=set())
    assert res.ok, "\n".join(f.render() for f in res.findings)
    assert res.files == len(list((ROOT / "benchmarks_torch").glob("*.py"))) + 3


@pytest.mark.parametrize("script", ["quickstart.py", "prep_pipeline.py", "serving.py"])
def test_examples_run_on_the_cpu(script):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(ROOT / "examples_torch" / script),
                           "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = {"quickstart.py": "recovered: levels", "prep_pipeline.py": "rpc bytes",
            "serving.py": "deterministic decode: OK"}[script]
    assert proc.stdout.strip().splitlines()[-1].startswith(last)
