"""What a dry-run row says about itself: a traced row's notes say that a
shard moved between dims is priced as the all-gather that torch emits, not
as the reference's all-to-all (``src/repro/roofline.py`` prices that move
local·(n-1)/n), and every row names the torch release that planned it."""
import pytest
import torch

from repro_torch import roofline as R
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_fake_mesh


@pytest.fixture
def fake_mesh():
    import torch.distributed as dist

    mesh = make_fake_mesh((2, 2), ("data", "model"))
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_a_traced_row_notes_how_a_reshard_is_priced(fake_mesh):
    plan = S.plan_cell("qwen3-1.7b:smoke", "decode_32k", fake_mesh, batch=4, seq=256)
    traced = R.analyze(plan, plan.trace(), "2x2")
    assert traced.notes == f"{plan.notes}; {R.RESHARD_NOTE}"
    assert "all-gather" in R.RESHARD_NOTE and "all-to-all" in R.RESHARD_NOTE
    assert f"torch {torch.__version__.split('+')[0]} " in R.RESHARD_NOTE
    assert R.analyze(plan, None, "2x2").notes == plan.notes  # no trace, no collectives


def test_every_dry_run_row_names_its_torch_release():
    row = dryrun.run_cell("qwen3-1.7b", "decode_32k", False, plan_only=True)
    assert row["status"] == "OK" and row["torch"] == torch.__version__
    assert R.RESHARD_NOTE not in row["notes"]  # planned, not traced
    skip = dryrun.run_cell("qwen3-1.7b", "long_500k", False, plan_only=True)
    assert skip["status"] == "SKIP" and skip["torch"] == torch.__version__
