# Copied from src/repro/core/lsm/__init__.py; only the repro. imports are rewritten.
"""OffloadDB — an LSM-tree KV store on OffloadFS with offloaded MemTable
flush (Log Recycling) and compaction (paper §IV)."""
from repro_torch.core.lsm.db import OffloadDB, DBConfig  # noqa: F401
