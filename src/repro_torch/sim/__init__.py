# Copied from src/repro/sim/__init__.py; only the repro. imports are rewritten.
from repro_torch.sim.des import Sim, Resource  # noqa: F401
from repro_torch.sim.cluster import Cluster, TESTBED  # noqa: F401
