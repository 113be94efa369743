"""OffloadFS storage plane, copied from ``repro.core``: the eight modules
the offload plane imports (block device, extents, file system, RPC fabric,
admission, MemTier, engine, offloader)."""
from repro_torch.core.blockdev import BLOCK_SIZE, BlockDevice  # noqa: F401
from repro_torch.core.extents import Extent, ExtentManager  # noqa: F401
from repro_torch.core.fs import OffloadFS  # noqa: F401
from repro_torch.core.rpc import FaultyFabric, RpcFabric  # noqa: F401
from repro_torch.core.engine import OffloadEngine  # noqa: F401
from repro_torch.core.memtier import (  # noqa: F401
    MemTier,
    MemTierNode,
    serve_memtier,
)
from repro_torch.core.offloader import TaskOffloader, serve_engine  # noqa: F401
from repro_torch.core.admission import (  # noqa: F401
    AcceptAll,
    CPUThreshold,
    RejectAll,
    TokenRing,
)
