from repro_torch.serve.step import generate, make_decode_step, make_prefill_step  # noqa: F401
from repro_torch.serve.kvstore import (  # noqa: F401
    KvCacheStore,
    KvEntry,
    ServingCrash,
    attach_store,
    register_kv_stubs,
)
