"""The port's OffloadDB and pushdown plane (``repro_torch.core``) against
the dict model and the JAX package's DB.

``tests/pushdown_util.py``'s generators drive one random op stream into a
port-built plane (the DB merging on ``device="cpu"``, where the merge
wrapper takes its plain version) and into the JAX package's plane; each
random program's pushdown and local scans on the port must equal
``reference(model, prog)`` and the JAX DB's rows exactly. The merge kernel
itself is held against its plain version on the card in
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""
import random

import pytest

from repro_torch.core import AcceptAll, BlockDevice, OffloadEngine, OffloadFS, RpcFabric
from repro_torch.core import pushdown as P
from repro_torch.core.lsm import compaction as C
from repro_torch.core.lsm.db import DBConfig, OffloadDB
from repro_torch.core.offloader import TaskOffloader, serve_engine

try:  # the JAX package's plane; the machine with the card has no jax
    import jax  # noqa: F401

    import pushdown_util as U
    from repro.core import pushdown as JP
except ImportError:
    U = None


def _need_jax():
    if U is None:
        pytest.skip("needs jax for the JAX reference")


def _db_config():
    # pushdown_util.build_plane's (L0 tables stay on rotating stripes), with
    # every WAL append on the device before it returns
    return DBConfig(memtable_bytes=4 * 1024, log_recycling=False, l0_cache=False,
                    l0_trigger=999, sync_wal=True)


def _port_plane(n_targets, *, dev=None):
    """``pushdown_util.build_plane`` built from the port's modules; with
    ``dev`` it remounts that device and recovers the DB."""
    mount = dev is not None
    dev = dev or BlockDevice(num_blocks=1 << 14)
    fs = (OffloadFS.mount(dev, node="init0") if mount
          else OffloadFS(dev, node="init0", shards=n_targets))
    fabric = RpcFabric()
    for t in range(n_targets):
        eng = OffloadEngine(fs, node=f"storage{t}")
        eng.register_stub("compact", C.stub_compact)
        eng.register_stub("log_recycle", C.stub_log_recycle)
        P.register_pushdown_stub(eng)
        serve_engine(eng, fabric, AcceptAll())
    off = TaskOffloader(fs, fabric, node="init0",
                        targets=[f"storage{t}" for t in range(n_targets)],
                        lb_policy="placement_affinity")
    if mount:
        return dev, fs, fabric, OffloadDB.recover(fs, off, _db_config(), device="cpu")
    return dev, fs, fabric, OffloadDB(fs, off, _db_config(), device="cpu")


class _Both:
    """One op stream into two DBs."""

    def __init__(self, *dbs):
        self.dbs = dbs

    def put(self, k, v):
        for db in self.dbs:
            db.put(k, v)

    def delete(self, k):
        for db in self.dbs:
            db.delete(k)

    def flush_all(self):
        for db in self.dbs:
            db.flush_all()


@pytest.mark.parametrize("seed", range(8))
def test_scans_match_model_and_jax_db(seed):
    _need_jax()
    rng = random.Random(seed)
    n_targets = rng.choice((1, 2, 3))
    _, fs, _, db = _port_plane(n_targets)
    jfs, _, _, jdb = U.build_plane(n_targets)
    model = {}
    U.random_corpus(rng, _Both(db, jdb), model)
    for _ in range(6):
        prog = U.random_program(rng)
        expect = U.reference(model, prog)
        assert db.scan(program=prog, pushdown=True) == expect
        assert db.scan(program=prog, pushdown=False) == expect
        assert jdb.scan(program=prog, pushdown=True) == expect
    assert db.stats["pushdown_scans"] == jdb.stats["pushdown_scans"] == 6
    assert not fs._leases and not jfs._leases


def test_recover_after_remount():
    """Tables on the stripes plus a tail left in the WAL: after a crash
    and a remount, the recovered DB (merging on the given device) reads
    and scans what the model holds."""
    _need_jax()
    rng = random.Random(42)
    dev, fs, fabric, db = _port_plane(3)
    model = {}
    U.random_corpus(rng, db, model, n_ops=200)
    for i in range(10):  # an unflushed tail: only the WAL holds it
        db.put(f"k{i:04d}".encode(), b"A-tail")
        model[f"k{i:04d}".encode()] = b"A-tail"
    fs.flush_metadata()
    fabric.drain()
    del db, fs, fabric

    _, fs2, _, db2 = _port_plane(3, dev=dev)
    assert db2.device == "cpu"
    for k in [f"k{i:04d}".encode() for i in range(U.KEYSPACE)]:
        assert db2.get(k) == model.get(k)
    for _ in range(4):
        prog = U.random_program(rng)
        assert db2.scan(program=prog, pushdown=True) == U.reference(model, prog)
    assert not fs2._leases


@pytest.mark.parametrize("seed", range(4))
def test_merge_row_streams_matches_jax(seed):
    """Per-target streams with shared 4-byte prefixes (tie groups), keys
    repeated across streams at different ranks, and tombstone markers."""
    _need_jax()
    rng = random.Random(seed)
    streams = []
    for s in range(rng.randrange(2, 6)):
        keys = sorted({f"k{rng.randrange(40):03d}{rng.choice('ab')}".encode()
                       for _ in range(rng.randrange(0, 30))})
        streams.append([(k, s * 10 + rng.randrange(10),
                         None if rng.random() < 0.2 else rng.randbytes(3)) for k in keys])
    assert P.merge_row_streams(streams, "cpu") == JP.merge_row_streams(streams)


@pytest.mark.parametrize("seed", range(2))
def test_merge_row_streams_orders_distinct_prefixes(seed):
    """Keys whose 4-byte prefixes all differ, so that the prefix merge
    alone orders the rows: equal to a plain sort by (key, rank) that keeps
    the newest row of each key, and to the JAX package's merge."""
    _need_jax()
    rng = random.Random(seed)
    pool = rng.sample(range(0xFFFFFFFE), 300)
    streams = [[(i.to_bytes(4, "big") + b"#", s, rng.randbytes(2))
                for i in sorted(rng.sample(pool, rng.randrange(1, 120)))]
               for s in range(rng.randrange(2, 6))]
    want = []
    for r in sorted((r for s in streams for r in s), key=lambda r: (r[0], r[1])):
        if not want or want[-1][0] != r[0]:
            want.append(r)
    got = P.merge_row_streams(streams, "cpu")
    assert got == want
    assert got == JP.merge_row_streams(streams)
