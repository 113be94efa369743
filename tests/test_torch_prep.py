"""The port's OffloadPrep path (``repro_torch.data``) and its preprocess
kernel (``repro_torch.kernels``) against the JAX package.

On the CPU the kernel wrapper takes its plain version, which must give the
storage node's numpy bytes exactly: the prep pipeline promises batches that
do not depend on where a share ran, so the port's batches are held to the
JAX package's with ``np.array_equal``. Against the Pallas kernel (two f32
matmuls, interpret mode) the tolerance is ``tests/test_kernels.py``'s,
1e-4. The CUDA kernel is held bit for bit against the plain version by the
``gpu``-marked tests at the end (and by ``chip_smoke.py``), which skip
without a card. Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import AcceptAll, BlockDevice, OffloadEngine, OffloadFS, RpcFabric
from repro_torch.core.admission import RejectAll
from repro_torch.core.lsm import DBConfig, OffloadDB
from repro_torch.core.lsm import compaction as C
from repro_torch.core.offloader import TaskOffloader, serve_engine
from repro_torch.data import ingest, offload_prep
from repro_torch.data.ingest import PrepPipeline, tokens_from_batch
from repro_torch.data.offload_prep import OffloadPrep
from repro_torch.data.preprocess import encode_image, synthetic_image
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import preprocess as kpp

try:  # the JAX reference; the machine with the card has no jax
    import jax.numpy as jnp

    import repro.core as jcore
    from repro.core.engine import OffloadEngine as JEngine
    from repro.core.offloader import TaskOffloader as JOffloader
    from repro.core.offloader import serve_engine as jserve_engine
    from repro.data import ingest as jingest
    from repro.data import offload_prep as joffload_prep
    from repro.data.preprocess import _MEAN, _STD, bilinear_resize
    from repro.data.preprocess import preprocess_image as jpreprocess_image
    from repro.kernels import ops as jops
except ImportError:
    jnp = None


def _need_jax():
    if jnp is None:
        pytest.skip("needs jax for the JAX reference")


def _bits_equal(got: torch.Tensor, want: np.ndarray) -> bool:
    g = got.detach().cpu().numpy()
    return g.shape == want.shape and g.dtype == want.dtype and np.array_equal(
        g.view(np.int64), want.view(np.int64))


# ------------------------------------------------------------ the kernel
@pytest.mark.parametrize("H,W,out,flip", [
    (96, 80, 64, False), (128, 128, 96, True), (61, 77, 32, True),
])
def test_preprocess_matches_pallas(H, W, out, flip):
    _need_jax()
    rng = np.random.RandomState(0)
    img = (rng.rand(3, H, W) * 255).astype(np.float32)
    want = np.asarray(jops.preprocess_image(jnp.asarray(img), out_size=out, flip=flip))
    got = ops.preprocess_image(torch.from_numpy(img), out_size=out, flip=flip)
    assert got.dtype == torch.float64 and got.shape == (3, out, out)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def _numpy_prep(crop_hwc: np.ndarray, out: int, flip: bool) -> np.ndarray:
    """The storage node's arithmetic (``repro.data.preprocess``)."""
    if flip:
        crop_hwc = crop_hwc[:, ::-1]
    return (bilinear_resize(crop_hwc, out, out) - _MEAN) / _STD


@pytest.mark.parametrize("h,w,out", [
    (1, 1, 224), (1, 6, 16), (5, 2, 7), (38, 41, 224), (61, 77, 224),
    (300, 417, 224), (224, 224, 224), (512, 509, 16),
])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_plain_version_bit_equal_to_numpy(h, w, out, dtype):
    """Crops from 1 pixel through upscales to downscales, both flips, u8
    and f32, each an HWC crop of a larger image seen as CHW (strided)."""
    _need_jax()
    rng = np.random.RandomState(h * 1000 + w)
    big = rng.randint(0, 256, (h + 3, w + 5, 3))
    big = big.astype(np.uint8) if dtype == np.uint8 else (big + rng.rand(*big.shape)).astype(
        np.float32)
    crop = big[2:2 + h, 1:1 + w]
    for flip in (False, True):
        got = ops.preprocess_image(torch.from_numpy(big)[2:2 + h, 1:1 + w].permute(2, 0, 1),
                                   out_size=out, flip=flip)
        assert _bits_equal(got.permute(1, 2, 0), _numpy_prep(crop, out, flip))


def test_preprocess_writes_into_a_batch_slot():
    rng = np.random.RandomState(5)
    crop = torch.from_numpy(rng.randint(0, 256, (40, 30, 3)).astype(np.uint8))
    batch = torch.zeros((3, 16, 16, 3), dtype=torch.float64)
    ret = ops.preprocess_image(crop.permute(2, 0, 1), out_size=16, flip=True,
                               out=batch[1].permute(2, 0, 1))
    assert ret.data_ptr() == batch[1].data_ptr()
    want = ref.preprocess_image_ref(crop.permute(2, 0, 1), out_size=16, flip=True)
    assert torch.equal(batch[1], want.permute(1, 2, 0))
    assert not batch[0].any() and not batch[2].any()


def test_normalisation_constants_match_numpy():
    _need_jax()
    assert np.array_equal(ref.PREP_MEAN.numpy(), _MEAN)
    assert np.array_equal(ref.PREP_STD.numpy(), _STD)


@pytest.mark.parametrize("bad", [
    lambda: ops.preprocess_image(torch.zeros(3, 8, 8, dtype=torch.float64)),  # dtype
    lambda: ops.preprocess_image(torch.zeros(3, 8, 8, dtype=torch.int16)),  # dtype
    lambda: ops.preprocess_image(torch.zeros(8, 8, dtype=torch.uint8)),  # rank
    lambda: ops.preprocess_image(torch.zeros(5, 8, 8, dtype=torch.uint8)),  # channels
    lambda: ops.preprocess_image(torch.zeros(3, 0, 8, dtype=torch.uint8)),  # empty
    lambda: ops.preprocess_image(torch.zeros(3, 8, 8, dtype=torch.uint8), out_size=0),
    lambda: ops.preprocess_image(torch.zeros(3, 8, 8, dtype=torch.uint8), mean=[1.0, 2.0]),
    lambda: ops.preprocess_image(torch.zeros(3, 8, 8, dtype=torch.uint8), out_size=4,
                                 out=torch.empty(3, 4, 4, dtype=torch.float32)),
    lambda: ops.preprocess_image(torch.zeros(3, 8, 8, dtype=torch.uint8), out_size=4,
                                 out=torch.empty(3, 5, 4, dtype=torch.float64)),
    lambda: ops.preprocess_image(torch.zeros(3, 8, 8, dtype=torch.uint8, device="meta")),
])
def test_preprocess_wrapper_refuses(bad):
    with pytest.raises(ValueError):
        bad()


# ------------------------------------------------------ the batch kernel
def _encoded(n, seed, max_side):
    """n encoded images of the synthetic corpus (sides up to ``max_side``)
    and a 1 x 1 image, whose only crop is its pixel."""
    imgs = [synthetic_image(seed * 1000 + i, min_side=1, max_side=max_side) for i in range(n)]
    imgs.append(np.random.RandomState(seed).randint(0, 256, (1, 1, 3)).astype(np.uint8))
    return [encode_image(im) for im in imgs]


@pytest.mark.parametrize("out,max_side", [(16, 40), (224, 96)])
def test_preprocess_batch_bit_equal_to_numpy(out, max_side):
    """OffloadPrep's packing, table and one ``preprocess_batch`` over a
    share written into scattered slots: each image has the bytes of the
    storage node's numpy ``preprocess_image``, and the other slots are
    untouched."""
    _need_jax()
    bufs = _encoded(9, out, max_side)
    slots = np.random.RandomState(out).permutation(len(bufs) + 3)[:len(bufs)]
    batch = torch.zeros((len(bufs) + 3, out, out, 3), dtype=torch.float64)
    prep = OffloadPrep(None, None, out_size=out, device="cpu")
    prep._preprocess_into([(b, 77 + i, int(s)) for i, (b, s) in enumerate(zip(bufs, slots))],
                          batch)
    for i, (b, s) in enumerate(zip(bufs, slots)):
        assert _bits_equal(batch[s], jpreprocess_image(b, 77 + i, out))
    rest = sorted(set(range(len(batch))) - set(slots.tolist()))
    assert len(rest) == 3 and not batch[rest].any()


def test_pack_crops_layout():
    rng = np.random.RandomState(2)
    big = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    crops = [big[3:9, 4:14], big[:1, :1], big[5:20, 0:30]]
    packed, desc = kpp.pack_crops(crops, [True, False, True], [2, 0, 5], "cpu")
    assert packed.dtype == torch.uint8 and packed.device.type == "cpu"
    assert np.array_equal(packed.numpy(), np.concatenate([c.reshape(-1) for c in crops]))
    assert desc.dtype == torch.int64 and desc.tolist() == [
        [0, 6, 10, 3, 1, 2], [180, 1, 1, 3, 0, 0], [183, 15, 30, 3, 1, 5]]
    empty, none = kpp.pack_crops([], [], [], "cpu")
    assert empty.numel() == 0 and none.shape == (0, len(kpp.DESC_COLUMNS))


def test_preprocess_batch_equals_preprocess_image():
    """Slot by slot what ``preprocess_image`` gives for the crop seen as CHW,
    with the default and with given normalisation constants."""
    rng = np.random.RandomState(4)
    crops = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in ((7, 9), (30, 2))]
    packed, desc = kpp.pack_crops(crops, [False, True], [1, 0], "cpu")
    for mean, std in ((None, None), ([1.0, 2.0, 3.0], [4.0, 5.0, 6.0])):
        out = torch.zeros((2, 12, 12, 3), dtype=torch.float64)
        assert ops.preprocess_batch(packed, desc, out, mean=mean, std=std) is out
        for crop, flip, slot in zip(crops, (False, True), (1, 0)):
            want = ops.preprocess_image(torch.from_numpy(crop).permute(2, 0, 1), out_size=12,
                                        flip=flip, mean=mean, std=std)
            assert torch.equal(out[slot], want.permute(1, 2, 0))


def _bad_batch(kind):
    crops = [np.zeros((4, 5, 3), np.uint8), np.zeros((2, 2, 3), np.uint8)]
    packed, desc = kpp.pack_crops(crops, [0, 1], [0, 1], "cpu")
    out = torch.empty((2, 8, 8, 3), dtype=torch.float64)
    col = dict(zip(kpp.DESC_COLUMNS, range(len(kpp.DESC_COLUMNS))))
    bad_row = {"offset": 61, "h": 0, "w": 3, "C": 4, "flip": 2, "slot": 2}
    if kind in bad_row:
        desc[1, col[kind]] = bad_row[kind]
    elif kind == "same_slot":
        desc[1, col["slot"]] = 0
    elif kind == "desc_dtype":
        desc = desc.to(torch.int32)
    elif kind == "desc_shape":
        desc = desc[:, :5]
    elif kind == "packed_dtype":
        packed = packed.to(torch.int16)
    elif kind == "out_dtype":
        out = out.to(torch.float32)
    elif kind == "out_strided":
        out = torch.empty((2, 8, 3, 8), dtype=torch.float64).permute(0, 1, 3, 2)
    elif kind == "out_channels":
        out = torch.empty((2, 8, 8, 5), dtype=torch.float64)
    elif kind == "mean":
        return lambda: ops.preprocess_batch(packed, desc, out, mean=[1.0])
    return lambda: ops.preprocess_batch(packed, desc, out)


@pytest.mark.parametrize("kind", ["offset", "h", "w", "C", "flip", "slot", "same_slot",
                                  "desc_dtype", "desc_shape", "packed_dtype", "out_dtype",
                                  "out_strided", "out_channels", "mean"])
def test_preprocess_batch_refuses(kind):
    with pytest.raises(ValueError):
        _bad_batch(kind)()


# ------------------------------------------------------ planes for both
def _port_plane(n_targets, policies=None, *, mount=False, dev=None):
    dev = dev or BlockDevice(num_blocks=1 << 17)
    fs = OffloadFS.mount(dev, node="init0") if mount else OffloadFS(dev, node="init0")
    fabric = RpcFabric()
    engines = []
    for t in range(n_targets):
        eng = OffloadEngine(fs, node=f"storage{t}", cache_blocks=1024)
        eng.register_stub("preprocess", offload_prep.stub_preprocess)
        eng.register_stub("compact", C.stub_compact)
        eng.register_stub("log_recycle", C.stub_log_recycle)
        serve_engine(eng, fabric, policies[t] if policies else AcceptAll())
        engines.append(eng)
    off = TaskOffloader(fs, fabric, node="init0", targets=[e.node for e in engines])
    return dev, fs, fabric, off


def _jax_plane(n_targets, policies=None):
    fs = jcore.OffloadFS(jcore.BlockDevice(num_blocks=1 << 17), node="init0")
    fabric = jcore.RpcFabric()
    engines = []
    for t in range(n_targets):
        eng = JEngine(fs, node=f"storage{t}", cache_blocks=1024)
        eng.register_stub("preprocess", joffload_prep.stub_preprocess)
        jserve_engine(eng, fabric, policies[t] if policies else jcore.AcceptAll())
        engines.append(eng)
    return fs, JOffloader(fs, fabric, node="init0", targets=[e.node for e in engines])


def _preps(n_targets, n_images, *, ratio=0.25, out=16, port_policies=None,
           jax_policies=None):
    """The same corpus on a port plane (``device="cpu"``) and a JAX one."""
    _, fs, _, off = _port_plane(n_targets, port_policies)
    prep = OffloadPrep(fs, off, out_size=out, offload_ratio=ratio, device="cpu")
    jfs, joff = _jax_plane(n_targets, jax_policies)
    jprep = joffload_prep.OffloadPrep(jfs, joff, out_size=out, offload_ratio=ratio)
    paths = prep.materialize_corpus(n_images, max_side=64)
    assert jprep.materialize_corpus(n_images, max_side=64) == paths
    return prep, jprep, paths


# ------------------------------------------------------------ the path
@pytest.mark.parametrize("policies", ["accept", "reject_first"])
def test_minibatch_bit_equal_to_jax(policies):
    """Local, offloaded and pushed-back shares alike: the port's float64
    batch on the device has the JAX package's bytes, and the same stats."""
    _need_jax()
    pp = jp = None
    if policies == "reject_first":
        pp, jp = [RejectAll(), AcceptAll()], [jcore.RejectAll(), jcore.AcceptAll()]
    prep, jprep, paths = _preps(2, 12, port_policies=pp, jax_policies=jp)
    got = prep.preprocess_minibatch(paths, epoch_seed=3)
    want = jprep.preprocess_minibatch(paths, epoch_seed=3)
    assert got.device.type == "cpu" and got.dtype == torch.float64
    assert _bits_equal(got, want)
    assert prep.stats == jprep.stats
    assert prep.stats["local"] == 6


def test_batches_identical_regardless_of_target_count():
    """``tests/test_prep_pipeline.py``'s determinism test on the port, and
    against the JAX package's batches."""
    _need_jax()
    golden = None
    for nt in (1, 3):
        prep, jprep, paths = _preps(nt, 24, ratio=0.2)
        got = [b.clone() for b in PrepPipeline(prep, paths, batch=8, epochs=2, seed=7,
                                               window=2, queue_depth=2)]
        want = list(jingest.PrepPipeline(jprep, paths, batch=8, epochs=2, seed=7,
                                         window=2, queue_depth=2))
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert _bits_equal(a, b)
        if golden is None:
            golden = got
        else:
            for a, b in zip(golden, got):
                assert torch.equal(a.view(torch.int64), b.view(torch.int64))


def test_pipeline_matches_synchronous_minibatch_content():
    _need_jax()
    prep, jprep, paths = _preps(2, 8)
    pipe = PrepPipeline(prep, paths, batch=8, epochs=1, seed=3, shuffle=False)
    got = list(pipe)
    assert len(got) == 1
    sync = OffloadPrep(prep.fs, prep.off, out_size=16, offload_ratio=0.25,
                       device="cpu").preprocess_minibatch(
        paths, epoch_seed=pipe._batch_seed(0, 0))
    assert torch.equal(got[0].view(torch.int64), sync.view(torch.int64))
    want = list(jingest.PrepPipeline(jprep, paths, batch=8, epochs=1, seed=3,
                                     shuffle=False))
    assert _bits_equal(got[0], want[0])
    assert tokens_from_batch(got[0], 997, 15).keys() == {"tokens", "labels"}
    for k, v in tokens_from_batch(got[0], 997, 15).items():
        assert np.array_equal(v, jingest.tokens_from_batch(want[0], 997, 15)[k])


def test_checkpoint_resume_roundtrip_through_offloaddb():
    """Checkpoint into the port's OffloadDB, crash, remount, recover and
    resume: the rest of the run is the uninterrupted run, bit for bit."""
    dev, fs, fabric, off = _port_plane(2)
    make = lambda fs, off: OffloadPrep(fs, off, out_size=16, offload_ratio=0.25,  # noqa: E731
                                       device="cpu")
    paths = make(fs, off).materialize_corpus(40, max_side=64)
    db = OffloadDB(fs, off, DBConfig(memtable_bytes=1 << 16), device="cpu")
    golden = list(PrepPipeline(make(fs, off), paths, batch=8, epochs=2, seed=11))
    pipe = PrepPipeline(make(fs, off), paths, batch=8, epochs=2, seed=11)
    it = iter(pipe)
    got = [next(it) for _ in range(6)]  # past the epoch boundary (5 a epoch)
    pipe.checkpoint(db)
    pipe.close()
    db.flush_all()
    fs.flush_metadata()
    fabric.drain()
    del pipe, db, fs, off, fabric

    _, fs2, _, off2 = _port_plane(2, mount=True, dev=dev)
    db2 = OffloadDB.recover(fs2, off2, device="cpu")
    assert db2.device == "cpu"
    pipe2 = PrepPipeline.resume(make(fs2, off2), paths, db2)
    assert pipe2.state.epoch == 1 and pipe2.state.cursor == 1
    got.extend(pipe2)
    assert len(got) == len(golden) == 10
    for a, b in zip(got, golden):
        assert torch.equal(a.view(torch.int64), b.view(torch.int64))


def test_pipeline_batches_complete_on_delivery(monkeypatch):
    """The producer hands each batch over with its completion event (none
    on the CPU), and the consumer waits on it before delivering."""
    _, fs, _, off = _port_plane(1)
    prep = OffloadPrep(fs, off, out_size=8, offload_ratio=0.5, device="cpu")
    paths = prep.materialize_corpus(8, max_side=64)
    waited = []

    class Done:
        def synchronize(self):
            waited.append(True)

    real = ingest.PrepPipeline._assemble
    monkeypatch.setattr(ingest.PrepPipeline, "_assemble",
                        lambda self, job: (real(self, job)[0], Done()))
    got = list(PrepPipeline(prep, paths, batch=4, epochs=1, seed=1))
    assert len(got) == 2 and len(waited) == 2


# ------------------------------------------------------ on the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,out,flip,dtype", [
    (512, 512, 224, True, torch.uint8), (61, 77, 224, False, torch.uint8),
    (1, 1, 224, True, torch.uint8), (300, 417, 224, True, torch.float32),
    (7, 5, 16, False, torch.float32),
])
def test_preprocess_kernel_bit_equal_on_card(h, w, out, flip, dtype):
    _need_cuda()
    rng = np.random.RandomState(h + w)
    hwc = torch.from_numpy(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).to("cuda", dtype)
    slot = torch.zeros((2, out, out, 3), dtype=torch.float64, device="cuda")
    before = build.LAUNCHES["preprocess_image"]
    got = ops.preprocess_image(hwc.permute(2, 0, 1), out_size=out, flip=flip,
                               out=slot[1].permute(2, 0, 1))
    want = ref.preprocess_image_ref(hwc.permute(2, 0, 1), out_size=out, flip=flip)
    torch.cuda.synchronize()
    assert build.LAUNCHES["preprocess_image"] == before + 1
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert not slot[0].any()


@pytest.mark.gpu
def test_offload_prep_on_card_equals_host_numpy():
    _need_cuda()
    _, fs, _, off = _port_plane(1)
    prep = OffloadPrep(fs, off, out_size=32, offload_ratio=0.25)
    paths = prep.materialize_corpus(8, max_side=96)
    before = build.LAUNCHES["preprocess_batch"]
    got = prep.preprocess_minibatch(paths, epoch_seed=2)
    assert got.is_cuda and got.dtype == torch.float64
    # one launch a share
    assert build.LAUNCHES["preprocess_batch"] - before == 1 and prep.stats["local"] == 6
    want = np.stack([offload_prep.preprocess_image(fs.read(p), prep._image_seed(2, i), 32)
                     for i, p in enumerate(paths)])
    assert _bits_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("out", [224, 16])
def test_preprocess_batch_kernel_bit_equal_on_card(out):
    """One launch over crops of the corpus's sizes (sides 1 to 512), a 1 x 1
    crop and both flips, into scattered slots: bit for bit the plain
    version's and the per-image kernel's, other slots untouched."""
    _need_cuda()
    from repro_torch.data.preprocess import decode_image, random_crop_params

    crops, flips = [], []
    for i, buf in enumerate(_encoded(40, 3, 512)):
        img = decode_image(buf)
        rng = np.random.RandomState(i)
        y, x, ch, cw = random_crop_params(rng, *img.shape[:2])
        crops.append(img[y:y + ch, x:x + cw])
        flips.append(bool(rng.rand() < 0.5))
    flips[-1] = True  # the 1 x 1 crop, flipped
    slots = np.random.RandomState(5).permutation(len(crops) + 4)[:len(crops)].tolist()
    packed, desc = kpp.pack_crops(crops, flips, slots, "cuda")
    got = torch.zeros((len(crops) + 4, out, out, 3), dtype=torch.float64, device="cuda")
    want = torch.zeros_like(got)
    before = build.LAUNCHES["preprocess_batch"]
    ops.preprocess_batch(packed, desc, got)
    assert build.LAUNCHES["preprocess_batch"] == before + 1
    ref.preprocess_batch_ref(packed, desc, want)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    for crop, flip, slot in zip(crops, flips, slots):
        one = ops.preprocess_image(torch.from_numpy(crop).cuda().permute(2, 0, 1),
                                   out_size=out, flip=flip)
        assert torch.equal(got[slot].view(torch.int64), one.permute(1, 2, 0).view(torch.int64))
    rest = sorted(set(range(len(got))) - set(slots))
    assert len(rest) == 4 and not got[rest].any()
