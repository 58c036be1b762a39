"""Port parity for ``gluon.data``, the vision datasets and transforms and
``rnn.BucketSentenceIter``, on the CPU.

- Dataset views (``filter``, ``take``, ``shard``, ``sample``,
  ``transform``, ``transform_first``), the samplers in unshuffled order
  and ``DataLoader`` batches (serial, threaded, and one process-pool case)
  against the JAX package's, exactly; ``RandomSampler`` draws from the
  generator it is given (its draws are not compared with the JAX
  package's);
- ``MNIST``, ``CIFAR10`` and ``CIFAR100`` read files the tests write in
  their binary formats, ``RecordFileDataset`` a RecordIO file, as the JAX
  package's do;
- every transform against the JAX package's on seeded images.  Those that
  draw from numpy's global generator (crops, flips, ``RandomApply``) are
  compared under the same numpy seed; the colour jitters and the lighting
  noise are compared at a jitter of 0 (a fixed factor of 1), where the
  draw does not matter.  Exact for uint8 crops and flips, 1e-6 of the
  largest |value| for float arithmetic, and one level in 255 for the
  bilinear resizes, which round to uint8 after summing in other orders;
- ``encode_sentences`` and ``BucketSentenceIter`` (same seed) exactly.

Every thread or process a test starts ends under a bound: the loaders'
workers are joined by the loader (``timeout``) and the tests check that
no thread and no pool process outlives its loader for longer than JOIN_S
seconds.
"""
import struct
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrio
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jT

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as tT

JOIN_S = 10.0
F_REL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = mx.set_default_context(mx.cpu())
    yield
    mx.set_default_context(prev)


def _a(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_a(e) for e in x)
    if hasattr(x, "asnumpy"):
        return np.asarray(x.asnumpy())
    return x


def _eq(got, ref):
    got, ref = _a(got), _a(ref)
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _eq(g, r)
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _threads_settle(before):
    deadline = time.time() + JOIN_S
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


# ---------------------------------------------------------------------------
# datasets and samplers
# ---------------------------------------------------------------------------
def _arrays(n=10):
    x = np.arange(3 * n, dtype=np.float32).reshape(n, 3)
    y = np.arange(n, dtype=np.float32) * 10
    return x, y


def test_dataset_views_match_jax():
    x, y = _arrays()
    ds = {"jax": jdata.ArrayDataset(x, y), "port": tdata.ArrayDataset(x, y)}
    views = {
        "filter": lambda d: d.filter(lambda s: s[1] % 20 == 0),
        "take": lambda d: d.take(4),
        "shard": lambda d: d.shard(3, 1),
        "shard_last": lambda d: d.shard(3, 2),
        "sample": lambda d: d.sample([7, 1, 3]),
        "transform": lambda d: d.transform(lambda a, b: (a * 2, b + 1)),
        "transform_first": lambda d: d.transform_first(lambda a: a[::-1]),
    }
    for name, view in views.items():
        got, ref = view(ds["port"]), view(ds["jax"])
        assert len(got) == len(ref), name
        for i in range(len(ref)):
            _eq(got[i], ref[i])
    simple = tdata.SimpleDataset(list("abcde"))
    assert simple.take(2)[1] == "b" and len(simple.shard(2, 0)) == 3


def test_samplers_unshuffled_match_jax():
    for last in ("keep", "discard", "rollover"):
        got = tdata.BatchSampler(tdata.SequentialSampler(10, start=2), 4,
                                 last)
        ref = jdata.BatchSampler(jdata.SequentialSampler(10, start=2), 4,
                                 last)
        for _ in range(2):                    # rollover carries over
            assert list(got) == list(ref) and len(got) == len(ref)
    ds = tdata.SimpleDataset(list(range(12)))
    jds = jdata.SimpleDataset(list(range(12)))
    assert list(tdata.FilterSampler(lambda v: v % 3 == 0, ds)) == list(
        jdata.FilterSampler(lambda v: v % 3 == 0, jds))


@pytest.mark.parametrize("make", [lambda: np.random.RandomState(4),
                                  lambda: torch.Generator().manual_seed(4)])
def test_random_sampler_draws_from_its_generator(make):
    a = list(tdata.RandomSampler(20, generator=make()))
    b = list(tdata.RandomSampler(20, generator=make()))
    assert a == b and sorted(a) == list(range(20)) and a != list(range(20))


def _loader_batches(pkg, **kw):
    x, y = _arrays(22)
    return [_a(b) for b in pkg.DataLoader(pkg.ArrayDataset(x, y), **kw)]


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=4, last_batch="discard"),
    dict(batch_size=5, num_workers=3),
    dict(batch_size=4, num_workers=2, prefetch=1, last_batch="rollover"),
])
def test_dataloader_matches_jax(kw):
    before = threading.active_count()
    got = _loader_batches(tdata, **kw)
    ref = _loader_batches(jdata, **kw)
    _eq(got, ref)
    _threads_settle(before)


def test_dataloader_process_pool_matches_jax():
    """One small spawned pool: its workers import torch and the port; the
    loader joins them when its loop ends."""
    import multiprocessing
    kw = dict(batch_size=8, num_workers=2, thread_pool=False, timeout=120)
    got = _loader_batches(tdata, **kw)
    deadline = time.time() + JOIN_S
    while multiprocessing.active_children() and time.time() < deadline:
        time.sleep(0.05)
    assert not multiprocessing.active_children()
    _eq(got, _loader_batches(jdata, batch_size=8))
    assert all(d.context == mx.cpu() for d, _ in
               tdata.DataLoader(tdata.ArrayDataset(*_arrays(8)),
                                batch_size=8))


def test_dataloader_early_exit_joins_workers():
    before = threading.active_count()
    loader = tdata.DataLoader(tdata.ArrayDataset(*_arrays(40)), batch_size=2,
                              num_workers=3, prefetch=1)
    it = iter(loader)
    next(it)
    it.close()                                # leaves the loop early
    _threads_settle(before)


def test_dataloader_pin_memory_without_a_card():
    """pin_memory=True pins only when a card exists: on a CPU-only torch it
    hands out the batches unpinned."""
    loader = tdata.DataLoader(tdata.ArrayDataset(*_arrays(8)), batch_size=4,
                              pin_memory=True)
    got = list(loader)
    assert len(got) == 2
    if not torch.cuda.is_available():
        assert not got[0][0]._data.is_pinned()


def test_dataloader_worker_error_reraises():
    class Bad(tdata.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise ValueError("bad sample")
            return np.float32(i)

    before = threading.active_count()
    with pytest.raises(ValueError, match="bad sample"):
        list(tdata.DataLoader(Bad(), batch_size=2, num_workers=2))
    _threads_settle(before)


# ---------------------------------------------------------------------------
# vision datasets
# ---------------------------------------------------------------------------
def _mnist_dir(tmp_path, n=6):
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    for prefix in ("train", "t10k"):
        (tmp_path / f"{prefix}-images-idx3-ubyte").write_bytes(
            struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
        (tmp_path / f"{prefix}-labels-idx1-ubyte").write_bytes(
            struct.pack(">II", 2049, n) + labels.tobytes())
    return str(tmp_path)


def _cifar_dir(tmp_path, label_bytes, files, n=5):
    rng = np.random.RandomState(label_bytes)
    for name in files:
        rec = rng.randint(0, 256, (n, label_bytes + 3072)).astype(np.uint8)
        rec[:, :label_bytes] %= 10
        (tmp_path / name).write_bytes(rec.tobytes())
    return str(tmp_path)


def _same_dataset(got, ref):
    assert len(got) == len(ref)
    for i in range(len(ref)):
        (g, gl), (r, rl) = got[i], ref[i]
        assert g.dtype == np.uint8 or str(g.dtype) == "uint8"
        _eq(g, r)
        assert int(gl) == int(rl)


def test_mnist_and_cifar_read_their_binary_formats(tmp_path):
    root = _mnist_dir(tmp_path)
    for train in (True, False):
        _same_dataset(tdata.vision.MNIST(root, train=train),
                      jdata.vision.MNIST(root, train=train))
    c10 = tmp_path / "c10"
    c10.mkdir()
    _cifar_dir(c10, 1, [f"data_batch_{i}.bin" for i in range(1, 6)]
               + ["test_batch.bin"])
    for train in (True, False):
        got = tdata.vision.CIFAR10(str(c10), train=train)
        assert got[0][0].shape == (32, 32, 3)
        _same_dataset(got, jdata.vision.CIFAR10(str(c10), train=train))
    c100 = tmp_path / "c100"
    c100.mkdir()
    _cifar_dir(c100, 2, ["train.bin", "test.bin"])
    _same_dataset(tdata.vision.CIFAR100(str(c100)),
                  jdata.vision.CIFAR100(str(c100)))
    tf = tdata.vision.MNIST(root, transform=lambda d, l: (d.shape, l + 1))
    assert tf[0][0] == (28, 28, 1)


def test_record_file_datasets_match_jax(tmp_path):
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    w = jrio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(0)
    for i in range(6):
        img = (rng.rand(8, 10, 3) * 255).astype(np.uint8)
        w.write_idx(i, jrio.pack_img(jrio.IRHeader(0, float(i), i, 0), img,
                                     img_fmt=".png"))
    w.close()
    raw, jraw = tdata.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(raw) == 6 and all(raw[i] == jraw[i] for i in range(6))
    _same_dataset(tdata.vision.ImageRecordDataset(rec),
                  jdata.vision.ImageRecordDataset(rec))


def test_image_folder_and_synthetic_datasets(tmp_path):
    for cls in ("b_cat", "a_dog"):
        (tmp_path / cls).mkdir()
        for i in range(2):
            np.save(tmp_path / cls / f"{i}.npy",
                    np.full((4, 4, 3), i, np.uint8))
    got = tdata.vision.ImageFolderDataset(str(tmp_path))
    ref = jdata.vision.ImageFolderDataset(str(tmp_path))
    assert got.synsets == ref.synsets == ["a_dog", "b_cat"]
    _same_dataset(got, ref)
    _same_dataset(tdata.vision.SyntheticImageDataset(4, (8, 8, 3), seed=2),
                  jdata.vision.SyntheticImageDataset(4, (8, 8, 3), seed=2))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------
def _image(h=20, w=26, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _apply(t_make, j_make, img, seed=11, nd_dtype="uint8"):
    np.random.seed(seed)
    got = t_make()(mx.nd.array(img, dtype=nd_dtype))
    np.random.seed(seed)
    ref = j_make()(jmx.nd.array(img, dtype=nd_dtype))
    return _a(got), np.asarray(_a(ref))


_EXACT = {
    "center_crop": lambda T: T.CenterCrop(12),
    "center_crop_wh": lambda T: T.CenterCrop((10, 14)),
    "random_crop": lambda T: T.RandomCrop(9),
    "random_crop_pad": lambda T: T.RandomCrop((8, 6), pad=2),
    "flip_lr": lambda T: T.RandomFlipLeftRight(),
    "flip_tb": lambda T: T.RandomFlipTopBottom(),
    "cast": lambda T: T.Cast("float32"),
    "apply_p1": lambda T: T.RandomApply(T.RandomFlipLeftRight(), p=1.0),
    "apply_p0": lambda T: T.RandomApply(T.CenterCrop(4), p=0.0),
    "jitter_none": lambda T: T.RandomColorJitter(),
}


@pytest.mark.parametrize("name", sorted(_EXACT))
@pytest.mark.parametrize("seed", [1, 2])
def test_exact_transforms_match_jax(name, seed):
    make = _EXACT[name]
    got, ref = _apply(lambda: make(tT), lambda: make(jT), _image(seed=seed),
                      seed=seed)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


_FLOAT = {
    "to_tensor": lambda T: T.ToTensor(),
    "normalize": lambda T: T.Compose([T.ToTensor(), T.Normalize(
        (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))]),
    "brightness0": lambda T: T.Compose([T.Cast(), T.RandomBrightness(0)]),
    "contrast0": lambda T: T.Compose([T.Cast(), T.RandomContrast(0)]),
    "saturation0": lambda T: T.Compose([T.Cast(), T.RandomSaturation(0)]),
    "hue0": lambda T: T.Compose([T.Cast(), T.RandomHue(0)]),
    "lighting0": lambda T: T.Compose([T.Cast(), T.RandomLighting(0.0)]),
}


@pytest.mark.parametrize("name", sorted(_FLOAT))
def test_float_transforms_match_jax(name):
    make = _FLOAT[name]
    got, ref = _apply(lambda: make(tT), lambda: make(jT), _image())
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got - ref).max() <= F_REL * np.abs(ref).max() + 1e-6


_RESIZE = {
    "resize_up": lambda T: T.Resize((40, 30)),
    "resize_down": lambda T: T.Resize(10),
    "resize_keep": lambda T: T.Resize(16, keep_ratio=True),
    "crop_resize": lambda T: T.CropResize(2, 3, 12, 10, size=(8, 6)),
    "resized_crop": lambda T: T.RandomResizedCrop(12),
}


@pytest.mark.parametrize("name", sorted(_RESIZE))
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_resize_transforms_match_jax(name, dtype):
    make = _RESIZE[name]
    got, ref = _apply(lambda: make(tT), lambda: make(jT), _image(),
                      nd_dtype=dtype)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = np.abs(got.astype(np.float32) - ref.astype(np.float32)).max()
    assert err <= (1.0 if dtype == "uint8" else 1e-3), err


def test_random_transforms_draw_within_their_ranges():
    img = mx.nd.array(_image(), dtype="float32")
    mx.random.seed(3)
    out = tT.RandomBrightness(0.5)(img).asnumpy()
    ratio = out[img.asnumpy() > 0] / img.asnumpy()[img.asnumpy() > 0]
    assert 0.5 <= ratio.min() and ratio.max() <= 1.5
    assert np.allclose(ratio, ratio[0], rtol=1e-5)
    lit = tT.RandomLighting(0.1)(img).asnumpy() - img.asnumpy()
    assert np.allclose(lit, lit[:1, :1], atol=1e-4)
    jit = tT.RandomColorJitter(0.2, 0.2, 0.2, 0.05)(img)
    assert jit.shape == img.shape and np.isfinite(jit.asnumpy()).all()


def test_transforms_feed_a_loader():
    """transform_first(Compose) over a dataset of uint8 images, batched by
    the threaded DataLoader: CHW float32 batches."""
    imgs = np.stack([_image(seed=i) for i in range(6)])
    ds = tdata.ArrayDataset(mx.nd.array(imgs, dtype="uint8"),
                            np.arange(6, dtype=np.float32))
    tf = tT.Compose([tT.CenterCrop(16), tT.ToTensor(),
                     tT.Normalize(0.5, 0.25)])
    batches = list(tdata.DataLoader(ds.transform_first(tf), batch_size=3,
                                    num_workers=2))
    assert batches[0][0].shape == (3, 3, 16, 16)
    assert batches[0][0].dtype == np.float32
    _eq(batches[1][1], np.arange(3, 6, dtype=np.float32))


# ---------------------------------------------------------------------------
# rnn.BucketSentenceIter
# ---------------------------------------------------------------------------
def _sentences():
    rng = np.random.RandomState(8)
    words = [f"w{i}" for i in range(30)]
    return [[words[j] for j in rng.randint(0, 30, rng.randint(3, 12))]
            for _ in range(60)]


def test_encode_sentences_matches_jax():
    got, vocab = mx.rnn.encode_sentences(_sentences(), start_label=1)
    ref, jvocab = jmx.rnn.encode_sentences(_sentences(), start_label=1)
    assert got == ref and vocab == jvocab
    more = [["w1", "zz"]]
    assert mx.rnn.encode_sentences(more, dict(vocab), unknown_token="<unk>") \
        == jmx.rnn.encode_sentences(more, dict(jvocab),
                                    unknown_token="<unk>")


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_jax(layout):
    coded, _ = mx.rnn.encode_sentences(_sentences(), start_label=1)
    kw = dict(batch_size=4, buckets=[5, 8, 12], invalid_label=0,
              layout=layout, seed=5)
    got_it = mx.rnn.BucketSentenceIter(coded, **kw)
    ref_it = jmx.rnn.BucketSentenceIter(coded, **kw)
    assert got_it.default_bucket_key == ref_it.default_bucket_key
    for _ in range(2):
        got, ref = list(got_it), list(ref_it)
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert g.bucket_key == r.bucket_key
            assert g.provide_data[0].shape == r.provide_data[0].shape
            _eq(g.data, r.data)
            _eq(g.label, r.label)
        got_it.reset()
        ref_it.reset()
