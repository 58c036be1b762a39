"""Port parity for ``recordio``, the native reader and the file iterators,
on the CPU.

- RecordIO files (plain, indexed, image records with scalar and vector
  labels) written by either package are byte for byte the other's, and
  each package reads the other's;
- the port's native reader (``csrc/recordio_core.cc``, built with ``g++``
  at first use) and its Python reader give the same bytes, and its native
  writer writes the Python writer's file;
- ``ImageRecordIter`` (float32 with mean/std, uint8, int8, the detection
  variant) gives the JAX package's batches from one file, ``rand_crop``
  and ``rand_mirror`` off: exact for uint8 and int8, float32 within 1e-6
  of the largest |value| (numpy computes ``(x - mean) / std`` on both
  sides; the slack covers nothing but the arrays' round trip);
- ``CSVIter``, ``MNISTIter`` and ``LibSVMIter`` give the JAX package's
  batches, exactly, from files the tests write.
"""
import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrio

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio as trio
from mxnet_tpu_torch.io import native

F32_REL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = mx.set_default_context(mx.cpu())
    yield
    mx.set_default_context(prev)


def _payloads():
    return [bytes([i % 251]) * (i * 7 + 1) for i in range(32)]


@pytest.mark.parametrize("writer,reader", [(jrio, trio), (trio, jrio)])
def test_plain_records_cross_byte_for_byte(tmp_path, writer, reader):
    paths = {}
    for name, rio in (("w", writer), ("other", reader)):
        paths[name] = str(tmp_path / f"{name}.rec")
        w = rio.MXRecordIO(paths[name], "w")
        for p in _payloads():
            w.write(p)
        w.close()
    with open(paths["w"], "rb") as a, open(paths["other"], "rb") as b:
        assert a.read() == b.read()
    r = reader.MXRecordIO(paths["w"], "r")
    assert [r.read() for _ in range(32)] == _payloads()
    assert r.read() is None
    r.close()


def _image_records(rio, rec, idx):
    """Indexed image records: PNG images, scalar and vector labels."""
    rng = np.random.RandomState(1)
    w = rio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(12):
        img = (rng.rand(20, 28, 3) * 255).astype(np.uint8)
        label = (float(i % 10) if i % 3 else
                 np.array([i, 2.5, -1.0], np.float32))
        w.write_idx(i, rio.pack_img(rio.IRHeader(0, label, i, 0), img,
                                    img_fmt=".png"))
        w.write_idx(100 + i, rio.pack(rio.IRHeader(0, float(i), i, 7),
                                      b"raw%d" % i))
    w.close()


@pytest.mark.parametrize("writer,reader", [(jrio, trio), (trio, jrio)])
def test_indexed_image_records_cross(tmp_path, writer, reader):
    files = {}
    for name, rio in (("w", writer), ("other", reader)):
        rec, idx = str(tmp_path / f"{name}.rec"), str(tmp_path / f"{name}.idx")
        _image_records(rio, rec, idx)
        files[name] = (rec, idx)
    for a, b in zip(files["w"], files["other"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    rec, idx = files["w"]
    r = reader.MXIndexedRecordIO(idx, rec, "r")
    ref = writer.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == ref.keys
    for k in r.keys:
        s = r.read_idx(k)
        assert s == ref.read_idx(k)
        if k < 100:
            (h, img), (rh, rimg) = reader.unpack_img(s), writer.unpack_img(s)
            np.testing.assert_array_equal(img, rimg)
            np.testing.assert_array_equal(np.asarray(h.label),
                                          np.asarray(rh.label))
            assert (h.flag, h.id, h.id2) == (rh.flag, rh.id, rh.id2)
        else:
            h, body = reader.unpack(s)
            assert body == b"raw%d" % (k - 100) and h.id2 == 7
    r.close()
    ref.close()


def test_native_reader_and_writer_agree_with_python(tmp_path):
    assert native.available()
    assert native.library_path().parent.name == "torch_kernels"
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    _image_records(trio, rec, idx)
    r = trio.MXIndexedRecordIO(idx, rec, "r")
    keys = list(reversed(r.keys))
    assert r.read_batch(keys) == [r.read_idx(k) for k in keys]
    offsets, sizes = native.index_file(rec)
    assert len(offsets) == len(r.keys)
    assert native.payload_size(rec, r.idx[r.keys[3]]) == len(
        r.read_idx(r.keys[3]))
    r.close()
    nat = str(tmp_path / "n.rec")
    offs = native.write_batch(nat, _payloads())
    py = str(tmp_path / "p.rec")
    w = trio.MXRecordIO(py, "w")
    pos = []
    for p in _payloads():
        pos.append(w.tell())
        w.write(p)
    w.close()
    with open(nat, "rb") as a, open(py, "rb") as b:
        assert a.read() == b.read()
    assert list(offs) == pos


def _pair(tmp_path, n=20, hw=(30, 34)):
    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = jrio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(4)
    for i in range(n):
        img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        w.write_idx(i, jrio.pack_img(jrio.IRHeader(0, float(i % 7), i, 0),
                                     img, img_fmt=".png"))
    w.close()
    return rec, idx


def _batches(it):
    out = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]
    it.close()
    return out


@pytest.mark.parametrize("dtype", ["float32", "uint8", "int8"])
def test_image_record_iter_matches_jax(tmp_path, dtype):
    rec, idx = _pair(tmp_path)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 24, 28),
              batch_size=8, round_batch=False, preprocess_threads=2,
              dtype=dtype)
    if dtype == "float32":
        kw.update(mean_r=123.7, mean_g=116.3, mean_b=103.5, std_r=58.4,
                  std_g=57.1, std_b=57.4)
    got = _batches(mx.io.ImageRecordIter(**kw))
    ref = _batches(jmx.io.ImageRecordIter(**kw))
    assert len(got) == len(ref) == 3
    for (g, gl, gp), (r, rl, rp) in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape == (8, 3, 24, 28)
        if dtype == "float32":
            assert np.abs(g - r).max() <= F32_REL * np.abs(r).max()
        else:
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(gl, rl)
        assert gp == rp


def test_image_record_iter_shapes_shuffle_and_shards(tmp_path):
    rec, idx = _pair(tmp_path, n=24)
    it = mx.io.ImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                               data_shape=(3, 28, 28), batch_size=8,
                               shuffle=True, rand_crop=True, rand_mirror=True,
                               seed=3)
    labels = []
    for batch in it:
        assert batch.data[0].shape == (8, 3, 28, 28)
        assert batch.data[0].context == mx.cpu()
        labels += batch.label[0].asnumpy().tolist()
    assert sorted(labels) == sorted(float(i % 7) for i in range(24))
    it.close()
    shards = []
    for part in range(2):
        it = mx.io.ImageRecordIter(path_imgrec=rec, path_imgidx=idx,
                                   data_shape=(3, 30, 34), batch_size=4,
                                   part_index=part, num_parts=2)
        shards += [lab for b in it for lab in b.label[0].asnumpy().tolist()]
        it.close()
    assert sorted(shards) == sorted(float(i % 7) for i in range(24))


def test_image_det_record_iter_matches_jax(tmp_path):
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = jrio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(2)
    for i in range(8):
        objs = rng.rand(1 + i % 3, 5).astype(np.float32)
        label = np.concatenate([[2.0, 5.0], objs.ravel()]).astype(np.float32)
        img = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
        w.write_idx(i, jrio.pack_img(jrio.IRHeader(0, label, i, 0), img,
                                     img_fmt=".png"))
    w.close()
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 16, 16),
              batch_size=4, label_pad_width=4)
    got = _batches(mx.io.ImageDetRecordIter(**kw))
    ref = _batches(jmx.io.ImageDetRecordIter(**kw))
    for (g, gl, _), (r, rl, _) in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(gl, rl)


def _same_batches(got_it, ref_it, epochs=2):
    for _ in range(epochs):
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
               for b in got_it]
        ref = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
               for b in ref_it]
        assert len(got) == len(ref) > 0
        for (g, gl, gp), (r, rl, rp) in zip(got, ref):
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(gl, rl)
            assert gp == rp
        got_it.reset()
        ref_it.reset()


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_jax(tmp_path, round_batch):
    rng = np.random.RandomState(0)
    data = rng.randn(10, 6).astype(np.float32)
    label = rng.randint(0, 3, (10, 1)).astype(np.float32)
    dpath, lpath = tmp_path / "d.csv", tmp_path / "l.csv"
    np.savetxt(dpath, data, delimiter=",")
    np.savetxt(lpath, label, delimiter=",")
    kw = dict(data_csv=str(dpath), data_shape=(2, 3), label_csv=str(lpath),
              batch_size=4, round_batch=round_batch)
    it = mx.io.CSVIter(**kw)
    assert it.provide_data[0].shape == (4, 2, 3)
    _same_batches(it, jmx.io.CSVIter(**kw))


def _mnist_files(tmp_path, n=30, gz=False):
    rng = np.random.RandomState(9)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    op = gzip.open if gz else open
    ext = ".gz" if gz else ""
    ip, lp = str(tmp_path / f"img{ext}"), str(tmp_path / f"lbl{ext}")
    with op(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with op(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return ip, lp


@pytest.mark.parametrize("flat,gz", [(False, False), (True, True)])
def test_mnist_iter_matches_jax(tmp_path, flat, gz):
    ip, lp = _mnist_files(tmp_path, gz=gz)
    kw = dict(image=ip, label=lp, batch_size=8, flat=flat)
    _same_batches(mx.io.MNISTIter(**kw), jmx.io.MNISTIter(**kw))
    sharded = mx.io.MNISTIter(part_index=1, num_parts=2, **kw)
    assert len(list(sharded)) == 15 // 8


def test_libsvm_iter_matches_jax(tmp_path):
    p = tmp_path / "d.libsvm"
    p.write_text("1 0:1.5 3:2.0\n0 1:1.0\n1 2:0.5 3:1.0\n0 0:2.0\n"
                 "1 1:3.0 2:4.0\n")
    lp = tmp_path / "l.libsvm"
    lp.write_text("0:1 1:2\n0:3 1:4\n0:5 1:6\n0:7 1:8\n0:9 1:10\n")
    for kw in (dict(batch_size=2),
               dict(batch_size=2, round_batch=False),
               dict(batch_size=2, label_libsvm=str(lp), label_shape=(2,))):
        it = mx.io.LibSVMIter(data_libsvm=str(p), data_shape=(4,), **kw)
        ref = jmx.io.LibSVMIter(data_libsvm=str(p), data_shape=(4,), **kw)
        got = [(b.data[0].tostype("default").asnumpy(),
                b.label[0].asnumpy(), b.pad) for b in it]
        want = [(b.data[0].tostype("default").asnumpy(),
                 np.asarray(b.label[0].asnumpy()), b.pad) for b in ref]
        assert len(got) == len(want)
        for (g, gl, gp), (r, rl, rp) in zip(got, want):
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(gl, rl)
            assert gp == rp
        assert it.provide_label[0].shape == ref.provide_label[0].shape
