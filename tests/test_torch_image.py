"""Port parity for the image ops (``ops/image.py``), ``mx.nd.image`` and
``mx.image``.

The same seeded images go through both packages.  Exact: crops, flips,
``swap_axis``, ``imdecode`` of a PNG and uint8 casts.  Float arithmetic
(``to_tensor``, ``normalize``, the colour ops): within F_REL of the
largest |value|.  Resizes: within one level in 255 for uint8 (the two
packages sum the taps in other orders and then truncate) and RESIZE_REL
for float.  The random ops draw from Philox here and from threefry in the
JAX package, so no draw is compared: each is held by its fixed-factor
twin (``min_factor == max_factor``, ``alpha_std = 0``, a window as large
as the image) against the JAX op, and its draws by their range.  The
augmenters and ``ImageIter`` draw their crops, flips and orders from
Python's ``random`` and their shuffles from numpy's RandomState, as the
JAX package's do, so under the same seeds they are compared exactly (the
jitter and lighting factors excepted).
"""
import os
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

F_REL = 1e-6
RESIZE_REL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_default():
    prev = tmx.set_default_context(tmx.cpu())
    yield
    tmx.set_default_context(prev)


def _image(h=12, w=16, seed=0, dtype=np.float32, batch=None):
    shape = (h, w, 3) if batch is None else (batch, h, w, 3)
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(dtype)


def _both(fn, img):
    """fn(pkg, NDArray) in the port, then in the JAX package, as numpy."""
    return [np.asarray(fn(pkg, pkg.nd.array(img, dtype=str(img.dtype)))
                       .asnumpy()) for pkg in (tmx, jmx)]


def _close(got, want, rel):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(np.abs(want.astype(np.float64)).max(), 1e-30)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= rel * scale, err / scale


EXACT = {
    "crop": lambda p, x: p.nd.image.crop(x, 2, 3, 7, 5),
    "flip_left_right": lambda p, x: p.nd.image.flip_left_right(x),
    "flip_top_bottom": lambda p, x: p.nd.image.flip_top_bottom(x),
    "swap_axis": lambda p, x: p.nd.invoke("_image_swap_axis", [x], {}),
    "random_crop_full": lambda p, x: p.nd.image.random_crop(
        x, x.shape[-2], x.shape[-3]),
}
FLOAT = {
    "to_tensor": lambda p, x: p.nd.image.to_tensor(x),
    "normalize": lambda p, x: p.nd.image.normalize(
        p.nd.image.to_tensor(x), (0.485, 0.456, 0.406),
        (0.229, 0.224, 0.225)),
    "brightness": lambda p, x: p.nd.image.random_brightness(x, 0.7, 0.7),
    "contrast": lambda p, x: p.nd.image.random_contrast(x, 0.6, 0.6),
    "saturation": lambda p, x: p.nd.image.random_saturation(x, 1.3, 1.3),
    "hue": lambda p, x: p.nd.image.random_hue(x, 0.2, 0.2),
    "lighting": lambda p, x: p.nd.image.random_lighting(x, 0.0),
}
RESIZE = {
    "up": lambda p, x: p.nd.image.resize(x, (23, 17)),
    "down": lambda p, x: p.nd.image.resize(x, 7),
    "nearest_up": lambda p, x: p.nd.image.resize(x, (20, 30), interp=0),
    "nearest_down": lambda p, x: p.nd.image.resize(x, (9, 5), interp=0),
}


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("name", sorted(EXACT))
def test_exact_ops_match_jax(name, dtype, batch):
    got, want = _both(EXACT[name], _image(dtype=dtype, batch=batch))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("name", sorted(FLOAT))
def test_float_ops_match_jax(name, batch):
    got, want = _both(FLOAT[name], _image(batch=batch))
    _close(got, want, F_REL)


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("name", sorted(RESIZE))
def test_resize_matches_jax(name, dtype, batch):
    got, want = _both(RESIZE[name], _image(dtype=dtype, batch=batch))
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == np.uint8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        _close(got, want, RESIZE_REL)


def test_random_draws_within_their_ranges():
    x = tmx.nd.array(_image() + 1.0)
    base = x.asnumpy()
    tmx.random.seed(5)
    seen_lr, seen_tb = set(), set()
    for _ in range(16):
        b = tmx.nd.image.random_brightness(x, 0.5, 1.5).asnumpy() / base
        assert 0.5 <= b.min() and b.max() <= 1.5
        np.testing.assert_allclose(b, b.flat[0], rtol=1e-5)
        lr = tmx.nd.image.random_flip_left_right(x).asnumpy()
        seen_lr.add(bool(np.array_equal(lr, base[:, ::-1])))
        assert np.array_equal(lr, base) or np.array_equal(lr, base[:, ::-1])
        tb = tmx.nd.image.random_flip_top_bottom(x).asnumpy()
        seen_tb.add(bool(np.array_equal(tb, base[::-1])))
        assert np.array_equal(tb, base) or np.array_equal(tb, base[::-1])
        c = tmx.nd.image.random_crop(x, 5, 4).asnumpy()
        hits = [(y, z) for y in range(9) for z in range(12)
                if np.array_equal(c, base[y:y + 4, z:z + 5])]
        assert len(hits) == 1
    assert seen_lr == seen_tb == {True, False}
    lit = tmx.nd.image.random_lighting(x, 0.1).asnumpy() - base
    np.testing.assert_allclose(lit, np.broadcast_to(lit[:1, :1], lit.shape),
                               atol=1e-3)
    for op in ("random_contrast", "random_saturation", "random_hue"):
        out = getattr(tmx.nd.image, op)(x, 0.8, 1.2).asnumpy()
        assert out.shape == base.shape and np.isfinite(out).all()


def test_every_image_op_is_registered_in_both():
    from mxnet_tpu.ops.registry import REGISTRY as JREG
    from mxnet_tpu_torch.ops.registry import REGISTRY as TREG
    names = sorted(n for n in JREG if n.startswith("_image_"))
    assert len(names) == 15 and all(n in TREG for n in names)


# ---------------------------------------------------------------------------
# mx.image
# ---------------------------------------------------------------------------
@pytest.fixture
def png(tmp_path):
    from PIL import Image
    arr = _image(13, 17, seed=3, dtype=np.uint8)
    path = tmp_path / "img.png"
    Image.fromarray(arr).save(str(path))
    return path, arr


def test_imdecode_and_imread_match_jax(png):
    path, arr = png
    for flag, to_rgb in ((1, True), (1, False), (0, True)):
        got = tmx.image.imdecode(path.read_bytes(), flag, to_rgb).asnumpy()
        want = jmx.image.imdecode(path.read_bytes(), flag, to_rgb).asnumpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tmx.image.imread(str(path)).asnumpy(), arr)
    np.testing.assert_array_equal(
        tmx.nd.imdecode(path.read_bytes(), clip_rect=(1, 2, 9, 8)).asnumpy(),
        jmx.nd.imdecode(path.read_bytes(), clip_rect=(1, 2, 9, 8)).asnumpy())


FUNCTIONAL = {
    "imresize": lambda m, x: m.image.imresize(x, 9, 6),
    "resize_short": lambda m, x: m.image.resize_short(x, 8),
    "fixed_crop": lambda m, x: m.image.fixed_crop(x, 1, 2, 8, 6),
    "fixed_crop_size": lambda m, x: m.image.fixed_crop(x, 1, 2, 8, 6, (5, 4)),
    "center_crop": lambda m, x: m.image.center_crop(x, (7, 5))[0],
    "random_crop": lambda m, x: m.image.random_crop(x, (7, 5))[0],
    "random_size_crop": lambda m, x: m.image.random_size_crop(
        x, (6, 6), (0.3, 0.9), (0.75, 1.33))[0],
    "color_normalize": lambda m, x: m.image.color_normalize(
        x.astype("float32"), m.nd.array([10.0, 20.0, 30.0]),
        m.nd.array([2.0, 4.0, 8.0])),
    "border": lambda m, x: m.image.copyMakeBorder(x, 1, 2, 3, 0, values=7),
    "border_rgb": lambda m, x: m.image.copyMakeBorder(
        x, 2, 0, 1, 1, values=(1.0, 2.0, 3.0)),
}


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_functional_match_jax(name, dtype):
    img = _image(12, 16, seed=4, dtype=dtype)
    out = []
    for pkg in (tmx, jmx):
        random.seed(7)
        out.append(FUNCTIONAL[name](pkg, pkg.nd.array(
            img, dtype=str(img.dtype))).asnumpy())
    got, want = out
    assert got.shape == want.shape and got.dtype == want.dtype
    if "resize" in name or name in ("fixed_crop_size", "random_size_crop"):
        tol = 1 if dtype == np.uint8 else RESIZE_REL * 255
        assert np.abs(got.astype(np.float64) - want).max() <= tol
    else:
        _close(got, want, F_REL)
    assert tmx.image.scale_down((10, 8), (12, 12)) == \
        jmx.image.scale_down((10, 8), (12, 12))


def _augs(m):
    eigval = np.array([55.46, 4.794, 1.148], np.float32)
    eigvec = np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.814],
                       [-0.5836, -0.6948, 0.4203]], np.float32)
    i = m.image
    return {
        "resize": i.ResizeAug(10),
        "force_resize": i.ForceResizeAug((9, 11)),
        "center_crop": i.CenterCropAug((8, 6)),
        "random_crop": i.RandomCropAug((8, 6)),
        "random_sized_crop": i.RandomSizedCropAug((6, 6), 0.3, (0.75, 1.33)),
        "flip_always": i.HorizontalFlipAug(1.0),
        "flip_coin": i.HorizontalFlipAug(0.5),
        "cast": i.CastAug("float32"),
        "normalize": i.ColorNormalizeAug(np.array([1.0, 2.0, 3.0]),
                                         np.array([2.0, 2.0, 4.0])),
        "gray": i.RandomGrayAug(1.0),
        "lighting_basis": i.LightingAug(0.1, eigval, eigvec),
        "brightness_fixed": i.BrightnessJitterAug(0),
        "contrast_fixed": i.ContrastJitterAug(0),
        "saturation_fixed": i.SaturationJitterAug(0),
        "hue_fixed": i.HueJitterAug(0),
        "sequential": i.SequentialAug([i.CenterCropAug((10, 8)),
                                       i.HorizontalFlipAug(1.0)]),
        "random_order": i.RandomOrderAug([i.CastAug(),
                                          i.HorizontalFlipAug(0.5),
                                          i.CenterCropAug((10, 8))]),
        "color_jitter_fixed": i.ColorJitterAug(0, 0, 0),
    }


def _dumps(aug):
    try:
        return aug.dumps()
    except TypeError:  # the JAX package's LightingAug keeps numpy floats
        return None


@pytest.mark.parametrize("name", sorted(_augs(tmx)))
def test_augmenters_match_jax(name):
    """On a uint8 image, except the hue rotation: the JAX op casts its
    matrix to the image's dtype (all but lost in uint8), the port rotates
    an integer image in fp32, so that one runs on a float image."""
    dtype = "float32" if name == "hue_fixed" else "uint8"
    img = _image(12, 16, seed=5, dtype=dtype)
    out = []
    for pkg in (tmx, jmx):
        random.seed(3)
        np.random.seed(3)
        aug = _augs(pkg)[name]
        out.append((aug(pkg.nd.array(img, dtype=dtype)).asnumpy(),
                    _dumps(aug)))
    (got, got_d), (want, want_d) = out
    assert got_d == want_d or (want_d is None and name == "lighting_basis")
    assert isinstance(got_d, (str, list))
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1 if "resize" in name or "sized" in name else F_REL * 255
    assert np.abs(got.astype(np.float64) - want).max() <= tol


def test_create_augmenter_builds_the_same_list():
    kw = dict(resize=20, rand_crop=True, rand_mirror=True, brightness=0.4,
              contrast=0.4, saturation=0.4, hue=0.1, pca_noise=0.1,
              mean=np.array([123.68, 116.779, 103.939]),
              std=np.array([58.393, 57.12, 57.375]))
    got = tmx.image.CreateAugmenter((3, 16, 16), **kw)
    want = jmx.image.CreateAugmenter((3, 16, 16), **kw)
    assert [a.dumps() for a in got] == [a.dumps() for a in want]
    img = tmx.nd.array(_image(24, 30, dtype=np.uint8), dtype="uint8")
    for aug in got:
        img = aug(img)
    assert img.shape == (16, 16, 3) and np.isfinite(img.asnumpy()).all()


# ---------------------------------------------------------------------------
# ImageIter
# ---------------------------------------------------------------------------
@pytest.fixture
def image_dir(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(0)
    entries = []
    for i in range(10):
        arr = rng.randint(0, 255, (40, 36, 3), dtype=np.uint8)
        Image.fromarray(arr).save(str(tmp_path / f"img{i}.png"))
        entries.append((float(i % 3), f"img{i}.png"))
    return str(tmp_path), entries


def _batches(pkg, seed=0, **kw):
    random.seed(seed)
    it = pkg.image.ImageIter(**kw)
    out = []
    for epoch in range(2):
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        it.reset()
    return out, it


@pytest.mark.parametrize("form", ["imglist", "lst"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_image_iter_matches_jax(image_dir, form, shuffle):
    root, entries = image_dir
    kw = dict(batch_size=4, data_shape=(3, 32, 32), path_root=root,
              shuffle=shuffle, resize=34, mean=np.array([1.0, 2.0, 3.0]))
    if form == "imglist":
        kw["imglist"] = entries
    else:
        lst = os.path.join(root, "t.lst")
        with open(lst, "w") as f:
            for i, (lab, p) in enumerate(entries):
                f.write(f"{i}\t{lab}\t{p}\n")
        kw["path_imglist"] = lst
    got, it = _batches(tmx, **kw)
    want, _ = _batches(jmx, **kw)
    assert len(got) == len(want) == 6
    assert [b[2] for b in got] == [b[2] for b in want] == [0, 0, 2] * 2
    for (gd, gl, _), (wd, wl, _) in zip(got, want):
        assert gd.shape == (4, 3, 32, 32) and gd.dtype == np.float32
        np.testing.assert_array_equal(gl, wl)
        assert np.abs(gd - wd).max() <= 1.0  # the uint8 resize, see above
    assert it.provide_data[0].shape == (4, 3, 32, 32)
    assert it.provide_label[0].shape == (4,)


def test_image_iter_random_crop_and_mirror_match_jax(image_dir):
    """rand_crop and rand_mirror draw from Python's random in both."""
    root, entries = image_dir
    kw = dict(batch_size=5, data_shape=(3, 30, 28), imglist=entries,
              path_root=root, rand_crop=True, rand_mirror=True)
    got, _ = _batches(tmx, seed=11, **kw)
    want, _ = _batches(jmx, seed=11, **kw)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp


def test_image_iter_bad_lst_line(tmp_path):
    lst = tmp_path / "bad.lst"
    lst.write_text("0\timg0.png\n")
    with pytest.raises(ValueError, match="expected"):
        tmx.image.ImageIter(batch_size=1, data_shape=(3, 4, 4),
                            path_imglist=str(lst))
