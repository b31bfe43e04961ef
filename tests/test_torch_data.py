"""The training data path without OpenCV: ``data/cv_ops.py`` against cv2
(which the test environment has), and the port's degradations and dataset byte for byte
against the JAX package's on the same PNG folder and seed.

For the byte-for-byte comparison the JAX modules' ``cv2`` attribute is
replaced by a shim built from ``cv_ops`` and their ``_av`` by None, and the
port's video compression gets the same shim and no PyAV: both sides run the
same primitives and take the no-codec branch, and the comparison holds the
logic and the order of the random draws; the primitives are held against
cv2 on their own. The JAX package itself is not edited. A whole item is not
compared with the real codec: the primitives' differences of up to 1e-5
become whole uint8 steps through its quantisation (up to 0.0604 measured;
``tests/test_torch_video_codec.py`` holds the codec's round trip alone).

cv2 routes some calls to Intel IPP, whose float32 resize and gray
conversion differ from OpenCV's own kernels (resize by up to 2e-5, gray by
one ulp in a pixel-alignment pattern). ``cv_ops`` follows OpenCV's own
kernels, so these tests turn IPP off, and measure what IPP gives too.
Limits: gray (BGR and RGB) bit for bit; filter2D, GaussianBlur and resize
within 1e-5 on [0, 1] (filter2D's border modes within 1e-6, and bit for bit
on float64 under OpenCV's DFT threshold); the JPEG round trip bit for bit with libjpeg-turbo at every quality
tried (the contract allowed mean |d| <= 0.5/255, max |d| <= 4/255).
"""
import os
import subprocess
import sys
import types

import cv2
import numpy as np
import pytest

import mgldvsr_tpu.data.blur_kernels as jblur
import mgldvsr_tpu.data.datasets as jds
import mgldvsr_tpu.data.degradations as jdeg
from mgldvsr_tpu.cli.train import default_degradation_cfg as jax_recipe
from mgldvsr_tpu_torch.cli.train import default_degradation_cfg
from mgldvsr_tpu_torch.data import blur_kernels, cv_ops
from mgldvsr_tpu_torch.data import datasets as pds
from mgldvsr_tpu_torch.data import degradations as pdeg
from mgldvsr_tpu_torch.data.file_client import DiskBackend, PackedBackend, PackedMaker, imfrombytes
from mgldvsr_tpu_torch.io.frames import encode_png, write_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _image(seed, h, w, c=3):
    rs = np.random.RandomState(seed)
    base = rs.rand(h // 4 + 2, w // 4 + 2, c)
    smooth = np.kron(base, np.ones((4, 4, 1)))[:h, :w]
    return np.clip(0.7 * smooth + 0.3 * rs.rand(h, w, c), 0, 1).astype(np.float32)


# -- primitives against cv2 ---------------------------------------------------


@pytest.mark.parametrize("width", [7, 53, 60, 64, 130])
def test_gray_is_bit_for_bit(no_ipp, width):
    img = _image(width, 31, width)
    np.testing.assert_array_equal(cv_ops.cvtColor(img, cv_ops.COLOR_BGR2GRAY),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


def test_gray_with_ipp_within_one_ulp():
    img = _image(3, 31, 53)
    got, want = cv_ops.cvtColor(img, cv_ops.COLOR_BGR2GRAY), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    assert (np.abs(got - want) <= np.spacing(np.maximum(got, want))).all()


@pytest.mark.parametrize("ksize", [7, 13, 21])
def test_filter2d(ksize):
    img = _image(ksize, 67, 45)
    k = blur_kernels.make_kernel("aniso", ksize, 2.0, 0.7, 0.4, 1, 1, 1)
    assert np.abs(cv_ops.filter2D(img, -1, k) - cv2.filter2D(img, -1, k)).max() <= 1e-5


@pytest.mark.parametrize("border", ["replicate", "reflect101"])
@pytest.mark.parametrize("ksize", [7, 11])
def test_filter2d_border_and_float64(border, ksize):
    """``borderType``: float32 [0, 1] within 1e-6 (FFT against OpenCV's
    sums); float64 [0, 255] under OpenCV's DFT threshold (7x7, NIQE's window)
    bit for bit, over it (11x11, SSIM's) within 1e-6."""
    cv_border = {"replicate": cv2.BORDER_REPLICATE, "reflect101": cv2.BORDER_REFLECT_101}[border]
    ours = {"replicate": cv_ops.BORDER_REPLICATE, "reflect101": cv_ops.BORDER_REFLECT_101}[border]
    ax = np.arange(ksize) - ksize // 2
    g = np.exp(-(ax ** 2) / (2 * 1.3 ** 2))
    k = np.outer(g, g) / np.outer(g, g).sum()
    img = _image(ksize, 50, 61, c=1)[..., 0]
    got = cv_ops.filter2D(img, -1, k, borderType=ours)
    assert np.abs(got - cv2.filter2D(img, -1, k, borderType=cv_border)).max() <= 1e-6
    img64 = np.round(img.astype(np.float64) * 255)
    got64 = cv_ops.filter2D(img64, -1, k, borderType=ours)
    want64 = cv2.filter2D(img64, -1, k, borderType=cv_border)
    assert got64.dtype == np.float64
    if ksize * ksize < 50:
        np.testing.assert_array_equal(got64, want64)
    else:
        assert np.abs(got64 - want64).max() <= 1e-6


@pytest.mark.parametrize("width", [7, 53, 64])
def test_rgb_gray_is_bit_for_bit(no_ipp, width):
    img = _image(width + 1, 31, width)
    np.testing.assert_array_equal(cv_ops.cvtColor(img, cv_ops.COLOR_RGB2GRAY),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


def test_rgb_gray_with_ipp_within_one_ulp():
    img = _image(5, 31, 53)
    got, want = cv_ops.cvtColor(img, cv_ops.COLOR_RGB2GRAY), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    assert (np.abs(got - want) <= np.spacing(np.maximum(got, want))).all()


@pytest.mark.parametrize("ksize", [5, 51])
def test_gaussian_blur(ksize):
    img = _image(ksize, 70, 90)
    got = cv_ops.GaussianBlur(img, (ksize, ksize), 0)
    assert np.abs(got - cv2.GaussianBlur(img, (ksize, ksize), 0)).max() <= 1e-5


@pytest.mark.parametrize("interp", [cv2.INTER_NEAREST, cv2.INTER_LINEAR, cv2.INTER_CUBIC,
                                    cv2.INTER_AREA, cv2.INTER_LANCZOS4])
def test_resize(no_ipp, interp):
    img = _image(interp, 77, 91)
    for size in [(45, 38), (182, 154), (91, 77), (46, 39), (120, 100), (30, 90), (200, 40),
                 (182, 77), (90, 76), (33, 33), (128, 128)]:
        want = cv2.resize(img, size, interpolation=interp)
        got = cv_ops.resize(img, size, interp)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got - want).max() <= 1e-5, size


def test_resize_with_ipp_is_measured():
    """With IPP on, cv2's own answer moves: the port stays within 5e-5."""
    img = _image(1, 77, 91)
    for interp in (cv2.INTER_LINEAR, cv2.INTER_CUBIC, cv2.INTER_AREA):
        for size in [(45, 38), (182, 154), (120, 100)]:
            want = cv2.resize(img, size, interpolation=interp)
            assert np.abs(cv_ops.resize(img, size, interp) - want).max() <= 5e-5


@pytest.mark.parametrize("quality", [30, 60, 95])
def test_jpeg_roundtrip_is_bit_for_bit(quality):
    worst = []
    for seed, (h, w) in enumerate([(64, 64), (67, 53), (101, 131), (9, 250)]):
        u8 = (_image(seed, h, w) * 255).astype(np.uint8)
        _, buf = cv2.imencode(".jpg", u8, [cv2.IMWRITE_JPEG_QUALITY, quality])
        want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED).astype(np.int32)
        got = cv_ops.jpeg_roundtrip(u8, quality).astype(np.int32)
        d = np.abs(got - want)
        worst.append((d.mean() / 255, d.max() / 255))
        np.testing.assert_array_equal(got, want)
    assert max(m for m, _ in worst) <= 0.5 / 255 and max(x for _, x in worst) <= 4 / 255


def test_jpeg_through_imencode_and_noise_images():
    rs = np.random.RandomState(0)
    for u8 in (rs.randint(0, 256, (33, 17, 3)).astype(np.uint8),
               (rs.rand(40, 24, 3) > 0.5).astype(np.uint8) * 255):
        ok, buf = cv_ops.imencode(".jpg", u8, [cv_ops.IMWRITE_JPEG_QUALITY, 47])
        assert ok
        want = cv2.imdecode(cv2.imencode(".jpg", u8, [cv2.IMWRITE_JPEG_QUALITY, 47])[1],
                            cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(cv_ops.imdecode(buf, cv_ops.IMREAD_UNCHANGED), want)


def test_png_read_and_imfrombytes(tmp_path):
    rgb = (np.random.RandomState(0).rand(9, 11, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "a.png")
    write_frame(path, rgb)
    np.testing.assert_array_equal(cv_ops.imread(path), cv2.imread(path, cv2.IMREAD_COLOR))
    assert cv_ops.imread(str(tmp_path / "missing.png")) is None
    np.testing.assert_array_equal(imfrombytes(encode_png(rgb)), rgb[..., ::-1])
    np.testing.assert_array_equal(imfrombytes(encode_png(rgb), float32=True),
                                  rgb[..., ::-1].astype(np.float32) / 255)


@pytest.mark.parametrize("kind", blur_kernels.KERNEL_TYPES)
def test_blur_kernels_are_the_jax_ones(kind):
    for size in (7, 21):
        args = (kind, size, 1.7, 0.6, 0.9, 1.5, 1.3, 1.9)
        np.testing.assert_array_equal(blur_kernels.make_kernel(*args), jblur.make_kernel(*args))


# -- the JAX degradations on the shim, byte for byte --------------------------


class _NoVideoWriter:
    def __init__(self, *args, **kwargs):
        pass

    def isOpened(self):
        return False

    def release(self):
        pass


@pytest.fixture
def shimmed(monkeypatch):
    shim = types.SimpleNamespace(**{k: getattr(cv_ops, k) for k in dir(cv_ops)
                                    if not k.startswith("_")})
    shim.VideoWriter = _NoVideoWriter
    shim.VideoWriter_fourcc = lambda *codes: 0
    monkeypatch.setattr(jdeg, "cv2", shim)
    monkeypatch.setattr(jds, "cv2", shim)
    monkeypatch.setattr(jdeg, "_av", None)
    monkeypatch.setattr(jdeg, "_FOURCC_CACHE", {})
    # the port imports its codecs inside the call: the same shim and no PyAV
    monkeypatch.setattr(pdeg, "_import_cv2", lambda: shim)
    monkeypatch.setattr(pdeg, "_import_av", lambda: None)
    monkeypatch.setattr(pdeg, "_FOURCC_CACHE", {})


def test_recipe_is_the_jax_one():
    assert default_degradation_cfg() == jax_recipe()


def _results(seed):
    frames = [_image(seed * 10 + i, 48, 56) for i in range(5)]
    return {"lqs": [f.copy() for f in frames], "gts": [f.copy() for f in frames]}


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert len(a[k]) == len(b[k])
        for x, y in zip(a[k], b[k]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["random_blur", "random_resize", "random_noise", "random_jpeg",
                                  "random_mpeg", "resize_final", "blur_final"])
def test_each_transform_byte_for_byte(shimmed, name):
    deg1, deg2 = default_degradation_cfg()
    cfg = {name: (deg2 if name in deg2 and name not in deg1 else deg1)[name]}
    if name == "resize_final":
        cfg[name] = dict(params=dict(deg2[name]["params"], target_size=[20, 24]))
    for seed in range(6):
        j, p = jdeg.DegradationStage(cfg), pdeg.DegradationStage(cfg)
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        _same(j(_results(seed), rj), p(_results(seed), rp))
        assert rj.randint(2**31) == rp.randint(2**31)  # the same draws were made


def test_noise_gray_poisson_byte_for_byte(shimmed):
    """The Poisson branch with gray noise: np.unique of the gray image sets
    the rate, so the gray conversion must agree to the bit."""
    cfg = {"random_noise": {"params": dict(
        noise_type=["poisson"], noise_prob=[1.0], poisson_scale=[0.05, 3],
        poisson_gray_noise_prob=1.0, poisson_scale_step=0.005)}}
    for seed in range(3):
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        _same(jdeg.DegradationStage(cfg)(_results(seed), rj),
              pdeg.DegradationStage(cfg)(_results(seed), rp))


def test_usm_byte_for_byte(shimmed):
    r = _results(4)
    _same(jdeg.UnsharpMasking()(dict(r)), pdeg.UnsharpMasking()(dict(r)))


@pytest.fixture(scope="module")
def gt_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("gt")
    for c, clip in enumerate(("000", "001", "002")):  # 000 is a REDS4 clip
        os.makedirs(root / clip)
        for i in range(10):
            write_frame(str(root / clip / f"{i:08d}.png"),
                        (_image(100 * c + i, 72, 80) * 255).astype(np.uint8))
    return str(root)


def _two_stage(lq):
    deg1, deg2 = default_degradation_cfg()
    final = dict(deg2["resize_final"]["params"], target_size=[lq, lq])
    return deg1, dict(deg2, resize_final=dict(params=final))


@pytest.mark.parametrize("stages", ["one", "two"])
def test_dataset_byte_for_byte(shimmed, gt_folder, stages):
    deg1, deg2 = _two_stage(16)
    if stages == "one":
        deg2 = None
        deg1 = dict(deg1, resize_final=dict(params=dict(target_size=[16, 16],
                                                        resize_opt=["bicubic"],
                                                        resize_prob=[1.0])))
    for seed in (0, 5):
        kw = dict(num_frame=5, gt_size=64, degradation_1=deg1, degradation_2=deg2, seed=seed,
                  interval_list=(1, 2), use_rot=True)
        j, p = jds.RealVSRRecurrentDataset(gt_folder, **kw), pds.RealVSRRecurrentDataset(
            gt_folder, **kw)
        assert j.clips == p.clips == [("001", 10), ("002", 10)]
        for index in range(3):
            a, b = j[index], p[index]
            assert a["clip"] == b["clip"]
            np.testing.assert_array_equal(a["indices"], b["indices"])
            for key in ("lqs", "gts"):
                assert a[key].dtype == b[key].dtype == np.float32
                assert a[key].shape == b[key].shape
                np.testing.assert_array_equal(a[key], b[key])
            assert b["lqs"].shape == (5, 16, 16, 3) and b["gts"].shape == (5, 64, 64, 3)


def test_packed_backend_gives_the_disk_samples(gt_folder, tmp_path):
    root = str(tmp_path / "packed")
    maker = PackedMaker(root)
    for clip in ("000", "001", "002"):
        for i in range(10):
            with open(os.path.join(gt_folder, clip, f"{i:08d}.png"), "rb") as f:
                maker.put(f"{clip}/{i:08d}.png", f.read())
    maker.close()
    want = DiskBackend().get(os.path.join(gt_folder, "001", "00000003.png"))
    assert PackedBackend(root).get("001/00000003.png") == want
    deg1, _ = _two_stage(16)
    kw = dict(num_frame=3, gt_size=32, degradation_1=deg1, seed=2)
    disk = pds.RealVSRRecurrentDataset(gt_folder, **kw)
    packed = pds.RealVSRRecurrentDataset(gt_folder, packed_root=root, **kw)
    for index in range(2):
        np.testing.assert_array_equal(disk[index]["lqs"], packed[index]["lqs"])
    # through the prefetch's worker processes, which get the dataset pickled
    for index, item in zip((1, 0), pds.prefetch_iterator(packed, [1, 0], num_workers=2)):
        np.testing.assert_array_equal(disk[index]["lqs"], item["lqs"])


def test_sampler_and_prefetch_are_the_jax_ones():
    for kw in (dict(num_samples=7), dict(num_samples=5, shard=1, num_shards=2, ratio=3, seed=4)):
        for epoch in (0, 3):
            np.testing.assert_array_equal(pds.ShardedSampler(**kw).epoch(epoch),
                                          jds.ShardedSampler(**kw).epoch(epoch))

    echo = [i * 2 for i in range(10)]  # item i is 2i
    order = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
    assert list(pds.prefetch_iterator(echo, order, num_workers=3, queue_size=2)) == [
        i * 2 for i in order]
    endless = pds.prefetch_iterator(echo, iter(lambda: 7, None), num_workers=2)
    assert [next(endless) for _ in range(3)] == [14, 14, 14]
    endless.close()


def test_data_path_imports_without_cv2_pil_or_av():
    code = (
        "import sys\n"
        "for m in ('cv2', 'PIL', 'av', 'jax', 'mgldvsr_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, os, tempfile\n"
        "from mgldvsr_tpu_torch.data import cv_ops, datasets, degradations, file_client\n"
        "from mgldvsr_tpu_torch.cli.train import default_degradation_cfg\n"
        "from mgldvsr_tpu_torch.io.frames import codec, write_frame\n"
        "assert codec() == 'png'\n"
        "d = tempfile.mkdtemp(); os.makedirs(d + '/001')\n"
        "rs = np.random.RandomState(0)\n"
        "for i in range(5):\n"
        "    write_frame(d + f'/001/{i:08d}.png', (rs.rand(40, 40, 3) * 255).astype(np.uint8))\n"
        "deg1, deg2 = default_degradation_cfg()\n"
        "deg2['resize_final']['params']['target_size'] = [8, 8]\n"
        "ds = datasets.RealVSRRecurrentDataset(d, gt_size=32, degradation_1=deg1,\n"
        "                                      degradation_2=deg2)\n"
        "item = ds[0]\n"
        "print(item['lqs'].shape, item['gts'].shape)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "(5, 8, 8, 3) (5, 32, 32, 3)"
