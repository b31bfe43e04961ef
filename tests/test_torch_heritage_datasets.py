"""The heritage datasets against the JAX package's, bit for bit on the same
PNG files and seed (DUF's Gaussian downsampling within 1e-6: its 13x13
filter takes the FFT path here and OpenCV's DFT there), and the data
path's OpenCV stand-ins this slice adds against cv2: ``filter2D`` with a
zero border, ``imread`` in gray, and ``FileClient`` against the JAX one.
"""
import os

import cv2
import numpy as np
import pytest

from mgldvsr_tpu.data import file_client as jfc
from mgldvsr_tpu.data import heritage_datasets as jhd
from mgldvsr_tpu_torch.data import cv_ops
from mgldvsr_tpu_torch.data import file_client as pfc
from mgldvsr_tpu_torch.data import heritage_datasets as phd

GT, LQ, FRAMES = (32, 48), (8, 12), 12


def _png(path, rs, size, gray=False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    shape = size if gray else size + (3,)
    cv2.imwrite(path, rs.randint(0, 256, shape, np.uint8))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("heritage")
    rs = np.random.RandomState(0)
    r = {k: str(base / k) for k in ("gt", "lq", "flow", "vgt", "vlq")}
    with open(base / "meta_reds.txt", "w") as f:
        for clip in ("000", "001", "002"):
            f.write(f"{clip} {FRAMES} ({GT[0]},{GT[1]},3)\n")
            for i in range(FRAMES):
                _png(f"{r['gt']}/{clip}/{i:08d}.png", rs, GT)
                _png(f"{r['lq']}/{clip}/{i:08d}.png", rs, LQ)
                for tag in ("p1", "p2", "n1", "n2"):
                    _png(f"{r['flow']}/{clip}/{i:08d}_{tag}.png", rs, (2 * LQ[0], LQ[1]),
                         gray=True)
    with open(base / "meta_vimeo.txt", "w") as f:
        for key in ("00001/0001", "00001/0002"):
            f.write(f"{key} 7 ({GT[0]},{GT[1]},3)\n")
            for i in range(1, 8):
                _png(f"{r['vgt']}/{key}/im{i}.png", rs, GT)
                _png(f"{r['vlq']}/{key}/im{i}.png", rs, LQ)
    r["meta_reds"], r["meta_vimeo"] = str(base / "meta_reds.txt"), str(base / "meta_vimeo.txt")
    return r


def _same_items(jds, pds, n=None):
    assert len(jds) == len(pds)
    for i in range(len(jds) if n is None else n):
        want, got = jds[i], pds[i]
        assert sorted(want) == sorted(got)
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
            else:
                assert want[k] == got[k], k


def test_reds_datasets_match_jax(roots):
    kw = dict(gt_size=16, scale=4, interval_list=(1, 2), random_reverse=True,
              frames_per_clip=FRAMES, seed=3)
    for cls_j, cls_p, extra in ((jhd.REDSDataset, phd.REDSDataset,
                                 dict(num_frame=5, flow_root=roots["flow"])),
                                (jhd.REDSDataset, phd.REDSDataset, dict(num_frame=3)),
                                (jhd.REDSRecurrentDataset, phd.REDSRecurrentDataset,
                                 dict(num_frame=4)),
                                (jhd.REDSRecurrentDataset, phd.REDSRecurrentDataset,
                                 dict(num_frame=4, test_mode=True))):
        args = (roots["gt"], roots["lq"], roots["meta_reds"])
        _same_items(cls_j(*args, **kw, **extra), cls_p(*args, **kw, **extra), 6)


@pytest.mark.parametrize("recurrent", [False, True])
def test_vimeo_datasets_match_jax(roots, recurrent):
    cj, cp = ((jhd.Vimeo90KRecurrentDataset, phd.Vimeo90KRecurrentDataset) if recurrent
              else (jhd.Vimeo90KDataset, phd.Vimeo90KDataset))
    kw = dict(gt_size=16, scale=4, random_reverse=True, seed=5,
              **({"flip_sequence": True} if recurrent else {"num_frame": 5}))
    args = (roots["vgt"], roots["vlq"], roots["meta_vimeo"])
    _same_items(cj(*args, **kw), cp(*args, **kw))


def test_test_protocols_match_jax(roots):
    for padding in ("replicate", "reflection", "reflection_circle", "circle"):
        for idx in range(FRAMES):
            assert (phd.generate_frame_indices(idx, FRAMES, 5, padding)
                    == jhd.generate_frame_indices(idx, FRAMES, 5, padding))
    args = (roots["gt"], roots["lq"])
    _same_items(jhd.VideoTestDataset(*args, num_frame=5), phd.VideoTestDataset(*args, num_frame=5),
                10)
    _same_items(jhd.VideoTestDataset(*args, num_frame=3, cache_data=True),
                phd.VideoTestDataset(*args, num_frame=3, cache_data=True), 4)
    _same_items(jhd.VideoRecurrentTestDataset(*args), phd.VideoRecurrentTestDataset(*args))
    _same_items(jhd.VideoTestDUFDataset(*args, num_frame=3),
                phd.VideoTestDUFDataset(*args, num_frame=3), 4)
    vargs = (roots["vgt"], roots["vlq"], roots["meta_vimeo"])
    _same_items(jhd.VideoTestVimeo90KDataset(*vargs), phd.VideoTestVimeo90KDataset(*vargs))
    _same_items(jhd.PairedImageDataset(f"{roots['gt']}/001", f"{roots['lq']}/001", 16,
                                       phase="train", seed=2),
                phd.PairedImageDataset(f"{roots['gt']}/001", f"{roots['lq']}/001", 16,
                                       phase="train", seed=2))
    _same_items(jhd.SingleImageDataset(f"{roots['lq']}/002"),
                phd.SingleImageDataset(f"{roots['lq']}/002"))


def test_duf_downsampling_matches_jax(roots):
    args = (roots["gt"], roots["lq"])
    want = jhd.VideoTestDUFDataset(*args, num_frame=3, use_duf_downsampling=True)[2]
    got = phd.VideoTestDUFDataset(*args, num_frame=3, use_duf_downsampling=True)[2]
    assert got["lqs"].shape == want["lqs"].shape == (3, 8, 12, 3)
    np.testing.assert_allclose(got["lqs"], want["lqs"], atol=1e-6, rtol=0)
    assert np.array_equal(got["gt"], want["gt"])
    x = np.random.RandomState(1).rand(2, 27, 33, 3).astype(np.float32)
    for scale in (2, 3):
        np.testing.assert_allclose(phd.duf_downsample(x, scale=scale),
                                   jhd.duf_downsample(x, scale=scale), atol=1e-6, rtol=0)
    dx, dy = np.random.RandomState(2).randint(0, 256, (2, 5, 7)).astype(np.uint8)
    for denorm in (False, True):
        assert np.array_equal(phd.dequantize_flow(dx, dy, denorm=denorm),
                              jhd.dequantize_flow(dx, dy, denorm=denorm))


def test_filter2d_zero_border_matches_cv2():
    rs = np.random.RandomState(3)
    img64 = rs.rand(11, 13, 3)
    k = rs.rand(3, 5)
    k = k / k.sum()
    want = cv2.filter2D(img64, -1, k, borderType=cv2.BORDER_CONSTANT)
    assert np.array_equal(cv_ops.filter2D(img64, -1, k, borderType=cv_ops.BORDER_CONSTANT), want)
    img32 = rs.rand(29, 31).astype(np.float32)
    k13 = rs.rand(13, 13)
    want = cv2.filter2D(img32, -1, k13 / k13.sum(), borderType=cv2.BORDER_CONSTANT)
    got = cv_ops.filter2D(img32, -1, k13 / k13.sum(), borderType=cv_ops.BORDER_CONSTANT)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_imread_grayscale_matches_cv2(tmp_path):
    rs = np.random.RandomState(4)
    for name, gray in (("color.png", False), ("gray.png", True)):
        path = str(tmp_path / name)
        _png(path, rs, (19, 23), gray=gray)
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        got = cv_ops.imread(path, cv_ops.IMREAD_GRAYSCALE)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
        assert np.array_equal(cv_ops.imread(path), cv2.imread(path, cv2.IMREAD_COLOR)), name
    assert cv_ops.imread(str(tmp_path / "missing.png"), cv_ops.IMREAD_GRAYSCALE) is None


def test_file_client_matches_jax(tmp_path, roots):
    path = f"{roots['lq']}/001/00000003.png"
    assert pfc.FileClient().get(path) == jfc.FileClient().get(path)
    root = str(tmp_path / "packed")
    maker = pfc.PackedMaker(root)
    for i in range(3):
        maker.put(f"k{i}", bytes([i]) * (i + 5))
    maker.close()
    port, jax_side = pfc.FileClient("packed", root=root), jfc.FileClient("packed", root=root)
    assert port.backend == "packed"
    for i in range(3):
        assert port.get(f"k{i}") == jax_side.get(f"k{i}") == bytes([i]) * (i + 5)
    # lmdb and memcached route to their backends, which name the missing package
    with pytest.raises(ImportError, match="lmdb"):
        pfc.FileClient("lmdb", db_path=str(tmp_path / "db"))
    with pytest.raises(ImportError, match="pylibmc"):
        pfc.FileClient("memcached", server_list_cfg="localhost:11211")
    with pytest.raises(ValueError):
        pfc.FileClient("s3")
