"""The port's native clip loader (``mgldvsr_tpu_torch/native``) against the
JAX package's on the same packed records: PNG (8-bit RGB, RGBA, gray,
16-bit, palette) and a JPEG, the same pixels and shapes, within one ulp (the
port divides each 8-bit value by 255.f as numpy does, the JAX loader
multiplies by 1/255.f). Against the port's Python decode (``imfrombytes``)
bit for bit. Every status, the codec gate, pickling into a spawned process, the
build under a race, ``pack_image_dir`` and the dataset's native read path.
The JAX package itself is not edited."""
import io
import json
import multiprocessing
import os
import pickle
import threading
from concurrent.futures import ProcessPoolExecutor

import cv2
import numpy as np
import pytest

from mgldvsr_tpu.native import native_available as jax_native_available
from mgldvsr_tpu_torch import native
from mgldvsr_tpu_torch.data import datasets as pds
from mgldvsr_tpu_torch.data.file_client import PackedBackend, PackedMaker, imfrombytes
from mgldvsr_tpu_torch.native.loader import STATUS, NativeClipLoader, pack_image_dir

# the JAX loader is the reference: without it (no toolchain here) there is
# nothing to hold the port against
pytestmark = pytest.mark.skipif(not jax_native_available(),
                                reason="the JAX package's native loader does not build here")

ULPS = 1  # value / 255.f against the JAX loader's value * (1 / 255.f)


def _png_palette(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).convert("P", palette=Image.ADAPTIVE, colors=16).save(buf, "PNG")
    return buf.getvalue()


def _records(rs):
    """name -> encoded bytes: every PNG type the loader decodes, and a JPEG."""
    rgb = rs.randint(0, 256, (37, 53, 3), np.uint8)
    out = {
        "rgb.png": cv2.imencode(".png", rgb)[1].tobytes(),
        "rgba.png": cv2.imencode(".png", rs.randint(0, 256, (37, 53, 4), np.uint8))[1].tobytes(),
        "gray.png": cv2.imencode(".png", rs.randint(0, 256, (37, 53), np.uint8))[1].tobytes(),
        "rgb16.png": cv2.imencode(".png", rs.randint(0, 65536, (37, 53, 3),
                                                     np.uint16))[1].tobytes(),
        "palette.png": _png_palette(rgb),
        "photo.jpg": cv2.imencode(".jpg", rgb, [cv2.IMWRITE_JPEG_QUALITY, 85])[1].tobytes(),
    }
    for i in range(6):
        out[f"clip/{i:08d}.png"] = cv2.imencode(
            ".png", rs.randint(0, 256, (48, 64, 3), np.uint8))[1].tobytes()
    return out


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native") / "pack")
    recs = _records(np.random.RandomState(19))
    maker = PackedMaker(root)
    for k, data in recs.items():
        maker.put(k, data)
    maker.put("garbage.png", b"\x89PNG\r\n\x1a\n" + bytes(range(200)))
    maker.put("text.txt", b"not an image at all, just some bytes to fill the probe")
    maker.close()
    return root, recs


@pytest.fixture(scope="module")
def loaders(packed):
    from mgldvsr_tpu.native.loader import NativeClipLoader as JaxLoader

    port, jax_side = NativeClipLoader(packed[0], 3), JaxLoader(packed[0], num_threads=3)
    yield port, jax_side
    port.close()
    jax_side.close()


KINDS = ["rgb.png", "rgba.png", "gray.png", "rgb16.png", "palette.png", "photo.jpg"]


@pytest.mark.parametrize("key", KINDS)
def test_probe_and_decode_bit_for_bit_against_jax(loaders, key):
    """The same sizes and 8-bit levels as the JAX loader, each value within
    one ulp of its (the port divides by 255, the JAX loader multiplies by
    1/255)."""
    port, jax_side = loaders
    assert port.probe(key) == jax_side.probe(key) == (37, 53)
    got, want = port.decode(key), jax_side.decode(key)
    assert got.dtype == np.float32 and got.shape == (37, 53, 3)
    np.testing.assert_array_max_ulp(got, want, maxulp=ULPS)
    np.testing.assert_array_equal(np.round(got * 255), np.round(want * 255))


@pytest.mark.parametrize("hflip,vflip,transpose", [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                                                   (1, 1, 0), (1, 1, 1)])
def test_clips_bit_for_bit_against_jax(loaders, hflip, vflip, transpose):
    """Crops, flips and the transpose: the JAX loader's 8-bit levels, each
    value within one ulp."""
    port, jax_side = loaders
    keys = [f"clip/{i:08d}.png" for i in range(5)]
    kw = dict(hflip=bool(hflip), vflip=bool(vflip), transpose=bool(transpose))
    got = port.load_clip(keys, 5, 7, 30, 41, **kw)
    want = jax_side.load_clip(keys, 5, 7, 30, 41, **kw)
    assert got.shape == ((5, 41, 30, 3) if transpose else (5, 30, 41, 3))
    np.testing.assert_array_max_ulp(got, want, maxulp=ULPS)
    np.testing.assert_array_equal(np.round(got * 255), np.round(want * 255))


def test_tickets_fetched_out_of_order(loaders):
    port, jax_side = loaders
    keys = [f"clip/{i:08d}.png" for i in range(6)]
    cases = [(t % 4, t % 9, 8 + t % 5, 12 + t % 3, bool(t & 1), bool(t & 2), bool(t & 4))
             for t in range(20)]
    tickets = [port.submit_clip(keys[t % 3:t % 3 + 3], top, left, h, w, hflip=hf, vflip=vf,
                                transpose=tr)
               for t, (top, left, h, w, hf, vf, tr) in enumerate(cases)]
    for t in (7, 19, 0, 3, 12, 1, 18, 2, 4, 5, 6, 8, 9, 10, 11, 13, 14, 15, 16, 17):
        top, left, h, w, hf, vf, tr = cases[t]
        want = jax_side.load_clip(keys[t % 3:t % 3 + 3], top, left, h, w, hflip=hf, vflip=vf,
                                  transpose=tr)
        got = port.fetch(tickets[t])
        np.testing.assert_array_max_ulp(got, want, maxulp=ULPS)
        np.testing.assert_array_equal(np.round(got * 255), np.round(want * 255))


@pytest.mark.parametrize("key", ["rgb.png", "rgba.png", "gray.png", "clip/00000002.png"])
def test_against_the_python_decode(packed, loaders, key):
    """The 8-bit PNGs the Python decoder reads: the loader equals
    ``imfrombytes(float32=True)`` bit for bit, the JAX loader within one
    ulp."""
    _, recs = packed
    want = imfrombytes(recs[key], float32=True)
    np.testing.assert_array_equal(loaders[0].decode(key), want)
    np.testing.assert_array_max_ulp(loaders[1].decode(key), want, maxulp=ULPS)


def test_every_status(packed, loaders):
    """Statuses 1-4 on both loaders with the same exception types; 5 and 6
    (a codec not built) on a library built without codecs: both raise by
    name, and the header probe still answers."""
    root, _ = packed
    port, jax_side = loaders
    for loader in (port, jax_side):
        with pytest.raises(KeyError, match="not in packed index"):
            loader.probe("missing.png")
        with pytest.raises(IOError, match="crop out of bounds"):
            loader.load_clip(["clip/00000000.png"], 0, 0, 49, 8)
        with pytest.raises(IOError, match="crop out of bounds"):
            loader.load_clip(["clip/00000000.png"], -1, 0, 8, 8)
        with pytest.raises(IOError, match="decode error"):
            loader.probe("text.txt")
        with pytest.raises(IOError, match="decode error"):
            loader.load_clip(["garbage.png"], 0, 0, 1, 1)
    for lib, handle in ((port._lib, port._h), (jax_side._lib, jax_side._h)):
        h, w = native.loader.ctypes.c_int(), native.loader.ctypes.c_int()
        assert lib.mgld_probe(handle, 999, native.loader.ctypes.byref(h),
                              native.loader.ctypes.byref(w)) == 4
    # a record whose extent runs past the data file: a read error
    index = json.load(open(root + ".index.json"))
    bad = root + "_short"
    with open(root + ".data", "rb") as f:
        data = f.read()
    with open(bad + ".data", "wb") as f:
        f.write(data[:index["clip/00000005.png"][0] + 10])
    with open(bad + ".index.json", "w") as f:
        json.dump(index, f)
    short = NativeClipLoader(bad, 1)
    with pytest.raises(IOError, match="read error"):
        short.load_clip(["clip/00000005.png"], 0, 0, 8, 8)
    short.close()
    bare = NativeClipLoader(root, 1, library=native.build_native(codecs=()))
    assert bare.codecs == () and bare.probe("rgb.png") == (37, 53)
    with pytest.raises(IOError, match="png codec not built"):
        bare.decode("rgb.png")
    with pytest.raises(IOError, match="png codec not built"):
        bare.load_clip(["clip/00000000.png"], 0, 0, 8, 8)
    with pytest.raises(IOError, match="jpeg codec not built"):
        bare.decode("photo.jpg")
    bare.close()
    assert STATUS[5].startswith("png codec not built")
    with pytest.raises(FileNotFoundError):
        NativeClipLoader(str(os.path.dirname(root)) + "/nothing", 1)


def test_build_names_and_race(tmp_path):
    """The library's name follows its codecs; three threads forcing the same
    build at once leave one loadable file (each renames a whole file into
    place)."""
    found = native.found_codecs()
    assert set(found) <= {"png", "jpeg"}
    assert native.library_path(()) != native.library_path(("png", "jpeg"))
    assert native.library_path() == native.library_path(found)
    assert native.codecs() == found
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build_native(force=True, codecs=("jpeg",)))
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert native.loader.compiled_codecs(paths[0]) == ("jpeg",)
    assert not [p for p in os.listdir(native.BUILD_DIR) if p.endswith(".tmp")]
    with pytest.raises(ValueError, match="unknown codecs"):
        native.build_native(codecs=("webp",))


def test_pickled_into_a_spawned_process(packed, loaders):
    root, _ = packed
    keys = [f"clip/{i:08d}.png" for i in range(4)]
    state = pickle.loads(pickle.dumps(loaders[0]))
    assert state.library == loaders[0].library
    want = loaders[0].load_clip(keys, 3, 2, 20, 24, hflip=True, transpose=True)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as ex:
        got = ex.submit(NativeClipLoader.load_clip, loaders[0], keys, 3, 2, 20, 24,
                        hflip=True, transpose=True).result(timeout=120)
    np.testing.assert_array_equal(got, want)
    state.close()


def test_pack_image_dir_matches_jax(tmp_path):
    from mgldvsr_tpu.native.loader import pack_image_dir as jax_pack

    rs = np.random.RandomState(3)
    src = tmp_path / "frames"
    for clip in ("001", "000"):
        (src / clip).mkdir(parents=True)
        for i in (2, 0, 1):
            cv2.imwrite(str(src / clip / f"{i:08d}.png"), rs.randint(0, 256, (9, 11, 3),
                                                                       np.uint8))
    cv2.imwrite(str(src / "000" / "extra.jpg"), rs.randint(0, 256, (9, 11, 3), np.uint8))
    (src / "000" / "notes.txt").write_text("skipped")
    assert pack_image_dir(str(src), str(tmp_path / "port")) == jax_pack(
        str(src), str(tmp_path / "jax")) == 7
    for ext in (".data", ".index.json"):
        assert (tmp_path / ("port" + ext)).read_bytes() == (tmp_path / ("jax" + ext)).read_bytes()


def _gt_folder(root, rs):
    for clip in ("005", "006"):
        os.makedirs(os.path.join(root, clip))
        for i in range(7):
            cv2.imwrite(os.path.join(root, clip, f"{i:08d}.png"),
                        rs.randint(0, 256, (64, 80, 3), np.uint8))


def test_dataset_native_read_path(tmp_path):
    """``read_path`` is native here; a sample (degradations on) equals the
    disk path's bit for bit (the JAX package's bar is 1e-6), also through
    the prefetch's spawned workers; with the degradations off the GT crops
    equal the JAX dataset's disk path bit for bit, its packed path within
    one ulp (the port's loader divides, as the disk path does), and its
    packed path bit for bit once the port's dataset reads through the JAX
    loader (the same draws in the same order)."""
    from mgldvsr_tpu.native.loader import NativeClipLoader as JaxLoader
    import mgldvsr_tpu.data.datasets as jds

    root = str(tmp_path / "gt")
    _gt_folder(root, np.random.RandomState(11))
    pk = str(tmp_path / "pk")
    pack_image_dir(root, pk)
    deg = {"random_blur": {"params": {"prob": 1.0, "kernel_size": [3], "kernel_list": ["iso"],
                                      "kernel_prob": [1.0], "sigma_x": [0.4, 1.0],
                                      "sigma_y": [0.4, 1.0], "rotate_angle": [-3.14, 3.14]}}}
    kw = dict(num_frame=3, gt_size=32, use_hflip=True, use_rot=True, val_partition="none",
              degradation_1=deg, seed=5)
    disk = pds.RealVSRRecurrentDataset(root, **kw)
    ds = pds.RealVSRRecurrentDataset(root, packed_root=pk, io_threads=2, **kw)
    assert disk.read_path == "disk" and ds.read_path == "native"
    for index in range(4):
        a, b = disk[index], ds[index]
        for key in ("lqs", "gts"):
            np.testing.assert_allclose(b[key], a[key], atol=1e-6, rtol=0)
            np.testing.assert_array_equal(b[key], a[key])
    for index, item in zip((3, 1), pds.prefetch_iterator(ds, [3, 1], num_workers=2)):
        np.testing.assert_array_equal(item["gts"], disk[index]["gts"])

    off = dict(kw, degradation_1=None, usm_gt=False)
    port = pds.RealVSRRecurrentDataset(root, packed_root=pk, **off)
    jax_side = jds.RealVSRRecurrentDataset(root, packed_root=pk, **off)
    assert jax_side.packed is not None  # the JAX dataset took its native path
    jax_disk = jds.RealVSRRecurrentDataset(root, **off)
    for index in range(4):
        want, got = jax_side[index]["gts"], port[index]["gts"]
        np.testing.assert_array_equal(got, jax_disk[index]["gts"])
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    port.packed = JaxLoader(pk, num_threads=2)
    for index in range(4):
        np.testing.assert_array_equal(port[index]["gts"], jax_side[index]["gts"])


def test_dataset_python_read_path_without_the_png_codec(tmp_path, monkeypatch):
    """Without the PNG codec the dataset takes the Python packed path, chosen
    at construction, with the same samples."""
    root = str(tmp_path / "gt")
    _gt_folder(root, np.random.RandomState(12))
    pk = str(tmp_path / "pk")
    pack_image_dir(root, pk)
    monkeypatch.setattr(native, "codecs", lambda: ("jpeg",))
    kw = dict(num_frame=3, gt_size=32, use_rot=True, val_partition="none", seed=2)
    ds = pds.RealVSRRecurrentDataset(root, packed_root=pk, **kw)
    assert ds.read_path == "python" and isinstance(ds.packed, PackedBackend)
    disk = pds.RealVSRRecurrentDataset(root, **kw)
    for index in range(3):
        np.testing.assert_array_equal(ds[index]["lqs"], disk[index]["lqs"])
