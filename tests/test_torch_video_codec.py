"""The video-codec round trip of the stage-1 degradations
(``RandomVideoCompression``) against the JAX package's class.

Both classes take PyAV where it imports, else cv2's ``VideoWriter``, else
identity. With this machine's cv2 (and PyAV taken away on both sides) the
two call the same encoder on the same uint8 frames, so the port's frames
must equal the JAX class's bit for bit (measured difference: 0 for each of
the recipe's three codec names), with the same draws left behind. PyAV is
checked only through a fake module that records what it is given: neither
this machine nor the card's has PyAV.

A whole stage-1 item is not compared with real cv2: the port's resize and
blur stand within 1e-5 of cv2's (``tests/test_torch_data.py``), and the
codec's quantisation turns such a difference into whole uint8 steps (up to
0.0604, about 15/255, on the dataset tests' folder and seeds). The dataset
comparison of ``tests/test_torch_data.py`` keeps its shim for that reason.
"""
import logging
import sys
import types

import cv2
import numpy as np
import pytest

import mgldvsr_tpu.data.degradations as jdeg
from mgldvsr_tpu.cli.train import default_degradation_cfg as jax_recipe
from mgldvsr_tpu_torch.data import degradations as pdeg

MPEG = jax_recipe()[0]["random_mpeg"]["params"]  # the shipped parameters


@pytest.fixture
def fresh_caches(monkeypatch):
    """Each side's fourcc cache empty, and PyAV taken away from the JAX
    class (neither machine has it; the port imports it inside the call)."""
    monkeypatch.setattr(jdeg, "_FOURCC_CACHE", {})
    monkeypatch.setattr(pdeg, "_FOURCC_CACHE", {})
    monkeypatch.setattr(jdeg, "_av", None)
    monkeypatch.setitem(sys.modules, "av", None)


def _cv2_writes() -> bool:
    return any(pdeg._probe_fourcc(cv2, codec) for codec in ("libx264", "h264", "mpeg4"))


def _clip(seed, frames=5, h=48, w=64):
    """uint8-exact float32 BGR frames in [0, 1]."""
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (h, w, 3)).astype(np.float32) / 255 for _ in range(frames)]


def _seed_drawing(codec: str) -> int:
    """The first seed whose draw (after the prob gate's) is ``codec``."""
    for seed in range(100):
        rs = np.random.RandomState(seed)
        rs.uniform()
        if str(rs.choice(MPEG["codec"], p=MPEG["codec_prob"])) == codec:
            return seed
    raise AssertionError(codec)


@pytest.mark.parametrize("codec", ["libx264", "h264", "mpeg4"])
def test_cv2_round_trip_is_the_jax_one(fresh_caches, codec):
    if not _cv2_writes():
        pytest.skip("cv2.VideoWriter opens no fourcc on this machine")
    seed = _seed_drawing(codec)
    frames = _clip(seed)
    j, p = jdeg.RandomVideoCompression(MPEG), pdeg.RandomVideoCompression(MPEG)
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    want = j({"lqs": [f.copy() for f in frames]}, rj)["lqs"]
    got = p({"lqs": [f.copy() for f in frames]}, rp)["lqs"]
    assert p.branch == f"cv2:{jdeg._FOURCC_CACHE[codec]}"
    assert len(got) == len(want) == len(frames)
    for g, w, f in zip(got, want, frames):
        assert g.dtype == np.float32 and g.shape == f.shape
        np.testing.assert_array_equal(g, w)
    assert max(float(np.abs(g - f).max()) for g, f in zip(got, frames)) > 0.1  # the codec ran
    assert rj.randint(2**31) == rp.randint(2**31)  # the same draws were made


def test_cv2_round_trip_keeps_red_red(fresh_caches):
    """A red BGR frame comes back red (the channels reversed around the
    writer), as ``tests/test_data.py`` holds the JAX class to."""
    if not _cv2_writes():
        pytest.skip("cv2.VideoWriter opens no fourcc on this machine")
    red = np.zeros((64, 64, 3), np.float32)
    red[..., 2] = 0.9  # BGR: channel 2 is R
    tr = pdeg.RandomVideoCompression({"codec": ["mpeg4"], "codec_prob": [1.0],
                                      "bitrate": [1e4, 1e5]})
    out = tr({"lqs": [red.copy() for _ in range(4)]}, np.random.RandomState(0))["lqs"]
    assert tr.branch.startswith("cv2:") and len(out) == 4
    assert not np.array_equal(out[0], red)  # lossy
    for f in out:
        assert f.shape == red.shape and f.dtype == np.float32
        assert f[..., 2].mean() > 0.5 and f[..., 0].mean() < 0.3, f.mean(axis=(0, 1))


class _NoVideoWriter:
    def __init__(self, *args, **kwargs):
        pass

    def isOpened(self):
        return False

    def release(self):
        pass


def _jax_without_codec(monkeypatch):
    """The JAX class's no-codec branch: no PyAV, a cv2 whose writer never opens."""
    shim = types.SimpleNamespace(VideoWriter=_NoVideoWriter, VideoWriter_fourcc=lambda *c: 0)
    monkeypatch.setattr(jdeg, "cv2", shim)
    monkeypatch.setattr(jdeg, "_av", None)
    monkeypatch.setattr(jdeg, "_FOURCC_CACHE", {})


def test_prob_gate_leaves_the_clip(monkeypatch):
    params = dict(MPEG, prob=0.0)
    frames = _clip(3)
    for seed in range(3):
        j, p = jdeg.RandomVideoCompression(params), pdeg.RandomVideoCompression(params)
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        want = j({"lqs": [f.copy() for f in frames]}, rj)["lqs"]
        got = p({"lqs": [f.copy() for f in frames]}, rp)["lqs"]
        assert p.branch is None
        for g, w, f in zip(got, want, frames):
            np.testing.assert_array_equal(g, f)
            np.testing.assert_array_equal(w, f)
        assert rj.randint(2**31) == rp.randint(2**31)


def test_identity_without_cv2_or_av(monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "av", None)
    _jax_without_codec(monkeypatch)
    p = pdeg.RandomVideoCompression(MPEG)
    j = jdeg.RandomVideoCompression(MPEG)
    rj, rp = np.random.RandomState(7), np.random.RandomState(7)
    with caplog.at_level(logging.WARNING, logger=pdeg.logger.name):
        for seed in range(3):
            frames = _clip(seed)
            got = p({"lqs": [f.copy() for f in frames]}, rp)["lqs"]
            want = j({"lqs": [f.copy() for f in frames]}, rj)["lqs"]
            for g, w, f in zip(got, want, frames):
                np.testing.assert_array_equal(g, f)
                np.testing.assert_array_equal(w, f)
    assert rj.randint(2**31) == rp.randint(2**31)
    assert p.branch == "identity (neither PyAV nor cv2 imports)"
    warned = [r.getMessage() for r in caplog.records if r.name == pdeg.logger.name]
    assert len(warned) == 1, warned
    assert "neither PyAV nor cv2" in warned[0]
    assert "no video codec on this machine" not in warned[0]


def _fake_av(seen: dict):
    """A PyAV of the calls ``_pyav_roundtrip`` makes: it records what it is
    given, and its decoder returns each encoded frame plus one."""
    av = types.ModuleType("av")

    class VideoFrame:
        def __init__(self, img):
            self.img = img
            self.pict_type = None

        @classmethod
        def from_ndarray(cls, img, format):
            seen.setdefault("formats", []).append(format)
            return cls(img)

        def to_rgb(self):
            return self

        def to_ndarray(self):
            return self.img

    class Stream:
        def encode(self, frame=None):
            if frame is None:
                seen["flushed"] = True
                return []
            seen.setdefault("pict_types", []).append(frame.pict_type)
            return [frame.img]

    class Container:
        def __init__(self, buf, mode, fmt):
            self.buf, self.mode = buf, mode
            seen.setdefault("opened", []).append((mode, fmt))
            self.streams = types.SimpleNamespace(video=[0] if mode == "r" else [])

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def add_stream(self, codec, rate):
            seen["stream"] = (codec, rate)
            self.stream = Stream()
            return self.stream

        def mux(self, packet):
            seen.setdefault("muxed", []).append(packet)

        def decode(self, video):
            seen["decoded_stream"] = video
            return [VideoFrame(np.minimum(p.astype(np.int32) + 1, 255).astype(np.uint8))
                    for p in seen["muxed"]]

    def open_(buf, mode, fmt):
        container = Container(buf, mode, fmt)
        if mode == "w":
            seen["container"] = container
        return container

    av.open = open_
    av.VideoFrame = VideoFrame
    return av


def test_pyav_branch_comes_first(monkeypatch):
    """The PyAV branch with a fake module: taken before cv2, with rate 1,
    yuv420p, the drawn bitrate and the rgb24 label. This is the only check
    the branch gets, since neither this machine nor the card's has PyAV."""
    seen: dict = {}
    monkeypatch.setitem(sys.modules, "av", _fake_av(seen))
    monkeypatch.setattr(pdeg, "_import_cv2", lambda: pytest.fail("cv2 taken before PyAV"))
    libav = logging.getLogger("libav")
    monkeypatch.setattr(libav, "level", libav.level)
    seed = _seed_drawing("h264")
    frames = _clip(seed, frames=3, h=32, w=32)
    p = pdeg.RandomVideoCompression(MPEG)
    got = p({"lqs": [f.copy() for f in frames]}, np.random.RandomState(seed))["lqs"]
    rs = np.random.RandomState(seed)
    rs.uniform()
    codec = str(rs.choice(MPEG["codec"], p=MPEG["codec_prob"]))
    bitrate = int(rs.randint(int(MPEG["bitrate"][0]), int(MPEG["bitrate"][1]) + 1))
    stream = seen["container"].stream
    assert p.branch == "pyav" and codec == "h264"
    assert seen["stream"] == ("h264", 1) and seen["opened"] == [("w", "mp4"), ("r", "mp4")]
    assert (stream.height, stream.width, stream.pix_fmt) == (32, 32, "yuv420p")
    assert stream.bit_rate == bitrate
    assert seen["formats"] == ["rgb24"] * 3 and seen["pict_types"] == ["NONE"] * 3
    assert seen["flushed"] and seen["decoded_stream"] == 0
    assert libav.level == logging.CRITICAL
    for g, f in zip(got, frames):  # the decoder's frames, as given (no channel swap)
        u8 = np.clip(f * 255.0, 0, 255).astype(np.uint8)  # by truncation, as the reference
        want = np.minimum(u8.astype(np.int32) + 1, 255).astype(np.float32) / 255
        np.testing.assert_array_equal(g, want)
