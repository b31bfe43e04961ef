"""RealBasicVSR-style on-the-fly degradation transforms (host data path).

Counterpart of ``mgldvsr_tpu/data/degradations.py`` with every OpenCV call
replaced by its counterpart in :mod:`mgldvsr_tpu_torch.data.cv_ops`: per-clip
random degradation parameters random-walked across frames (``*_step``), two
stages of blur -> resize -> noise -> JPEG -> video compression, a final
resize + sinc, USM sharpening of the GT, and the clip. Every transform makes
the same ``RandomState`` draws in the same order as the JAX package's, so a
(seed, clip) gives the same sample wherever the primitives agree.

Video compression is the one transform that needs a codec. It takes the JAX
package's three branches in its order: PyAV where ``av`` imports, else
OpenCV's ``VideoWriter`` where ``cv2`` imports and opens a fourcc, else the
clip unchanged with a one-time warning that says why. Both are imported
inside the call, never at module import, and used nowhere else in the data
path.

Clips are lists of float32 HWC arrays in [0, 1], in BGR channel order (the
datasets flip to RGB at their return, where the reference does).
"""
from __future__ import annotations

import io
import logging
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mgldvsr_tpu_torch.data import cv_ops
from mgldvsr_tpu_torch.data.blur_kernels import make_kernel

logger = logging.getLogger(__name__)


def _walk(rng: np.random.RandomState, value: float, step: float, lo: float,
          hi: float) -> float:
    """Random-walk a parameter within [lo, hi] (temporal correlation)."""
    if step == 0:
        return value
    return float(np.clip(value + rng.uniform(-step, step), lo, hi))


class RandomBlur:
    """Per-frame blur with a randomly chosen kernel family whose parameters
    random-walk across frames."""

    def __init__(self, params: Dict, keys: Sequence[str] = ("lqs",)):
        self.params = params
        self.keys = keys

    def get_kernels(self, rng: np.random.RandomState, num_frames: int
                    ) -> List[np.ndarray]:
        p = self.params
        kernel_type = rng.choice(p["kernel_list"], p=p.get("kernel_prob"))
        kernel_size = int(rng.choice(p["kernel_size"]))
        sx_lo, sx_hi = p.get("sigma_x", [0.2, 3])
        sy_lo, sy_hi = p.get("sigma_y", [0.2, 3])
        ra_lo, ra_hi = p.get("rotate_angle", [-np.pi, np.pi])
        bg_lo, bg_hi = p.get("beta_gaussian", [0.5, 4])
        bp_lo, bp_hi = p.get("beta_plateau", [1, 2])
        om_lo, om_hi = p.get("omega", [np.pi / 3, np.pi])
        if kernel_size < 13:
            om_lo = max(om_lo, np.pi / 3)

        sigma_x = rng.uniform(sx_lo, sx_hi)
        sigma_y = rng.uniform(sy_lo, sy_hi)
        rotate = rng.uniform(ra_lo, ra_hi)
        beta_g = rng.uniform(bg_lo, bg_hi)
        beta_p = rng.uniform(bp_lo, bp_hi)
        omega = rng.uniform(om_lo, om_hi)

        kernels = []
        for i in range(num_frames):
            if i > 0:
                sigma_x = _walk(rng, sigma_x, p.get("sigma_x_step", 0), sx_lo, sx_hi)
                sigma_y = _walk(rng, sigma_y, p.get("sigma_y_step", 0), sy_lo, sy_hi)
                rotate = _walk(rng, rotate, p.get("rotate_angle_step", 0), ra_lo, ra_hi)
                beta_g = _walk(rng, beta_g, p.get("beta_gaussian_step", 0), bg_lo, bg_hi)
                beta_p = _walk(rng, beta_p, p.get("beta_plateau_step", 0), bp_lo, bp_hi)
                omega = _walk(rng, omega, p.get("omega_step", 0), om_lo, om_hi)
            kernels.append(
                make_kernel(kernel_type, kernel_size, sigma_x, sigma_y,
                            rotate, beta_g, beta_p, omega)
            )
        return kernels

    def __call__(self, results: Dict, rng: np.random.RandomState) -> Dict:
        if np.random.RandomState(rng.randint(2**31)).uniform() > self.params.get("prob", 1.0):
            return results
        for key in self.keys:
            frames = results[key]
            kernels = self.get_kernels(rng, len(frames))
            results[key] = [cv_ops.filter2D(f, -1, k) for f, k in zip(frames, kernels)]
        return results


class RandomResize:
    """Random up/down/keep rescale with per-frame scale stepping."""

    _INTERP = {
        "bilinear": cv_ops.INTER_LINEAR,
        "bicubic": cv_ops.INTER_CUBIC,
        "area": cv_ops.INTER_AREA,
        "nearest": cv_ops.INTER_NEAREST,
        "lanczos": cv_ops.INTER_LANCZOS4,
    }

    def __init__(self, params: Dict, keys: Sequence[str] = ("lqs",)):
        self.params = params
        self.keys = keys

    def __call__(self, results: Dict, rng: np.random.RandomState) -> Dict:
        p = self.params
        interp = self._INTERP[rng.choice(p["resize_opt"], p=p.get("resize_prob"))]
        if "target_size" in p:
            target = tuple(p["target_size"])
            for key in self.keys:
                results[key] = [cv_ops.resize(f, (target[1], target[0]), interpolation=interp)
                                for f in results[key]]
            return results

        mode = rng.choice(["up", "down", "keep"], p=p["resize_mode_prob"])
        lo, hi = p["resize_scale"]
        if mode == "up":
            scale = rng.uniform(1, hi)
        elif mode == "down":
            scale = rng.uniform(lo, 1)
        else:
            scale = 1.0
        step = p.get("resize_step", 0)
        for key in self.keys:
            frames = results[key]
            h, w = frames[0].shape[:2]
            out = []
            s = scale
            for i, f in enumerate(frames):
                if i > 0:
                    s = _walk(rng, s, step, lo, hi)
                th, tw = int(h * s), int(w * s)
                if p.get("is_size_even"):
                    th, tw = th - th % 2, tw - tw % 2
                th, tw = max(th, 1), max(tw, 1)
                out.append(cv_ops.resize(f, (tw, th), interpolation=interp))
            results[key] = out
        return results


class RandomNoise:
    """Gaussian or Poisson noise, optionally gray (channel-shared), with
    per-frame sigma/scale stepping."""

    def __init__(self, params: Dict, keys: Sequence[str] = ("lqs",)):
        self.params = params
        self.keys = keys

    def _gaussian(self, frames, rng):
        p = self.params
        lo, hi = p["gaussian_sigma"]
        sigma = rng.uniform(lo / 255.0, hi / 255.0)
        gray = rng.uniform() < p.get("gaussian_gray_noise_prob", 0)
        step = p.get("gaussian_sigma_step", 0) / 255.0
        out = []
        for i, f in enumerate(frames):
            if i > 0:
                sigma = _walk(rng, sigma, step, lo / 255.0, hi / 255.0)
            if gray:
                n = rng.randn(*f.shape[:2], 1).astype(np.float32) * sigma
            else:
                n = rng.randn(*f.shape).astype(np.float32) * sigma
            out.append(f + n)
        return out

    def _poisson(self, frames, rng):
        p = self.params
        lo, hi = p["poisson_scale"]
        scale = rng.uniform(lo, hi)
        gray = rng.uniform() < p.get("poisson_gray_noise_prob", 0)
        step = p.get("poisson_scale_step", 0)
        out = []
        for i, f in enumerate(frames):
            if i > 0:
                scale = _walk(rng, scale, step, lo, hi)
            img = np.clip(f, 0, 1)
            if gray:
                # the gray image's distinct values set the Poisson rate: it
                # must be OpenCV's to the bit (cv_ops.cvtColor)
                g = cv_ops.cvtColor(img.astype(np.float32), cv_ops.COLOR_BGR2GRAY)[..., None]
                vals = len(np.unique(g))
                vals = 2 ** np.ceil(np.log2(vals))
                noise = rng.poisson(g * vals) / float(vals) - g
            else:
                vals = len(np.unique(img))
                vals = 2 ** np.ceil(np.log2(max(vals, 2)))
                noise = rng.poisson(img * vals) / float(vals) - img
            out.append(f + noise.astype(np.float32) * scale)
        return out

    def __call__(self, results: Dict, rng: np.random.RandomState) -> Dict:
        noise_type = rng.choice(self.params["noise_type"], p=self.params.get("noise_prob"))
        for key in self.keys:
            if noise_type == "gaussian":
                results[key] = self._gaussian(results[key], rng)
            else:
                results[key] = self._poisson(results[key], rng)
        return results


class RandomJPEGCompression:
    """JPEG round trip (libjpeg-turbo's, in :mod:`cv_ops`) with the quality
    random-walked across frames."""

    def __init__(self, params: Dict, keys: Sequence[str] = ("lqs",)):
        self.params = params
        self.keys = keys

    def __call__(self, results: Dict, rng: np.random.RandomState) -> Dict:
        lo, hi = self.params["quality"]
        q = rng.uniform(lo, hi)
        step = self.params.get("quality_step", 0)
        for key in self.keys:
            out = []
            for i, f in enumerate(results[key]):
                if i > 0:
                    q = _walk(rng, q, step, lo, hi)
                img = np.clip(f * 255.0, 0, 255).astype(np.uint8)
                out.append(cv_ops.jpeg_roundtrip(img, int(q)).astype(np.float32) / 255.0)
            results[key] = out
        return results


# fourcc candidates for each codec name of the recipe, for cv2's writer
_CV2_FOURCC = {
    "libx264": ("avc1", "h264", "X264", "mp4v"),
    "h264": ("avc1", "h264", "X264", "mp4v"),
    "mpeg4": ("mp4v",),
    "mp4v": ("mp4v",),
}
# codec name -> the first fourcc that opened in this process (None: none did)
_FOURCC_CACHE: Dict[str, Optional[str]] = {}


def _import_av():
    """PyAV, or None where it does not import; libav's own log silenced."""
    try:
        import av
    except ImportError:
        return None
    logging.getLogger("libav").setLevel(logging.CRITICAL)
    return av


def _import_cv2():
    """OpenCV, or None where it does not import."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _temp_mp4() -> str:
    """A fresh empty .mp4 path of this process's own (``mkstemp``), so that
    the dataset's worker processes never write to one path."""
    fd, path = tempfile.mkstemp(suffix=".mp4")
    os.close(fd)
    return path


def _probe_fourcc(cv2, codec: str) -> Optional[str]:
    """The first of ``codec``'s fourccs that ``cv2.VideoWriter`` opens."""
    if codec in _FOURCC_CACHE:
        return _FOURCC_CACHE[codec]
    found = None
    for fourcc in _CV2_FOURCC.get(codec, ("mp4v",)):
        path = _temp_mp4()
        try:
            writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 25, (32, 32))
            ok = writer.isOpened()
            writer.release()
        except cv2.error:
            ok = False
        finally:
            os.remove(path)
        if ok:
            found = fourcc
            break
    _FOURCC_CACHE[codec] = found
    return found


def _pyav_roundtrip(av, u8_frames: List[np.ndarray], codec: str,
                    bitrate: int) -> Optional[List[np.ndarray]]:
    """The reference's in-memory mp4: ``codec`` at ``bitrate``, yuv420p,
    frames labelled rgb24."""
    buf = io.BytesIO()
    with av.open(buf, "w", "mp4") as container:
        stream = container.add_stream(codec, rate=1)
        stream.height = u8_frames[0].shape[0]
        stream.width = u8_frames[0].shape[1]
        stream.pix_fmt = "yuv420p"
        stream.bit_rate = bitrate
        for img in u8_frames:
            frame = av.VideoFrame.from_ndarray(img, format="rgb24")
            frame.pict_type = "NONE"
            for packet in stream.encode(frame):
                container.mux(packet)
        for packet in stream.encode():
            container.mux(packet)
    out = []
    with av.open(buf, "r", "mp4") as container:
        if container.streams.video:
            for frame in container.decode(**{"video": 0}):
                out.append(frame.to_rgb().to_ndarray())
    return out or None


def _cv2_roundtrip(cv2, u8_frames: List[np.ndarray],
                   fourcc: str) -> Optional[List[np.ndarray]]:
    """Write the frames at 25 fps with ``fourcc`` and read them back; None
    where fewer come back. cv2 maps input channel 0 to the encoder's B and
    the reference's rgb24 label maps it to R, so the channels are reversed
    before the write and after the read."""
    h, w = u8_frames[0].shape[:2]
    path = _temp_mp4()
    try:
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
        for img in u8_frames:
            writer.write(np.ascontiguousarray(img[:, :, ::-1]))
        writer.release()
        cap = cv2.VideoCapture(path)
        out = []
        for _ in u8_frames:
            ok, img = cap.read()
            if not ok:
                break
            out.append(np.ascontiguousarray(img[:, :, ::-1]))
        cap.release()
    finally:
        os.remove(path)
    return out if len(out) == len(u8_frames) else None


class RandomVideoCompression:
    """Lossy video-codec round trip of the clip (the reference's
    random_degradations.py:455-525), as the JAX package's class does it.

    The codec is drawn from ``params['codec']`` / ``params['codec_prob']``
    and the bitrate from U{bitrate[0]..bitrate[1]}; then the first branch
    that the machine has runs:

    - PyAV: the reference's in-memory mp4 (codec, bitrate, yuv420p, rate 1,
      a flush), frames labelled rgb24. The clips are BGR here, as the
      reference's are at this point, so the label runs the YUV matrix with
      R and B swapped, as the reference does.
    - cv2: ``VideoWriter`` with the first of the codec's fourccs that opens
      (``_CV2_FOURCC``), 25 fps, the channels reversed around the round trip
      to keep that R/B-swapped mapping. cv2 has no bitrate control: the
      bitrate is drawn but unused.
    - neither, or a branch that gives fewer frames back: the clip unchanged,
      with a one-time warning that says why.

    ``branch`` names what the last clip took: ``"pyav"``, ``"cv2:<fourcc>"``
    or ``"identity (<why>)"``.
    """

    def __init__(self, params: Dict, keys: Sequence[str] = ("lqs",)):
        self.params = params
        self.keys = keys
        self.branch: Optional[str] = None
        self._warned = False

    @staticmethod
    def _roundtrip(u8_frames: List[np.ndarray], codec: str,
                   bitrate: int) -> Tuple[Optional[List[np.ndarray]], str]:
        av = _import_av()
        if av is not None:
            out = _pyav_roundtrip(av, u8_frames, codec, bitrate)
            return out, "pyav" if out is not None else f"identity (PyAV decoded no {codec} frames)"
        cv2 = _import_cv2()
        if cv2 is None:
            return None, "identity (neither PyAV nor cv2 imports)"
        fourcc = _probe_fourcc(cv2, codec)
        if fourcc is None:
            return None, f"identity (no PyAV; cv2.VideoWriter opens no fourcc for {codec})"
        out = _cv2_roundtrip(cv2, u8_frames, fourcc)
        if out is None:
            return None, f"identity (no PyAV; cv2's {fourcc} round trip gave back too few frames)"
        return out, f"cv2:{fourcc}"

    def __call__(self, results: Dict, rng: np.random.RandomState) -> Dict:
        if rng.uniform() > self.params.get("prob", 1):
            return results
        for key in self.keys:
            codec = str(rng.choice(self.params["codec"], p=self.params.get("codec_prob")))
            lo, hi = self.params["bitrate"]
            bitrate = int(rng.randint(int(lo), int(hi) + 1))
            u8 = [np.clip(np.asarray(f, np.float32) * 255.0, 0, 255).astype(np.uint8)
                  for f in results[key]]
            out, self.branch = self._roundtrip(u8, codec, bitrate)
            if out is None:
                if not self._warned:
                    self._warned = True
                    logger.warning("RandomVideoCompression returns the clip unchanged: %s",
                                   self.branch)
                continue
            results[key] = [o.astype(np.float32) / 255.0 for o in out]
        return results


class UnsharpMasking:
    """USM sharpening with a thresholded mask (aug_pix.py:536; applied to
    the GT clip)."""

    def __init__(self, kernel_size: int = 51, sigma: float = 0,
                 weight: float = 0.5, threshold: float = 10,
                 keys: Sequence[str] = ("gts",)):
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.weight = weight
        self.threshold = threshold
        self.keys = keys

    def _sharpen(self, img: np.ndarray) -> np.ndarray:
        k = (self.kernel_size, self.kernel_size)
        blur = cv_ops.GaussianBlur(img, k, self.sigma)
        residual = img - blur
        mask = (np.abs(residual) * 255.0 > self.threshold).astype(np.float32)
        soft_mask = cv_ops.GaussianBlur(mask, k, self.sigma)
        sharp = np.clip(img + self.weight * residual, 0, 1)
        return soft_mask * sharp + (1 - soft_mask) * img

    def __call__(self, results: Dict, rng=None) -> Dict:
        for key in self.keys:
            results[key] = [self._sharpen(f) for f in results[key]]
        return results


class Clip:
    def __init__(self, keys: Sequence[str] = ("lqs",), lo=0.0, hi=1.0):
        self.keys = keys
        self.lo, self.hi = lo, hi

    def __call__(self, results: Dict, rng=None) -> Dict:
        for key in self.keys:
            results[key] = [np.clip(f, self.lo, self.hi) for f in results[key]]
        return results


class DegradationStage:
    """One blur -> resize -> noise -> jpeg -> video-compression stage, with
    an optional final resize + sinc blur (stage 2)."""

    def __init__(self, cfg: Dict):
        self.transforms = []
        order = (
            ("random_blur", RandomBlur),
            ("random_resize", RandomResize),
            ("random_noise", RandomNoise),
            ("random_jpeg", RandomJPEGCompression),
            ("random_mpeg", RandomVideoCompression),
            ("resize_final", RandomResize),
            ("blur_final", RandomBlur),
        )
        for name, cls in order:
            if name in cfg:
                entry = cfg[name]
                self.transforms.append(cls(entry["params"], entry.get("keys", ("lqs",))))

    def __call__(self, results: Dict, rng: np.random.RandomState) -> Dict:
        for t in self.transforms:
            results = t(results, rng)
        return results


_DEGRADATION_TYPES = {
    "RandomBlur": RandomBlur,
    "RandomResize": RandomResize,
    "RandomNoise": RandomNoise,
    "RandomJPEGCompression": RandomJPEGCompression,
    "RandomVideoCompression": RandomVideoCompression,
}


class DegradationsWithShuffle:
    """Degradations applied in a partly shuffled order (BasicSR's
    DegradationsWithShuffle).

    ``degradations`` is a list of ``{"type": name, "params": {...}}`` dicts,
    where an entry may itself be a list: a group that keeps its inner order.
    Each call permutes the entries at ``shuffle_idx`` (default: all) with one
    ``rng.shuffle``, the JAX package's draw."""

    def __init__(self, degradations, keys: Sequence[str] = ("lqs",), shuffle_idx=None):
        self.keys = tuple(keys)
        self.degradations = self._build(list(degradations))
        if shuffle_idx is None:
            self.shuffle_idx = list(range(len(self.degradations)))
        else:
            self.shuffle_idx = list(shuffle_idx)

    def _build(self, degradations):
        built = []
        for d in degradations:
            if isinstance(d, (list, tuple)):
                built.append(self._build(list(d)))
            else:
                built.append(_DEGRADATION_TYPES[d["type"]](d["params"], self.keys))
        return built

    def __call__(self, results: Dict, rng: np.random.RandomState) -> Dict:
        order = list(self.degradations)
        if self.shuffle_idx:
            picked = [order[i] for i in self.shuffle_idx]
            rng.shuffle(picked)
            for i, idx in enumerate(self.shuffle_idx):
                order[idx] = picked[i]
        for d in order:
            for sub in (d if isinstance(d, list) else [d]):
                results = sub(results, rng)
        return results
