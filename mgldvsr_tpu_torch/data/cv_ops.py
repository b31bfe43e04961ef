"""numpy/scipy counterparts of the OpenCV calls of the training data path.

The JAX package's host data code calls OpenCV, which the card's machine
does not have. Each function here computes what its OpenCV namesake
computes on the inputs that data path gives it (float32 frames in [0, 1],
or uint8 for the JPEG round trip), with OpenCV's argument order and BGR
channel order:

- :func:`filter2D`: correlation with the kernel centred, border
  ``BORDER_REFLECT_101`` (OpenCV's default), ``BORDER_REPLICATE`` or
  ``BORDER_CONSTANT`` (zeros). A
  float64 image under OpenCV's DFT threshold of 50 taps is summed directly,
  tap by tap in the kernel's row-major order, as OpenCV's own loop does: bit
  for bit. Every other call goes through an FFT in float64, rounded to the
  image's type (OpenCV takes a DFT or float32 sums there, so the two agree
  to about 1e-6 on [0, 1], not bit for bit).
- :func:`resize`: nearest, bilinear, bicubic (A = -0.75, replicated
  border), area (fractional box weights when shrinking, OpenCV's area
  coefficients when growing) and Lanczos-4, with OpenCV's pixel centres and
  its same-size copy.
- :func:`cvtColor` with ``COLOR_BGR2GRAY`` or ``COLOR_RGB2GRAY`` on
  float32, bit for bit with OpenCV's own AVX2 kernel. With the channels in
  memory order p0, p1, p2 and their weights c0, c1, c2 (0.114, 0.587, 0.299
  for BGR; 0.299, 0.587, 0.114 for RGB): eight pixels at a time as
  ``fma(p2, c2, fma(p1, c1, p0 * c0))``, the row's remaining pixels as
  ``fma(p2, c2, fma(p0, c0, p1 * c1))``. (Where OpenCV hands the call to
  Intel IPP instead, IPP picks between the same two orders by its own rule,
  so a pixel may differ by one ulp.)
- :func:`GaussianBlur` with OpenCV's sigma-from-size rule for sigma <= 0.
- :func:`jpeg_roundtrip` (and :func:`imencode` / :func:`imdecode` around it):
  what ``cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY, q])`` followed by
  ``cv2.imdecode`` gives with libjpeg-turbo: the IJG tables scaled by
  quality, JFIF YCbCr, 4:2:0 with libjpeg's edge replication and
  alternating-bias box downsampling, the integer "islow" DCT and its
  reciprocal quantisation, the islow inverse DCT and fancy (triangle)
  upsampling. Entropy coding is lossless, so it is skipped: the "encoded
  buffer" holds the quantised coefficients.
- :func:`imread`: a PNG through :mod:`mgldvsr_tpu_torch.io.frames`, in BGR,
  or with ``IMREAD_GRAYSCALE`` one channel: libpng's RGB-to-gray as OpenCV
  asks for it, (9797 R + 19234 G + 3737 B) >> 15, truncated.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import fft as _fft
from scipy import ndimage

from mgldvsr_tpu_torch.io.frames import decode_png, read_frame

# OpenCV's enum values, so a call written for cv2 reads the same here
INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_LANCZOS4 = 0, 1, 2, 3, 4
COLOR_BGR2GRAY, COLOR_RGB2GRAY = 6, 7
BORDER_CONSTANT, BORDER_REPLICATE, BORDER_REFLECT_101 = 0, 1, 4
IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR = -1, 0, 1
IMWRITE_JPEG_QUALITY = 1


# -- filtering ----------------------------------------------------------------


def filter2D(img: np.ndarray, ddepth: int, kernel: np.ndarray,
             borderType: int = BORDER_REFLECT_101) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel, borderType=...)``: correlation of every
    channel with ``kernel`` (odd sizes, anchor at the centre)."""
    if ddepth != -1:
        raise ValueError("only ddepth=-1 (the input's depth) is supported")
    pad_mode = {BORDER_REFLECT_101: "reflect", BORDER_REPLICATE: "edge",
                BORDER_CONSTANT: "constant"}.get(borderType)
    if pad_mode is None:
        raise ValueError(f"borderType {borderType} is not supported (BORDER_REFLECT_101, "
                         f"BORDER_REPLICATE or BORDER_CONSTANT)")
    kernel = np.asarray(kernel, np.float64)
    kh, kw = kernel.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"odd kernel sizes only, got {kernel.shape}")
    x = np.asarray(img, np.float64)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    ph, pw = kh // 2, kw // 2
    xp = np.pad(x, ((ph, ph), (pw, pw), (0, 0)), mode=pad_mode)
    h, w = x.shape[:2]
    if img.dtype == np.float64 and kh * kw < 50:
        # OpenCV's direct loop: one running sum a pixel, taps in row-major order
        out = np.zeros_like(x)
        for i in range(kh):
            for j in range(kw):
                out = out + kernel[i, j] * xp[i:i + h, j:j + w]
    else:
        # correlation = convolution with the flipped kernel, by FFT in float64
        shape = (xp.shape[0] + kh - 1, xp.shape[1] + kw - 1)
        fshape = tuple(_fft.next_fast_len(s, real=True) for s in shape)
        fk = _fft.rfft2(kernel[::-1, ::-1], fshape)
        fx = _fft.rfft2(xp, fshape, axes=(0, 1))
        full = _fft.irfft2(fx * fk[..., None], fshape, axes=(0, 1))
        out = full[kh - 1:kh - 1 + h, kw - 1:kw - 1 + w]
    out = out.astype(img.dtype if img.dtype != np.uint8 else np.float32)
    return out[..., 0] if squeeze else out


_SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}


def getGaussianKernel(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV's float32 Gaussian taps: its fixed tables for sizes up to 7
    with sigma <= 0; otherwise sigma <= 0 becomes
    0.3 * ((ksize - 1) / 2 - 1) + 0.8, each tap rounded to float32, then
    normalised by their sum."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[ksize], np.float32)
    if sigma <= 0:
        sigma = ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    taps = np.exp(-0.5 / (sigma * sigma) * x * x).astype(np.float32)
    return (taps.astype(np.float64) * (1.0 / taps.astype(np.float64).sum())).astype(np.float32)


def GaussianBlur(img: np.ndarray, ksize: Tuple[int, int], sigmaX: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), sigma)``: separable, the same sigma on
    both axes, ``BORDER_REFLECT_101``."""
    kw, kh = ksize
    kx = getGaussianKernel(kw, sigmaX).astype(np.float64)
    ky = getGaussianKernel(kh, sigmaX).astype(np.float64)
    x = np.asarray(img, np.float64)
    x = ndimage.correlate1d(x, kx, axis=1, mode="mirror")
    x = ndimage.correlate1d(x, ky, axis=0, mode="mirror")
    return x.astype(img.dtype)


# -- colour -------------------------------------------------------------------


def _fma(a: np.ndarray, b: np.float32, c: np.ndarray) -> np.ndarray:
    """float32 fused multiply-add: the product is exact in long double, the
    sum rounds once there (64 significant bits) and again to float32."""
    return (a.astype(np.longdouble) * np.longdouble(b) + c.astype(np.longdouble)).astype(np.float32)


def cvtColor(img: np.ndarray, code: int) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` or ``COLOR_RGB2GRAY`` on a
    float32 [H, W, 3] image, bit for bit with OpenCV's own AVX2 kernel (see
    the module docstring)."""
    weights = {COLOR_BGR2GRAY: (0.114, 0.587, 0.299), COLOR_RGB2GRAY: (0.299, 0.587, 0.114)}
    if code not in weights or img.dtype != np.float32 or img.ndim != 3:
        raise ValueError("only COLOR_BGR2GRAY or COLOR_RGB2GRAY of a float32 [H, W, 3] image "
                         "is supported")
    c0, c1, c2 = (np.float32(c) for c in weights[code])
    p0, p1, p2 = img[..., 0], img[..., 1], img[..., 2]
    w = img.shape[1]
    vec = w - w % 8
    out = np.empty(img.shape[:2], np.float32)
    out[:, :vec] = _fma(p2[:, :vec], c2, _fma(p1[:, :vec], c1, p0[:, :vec] * c0))
    out[:, vec:] = _fma(p2[:, vec:], c2, _fma(p0[:, vec:], c0, p1[:, vec:] * c1))
    return out


# -- resize -------------------------------------------------------------------


def _cubic(x: np.ndarray) -> np.ndarray:
    a = np.float32(-0.75)
    x = x.astype(np.float32)
    one = np.float32(1)
    c0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = np.array([[1, 0], [-_S45, -_S45], [0, 1], [_S45, -_S45], [-1, 0], [_S45, _S45],
                        [0, -1], [-_S45, _S45]], np.float64)


def _lanczos4(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    y0 = -(x.astype(np.float64) + 3) * math.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    coeffs = np.empty(x.shape + (8,), np.float32)
    for i in range(8):
        yi = (x + np.float32(3 - i)).astype(np.float32)
        y = -yi.astype(np.float64) * math.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            val = ((_LANCZOS_CS[i, 0] * s0 + _LANCZOS_CS[i, 1] * c0) / (y * y)).astype(np.float32)
        coeffs[..., i] = np.where(np.abs(yi) >= np.float32(1e-6), val, np.float32(1e30))
    total = np.zeros(x.shape, np.float32)
    for i in range(8):
        total = total + coeffs[..., i]
    return coeffs * (np.float32(1) / total)[..., None]


def _axis_taps(ssize: int, dsize: int, interp: int, area_mode: bool):
    """(indices [dsize, k], weights [dsize, k]) of OpenCV's generic resize
    along one axis: indices clamped into [0, ssize) (a replicated border)."""
    inv_scale = dsize / ssize
    scale = 1.0 / inv_scale
    dx = np.arange(dsize, dtype=np.float64)
    if area_mode:
        sx = np.floor(dx * scale).astype(np.int64)
        fx = ((dx + 1) - (sx + 1) * inv_scale).astype(np.float32)
        fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx)).astype(np.float32)
    else:
        fxd = ((dx + 0.5) * scale - 0.5).astype(np.float32)
        sx = np.floor(fxd).astype(np.int64)
        fx = (fxd - sx).astype(np.float32)
    if interp in (INTER_CUBIC, INTER_LANCZOS4):
        ksize = 4 if interp == INTER_CUBIC else 8
        weights = _cubic(fx) if interp == INTER_CUBIC else _lanczos4(fx)
        start = sx - (ksize // 2 - 1)
    else:
        ksize = 2
        low = sx < 0
        high = sx >= ssize - 1
        fx = np.where(low | high, np.float32(0), fx)
        sx = np.where(low, 0, np.where(high, ssize - 1, sx))
        weights = np.stack([np.float32(1) - fx, fx], axis=-1)
        start = sx
    idx = np.clip(start[:, None] + np.arange(ksize)[None, :], 0, ssize - 1)
    return idx, weights.astype(np.float64)


def _area_matrix(ssize: int, dsize: int) -> np.ndarray:
    """OpenCV's ``computeResizeAreaTab`` as a dense [dsize, ssize] matrix of
    float32 weights."""
    scale = ssize / dsize
    m = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            m[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            m[dx, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            m[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return m


def _apply_taps(x: np.ndarray, axis: int, idx: np.ndarray, w: np.ndarray) -> np.ndarray:
    g = np.take(x, idx, axis=axis)  # the tap axis lands right after ``axis``
    shape = [1] * g.ndim
    shape[axis], shape[axis + 1] = w.shape
    return (g * w.reshape(shape)).sum(axis=axis + 1)


def resize(img: np.ndarray, dsize: Tuple[int, int], interpolation: int = INTER_LINEAR
           ) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=...)`` of a float32
    (or float64) [H, W] or [H, W, C] image."""
    dw, dh = int(dsize[0]), int(dsize[1])
    sh, sw = img.shape[:2]
    if (dh, dw) == (sh, sw):
        return img.copy()
    x = np.asarray(img, np.float64)
    if interpolation == INTER_NEAREST:
        ys = np.minimum(np.floor(np.arange(dh) * (sh / dh)).astype(np.int64), sh - 1)
        xs = np.minimum(np.floor(np.arange(dw) * (sw / dw)).astype(np.int64), sw - 1)
        return img[ys][:, xs].copy()
    scale_x, scale_y = sw / dw, sh / dh
    if interpolation == INTER_LINEAR and scale_x == 2 and scale_y == 2:
        interpolation = INTER_AREA
    if interpolation == INTER_AREA and scale_x >= 1 and scale_y >= 1:
        x = np.tensordot(_area_matrix(sw, dw), x, axes=([1], [1]))  # [dw, sh, ...]
        x = np.tensordot(_area_matrix(sh, dh), x, axes=([1], [1]))  # [dh, dw, ...]
        return x.astype(img.dtype)
    if interpolation not in (INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_LANCZOS4):
        raise ValueError(f"interpolation {interpolation} is not supported")
    area = interpolation == INTER_AREA
    x = _apply_taps(x, 1, *_axis_taps(sw, dw, interpolation, area))
    x = _apply_taps(x, 0, *_axis_taps(sh, dh, interpolation, area))
    return x.astype(img.dtype)


# -- JPEG (libjpeg-turbo, baseline, 4:2:0, islow) ----------------------------

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_CHROMA_Q = np.full(64, 99, np.int64)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

_CONST_BITS, _PASS1_BITS = 13, 2
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633,
          f1501=12299, f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg's ``jpeg_set_quality(q, force_baseline=TRUE)``: the IJG
    tables scaled and clamped to [1, 255], natural (row-major) order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_LUMA_Q, _CHROMA_Q))


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d: Sequence[np.ndarray], last: bool):
    """One pass of ``jfdctint.c``'s forward DCT over eight int64 arrays."""
    f = _F
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    n = _CONST_BITS + _PASS1_BITS if last else _CONST_BITS - _PASS1_BITS
    out = [None] * 8
    if last:
        out[0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, _PASS1_BITS)
    else:
        out[0] = (tmp10 + tmp11) << _PASS1_BITS
        out[4] = (tmp10 - tmp11) << _PASS1_BITS
    z1 = (tmp12 + tmp13) * f["f0541"]
    out[2] = _descale(z1 + tmp13 * f["f0765"], n)
    out[6] = _descale(z1 - tmp12 * f["f1847"], n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * f["f1175"]
    tmp4, tmp5 = tmp4 * f["f0298"], tmp5 * f["f2053"]
    tmp6, tmp7 = tmp6 * f["f3072"], tmp7 * f["f1501"]
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3, z4 = z3 * -f["f1961"] + z5, z4 * -f["f0390"] + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return out


def _idct_1d(d: Sequence[np.ndarray], last: bool):
    """One pass of ``jidctint.c``'s inverse DCT over eight int64 arrays (the
    zero-AC shortcuts of the C code give the same numbers)."""
    f = _F
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * f["f0541"]
    tmp2 = z1 - z3 * f["f1847"]
    tmp3 = z1 + z2 * f["f0765"]
    tmp0 = (d[0] + d[4]) << _CONST_BITS
    tmp1 = (d[0] - d[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0, t1 = t0 * f["f0298"], t1 * f["f2053"]
    t2, t3 = t2 * f["f3072"], t3 * f["f1501"]
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3, z4 = z3 * -f["f1961"] + z5, z4 * -f["f0390"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    n = _CONST_BITS + _PASS1_BITS + 3 if last else _CONST_BITS - _PASS1_BITS
    return [_descale(tmp10 + t3, n), _descale(tmp11 + t2, n), _descale(tmp12 + t1, n),
            _descale(tmp13 + t0, n), _descale(tmp13 - t0, n), _descale(tmp12 - t1, n),
            _descale(tmp11 - t2, n), _descale(tmp10 - t3, n)]


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] (multiples of 8) -> [H/8, W/8, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _unblocks(b: np.ndarray) -> np.ndarray:
    nh, nw = b.shape[:2]
    return b.transpose(0, 2, 1, 3).reshape(nh * 8, nw * 8)


def _fdct(blocks: np.ndarray) -> np.ndarray:
    """islow forward DCT of [..., 8, 8] int64 samples less 128 (rows, then
    columns); coefficients scaled by 8, as libjpeg leaves them."""
    rows = _fdct_1d([blocks[..., :, k] for k in range(8)], last=False)
    d = np.stack(rows, axis=-1)
    cols = _fdct_1d([d[..., k, :] for k in range(8)], last=True)
    return np.stack(cols, axis=-2)


def _idct(coef: np.ndarray) -> np.ndarray:
    """islow inverse DCT of dequantised [..., 8, 8] coefficients (columns,
    then rows) -> samples, through libjpeg's range-limit table."""
    cols = _idct_1d([coef[..., k, :] for k in range(8)], last=False)
    ws = np.stack(cols, axis=-2)
    rows = _idct_1d([ws[..., :, k] for k in range(8)], last=True)
    v = np.stack(rows, axis=-1) & 1023
    # post-IDCT range limit: [0, 127] -> +128, [128, 511] -> 255,
    # [512, 895] -> 0, [896, 1023] -> v - 896
    return np.where(v < 128, v + 128, np.where(v < 512, 255, np.where(v < 896, 0, v - 896)))


def _quantize(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's reciprocal quantisation (``compute_reciprocal`` with
    16-bit DCT elements) of islow coefficients by ``qtable << 3``."""
    div = qtable.reshape(8, 8) << 3
    recip = np.empty_like(div)
    corr = np.empty_like(div)
    shift = np.empty_like(div)
    for i, d in np.ndenumerate(div):
        d = int(d)
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    mag = ((np.abs(coef) + corr) * recip) >> shift
    return np.where(coef < 0, -mag, mag)


def _expand(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Replicate the last row and column out to ``rows`` x ``cols``."""
    h, w = plane.shape
    return np.pad(plane, ((0, rows - h), (0, cols - w)), mode="edge")


def _rgb_to_ycc(rgb: np.ndarray):
    """``jccolor.c``: 16-bit fixed-point JFIF YCbCr."""
    def fix(x):
        return int(x * 65536 + 0.5)

    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half - 1) >> 16
    return y, cb, cr


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c``: 16-bit fixed-point tables, clamped to [0, 255]."""
    def fix(x):
        return int(x * 65536 + 0.5)

    half = 1 << 15
    xb, xr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * xr + half) >> 16)
    g = y + ((-fix(0.34414) * xb + half - fix(0.71414) * xr) >> 16)
    b = y + ((fix(1.77200) * xb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255)


def _downsample_h2v2(plane: np.ndarray) -> np.ndarray:
    """``h2v2_downsample``: 2x2 sums plus a bias of 1, 2, 1, 2, ... along
    the row, shifted right by 2."""
    s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] + plane[1::2, 1::2]
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
    return (s + bias[None, :]) >> 2


def _upsample_h2v2_fancy(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """``h2v2_fancy_upsample`` of the first ``rows`` x ``cols`` samples:
    triangle weights 9/16, 3/16, 3/16, 1/16; the edge rows repeated above
    and below, the edge columns weighted 4/4."""
    p = plane[:rows, :cols]
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    out = np.empty((2 * rows, 2 * cols), np.int64)
    for v, near in ((0, above), (1, below)):
        cs = p * 3 + near  # column sums
        left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        even = (cs * 3 + left + 8) >> 4
        odd = (cs * 3 + right + 7) >> 4
        even[:, 0] = (cs[:, 0] * 4 + 8) >> 4
        odd[:, -1] = (cs[:, -1] * 4 + 7) >> 4
        out[v::2, 0::2] = even
        out[v::2, 1::2] = odd
    return out


def jpeg_encode(bgr: np.ndarray, quality: int):
    """The lossy half of ``cv2.imencode('.jpg', bgr, [IMWRITE_JPEG_QUALITY,
    quality])``: (size, quantised Y, Cb, Cr coefficient blocks, tables)."""
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError("jpeg_encode takes a [H, W, 3] uint8 BGR image")
    h, w = bgr.shape[:2]
    qy, qc = quant_tables(quality)
    y, cb, cr = _rgb_to_ycc(bgr[..., ::-1])
    ceil = lambda a, b: -(-a // b)  # noqa: E731
    # luma: replicate to whole blocks
    yp = _expand(y, ceil(h, 8) * 8, ceil(w, 8) * 8)
    # chroma: rows to an even count and columns to whole chroma blocks x2,
    # then the 2x2 downsample, then the last row repeated to whole blocks
    chroma = []
    for c in (cb, cr):
        full = _expand(c, ceil(h, 2) * 2, ceil(w, 16) * 16)
        small = _downsample_h2v2(full)
        chroma.append(_expand(small, ceil(h, 16) * 8, small.shape[1]))
    coefs = [_quantize(_fdct(_blocks(yp) - 128), qy)]
    coefs += [_quantize(_fdct(_blocks(c) - 128), qc) for c in chroma]
    return (h, w), coefs, (qy, qc)


def jpeg_decode(encoded) -> np.ndarray:
    """``cv2.imdecode`` of :func:`jpeg_encode`'s result: [H, W, 3] uint8 BGR."""
    (h, w), coefs, (qy, qc) = encoded
    y = _unblocks(_idct(coefs[0] * qy.reshape(8, 8)))[:h, :w]
    ch, cw = -(-h // 2), -(-w // 2)
    chroma = [_upsample_h2v2_fancy(_unblocks(_idct(c * qc.reshape(8, 8))), ch, cw)[:h, :w]
              for c in coefs[1:]]
    rgb = _ycc_to_rgb(y, *chroma)
    return np.ascontiguousarray(rgb[..., ::-1]).astype(np.uint8)


def jpeg_roundtrip(bgr: np.ndarray, quality: int) -> np.ndarray:
    """``cv2.imdecode(cv2.imencode('.jpg', bgr, [IMWRITE_JPEG_QUALITY, q])[1])``."""
    return jpeg_decode(jpeg_encode(bgr, quality))


class _Encoded:
    """What :func:`imencode` returns in place of the JPEG bytes."""

    def __init__(self, payload):
        self.payload = payload


def imencode(ext: str, img: np.ndarray, params: Optional[Sequence[int]] = None):
    """``cv2.imencode`` for ``.jpg``: (True, an opaque buffer) that
    :func:`imdecode` reads back. The quality defaults to OpenCV's 95."""
    if ext.lower() not in (".jpg", ".jpeg"):
        raise ValueError(f"only .jpg is supported, got {ext}")
    opts = dict(zip(params[0::2], params[1::2])) if params else {}
    return True, _Encoded(jpeg_encode(img, int(opts.get(IMWRITE_JPEG_QUALITY, 95))))


def imdecode(buf, flags: int = IMREAD_COLOR) -> np.ndarray:
    """``cv2.imdecode`` of an :func:`imencode` buffer (BGR), or of PNG bytes."""
    if isinstance(buf, _Encoded):
        return jpeg_decode(buf.payload)
    rgb = decode_png(bytes(np.asarray(buf, np.uint8)))
    return np.ascontiguousarray(rgb[..., ::-1])


def imread(path: str, flags: int = IMREAD_COLOR) -> Optional[np.ndarray]:
    """``cv2.imread(path, IMREAD_COLOR)``: [H, W, 3] uint8 BGR, or with
    ``IMREAD_GRAYSCALE`` [H, W] uint8; None when the file is missing."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise ValueError(f"only IMREAD_COLOR or IMREAD_GRAYSCALE is supported, got {flags}")
    try:
        rgb = read_frame(path)
    except FileNotFoundError:
        return None
    if flags == IMREAD_GRAYSCALE:
        # a gray file comes back as R = G = B, which this leaves as it is
        r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
        return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)
    return np.ascontiguousarray(rgb[..., ::-1])
