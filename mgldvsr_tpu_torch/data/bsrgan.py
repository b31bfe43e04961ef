"""BSRGAN's practical degradation model (host data augmentation).

Counterpart of ``mgldvsr_tpu/data/bsrgan.py`` (the reference's
``ldm/modules/image_degradation/{bsrgan,bsrgan_light}.py``): the shuffled
degradation chain (two blurs, a two-stage downsample, Gaussian, speckle and
Poisson noise, JPEG, a final JPEG, the paired crop) and its kernel and
noise atoms. Host numpy and scipy, as in the JAX package; every OpenCV call
is its counterpart in :mod:`mgldvsr_tpu_torch.data.cv_ops` (``resize``, the
libjpeg-turbo round trip ``jpeg_roundtrip``, RGB <-> BGR as a flip of the
channel axis), and ``cv2.resize(fx=0.5, fy=0.5)`` is the resize to half the
size, which is the same map on the even sizes the mod-crop leaves. All
randomness comes from an explicit ``np.random.Generator``, drawn in the
JAX package's order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage
from scipy.linalg import orth

from mgldvsr_tpu_torch.data import cv_ops

# the interpolations the reference samples from: linear, cubic, area
_CV2_INTERP = (cv_ops.INTER_LINEAR, cv_ops.INTER_CUBIC, cv_ops.INTER_AREA)


def anisotropic_gaussian_kernel(ksize: int, theta: float, l1: float,
                                l2: float) -> np.ndarray:
    """Rotated anisotropic Gaussian (bsrgan.py:65-96)."""
    v = np.dot(np.array([[np.cos(theta), -np.sin(theta)],
                         [np.sin(theta), np.cos(theta)]]), np.array([1.0, 0.0]))
    V = np.array([[v[0], v[1]], [v[1], -v[0]]])
    D = np.array([[l1, 0], [0, l2]])
    cov = np.dot(np.dot(V, D), np.linalg.inv(V))
    center = ksize / 2.0 + 0.5
    xx, yy = np.meshgrid(np.arange(1, ksize + 1), np.arange(1, ksize + 1))
    pts = np.stack([xx - center, yy - center], -1)
    inv = np.linalg.inv(cov)
    expo = np.einsum("...i,ij,...j->...", pts, inv, pts)
    k = np.exp(-0.5 * expo)
    return k / k.sum()


def fspecial_gaussian(hsize: int, sigma: float) -> np.ndarray:
    """MATLAB fspecial('gaussian') (bsrgan.py:187-198)."""
    hsize = [hsize, hsize]
    siz = [(hsize[0] - 1.0) / 2.0, (hsize[1] - 1.0) / 2.0]
    std = sigma
    x, y = np.meshgrid(np.arange(-siz[1], siz[1] + 1),
                       np.arange(-siz[0], siz[0] + 1))
    arg = -(x * x + y * y) / (2 * std * std)
    h = np.exp(arg)
    h[h < np.finfo(float).eps * h.max()] = 0
    sumh = h.sum()
    if sumh != 0:
        h = h / sumh
    return h


def shift_pixel(x: np.ndarray, sf: int, upper_left: bool = True) -> np.ndarray:
    """Shift by (sf-1)*0.5 px toward a corner via linear interpolation
    (bsrgan.py:99-125) — aligns the blur kernel with nearest downsampling."""
    h, w = x.shape[:2]
    shift = (sf - 1) * 0.5
    xv, yv = np.arange(0, w, 1.0), np.arange(0, h, 1.0)
    if upper_left:
        x1 = xv + shift
        y1 = yv + shift
    else:
        x1 = xv - shift
        y1 = yv - shift
    x1 = np.clip(x1, 0, w - 1)
    y1 = np.clip(y1, 0, h - 1)
    # bilinear grid interpolation (scipy removed interp2d; kx=ky=1
    # RectBivariateSpline is its exact linear-kind replacement)
    from scipy.interpolate import RectBivariateSpline
    if x.ndim == 2:
        x = RectBivariateSpline(yv, xv, x, kx=1, ky=1)(y1, x1)
    else:
        for i in range(x.shape[-1]):
            x[:, :, i] = RectBivariateSpline(
                yv, xv, x[:, :, i], kx=1, ky=1)(y1, x1)
    return x


def blur(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Mirror-padded 2-D convolution per channel (bsrgan.py:128-142)."""
    return ndimage.convolve(img, np.expand_dims(k, axis=2), mode="mirror")


def add_blur(img: np.ndarray, rng: np.random.Generator,
             sf: int = 4) -> np.ndarray:
    """Random iso/aniso Gaussian blur (bsrgan.py:325-336)."""
    wd2 = 4.0 + sf
    wd = 2.0 + 0.2 * sf
    ksize = 2 * int(rng.integers(2, 12)) + 3
    if rng.random() < 0.5:
        k = anisotropic_gaussian_kernel(
            ksize, rng.random() * np.pi, wd2 * rng.random(),
            wd2 * rng.random())
    else:
        k = fspecial_gaussian(ksize, wd * rng.random())
    return blur(img, k)


def add_resize(img: np.ndarray, rng: np.random.Generator,
               sf: int = 4) -> np.ndarray:
    """Random up/down/identity resize (bsrgan.py:339-351)."""
    rnum = rng.random()
    if rnum > 0.8:
        sf1 = rng.uniform(1, 2)
    elif rnum < 0.7:
        sf1 = rng.uniform(0.5 / sf, 1)
    else:
        sf1 = 1.0
    img = cv_ops.resize(img, (int(sf1 * img.shape[1]), int(sf1 * img.shape[0])),
                        interpolation=_CV2_INTERP[rng.integers(3)])
    return np.clip(img, 0.0, 1.0)


def add_gaussian_noise(img: np.ndarray, rng: np.random.Generator,
                       noise_level1: int = 2,
                       noise_level2: int = 25) -> np.ndarray:
    """Color / grayscale / correlated-multivariate Gaussian noise
    (bsrgan.py:369-383)."""
    noise_level = int(rng.integers(noise_level1, noise_level2 + 1))
    rnum = rng.random()
    if rnum > 0.6:
        img = img + rng.normal(0, noise_level / 255.0,
                               img.shape).astype(np.float32)
    elif rnum < 0.4:
        img = img + rng.normal(0, noise_level / 255.0,
                               (*img.shape[:2], 1)).astype(np.float32)
    else:
        L = noise_level2 / 255.0
        D = np.diag(rng.random(3))
        U = orth(rng.random((3, 3)))
        conv = np.dot(np.dot(np.transpose(U), D), U)
        img = img + rng.multivariate_normal(
            [0, 0, 0], np.abs(L ** 2 * conv), img.shape[:2]).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def add_speckle_noise(img: np.ndarray, rng: np.random.Generator,
                      noise_level1: int = 2,
                      noise_level2: int = 25) -> np.ndarray:
    """Multiplicative (signal-proportional) noise (bsrgan.py:386-401)."""
    noise_level = int(rng.integers(noise_level1, noise_level2 + 1))
    img = np.clip(img, 0.0, 1.0)
    rnum = rng.random()
    if rnum > 0.6:
        img = img + img * rng.normal(0, noise_level / 255.0,
                                     img.shape).astype(np.float32)
    elif rnum < 0.4:
        img = img + img * rng.normal(0, noise_level / 255.0,
                                     (*img.shape[:2], 1)).astype(np.float32)
    else:
        L = noise_level2 / 255.0
        D = np.diag(rng.random(3))
        U = orth(rng.random((3, 3)))
        conv = np.dot(np.dot(np.transpose(U), D), U)
        img = img + img * rng.multivariate_normal(
            [0, 0, 0], np.abs(L ** 2 * conv), img.shape[:2]).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def add_poisson_noise(img: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
    """Shot noise at a random exposure, full-color or luma-only
    (bsrgan.py:404-415)."""
    img = np.clip((img * 255.0).round(), 0, 255) / 255.0
    vals = 10 ** (2 * rng.random() + 2.0)
    if rng.random() < 0.5:
        img = rng.poisson(img * vals).astype(np.float32) / vals
    else:
        img_gray = np.dot(img[..., :3], [0.299, 0.587, 0.114])
        img_gray = np.clip((img_gray * 255.0).round(), 0, 255) / 255.0
        noise_gray = (rng.poisson(img_gray * vals).astype(np.float32) / vals
                      - img_gray)
        img = img + noise_gray[:, :, np.newaxis]
    return np.clip(img, 0.0, 1.0)


def add_jpeg_noise(img: np.ndarray, rng: np.random.Generator,
                   q_lo: int = 30, q_hi: int = 95) -> np.ndarray:
    """Round-trip through JPEG at a random quality (bsrgan.py:418-424)."""
    quality = int(rng.integers(q_lo, q_hi + 1))
    rgb = (img.clip(0, 1) * 255.0).round().astype(np.uint8)
    dec = cv_ops.jpeg_roundtrip(np.ascontiguousarray(rgb[..., ::-1]), quality)
    return dec[..., ::-1].astype(np.float32) / 255.0


def random_paired_crop(lq: np.ndarray, hq: np.ndarray,
                       rng: np.random.Generator, sf: int = 4,
                       lq_patchsize: int = 64
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Aligned LQ/HQ crop (bsrgan.py:427-435)."""
    h, w = lq.shape[:2]
    rnd_h = int(rng.integers(0, h - lq_patchsize + 1))
    rnd_w = int(rng.integers(0, w - lq_patchsize + 1))
    lq = lq[rnd_h:rnd_h + lq_patchsize, rnd_w:rnd_w + lq_patchsize, :]
    rh, rw = int(rnd_h * sf), int(rnd_w * sf)
    hq = hq[rh:rh + lq_patchsize * sf, rw:rw + lq_patchsize * sf, :]
    return lq, hq


def degradation_bsrgan(
    img: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    sf: int = 4,
    lq_patchsize: int = 72,
) -> Tuple[np.ndarray, np.ndarray]:
    """The full shuffled BSRGAN chain (bsrgan.py:438-527): HWC [0,1] HQ
    image -> (lq_patch [p,p,C], hq_patch [p*sf,p*sf,C]).

    Order: optional pre-halving (sf=4 only, p=0.25), then ops {blur, blur,
    downsample2, downsample3, gaussian noise, jpeg(p=0.9), (isp slot)} in a
    random order with downsample3 forced after downsample2, then a final
    JPEG and an aligned random crop."""
    rng = rng or np.random.default_rng()
    jpeg_prob, scale2_prob = 0.9, 0.25
    sf_ori = sf

    h1, w1 = img.shape[:2]
    # the reference mod-crops with swapped h/w limits (bsrgan.py:455) —
    # harmless on the square training crops it feeds; use the correct axes
    img = img.copy()[: h1 - h1 % sf, : w1 - w1 % sf, ...]
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f"img size ({h1}x{w1}) is too small")

    hq = img.copy()

    if sf == 4 and rng.random() < scale2_prob:
        if rng.random() < 0.5:
            img = cv_ops.resize(
                img, (int(img.shape[1] / 2), int(img.shape[0] / 2)),
                interpolation=_CV2_INTERP[rng.integers(3)])
        else:
            img = cv_ops.resize(img, (img.shape[1] // 2, img.shape[0] // 2),
                                interpolation=cv_ops.INTER_CUBIC)
        img = np.clip(img, 0.0, 1.0)
        sf = 2

    shuffle_order = list(rng.permutation(7))
    idx1, idx2 = shuffle_order.index(2), shuffle_order.index(3)
    if idx1 > idx2:  # keep downsample3 after downsample2
        shuffle_order[idx1], shuffle_order[idx2] = (
            shuffle_order[idx2], shuffle_order[idx1])

    a = b = None
    for i in shuffle_order:
        if i in (0, 1):
            img = add_blur(img, rng, sf=sf)
        elif i == 2:
            a, b = img.shape[1], img.shape[0]
            if rng.random() < 0.75:
                sf1 = rng.uniform(1, 2 * sf)
                img = cv_ops.resize(
                    img, (int(img.shape[1] / sf1), int(img.shape[0] / sf1)),
                    interpolation=_CV2_INTERP[rng.integers(3)])
            else:
                k = fspecial_gaussian(25, rng.uniform(0.1, 0.6 * sf))
                k_shifted = shift_pixel(k, sf)
                k_shifted = k_shifted / k_shifted.sum()
                img = blur(img, k_shifted)
                img = img[0::sf, 0::sf, ...]
            img = np.clip(img, 0.0, 1.0)
        elif i == 3:
            img = cv_ops.resize(img, (int(a / sf), int(b / sf)),
                                interpolation=_CV2_INTERP[rng.integers(3)])
            img = np.clip(img, 0.0, 1.0)
        elif i == 4:
            img = add_gaussian_noise(img, rng, 2, 25)
        elif i == 5:
            if rng.random() < jpeg_prob:
                img = add_jpeg_noise(img, rng)
        # i == 6: camera-ISP slot — the reference only runs it when an
        # isp_model is supplied (never in shipped configs)

    img = add_jpeg_noise(img, rng)
    return random_paired_crop(img, hq, rng, sf_ori, lq_patchsize)


def degradation_bsrgan_light(
    img: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    sf: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """The 'variant' chain (bsrgan_light.py / bsrgan.py:530-613): same op
    set without the paired crop — returns (lq, hq) at 1/sf and full size,
    used for whole-image validation degradation."""
    rng = rng or np.random.default_rng()
    h1, w1 = img.shape[:2]
    img = img.copy()[: h1 - h1 % sf, : w1 - w1 % sf, ...]
    hq = img.copy()
    sf_run = sf

    if sf == 4 and rng.random() < 0.25:
        img = cv_ops.resize(img, (int(img.shape[1] / 2), int(img.shape[0] / 2)),
                            interpolation=_CV2_INTERP[rng.integers(3)])
        img = np.clip(img, 0.0, 1.0)
        sf_run = 2

    shuffle_order = list(rng.permutation(7))
    idx1, idx2 = shuffle_order.index(2), shuffle_order.index(3)
    if idx1 > idx2:
        shuffle_order[idx1], shuffle_order[idx2] = (
            shuffle_order[idx2], shuffle_order[idx1])

    a = b = None
    for i in shuffle_order:
        if i in (0, 1):
            img = add_blur(img, rng, sf=sf_run)
        elif i == 2:
            a, b = img.shape[1], img.shape[0]
            if rng.random() < 0.75:
                sf1 = rng.uniform(1, 2 * sf_run)
                img = cv_ops.resize(
                    img, (int(img.shape[1] / sf1), int(img.shape[0] / sf1)),
                    interpolation=_CV2_INTERP[rng.integers(3)])
            else:
                k = fspecial_gaussian(25, rng.uniform(0.1, 0.6 * sf_run))
                k_shifted = shift_pixel(k, sf_run)
                k_shifted = k_shifted / k_shifted.sum()
                img = blur(img, k_shifted)
                img = img[0::sf_run, 0::sf_run, ...]
            img = np.clip(img, 0.0, 1.0)
        elif i == 3:
            img = cv_ops.resize(img, (w1 // sf, h1 // sf),
                                interpolation=_CV2_INTERP[rng.integers(3)])
            img = np.clip(img, 0.0, 1.0)
        elif i == 4:
            img = add_gaussian_noise(img, rng, 2, 25)
        elif i == 5:
            if rng.random() < 0.9:
                img = add_jpeg_noise(img, rng)

    img = cv_ops.resize(img, (w1 // sf, h1 // sf),
                        interpolation=cv_ops.INTER_LINEAR)
    img = add_jpeg_noise(img, rng)
    return img, hq
