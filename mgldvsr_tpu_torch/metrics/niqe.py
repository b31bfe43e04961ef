"""NIQE no-reference quality metric, on the host in numpy and scipy.

Counterpart of ``mgldvsr_tpu/metrics/niqe.py`` (basicsr's
``calculate_niqe``): MSCN coefficients, AGGD feature fits over 96x96 blocks
at two scales, and a Mahalanobis-style distance to a pristine multivariate
Gaussian. The pristine parameters (an npz with ``mu_pris_param``,
``cov_pris_param``, ``gaussian_window``) are data: pass ``params_path``,
set ``MGLD_NIQE_PARAMS``, or fit them with :func:`fit_niqe_params`. OpenCV's
calls are :mod:`mgldvsr_tpu_torch.data.cv_ops`'s: the 7x7 window filter
with ``BORDER_REPLICATE`` (bit for bit with OpenCV on float64), the
half-size ``INTER_LINEAR`` resize and the float32 RGB-to-gray conversion.

An image needs at least two 96x96 blocks: one block has no covariance.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
from scipy.special import gamma

from mgldvsr_tpu_torch.data import cv_ops
from mgldvsr_tpu_torch.metrics.image import rgb_to_y

_GAMMA_RANGE = np.arange(0.2, 10.001, 0.001)
_R_GAM = (gamma(2.0 / _GAMMA_RANGE) ** 2) / (
    gamma(1.0 / _GAMMA_RANGE) * gamma(3.0 / _GAMMA_RANGE))


def estimate_aggd_param(block: np.ndarray) -> Tuple[float, float, float]:
    """Fit an asymmetric generalised Gaussian: (alpha, beta_l, beta_r)."""
    block = block.flatten()
    left_std = np.sqrt(np.mean(block[block < 0] ** 2)) if (block < 0).any() else 0.0
    right_std = np.sqrt(np.mean(block[block > 0] ** 2)) if (block > 0).any() else 0.0
    gammahat = left_std / right_std if right_std > 0 else np.inf
    rhat = (np.mean(np.abs(block))) ** 2 / np.mean(block ** 2) if np.mean(block ** 2) > 0 else 0.0
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / (
        (gammahat ** 2 + 1) ** 2) if np.isfinite(gammahat) else 0.0
    array_position = np.argmin((_R_GAM - rhatnorm) ** 2)
    alpha = _GAMMA_RANGE[array_position]
    beta_l = left_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    beta_r = right_std * np.sqrt(gamma(1 / alpha) / gamma(3 / alpha))
    return float(alpha), float(beta_l), float(beta_r)


def compute_feature(block: np.ndarray) -> list:
    """18 NIQE features: the block's AGGD and those of 4 paired products."""
    feat = []
    alpha, beta_l, beta_r = estimate_aggd_param(block)
    feat.extend([alpha, (beta_l + beta_r) / 2])
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        shifted = np.roll(block, (dy, dx), axis=(0, 1))
        alpha, beta_l, beta_r = estimate_aggd_param(block * shifted)
        mean = (beta_r - beta_l) * (gamma(2 / alpha) / gamma(1 / alpha))
        feat.extend([alpha, mean, beta_l, beta_r])
    return feat


def _default_gaussian_window() -> np.ndarray:
    """7x7 Gaussian (sigma 7/6), MATLAB's fspecial('gaussian', 7, 7/6)."""
    ax = np.arange(7) - 3
    g = np.exp(-(ax ** 2) / (2 * (7.0 / 6.0) ** 2))
    w = np.outer(g, g)
    return (w / w.sum()).astype(np.float64)


def _image_features(img: np.ndarray, block_size_h: int = 96, block_size_w: int = 96,
                    gaussian_window: Optional[np.ndarray] = None) -> np.ndarray:
    """[blocks, 36] NIQE features (both scales) of one gray [0,255] image:
    the one feature path of scoring and of fitting."""
    if gaussian_window is None:
        gaussian_window = _default_gaussian_window()
    h, w = img.shape
    num_block_h = math.floor(h / block_size_h)
    num_block_w = math.floor(w / block_size_w)
    img = img[: num_block_h * block_size_h, : num_block_w * block_size_w]
    distparam = []
    for scale in (1, 2):
        mu = cv_ops.filter2D(img, -1, gaussian_window, borderType=cv_ops.BORDER_REPLICATE)
        sigma = np.sqrt(np.abs(cv_ops.filter2D(img ** 2, -1, gaussian_window,
                                               borderType=cv_ops.BORDER_REPLICATE) - mu ** 2))
        img_norm = (img - mu) / (sigma + 1)
        bh = block_size_h // scale
        bw = block_size_w // scale
        feats = [compute_feature(img_norm[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw])
                 for i in range(num_block_h) for j in range(num_block_w)]
        distparam.append(np.array(feats))
        if scale == 1:
            # half the cropped image, as basicsr's loop does (the JAX package
            # halves the uncropped size; the two agree where H and W are whole
            # blocks)
            img = cv_ops.resize(img / 255.0, (img.shape[1] // 2, img.shape[0] // 2),
                                interpolation=cv_ops.INTER_LINEAR) * 255.0
    return np.concatenate(distparam, axis=1)


def niqe_core(img: np.ndarray, mu_pris: np.ndarray, cov_pris: np.ndarray,
              gaussian_window: Optional[np.ndarray] = None, block_size_h: int = 96,
              block_size_w: int = 96) -> float:
    """NIQE of a gray [0,255] float64 image."""
    distparam = _image_features(img, block_size_h, block_size_w, gaussian_window)
    mu_distparam = np.nanmean(distparam, axis=0)
    dist_no_nan = distparam[~np.isnan(distparam).any(axis=1)]
    cov_distparam = np.cov(dist_no_nan, rowvar=False)
    invcov = np.linalg.pinv((cov_pris + cov_distparam) / 2)
    diff = mu_pris - mu_distparam
    return float(np.sqrt(diff @ invcov @ diff.T))


def fit_niqe_params(images, out_path: Optional[str] = None, block_size: int = 96):
    """The pristine model from pristine gray [0,255] images (an iterable of
    HxW arrays): (mu_pris_param, cov_pris_param, gaussian_window), also
    saved to ``out_path`` as an npz that :func:`calculate_niqe` reads."""
    feats = np.concatenate([_image_features(np.asarray(im, np.float64), block_size, block_size)
                            for im in images], axis=0)
    feats = feats[~np.isnan(feats).any(axis=1)]
    mu = np.mean(feats, axis=0)
    cov = np.cov(feats, rowvar=False)
    gw = _default_gaussian_window()
    if out_path:
        np.savez(out_path, mu_pris_param=mu, cov_pris_param=cov, gaussian_window=gw)
    return mu, cov, gw


def calculate_niqe(img: np.ndarray, crop_border: int = 0, params_path: Optional[str] = None,
                   convert_to: str = "y") -> float:
    """NIQE of a [0,255] HWC (or HW) image, on its Y channel (``"y"``) or
    its gray conversion (``"gray"``)."""
    if params_path is None:
        params_path = os.environ.get("MGLD_NIQE_PARAMS")
    if params_path is None:
        raise ValueError("NIQE needs the pristine model parameters (niqe_pris_params.npz); "
                         "pass params_path, set MGLD_NIQE_PARAMS, or create one with "
                         "fit_niqe_params()")
    with np.load(params_path) as data:
        mu_pris = data["mu_pris_param"]
        cov_pris = data["cov_pris_param"]
        gw = data["gaussian_window"] if "gaussian_window" in data else None

    img = img.astype(np.float64)
    if img.ndim == 3 and img.shape[2] == 3:
        if convert_to == "y":
            img = rgb_to_y(img)[..., 0]
        else:
            img = cv_ops.cvtColor((img / 255.0).astype(np.float32),
                                  cv_ops.COLOR_RGB2GRAY).astype(np.float64) * 255.0
    elif img.ndim == 3:
        img = img[..., 0]
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    return niqe_core(np.round(img), mu_pris, cov_pris, gw)
