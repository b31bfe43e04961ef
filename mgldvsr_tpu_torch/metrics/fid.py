"""FID: InceptionV3 pool3 features and the Fréchet distance.

Counterpart of ``mgldvsr_tpu/metrics/fid.py`` (basicsr's FID): the
FID-patched pool3 tower (:class:`~mgldvsr_tpu_torch.metrics.inception.
InceptionV3FID`), the mean and covariance of its features, and the Fréchet
distance between the two Gaussians, in scipy on the host. The
pt_inception-2015-12-05 checkpoint loads directly, with no conversion. The
feature extractor stays pluggable (any ``fn(frames_nhwc) -> [N, D]``).
"""
from __future__ import annotations

import warnings
from typing import Callable, Iterable, Tuple

import numpy as np
import torch
from scipy import linalg

from mgldvsr_tpu_torch.io.torch_ckpt import load_torch_state_dict
from mgldvsr_tpu_torch.metrics.inception import InceptionV3FID, feature_state_dict


def load_patched_inception(ckpt_path: str, resize_input: bool = True,
                           normalize_input: bool = False,
                           device: str | torch.device = "cuda") -> InceptionV3FID:
    """basicsr's ``load_patched_inception_v3``: the tower with the
    checkpoint's weights (strict), on ``device``. Called on [N, H, W, 3]
    frames it returns [N, 2048] features."""
    model = InceptionV3FID(resize_input=resize_input, normalize_input=normalize_input)
    model.load_state_dict(feature_state_dict(load_torch_state_dict(ckpt_path)), strict=True)
    return model.to(device)


def extract_features(feature_fn: Callable[[np.ndarray], np.ndarray],
                     batches: Iterable[np.ndarray]) -> np.ndarray:
    feats = [np.asarray(feature_fn(b)) for b in batches]
    return np.concatenate(feats, axis=0)


def calculate_activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    if feats.shape[0] <= feats.shape[-1]:
        warnings.warn(
            f"FID statistics from {feats.shape[0]} samples of dim {feats.shape[-1]}: the "
            "covariance is singular (need > dim samples, canonically >=2048 images) — the "
            "resulting FID is not comparable across runs", stacklevel=2)
    mu = np.mean(feats, axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def calculate_fid(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
                  eps: float = 1e-6) -> float:
    """Fréchet distance between N(mu1, sigma1) and N(mu2, sigma2)."""
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        warnings.warn(
            f"fid sqrtm produced non-finite values; retrying with a {eps} diagonal offset "
            "(expected with singular covariances from too few samples)", stacklevel=2)
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))
