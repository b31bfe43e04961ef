"""Blur-kernel synthesis for RealBasicVSR-style degradations.

Counterpart of ``mgldvsr_tpu/data/blur_kernels.py``, copied: isotropic and
anisotropic (generalized) Gaussians, plateau kernels and circular low-pass
(sinc) kernels. Pure numpy and ``scipy.special``; the kernels are the JAX
package's byte for byte at the same parameters.
"""
from __future__ import annotations

import numpy as np
from scipy import special


def mesh_grid(kernel_size: int):
    ax = np.arange(-(kernel_size // 2), kernel_size // 2 + 1, dtype=np.float64)
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], axis=-1), xx, yy


def sigma_matrix2(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x**2, 0], [0, sig_y**2]], dtype=np.float64)
    u = np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]],
        dtype=np.float64,
    )
    return u @ d @ u.T


def _quadratic_form(kernel_size: int, sigma_matrix: np.ndarray) -> np.ndarray:
    grid, _, _ = mesh_grid(kernel_size)
    inv = np.linalg.inv(sigma_matrix)
    return np.einsum("...i,ij,...j->...", grid, inv, grid)


def bivariate_gaussian(
    kernel_size: int,
    sig_x: float,
    sig_y: float | None = None,
    theta: float = 0.0,
    isotropic: bool = True,
) -> np.ndarray:
    if isotropic:
        sig_y, theta = sig_x, 0.0
    u = _quadratic_form(kernel_size, sigma_matrix2(sig_x, sig_y, theta))
    kernel = np.exp(-0.5 * u)
    return (kernel / kernel.sum()).astype(np.float32)


def bivariate_generalized_gaussian(
    kernel_size: int,
    sig_x: float,
    sig_y: float | None = None,
    theta: float = 0.0,
    beta: float = 1.0,
    isotropic: bool = True,
) -> np.ndarray:
    if isotropic:
        sig_y, theta = sig_x, 0.0
    u = _quadratic_form(kernel_size, sigma_matrix2(sig_x, sig_y, theta))
    kernel = np.exp(-0.5 * np.power(u, beta))
    return (kernel / kernel.sum()).astype(np.float32)


def bivariate_plateau(
    kernel_size: int,
    sig_x: float,
    sig_y: float | None = None,
    theta: float = 0.0,
    beta: float = 1.0,
    isotropic: bool = True,
) -> np.ndarray:
    if isotropic:
        sig_y, theta = sig_x, 0.0
    u = _quadratic_form(kernel_size, sigma_matrix2(sig_x, sig_y, theta))
    kernel = 1.0 / (np.power(u, beta) + 1.0)
    return (kernel / kernel.sum()).astype(np.float32)


def circular_lowpass_kernel(
    cutoff: float, kernel_size: int, pad_to: int = 0
) -> np.ndarray:
    """2-D sinc filter with cutoff frequency ``cutoff`` (0 < cutoff <= pi)."""
    assert kernel_size % 2 == 1
    half = (kernel_size - 1) / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        y, x = np.ogrid[-half : half + 1, -half : half + 1]
        r = np.sqrt(x**2 + y**2)
        kernel = cutoff * special.j1(cutoff * r) / (2 * np.pi * r)
        kernel[int(half), int(half)] = cutoff**2 / (4 * np.pi)
    kernel = kernel / kernel.sum()
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel.astype(np.float32)


KERNEL_TYPES = (
    "iso",
    "aniso",
    "generalized_iso",
    "generalized_aniso",
    "plateau_iso",
    "plateau_aniso",
    "sinc",
)


def make_kernel(
    kernel_type: str,
    kernel_size: int,
    sigma_x: float,
    sigma_y: float,
    rotate_angle: float,
    beta_gaussian: float,
    beta_plateau: float,
    omega: float,
) -> np.ndarray:
    """One kernel of the requested family with fully explicit parameters
    (the random-walk stepping lives in the transform, not here)."""
    if kernel_type == "iso":
        return bivariate_gaussian(kernel_size, sigma_x, isotropic=True)
    if kernel_type == "aniso":
        return bivariate_gaussian(
            kernel_size, sigma_x, sigma_y, rotate_angle, isotropic=False
        )
    if kernel_type == "generalized_iso":
        return bivariate_generalized_gaussian(
            kernel_size, sigma_x, beta=beta_gaussian, isotropic=True
        )
    if kernel_type == "generalized_aniso":
        return bivariate_generalized_gaussian(
            kernel_size, sigma_x, sigma_y, rotate_angle, beta_gaussian, False
        )
    if kernel_type == "plateau_iso":
        return bivariate_plateau(
            kernel_size, sigma_x, beta=beta_plateau, isotropic=True
        )
    if kernel_type == "plateau_aniso":
        return bivariate_plateau(
            kernel_size, sigma_x, sigma_y, rotate_angle, beta_plateau, False
        )
    if kernel_type == "sinc":
        return circular_lowpass_kernel(omega, kernel_size)
    raise ValueError(f"unknown kernel type {kernel_type}")
