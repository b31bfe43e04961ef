"""Quality metrics: PSNR/SSIM (MATLAB parity), NIQE, FID, E*warp."""
from mgldvsr_tpu_torch.metrics.fid import calculate_activation_statistics, calculate_fid
from mgldvsr_tpu_torch.metrics.image import (
    calculate_psnr,
    calculate_ssim,
    psnr_tensor,
    ssim_tensor,
)
from mgldvsr_tpu_torch.metrics.niqe import calculate_niqe, fit_niqe_params
from mgldvsr_tpu_torch.metrics.temporal import calculate_ewarp
