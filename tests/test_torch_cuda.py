"""The port's kernels on the card: each CUDA/Triton kernel against its plain
PyTorch version, and the tiny restore on the card against the CPU.

Every test here needs a CUDA device, carries the ``cuda`` marker and skips
without one. This file imports neither JAX nor the JAX package, so on a
machine without JAX it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest
import torch

from mgldvsr_tpu_torch.ops import kernels
from mgldvsr_tpu_torch.ops.kernels.attention import attention, attention_plain
from mgldvsr_tpu_torch.ops.kernels.corr_lookup import lookup_corr, lookup_corr_plain
from mgldvsr_tpu_torch.ops.kernels.flow_warp import (
    flow_warp_guided,
    warp_dx,
    warp_dx_plain,
    warp_forward,
    warp_plain,
)
from mgldvsr_tpu_torch.ops.kernels.groupnorm import channel_sums, channel_sums_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def test_warp_kernels_match_plain(dev):
    """fp32; dx sums by atomics in a varying order: atol 1e-5."""
    gen = _gen(dev)
    x = torch.randn(6, 64, 64, 4, device=dev, generator=gen)
    flow = torch.randn(6, 64, 64, 2, device=dev, generator=gen) * 5
    g = torch.randn(6, 64, 64, 4, device=dev, generator=gen)
    torch.testing.assert_close(warp_forward(x, flow), warp_plain(x, flow), atol=1e-5, rtol=0)
    torch.testing.assert_close(warp_dx(g, flow), warp_dx_plain(g, flow), atol=1e-5, rtol=0)
    xr = x.clone().requires_grad_(True)
    flow_warp_guided(xr, flow).backward(g)
    torch.testing.assert_close(xr.grad, warp_dx_plain(g, flow), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,d", [(1100, 64), (1024, 16), (1030, 8), (300, 128)])
def test_attention_kernel_matches_plain(dev, dtype, tol, n, d):
    """bf16: the plain version rounds its probabilities to bf16 (2e-2)."""
    gen = _gen(dev, n + d)
    q, k, v = (torch.randn(4, n, d, device=dev, generator=gen).to(dtype) for _ in range(3))
    torch.testing.assert_close(attention(q, k, v).float(), attention_plain(q, k, v).float(),
                               atol=tol, rtol=0)


def test_corr_lookup_kernel_matches_plain(dev):
    gen = _gen(dev)
    pyr = [torch.randn(2, 256, 16 >> lvl, 16 >> lvl, device=dev, generator=gen)
           for lvl in range(4)] + [torch.randn(2, 256, 0, 0, device=dev)]
    coords = torch.rand(2, 16, 16, 2, device=dev, generator=gen) * 30 - 8
    torch.testing.assert_close(lookup_corr(pyr, coords, 4), lookup_corr_plain(pyr, coords, 4),
                               atol=1e-5, rtol=0)


def test_channel_sums_kernel_matches_plain(dev):
    gen = _gen(dev)
    xb = (torch.randn(2, 64, 130, 129, device=dev, generator=gen) + 0.5).to(torch.bfloat16)
    for a, b in zip(channel_sums(xb), channel_sums_plain(xb)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-2)


def test_wrappers_raise_on_bad_input(dev):
    x = torch.randn(2, 8, 8, 4, device=dev)
    with pytest.raises(TypeError):
        warp_forward(x.double(), torch.zeros(2, 8, 8, 2, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        warp_forward(x, torch.zeros(2, 8, 8, 2))  # flow on the CPU
    q = torch.randn(2, 64, 24, device=dev)
    with pytest.raises(ValueError):
        attention(q, q, q)  # head dim 24 has no kernel


def test_tiny_restore_on_card_matches_cpu(dev):
    """fp32, TF32 off: the card (kernels) and the CPU (plain versions) give
    the same frames within 1e-3 on [0,1], and the kernels were launched."""
    import chip_smoke

    chip_smoke.phase3(0, "test")
    assert kernels.launch_counts()["attention"] > 0
