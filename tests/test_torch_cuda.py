"""The port's kernels on the card: each CUDA/Triton kernel against its plain
PyTorch version, and the tiny restore on the card against the CPU.

Every test here needs a CUDA device, carries the ``cuda`` marker and skips
without one. This file imports neither JAX nor the JAX package, so on a
machine without JAX it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import subprocess
import sys

import pytest
import torch

from mgldvsr_tpu_torch.ops import kernels
from mgldvsr_tpu_torch.ops.kernels.attention import (
    attention,
    attention_bnhd,
    attention_plain,
)
from mgldvsr_tpu_torch.ops.kernels.corr_lookup import lookup_corr, lookup_corr_plain
from mgldvsr_tpu_torch.ops.kernels.flow_warp import (
    flow_warp_guided,
    warp_dx,
    warp_dx_plain,
    warp_forward,
    warp_plain,
)
from mgldvsr_tpu_torch.ops.kernels import _build
from mgldvsr_tpu_torch.ops.kernels import gn_silu_conv as conv_mod
from mgldvsr_tpu_torch.ops.kernels import guidance as guide_mod
from mgldvsr_tpu_torch.ops.kernels.gn_silu_conv import gn_silu_conv3x3, gn_silu_conv3x3_plain
from mgldvsr_tpu_torch.ops.kernels.groupnorm import (
    channel_sums,
    channel_sums_plain,
    fused_gn_plan,
    fused_group_norm,
    fused_group_norm_plain,
    gn_scale_shift,
    gn_scale_shift_plain,
)

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


def _warp_case(dev, c, case):
    """x [n,h,w,c] and a flow for ``warp_forward``: ``smooth`` (a coarse
    field of a few pixels, upsampled), ``large`` (randn x 40: taps far from
    their pixel), ``odd`` (H and W off the 16 x 64 tile), ``offset`` (x's base
    one element off the 16-byte boundary: 4 channels leave the float4 kernel
    for the tiled one) and ``outside`` (taps mostly beyond the image, whole
    tiles reading only zeros); the rest randn x 3."""
    import torch.nn.functional as F

    gen = _gen(dev, 100 * c + len(case))
    n, h, w = (2, 37, 101) if case == "odd" else (2, 64, 160)
    flow = torch.randn(n, h, w, 2, device=dev, generator=gen) * 3
    if case == "smooth":
        coarse = torch.randn(n, 2, 4, 6, device=dev, generator=gen) * 3
        flow = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
        flow = flow.permute(0, 2, 3, 1).contiguous()
    elif case == "large":
        flow = flow * 40
    elif case == "outside":
        flow = flow + torch.tensor([0.75 * w, -0.6 * h], device=dev)
    if case == "offset":
        x = torch.randn(n * h * w * c + 1, device=dev, generator=gen)[1:].view(n, h, w, c)
        assert x.data_ptr() % 16 == 4 and x.is_contiguous()
    else:
        x = torch.randn(n, h, w, c, device=dev, generator=gen)
    return x, flow


@pytest.mark.parametrize("case", ["smooth", "large", "odd", "offset", "outside"])
@pytest.mark.parametrize("c", [3, 4])
def test_warp_forward_equals_plain(dev, c, case):
    """Both forward kernels (the tiled gather; one thread a pixel with
    float4 taps for aligned 4-channel images) do the plain warp's
    arithmetic: equal, in one launch."""
    x, flow = _warp_case(dev, c, case)
    kernels.reset_launch_counts()
    got = warp_forward(x, flow)
    assert kernels.launch_counts()["warp_forward"] == 1
    want = warp_plain(x, flow)
    assert torch.equal(got, want), float((got - want).abs().max())
    if case == "outside":
        assert (want == 0).float().mean() > 0.5


def _attention_counts():
    return {name: n for name, n in kernels.launch_counts().items() if "attention" in name}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1100, 64), (1024, 16), (1030, 8), (300, 128),
                                 (1024, 64), (4096, 64)])
def test_attention_kernel_matches_plain(dev, dtype, n, d):
    """v has mean 1, so the outputs are O(1) and a dropped key tile or a
    wrong mask moves them by percents. float32: 1e-4. bf16: 3 bf16 ulps at
    max |want| (about 1e-2; the kernel and the plain version each round the
    probabilities and the output to bf16 once), against the plain version on
    the same inputs and against the plain version in float32 on the same
    values. bf16 at head dim 64 must run the tensor-core kernel and
    everything else the FMA kernel."""
    gen = _gen(dev, n + d)
    q, k, v = (torch.randn(4, n, d, device=dev, generator=gen) for _ in range(3))
    q, k, v = q.to(dtype), k.to(dtype), (v + 1).to(dtype)
    want = attention_plain(q.float(), k.float(), v.float())
    tol = 1e-4 if dtype == torch.float32 else 3 * 2 ** -8 * float(want.abs().max())
    kernels.reset_launch_counts()
    got = attention(q, k, v).float()
    tensor_cores = int(dtype == torch.bfloat16 and d == 64)
    assert _attention_counts() == {"attention": 1, "attention_wgmma": tensor_cores,
                                   "attention_strided": tensor_cores,
                                   "attention_wide": 0, "attention_wide_strided": 0}
    torch.testing.assert_close(got, want, atol=tol, rtol=0)
    torch.testing.assert_close(got, attention_plain(q, k, v).float(), atol=tol, rtol=0)


def _vae_views(dev, n, dtype, seed):
    """q, k, v as the VAE's mid attention hands them over: [5, 512, N]
    1x1-conv outputs (NCHW, flattened) viewed as [5, N, 1, 512], stride N in
    D. v has mean 1 (outputs O(1))."""
    gen = _gen(dev, seed)
    q, k, v = (torch.randn(5, 512, n, device=dev, generator=gen) for _ in range(3))
    return [z.to(dtype).transpose(1, 2)[:, :, None] for z in (q, k, v + 1)]


@pytest.mark.parametrize("dtype,n", [(torch.bfloat16, 1024), (torch.bfloat16, 1030),
                                     (torch.bfloat16, 2304), (torch.bfloat16, 3249),
                                     (torch.float32, 1024), (torch.float32, 2025)])
def test_vae_mid_attention_takes_the_wide_kernel_on_card(dev, dtype, n):
    """The VAE's single-head d=512 mid attention at the gate's smallest and
    largest latents (32^2 to 57^2 in bf16, to 45^2 in float32; and N off the
    64-row tiles) passes the JAX gate and takes a wide kernel, once, through
    the dispatch, on the VAE's own views. bf16 reads them in place where N
    is a multiple of 8 and writes [5, 512, N], so the reshape back to NCHW
    is a view; otherwise they are copied. Limits as
    ``test_attention_kernel_matches_plain``'s, against the plain math in
    float32 on the same values."""
    from mgldvsr_tpu_torch.ops.attention import attend, attention_math

    q, k, v = _vae_views(dev, n, dtype, n)
    want = attention_math(q.float(), k.float(), v.float())
    tol = 1e-4 if dtype == torch.float32 else 3 * 2 ** -8 * float(want.abs().max())
    kernels.reset_launch_counts()
    got = attend(q, k, v)
    in_place = int(dtype == torch.bfloat16 and n % 8 == 0)
    assert _attention_counts() == {"attention": 1, "attention_wgmma": 0, "attention_strided": 0,
                                   "attention_wide": 1, "attention_wide_strided": in_place}
    assert got.shape == q.shape and got.dtype == dtype
    assert got[:, :, 0].transpose(1, 2).is_contiguous() == bool(in_place)
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("n", [1024, 2304])
def test_wide_attention_vae_views_equal_the_folded_call_on_card(dev, n):
    """bf16 at d=512: the VAE's views read in place (d rows) equal the same
    values folded into contiguous token rows, bit for bit."""
    q, k, v = _vae_views(dev, n, torch.bfloat16, n + 7)
    kernels.reset_launch_counts()
    got = attention_bnhd(q, k, v)
    assert kernels.launch_counts()["attention_wide_strided"] == 1
    want = attention(*(z[:, :, 0].contiguous() for z in (q, k, v)))
    assert kernels.launch_counts()["attention_wide_strided"] == 2  # contiguous rows: in place
    assert torch.equal(got[:, :, 0], want)


@pytest.mark.parametrize("n", [1024, 1030])
def test_wide_attention_large_logits_on_card(dev, n):
    """bf16 at d=512 with q scaled by 8 (logits of tens: the running max
    moves and the accumulator is rescaled from tile to tile), against the
    plain version in float32 on the same values, 2e-2, as at d = 64."""
    gen = _gen(dev, n + 3)
    q, k, v = (torch.randn(5, n, 512, device=dev, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    q = q * 8
    kernels.reset_launch_counts()
    got = attention(q, k, v)
    assert kernels.launch_counts()["attention_wide"] == 1
    assert torch.isfinite(got).all()
    want = attention_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("n", [1024, 1100])
def test_attention_large_logits_on_card(dev, n):
    """q scaled by 8: logits of tens, so the running max moves and the
    accumulator is rescaled from tile to tile. The plain version in bf16
    rounds its logits to bf16, several percent of a probability at this
    size, so the reference is the plain version in float32 on the same bf16
    values; 2e-2 covers the kernel's rounding of P to bf16."""
    gen = _gen(dev, n)
    q, k, v = (torch.randn(3, n, 64, device=dev, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    q = q * 8
    got = attention(q, k, v)
    assert torch.isfinite(got).all()
    want = attention_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("n", [1024, 1100])
def test_attention_strided_entry_on_card(dev, n):
    """[B,N,H,D] operands read in place (slices of one [B,N,3,H,D] tensor,
    as a fused projection would give) equal the folded call bit for bit; a
    view with stride N in D (the qkv block's layout) is copied and agrees
    too. The output is contiguous [B,N,H,D]."""
    gen = _gen(dev, n + 1)
    qkv = torch.randn(2, n, 3, 5, 64, device=dev, generator=gen).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()

    def fold(z):
        return z.permute(0, 2, 1, 3).reshape(10, n, 64).contiguous()

    want = attention(fold(q), fold(k), fold(v)).reshape(2, 5, n, 64).permute(0, 2, 1, 3)
    kernels.reset_launch_counts()
    got = attention_bnhd(q, k, v)
    assert got.is_contiguous() and got.shape == (2, n, 5, 64)
    assert torch.equal(got, want)
    assert _attention_counts() == {"attention": 1, "attention_wgmma": 1,
                                   "attention_strided": 1, "attention_wide": 0,
                                   "attention_wide_strided": 0}
    chan = torch.randn(2, 5, 3, 64, n, device=dev, generator=gen).to(torch.bfloat16)
    q, k, v = chan.permute(2, 0, 4, 1, 3).unbind(0)  # [B,N,H,D] with stride N in D
    got = attention_bnhd(q, k, v)
    assert _attention_counts() == {"attention": 2, "attention_wgmma": 2,
                                   "attention_strided": 1, "attention_wide": 0,
                                   "attention_wide_strided": 0}
    want = attention(fold(q), fold(k), fold(v)).reshape(2, 5, n, 64).permute(0, 2, 1, 3)
    assert torch.equal(got, want)
    # a contiguous [BH,N,D] view whose base is 2 bytes off a 16-byte boundary
    flat = torch.randn(3, 10 * n * 64 + 1, device=dev, generator=gen).to(torch.bfloat16)
    q, k, v = (z[1:].view(10, n, 64) for z in flat)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    assert torch.equal(attention(q, k, v), attention(q.clone(), k.clone(), v.clone()))
    # the same for [B,N,H,D] operands: contiguous, so ``contiguous()`` would
    # hand them back as they are; they must be copied, not faulted on
    q, k, v = (z[1:].view(2, n, 5, 64) for z in flat)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    kernels.reset_launch_counts()
    got = attention_bnhd(q, k, v)
    assert _attention_counts() == {"attention": 1, "attention_wgmma": 1,
                                   "attention_strided": 0, "attention_wide": 0,
                                   "attention_wide_strided": 0}
    assert torch.equal(got, attention_bnhd(q.clone(), k.clone(), v.clone()))


@pytest.mark.parametrize("radius", [4, 2, 0])
def test_corr_lookup_kernel_matches_plain(dev, radius):
    """All levels in one launch: square, ragged (5 x 3, 1 x 7) and empty
    level maps, centres up to 8 px outside the map and some thousands of
    pixels away (the clamped base: all zeros). fp32, 1e-5: the same four
    products summed in the same order."""
    gen = _gen(dev)
    sizes = [(16, 16), (8, 8), (5, 3), (1, 7), (0, 0)]
    pyr = [torch.randn(2, 256, hl, wl, device=dev, generator=gen) for hl, wl in sizes]
    coords = torch.rand(2, 16, 16, 2, device=dev, generator=gen) * 30 - 8
    coords[0, 0, :4] = torch.tensor([[-3e4, 5.0], [5.0, 4e4], [1e9, -1e9], [-17.5, 33.25]],
                                    device=dev)
    kernels.reset_launch_counts()
    got = lookup_corr(pyr, coords, radius)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {"corr_lookup": 1}
    want = lookup_corr_plain(pyr, coords, radius)
    assert got.shape == (2, 16, 16, 5 * (2 * radius + 1) ** 2)
    assert not got[0, 0, :3].any()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_corr_lookup_raises_on_what_it_does_not_take(dev):
    coords = torch.zeros(1, 4, 4, 2, device=dev)
    level = torch.zeros(1, 16, 4, 4, device=dev)
    with pytest.raises(ValueError):
        lookup_corr([level] * 9, coords, 4)   # more levels than the kernel's struct holds
    with pytest.raises(ValueError):
        lookup_corr([level] * 4, coords, 19)  # windows beyond a block's shared memory
    with pytest.raises(ValueError):
        lookup_corr([level.double()], coords, 4)


def test_channel_sums_kernel_matches_plain(dev):
    gen = _gen(dev)
    xb = (torch.randn(2, 64, 130, 129, device=dev, generator=gen) + 0.5).to(torch.bfloat16)
    for a, b in zip(channel_sums(xb), channel_sums_plain(xb)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-2)


def test_channel_sums_gradient_on_card(dev):
    """dx = g1 + 2 x g2 through the autograd Function, against autograd of
    the plain version (fp32, 1e-5)."""
    gen = _gen(dev, 1)
    x = torch.randn(2, 8, 16, 16, device=dev, generator=gen)
    g1, g2 = (torch.randn(2, 8, device=dev, generator=gen) for _ in range(2))
    grads = []
    for fn in (channel_sums, channel_sums_plain):
        xr = x.clone().requires_grad_(True)
        s1, s2 = fn(xr)
        ((s1 * g1).sum() + (s2 * g2).sum()).backward()
        grads.append(xr.grad)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=0)


_ULP = {torch.float32: 0.0, torch.bfloat16: 2 ** -8, torch.float16: 2 ** -11}


@pytest.mark.parametrize("shape,dtype,eps,plan", [
    ((5, 320, 64, 64), torch.bfloat16, 1e-5, (4, 20480)),
    ((2, 960, 64, 64), torch.bfloat16, 1e-5, (8, 30720)),
    ((5, 1280, 16, 16), torch.bfloat16, 1e-5, (2, 10240)),
    ((5, 1280, 8, 8), torch.bfloat16, 1e-6, (1, 5120)),
    ((1, 1280, 5, 8, 8), torch.bfloat16, 1e-5, (2, 12800)),
    ((3, 64, 7, 9), torch.float16, 1e-5, (1, 256)),       # slabs of 252 bytes: bases off 16
    ((2, 64, 33, 31), torch.bfloat16, 1e-5, (1, 4096)),   # vectors that straddle two channels
    ((1, 96, 37, 37), torch.bfloat16, 1e-6, (1, 8224)),   # a ragged end under one vector
    ((2, 32, 3, 1), torch.bfloat16, 1e-5, (1, 16)),       # channels shorter than a vector
    ((5, 32, 64, 64), torch.float32, 1e-5, (2, 8192)),
    ((2, 64, 13, 11), torch.float32, 1e-6, (1, 1152)),
    ((1, 1280, 5, 64, 64), torch.float32, 1e-5, (8, 0)),  # shares of 400 KB: walked twice
    ((1, 64, 300, 300), torch.bfloat16, 1e-5, (8, 45008)),  # staged shares with ragged ends
    ((1, 32, 640, 640), torch.bfloat16, 1e-5, (8, 0)),      # 100 KB shares: not staged
])
def test_fused_group_norm_kernel_matches_plain(dev, shape, dtype, eps, plan):
    """Every split (1, 2, 4, 8 blocks a slab), staged and walked twice,
    aligned and not. fp32: 1e-5 (sums in another order). bf16/fp16: the
    folded scale and shift can round to the neighbouring value, so 2 ulps at
    max |y|."""
    n, c = shape[:2]
    gen = _gen(dev, sum(shape))
    x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5).to(dtype)
    assert fused_gn_plan(n * 32, x[0].numel() // 32, x.element_size(), c // 32) == plan
    w = torch.randn(c, device=dev, generator=gen)
    b = torch.randn(c, device=dev, generator=gen)
    kernels.reset_launch_counts()
    got = fused_group_norm(x, w, b, 32, eps)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {"fused_group_norm": 1}
    want = fused_group_norm_plain(x, w, b, 32, eps)
    assert got.dtype == dtype and got.shape == x.shape
    tol = 1e-5 + 2 * _ULP[dtype] * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_group_norm_on_a_view_off_the_16_byte_boundary(dev, dtype):
    """x is a contiguous view that starts one element into its buffer, so
    every slab's base is off a 16-byte boundary while y's is on one: the
    scalar loops, which sum in another order than the vector loops do on an
    aligned copy. fp32 1e-5; bf16 2 ulps at max |y|, as against the plain
    version."""
    gen = _gen(dev, 3)
    flat = (torch.randn(2 * 64 * 16 * 16 + 1, device=dev, generator=gen) * 2 + 0.5).to(dtype)
    x = flat[1:].view(2, 64, 16, 16)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    w, b = (torch.randn(64, device=dev, generator=gen) for _ in range(2))
    got = fused_group_norm(x, w, b, 32, 1e-5).float()
    for want in (fused_group_norm(x.clone(), w, b, 32, 1e-5).float(),
                 fused_group_norm_plain(x, w, b, 32, 1e-5).float()):
        tol = 1e-5 + 2 * _ULP[dtype] * float(want.abs().max())
        torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_group_norm_of_a_constant_clips_the_variance(dev, dtype):
    """x = 2 everywhere: the sums are exact, the variance is exactly 0, so
    a = w / sqrt(eps) (632 |w|) and y = 2 a + (bias - 2 a), which is the bias
    up to the rounding of two numbers of the size of 2 a: 2 ulps of max |2 a|
    in bf16; in fp32 1e-6 of it (``rsqrtf`` against ``torch.rsqrt``: a few
    ulps)."""
    gen = _gen(dev, 4)
    x = torch.full((2, 64, 16, 16), 2.0, device=dev, dtype=dtype)
    w, b = (torch.randn(64, device=dev, generator=gen) for _ in range(2))
    got = fused_group_norm(x, w, b, 32, 1e-5)
    want = fused_group_norm_plain(x, w, b, 32, 1e-5)
    assert torch.isfinite(got).all()
    size = 2 * 1e-5 ** -0.5 * float(w.abs().max())
    tol = size * (2 * 2 ** -8 if dtype == torch.bfloat16 else 1e-6)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    torch.testing.assert_close(got.float(), b[None, :, None, None].expand(x.shape), atol=2 * tol,
                               rtol=0)


def test_fused_group_norm_is_one_ctypes_launch_without_triton():
    """In a fresh process: one call is one launch, and it does not bring
    Triton in (``channel_sums`` is the one kernel that does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    code = (
        "import sys, torch\n"
        "from mgldvsr_tpu_torch.ops import kernels\n"
        "from mgldvsr_tpu_torch.ops.kernels.groupnorm import channel_sums, fused_group_norm\n"
        "before = 'triton' in sys.modules\n"
        "x = torch.randn(5, 320, 64, 64, device='cuda').bfloat16()\n"
        "w, b = torch.ones(320, device='cuda'), torch.zeros(320, device='cuda')\n"
        "y = fused_group_norm(x, w, b)\n"
        "torch.cuda.synchronize()\n"
        "assert kernels.launch_counts()['fused_group_norm'] == 1\n"
        "assert ('triton' in sys.modules) == before, 'fused_group_norm imported triton'\n"
        "channel_sums(x)\n"
        "assert 'triton' in sys.modules\n"
        "print('ok', before)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stdout + out.stderr


@pytest.mark.parametrize("n,c,h,w,co,dtype", [
    (5, 320, 64, 64, 320, torch.bfloat16),
    (2, 960, 32, 32, 320, torch.bfloat16),
    (5, 2560, 8, 8, 1280, torch.bfloat16),
    (5, 320, 64, 64, 4, torch.bfloat16),
    (1, 128, 130, 70, 3, torch.bfloat16),
    (2, 64, 19, 23, 96, torch.bfloat16),
    (2, 96, 24, 40, 72, torch.bfloat16),    # C and Co off the 64- and 128-channel tiles
    (2, 64, 16, 1, 32, torch.bfloat16),     # a frame one pixel wide
    (5, 128, 8, 8, 200, torch.bfloat16),    # 8 x 8 frames: a warpgroup a frame, the last one idle
    (3, 64, 21, 7, 24, torch.bfloat16),     # narrow and ragged
    (1, 576, 16, 16, 64, torch.bfloat16),   # 2 tiles, 9 stages: split among a cluster of 8 blocks
    (2, 1280, 8, 8, 96, torch.bfloat16),    # the same for 8 x 8 tiles
    (2, 96, 16, 8, 40, torch.float16),
    (2, 64, 16, 8, 96, torch.float32),
    (3, 32, 9, 21, 5, torch.float32),
])
def test_gn_silu_conv_kernel_matches_plain(dev, n, c, h, w, co, dtype):
    """Ragged frames, Co below and off the channel tile, C off the stage
    (96). fp32: 1e-4 of max |y| (sums in another order, TF32 off). bf16 and
    fp16: the plain version rounds the conv's result and then the biased
    sum, the kernel once; with the rare activation that rounds the other
    way, 3 ulps at max |y|. bf16 with more than 8 output channels must run
    the tensor-core kernel, everything else the other two."""
    x, gw, gb, wt, bias = _conv_case(dev, n, c, h, w, co, dtype)
    kernels.reset_launch_counts()
    got = gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    counts = kernels.launch_counts()
    assert counts["gn_silu_conv3x3"] == counts["gn_scale_shift"] == 1
    assert counts["gn_silu_conv3x3_wgmma"] == int(dtype == torch.bfloat16 and co > 8)
    want = gn_silu_conv3x3_plain(x, gw, gb, wt, bias, 32, 1e-5)
    assert got.dtype == dtype and got.shape == (n, co, h, w)
    torch.testing.assert_close(got.float(), want.float(), atol=_conv_limit(want), rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c,h,w,co", [
    (5, 320, 64, 64, 160),   # the UNet's 320 over 2 ranks: a partial 128-wide wgmma tile
    (5, 320, 64, 64, 80),    # ... over 4
    (5, 2560, 8, 8, 640),    # its 1280 at 8 x 8 over 2
    (5, 2560, 8, 8, 320),    # ... over 4
    (5, 256, 64, 64, 128),   # the struct-cond's 256 over 2
    (5, 512, 64, 64, 256),   # the VAE decoder's 512 over 2
])
def test_gn_silu_conv_at_a_rank_s_output_widths(dev, n, c, h, w, co, dtype):
    """Kernel 7 on a rank's rows of a conv split by tensor-parallel
    training (a parameter of its own, as ``shard_module`` makes it) and the
    whole input, against the plain version at the limits above; after an
    in-place update of the rows (the trainer copies its masters in so), the
    re-laid weight follows."""
    x, gw, gb, wt, bias = _conv_case(dev, n, c, h, w, co, dtype)
    rows = torch.nn.Parameter(wt.clone())
    with torch.no_grad():
        for scale in (1.0, 0.5):
            rows.copy_(wt * scale)
            got = gn_silu_conv3x3(x, gw, gb, rows, bias, 32, 1e-5)
            want = gn_silu_conv3x3_plain(x, gw, gb, wt * scale, bias, 32, 1e-5)
            assert got.shape == (n, co, h, w)
            torch.testing.assert_close(got.float(), want.float(), atol=_conv_limit(want), rtol=0)


def _conv_case(dev, n, c, h, w, co, dtype, mean=0.3):
    gen = _gen(dev, n + c + h + w + co)
    x = (torch.randn(n, c, h, w, device=dev, generator=gen) * 1.5 + mean).to(dtype)
    gw = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
    gb = 0.1 * torch.randn(c, device=dev, generator=gen)
    wt = (torch.randn(co, c, 3, 3, device=dev, generator=gen) * (9 * c) ** -0.5).to(dtype)
    bias = 0.1 * torch.randn(co, device=dev, generator=gen)
    return x, gw, gb, wt, bias


def _conv_limit(want):
    rel = {torch.float32: 1e-4, torch.bfloat16: 3 * 2 ** -8, torch.float16: 3 * 2 ** -11}
    return rel[want.dtype] * float(want.float().abs().max())


def test_gn_silu_conv_mma_kernel_matches_the_wgmma_kernel(dev):
    """The ``mma.sync`` kernel, which bf16 keeps for up to 8 output channels
    and fp16 for all, against the tensor-core kernel on the same bf16 chain:
    both sum bf16 products in fp32, in another order, and they round SiLU by
    two formulas (exp and divide there, tanh here), so an output may land on
    the neighbouring bf16: 2 ulps at max |y| (one whole step of the largest
    outputs)."""
    x, gw, gb, wt, bias = _conv_case(dev, 2, 320, 32, 32, 320, torch.bfloat16)
    new = gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    scale, shift = gn_scale_shift(x, gw, gb, 32, 1e-5)
    old = torch.empty_like(new)
    _build.check(_build.library().mgld_gn_silu_conv_bf16(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), wt.data_ptr(), bias.data_ptr(),
        old.data_ptr(), 2, 320, 32, 32, 320, _build.stream_ptr(dev)), "mgld_gn_silu_conv_bf16")
    torch.testing.assert_close(old.float(), new.float(),
                               atol=2 * 2 ** -8 * float(new.abs().max()), rtol=0)


@pytest.mark.parametrize("shape,dtype,eps,mean", [
    ((5, 320, 64, 64), torch.bfloat16, 1e-5, 0.5),
    ((2, 960, 32, 32), torch.bfloat16, 1e-6, 0.5),
    ((2, 128, 130, 70), torch.bfloat16, 1e-6, 0.5),   # long slabs, 8 blocks each, ragged shares
    ((3, 96, 7, 9), torch.float16, 1e-5, 0.5),        # slabs off the 16-byte vectors
    ((2, 64, 13, 11), torch.float32, 1e-5, 0.5),
    ((1, 64, 128, 128), torch.float32, 1e-5, 0.5),
    ((2, 64, 16, 16), torch.float32, 1e-5, 300.0),    # mean >> std: E[x^2] - E[x]^2 cancels
])
def test_gn_scale_shift_kernel_matches_plain(dev, shape, dtype, eps, mean):
    """The folded scale and shift in one launch (a cluster of blocks a slab)
    against the plain version: 1e-5 of the largest scale and shift (fp32 sums
    in another order). At mean >> std the variance is a difference of nearly
    equal fp32 numbers and may clip at 0 in one order and not in the other,
    so there only the clipping is held: finite, and no scale above
    rsqrt(eps)."""
    gen = _gen(dev, sum(shape))
    x = (torch.randn(shape, device=dev, generator=gen) * 2 + mean).to(dtype)
    w = torch.randn(shape[1], device=dev, generator=gen)
    b = torch.randn(shape[1], device=dev, generator=gen)
    kernels.reset_launch_counts()
    scale, shift = gn_scale_shift(x, w, b, 32, eps)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {"gn_scale_shift": 1}
    assert scale.shape == shift.shape == shape[:2] and scale.dtype == torch.float32
    assert torch.isfinite(scale).all() and torch.isfinite(shift).all()
    if mean > 100:
        assert float((scale.abs() / w.abs()).max()) <= 1.001 * eps ** -0.5
        return
    for got, want in zip((scale, shift), gn_scale_shift_plain(x, w, b, 32, eps)):
        torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=1e-5)


def test_gn_silu_conv_with_a_clipped_variance(dev):
    """x = a large constant plus a little noise: E[x^2] - E[x]^2 is negative
    in fp32 for some groups and clips at 0. The kernel's chain and the plain
    version see the same x but sum in another order, so they are compared
    through their own statistics: the conv kernel on the plain version's
    scale and shift must equal the plain version."""
    x, gw, gb, wt, bias = _conv_case(dev, 2, 64, 16, 16, 64, torch.bfloat16, mean=300.0)
    got = gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    assert torch.isfinite(got).all()
    scale, shift = (t.contiguous() for t in gn_scale_shift_plain(x, gw, gb, 32, 1e-5))
    out = torch.empty_like(got)
    relaid = conv_mod.relaid_weight(wt)
    _build.check(_build.library().mgld_gn_silu_conv_wgmma_bf16(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), relaid.data_ptr(), bias.data_ptr(),
        out.data_ptr(), 2, 64, relaid.shape[2], 16, 16, 64, _build.stream_ptr(dev)), "conv")
    want = gn_silu_conv3x3_plain(x, gw, gb, wt, bias, 32, 1e-5)
    torch.testing.assert_close(out.float(), want.float(), atol=_conv_limit(want), rtol=0)


def test_relaid_weight_on_card(dev):
    """[Co,C,3,3] -> [9,Co,Cp] bit for bit a permute, zero beyond C; made once,
    reused, and made again after an in-place update or a load_state_dict."""
    conv = torch.nn.Conv2d(96, 40, 3, padding=1).to(dev).to(torch.bfloat16)
    made = conv_mod._derived.made
    relaid = conv_mod.relaid_weight(conv.weight)
    assert relaid.shape == (9, 40, 128) and relaid.data_ptr() % 16 == 0
    assert torch.equal(relaid[:, :, :96], conv.weight.detach().permute(2, 3, 0, 1).reshape(9, 40, 96))
    assert not relaid[:, :, 96:].any()
    assert conv_mod.relaid_weight(conv.weight) is relaid and conv_mod._derived.made == made + 1
    with torch.no_grad():
        conv.weight.mul_(2)
    again = conv_mod.relaid_weight(conv.weight)
    assert again is not relaid and torch.equal(again, relaid * 2)
    conv.load_state_dict({k: torch.zeros_like(v) for k, v in conv.state_dict().items()})
    assert not conv_mod.relaid_weight(conv.weight).any() and conv_mod._derived.made == made + 3


def test_fused_chain_is_two_launches_and_copies_nothing(dev):
    """A warm bf16 chain with a bf16 conv bias, as the full-width towers run
    it: the statistics kernel, the conv kernel, and nothing laid out anew."""
    x, gw, gb, wt, bias = _conv_case(dev, 5, 320, 64, 64, 320, torch.bfloat16)
    bias = bias.to(torch.bfloat16)
    want = gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    made = conv_mod._derived.made
    kernels.reset_launch_counts()
    got = gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    counts = kernels.launch_counts()
    assert torch.equal(got, want) and conv_mod._derived.made == made
    assert {k: v for k, v in counts.items() if v} == {
        "gn_scale_shift": 1, "gn_silu_conv3x3": 1, "gn_silu_conv3x3_wgmma": 1}


@pytest.mark.parametrize("n,c,h,w,co,dtype", [
    (5, 320, 64, 64, 320, torch.bfloat16),   # wgmma, 8 x 16 tiles
    (2, 1280, 8, 8, 96, torch.bfloat16),     # wgmma, 8 x 8 tiles, a cluster splitting K
    (2, 64, 16, 16, 4, torch.bfloat16),      # mma.sync (few output channels)
    (2, 64, 16, 16, 32, torch.float16),      # mma.sync
    (2, 64, 16, 8, 96, torch.float32),       # fma
])
def test_chain_in_one_call_equals_the_two_launches(dev, n, c, h, w, co, dtype):
    """The chain's one C call (statistics, then the conv kernel) equals
    ``gn_scale_shift`` followed by the conv kernel alone, bit for bit, and
    counts one launch of each."""
    x, gw, gb, wt, bias = _conv_case(dev, n, c, h, w, co, dtype)
    kernels.reset_launch_counts()
    got = gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    wgmma = conv_mod.kernel_variant(dtype, co) == "wgmma"
    assert counts == {"gn_scale_shift": 1, "gn_silu_conv3x3": 1,
                      **({"gn_silu_conv3x3_wgmma": 1} if wgmma else {})}
    scale, shift = gn_scale_shift(x, gw, gb, 32, 1e-5)
    want = torch.empty_like(got)
    if wgmma:
        relaid = conv_mod.relaid_weight(wt)
        err = _build.library().mgld_gn_silu_conv_wgmma_bf16(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), relaid.data_ptr(),
            bias.data_ptr(), want.data_ptr(), n, c, relaid.shape[2], h, w, co,
            _build.stream_ptr(dev))
    else:
        err = getattr(_build.library(), conv_mod._ENTRY[dtype])(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), wt.data_ptr(), bias.data_ptr(),
            want.data_ptr(), n, c, h, w, co, _build.stream_ptr(dev))
    _build.check(err, "conv")
    assert torch.equal(got, want)
    torch.testing.assert_close(got.float(), gn_silu_conv3x3_plain(x, gw, gb, wt, bias).float(),
                               atol=_conv_limit(got), rtol=0)


def test_new_kernels_gradients_on_card(dev):
    """Forward the kernel, backward autograd of the plain/reference form:
    gradients equal those of the plain version within fp32 noise."""
    gen = _gen(dev, 7)
    x = torch.randn(2, 64, 8, 8, device=dev, generator=gen)
    gw, gb = (torch.randn(64, device=dev, generator=gen) for _ in range(2))
    wt = torch.randn(32, 64, 3, 3, device=dev, generator=gen) * 0.05
    bias = torch.randn(32, device=dev, generator=gen)
    for fn, plain, args in (
            (fused_group_norm, fused_group_norm_plain, (x, gw, gb)),
            (gn_silu_conv3x3, gn_silu_conv3x3_plain, (x, gw, gb, wt, bias))):
        grads = []
        for f in (fn, plain):
            leaves = [a.clone().requires_grad_(True) for a in args]
            f(*leaves).square().sum().backward()
            grads.append([a.grad for a in leaves])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, atol=2e-3 * float(b.abs().max()), rtol=0)


def test_new_kernels_raise_on_non_contiguous_input(dev):
    """No fallback: a CUDA tensor the kernel does not take raises."""
    x = torch.randn(2, 8, 8, 64, device=dev).permute(0, 3, 1, 2)  # NCHW view of NHWC
    gw, gb = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    wt, bias = torch.randn(16, 64, 3, 3, device=dev), torch.zeros(16, device=dev)
    before = kernels.launch_counts()
    with pytest.raises(ValueError):
        fused_group_norm(x, gw, gb)
    with pytest.raises(ValueError):
        gn_silu_conv3x3(x, gw, gb, wt, bias)
    with pytest.raises(TypeError):
        gn_silu_conv3x3(x.contiguous(), gw, gb, wt.to(torch.bfloat16), bias)
    with pytest.raises(ValueError):  # GroupNorm's affine is float32: no copy is made for it
        gn_silu_conv3x3(x.contiguous(), gw.double(), gb.double(), wt, bias)
    with pytest.raises(ValueError):
        fused_group_norm(x.contiguous(), gw.bfloat16(), gb.bfloat16())
    with pytest.raises(ValueError):
        fused_group_norm(x.contiguous(), gw, gb.cpu())
    with pytest.raises(ValueError):
        fused_group_norm(x.contiguous()[:, :, :0], gw, gb)
    assert kernels.launch_counts() == before


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

    chip_smoke.phase3(0, "test", fused=False)
    assert kernels.launch_counts()["attention"] > 0
    assert kernels.launch_counts()["gn_silu_conv3x3"] == 0


def test_tiny_restore_fused_configuration_matches_cpu(dev):
    """The same under MGLD_FUSED_GN_CONV=1: the fused kernel on the card
    against its plain version on the CPU."""
    import chip_smoke

    chip_smoke.phase3(0, "test", fused=True)
    assert kernels.launch_counts()["gn_silu_conv3x3"] > 0


# the guidance pair at the restore's shape (1 window of 5 frames, 64x64x4
# latents, held as NHWC views of NCHW memory as the sampler holds them), the
# same packed NHWC, two windows at t = 3 and t = 2, 3 channels, masks all 0
# and all 1, and flows that push every tap outside
GUIDANCE_CASES = [(1, 5, 4, "random"), (1, 5, 4, "packed"), (2, 3, 4, "random"),
                  (2, 2, 4, "random"), (1, 5, 3, "random"), (1, 5, 3, "packed"),
                  (1, 5, 4, "none occluded"), (1, 5, 4, "all occluded"), (1, 5, 4, "taps outside")]
# latents [b*t, h, w, c] of which one tensor the kernels index reaches 2^31
# elements: the cotangent scratch (t = 32 aligned: 62 warps), the flows
# (c = 1) or the latents themselves
GUIDANCE_TOO_LARGE = [((32, 3000, 3000, 4), 32, "aligned"), ((32, 5900, 5900, 1), 32, "reference"),
                      ((1, 46341, 46341, 1), 1, "reference")]


def _guidance_case(dev, b, t, c, case, h=64, w=64, seed=0):
    import chip_smoke

    return chip_smoke.guidance_inputs(b, t, c, case, dev, _gen(dev, seed), h, w)


@pytest.mark.parametrize("mode", ["reference", "aligned"])
@pytest.mark.parametrize("b,t,c,case", GUIDANCE_CASES)
def test_guidance_pair_matches_plain(dev, mode, b, t, c, case):
    """Launch A equals its plain version bit for bit (the same tap and loss
    arithmetic, no contraction); A then B equals ``guidance_grad_plain``
    within 1e-6 of max |want| (B's atomics add in a varying order); one
    launch each, none of B where the loss has no warps; the gradient, and each
    slot of the cotangent scratch, has the latents' strides."""
    lat, flows, occs = _guidance_case(dev, b, t, c, case)
    kernels.reset_launch_counts()
    grad, cot = guide_mod.guidance_residual(lat, flows, occs, t, mode)
    assert grad.stride() == lat.stride() and cot.stride()[1:] == lat.stride()
    want_direct, want_cot = guide_mod.guidance_residual_plain(lat, flows, occs, t, mode)
    assert torch.equal(grad, want_direct) and torch.equal(cot, want_cot)
    got = guide_mod.guidance_scatter(grad, cot, flows, t, mode)
    want = guide_mod.guidance_grad_plain(lat, flows, occs, t, mode)
    torch.testing.assert_close(got, want, atol=1e-6 * float(want.abs().max()), rtol=0)
    slots = guide_mod.warp_slots(t, mode)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        "guidance_residual": 1, **({"guidance_scatter": 1} if slots else {})}
    torch.testing.assert_close(guide_mod.guidance_grad(lat, flows, occs, t, mode), want,
                               atol=1e-6 * float(want.abs().max()), rtol=0)
    assert bool(want.any()) == (case != "all occluded")


def test_guidance_raises_on_what_it_does_not_take(dev):
    """No fallback: float32 only, one device, contiguous, shapes as
    documented, t dividing the frames, a known mode, no tensor past 32-bit
    offsets (the cotangent scratch and the flows included), no gradient asked
    of the kernels; nothing is launched."""
    lat, flows, occs = _guidance_case(dev, 1, 5, 4, "random", h=8, w=8)
    before = kernels.launch_counts()
    with pytest.raises(RuntimeError, match="guidance_grad"):
        guide_mod.guidance_grad(lat.clone().requires_grad_(True), flows, occs, 5)
    for shape, t, mode in GUIDANCE_TOO_LARGE:  # shapes only: nothing is allocated
        big = [torch.empty(shape, device="meta")]
        b, h, w = shape[0] // t, shape[1], shape[2]
        big += [torch.empty(b, t - 1, h, w, k, device="meta") for k in (2, 2, 1, 1)]
        with pytest.raises(ValueError, match="32 bits"):
            guide_mod.guidance_grad(big[0], big[1:3], big[3:], t, mode)
    with pytest.raises(TypeError):
        guide_mod.guidance_grad(lat.double(), flows, occs, 5)
    with pytest.raises(ValueError):
        guide_mod.guidance_grad(lat, (flows[0].cpu(), flows[1]), occs, 5)
    with pytest.raises(ValueError):  # not dense: the gradient could not share its strides
        guide_mod.guidance_grad(torch.randn(5, 8, 8, 8, device=dev)[..., :4], flows, occs, 5)
    with pytest.raises(ValueError):  # frames not outermost
        guide_mod.guidance_grad(lat.transpose(0, 1).contiguous().transpose(0, 1), flows, occs, 5)
    with pytest.raises(ValueError):
        guide_mod.guidance_grad(lat, (flows[0].transpose(2, 3), flows[1]), occs, 5)
    with pytest.raises(ValueError):
        guide_mod.guidance_grad(lat, flows, (occs[0][..., 0], occs[1]), 5)
    with pytest.raises(ValueError):
        guide_mod.guidance_grad(lat, flows, occs, 3)
    with pytest.raises(ValueError):
        guide_mod.guidance_grad(lat, flows, occs, 5, "sideways")
    grad, cot = guide_mod.guidance_residual(lat, flows, occs, 5)
    with pytest.raises(ValueError):
        guide_mod.guidance_scatter(grad, cot[:, :3], flows, 5)
    with pytest.raises(ValueError):  # the scratch in another layout than the gradient's
        guide_mod.guidance_scatter(grad, cot.contiguous(), flows, 5)
    assert kernels.launch_counts() == {**before, "guidance_residual": before["guidance_residual"] + 1}


def test_kernels_without_a_gradient_raise_when_asked_for_one(dev):
    """``warp_forward`` and ``lookup_corr`` have no backward: a CUDA call that
    autograd would differentiate raises instead of returning a tensor with no
    graph. Without grad mode they run; ``flow_warp_guided`` differentiates."""
    x = torch.randn(2, 8, 8, 4, device=dev, requires_grad=True)
    flow = torch.zeros(2, 8, 8, 2, device=dev)
    with pytest.raises(RuntimeError, match="warp_forward"):
        warp_forward(x, flow)
    with torch.no_grad():
        assert torch.equal(warp_forward(x, flow), x)
    flow_warp_guided(x, flow).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    level = torch.randn(1, 16, 4, 4, device=dev, requires_grad=True)
    coords = torch.rand(1, 4, 4, 2, device=dev) * 4
    with pytest.raises(RuntimeError, match="lookup_corr"):
        lookup_corr([level], coords, 2)
    with pytest.raises(RuntimeError, match="lookup_corr"):
        lookup_corr([level.detach()], coords.requires_grad_(True), 2)
    with torch.no_grad():
        lookup_corr([level], coords, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_gradient_on_card(dev, dtype):
    """Forward the kernel, backward autograd of the plain version: the
    input gradients are those of the plain version, whose backward the
    Function replays on the same inputs (1e-5 of the largest, for a replay
    that may pick other library kernels). fp16 raises with a message that
    names what to use."""
    gen = _gen(dev, 3)
    q, k, v, g = (torch.randn(2, 256, 64, device=dev, generator=gen).to(dtype) for _ in range(4))
    grads = []
    for fn in (attention, attention_plain):
        leaves = [z.clone().requires_grad_(True) for z in (q, k, v)]
        (fn(*leaves).float() * g.float()).sum().backward()
        grads.append([z.grad for z in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5 * float(b.float().abs().max()), rtol=0)
    with pytest.raises(TypeError, match="fp16 is not supported on the card; use bf16 or fp32"):
        attention(q.half(), k.half(), v.half())


def _tiny_bf16_trainer(dev, grad_accum):
    """The command line's tiny preset in bf16 on the card, seeded, jittered,
    and its stage-1 trainer."""
    from mgldvsr_tpu_torch.cli.infer import tiny_pipeline_config
    from mgldvsr_tpu_torch.io.init_weights import jitter_weights
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights
    from mgldvsr_tpu_torch.train.trainer import Stage1Config, Stage1Trainer

    pipe = MGLDVSRPipeline(tiny_pipeline_config(torch.bfloat16), device=dev)
    init_pipeline_weights(pipe, 0)
    jitter_weights(pipe, 0.02, 0)
    return Stage1Trainer(pipe, Stage1Config(grad_accum=grad_accum))


def _frames(dev, seed, size=64):
    return torch.rand(5, size, size, 3, device=dev, generator=_gen(dev, seed))


def test_trainer_keeps_fp32_masters_and_compute_copies(dev):
    """The masters are float32, the towers' trainable convs and linears
    bf16; an applied update leaves each tower weight equal to its master
    cast to the tower's dtype, and the frozen towers untouched."""
    from mgldvsr_tpu_torch.train.trainer import partition_params

    tr = _tiny_bf16_trainer(dev, grad_accum=1)
    state = tr.init_state()
    train, frozen = partition_params(tr.pipe)
    assert all(m.dtype == torch.float32 for m in state.trainable.values())
    assert {p.dtype for p in train.values()} == {torch.bfloat16, torch.float32}
    frozen0 = {k: p.clone() for k, p in frozen.items()}
    masters0 = {k: m.clone() for k, m in state.trainable.items()}
    state, metrics = tr.train_step(state, _frames(dev, 1), _frames(dev, 2), _gen(dev, 3))
    assert torch.isfinite(metrics["loss"])
    moved = sum(not torch.equal(masters0[k], m) for k, m in state.trainable.items())
    assert moved > 0.9 * len(masters0)
    for k, p in train.items():
        assert torch.equal(p, state.trainable[k].to(p.dtype)), k
    assert all(torch.equal(frozen0[k], p) for k, p in frozen.items())


def test_gradient_accumulator_is_fp32_mean(dev):
    """Three micro-steps at grad_accum 4: the accumulator is float32 and
    holds the mean of the three float32 gradients (the towers do not change
    in between), to float32 rounding."""
    tr = _tiny_bf16_trainer(dev, grad_accum=4)
    state = tr.init_state()
    lq, gt = _frames(dev, 1), _frames(dev, 2)
    grads = []
    for s in range(3):
        draws = tr.draws(5, 8, 8, _gen(dev, 10 + s))
        grads.append(tr.loss_and_grads(lq, gt, draws)[2])
        state, _ = tr.train_step(state, lq, gt, draws=draws)
    for k, acc in state.opt_state["acc"].items():
        assert acc.dtype == torch.float32
        want = (grads[0][k] + grads[1][k] + grads[2][k]) / 3
        torch.testing.assert_close(acc, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()) + 1e-12)


def test_relaid_weight_cache_after_updates(dev):
    """A trainable bf16 conv weight updated in place (as the trainer loads
    its masters): the tensor-core conv re-lays it once per update, keeps one
    entry per weight, and computes with the new weight."""
    gen = _gen(dev, 5)
    x = torch.randn(2, 64, 16, 16, device=dev, generator=gen).bfloat16()
    gw, gb = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    w = (0.05 * torch.randn(64, 64, 3, 3, device=dev, generator=gen)).bfloat16()
    b = torch.zeros(64, device=dev)
    entries0, _ = conv_mod.derived_bytes()
    for update in range(3):
        made = conv_mod._derived.made
        out = gn_silu_conv3x3(x, gw, gb, w, b)
        assert conv_mod._derived.made == made + 1
        gn_silu_conv3x3(x, gw, gb, w, b)
        assert conv_mod._derived.made == made + 1  # warm: no new copy
        assert conv_mod.derived_bytes()[0] == entries0 + 1
        want = gn_silu_conv3x3_plain(x, gw, gb, w, b)
        torch.testing.assert_close(out.float(), want.float(), rtol=0,
                                   atol=3 * 2 ** -8 * float(want.float().abs().max()))
        with torch.no_grad():
            w.copy_(w * 1.5 + 0.01)


def test_ewarp_on_card_launches_kernels_and_matches_cpu(dev):
    """E*warp of a seeded tiny RAFT on the card: one warp launch for every
    pair, one lookup launch an iteration for each group of pairs, and the
    CPU's plain versions' value within 1e-5 relative."""
    from mgldvsr_tpu_torch.flow.raft import RAFT, RAFTConfig
    from mgldvsr_tpu_torch.metrics.temporal import calculate_ewarp
    from mgldvsr_tpu_torch.tools.quality_eval import seeded

    raft = seeded(RAFT(RAFTConfig(iters=3))).eval()
    with torch.no_grad():
        raft.update_block.flow_head.conv2.weight.mul_(1e-2)
    clip = torch.rand(5, 64, 96, 3, generator=torch.Generator().manual_seed(3))
    want = calculate_ewarp(clip, raft, chunk_pairs=8)
    kernels.reset_launch_counts()
    got = calculate_ewarp(clip, raft.to(dev), chunk_pairs=8, device=dev)
    counts = kernels.launch_counts()
    assert counts["warp_forward"] == 1 and counts["corr_lookup"] == 3
    assert sum(counts.values()) == 4
    assert want > 0 and abs(got - want) <= 1e-5 * want, (got, want)


@pytest.mark.parametrize("shape", [(1, 64, 64, 4), (1, 37, 53, 4)])
def test_boundary_grad_matches_plain(dev, shape):
    """The window-parallel boundary term's gradient on the card (the warp
    by ``warp_forward``) against autograd of its plain loss, at the restore's
    [1,64,64,4] and an odd size; within 1e-6 of max |grad|."""
    from mgldvsr_tpu_torch.parallel import sharded_sampler as ss

    gen = _gen(dev, 5)
    last = torch.randn(*shape, device=dev, generator=gen)
    nb = torch.randn(*shape, device=dev, generator=gen)
    bflow = torch.randn(*shape[:3], 2, device=dev, generator=gen) * 3
    bocc = (torch.rand(*shape[:3], 1, device=dev, generator=gen) > 0.7).float()
    kernels.reset_launch_counts()
    got = ss.boundary_grad(last, nb, bflow, bocc)
    assert kernels.launch_counts()["warp_forward"] == 1
    leaf = last.clone().requires_grad_(True)
    ss.boundary_loss_plain(leaf, nb, bflow, bocc).backward()
    g_max = float(leaf.grad.abs().max())
    assert g_max > 0
    torch.testing.assert_close(got, leaf.grad, atol=1e-6 * g_max, rtol=0)


def test_exchange_first_in_a_world_of_one_nccl_rank(dev, tmp_path, monkeypatch):
    """One NCCL rank on the card: the group is NCCL on cuda:0, and the halo
    exchange sends and receives nothing (no right neighbour: zeros,
    has_right 0)."""
    import datetime

    from mgldvsr_tpu_torch.parallel import mesh
    from mgldvsr_tpu_torch.parallel.sharded_sampler import exchange_first

    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    device = mesh.init_group("cuda", f"file://{tmp_path / 'store'}",
                             timeout=datetime.timedelta(seconds=120))
    try:
        assert device == torch.device("cuda", 0)
        assert torch.distributed.get_backend() == "nccl"
        first = torch.ones(1, 64, 64, 4, device=device)
        nb, has_right = exchange_first(first)
        mesh.barrier()
        assert has_right == 0 and nb.shape == first.shape and not nb.any()
        assert mesh.subgroup(1) is torch.distributed.group.WORLD
    finally:
        mesh.destroy()


def test_guidance_gradient_is_the_same_bit_for_bit_every_call(dev):
    """Launch B sums in fixed point, so the gradient does not depend on the
    order its atomics land in: ten calls on the restore's latents give the
    same bits (float atomics gave ~5e-11 between calls)."""
    gen = _gen(dev, 7)
    lat = torch.randn(5, 4, 64, 64, device=dev, generator=gen).permute(0, 2, 3, 1)
    flows = tuple(torch.randn(1, 4, 64, 64, 2, device=dev, generator=gen) for _ in range(2))
    occs = tuple((torch.rand(1, 4, 64, 64, 1, device=dev, generator=gen) > 0.8).float()
                 for _ in range(2))
    first = guide_mod.guidance_grad(lat, flows, occs, 5)
    assert first.any()
    for _ in range(10):
        assert torch.equal(guide_mod.guidance_grad(lat, flows, occs, 5), first)


def _world_of_one_nccl(monkeypatch, tmp_path):
    import datetime

    from mgldvsr_tpu_torch.parallel import mesh

    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    return mesh.init_group("cuda", f"file://{tmp_path / 'store'}",
                           timeout=datetime.timedelta(seconds=120))


def test_all_reduce_mean_in_a_world_of_one_nccl_rank_is_identity(dev, tmp_path, monkeypatch):
    """One NCCL rank: the bucketed mean of a gradient-like dict (float32
    leaves of odd sizes, a 0-dim one) gives the same tensors bit for bit,
    and so does ZeRO-1's reduction (nothing splits in a world of one)."""
    from mgldvsr_tpu_torch.parallel import mesh

    device = _world_of_one_nccl(monkeypatch, tmp_path)
    try:
        gen = _gen(device, 3)
        grads = {f"g{i}": torch.randn(shape, device=device, generator=gen)
                 for i, shape in enumerate([(320, 320, 3, 3), (1280,), (7, 5), (), (3, 8, 1, 1)])}
        out = mesh.all_reduce_mean(grads)
        assert list(out) == list(grads)
        assert all(torch.equal(out[k], v) for k, v in grads.items())
        zero = mesh.ZeroShard({k: v.shape for k, v in grads.items()}, zero1=True)
        assert not zero.axes
        assert all(torch.equal(v, grads[k]) for k, v in zero.reduce_gradients(grads).items())
    finally:
        mesh.destroy()


def test_flax_batch_norm_with_a_group_of_one_equals_it_without(dev, tmp_path, monkeypatch):
    """The discriminator's BatchNorm over a group of one NCCL rank: the
    output, its gradients and the running statistics equal the pass
    without a group, bit for bit."""
    from mgldvsr_tpu_torch.models.discriminator import FlaxBatchNorm
    from mgldvsr_tpu_torch.parallel import mesh

    device = _world_of_one_nccl(monkeypatch, tmp_path)
    try:
        x = torch.randn(10, 256, 15, 15, device=device, generator=_gen(device, 4))
        outs = []
        for group in (None, torch.distributed.group.WORLD):
            bn = FlaxBatchNorm(256).to(device)
            xi = x.clone().requires_grad_(True)
            y = bn(xi, True, group)
            (y * y.detach().flip(0)).sum().backward()
            outs.append((y.detach(), xi.grad, bn.weight.grad, bn.running_mean.clone(),
                         bn.running_var.clone()))
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    finally:
        mesh.destroy()
