"""GroupNorm kernels, each beside its plain version: the one-pass channel sums
in Triton; in CUDA C++ the fully fused GroupNorm, and the folded scale and
shift that the fused GroupNorm+SiLU+conv kernel takes.

``channel_sums`` replaces ``mgldvsr_tpu/ops/pallas/groupnorm.py``
``channel_sums`` (kernel ``_stats_kernel``). It is bound by device-memory
bandwidth: one read of a bf16 [N, C, H, W] activation (the VAE's 128^2 to
512^2 levels). Each program reduces one contiguous H*W row of one (n, c) in
fp32 and writes both sums, so the activation is read once and no fp32 copy
of it is ever materialised; the group fold and scale-shift stay in PyTorch
on [N, C] data. Its gradient is the JAX package's formula in plain tensor
code (the JAX backward is plain ``jnp`` too). It is the one Triton kernel of
the port, and ``triton`` is imported only inside its launching function, so
this module imports where Triton is absent.

``fused_group_norm`` replaces ``fused_group_norm`` of the same JAX file
(kernel ``_fused_gn_kernel``). It is bound by device-memory bandwidth too:
the least it can move is one read and one write of the activation. The TPU
kernel held one NHWC sample in fast memory and folded channels into groups
with one-hot matmuls, because its compiler cannot split the lane dimension.
In NCHW one (sample, group) is one contiguous slab of C/G * S elements. The
kernel (``csrc/groupnorm.cu`` ``group_norm_kernel``) gives a slab to a thread
block cluster of 1, 2, 4 or 8 blocks: each block loads its share into shared
memory and sums it in fp32 on the way, the partial sums meet through the
cluster's shared-memory window, and every block writes ``y = x * a_c + b_c``
for its share from shared memory, so x is read once from device memory and
nowhere else. ``fused_gn_plan`` chooses the split (shares of 32 KB and less,
the card's SMs several blocks each, a small slab one block) and whether the
share is staged: one too long for shared memory is walked a second time from
global memory by the same kernel. One ``ctypes`` launch, under half the host
time of the Triton launch it replaced; a default restore makes 5,921 of them.

``gn_scale_shift`` is the statistics half of the fused
GroupNorm+SiLU+conv chain (``mgldvsr_tpu/ops/pallas/gn_silu_conv.py``
``_fused_fwd_impl``, the reduction ahead of its kernel): the fp32
``scale[N, C]`` and ``shift[N, C]`` with ``GroupNorm(x) = x * scale + shift``.
It is bound by one read of x and is one launch of a CUDA C++ kernel
(``csrc/gn_silu_conv.cu`` ``gn_stats_kernel``, beside the conv kernel it
feeds): a cluster of 1 to 8 blocks per (sample, group) slab; a sampler step
of the fused configuration makes 73 of them.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import functools

import torch

from mgldvsr_tpu_torch.ops.kernels import _build

_FLOATS = (torch.bfloat16, torch.float16, torch.float32)


def channel_sums_plain(x: torch.Tensor):
    """Plain version: per-(n, c) fp32 sum and sum of squares over H, W of
    an [N, C, H, W] tensor."""
    xf = x.float()
    return xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))


@functools.cache
def _channel_sums_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def channel_sums_kernel(x_ptr, s1_ptr, s2_ptr, hw, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        base = x_ptr + row.to(tl.int64) * hw
        acc1 = tl.zeros([BLOCK], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, hw, BLOCK):
            offs = start + tl.arange(0, BLOCK)
            v = tl.load(base + offs, mask=offs < hw, other=0.0).to(tl.float32)
            acc1 += v
            acc2 += v * v
        tl.store(s1_ptr + row, tl.sum(acc1, axis=0))
        tl.store(s2_ptr + row, tl.sum(acc2, axis=0))

    return channel_sums_kernel


def _launch_channel_sums(x: torch.Tensor):
    n, c, h, w = x.shape
    s1 = torch.empty(n, c, dtype=torch.float32, device=x.device)
    s2 = torch.empty(n, c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _channel_sums_kernel()[(n * c,)](x, s1, s2, h * w, BLOCK=2048, num_warps=8)
    channel_sums.launches += 1
    return s1, s2


class _ChannelSums(torch.autograd.Function):
    """Forward: the kernel. Backward: d(sum)/dx = 1, d(sumsq)/dx = 2x, in
    fp32, cast to x's dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _launch_channel_sums(x)

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        dx = g1.float()[:, :, None, None] + 2.0 * x.float() * g2.float()[:, :, None, None]
        return dx.to(x.dtype)


def channel_sums(x: torch.Tensor):
    """(sum, sum of squares), each [N, C] float32, of a contiguous
    [N, C, H, W] tensor, reduced over H and W in one read. Differentiable:
    dx = g1 + 2 x g2."""
    if x.device.type == "cpu":
        return channel_sums_plain(x)
    if x.ndim != 4 or not x.is_contiguous() or x.device.type != "cuda":
        raise ValueError(f"channel_sums: need a contiguous CUDA [N,C,H,W] tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    if x.dtype not in _FLOATS:
        raise TypeError(f"channel_sums: floating input only, got {x.dtype}")
    if torch.is_grad_enabled() and x.requires_grad:
        return _ChannelSums.apply(x)
    return _launch_channel_sums(x)


channel_sums.launches = 0


def group_scale_shift(s1: torch.Tensor, s2: torch.Tensor, count: float, weight: torch.Tensor,
                      bias: torch.Tensor, groups: int, eps: float):
    """Fold per-(n, c) fp32 sums into GroupNorm's per-(n, c) fp32 affine
    ``y = x * a + b``: ``var = max(E[x^2] - E[x]^2, 0)``,
    ``inv = rsqrt(var + eps)``, ``a = inv * weight``,
    ``b = bias - mean * inv * weight``. ``count`` is the number of elements
    of one (sample, group)."""
    n, c = s1.shape
    cg = c // groups
    mean = s1.reshape(n, groups, cg).sum(-1, keepdim=True) / count
    var = (s2.reshape(n, groups, cg).sum(-1, keepdim=True) / count - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    a = inv.expand(n, groups, cg).reshape(n, c) * weight.float()
    b = bias.float() - (mean * inv).expand(n, groups, cg).reshape(n, c) * weight.float()
    return a, b


def gn_scale_shift_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         groups: int = 32, eps: float = 1e-5):
    """Plain version: GroupNorm of [N, C, H, W] as fp32 ``(scale, shift)``,
    each [N, C], with ``GroupNorm(x) = x * scale + shift``; the statistics
    are fp32 sums of x as it is, the variance clipped at 0."""
    c = x.shape[1]
    count = float(x[0, 0].numel() * (c // groups))
    return group_scale_shift(*channel_sums_plain(x), count, weight, bias, groups, eps)


_SCALE_SHIFT_ENTRY = {torch.bfloat16: "mgld_gn_scale_shift_bf16",
                      torch.float16: "mgld_gn_scale_shift_f16",
                      torch.float32: "mgld_gn_scale_shift_f32"}
_F32 = torch.float32


def gn_scale_shift(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   groups: int = 32, eps: float = 1e-5):
    """GroupNorm of a contiguous [N, C, H, W] tensor as fp32
    ``(scale, shift)``, each [N, C]: ``GroupNorm(x) = x * scale + shift``,
    in one launch. Contiguous float32 ``weight`` and ``bias`` of [C]. No
    gradient: the fused conv's backward recomputes. The two are the rows of
    one [2, N, C] tensor."""
    if not x.is_cuda and x.device.type == "cpu":
        return gn_scale_shift_plain(x, weight, bias, groups, eps)
    if not (x.is_cuda and x.ndim == 4 and x.is_contiguous() and x.dtype in _SCALE_SHIFT_ENTRY
            and group_affine_ok(x, weight, bias, groups)):
        _check_scale_shift(x, weight, bias, groups)
    n, c, h, w = x.shape
    out = torch.empty(2, n, c, dtype=_F32, device=x.device)
    name = _SCALE_SHIFT_ENTRY[x.dtype]
    fn, stream = _build.bind(name)
    scale = out.data_ptr()
    err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), scale, scale + 4 * n * c, n, c,
             h * w, groups, eps, stream(x.get_device()))
    if err:
        _build.check(err, name)
    gn_scale_shift.launches += 1
    return out.unbind()


def _check_scale_shift(x, weight, bias, groups: int) -> None:
    """Raise with the reason where ``gn_scale_shift`` refuses its input."""
    if x.ndim != 4 or not x.is_contiguous() or x.device.type != "cuda":
        raise ValueError(f"gn_scale_shift: need a contiguous CUDA [N,C,H,W] tensor, got "
                         f"{tuple(x.shape)} (contiguous={x.is_contiguous()}) on {x.device}")
    if x.dtype not in _FLOATS:
        raise TypeError(f"gn_scale_shift: floating input only, got {x.dtype}")
    check_group_affine("gn_scale_shift", x, weight, bias, groups)


def group_affine_ok(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    groups: int) -> bool:
    """Every condition of ``check_group_affine`` as one cheap test."""
    c = x.shape[1]
    return (c % groups == 0 and weight.dtype is _F32 and bias.dtype is _F32
            and weight.shape == (c,) and bias.shape == (c,) and weight.is_contiguous()
            and bias.is_contiguous() and weight.get_device() == x.get_device()
            and bias.get_device() == x.get_device())


def check_group_affine(who: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       groups: int) -> None:
    """Raise unless ``weight`` and ``bias`` are contiguous float32 [C] on x's
    device and ``groups`` divides C: the kernel reads them as they are."""
    c = x.shape[1]
    if c % groups or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{who}: {c} channels, {groups} groups, GroupNorm weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{who}: GroupNorm {name} must be contiguous float32 on x's device, "
                             f"got {t.dtype} (contiguous={t.is_contiguous()}) on {t.device}")


gn_scale_shift.launches = 0


def fused_group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Plain version: GroupNorm of [N, C, *spatial] from fp32 sums of the
    input as it is, the affine folded per (n, c), rounded to x's dtype, and
    one scale-shift in x's dtype. Output dtype = input dtype."""
    n, c = x.shape[:2]
    spatial = tuple(range(2, x.ndim))
    xf = x.float()
    s1 = xf.sum(dim=spatial)
    s2 = (xf * xf).sum(dim=spatial)
    count = float(x[0, 0].numel() * (c // groups))
    a, b = group_scale_shift(s1, s2, count, weight, bias, groups, eps)
    shape = (n, c) + (1,) * (x.ndim - 2)
    return x * a.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         groups: int, eps: float) -> torch.Tensor:
    """Two-pass fp32 GroupNorm cast to x's dtype: the form the fused
    kernel's gradient is taken through (the JAX ``_gn_reference``)."""
    n, c = x.shape[:2]
    xg = x.float().reshape(n, groups, -1)
    mean = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    return (y * weight.float().reshape(shape) + bias.float().reshape(shape)).to(x.dtype)


SM_COUNT = 132                  # of an H100; only the split of slabs among blocks looks at it
GN_SHARE_TARGET = 32 * 1024     # bytes of a share at which several blocks fit an SM
GN_MIN_SHARE = 8 * 1024         # no split leaves a block less than this to read
GN_STAGE_LIMIT = 100 * 1024     # the longest share kept in shared memory: two blocks to an SM
GN_MAX_GROUP_CHANNELS = 4096    # a and b of one group wait in shared memory

_GROUP_NORM_ENTRY = {torch.bfloat16: "mgld_group_norm_bf16",
                     torch.float16: "mgld_group_norm_f16",
                     torch.float32: "mgld_group_norm_f32"}


def fused_gn_plan(slabs: int, slab: int, itemsize: int, cg: int) -> tuple[int, int]:
    """How the fused GroupNorm kernel is launched on ``slabs`` (sample, group)
    slabs of ``slab`` elements of ``itemsize`` bytes, ``cg`` channels a group:
    ``(split, stage_bytes)``. ``split`` blocks, a cluster, share one slab: it
    doubles, up to 8, while a share is above 32 KB or the card's SMs have
    under four blocks each, as long as a block keeps 8 KB to read.
    ``stage_bytes`` is the shared memory that holds one block's share (whole
    16-byte vectors), or 0 where the share is too long to stage and the
    kernel walks it twice."""
    nbytes = slab * itemsize
    split = 1
    while (split < 8 and nbytes >= 2 * split * GN_MIN_SHARE
           and (nbytes > split * GN_SHARE_TARGET or slabs * split < 4 * SM_COUNT)):
        split *= 2
    vec = 16 // itemsize
    share = -(-(-(-slab // split)) // vec) * vec
    stage_bytes = share * itemsize
    return split, stage_bytes if stage_bytes + 8 * cg <= GN_STAGE_LIMIT else 0


def _launch_fused_gn(x, weight, bias, groups: int, eps: float) -> torch.Tensor:
    """The launch without the checks (``fused_group_norm`` made them)."""
    n, c = x.shape[0], x.shape[1]
    cg = c // groups
    s = x.numel() // (n * c)
    split, stage_bytes = fused_gn_plan(n * groups, cg * s, x.element_size(), cg)
    y = torch.empty_like(x)
    name = _GROUP_NORM_ENTRY[x.dtype]
    err = getattr(_build.library(), name)(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), n * groups, cg, s,
        groups, eps, split, stage_bytes, _build.stream_ptr(x.device))
    _build.check(err, name)
    fused_group_norm.launches += 1
    return y


class _FusedGroupNorm(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the two-pass fp32
    GroupNorm on the saved inputs."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.groups, ctx.eps = groups, eps
        return _launch_fused_gn(x, weight, bias, groups, eps)

    @staticmethod
    def backward(ctx, g):
        return (*recompute_grads(
            lambda *a: group_norm_reference(*a, ctx.groups, ctx.eps), ctx.saved_tensors, g,
            ctx.needs_input_grad[:3]), None, None)


def recompute_grads(fn, saved, g, needs):
    """Gradients of ``fn(*saved)`` against the cotangent ``g`` for the inputs
    flagged in ``needs`` (None for the others)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
        out = fn(*leaves)
        wanted = [t for t, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
    return tuple(next(grads) if need else None for need in needs)


def fused_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of a contiguous [N, C, *spatial] tensor in one kernel:
    fp32 statistics per (sample, group), ``y = x * a + b`` in x's dtype.
    Contiguous float32 ``weight`` and ``bias`` of [C]: the kernel reads them
    as they are. Output dtype = input dtype."""
    if x.device.type == "cpu":
        return fused_group_norm_plain(x, weight, bias, groups, eps)
    if x.ndim < 3 or not x.is_contiguous() or x.device.type != "cuda" or x.numel() == 0:
        raise ValueError(f"fused_group_norm: need a contiguous non-empty CUDA [N,C,*spatial] "
                         f"tensor, got {tuple(x.shape)} (contiguous={x.is_contiguous()}) on "
                         f"{x.device}")
    if x.dtype not in _FLOATS:
        raise TypeError(f"fused_group_norm: floating input only, got {x.dtype}")
    check_group_affine("fused_group_norm", x, weight, bias, groups)
    n, c = x.shape[0], x.shape[1]
    if x.numel() // (n * groups) >= 2 ** 31 or c // groups > GN_MAX_GROUP_CHANNELS:
        raise ValueError(f"fused_group_norm: one (sample, group) slab exceeds 2^31 elements or "
                         f"{GN_MAX_GROUP_CHANNELS} channels: {tuple(x.shape)}, {groups} groups")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _FusedGroupNorm.apply(x, weight, bias, groups, eps)
    return _launch_fused_gn(x, weight, bias, groups, eps)


fused_group_norm.launches = 0
