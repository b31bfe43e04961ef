"""int8 3x3 convolution (``MGLD_INT8_CONV=1``), its kernels and its plain
version.

The JAX package's ``Int8Conv3x3`` (``mgldvsr_tpu/models/layers.py:163``)
quantizes the input with one dynamic scale over the whole tensor and the
weight with one scale an output channel, sums int8 x int8 products in int32,
and dequantises in float32 before adding the bias. It reaches no Pallas
kernel (XLA convolves the int8 operands); no PyTorch call convolves int8 on
CUDA, so the card runs two kernels of ``csrc/int8_conv.cu`` from one host
call: ``int8_absmax`` (max|x| over the whole tensor, after a 4-byte memset
of its scratch) and ``int8_conv3x3`` (an implicit GEMM on ``mma.sync``
s8 x s8 -> s32 that quantizes the input while staging it and dequantises,
adds the bias and casts in its epilogue). The wrapper counts one launch of
each.

The arithmetic, exactly as the JAX module's, step by step:

- ``sx = max(max|x|, 1e-6) / 127`` in float32 (the max in x's own type);
- ``xq = clip(round(float32(x) / sx), -127, 127)``, rounding half to even;
- ``sw[c] = max(max|k[c]|, 1e-12) / 127`` and ``kq = clip(round(k / sw),
  -127, 127)`` from the **float32** weight (:func:`quantize_weight`);
- ``acc = sum xq * kq`` in int32, exact (the plain version sums the levels
  in float64: every partial sum is an integer below 2^53);
- ``y = float32(acc) * (sx * sw) + b``, each operation rounded once, then
  the cast to the output type.

So kernel and plain version agree bit for bit. A CPU tensor takes the plain
version; a CUDA tensor launches the kernels or raises. There is no
gradient: the JAX module's gradient reaches only the scales and the bias
(``round`` has none), and the port raises where one would be recorded
(:class:`mgldvsr_tpu_torch.models.layers.Int8Conv3x3`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mgldvsr_tpu_torch.ops.kernels import _build
from mgldvsr_tpu_torch.ops.kernels.gn_silu_conv import _derived

STAGE_CHANNELS = 32  # input channels a stage of the conv kernel (the K of m16n8k32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(``kq`` int8 [Co, C, 3, 3], ``sw`` float32 [Co]) of a float32 weight
    [Co, C, 3, 3]; raises on any other type (a weight rounded to bf16 lands
    many levels one step away)."""
    if weight.dtype != torch.float32:
        raise TypeError(f"quantize_weight: the levels come from the float32 weight, got "
                        f"{weight.dtype}")
    k = weight.detach()
    peak = k.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12)
    sw = peak / _levels_of(peak)
    kq = torch.round(k / sw.reshape(-1, 1, 1, 1)).clamp(-127, 127).to(torch.int8)
    return kq, sw


def _levels_of(t: torch.Tensor) -> torch.Tensor:
    """127 as a tensor on ``t``'s device. Divide by it, never by the number:
    on CUDA PyTorch turns a division by a Python number into a product with
    its rounded reciprocal, a scale one ulp off the JAX module's now and
    then."""
    return t.new_tensor(127.0)


def weight_levels(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_weight` of a float32 weight, cached until the weight
    changes (in place or by ``load_state_dict``)."""
    return _derived(weight, "int8", quantize_weight)


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(``xq`` int8, ``sx`` float32 0-d) of x with one scale over the whole
    tensor."""
    amax = x.detach().abs().amax().float()
    sx = torch.maximum(amax, amax.new_tensor(1e-6)) / _levels_of(amax)
    return torch.round(x.detach().float() / sx).clamp(-127, 127).to(torch.int8), sx


def int8_accumulate(xq: torch.Tensor, kq: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The int32 sums of the 3x3 conv of levels ``xq`` [N,C,H,W] with levels
    ``kq`` [Co,C,3,3], zero padding 1 (exact: float64 holds every sum)."""
    acc = F.conv2d(xq.double(), kq.double(), None, stride=stride, padding=1)
    return acc.to(torch.int32)


def dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """``float32(acc) * (sx * sw) + bias``, one rounding an operation, cast to
    ``out_dtype``."""
    scale = (sx * sw.float()).reshape(1, -1, 1, 1)
    return (acc.float() * scale + bias.float().reshape(1, -1, 1, 1)).to(out_dtype)


def int8_conv3x3_plain(x: torch.Tensor, kq: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
                       stride: int = 1, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The JAX ``Int8Conv3x3`` on NCHW: quantize, sum the levels, dequantise."""
    xq, sx = quantize_activation(x)
    return dequantize(int8_accumulate(xq, kq, stride), sx, sw, bias, out_dtype or x.dtype)


def relayout_levels(kq: torch.Tensor) -> torch.Tensor:
    """``[Co, C, 3, 3]`` int8 -> ``[9, Co, Cp]``: tap-major, channels
    contiguous, Cp = C rounded up to 32 with zero levels beyond C."""
    co, c = kq.shape[:2]
    cp = -(-c // STAGE_CHANNELS) * STAGE_CHANNELS
    out = kq.new_zeros(9, co, cp)
    out[:, :, :c] = kq.permute(2, 3, 0, 1).reshape(9, co, c)
    return out


def relaid_levels(kq: torch.Tensor) -> torch.Tensor:
    """The cached :func:`relayout_levels` of ``kq``."""
    return _derived(kq, "int8_relaid", relayout_levels)


def output_size(h: int, w: int, stride: int) -> tuple[int, int]:
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def _launch(x, kq, sw, bias, stride: int, out_dtype) -> torch.Tensor:
    n, c, h, w = x.shape
    co = kq.shape[0]
    wq = relaid_levels(kq)
    amax = torch.empty(1, dtype=torch.int32, device=x.device)
    out = torch.empty(n, co, *output_size(h, w, stride), dtype=out_dtype, device=x.device)
    fn, stream = _build.bind("mgld_int8_conv3x3_chain")
    err = fn(x.data_ptr(), _DTYPES[x.dtype], amax.data_ptr(), wq.data_ptr(), sw.data_ptr(),
             bias.data_ptr(), out.data_ptr(), _DTYPES[out_dtype], n, c, wq.shape[2], h, w, co,
             stride, stream(x.get_device()))
    if err:
        _build.check(err, "mgld_int8_conv3x3_chain")
    int8_absmax.launches += 1
    int8_conv3x3.launches += 1
    return out


def int8_conv3x3(x: torch.Tensor, kq: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
                 stride: int = 1, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The int8 conv of a contiguous x [N,C,H,W] (float32, bfloat16 or
    float16) with levels ``kq`` [Co,C,3,3] (int8) and scales ``sw`` [Co]
    (float32, both from :func:`quantize_weight`), float32 ``bias`` [Co],
    zero padding 1, stride 1 or 2; output [N,Co,Ho,Wo] in ``out_dtype``
    (default x's)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_conv3x3_plain(x, kq, sw, bias, stride, out_dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("int8_conv3x3: no gradient (round has none); call it without "
                           "recording one")
    if not (x.is_cuda and x.ndim == 4 and x.is_contiguous() and x.dtype in _DTYPES
            and out_dtype in _DTYPES and stride in (1, 2) and x.shape[0] <= 65535
            and kq.dtype == torch.int8 and kq.ndim == 4 and kq.shape[1:] == (x.shape[1], 3, 3)
            and all(t.device == x.device for t in (kq, sw, bias))
            and sw.dtype == bias.dtype == torch.float32 and sw.is_contiguous()
            and bias.is_contiguous() and sw.shape == bias.shape == (kq.shape[0],)):
        raise ValueError(
            f"int8_conv3x3: need a contiguous CUDA [N<=65535,C,H,W] float32/bfloat16/float16 x, "
            f"int8 levels [Co,C,3,3], contiguous float32 scales and bias [Co] on x's device, "
            f"stride 1 or 2, a float output type; got x {tuple(x.shape)} {x.dtype} on "
            f"{x.device} (contiguous={x.is_contiguous()}), levels {tuple(kq.shape)} {kq.dtype} "
            f"on {kq.device}, scales {tuple(sw.shape)} {sw.dtype}, bias {tuple(bias.shape)} "
            f"{bias.dtype}, stride {stride}, out {out_dtype}")
    return _launch(x, kq, sw, bias, stride, out_dtype)


def int8_absmax(x: torch.Tensor) -> torch.Tensor:
    """max|x| over the whole tensor as float32 [1]: the first kernel of
    :func:`int8_conv3x3`, alone (timing and tests). A CPU tensor takes the
    plain version."""
    if x.device.type == "cpu":
        return x.detach().abs().amax().float().reshape(1)
    if not (x.is_cuda and x.is_contiguous() and x.dtype in _DTYPES):
        raise ValueError(f"int8_absmax: need a contiguous CUDA float32/bfloat16/float16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype} on {x.device}")
    amax = torch.empty(1, dtype=torch.int32, device=x.device)
    fn, stream = _build.bind("mgld_int8_absmax")
    err = fn(x.data_ptr(), _DTYPES[x.dtype], x.numel(), amax.data_ptr(),
             stream(x.get_device()))
    if err:
        _build.check(err, "mgld_int8_absmax")
    int8_absmax.launches += 1
    return amax.view(torch.float32)


def conv_alone(x: torch.Tensor, amax: torch.Tensor, kq: torch.Tensor, sw: torch.Tensor,
               bias: torch.Tensor, stride: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The conv kernel alone on a ready ``amax`` (:func:`int8_absmax`'s
    output) of a contiguous CUDA x, the arguments as :func:`int8_conv3x3`
    checks them (timing and tests; counted as a launch of
    ``int8_conv3x3``)."""
    n, c, h, w = x.shape
    co = kq.shape[0]
    wq = relaid_levels(kq)
    out = torch.empty(n, co, *output_size(h, w, stride), dtype=out_dtype, device=x.device)
    fn, stream = _build.bind("mgld_int8_conv3x3")
    err = fn(x.data_ptr(), _DTYPES[x.dtype], amax.data_ptr(), wq.data_ptr(), sw.data_ptr(),
             bias.data_ptr(), out.data_ptr(), _DTYPES[out_dtype], n, c, wq.shape[2], h, w, co,
             stride, stream(x.get_device()))
    if err:
        _build.check(err, "mgld_int8_conv3x3")
    int8_conv3x3.launches += 1
    return out


int8_absmax.launches = 0
int8_conv3x3.launches = 0
