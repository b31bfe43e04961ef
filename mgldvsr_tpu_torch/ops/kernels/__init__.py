"""Hand-written Hopper kernels of the restore path (and of its
``MGLD_INT8_CONV=1`` convs), each beside its plain PyTorch version. Each wrapper counts the launches it makes in an integer
attribute ``launches``; :func:`launch_counts` and
:func:`reset_launch_counts` read and clear them all. The attention wrapper
also counts which of its four kernels ran and how many calls read their
operands in place, and the fused GroupNorm+SiLU+conv wrapper how many of its
launches took the tensor-core kernel."""
from __future__ import annotations

from mgldvsr_tpu_torch.ops.kernels import (
    attention,
    corr_lookup,
    flow_warp,
    gn_silu_conv,
    groupnorm,
    guidance,
    int8_conv,
)

WRAPPERS = {
    "warp_forward": flow_warp.warp_forward,
    "warp_dx": flow_warp.warp_dx,
    "guidance_residual": guidance.guidance_residual,
    "guidance_scatter": guidance.guidance_scatter,
    "attention": attention.attention,
    "corr_lookup": corr_lookup.lookup_corr,
    "channel_sums": groupnorm.channel_sums,
    "fused_group_norm": groupnorm.fused_group_norm,
    "gn_scale_shift": groupnorm.gn_scale_shift,
    "gn_silu_conv3x3": gn_silu_conv.gn_silu_conv3x3,
    "int8_absmax": int8_conv.int8_absmax,
    "int8_conv3x3": int8_conv.int8_conv3x3,
}


def launch_counts() -> dict[str, int]:
    """Launches by wrapper; and of the attention launches, those on the
    tensor-core kernel (``attention_wgmma``), those of them that read q, k
    and v in place (``attention_strided``), those on the two head-dim-512
    kernels (``attention_wide``; the rest took the FMA kernel) and those of
    them that read q, k and v in place (``attention_wide_strided``);
    of the fused GroupNorm+SiLU+conv launches, those on the tensor-core kernel
    (``gn_silu_conv3x3_wgmma``)."""
    counts = {name: fn.launches for name, fn in WRAPPERS.items()}
    counts["attention_wgmma"] = attention.attention.wgmma_launches
    counts["attention_strided"] = attention.attention.strided_launches
    counts["attention_wide"] = attention.attention.wide_launches
    counts["attention_wide_strided"] = attention.attention.wide_strided_launches
    counts["gn_silu_conv3x3_wgmma"] = gn_silu_conv.gn_silu_conv3x3.wgmma_launches
    return counts


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    attention.attention.wgmma_launches = 0
    attention.attention.strided_launches = 0
    attention.attention.wide_launches = 0
    attention.attention.wide_strided_launches = 0
    gn_silu_conv.gn_silu_conv3x3.wgmma_launches = 0
