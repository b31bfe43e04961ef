"""Hand-written Hopper kernels of the restore path, each beside its plain
PyTorch version. Each wrapper counts the launches it makes in an integer
attribute ``launches``; :func:`launch_counts` and
:func:`reset_launch_counts` read and clear them all."""
from __future__ import annotations

from mgldvsr_tpu_torch.ops.kernels import attention, corr_lookup, flow_warp, groupnorm

WRAPPERS = {
    "warp_forward": flow_warp.warp_forward,
    "warp_dx": flow_warp.warp_dx,
    "attention": attention.attention,
    "corr_lookup": corr_lookup.lookup_corr,
    "channel_sums": groupnorm.channel_sums,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
