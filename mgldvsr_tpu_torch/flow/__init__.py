"""Optical-flow networks and clip-level flow utilities."""
from mgldvsr_tpu_torch.flow.raft import RAFT, RAFTConfig
from mgldvsr_tpu_torch.flow.spynet import SpyNet
from mgldvsr_tpu_torch.flow.maskflownet import MaskFlownetConfig, MaskFlownetS
from mgldvsr_tpu_torch.flow.compute import compute_clip_flows, compute_occlusion_masks
