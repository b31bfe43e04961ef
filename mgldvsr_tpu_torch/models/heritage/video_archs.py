"""Video SR backbones: BasicVSR, EDVR (PCD alignment, TSA fusion),
BasicVSR++ (second-order flow-guided deformable alignment) and the latent
flow-propagation CouplePropModule.

Counterpart of ``mgldvsr_tpu/models/heritage/video_archs.py``. Frames are
NHWC at the boundary ([B, T, H, W, C]) and flows are inputs ([B, T-1, H,
W, 2], (x, y) order), as in JAX; features run NCHW inside and the JAX
package's frame scans are Python loops. Keys are basicsr's
(``backward_trunk.main.{0,2.i}``, ``pcd_align.dcn_pack.l{n}``,
``fusion.spatial_attn*``, ``deform_align.{branch}.conv_offset.{0,2,4,6}``,
``backbone.{branch}``), the layout the JAX package's converters read.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mgldvsr_tpu_torch.models.heritage.sr_archs import (
    ResidualBlockNoBN,
    conv,
    lrelu,
    nchw,
    nhwc,
    resize_nchw,
)
from mgldvsr_tpu_torch.ops.dcn import DCNv2Pack, modulated_deform_conv2d
from mgldvsr_tpu_torch.ops.resize import resize2d
from mgldvsr_tpu_torch.ops.warp import flow_warp


def warp_nchw(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The port's plain ``flow_warp`` of an NCHW feature by an NHWC flow."""
    return nchw(flow_warp(nhwc(feat), flow))


class ConvResidualBlocks(nn.Module):
    """lrelu(conv_in(x)) then ``num_block`` residual blocks, NCHW."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64, num_block: int = 30):
        super().__init__()
        self.main = nn.Sequential(
            conv(num_in_ch, num_feat), nn.LeakyReLU(0.1),
            nn.Sequential(*[ResidualBlockNoBN(num_feat) for _ in range(num_block)]))

    def forward(self, x):
        return self.main(x)


class _Upsampler(nn.Module):
    """The x4 tail the video models share: two conv + pixel-shuffle stages,
    conv_hr and conv_last, plus the bilinear x4 of the frame."""

    def _build_tail(self, num_feat: int) -> None:
        self.upconv1 = conv(num_feat, num_feat * 4)
        self.upconv2 = conv(num_feat, 64 * 4)
        self.conv_hr = conv(64, 64)
        self.conv_last = conv(64, 3)

    def _tail(self, feat: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
        out = lrelu(F.pixel_shuffle(self.upconv1(feat), 2))
        out = lrelu(F.pixel_shuffle(self.upconv2(out), 2))
        out = nhwc(self.conv_last(lrelu(self.conv_hr(out))))
        h, w = frame.shape[1:3]
        return out + resize2d(frame, (h * 4, w * 4), "bilinear")


class BasicVSR(_Upsampler):
    """``forward(frames [B,T,H,W,3], flows_forward, flows_backward)`` ->
    [B,T,4H,4W,3]."""

    def __init__(self, num_feat: int = 64, num_block: int = 15):
        super().__init__()
        self.num_feat = num_feat
        self.backward_trunk = ConvResidualBlocks(num_feat + 3, num_feat, num_block)
        self.forward_trunk = ConvResidualBlocks(num_feat + 3, num_feat, num_block)
        self.fusion = conv(num_feat * 2, num_feat, 1)
        self._build_tail(num_feat)

    def forward(self, frames, flows_forward, flows_backward):
        b, t, h, w, _ = frames.shape
        zeros = frames.new_zeros((b, self.num_feat, h, w))
        # the JAX scan's inputs: frame t-1-s with backward flow t-2-s (a zero
        # flow for the first frame, whose warp reads zeros anyway)
        flows_b = torch.cat([torch.zeros_like(flows_backward[:, :1]), flows_backward], 1)
        feat_prop, feats_bwd = zeros, [None] * t
        for i in range(t - 1, -1, -1):
            feat_prop = warp_nchw(feat_prop, flows_b[:, i])
            feat_prop = self.backward_trunk(torch.cat([nchw(frames[:, i]), feat_prop], 1))
            feats_bwd[i] = feat_prop
        outs = []
        feat_prop = zeros
        for i in range(t):
            frame = frames[:, i]
            if i > 0:
                feat_prop = warp_nchw(feat_prop, flows_forward[:, i - 1])
            feat_prop = self.forward_trunk(torch.cat([nchw(frame), feat_prop], 1))
            out = lrelu(self.fusion(torch.cat([feats_bwd[i], feat_prop], 1)))
            outs.append(self._tail(out, frame))
        return torch.stack(outs, dim=1)


def _level_convs(lvls, cin_of, cout: int) -> nn.ModuleDict:
    return nn.ModuleDict({f"l{lvl}": conv(cin_of(lvl), cout) for lvl in lvls})


class PCDAlignment(nn.Module):
    """EDVR's pyramid, cascading and deformable alignment. The DCN packs'
    offsets are the plain concat of the offset conv's first two chunks, read
    [g, k, (y, x)] (the JAX package's layout)."""

    def __init__(self, num_feat: int = 64, deform_groups: int = 8):
        super().__init__()
        nf = num_feat
        self.offset_conv1 = _level_convs((3, 2, 1), lambda _: 2 * nf, nf)
        self.offset_conv2 = _level_convs((3, 2, 1), lambda lvl: nf if lvl == 3 else 2 * nf, nf)
        self.offset_conv3 = _level_convs((2, 1), lambda _: nf, nf)
        self.dcn_pack = nn.ModuleDict({f"l{lvl}": DCNv2Pack(nf, nf, deform_groups)
                                       for lvl in (3, 2, 1)})
        self.feat_conv = _level_convs((2, 1), lambda _: 2 * nf, nf)
        self.cas_offset_conv1 = conv(2 * nf, nf)
        self.cas_offset_conv2 = conv(nf, nf)
        self.cas_dcnpack = DCNv2Pack(nf, nf, deform_groups)

    @staticmethod
    def _dcn(pack: DCNv2Pack, x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
        o1, o2, m = torch.chunk(nhwc(pack.conv_offset(off)), 3, dim=-1)
        out = modulated_deform_conv2d(nhwc(x), torch.cat([o1, o2], -1), torch.sigmoid(m),
                                      pack.weight, pack.bias, deform_groups=pack.deform_groups)
        return nchw(out)

    def forward(self, nbr_pyr: Sequence[torch.Tensor], ref_pyr: Sequence[torch.Tensor]):
        up_off = up_feat = feat = None
        for lvl in (3, 2, 1):
            key = f"l{lvl}"
            nbr, ref = nbr_pyr[lvl - 1], ref_pyr[lvl - 1]
            off = lrelu(self.offset_conv1[key](torch.cat([nbr, ref], 1)))
            if lvl < 3:
                off = lrelu(self.offset_conv2[key](torch.cat([off, up_off], 1)))
                off = lrelu(self.offset_conv3[key](off))
            else:
                off = lrelu(self.offset_conv2[key](off))
            feat = self._dcn(self.dcn_pack[key], nbr, off)
            if lvl < 3:
                feat = self.feat_conv[key](torch.cat([feat, up_feat], 1))
            if lvl > 1:
                feat = lrelu(feat)
                size = (off.shape[2] * 2, off.shape[3] * 2)
                up_off = 2.0 * resize_nchw(off, size)
                up_feat = resize_nchw(feat, size)
        off = lrelu(self.cas_offset_conv1(torch.cat([feat, ref_pyr[0]], 1)))
        off = lrelu(self.cas_offset_conv2(off))
        return lrelu(self._dcn(self.cas_dcnpack, feat, off))


class TSAFusion(nn.Module):
    """EDVR's temporal and spatial attention fusion: aligned [B,T,C,H,W] ->
    [B,C,H,W]."""

    def __init__(self, num_feat: int = 64, num_frame: int = 5, center: int = 2):
        super().__init__()
        nf = num_feat
        self.center = center
        self.temporal_attn1 = conv(nf, nf)
        self.temporal_attn2 = conv(nf, nf)
        self.feat_fusion = conv(num_frame * nf, nf, 1)
        self.spatial_attn1 = conv(num_frame * nf, nf, 1)
        self.spatial_attn2 = conv(2 * nf, nf, 1)
        self.spatial_attn3 = conv(nf, nf)
        self.spatial_attn4 = conv(nf, nf, 1)
        self.spatial_attn5 = conv(nf, nf)
        self.spatial_attn_l1 = conv(nf, nf, 1)
        self.spatial_attn_l2 = conv(2 * nf, nf)
        self.spatial_attn_l3 = conv(nf, nf)
        self.spatial_attn_add1 = conv(nf, nf, 1)
        self.spatial_attn_add2 = conv(nf, nf, 1)

    def forward(self, aligned):
        b, t, c, h, w = aligned.shape
        emb_ref = self.temporal_attn1(aligned[:, self.center])
        emb = self.temporal_attn2(aligned.reshape(b * t, c, h, w)).reshape(b, t, -1, h, w)
        prob = torch.sigmoid((emb * emb_ref[:, None]).sum(dim=2, keepdim=True))
        al = (aligned * prob).reshape(b, t * c, h, w)
        feat = lrelu(self.feat_fusion(al))

        def pools(z):
            return torch.cat([F.max_pool2d(z, 3, 2, 1), F.avg_pool2d(z, 3, 2, 1)], 1)

        attn = lrelu(self.spatial_attn1(al))
        attn = lrelu(self.spatial_attn2(pools(attn)))
        level = lrelu(self.spatial_attn_l1(attn))
        level = lrelu(self.spatial_attn_l2(pools(level)))
        level = lrelu(self.spatial_attn_l3(level))
        level = resize_nchw(level, (attn.shape[2], attn.shape[3]))
        attn = lrelu(self.spatial_attn3(attn)) + level
        attn = lrelu(self.spatial_attn4(attn))
        attn = self.spatial_attn5(resize_nchw(attn, (h, w)))
        attn_add = self.spatial_attn_add2(lrelu(self.spatial_attn_add1(attn)))
        return feat * torch.sigmoid(attn) * 2 + attn_add


class EDVR(_Upsampler):
    """``forward(frames [B,T,H,W,3])`` -> the centre frame x4, [B,4H,4W,3]."""

    def __init__(self, num_feat: int = 64, num_frame: int = 5, num_extract_block: int = 5,
                 num_reconstruct_block: int = 10, deform_groups: int = 8):
        super().__init__()
        nf = num_feat
        self.conv_first = conv(3, nf)
        self.feature_extraction = nn.Sequential(
            *[ResidualBlockNoBN(nf) for _ in range(num_extract_block)])
        self.conv_l2_1 = conv(nf, nf, stride=2)
        self.conv_l2_2 = conv(nf, nf)
        self.conv_l3_1 = conv(nf, nf, stride=2)
        self.conv_l3_2 = conv(nf, nf)
        self.pcd_align = PCDAlignment(nf, deform_groups)
        self.fusion = TSAFusion(nf, num_frame, num_frame // 2)
        self.reconstruction = nn.Sequential(
            *[ResidualBlockNoBN(nf) for _ in range(num_reconstruct_block)])
        self._build_tail(nf)

    def forward(self, frames):
        b, t, h, w, _ = frames.shape
        center = t // 2
        l1 = self.feature_extraction(lrelu(self.conv_first(
            nchw(frames.reshape(b * t, h, w, 3)))))
        l2 = lrelu(self.conv_l2_2(lrelu(self.conv_l2_1(l1))))
        l3 = lrelu(self.conv_l3_2(lrelu(self.conv_l3_1(l2))))
        pyr = [z.reshape(b, t, *z.shape[1:]) for z in (l1, l2, l3)]
        ref = [p[:, center] for p in pyr]
        aligned = torch.stack([self.pcd_align([p[:, i] for p in pyr], ref) for i in range(t)], 1)
        feat = self.reconstruction(self.fusion(aligned))
        return self._tail(feat, frames[:, center])


class SecondOrderDeformAlign(nn.Module):
    """BasicVSR++'s second-order flow-guided deformable alignment: offsets
    are ``max_residue_magnitude * tanh`` of the offset convs plus the flows
    (as (y, x), tiled over the taps), the mask a sigmoid, a DCN over the
    2C channels of [feat_prop, feat_n2]."""

    def __init__(self, num_feat: int = 64, deform_groups: int = 16,
                 max_residue_magnitude: float = 10.0):
        super().__init__()
        nf = num_feat
        self.deform_groups, self.max_residue_magnitude = deform_groups, max_residue_magnitude
        self.conv_offset = nn.Sequential(
            conv(3 * nf + 4, nf), nn.LeakyReLU(0.1), conv(nf, nf), nn.LeakyReLU(0.1),
            conv(nf, nf), nn.LeakyReLU(0.1), conv(nf, 27 * deform_groups))
        self.weight = nn.Parameter(torch.zeros(nf, 2 * nf, 3, 3))
        self.bias = nn.Parameter(torch.zeros(nf))

    def forward(self, x, cond, flow1, flow2):
        """x, cond NCHW; flow1, flow2 NHWC (x, y). Returns NCHW."""
        out = nhwc(self.conv_offset(torch.cat([cond, nchw(flow1), nchw(flow2)], 1)))
        o1, o2, m = torch.chunk(out, 3, dim=-1)
        offset = self.max_residue_magnitude * torch.tanh(torch.cat([o1, o2], -1))
        off1, off2 = torch.chunk(offset, 2, dim=-1)
        reps = off1.shape[-1] // 2
        off1 = off1 + flow1.flip(-1).repeat(1, 1, 1, reps)
        off2 = off2 + flow2.flip(-1).repeat(1, 1, 1, reps)
        out = modulated_deform_conv2d(nhwc(x), torch.cat([off1, off2], -1), torch.sigmoid(m),
                                      self.weight, self.bias, deform_groups=self.deform_groups)
        return nchw(out)


BVPP_BRANCHES = ("backward_1", "forward_1", "backward_2", "forward_2")


class BasicVSRPlusPlus(_Upsampler):
    """BasicVSR++: the second-order grid propagation of four branches, then
    reconstruction and x4. ``forward(frames [B,T,H,W,3], flows_forward,
    flows_backward)`` -> [B,T,4H,4W,3]."""

    def __init__(self, num_feat: int = 64, num_block: int = 7, deform_groups: int = 16):
        super().__init__()
        nf = num_feat
        self.num_feat = nf
        self.feat_extract = ConvResidualBlocks(3, nf, 5)
        self.deform_align = nn.ModuleDict(
            {name: SecondOrderDeformAlign(nf, deform_groups) for name in BVPP_BRANCHES})
        self.backbone = nn.ModuleDict(
            {name: ConvResidualBlocks((2 + i) * nf, nf, num_block)
             for i, name in enumerate(BVPP_BRANCHES)})
        self.reconstruction = ConvResidualBlocks(5 * nf, nf, 5)
        self._build_tail(nf)

    def forward(self, frames, flows_forward, flows_backward):
        b, t, h, w, _ = frames.shape
        spatial = self.feat_extract(nchw(frames.reshape(b * t, h, w, 3)))
        spatial = spatial.reshape(b, t, self.num_feat, h, w)
        feats = {"spatial": [spatial[:, i] for i in range(t)]}
        for name in BVPP_BRANCHES:
            align, backbone = self.deform_align[name], self.backbone[name]
            backward = "backward" in name
            flows = flows_backward if backward else flows_forward
            frame_idx = list(range(t))[::-1] if backward else list(range(t))
            flow_idx = frame_idx if backward else [-1] + list(range(t - 1))
            feats[name] = []
            feat_prop = frames.new_zeros((b, self.num_feat, h, w))
            for i, idx in enumerate(frame_idx):
                feat_current = feats["spatial"][idx]
                if i > 0:
                    flow_n1 = flows[:, flow_idx[i]]
                    cond_n1 = warp_nchw(feat_prop, flow_n1)
                    feat_n2 = torch.zeros_like(feat_prop)
                    flow_n2 = torch.zeros_like(flow_n1)
                    cond_n2 = torch.zeros_like(cond_n1)
                    if i > 1:  # the second-order connection
                        feat_n2 = feats[name][-2]
                        flow_n2 = flows[:, flow_idx[i - 1]]
                        flow_n2 = flow_n1 + flow_warp(flow_n2, flow_n1)
                        cond_n2 = warp_nchw(feat_n2, flow_n2)
                    cond = torch.cat([cond_n1, feat_current, cond_n2], 1)
                    feat_prop = align(torch.cat([feat_prop, feat_n2], 1), cond, flow_n1, flow_n2)
                feat = torch.cat([feat_current]
                                 + [feats[k][idx] for k in feats if k not in ("spatial", name)]
                                 + [feat_prop], 1)
                feat_prop = feat_prop + backbone(feat)
                feats[name].append(feat_prop)
            if backward:
                feats[name] = feats[name][::-1]
        outs = []
        for i in range(t):
            hr = torch.cat([feats["spatial"][i]] + [feats[k][i] for k in BVPP_BRANCHES], 1)
            outs.append(self._tail(self.reconstruction(hr), frames[:, i]))
        return torch.stack(outs, dim=1)


class CouplePropModule(nn.Module):
    """Bidirectional flow-guided latent propagation: ``forward(latents
    [B,T,H,W,C], flows_forward, flows_backward)`` -> latents plus a
    correction a frame. ``backward_fusion`` / ``forward_fusion`` are the
    reference's convs that its forward never uses, kept for its
    checkpoints."""

    def __init__(self, num_ch: int = 4, num_feat: int = 64, num_block: int = 5):
        super().__init__()
        self.num_feat = num_feat
        self.backward_trunk = ConvResidualBlocks(num_ch + num_feat, num_feat, num_block)
        self.forward_trunk = ConvResidualBlocks(num_ch + 2 * num_feat, num_feat, num_block)
        self.backward_fusion = conv(2 * num_feat, num_feat)
        self.forward_fusion = conv(2 * num_feat, num_feat)
        self.conv_last = conv(num_feat, num_ch)

    def forward(self, latents, flows_forward, flows_backward):
        b, t, h, w, c = latents.shape
        bwd: List[torch.Tensor] = [None] * t
        prop = latents.new_zeros((b, self.num_feat, h, w))
        for i in range(t - 1, -1, -1):
            if i < t - 1:
                prop = warp_nchw(prop, flows_backward[:, i])
            prop = self.backward_trunk(torch.cat([nchw(latents[:, i]), prop], 1))
            bwd[i] = prop
        outs = []
        prop = latents.new_zeros((b, self.num_feat, h, w))
        for i in range(t):
            if i > 0:
                prop = warp_nchw(prop, flows_forward[:, i - 1])
            prop = self.forward_trunk(torch.cat([nchw(latents[:, i]), bwd[i], prop], 1))
            outs.append(latents[:, i] + nhwc(self.conv_last(prop)))
        return torch.stack(outs, dim=1)
