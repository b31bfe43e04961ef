#!/usr/bin/env python3
"""Time the fused GroupNorm+SiLU+conv3x3 chain at every shape the full-width
restore gives it, on the GPU.

    python3 tools/bench_fused_conv.py [--iters 20] [--frames 5]

The shapes come from the towers themselves (``chain_shapes``): the full-width
UNet, struct-cond encoder and VAE are built on the meta device (no memory) and
run once with every chain recorded instead of computed, which gives each distinct
(input shape, output channels) and how often one sampler step (UNet,
struct-cond) or one restore (VAE) runs it. Each shape is then timed in
bfloat16 with seeded inputs, CUDA events over ``--iters`` launches: the whole
chain (statistics + conv, two launches), the conv kernel alone, and the
PyTorch chain ``F.conv2d(F.silu(F.group_norm(x)))`` (cuDNN) as the yardstick.
The last lines sum the times weighted by the counts: milliseconds of fused
chains per sampler step and per restore's VAE. The last line is one JSON
object with every row.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def chain_shapes(frames: int, dtype=None):
    """{tower: [(n, c, h, w, co, weight dtype), ...]}: every GroupNorm -> SiLU ->
    conv3x3 chain of the full-width towers in call order, for ``frames``
    frames of 512px in ``dtype`` (bfloat16 if None)."""
    import torch

    import mgldvsr_tpu_torch.models.unet as unet_mod
    import mgldvsr_tpu_torch.models.vae as vae_mod
    import mgldvsr_tpu_torch.ops.attention as attend_mod
    from mgldvsr_tpu_torch.models import layers

    dtype = dtype or torch.bfloat16
    seen: list = []

    def record(norm, conv, x):
        assert x.ndim == 4 and conv.kernel_size == (3, 3) and conv.padding == (1, 1)
        co = conv.weight.shape[0]
        seen.append((*x.shape, co, conv.weight.dtype))
        return torch.empty(x.shape[0], co, *x.shape[2:], dtype=conv.weight.dtype, device=x.device)

    def taken():
        chains = list(seen)
        del seen[:]
        return chains

    saved = [(m, m.norm_silu_conv) for m in (layers, unet_mod, vae_mod)]
    saved_attention = attend_mod.attention_bnhd
    for mod, _ in saved:
        mod.norm_silu_conv = record
    attend_mod.attention_bnhd = lambda q, k, v: torch.empty_like(q)  # changes no shape
    towers = {}
    try:
        with torch.device("meta"), torch.no_grad():
            lat, t = torch.empty(frames, 4, 64, 64), torch.empty(frames, dtype=torch.long)
            enc = layers.cast_weights(unet_mod.StructCondEncoder(
                unet_mod.StructCondConfig(num_frames=frames, dtype=dtype)), dtype)
            cond = enc(lat, t)
            towers["structcond"] = taken()
            unet = layers.cast_weights(unet_mod.InflatedUNetDualCond(
                unet_mod.UNetConfig(num_frames=frames, dtype=dtype)), dtype)
            unet(lat, t, torch.empty(1, 77, 1024), cond)
            towers["unet"] = taken()
            vae = layers.cast_weights(vae_mod.VideoAutoencoderKLResi(
                vae_mod.VAEConfig(num_frames=frames, enable_fusion=True, dtype=dtype)), dtype)
            _, enc_fea = vae.encode(torch.empty(frames, 3, 512, 512))
            vae.decode(lat, enc_fea)
            towers["vae"] = taken()
    finally:
        for mod, fn in saved:
            mod.norm_silu_conv = fn
        attend_mod.attention_bnhd = saved_attention
    return towers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--frames", type=int, default=5)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_fused_conv: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from mgldvsr_tpu_torch.ops.kernels import gn_silu_conv as conv_mod
    from mgldvsr_tpu_torch.ops.kernels import groupnorm as gn_mod

    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    towers = {tower: collections.Counter(chain[:5] for chain in chains)
              for tower, chains in chain_shapes(args.frames).items()}
    rows = []
    print("tower       shape -> Co                 count  kernel  chain ms  conv ms  TFLOP/s  "
          "library ms  chain/library")
    for tower, shapes in towers.items():
        for (n, c, h, w, co), count in sorted(shapes.items()):
            x = (torch.randn(n, c, h, w, device=dev, generator=gen) * 1.5 + 0.3).to(bf16)
            gw = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
            gb = 0.1 * torch.randn(c, device=dev, generator=gen)
            wt = (torch.randn(co, c, 3, 3, device=dev, generator=gen) * (9 * c) ** -0.5).to(bf16)
            bias = (0.1 * torch.randn(co, device=dev, generator=gen)).to(bf16)
            gwd, gbd = gw.to(bf16), gb.to(bf16)
            iters = max(3, args.iters // 4) if h >= 256 else args.iters
            out = conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-6)
            scale, shift = gn_mod.gn_scale_shift(x, gw, gb, 32, 1e-6)
            variant = conv_mod.kernel_variant(bf16, co)
            conv_only = chip_smoke.conv_alone(x, scale, shift, wt, conv_mod.bias_fp32(bias), out,
                                              variant)
            chain = chip_smoke.cuda_ms(
                lambda: conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-6), iters)
            conv = chip_smoke.cuda_ms(conv_only, iters)
            library = chip_smoke.cuda_ms(
                lambda: F.conv2d(F.silu(F.group_norm(x, 32, gwd, gbd, 1e-6)), wt, bias, padding=1),
                iters)
            tflops = 18e-9 * c * co * n * h * w / conv
            rows.append({"tower": tower, "shape": [n, c, h, w], "co": co, "count": count,
                         "kernel": variant, "chain_ms": chain, "conv_ms": conv, "tflops": tflops,
                         "library_ms": library})
            print(f"{tower:10}  {str([n, c, h, w]):22} -> {co:4}  {count:5}  {variant:6}  "
                  f"{chain:8.4f}  {conv:7.4f}  {tflops:7.1f}  {library:10.4f}  "
                  f"{chain / library:6.2f}", flush=True)
            del x, wt, out
    for label, names in (("one sampler step (UNet + struct-cond)", ("unet", "structcond")),
                         ("one restore's VAE", ("vae",))):
        sel = [r for r in rows if r["tower"] in names]
        print(f"{label}: {sum(r['count'] for r in sel)} chains, chain "
              f"{sum(r['count'] * r['chain_ms'] for r in sel):.3f} ms, conv kernels alone "
              f"{sum(r['count'] * r['conv_ms'] for r in sel):.3f} ms, library "
              f"{sum(r['count'] * r['library_ms'] for r in sel):.3f} ms  [{card}]")
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
