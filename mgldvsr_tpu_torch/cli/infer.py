"""Inference CLI of the PyTorch port, the counterpart of
``mgldvsr_tpu/cli/infer.py`` (the reference's three ``vsr_val`` scripts in
one entry point):

  python -m mgldvsr_tpu_torch.cli.infer --seqs-path LQ_ROOT --out-path OUT \\
      [--mode fixed|tile|latent] [--torch-ckpt ckpt] [--ddpm-steps 50] \\
      [--shard 0 --num-shards 1] [--seed 42] [--device cuda|cpu]

``LQ_ROOT`` holds one folder of frames per clip; every clip is restored
window by window (``num_frames`` frames, the last window padded) into
``OUT/<clip>/`` under the input frame names. ``fixed`` restores each window
pre-upscaled x``sf`` in one piece, ``tile`` runs the arbitrary-resolution
tiled protocol, ``latent`` also writes each frame's final latent as
``<name>.npy`` ([h/8, w/8, 4] float32) for stage-2 training.

Without a checkpoint the towers get seeded random weights (a smoke run).
Every window's noise comes from a ``torch.Generator`` seeded with ``--seed``
and a CRC32 of ``clip/first frame name``: the same run gives the same
frames in every process.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
import zlib


def segment_seed(seed: int, clip: str, name: str) -> int:
    """The generator seed of the window of ``clip`` that starts at frame
    ``name``: ``seed`` in the high 32 bits, a CRC32 of ``clip/name`` in the
    low ones."""
    return ((seed & 0xFFFFFFFF) << 32) | zlib.crc32(f"{clip}/{name}".encode())


def tiny_pipeline_config(dtype, num_frames: int = 5, **knobs):
    """Smoke widths: the same graph as the shipped one, about ten times
    narrower (the inference and training command lines' tiny preset)."""
    from mgldvsr_tpu_torch.flow.raft import RAFTConfig
    from mgldvsr_tpu_torch.infer.pipeline import PipelineConfig
    from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig
    from mgldvsr_tpu_torch.models.unet import StructCondConfig, UNetConfig
    from mgldvsr_tpu_torch.models.vae import VAEConfig

    return PipelineConfig(
        **knobs, num_frames=num_frames,
        unet=UNetConfig(model_channels=32, num_head_channels=16, context_dim=32,
                        semb_channels=32, channel_mult=(1, 2), attention_resolutions=(1, 2),
                        num_frames=num_frames, dtype=dtype),
        structcond=StructCondConfig(model_channels=32, out_channels=32, channel_mult=(1, 1),
                                    attention_resolutions=(1, 2), num_frames=num_frames,
                                    dtype=dtype),
        vae=VAEConfig(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, num_frames=num_frames,
                      enable_fusion=True, num_fuse_block=1, dtype=dtype),
        clip=CLIPTextConfig(width=32, heads=2, layers=2, dtype=dtype),
        raft=RAFTConfig(iters=2))


def build_pipeline(args):
    import torch

    from mgldvsr_tpu_torch.flow.raft import RAFTConfig
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, PipelineConfig
    from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig
    from mgldvsr_tpu_torch.models.unet import StructCondConfig, UNetConfig
    from mgldvsr_tpu_torch.models.vae import VAEConfig

    dt = torch.bfloat16 if args.bf16 else torch.float32
    knobs = dict(ddpm_steps=args.ddpm_steps, guidance_scale=args.guidance, dec_w=args.dec_w,
                 colorfix=args.colorfix)
    if args.preset == "tiny":
        cfg = tiny_pipeline_config(dt, **knobs)
    elif args.model_cfg:
        from mgldvsr_tpu_torch.utils.config import pipeline_config_from_dict

        cfg = dataclasses.replace(pipeline_config_from_dict(args.model_cfg), **knobs)
        # a tower's dtype from the config wins; otherwise --bf16 / --no-bf16
        for name in ("unet", "structcond", "vae", "clip"):
            if "dtype" not in (args.model_cfg.get(name) or {}):
                cfg = dataclasses.replace(
                    cfg, **{name: dataclasses.replace(getattr(cfg, name), dtype=dt)})
    else:
        cfg = PipelineConfig(
            **knobs, unet=UNetConfig(dtype=dt), structcond=StructCondConfig(dtype=dt),
            vae=VAEConfig(num_frames=5, enable_fusion=True, dtype=dt),
            clip=CLIPTextConfig(dtype=dt), raft=RAFTConfig())
    if args.flow_scale is not None:
        cfg = dataclasses.replace(cfg, flow_scale=args.flow_scale)
    if args.flow_chunk is not None:
        # 0 is one batched RAFT call over every pair
        cfg = dataclasses.replace(cfg, flow_chunk_pairs=args.flow_chunk)
    return MGLDVSRPipeline(cfg, device=args.device)


def load_weights(pipe, args) -> None:
    """The checkpoints given, else seeded random weights; then each tower
    in its compute dtype."""
    if args.torch_ckpt:
        from mgldvsr_tpu_torch.io.torch_ckpt import load_pipeline_checkpoints

        n_ema = load_pipeline_checkpoints(pipe, args.torch_ckpt, args.vqgan_ckpt, args.raft_ckpt)
        if n_ema:
            print(f"LitEma shadows applied: {n_ema} UNet weights are the EMA weights")
    else:
        from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights

        print("WARNING: no checkpoint given — using random weights (smoke mode)")
        init_pipeline_weights(pipe, 0)
    pipe.cast_to_compute_dtypes()


def parse_args(argv=None):
    # config files and KEY.PATH=VALUE overrides (configs/infer_mgldvsr.yaml):
    # their values become argparse defaults, explicit flags win
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", action="append", default=[])
    pre.add_argument("--set", dest="overrides", action="append", default=[],
                     metavar="KEY.PATH=VALUE")
    pre_args, _ = pre.parse_known_args(argv)
    cfg = {}
    if pre_args.config or pre_args.overrides:
        from mgldvsr_tpu_torch.utils.config import load_config

        cfg = load_config(pre_args.config, pre_args.overrides)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0], parents=[pre])
    ap.add_argument("--seqs-path", required=True, help="folder of clip folders")
    ap.add_argument("--out-path", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--torch-ckpt", help="MGLD-VSR torch checkpoint")
    ap.add_argument("--vqgan-ckpt", help="video VAE torch checkpoint (no key prefix)")
    ap.add_argument("--raft-ckpt", help="raft-things torch checkpoint")
    ap.add_argument("--mode", choices=["fixed", "tile", "latent"], default="fixed")
    ap.add_argument("--ddpm-steps", type=int, default=50)
    ap.add_argument("--dec-w", type=float, default=1.0)
    ap.add_argument("--guidance", type=float, default=-10.0)
    ap.add_argument("--colorfix", default="adain", choices=["adain", "wavelet", "none"])
    ap.add_argument("--size", type=int, default=512,
                    help="unused: seeded weights do not depend on the frame size (kept so "
                         "the JAX CLI's configs load)")
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--num-shards", type=int, default=1,
                    help="restore the clips whose index is --shard modulo this")
    ap.add_argument("--vqgantile-size", type=int, default=960,
                    help="tile mode: pixel patch size (the reference's default 960; 0 = one "
                         "canvas tile a patch, stride 7/8 of it)")
    ap.add_argument("--vqgantile-stride", type=int, default=750,
                    help="tile mode: pixel patch stride (the reference's default 750; 0 = "
                         "7/8 of the patch in latent units, also taken when the patch size is "
                         "0 and this stride would leave no overlap)")
    ap.add_argument("--tile-overlap", type=int, default=32,
                    help="tile mode: latent canvas tile overlap (the reference's default 32)")
    ap.add_argument("--patch-batch", type=int, default=None,
                    help="tile mode: patches restored together on the window axis (default: "
                         "what free device memory holds; 1 on the CPU); every patch gets the "
                         "same draws, so the frames depend on it only through the towers' "
                         "rounding (bf16 sums in another order at another batch)")
    ap.add_argument("--min-side", type=int, default=512,
                    help="tile mode: the working frame's shorter side at least (the reference "
                         "fixes 512)")
    ap.add_argument("--window-batch", type=int, default=1,
                    help="fixed mode: restore this many consecutive windows in one call; they "
                         "stay independent but share one generator")
    ap.add_argument("--flow-scale", type=float, default=None,
                    help="resolution RAFT runs at, relative to the working size (default: the "
                         "config's 1.0 in fixed mode, 0.25 in tile mode; latent mode always "
                         "1.0)")
    ap.add_argument("--flow-chunk", type=int, default=None,
                    help="RAFT frame pairs a call (0: all pairs in one call; default: the "
                         "config's 8)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--no-bf16", dest="bf16", action="store_false")
    ap.add_argument("--preset", choices=["full", "tiny"], default="full",
                    help="'tiny' = smoke-test widths")
    if cfg.get("infer"):
        known = {a.dest for a in ap._actions}
        unknown = set(cfg["infer"]) - known
        if unknown:
            raise KeyError(f"config infer: unknown keys {sorted(unknown)}")
        ap.set_defaults(**cfg["infer"])
    model_cfg = cfg.get("model") or {}
    for cfg_key, dest in (("ddpm_steps", "ddpm_steps"), ("guidance_scale", "guidance"),
                          ("dec_w", "dec_w"), ("colorfix", "colorfix")):
        if cfg_key in model_cfg:
            ap.set_defaults(**{dest: model_cfg[cfg_key]})
    args = ap.parse_args(argv)
    args.model_cfg = model_cfg
    return args


def main(argv=None) -> None:
    args = parse_args(argv)

    import numpy as np
    import torch

    from mgldvsr_tpu_torch.data.video_folder import VideoFolderDataset
    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
    from mgldvsr_tpu_torch.io.frames import codec, write_frame

    pipe = build_pipeline(args)
    load_weights(pipe, args)
    ds = VideoFolderDataset(args.seqs_path, num_frame=pipe.cfg.num_frames)
    t = pipe.cfg.num_frames
    group_size = max(1, args.window_batch) if args.mode == "fixed" else 1
    print(f"mode {args.mode} on {pipe.device}, frames through {codec()}", flush=True)

    for seq_idx in range(len(ds)):
        if seq_idx % args.num_shards != args.shard:
            continue
        t0 = time.time()
        n_frames = 0
        segments = list(ds.segments(seq_idx))
        for g0 in range(0, len(segments), group_size):
            group = segments[g0:g0 + group_size]
            clip, first_names, _ = group[0]
            outdir = os.path.join(args.out_path, clip)
            os.makedirs(outdir, exist_ok=True)
            gen = torch.Generator(device=pipe.device).manual_seed(
                segment_seed(args.seed, clip, first_names[0]))
            frames = torch.from_numpy(np.concatenate([f for _, _, f in group])).to(pipe.device)
            latents = None
            if args.mode == "tile":
                out = pipe.restore_video(
                    frames, gen, dec_w=args.dec_w, pch_size=args.vqgantile_size,
                    pch_stride=args.vqgantile_stride, tile_overlap=args.tile_overlap,
                    min_side=args.min_side, patch_batch=args.patch_batch,
                    **({"flow_scale": args.flow_scale} if args.flow_scale is not None else {}))
            elif args.mode == "latent":
                out, latents = pipe.restore_with_latents(upscale_frames(frames, pipe.cfg.sf), gen)
                latents = latents.float().cpu().numpy()
            else:
                out = pipe.restore_segment(upscale_frames(frames, pipe.cfg.sf), gen)
            out = (out.float().clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()
            for w, (_, names, _) in enumerate(group):
                for i, name in enumerate(names):
                    write_frame(os.path.join(outdir, name), out[w * t + i])
                    if latents is not None:
                        np.save(os.path.join(outdir, os.path.splitext(name)[0] + ".npy"),
                                np.ascontiguousarray(latents[w * t + i]))
                n_frames += len(names)
        dt = time.time() - t0
        print(f"[{seq_idx}] {ds.clips[seq_idx]}: {n_frames} frames in {dt:.1f}s "
              f"({n_frames / max(dt, 1e-9):.2f} frames/s)", flush=True)


if __name__ == "__main__":
    main()
