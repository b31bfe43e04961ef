#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's restore path once on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 50] [--seed 0]

Phase 0  refuse to run without CUDA; print the card's name and power limit.
Phase 1  build the CUDA kernels from csrc/ (nvcc, sm_90a) and load them.
Phase 2  hold each kernel (the seven that replace a TPU kernel, the
         statistics kernel of the fused chain, and the guidance pair that
         replaces the two warp kernels on the restore path) against its plain
         PyTorch version on the card at the main path's shapes; time both
         with CUDA events, time the one PyTorch library call that computes
         the same function where there is one, and compute the card's lower
         bound for the work. The kernels that take under 0.1 ms are also
         replayed from a CUDA graph, which gives their time on the device
         without the host's launch path (``device_ms``).
         The guidance pair also: both loss modes, two windows at t = 3 and
         t = 2, 3 channels, masks all 0 and all 1, taps all outside; its
         launches a step from a profiler trace against the autograd step it
         replaced (the warp kernels, a memset and the loss's elementwise
         launches).
         The fused GroupNorm also: every split of a slab among 1, 2, 4 or 8
         blocks, a slab too long for shared memory, slabs off the 16-byte
         boundary, and a constant input. The RAFT lookup also: one launch a
         call, ragged level maps and centres far outside them.
         Attention also: ragged N, large logits, the [B,N,H,D] strided entry
         bit for bit against the folded call, which of its four kernels
         (tensor-core, FMA, and the two at head dim 512) each type and head
         dim takes, and the head-dim-512 kernels at the VAE's mid attention
         of 256-456 px frames (bf16 [5,1024|2304|3249,512], f32
         [5,1024|2025,512]) with their own times and bounds, and on the
         VAE's own views (read in place in bf16, bit for bit the folded
         call) with the block's reshape, timed beside the copies.
         The fused GroupNorm+SiLU+conv also: shapes off its tiles, narrow
         frames, a clipped variance, the re-laid weight bit for bit, and its
         ``mma.sync`` kernel against its tensor-core kernel; the chain's one
         C call equal to the statistics and conv kernels launched apart, bit
         for bit, its device time from a CUDA graph and its host time a call
         beside the cuDNN chain's; and at the output widths tensor-parallel
         training gives a rank (``--tensor-parallel`` 2 and 4: Co 160 and 80
         of the UNet's 320, 640 and 320 of its 1280, 128 of the struct-cond's
         256, 256 of the VAE decoder's 512), bf16 and f32, against the plain
         version, timed. The standalone warp also: 3-channel
         512x512 frames, 4 and 1 of them, under a scattered, a smooth and a
         large flow, each equal to the plain warp bit for bit, with host
         microseconds a call beside F.grid_sample's; the statistics kernel's
         host time beside torch.var_mean's. The channel sums at the
         restore's [5,128,512,512] and text to image's batch-1
         [1,256,128,128] and [1,256,256,256]: ms, device ms, host us and the
         threads a block beside torch.var_mean's ms, device ms and host us,
         and two calls bit for bit.
Phase 3  tiny config at 256x256, float32, 2 steps, deterministic: the same
         weights on the card (kernels) and on the CPU (plain versions) must
         give the same frames, once in the default configuration and once
         with MGLD_FUSED_GN_CONV=1. In both configurations also the tile
         protocol (``restore_video``) on a 13x11 clip (two 64px patches of
         nine 4-latent canvas tiles, one and two patches a group) and the
         latent protocol (``restore_with_latents``: frames and latents).
Phase 4  the default configuration at full width: 5 frames x4 to 512x512, 50
         guided steps, bf16 UNet / struct-cond / VAE / CLIP and float32 RAFT
         with seeded random weights, through
         ``MGLDVSRPipeline.restore_segment``; every kernel but the fused
         GroupNorm+SiLU+conv's two and the standalone warp's two must have
         been launched by that run, the guidance pair once each a step, and
         every gated attention call (14 per step) must have taken the
         tensor-core kernel. The guidance gradient on the clip's real flows
         and masks must be non-zero and equal its plain version. Then the
         latent protocol (``restore_with_latents``) on the same clip and
         weights: frames and latents at their shapes, every kernel of the
         default configuration launched.
Phase 5  the fused configuration (MGLD_FUSED_GN_CONV=1) at the same width,
         clip, seed and weights: every kernel but the channel sums (whose
         GroupNorms all head a fused chain) must have been launched,
         every chain as two launches (statistics, conv), and every bf16 chain
         with more than 8 output channels on the tensor-core kernel.

Phase 6  the tile protocol at full width (phase 4's weights) on a 5-frame
         180x320 clip restored to 720x1280: the device memory one more patch
         adds to a group (two steps, one and two patches a group, at both
         patch geometries); (a) the auto geometry (512/448 px, six patches)
         at 10 steps with the patch batch the envelope allows; (b) the
         reference geometry (960/750 px: two 736x960 patches of six canvas
         tiles) at 5 steps. Each must give finite frames in [0, 1], launch
         kernels 1-6, the guidance pair once a step a patch group, and
         nothing of the fused configuration. The bytes a patch adds must not
         exceed the pipeline's PATCH_BYTES_PER_PIXEL. (c) the largest group
         of 736x960 patches the envelope allows, in one group on a clip wide
         enough to fill it (past 2^32 elements in the VAE from 5 patches), at
         2 steps: its frames must match one patch a group within bf16's
         rounding.
Phase 7  the inference CLI on the card: a clip of 7 PNG frames of 32x48 (two
         windows, the last padded) through ``--preset tiny`` in fixed (two
         windows a call), tile and latent mode; every frame and latent must
         be written and read back at its shape. Then ``--preset full`` in
         fixed mode on five 128x128 frames (512x512 out, 3 steps): the
         frames written, every kernel of the default configuration launched.

Phase 8  stage-1 training. (a) one tiny fp32 micro-step at 256x256 with
         injected draws, on the card and on the CPU, in both configurations:
         the loss, every trainable's gradient (by norm, beside a witness: the
         CPU against itself with the clips moved by 1e-5, which moves the
         gradients behind SPADE's ReLU by about 1e-2) and the parameters
         after the update. (b) the shipped widths through the
         training CLI's loop: bf16 towers, float32 masters, seeded weights
         jittered by 0.02 N(0,1), two seeded 8-frame 544x544 PNG clips through
         the two-stage recipe (GT 512, LQ 128, 5 frames), 8 micro-steps at
         grad_accum 4: finite losses, trainables changed at micro-steps 4 and
         8 only, frozen towers bit for bit, EMA apart from the trainables,
         attention (all on the tensor-core kernel), the channel sums and the
         fused GroupNorm launched in every micro-step; then a fresh pipeline
         resumes the step-4 checkpoint and replays steps 5-8, which must
         equal the straight run bit for bit. (c) a fresh run of the CLI
         loop for 10 micro-steps without saves: torch.profiler traces of
         micro-steps 2-5 for device time and the idle share, and of
         micro-step 6 with host ops for the share in the backwards that
         replay a kernel's plain version; micro-steps 7-10 in the fused
         configuration, checked as (b)'s (the chain's two kernels in every
         micro-step, one update); then four micro-steps on clips loaded in
         advance, alone, and two clips of the host data path timed alone,
         with the video-codec branch they took (``pyav``, ``cv2:<fourcc>``
         or ``identity (<why>)``; none fails). (d) ``cli.train --stage 1
         --tiny --max-steps 4`` on the card, then ``cli.infer`` restores a
         clip with the parameters it exported. Prints the loop's clips/s
         over steps 2-8 (data waits and checkpoint saves included), micro-step
         seconds, data-path seconds, peak memory and launches a micro-step
         (``launches_train``, ``launches_train_fused`` in the kernels line).

Phase 9  stage-2 training (the video VAE decoder's fusion and temporal
         layers; LPIPS, the PatchGAN discriminator and SpyNet seeded in
         float32, SpyNet's last convs scaled by 1e-2 so that flows leave
         pixels unoccluded). The data: two seeded 10-frame 512x512 GT clips,
         their LQ frames at 128x128, and the latents the inference command
         line's latent mode writes for them at full width. (b) the shipped
         ``configs/video_autoencoder_kl_64x64x4_resi.yaml`` (VAE ch 128,
         bf16, fusion) through the training CLI's loop: 8 micro-steps at
         grad_accum 4 (the YAML's 8, cut for time): finite losses,
         temp_loss > 0, trainables and logvar changed at micro-steps 4 and 8
         only, frozen VAE, LPIPS and SpyNet bit for bit, the channel sums
         and fused GroupNorm launched in every micro-step, the warp exactly
         once (the swc loss's warps in one call); a fresh
         pipeline resumes the step-4 checkpoint and replays 5-8, which must
         equal the straight run bit for bit. (c) four
         micro-steps through ``Stage2Trainer`` with disc_start 0: d_weight
         finite and non-zero, the discriminator moved, the decoder's
         conv_out unchanged. (d) (b) for 4 micro-steps in the fused
         configuration (the chain's two kernels in every micro-step). (e)
         the decoder's forward and backward at full width in both
         configurations, the kernels against their plain versions on the
         card: the reconstruction, the trainables' gradients and conv_out's
         weight gradient. A kernels-only torch.profiler trace of the loop
         (device time, idle share) and the device time of its parts traced
         alone (flows, encode, decoder forward and backward, LPIPS,
         discriminator); kernel 1 at the swc loss's stack [6,512,512,3]
         against its plain version, F.grid_sample and its bound. (a) two tiny fp32
         micro-steps at 64x64 on the card and on the CPU in both
         configurations: the metrics, the generator's gradients of both
         micro-steps and Adam's moments card against CPU, the
         discriminator's against its float64 replay on the card's inputs,
         and the parameters after the update where it cannot depend on
         rounding.
         Prints clips/s with and without the saves, micro-step seconds, peak
         memory and launches a micro-step (``launches_stage2``,
         ``launches_stage2_fused`` in the kernels line).
         ``--only-train`` builds the kernels and runs phases 8 and 9 alone,
         ``--only-stage2`` phase 9 alone, ``--only-quality`` phase 4 and 5's
         restores and phase 10, without the result line.

Phase 10 the quality harness at full width, after phase 5, on phase 4's clip:
         the restore ``out4`` (5 frames, 512x512), its GT the bicubic x4
         input frames, ``other`` phase 5's restore, all three as uint8.
         (a) in process: PSNR, SSIM, NIQE (pristine model fitted from the
         GT frames), LPIPS (seeded VGG16), E*warp (phase 4's RAFT, 10
         iterations, its last flow-head conv x1e-2: ``warp_forward`` once and
         ``corr_lookup`` 10 times, every other kernel 0) and FID (seeded
         InceptionV3 at 299^2, out4 against the GT; singular covariance),
         the L1 and max deltas to ``other``; ms a frame of each metric
         (warm, synchronised) and the peak memory; kernel 1 alone at
         E*warp's [4,512,512,3] against its plain version, F.grid_sample
         and its bound. The card's Inception
         features against the CPU's within 1e-4 of the largest |feature|,
         E*warp against the plain warp and lookup on the card within 1e-5
         relative. (b) the frames as PNGs and LPIPS and RAFT as torch
         files through ``python -m mgldvsr_tpu_torch.tools.quality_eval``
         (without FID and NIQE, which (a) computes): its row equals (a), the
         host metrics bit for bit, LPIPS and E*warp within 1e-5 relative. (c) ``python -m
         mgldvsr_tpu_torch.tools.quality_smoke --preset tiny --clips 1
         --frames 3`` on the card: ``ok``. (b) and (c) run beside the end of (a). Prints the phase's
         seconds; ``launches_quality`` in the kernels line.

Phase 11 the multi-device restore on one card (after phase 6, phase 4's
         weights, 10 steps, deterministic). (a) a world of one NCCL rank from a
         file:// store: ``restore_windows_sharded`` of phase 4's window equals
         ``restore_segment`` by ``torch.equal`` with the same launches; the
         exchange receives nothing. (b) ten consecutive 512x512 frames as two
         windows driven through ``sharded_step`` in lockstep
         (``tools/multicard_check.lockstep``: window 1's first frame latent
         handed to window 0 at every step): ``boundary_grad`` against autograd
         of ``boundary_loss_plain`` within 1e-6 of max |grad|; at weight 0 each
         window equals its ``restore_segment`` bit for bit, at 1 window 0
         moves and window 1 does not, and a second run at 1 is the same bit
         for bit; ``warp_forward`` once a step for window 0 only; every kernel
         of the default configuration launched by window 0 (its counts are
         ``launches_window_parallel`` in the kernels line); the pair's sampler
         ms/step in turns with two ``restore_segment`` calls'. (c) the lockstep
         at phase 3's tiny configuration, card against CPU within 1e-3, and
         window 0 moved by the boundary term on the card. (d)
         ``torchrun --nproc_per_node=1 -m mgldvsr_tpu_torch.cli.infer`` with
         ``--window-parallel`` (fixed) and ``--patch-parallel`` (tile) on phase
         7's clip: the same PNGs as the command without them.
         ``--only-parallel`` builds the kernels and runs phase 11 alone.

Phase 12 training over ranks on one card (after phase 9, on phases 8 (b) and
         9 (b)'s data). (a) a world of one NCCL rank (``rank_env``, a file://
         store) runs phase 8 (b)'s full-width stage-1 CLI loop with
         ``--mesh`` for its first 4 micro-steps (one update): the masters,
         moments, accumulator, EMA, the metrics.jsonl losses and every
         micro-step's launches equal phase 8 (b)'s straight run after
         micro-step 4 by ``torch.equal``; then the same with ``--mesh
         --zero1`` (``launches_train_parallel`` in the kernels line).
         (b) the same for stage 2 (phase 9 (b)'s loop, ``--mesh``, its first
         4 micro-steps against the straight run's state after micro-step 4).
         (c)
         ``torchrun --standalone --nproc_per_node=1 -m
         mgldvsr_tpu_torch.cli.train --tiny --mesh --zero1 --tensor-parallel
         1`` for 4 micro-steps writes the metrics and the checkpoint of the
         command without the flags, and that command resumes its step-2
         checkpoint bit for bit; with ``--tensor-parallel 2`` the grid
         degrades to 1 x 1 (NCCL puts no two ranks on one card), prints the
         mesh line and writes the same metrics and checkpoint.
         ``--only-train-parallel`` builds the kernels and runs phases 8 (b)
         and 9 (b)'s straight runs and phase 12 alone.
Phase 13 full width against float32 (after phase 11, phase 4's seed and
         clip): an fp32 twin of phase 4's weights (the same seeded init, never
         cast; its bf16 cast equals phase 4's weights bit for bit). (a) A
         2-step deterministic fp32 restore at 256 px on the card against the
         same port on this machine's CPU, within the limit that
         ``tests/test_torch_full_width.py`` holds the port to against the JAX
         package (``FP32_RESTORE_LIMIT``), and without guidance within
         ``UNGUIDED_LIMIT``. The guided comparison restores on the CPU with
         the card's sign of every guidance residual (a residual within
         rounding of 0 can take either sign on the two sides, and one flip
         moves a patch of the frames by up to ~1e-2): flips must be rare and
         within the sides' latent distance of 0, and the replay must agree
         within the limit (without a flip the replay is the CPU's own
         restore, so that one is not run). fp32 towers take the FMA attention kernel (the VAE's mid
         attention the wide kernel, twice) and the fp32 GroupNorm route,
         whose launches are checked.
         (b) Phase 4's 512 px, 50-step restore, deterministic, in bf16
         (phase 4's pipeline) and in fp32 (the twin): max |d|, mean |d| and
         PSNR, held to ``BF16_BOUND`` (PERF.md section 6, written before the
         first card run). (c) The stock UNet (``use_temporal=False,
         use_spade=False``) at phase 3's tiny widths, card against CPU: its
         forward (1e-4 of max |eps|), the restore without guidance (1e-3),
         and phase 3's guided restore on two clips, as (a)'s guided one
         with a limit of 1e-3. (d), run after (a): phase 4's bf16 pipeline
         at (a)'s 256 px, 2 steps, on (a)'s frames, against the fp32 twin's
         restore on the card, held to ``BF16_256_BOUND`` (PERF.md section 6,
         written before the first card run); the VAE's mid attention takes
         the bf16 head-dim-512 kernel twice, reading its views in place.
         ``--only-fp32`` builds the kernels and runs phases 13 and 14 alone;
         ``--only-attention`` phase 2's attention checks and head-dim-512
         rows alone.
Phase 14 the soak tool on the card (``mgldvsr_tpu_torch.tools.soak_train
         --tiny``): the training command line as a subprocess for 40
         micro-steps, SIGUSR1 at step 10, SIGKILL, ``--resume``; the step counter must
         continue from the checkpoint, the replayed step log the same loss,
         and the trainer's peak device memory appear in the summary. In the
         whole script it runs beside phase 12 (its own processes, a tiny
         model), so both phases' rates are taken sharing the card; its
         ``[phase14]`` wall is the soak's own, from its start to its exit.
Phase 15 the device synthesis and the stock text-to-image path. (a)
         Real-ESRGAN's two-stage synthesis (``train/synthesis.py``) on a
         stage-1 clip's GT [8,512,512,3] float32 with a kernel set a frame
         and draws from the card's generator: LQ [8,128,128,3] finite, in
         [0, 1], on the 1/255 grid, ms a clip beside phase 8's host data
         path; then at [2,128,128,3] card against CPU with the same draws,
         step by step on the card's input to each step (the CPU tests'
         limits: DiffJPEG's blocks apart only where a coefficient lies
         within 1e-4 of a half-integer) and whole. (b) ``Text2ImgPipeline``
         at full width in bf16 (SD 2.1's stock UNet, VAE ch 128, OpenCLIP
         ViT-H text, seeded weights): a made-up-vocabulary prompt and the
         empty one, CFG 7.5, 512x512, 50 DDIM steps, then DDIM inversion of
         the image at 10 steps, in both configurations: finite, every gated
         attention call (10 a UNet call) on the tensor-core kernel, the
         GroupNorm kernels launched, and with MGLD_FUSED_GN_CONV=1 every
         chain of more than 8 output channels on kernel 7's tensor-core
         kernel; ms/step, peak memory and launches (``launches_txt2img``,
         ``launches_txt2img_fused`` in the kernels line). (c) the tiny
         pipeline card against CPU in both configurations: DDIM under
         guidance, PLMS, inversion, within 1e-3. (d) the tiny alternate
         encoders, the classifier's three pools and textual inversion
         through the tiny text tower, card against CPU within 1e-4. (e)
         Every kernel against its plain version at every shape that (b)'s
         warm runs gave it (noted call by call; the notes must account for
         every launch), on seeded inputs with phase 2's limits, timed beside
         the plain version, the library call and the bound; the
         ``txt2img_shapes`` of each kernel in the kernels line. (f), after
         (b): one batch-2 CFG UNet call (the first DDIM timestep) and one
         decode at full width, the kernels in both configurations against
         the plain versions in bf16 and both against a float32 twin of the
         weights on the plain versions: the kernels' distance from float32
         within ``T2I_TO_F32`` times the plain bf16 run's. The raw decode of
         seeded weights spans more than [-1, 1]: (b) prints its range and
         inverts the image clamped to [-1, 1].
         ``--only-txt2img`` builds the kernels and runs phase 15 alone.
Phase 16 MaskFlownet_S, the deformable conv and the BasicSR heritage (no
         kernel of this repo runs here: the TPU package built these as plain
         XLA, the port as plain PyTorch), float32 with TF32 off. (a) The
         ops (``modulated_deform_conv2d`` at 4 deform groups with taps
         outside the image, ``local_correlation``, ``upfirdn2d``) card
         against CPU within 1e-5, and every ported architecture at the JAX
         tests' tiny widths (seeded weights, MaskFlownet at its own widths on
         a 96x128 pair, DFDNet at 64x64 with synthesised dictionaries,
         StyleGAN2 with injected noise) within 1e-4 of max |output|. (b) At
         published widths, seeded weights, each finite at its shape, warm
         synchronised ms a frame and the peak memory: seven 180x320 PNG
         frames through ``VideoRecurrentTestDataset``, SpyNet's flows and
         BasicVSR++ (mid 64, 7 blocks, 16 groups) to 720x1280; EDVR M on
         the centre window; RRDBNet as Real-ESRGAN x4plus on one frame;
         SwinIR classical x4 (embed 180, 6x6) at 128x128; MaskFlownet_S on
         a 512x512 pair; the StyleGAN2 generator at 512, channel multiplier
         2. ``--only-heritage`` runs phase 16 alone (no kernel build).
Phase 17 the native clip loader (``native/src/clip_loader.cpp``, host C++,
         no kernel of its own) and the runtime extras. (a) The library built
         with g++ from the checkout: its codecs (each compiled in where the
         compiler finds its header) beside the codec headers under
         /usr/include and the libraries ldconfig lists. (b) Each frame's
         decode against the Python path (``imfrombytes``) bit for bit; 16
         clips of 4 frames (each flip, the transpose) fetched in reverse, bit for
         bit. Without the PNG codec, (b) checks that a PNG record raises by
         name. (c) ``RealVSRRecurrentDataset(packed_root=, io_threads=2)``:
         ``read_path`` must be ``native`` (``python`` without the PNG
         codec); four samples through ``prefetch_iterator``'s two spawned
         workers against the disk path within 1e-6. (d) ``cli.train --stage 1
         --tiny --max-steps 2 --set data.packed_root=... --set
         data.io_threads=2`` on the card: finite losses, the read path it
         prints, the kernels it launches (``launches_loader_train`` in the
         kernels line; the fused GroupNorm must be among them). (e)
         ``StepTimer`` over a ~50 ms ``torch.cuda._sleep`` reads at least 40
         ms; ``device_memory_stats``' peak covers a 256 MiB allocation; five
         ``trace``s of one ``fused_group_norm`` call with torch's ``mul_``
         beside it, in the script's process after every earlier phase's
         profiler sessions, must each name both kernels, and the same trace
         in a fresh interpreter the GroupNorm kernel.
         (f) ``tools/loader_bench`` at its defaults (5 frames, 360 px source,
         128 crop, 40 clips, 4 threads), the busy main thread a CUDA matmul
         loop: clips/s of the disk path, the native pool alone and beside
         it. ``--only-loader`` builds the kernels and runs phase 17 alone.

Phase 18 ``MGLD_INT8_CONV=1`` (after phase 13, phase 4's seed and clip): phase
         4's weights built under the switch (every ``conv3x3()`` site of the
         JAX package an ``Int8Conv3x3``, its levels taken from the float32
         weights by the cast to bf16), 10 guided steps at 512 px: finite
         frames in [0, 1]; every int8 site run once a UNet or struct-cond
         call and once in the encode or decode, each call one launch of
         ``int8_absmax`` and ``int8_conv3x3``, and no site without levels
         from float32; the sampler's ms/step beside phase 4's pipeline at
         the same 10 steps, and mean |int8 - phase 4| (no limit). Then the
         kernels at the shapes that restore gave them (the largest of each
         tower, Cin 3 and 4, stride 2, the RDB's 32-channel growth convs,
         at most 8 output channels, frames up to 8 pixels wide), seeded:
         the output, max|x|, the levels (an identity kernel) and the int32
         sums (the conv kernel alone with both scales 1) equal to the plain
         version bit for bit; the chain's ms and CUDA-graph device ms, each
         kernel's ms alone, the bound (int8 operations at 1,979 TOPS or the
         bytes), the plain version's ms, and the yardsticks: ``x.abs().amax()``
         for the absmax, ``torch._int_mm`` of the im2col'd levels and
         cuDNN's bf16 conv for the conv. ``launches_int8`` in the kernels
         line. ``--only-int8`` builds the kernels and runs phase 4's
         pipeline and phase 18 alone (no result line).

Every phase prints its own ``[phaseN] ... s of wall`` line, and a
``[phases]`` line lists them all before the kernels line.

Prints one JSON line describing the kernels before the last line, and the
result line ``{"ok": true, "device": {...}}`` last. Any failure raises and
exits non-zero without the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

KERNELS = {
    # wrapper name: (route, source, TPU kernel it replaces)
    "warp_forward": ("cuda", "mgldvsr_tpu_torch/csrc/flow_warp.cu",
                     "mgldvsr_tpu/ops/pallas/flow_warp.py:103"),
    "warp_dx": ("cuda", "mgldvsr_tpu_torch/csrc/flow_warp.cu",
                "mgldvsr_tpu/ops/pallas/flow_warp.py:203"),
    # on the restore path both warp kernels, and the loss around them, are these two
    "guidance_residual": ("cuda", "mgldvsr_tpu_torch/csrc/guidance.cu",
                          "mgldvsr_tpu/ops/pallas/flow_warp.py:103"),
    "guidance_scatter": ("cuda", "mgldvsr_tpu_torch/csrc/guidance.cu",
                         "mgldvsr_tpu/ops/pallas/flow_warp.py:203"),
    "attention": ("cuda", "mgldvsr_tpu_torch/csrc/attention.cu",
                  "mgldvsr_tpu/ops/pallas/attention.py:76"),
    "corr_lookup": ("cuda", "mgldvsr_tpu_torch/csrc/corr_lookup.cu",
                    "mgldvsr_tpu/ops/pallas/corr_lookup.py:94"),
    "channel_sums": ("cuda", "mgldvsr_tpu_torch/csrc/groupnorm.cu",
                     "mgldvsr_tpu/ops/pallas/groupnorm.py:55"),
    "fused_group_norm": ("cuda", "mgldvsr_tpu_torch/csrc/groupnorm.cu",
                         "mgldvsr_tpu/ops/pallas/groupnorm.py:139"),
    "gn_silu_conv3x3": ("cuda", "mgldvsr_tpu_torch/csrc/gn_silu_conv.cu",
                        "mgldvsr_tpu/ops/pallas/gn_silu_conv.py:154"),
    # the statistics of the same TPU function, which it left to XLA
    "gn_scale_shift": ("cuda", "mgldvsr_tpu_torch/csrc/gn_silu_conv.cu",
                       "mgldvsr_tpu/ops/pallas/gn_silu_conv.py:161"),
    # MGLD_INT8_CONV's Int8Conv3x3: no Pallas kernel (XLA's int8 conv there)
    "int8_absmax": ("cuda", "mgldvsr_tpu_torch/csrc/int8_conv.cu",
                    "mgldvsr_tpu/models/layers.py:163"),
    "int8_conv3x3": ("cuda", "mgldvsr_tpu_torch/csrc/int8_conv.cu",
                     "mgldvsr_tpu/models/layers.py:163"),
}
FUSED_ONLY = ("gn_silu_conv3x3", "gn_scale_shift")  # launched by the fused configuration alone
# launched by the default configuration alone: its GroupNorms of 128^2 pixels
# and more all head a chain, which the fused configuration gives to the two above
DEFAULT_ONLY = ("channel_sums",)
# on no single-window restore path (phases 3-7): the restore's guidance step runs
# the guidance pair; warp_forward alone runs in the window-parallel boundary term
# (phase 11), stage-2 training's swc loss (phase 9) and E*warp (phase 10)
STANDALONE = ("warp_forward", "warp_dx")
# launched only by towers built under MGLD_INT8_CONV=1 (phase 18)
INT8_ONLY = ("int8_absmax", "int8_conv3x3")

# NVIDIA H100 SXM data sheet, dense: device memory bytes/s, tensor-core
# flop/s for bf16 and fp16 (int8 operations/s), fp32 flop/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12, "int8": 1979e12}


def bound(nbytes: float, flops: float, kind: str):
    """(least ms the card could take, what binds it): the larger of bytes
    over the memory rate and operations over the peak rate of ``kind``."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[kind]
    return 1000 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@contextlib.contextmanager
def fused_switch(on: bool):
    """Set MGLD_FUSED_GN_CONV for the enclosed calls (it is read at call
    time) and restore the previous value."""
    before = os.environ.get("MGLD_FUSED_GN_CONV")
    os.environ["MGLD_FUSED_GN_CONV"] = "1" if on else "0"
    try:
        yield
    finally:
        if before is None:
            del os.environ["MGLD_FUSED_GN_CONV"]
        else:
            os.environ["MGLD_FUSED_GN_CONV"] = before


def log(msg: str) -> None:
    print(msg, flush=True)


# seconds of wall of the phases' parts ("phase8 (b)": ...), summed over
# repeats; each phase's wall line lists its own
PARTS: dict = {}


@contextlib.contextmanager
def part(name: str):
    """Time the block into ``PARTS[name]``; ``name`` starts with its phase."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PARTS[name] = PARTS.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def wall(phase: str, card: str, times: dict):
    """Time the block: ``[phaseN] ... s of wall``, with the seconds of its
    parts, and ``times[phase]``."""
    t0 = time.perf_counter()
    yield
    times[phase] = time.perf_counter() - t0
    mine = {k: round(v, 1) for k, v in PARTS.items() if k.split()[0] == phase}
    log(f"[{phase}] {times[phase]:.1f} s of wall{f'; parts {mine}' if mine else ''}  [{card}]")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of one ``fn()``: ``iters`` calls are captured into one
    CUDA graph and the graph is replayed, so the host's launch path is not in
    the time."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds one ``fn()`` takes to return (checks, allocation and
    the launch's enqueue), the device's work not waited for."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * elapsed / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def device_activity(fn, where: str, calls: int = 10) -> tuple[float, float]:
    """(device activities a warm ``fn()``: kernels, memsets and copies; their
    summed device ms a call), from a ``torch.profiler`` CUDA trace of
    ``calls`` calls. The trace can miss the window's first activity, so one
    call alone may read one launch short. Raises, naming ``where``, on a
    trace without kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mgldvsr_tpu_torch.utils.profiling import check_kernels, reattach_cupti

    fn()
    torch.cuda.synchronize()
    reattach_cupti()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    check_kernels(prof, where, launched=True)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in events) / calls,
            sum(e.self_device_time_total for e in events) / 1000 / calls)


def bf16_ulps(count: int, want) -> float:
    """``count`` bfloat16 ulps at max |want|: a limit that follows the data."""
    return count * 2 ** -8 * float(want.float().abs().max())


def attention_inputs(bh: int, n: int, d: int, dtype, dev, gen):
    """q, k ~ N(0,1) and v ~ N(1,1). With a zero-mean v the outputs would be
    averages of N values around 0, std sqrt(e/N), a few 1e-2, and a limit
    that catches a dropped key tile or a wrong mask would sit in the rounding
    noise; with mean 1 the outputs are O(1) and such a fault moves them by
    several percent."""
    import torch

    q, k, v = (torch.randn(bh, n, d, device=dev, generator=gen) for _ in range(3))
    return q.to(dtype), k.to(dtype), (v + 1).to(dtype)


def lq_clip(seed: int, size: int, frames: int = 5, width: int | None = None) -> np.ndarray:
    """[T, size, width (default size), 3] in [0,1]: a smooth seeded pattern
    moving 2 px right and 1 px down per frame, so that flows are non-zero."""
    rs = np.random.RandomState(seed)
    width = size if width is None else width
    big_h, big_w = size + 4 * frames, width + 4 * frames
    yy, xx = np.mgrid[0:big_h, 0:big_w].astype(np.float32) / max(big_h, big_w)
    pattern = np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * (rs.uniform(1, 4) * xx + rs.uniform(1, 4) * yy
                                        + rs.uniform(0, 1)))
        for _ in range(3)], axis=-1)
    pattern += 0.05 * rs.rand(big_h, big_w, 3).astype(np.float32)
    clip = [pattern[f:f + size, 2 * f:2 * f + width] for f in range(frames)]
    return np.clip(np.stack(clip), 0.0, 1.0).astype(np.float32)


def calm_raft(pipe) -> None:
    """Scale RAFT's last flow-head conv by 1e-2. Random RAFT weights predict
    flows of several latent pixels that disagree between the two
    directions, so the consistency check marks every pixel occluded and the
    guidance gradient is exactly zero. Small flows stay under its 0.5 px
    threshold, so the guidance acts on the run as it would with trained
    weights."""
    import torch

    with torch.no_grad():
        pipe.raft.update_block.flow_head.conv2.weight.mul_(1e-2)


def guidance_inputs(b: int, t: int, c: int, case: str, dev, gen, h: int = 64, w: int = 64):
    """latents [b*t,h,w,c] ~ N(0,1) as NHWC views of NCHW memory, the layout
    the sampler holds them in (``packed``: contiguous NHWC), flows (forward,
    backward) [b,t-1,h,w,2] of about 2 px (or w + 2.5 everywhere: every tap
    outside), occlusions [b,t-1,h,w,1] at 30% (or none, or all)."""
    import torch

    if case == "packed":
        lat = torch.randn(b * t, h, w, c, device=dev, generator=gen)
    else:
        lat = torch.randn(b * t, c, h, w, device=dev, generator=gen).permute(0, 2, 3, 1)
    if case == "taps outside":
        flows = tuple(torch.full((b, t - 1, h, w, 2), w + 2.5, device=dev) for _ in range(2))
    else:
        flows = tuple(torch.randn(b, t - 1, h, w, 2, device=dev, generator=gen) * 2
                      for _ in range(2))
    share = {"all occluded": 1.0, "none occluded": 0.0}.get(case, 0.3)
    occs = tuple((torch.rand(b, t - 1, h, w, 1, device=dev, generator=gen) < share).float()
                 for _ in range(2))
    return lat, flows, occs


def small_residuals(lat, flows, occs, t: int, mode: str, eps: float = 1e-6) -> int:
    """Unmasked elements of the loss's terms whose residual |m prev - m lat|
    is under ``eps``: where a prev summed in another order could flip sgn."""
    from mgldvsr_tpu_torch.ops.kernels import guidance as guide_mod
    from mgldvsr_tpu_torch.ops.kernels.flow_warp import warp_plain

    lat5 = lat.reshape(lat.shape[0] // t, t, *lat.shape[1:])
    n = 0
    for tm in guide_mod.guidance_terms(t, mode):
        m = 1.0 - occs[tm.kind][:, tm.occ]
        prev = 0.0 if tm.src < 0 else warp_plain(lat5[:, tm.src], flows[1 - tm.kind][:, tm.flow])
        r = m * prev - m * lat5[:, tm.frame]
        n += int(((r.abs() < eps) & (m != 0)).sum())
    return n


def guidance_bytes(b: int, t: int, h: int, w: int, c: int, mode: str) -> dict:
    """Bytes float32 launches A and B and the whole gradient must move, from
    the term table: the latent frames the terms read, the mask slices they
    read, the flow slices their warps read, the gradient written; A also
    writes the cotangent scratch, which B reads, and B reads and writes the
    gradient of the warps' source frames alone."""
    from mgldvsr_tpu_torch.ops.kernels import guidance as guide_mod

    terms = guide_mod.guidance_terms(t, mode)
    warps = [tm for tm in terms if tm.slot >= 0]
    frame, pixels = 4 * b * h * w * c, b * h * w
    frames_read = len({tm.frame for tm in terms} | {tm.src for tm in warps})
    masks = 4 * pixels * len({(tm.kind, tm.occ) for tm in terms})
    flows = 8 * pixels * len({(tm.kind, tm.flow) for tm in warps})
    cot = frame * len(warps)
    pair = frame * frames_read + masks + flows + frame * t
    return {"A": pair + cot, "B": cot + flows + 2 * frame * len({tm.src for tm in warps}),
            "pair": pair}


def guidance_phase2(dev, gen, card: str, record) -> dict:
    """The guidance pair against its plain versions in every case, then timed
    at the restore's shape beside the autograd step it replaced."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.kernels import guidance as guide_mod

    worst = 0.0  # the direct part's and the cotangent's error over the cases
    for b, t, c, case in ((1, 5, 4, "random"), (1, 5, 4, "packed"), (2, 3, 4, "random"),
                          (2, 2, 4, "random"), (1, 5, 3, "random"), (1, 5, 3, "packed"),
                          (1, 5, 4, "none occluded"), (1, 5, 4, "all occluded"),
                          (1, 5, 4, "taps outside")):
        for mode in ("reference", "aligned"):
            lat, flows, occs = guidance_inputs(b, t, c, case, dev, gen)
            kernels.reset_launch_counts()
            grad, cot = guide_mod.guidance_residual(lat, flows, occs, t, mode)
            direct, want_cot = guide_mod.guidance_residual_plain(lat, flows, occs, t, mode)
            err_a = max(max_err(grad, direct), max_err(cot, want_cot) if cot.numel() else 0.0)
            got = guide_mod.guidance_scatter(grad, cot, flows, t, mode)
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            want = guide_mod.guidance_grad_plain(lat, flows, occs, t, mode)
            err, tol = max_err(got, want), 1e-6 * float(want.abs().max())
            log(f"[phase2] guidance pair b={b} t={t} [64,64,{c}] {mode}, {case}: direct part and "
                f"cotangent max_abs_err {err_a:.3e} (limit 0: bit for bit), gradient "
                f"{err:.3e} (limit {tol:.3e}), residuals under 1e-6 "
                f"{small_residuals(lat, flows, occs, t, mode)}, launches {counts}")
            slots = guide_mod.warp_slots(t, mode)
            if not (err_a == 0.0 and err <= tol and torch.isfinite(got).all()):
                raise AssertionError(f"guidance pair b={b} t={t} c={c} {mode} {case}: "
                                     f"{err_a:.3e} > 0 or {err:.3e} > {tol:.3e}")
            if counts != {"guidance_residual": 1, **({"guidance_scatter": 1} if slots else {})}:
                raise AssertionError(f"guidance pair: launches {counts}, slots {slots}")
            if bool(want.any()) != (case != "all occluded"):
                raise AssertionError(f"guidance pair {case}: the gradient is zero or not zero")
            worst = max(worst, err_a)

    # timed at the restore's call: one window of 5 frames, reference mode
    lat, flows, occs = guidance_inputs(1, 5, 4, "random", dev, gen)
    grad, cot = guide_mod.guidance_residual(lat, flows, occs, 5)
    want = guide_mod.guidance_grad_plain(lat, flows, occs, 5)
    shape = "b=1, t=5, [64,64,4] f32 (NCHW memory, as the sampler holds it), reference"
    moved = guidance_bytes(1, 5, 64, 64, 4, "reference")
    record("guidance_residual", worst, 0.0,
           cuda_ms(lambda: guide_mod.guidance_residual(lat, flows, occs, 5)),
           cuda_ms(lambda: guide_mod.guidance_residual_plain(lat, flows, occs, 5)),
           shape + " (error: the worst of the 18 cases)",
           *bound(moved["A"], 40.0 * lat.numel() * 2, "f32"),
           device_ms=graph_ms(lambda: guide_mod.guidance_residual(lat, flows, occs, 5)))
    scratch = grad.clone()
    got = guide_mod.guidance_scatter(grad.clone(), cot, flows, 5)
    record("guidance_scatter", max_err(got, want), 1e-6 * float(want.abs().max()),
           cuda_ms(lambda: guide_mod.guidance_scatter(scratch, cot, flows, 5)),
           cuda_ms(lambda: guide_mod.guidance_scatter_plain(scratch, cot, flows, 5)),
           shape + " (the pair's gradient vs guidance_grad_plain)",
           *bound(moved["B"], 16.0 * cot.numel(), "f32"),
           device_ms=graph_ms(lambda: guide_mod.guidance_scatter(scratch, cot, flows, 5)))

    def pair():
        return guide_mod.guidance_grad(lat, flows, occs, 5)

    # launch B's sum is fixed point: every call gives the same bits
    first = pair()
    if not all(torch.equal(pair(), first) for _ in range(5)):
        raise AssertionError("guidance: two calls of the pair on the same inputs differ")

    def autograd_step():
        """What the sampler ran per step before the pair: the loss through
        kernels 1 and 2, then torch.autograd.grad."""
        with torch.enable_grad():
            leaf = lat.detach().requires_grad_(True)
            loss = guide_mod.temporal_warp_loss(leaf, flows, occs, 5)
            return torch.autograd.grad(loss, leaf)[0]

    kernels.reset_launch_counts()
    old = autograd_step()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    err_old, tol = max_err(old, pair()), 1e-6 * float(want.abs().max())
    if counts != {"warp_forward": 1, "warp_dx": 1} or not err_old <= tol:
        raise AssertionError(f"guidance: the autograd step launched {counts}, differs by "
                             f"{err_old:.3e} (limit {tol:.3e})")
    n_old, dev_old = device_activity(autograd_step, "phase 2: the autograd guidance step")
    n_new, dev_new = device_activity(pair, "phase 2: the guidance pair")
    # launch A, the accumulator's zero fill, launch B and its finishing kernel
    if round(n_new) != 4:
        raise AssertionError(f"guidance: the pair made {n_new} device launches a call, "
                             f"expected 4")
    out = {
        "shape": shape, "ms": cuda_ms(pair), "device_ms": graph_ms(pair),
        "host_us": host_us(pair), "launches": n_new, "device_activity_ms": dev_new,
        "autograd_step_ms": cuda_ms(autograd_step), "autograd_step_launches": n_old,
        "autograd_step_device_activity_ms": dev_old,
        "plain_ms": cuda_ms(lambda: guide_mod.guidance_grad_plain(lat, flows, occs, 5)),
        "bound_ms": bound(moved["pair"], 40.0 * lat.numel() * 2, "f32")[0],
        "max_abs_err_vs_autograd_step": err_old}
    log(f"[phase2] guidance gradient, {shape}: the pair {out['ms']:.4f} ms a call in a host "
        f"loop (on the device {out['device_ms']:.4f} ms, {out['host_us']:.1f} us to return), "
        f"{n_new:g} device launches a call ({dev_new:.4f} ms of device time); the autograd "
        f"step it replaced {out['autograd_step_ms']:.4f} ms, {n_old:g} device launches "
        f"({dev_old:.4f} ms); plain version {out['plain_ms']:.4f} ms; bound "
        f"{out['bound_ms']:.4f} ms (bytes: {moved['pair']} B; launch A {moved['A']} B, B "
        f"{moved['B']} B); pair vs autograd step max_abs_err {err_old:.3e}  [{card}]")
    return out


def attention_checks(dev, gen) -> None:
    """The attention kernels off the timed shapes: ragged N, large logits,
    the strided entry, and the dispatch between the two kernels."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.kernels import attention as attn_mod

    bf16 = torch.bfloat16

    def check(what, got, want, tol, want_counts):
        err = max_err(got, want)
        counts = {name: n for name, n in kernels.launch_counts().items() if "attention" in name}
        log(f"[phase2] attention {what}: max_abs_err {err:.3e} (limit {tol:.3e}), {counts}")
        if not err <= tol or not torch.isfinite(got).all():
            raise AssertionError(f"attention {what}: {err:.3e} > {tol:.3e}")
        if counts != want_counts:
            raise AssertionError(f"attention {what}: launches {counts}, expected {want_counts}")

    def qkv(bh, n, d, dtype):
        return attention_inputs(bh, n, d, dtype, dev, gen)

    def counts(wgmma: int, strided: int):
        return {"attention": 1, "attention_wgmma": wgmma, "attention_strided": strided,
                "attention_wide": 0, "attention_wide_strided": 0}

    # N off the 128-row tiles: masked keys, unwritten query rows. Held against
    # the plain version in bf16 and in float32 on the same bf16 values.
    q, k, v = qkv(8, 1100, 64, bf16)
    for name, want in (("bf16", attn_mod.attention_plain(q, k, v)),
                       ("f32", attn_mod.attention_plain(q.float(), k.float(), v.float()))):
        kernels.reset_launch_counts()
        check(f"ragged [8,1100,64] bf16 vs the plain version in {name}",
              attn_mod.attention(q, k, v), want, bf16_ulps(3, want), counts(1, 1))
    # logits of tens (q scaled by 8): the running max moves and the accumulator
    # is rescaled from tile to tile. The plain version in bf16 rounds its
    # logits to bf16 (a relative 2^-9 of ~60 is several percent of a
    # probability), so the reference here is the plain version in float32 on
    # the same bf16 values; the kernel's own rounding of P to bf16 stays
    # within the same 2e-2.
    q, k, v = qkv(8, 1100, 64, bf16)
    q = q * 8
    kernels.reset_launch_counts()
    check("large logits [8,1100,64] bf16 vs the plain version in f32",
          attn_mod.attention(q, k, v), attn_mod.attention_plain(q.float(), k.float(), v.float()),
          2e-2, counts(1, 1))
    # the same heads through [B,N,H,D] strides, as the UNet's CrossAttention
    # hands them over: bit for bit the folded call, no copy made
    for b, n, h in ((5, 4096, 5), (5, 1024, 10)):
        q, k, v = (z.reshape(b, n, h, 64) for z in qkv(b, n, h * 64, bf16))
        folded = attn_mod.attention(*(z.permute(0, 2, 1, 3).reshape(b * h, n, 64).contiguous()
                                      for z in (q, k, v)))
        kernels.reset_launch_counts()
        got = attn_mod.attention_bnhd(q, k, v)
        check(f"strided [{b},{n},{h},64] bf16 vs the folded call, bit for bit", got,
              folded.reshape(b, h, n, 64).permute(0, 2, 1, 3), 0.0, counts(1, 1))
        if not got.is_contiguous():
            raise AssertionError("attention: the strided entry's output is not contiguous")
    # a [B,N,H,D] operand that is contiguous but whose base is 2 bytes off a
    # 16-byte boundary cannot be read in place: it is copied, not faulted on
    flat = [z.reshape(-1) for z in qkv(10, 1025, 64, bf16)]
    q, k, v = (z[1:1 + 2 * 1024 * 5 * 64].view(2, 1024, 5, 64) for z in flat)
    if not (q.is_contiguous() and q.data_ptr() % 16 == 2):
        raise AssertionError("attention: the misaligned operand is not what it should be")
    want = attn_mod.attention_bnhd(q.clone(), k.clone(), v.clone())
    kernels.reset_launch_counts()
    check("[2,1024,5,64] bf16 with bases 2 bytes off 16 vs aligned copies, bit for bit",
          attn_mod.attention_bnhd(q, k, v), want, 0.0, counts(1, 0))
    # float32 (the parity mode) and bf16 at head dim 16 take the FMA kernel,
    # whose probabilities stay in float32
    for d, dtype in ((64, torch.float32), (16, bf16)):
        q, k, v = qkv(8, 1024, d, dtype)
        want = attn_mod.attention_plain(q.float(), k.float(), v.float())
        kernels.reset_launch_counts()
        check(f"[8,1024,{d}] {'bf16' if dtype == bf16 else 'f32'} vs the plain version in f32",
              attn_mod.attention(q, k, v), want, bf16_ulps(3, want) if dtype == bf16 else 1e-4,
              counts(0, 0))


# the VAE's mid attention at the gate's smallest and largest latents: 32^2,
# 48^2 and 57^2 in bf16 (frames of 256, 384 and 456 px), 32^2 and 45^2 in
# float32 (256 and 360 px)
WIDE_SHAPES = (("bf16", 1024), ("bf16", 2304), ("bf16", 3249), ("f32", 1024), ("f32", 2025))


def wide_attention(dev, gen, card: str) -> dict:
    """The head-dim-512 kernels at every shape of ``WIDE_SHAPES``, 5 frames,
    in bf16 (the default towers; the tensor-core kernel) and float32 (the
    parity mode, phase 13 (a); the FMA kernel). Limits as the FMA kernel's:
    3 bf16 ulps at max |want| in bf16, 1e-4 in float32, against the plain
    version on the same inputs and in float32 on the same values. 4 N^2 D
    flops a head; the bound takes the type's peak (the tensor cores' for
    bf16). Beside the kernel alone (token rows, contiguous): ``attend`` on
    the VAE's own views with the block's reshape back to NCHW (``vae_ms``:
    read in place in bf16 where N is a multiple of 8, copies otherwise),
    and the same views copied into token rows first (``folded_ms``), which
    in bf16 must give the same bits."""
    import torch
    import torch.nn.functional as F

    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.attention import attend
    from mgldvsr_tpu_torch.ops.kernels import attention as attn_mod

    out = {}
    for kind, n in WIDE_SHAPES:
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        side = int(round(n ** 0.5))
        q, k, v = attention_inputs(5, n, 512, dtype, dev, gen)
        kernels.reset_launch_counts()
        got = attn_mod.attention(q, k, v)
        counts = {name: c for name, c in kernels.launch_counts().items() if "attention" in name}
        want32 = attn_mod.attention_plain(q.float(), k.float(), v.float())
        tol = bf16_ulps(3, want32) if dtype == torch.bfloat16 else 1e-4
        err = max(max_err(got, want32), max_err(got, attn_mod.attention_plain(q, k, v)))
        del want32
        if counts != {"attention": 1, "attention_wgmma": 0, "attention_strided": 0,
                      "attention_wide": 1, "attention_wide_strided": 1}:
            raise AssertionError(f"attention wide [5,{n},512] {kind}: launches {counts}")
        if not (err <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"attention wide [5,{n},512] {kind}: {err:.3e} > {tol:.3e}")
        # the same values as the VAE hands them over: [5,512,N] viewed [5,N,1,512]
        views = [z.transpose(1, 2).contiguous().transpose(1, 2)[:, :, None] for z in (q, k, v)]

        def vae():
            return attend(*views)[:, :, 0].transpose(1, 2).reshape(5, 512, side, side)

        def folded():
            o = attn_mod.attention(*(z[:, :, 0].contiguous() for z in views))
            return o.transpose(1, 2).reshape(5, 512, side, side)

        kernels.reset_launch_counts()
        through_views = vae()
        in_place = kernels.launch_counts()["attention_wide_strided"]
        if in_place != int(dtype == torch.bfloat16 and n % 8 == 0):
            raise AssertionError(f"attention wide [5,{n},512] {kind}: the VAE's views were "
                                 f"read in place {in_place} times")
        same = torch.equal(through_views, folded())
        if dtype == torch.bfloat16 and not same:
            raise AssertionError(f"attention wide [5,{n},512] bf16: the VAE's views differ "
                                 f"from the folded call by {max_err(through_views, folded()):.3e}")
        row = {"shape": f"[5,{n},512] {kind}", "max_abs_err": err, "limit": tol,
               "ms": cuda_ms(lambda: attn_mod.attention(q, k, v), iters=10),
               "plain_ms": cuda_ms(lambda: attn_mod.attention_plain(q, k, v), iters=10),
               "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                   q[None], k[None], v[None]), iters=10),
               "vae_ms": cuda_ms(vae, iters=10), "vae_in_place": bool(in_place),
               "folded_ms": cuda_ms(folded, iters=10), "vae_equals_folded": same}
        row["bound_ms"], row["bound_by"] = bound(nbytes(q, k, v, got),
                                                 4.0 * 5 * n * n * 512, kind)
        log(f"[phase2] attention wide [5,{n},512] {kind} vs the plain version: max_abs_err "
            f"{err:.3e} (limit {tol:.3e}) kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); the VAE's views "
            f"{'in place' if in_place else 'copied'} {row['vae_ms']:.4f} ms, copied into "
            f"token rows {row['folded_ms']:.4f} ms, the same bits: {same}; {counts}  [{card}]")
        out[row["shape"]] = row
        del q, k, v, got, views, through_views
    return out


def group_norm_case(shape, dtype, dev, gen):
    import torch

    x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5).to(dtype)
    return (x, torch.randn(shape[1], device=dev, generator=gen),
            torch.randn(shape[1], device=dev, generator=gen))


def group_norm_limit(want) -> float:
    """2 ulps at max |y| in bf16 (a folded scale or shift that rounds to the
    neighbouring value), 1e-5 in float32 (sums in another order)."""
    import torch

    return 1e-5 + (bf16_ulps(2, want) if want.dtype == torch.bfloat16 else 0.0)


def group_norm_checks(dev, gen) -> None:
    """The fused GroupNorm off the timed shapes: each split of a slab among
    the blocks of a cluster, staged in shared memory and walked twice, slabs
    off the 16-byte boundary, channels that end inside a vector, a constant."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.kernels import groupnorm as gn_mod

    bf16, f32 = torch.bfloat16, torch.float32

    def check(what, got, want, tol):
        err = max_err(got, want)
        log(f"[phase2] fused_group_norm {what}: max_abs_err {err:.3e} (limit {tol:.3e})")
        if not err <= tol or not torch.isfinite(got).all():
            raise AssertionError(f"fused_group_norm {what}: {err:.3e} > {tol:.3e}")

    for shp, dtype, plan, what in (
            ((5, 1280, 8, 8), bf16, (1, 5120), "one block a slab"),
            ((5, 1280, 16, 16), bf16, (2, 10240), "a cluster of 2"),
            ((5, 640, 32, 32), bf16, (4, 10240), "a cluster of 4"),
            ((2, 960, 64, 64), bf16, (8, 30720), "a cluster of 8"),
            ((1, 64, 300, 300), bf16, (8, 45008), "staged shares, the last one shorter"),
            ((1, 1280, 5, 64, 64), f32, (8, 0), "shares of 400 KB, walked twice"),
            ((3, 64, 7, 9), bf16, (1, 256), "slabs of 252 bytes, bases off 16, odd channels"),
            ((1, 96, 37, 37), bf16, (1, 8224), "a ragged end under one vector"),
            ((2, 32, 3, 1), bf16, (1, 16), "channels shorter than a vector")):
        x, w, b = group_norm_case(shp, dtype, dev, gen)
        slabs, cg = shp[0] * 32, shp[1] // 32
        got_plan = gn_mod.fused_gn_plan(slabs, x[0].numel() // 32, x.element_size(), cg)
        if got_plan != plan:
            raise AssertionError(f"fused_group_norm {list(shp)}: plan {got_plan}, expected {plan}")
        kernels.reset_launch_counts()
        got = gn_mod.fused_group_norm(x, w, b, 32, 1e-5)
        if {k: v for k, v in kernels.launch_counts().items() if v} != {"fused_group_norm": 1}:
            raise AssertionError("fused_group_norm: a call is not one launch")
        want = gn_mod.fused_group_norm_plain(x, w, b, 32, 1e-5)
        check(f"{list(shp)} {'bf16' if dtype == bf16 else 'f32'} (split, staged bytes) = {plan}: "
              f"{what}", got, want, group_norm_limit(want))
        del x, got, want
    # a contiguous view one element into its buffer: every slab base off 16 bytes
    flat = (torch.randn(2 * 64 * 16 * 16 + 1, device=dev, generator=gen) * 2 + 0.5).to(bf16)
    x = flat[1:].view(2, 64, 16, 16)
    w, b = (torch.randn(64, device=dev, generator=gen) for _ in range(2))
    if x.data_ptr() % 16 == 0:
        raise AssertionError("fused_group_norm: the misaligned view is not what it should be")
    want = gn_mod.fused_group_norm_plain(x, w, b, 32, 1e-5)
    check("[2,64,16,16] bf16, a view 2 bytes off 16", gn_mod.fused_group_norm(x, w, b, 32, 1e-5),
          want, group_norm_limit(want))
    # x = 2 everywhere: exact sums, variance 0, a = w / sqrt(eps), and y is
    # the bias up to the rounding of two numbers of the size of 2 a
    x = torch.full((2, 64, 16, 16), 2.0, device=dev, dtype=bf16)
    got = gn_mod.fused_group_norm(x, w, b, 32, 1e-5)
    size = 2 * 1e-5 ** -0.5 * float(w.abs().max())
    check("[2,64,16,16] bf16, a constant (variance clipped at 0; 2 ulps of max |2 a|)", got,
          gn_mod.fused_group_norm_plain(x, w, b, 32, 1e-5), 2 * 2 ** -8 * size)


def lookup_checks(dev, gen) -> None:
    """The RAFT lookup off the timed shape: ragged and empty level maps,
    centres outside the maps and thousands of pixels away, another radius."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.kernels import corr_lookup as corr_mod

    pyr = [torch.randn(2, 256, hl, wl, device=dev, generator=gen)
           for hl, wl in ((16, 16), (8, 8), (5, 3), (1, 7), (0, 0))]
    coords = torch.rand(2, 16, 16, 2, device=dev, generator=gen) * 30 - 8
    coords[0, 0, :3] = torch.tensor([[-3e4, 5.0], [5.0, 4e4], [1e9, -1e9]], device=dev)
    for radius in (4, 2):
        kernels.reset_launch_counts()
        got = corr_mod.lookup_corr(pyr, coords, radius)
        if kernels.launch_counts()["corr_lookup"] != 1:
            raise AssertionError("corr_lookup: a call is not one launch")
        err = max_err(got, corr_mod.lookup_corr_plain(pyr, coords, radius))
        log(f"[phase2] corr_lookup 5 levels [2,256,16x16, 8x8, 5x3, 1x7, 0x0], radius {radius}, "
            f"centres up to 1e9 px away: max_abs_err {err:.3e} (limit 1e-5)")
        if not err <= 1e-5 or got[0, 0, :3].any():
            raise AssertionError(f"corr_lookup: ragged levels, radius {radius}: {err:.3e}")


def phase2(card: str):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from mgldvsr_tpu_torch.flow.raft import build_corr_pyramid
    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.kernels import attention as attn_mod
    from mgldvsr_tpu_torch.ops.kernels import corr_lookup as corr_mod
    from mgldvsr_tpu_torch.ops.kernels import flow_warp as warp_mod
    from mgldvsr_tpu_torch.ops.kernels import gn_silu_conv as conv_mod
    from mgldvsr_tpu_torch.ops.kernels import groupnorm as gn_mod

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def record(name, err, tol, ms, plain_ms, shape, bound_ms, bound_by, library_ms=None,
               device_ms=None):
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        dev_txt = "" if device_ms is None else f" (on the device {device_ms:.4f} ms)"
        log(f"[phase2] {name} {shape}: max_abs_err {err:.3e} (limit {tol:.1e}) "
            f"kernel {ms:.4f} ms{dev_txt}, plain {plain_ms:.4f} ms, library {lib}, "
            f"bound {bound_ms:.4f} ms ({bound_by})  [{card}]")
        if not err <= tol:
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"({err:.3e} > {tol:.1e})")
        # the JSON line carries each kernel's first shape; max_abs_err its worst (with
        # phase 15 (e)'s shapes folded in)
        first = results.setdefault(name, {
            "shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "device_ms": device_ms})
        first["max_abs_err"] = max(first["max_abs_err"], err)

    # the standalone warp: 2(t-2) = 6 latents of one 5-frame window at
    # 64x64x4; 4 taps of 2 flops and ~12 flops of weights per output element.
    # The library call: F.grid_sample (bilinear, zeros, align_corners=True) of
    # the NCHW latents at the normalised p + flow, and its input gradient.
    x = torch.randn(6, 64, 64, 4, device=dev, generator=gen)
    flow = torch.randn(6, 64, 64, 2, device=dev, generator=gen) * 3
    g = torch.randn(6, 64, 64, 4, device=dev, generator=gen)
    shape = "x[6,64,64,4] f32"
    warp_bound = bound(nbytes(x, flow, x), 20 * x.numel(), "f32")
    gy, gx = torch.meshgrid(torch.arange(64.0, device=dev), torch.arange(64.0, device=dev),
                            indexing="ij")
    grid = torch.stack([(gx + flow[..., 0]) * (2 / 63) - 1, (gy + flow[..., 1]) * (2 / 63) - 1],
                       -1)
    xn, gn = (z.permute(0, 3, 1, 2).contiguous() for z in (x, g))

    def sample():
        return F.grid_sample(xn, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    def sample_dx():
        return torch.ops.aten.grid_sampler_2d_backward(gn, xn, grid, 0, 0, True, [True, False])

    log(f"[phase2]   F.grid_sample vs the plain warp: max_abs_err "
        f"{max_err(sample().permute(0, 2, 3, 1), warp_mod.warp_plain(x, flow)):.3e}; its "
        f"backward vs the plain dx "
        f"{max_err(sample_dx()[0].permute(0, 2, 3, 1), warp_mod.warp_dx_plain(g, flow)):.3e} "
        f"(another rounding of p + flow)")
    got = warp_mod.warp_forward(x, flow)
    if not torch.equal(got, warp_mod.warp_plain(x, flow)):
        raise AssertionError("warp_forward: the float4 kernel differs from the plain warp")
    record("warp_forward", max_err(got, warp_mod.warp_plain(x, flow)), 0.0,
           cuda_ms(lambda: warp_mod.warp_forward(x, flow)),
           cuda_ms(lambda: warp_mod.warp_plain(x, flow)), shape, *warp_bound, cuda_ms(sample),
           device_ms=graph_ms(lambda: warp_mod.warp_forward(x, flow)))
    log(f"[phase2]   the host's share of a call: "
        f"{host_us(lambda: warp_mod.warp_forward(x, flow)):.1f} us to return, F.grid_sample "
        f"{host_us(sample):.1f} us")
    # 3-channel frames at 512^2 (E*warp's 4 pairs, one swc pair) under three flows
    frames = {f"[{n},512,512,3] {kind}": warp_alone(card, n, "phase2", kind)
              for n in (4, 1) for kind in WARP_FLOWS}
    results["warp_forward"]["frames_512"] = frames
    xr = x.clone().requires_grad_(True)
    warp_mod.warp_plain(xr, flow).backward(g)
    dx = warp_mod.warp_dx(g, flow)
    err = max(max_err(dx, warp_mod.warp_dx_plain(g, flow)), max_err(dx, xr.grad))
    record("warp_dx", err, 1e-5, cuda_ms(lambda: warp_mod.warp_dx(g, flow)),
           cuda_ms(lambda: warp_mod.warp_dx_plain(g, flow)), shape + " (vs plain and autograd)",
           *warp_bound, cuda_ms(sample_dx), device_ms=graph_ms(lambda: warp_mod.warp_dx(g, flow)))
    del grid, xn, gn
    pair = guidance_phase2(dev, gen, card, record)
    results["guidance_residual"]["pair"] = results["guidance_scatter"]["pair"] = pair

    # attention: UNet self-attention at 64^2 (5 frames x 5 heads) and 32^2
    # (5 x 10), struct-cond at 64^2 (5 x 4), head dim 64, bf16: the
    # tensor-core kernel. Outputs are O(1) (attention_inputs) and the limit
    # is 3 bf16 ulps at max |want|, about 1e-2: the kernel and the plain
    # version each round the probabilities and the output to bf16 once. It
    # holds against the plain version on the same bf16 inputs and against the
    # plain version in float32 on the same values. 4 N^2 D flops per head.
    for bh, n in ((25, 4096), (50, 1024), (20, 4096)):
        q, k, v = attention_inputs(bh, n, 64, torch.bfloat16, dev, gen)
        kernels.reset_launch_counts()
        out = attn_mod.attention(q, k, v)
        if kernels.launch_counts()["attention_wgmma"] != 1:
            raise AssertionError("attention: bf16 at head dim 64 did not take the wgmma kernel")
        want32 = attn_mod.attention_plain(q.float(), k.float(), v.float())
        err32, tol = max_err(out, want32), bf16_ulps(3, want32)
        log(f"[phase2] attention [{bh},{n},64] bf16 vs the plain version in f32: max_abs_err "
            f"{err32:.3e} (limit {tol:.3e}), max |want| {float(want32.abs().max()):.3f}")
        if not err32 <= tol:
            raise AssertionError(f"attention: kernel disagrees with the plain version in f32 "
                                 f"({err32:.3e} > {tol:.3e})")
        del want32
        record("attention", max_err(out, attn_mod.attention_plain(q, k, v)), tol,
               cuda_ms(lambda: attn_mod.attention(q, k, v), iters=10),
               cuda_ms(lambda: attn_mod.attention_plain(q, k, v), iters=10),
               f"[{bh},{n},64] bf16", *bound(nbytes(q, k, v, out), 4.0 * bh * n * n * 64, "bf16"),
               cuda_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None]),
                       iters=10))
        del q, k, v, out
    # one block to an SM against two (33 blocks of 128 rows a head at N = 4224):
    # what a partial last wave costs
    wave_ms = {}
    for bh in (4, 8):
        q, k, v = (torch.randn(bh, 4224, 64, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        wave_ms[bh] = cuda_ms(lambda: attn_mod.attention(q, k, v), iters=10)
    log(f"[phase2]   wgmma kernel [4,4224,64] (132 blocks, one to an SM) {wave_ms[4]:.4f} ms, "
        f"[8,4224,64] (264 blocks, two to an SM) {wave_ms[8]:.4f} ms = "
        f"{4e-9 * 8 * 4224 * 4224 * 64 / wave_ms[8]:.0f} TFLOP/s  [{card}]")
    results["attention"]["variant"] = ("wgmma (attention_wgmma_kernel) for bf16 at head dim 64; "
                                       "wide_wgmma (attention_wide_wgmma_kernel) for bf16 and "
                                       "wide_fma (attention_wide_fma_kernel) for f32 at head "
                                       "dim 512; fma (attention_kernel) for f32 and other "
                                       "head dims")
    attention_checks(dev, gen)
    results["attention"]["wide"] = wide_attention(dev, gen, card)

    # RAFT lookup: 8 frame pairs, 64x64 queries at 1/8 of 512px, 4 levels, r=4.
    # Data-dependent reads: a query touches at most (2r+2)^2 cells of a level.
    f1 = torch.randn(8, 256, 64, 64, device=dev, generator=gen)
    f2 = torch.randn(8, 256, 64, 64, device=dev, generator=gen)
    pyr = [p.contiguous() for p in build_corr_pyramid(f1, f2, 4)]
    gy, gx = torch.meshgrid(torch.arange(64.0, device=dev), torch.arange(64.0, device=dev),
                            indexing="ij")
    coords = (torch.stack([gx, gy], -1)[None]
              + torch.randn(8, 64, 64, 2, device=dev, generator=gen) * 4).contiguous()
    kernels.reset_launch_counts()
    got = corr_mod.lookup_corr(pyr, coords, 4)
    if kernels.launch_counts()["corr_lookup"] != 1:
        raise AssertionError("corr_lookup: a call is not one launch")
    cells = sum(min(100, p.shape[-1] * p.shape[-2]) for p in pyr)
    # the library call: RAFT's own CorrBlock lookup, F.grid_sample of the
    # (2r+1)^2 window grid around each query at each level
    side = torch.arange(-4.0, 5.0, device=dev)
    delta = torch.stack(torch.meshgrid(side, side, indexing="ij"), -1)  # RAFT's (dy, dx) order
    maps, grids = [], []
    for lvl, p in enumerate(pyr):
        hl, wl = p.shape[-2:]
        at = coords.reshape(-1, 1, 1, 2) / 2 ** lvl + delta
        maps.append(p.reshape(-1, 1, hl, wl))
        grids.append(torch.stack([at[..., 0] * (2 / (wl - 1)) - 1, at[..., 1] * (2 / (hl - 1)) - 1],
                                 -1))

    def corr_block():
        return [F.grid_sample(m, gr, align_corners=True) for m, gr in zip(maps, grids)]

    lib_out = torch.cat([o.reshape(8, 4096, 81) for o in corr_block()], -1)
    log(f"[phase2]   RAFT's CorrBlock (F.grid_sample a level) vs the plain lookup: max_abs_err "
        f"{max_err(lib_out, corr_mod.lookup_corr_plain(pyr, coords, 4).reshape(8, 4096, -1)):.3e}")
    record("corr_lookup", max_err(got, corr_mod.lookup_corr_plain(pyr, coords, 4)),
           1e-4, cuda_ms(lambda: corr_mod.lookup_corr(pyr, coords, 4)),
           cuda_ms(lambda: corr_mod.lookup_corr_plain(pyr, coords, 4), iters=5),
           "pyramid [8,4096,64^2..8^2] f32, coords [8,64,64,2]",
           *bound(8 * 4096 * cells * 4 + nbytes(coords, got), 8.0 * got.numel(), "f32"),
           cuda_ms(corr_block), graph_ms(lambda: corr_mod.lookup_corr(pyr, coords, 4)))
    del maps, grids, lib_out
    log(f"[phase2]   the host's share of a call: "
        f"{host_us(lambda: corr_mod.lookup_corr(pyr, coords, 4)):.1f} us to return")
    lookup_checks(dev, gen)
    del f1, f2, pyr, got

    # channel sums: the VAE's 512^2 level of the restore (5 frames x 128
    # channels) and text to image's batch-1 decode at 128^2 and 256^2 (256
    # rows), bf16; float32 sums of up to 262144 terms: the limit is relative
    # to the sums' size. Two calls give the same bits (no atomics).
    for shp in ((5, 128, 512, 512), (1, 256, 128, 128), (1, 256, 256, 256)):
        xb = torch.randn(shp, device=dev, generator=gen).to(torch.bfloat16) + 0.5
        s = gn_mod.channel_sums(xb)
        p = gn_mod.channel_sums_plain(xb)
        err = max(max_err(s[0], p[0]), max_err(s[1], p[1]))
        if not all(torch.equal(a, b) for a, b in zip(s, gn_mod.channel_sums(xb))):
            raise AssertionError(f"channel_sums {list(shp)}: two calls differ")
        label = f"{list(shp)} bf16"
        r = {"ms": cuda_ms(lambda: gn_mod.channel_sums(xb)),
             "device_ms": graph_ms(lambda: gn_mod.channel_sums(xb)),
             "host_us": host_us(lambda: gn_mod.channel_sums(xb)),
             "plain_ms": cuda_ms(lambda: gn_mod.channel_sums_plain(xb)),
             "library_ms": cuda_ms(lambda: torch.var_mean(xb, dim=(2, 3))),
             "library_device_ms": graph_ms(lambda: torch.var_mean(xb, dim=(2, 3))),
             "library_host_us": host_us(lambda: torch.var_mean(xb, dim=(2, 3))),
             "threads": gn_mod.channel_sums_plan(shp[0] * shp[1], shp[2] * shp[3], 2)}
        r["bound_ms"], r["bound_by"] = bound(nbytes(xb, *s), 3.0 * xb.numel(), "f32")
        record("channel_sums", err, 1e-5 * float(p[1].abs().max()), r["ms"], r["plain_ms"],
               label, r["bound_ms"], r["bound_by"], r["library_ms"], r["device_ms"])
        results["channel_sums"].setdefault("shapes", {})[label] = r
        log(f"[phase2]   threads a block {r['threads']}; the host's share of a call: "
            f"{r['host_us']:.1f} us to return; torch.var_mean {r['library_host_us']:.1f} us, on "
            f"the device {r['library_device_ms']:.4f} ms")
        del xb, s, p

    # fused GroupNorm: the UNet's levels, the 960-channel skip concat (the
    # longest slab, 240 KB: a cluster of 8), a 5-D temporal input, and float32.
    # The folded scale and shift may round to the neighbouring bf16, so the
    # limit is 2 ulps at max |y|; float32 1e-5 (sums in another order).
    bf16, f32 = torch.bfloat16, torch.float32
    for shp, dtype, eps in (((5, 320, 64, 64), bf16, 1e-5), ((5, 960, 64, 64), bf16, 1e-5),
                            ((5, 1280, 8, 8), bf16, 1e-6), ((1, 1280, 5, 8, 8), bf16, 1e-5),
                            ((5, 32, 64, 64), f32, 1e-5), ((5, 32, 64, 64), f32, 1e-6)):
        x, w, b = group_norm_case(shp, dtype, dev, gen)
        got = gn_mod.fused_group_norm(x, w, b, 32, eps)
        want = gn_mod.fused_group_norm_plain(x, w, b, 32, eps)
        wd, bd = w.to(dtype), b.to(dtype)
        record("fused_group_norm", max_err(got, want), group_norm_limit(want),
               cuda_ms(lambda: gn_mod.fused_group_norm(x, w, b, 32, eps)),
               cuda_ms(lambda: gn_mod.fused_group_norm_plain(x, w, b, 32, eps)),
               f"{list(shp)} {'bf16' if dtype == bf16 else 'f32'} eps {eps:g}",
               *bound(nbytes(x, got, w, b), 8.0 * x.numel(), "f32"),
               cuda_ms(lambda: F.group_norm(x, 32, wd, bd, eps)),
               graph_ms(lambda: gn_mod.fused_group_norm(x, w, b, 32, eps)))
        log(f"[phase2]   the host's share of a call: "
            f"{host_us(lambda: gn_mod.fused_group_norm(x, w, b, 32, eps)):.1f} us to return, "
            f"F.group_norm {host_us(lambda: F.group_norm(x, 32, wd, bd, eps)):.1f} us")
        del x, got, want
    group_norm_checks(dev, gen)

    # the fused chain's statistics: the folded (scale, shift) of GroupNorm in
    # one launch, a cluster of blocks per (sample, group) slab; fp32 sums in
    # another order than the plain version's: 1e-5 of the largest value
    for shp, eps in (((5, 320, 64, 64), 1e-5), ((5, 960, 64, 64), 1e-5), ((5, 1280, 8, 8), 1e-6),
                     ((5, 128, 512, 512), 1e-6)):
        x = (torch.randn(shp, device=dev, generator=gen) * 2 + 0.5).to(bf16)
        w = torch.randn(shp[1], device=dev, generator=gen)
        b = torch.randn(shp[1], device=dev, generator=gen)

        def stats():
            return gn_mod.gn_scale_shift(x, w, b, 32, eps)

        got, want = stats(), gn_mod.gn_scale_shift_plain(x, w, b, 32, eps)
        err = max(max_err(a, p) / float(p.abs().max()) for a, p in zip(got, want))
        iters = 5 if shp[2] >= 512 else 20
        groups = x.view(shp[0], 32, -1)
        record("gn_scale_shift", err, 1e-5, cuda_ms(stats, iters),
               cuda_ms(lambda: gn_mod.gn_scale_shift_plain(x, w, b, 32, eps), iters),
               f"{list(shp)} bf16 eps {eps:g} (error relative to max |scale|, |shift|)",
               *bound(nbytes(x, w, b, *got), 3.0 * x.numel(), "f32"),
               cuda_ms(lambda: torch.var_mean(groups, dim=2), iters), graph_ms(stats, iters))
        us = {"gn_scale_shift": host_us(stats),
              "torch.var_mean": host_us(lambda: torch.var_mean(groups, dim=2))}
        results["gn_scale_shift"].setdefault("host_us", {})[str(list(shp))] = us
        log(f"[phase2]   the host's share of a call: {us['gn_scale_shift']:.1f} us to return, "
            f"torch.var_mean {us['torch.var_mean']:.1f} us")
        del x, got, want

    # fused GroupNorm+SiLU+conv3x3: UNet res-block chains, the skip concat,
    # the 8^2 level, the 4-channel output conv, the VAE's 512^2 level, and a
    # small float32 case. bf16: the plain version rounds the conv's result
    # and again after the bias, the kernel once: 3 ulps at max |y|; float32
    # 1e-4 of max |y| (sums in another order; TF32 is off).
    for (n, c, h, w_, co), dtype in (((5, 320, 64, 64, 320), bf16), ((5, 960, 64, 64, 320), bf16),
                                     ((5, 2560, 8, 8, 1280), bf16), ((5, 320, 64, 64, 4), bf16),
                                     ((5, 128, 512, 512, 128), bf16), ((2, 64, 16, 8, 96), f32)):
        x = (torch.randn(n, c, h, w_, device=dev, generator=gen) * 1.5 + 0.3).to(dtype)
        gw = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
        gb = 0.1 * torch.randn(c, device=dev, generator=gen)
        wt = (torch.randn(co, c, 3, 3, device=dev, generator=gen) * (9 * c) ** -0.5).to(dtype)
        bias = 0.1 * torch.randn(co, device=dev, generator=gen)
        got = conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
        want = conv_mod.gn_silu_conv3x3_plain(x, gw, gb, wt, bias, 32, 1e-5)
        rel = 3 * 2 ** -8 if dtype == bf16 else 1e-4
        gwd, gbd, biasd = gw.to(dtype), gb.to(dtype), bias.to(dtype)
        iters = 5 if h >= 512 else 20
        record("gn_silu_conv3x3", max_err(got, want), rel * float(want.float().abs().max()),
               cuda_ms(lambda: conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5), iters),
               cuda_ms(lambda: conv_mod.gn_silu_conv3x3_plain(x, gw, gb, wt, bias, 32, 1e-5),
                       iters),
               f"[{n},{c},{h},{w_}]->{co} {'bf16' if dtype == bf16 else 'f32'}",
               *bound(nbytes(x, wt, got, gw, gb, bias), 18.0 * c * co * n * h * w_,
                      "bf16" if dtype == bf16 else "f32"),
               cuda_ms(lambda: F.conv2d(F.silu(F.group_norm(x, 32, gwd, gbd, 1e-5)), wt, biasd,
                                        padding=1), iters))
        # the wrapper's two parts timed alone: the statistics launch and the
        # conv kernel itself; the one-call chain against the two launches
        def stats():
            return gn_mod.gn_scale_shift(x, gw, gb, 32, 1e-5)

        def chain():
            return conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)

        def cudnn_chain():
            return F.conv2d(F.silu(F.group_norm(x, 32, gwd, gbd, 1e-5)), wt, biasd, padding=1)

        scale, shift = stats()
        variant = conv_mod.kernel_variant(dtype, co)
        two = torch.empty_like(got)
        conv_only = conv_alone(x, scale, shift, wt, conv_mod.bias_fp32(bias), two, variant)
        conv_only()
        if not torch.equal(got, two):
            raise AssertionError(f"gn_silu_conv3x3 [{n},{c},{h},{w_}]->{co}: the one-call chain "
                                 f"differs from gn_scale_shift and the conv kernel")
        conv_ms = cuda_ms(conv_only, iters)
        us = {"chain": host_us(chain, 50), "cudnn_chain": host_us(cudnn_chain, 50)}
        chain_graph = graph_ms(chain, iters)
        results["gn_silu_conv3x3"].setdefault("chain", {})[f"[{n},{c},{h},{w_}]->{co}"] = {
            "graph_ms": chain_graph, "host_us": us}
        log(f"[phase2]   {variant} kernel, one C call equal to the two launches bit for bit; "
            f"of which statistics {cuda_ms(stats, iters):.4f} ms, conv kernel alone "
            f"{conv_ms:.4f} ms = {18e-9 * c * co * n * h * w_ / conv_ms:.0f} TFLOP/s; the chain "
            f"on the device (graph) {chain_graph:.4f} ms; the host's share of a call "
            f"{us['chain']:.1f} us to return, the cuDNN chain {us['cudnn_chain']:.1f} us")
        del x, wt, got, want
    results["gn_silu_conv3x3"]["variant"] = (
        "wgmma (conv_wgmma_kernel) for bf16 with more than 8 output channels; mma.sync "
        "(conv_mma_kernel) for f16 and bf16 up to 8 channels; fma (conv_fma_kernel) for f32")
    results["gn_silu_conv3x3"]["tensor_parallel_widths"] = conv_checks(dev, gen)
    return results


def conv_alone(x, scale, shift, wt, bias, out, variant):
    """A function that launches only the conv kernel ``variant`` of the fused
    chain on ready-made statistics."""
    from mgldvsr_tpu_torch.ops.kernels import _build
    from mgldvsr_tpu_torch.ops.kernels import gn_silu_conv as conv_mod

    n, c, h, w = x.shape
    co = wt.shape[0]
    lib, stream = _build.library(), _build.stream_ptr(x.device)
    head = (x.data_ptr(), scale.data_ptr(), shift.data_ptr())
    if variant == "wgmma":
        relaid = conv_mod.relaid_weight(wt)
        args = (*head, relaid.data_ptr(), bias.data_ptr(), out.data_ptr(), n, c, relaid.shape[2],
                h, w, co, stream)
        entry = lib.mgld_gn_silu_conv_wgmma_bf16
    else:
        args = (*head, wt.data_ptr(), bias.data_ptr(), out.data_ptr(), n, c, h, w, co, stream)
        entry = getattr(lib, conv_mod._ENTRY[x.dtype])
    return lambda: _build.check(entry(*args), "conv")


# the chains tensor-parallel training gives a rank (its rows of the conv, the
# whole input): [N, C, H, W] -> Co / T at T = 2 and 4
TENSOR_PARALLEL_CHAINS = ((5, 320, 64, 64, 160), (5, 320, 64, 64, 80), (5, 2560, 8, 8, 640),
                          (5, 2560, 8, 8, 320), (5, 256, 64, 64, 128), (5, 512, 64, 64, 256))


def conv_checks(dev, gen) -> dict:
    """The fused GroupNorm+SiLU+conv off the timed shapes: C and Co off the
    tensor-core kernel's tiles, narrow frames, a clipped variance, the re-laid
    weight, the chain's launches, the ``mma.sync`` kernel against the
    tensor-core one, and the output widths of tensor-parallel training.
    Returns the last's errors and times."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.kernels import gn_silu_conv as conv_mod
    from mgldvsr_tpu_torch.ops.kernels import groupnorm as gn_mod

    bf16 = torch.bfloat16

    def case(n, c, h, w, co, mean=0.3):
        x = (torch.randn(n, c, h, w, device=dev, generator=gen) * 1.5 + mean).to(bf16)
        gw = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
        gb = 0.1 * torch.randn(c, device=dev, generator=gen)
        wt = (torch.randn(co, c, 3, 3, device=dev, generator=gen) * (9 * c) ** -0.5).to(bf16)
        return x, gw, gb, wt, (0.1 * torch.randn(co, device=dev, generator=gen)).to(bf16)

    def check(what, got, want, tol):
        err = max_err(got, want)
        log(f"[phase2] gn_silu_conv3x3 {what}: max_abs_err {err:.3e} (limit {tol:.3e})")
        if not err <= tol or not torch.isfinite(got).all():
            raise AssertionError(f"gn_silu_conv3x3 {what}: {err:.3e} > {tol:.3e}")

    # bf16 bias, as the towers' convs hold it; 3 ulps at max |y| as above
    for n, c, h, w, co, what in ((2, 96, 24, 40, 72, "C and Co off the 64 and 128 tiles"),
                                 (2, 64, 16, 1, 32, "a frame one pixel wide"),
                                 (5, 128, 8, 8, 200, "8x8 frames, an odd number of them"),
                                 (3, 64, 21, 7, 24, "narrow and ragged"),
                                 (1, 576, 16, 16, 64, "9 stages split among a cluster of 8"),
                                 (2, 1280, 8, 8, 96, "8x8 tiles, 20 stages among 8 blocks")):
        args = case(n, c, h, w, co)
        kernels.reset_launch_counts()
        got = conv_mod.gn_silu_conv3x3(*args, 32, 1e-5)
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        if counts != {"gn_scale_shift": 1, "gn_silu_conv3x3": 1, "gn_silu_conv3x3_wgmma": 1}:
            raise AssertionError(f"gn_silu_conv3x3: a bf16 chain launched {counts}")
        want = conv_mod.gn_silu_conv3x3_plain(*args, 32, 1e-5)
        check(f"[{n},{c},{h},{w}]->{co} bf16 ({what})", got, want, bf16_ulps(3, want))

    # x with mean >> std: E[x^2] - E[x]^2 cancels in fp32 and clips at 0 for
    # some groups, in one summation order and not in another. The chain must
    # stay finite, and the conv kernel on the plain version's statistics must
    # equal the plain version.
    x, gw, gb, wt, bias = case(2, 64, 16, 16, 64, mean=300.0)
    got = conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    scale, shift = gn_mod.gn_scale_shift(x, gw, gb, 32, 1e-5)
    if not (torch.isfinite(got).all() and float(scale.abs().max()) <= 1.2 * 1e-5 ** -0.5):
        raise AssertionError("gn_silu_conv3x3: the clipped variance gave a non-finite chain")
    scale, shift = (t.contiguous() for t in gn_mod.gn_scale_shift_plain(x, gw, gb, 32, 1e-5))
    conv_alone(x, scale, shift, wt, conv_mod.bias_fp32(bias), got, "wgmma")()
    want = conv_mod.gn_silu_conv3x3_plain(x, gw, gb, wt, bias, 32, 1e-5)
    check("[2,64,16,16]->64 bf16, x = 300 + noise, on the plain version's statistics", got, want,
          bf16_ulps(3, want))

    # the re-laid weight: a permute bit for bit, zeros beyond C, made once
    x, gw, gb, wt, bias = case(2, 96, 16, 16, 40)
    made = conv_mod._derived.made
    relaid = conv_mod.relaid_weight(wt)
    if not (relaid.shape == (9, 40, 128) and not relaid[:, :, 96:].any()
            and torch.equal(relaid[:, :, :96], wt.permute(2, 3, 0, 1).reshape(9, 40, 96))):
        raise AssertionError("gn_silu_conv3x3: the re-laid weight is not the permuted weight")
    conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    if conv_mod.relaid_weight(wt) is not relaid or conv_mod._derived.made != made + 2:
        raise AssertionError("gn_silu_conv3x3: the weight or the bias was laid out again")
    wt.mul_(2)
    if not torch.equal(conv_mod.relaid_weight(wt), relaid * 2):
        raise AssertionError("gn_silu_conv3x3: an in-place update left a stale re-laid weight")
    log("[phase2] gn_silu_conv3x3 re-laid weight [40,96,3,3] -> [9,40,128]: equals the permute "
        "bit for bit, made once for two calls, made again after an in-place update")

    # the mma.sync kernel (kept for f16 and for up to 8 output channels) on a
    # shape that bf16 sends to the tensor-core kernel: bf16 products summed in
    # fp32 in another order, SiLU rounded by two formulas (exp and divide
    # there, tanh here): 2 ulps at max |y|, one whole step of the largest
    x, gw, gb, wt, bias = case(2, 320, 32, 32, 320)
    new = conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
    old = torch.empty_like(new)
    scale, shift = gn_mod.gn_scale_shift(x, gw, gb, 32, 1e-5)
    conv_alone(x, scale, shift, wt, conv_mod.bias_fp32(bias), old, "mma")()
    check("[2,320,32,32]->320 bf16, mma.sync kernel vs wgmma kernel", old, new, bf16_ulps(2, new))

    # a rank's rows of the towers' convs under --tensor-parallel 2 and 4 (Co
    # 160 and 80 are partial 128-wide tiles of the wgmma grid): 3 ulps at max
    # |y| in bf16, 1e-4 of max |y| in f32, as the full widths' limits
    sliced = {}
    for n, c, h, w, co in TENSOR_PARALLEL_CHAINS:
        for dtype in (bf16, torch.float32):
            x, gw, gb, wt, bias = case(n, c, h, w, co)
            x, wt, bias = x.to(dtype), wt.to(dtype), bias.to(dtype)
            got = conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)
            want = conv_mod.gn_silu_conv3x3_plain(x, gw, gb, wt, bias, 32, 1e-5)
            name = f"[{n},{c},{h},{w}]->{co} {'bf16' if dtype == bf16 else 'f32'}"
            check(f"{name} (a rank's rows under tensor parallelism)", got, want,
                  bf16_ulps(3, want) if dtype == bf16 else 1e-4 * float(want.abs().max()))
            sliced[name] = {
                "variant": conv_mod.kernel_variant(dtype, co), "max_abs_err": max_err(got, want),
                "ms": cuda_ms(lambda: conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, 32, 1e-5)),
                "plain_ms": cuda_ms(
                    lambda: conv_mod.gn_silu_conv3x3_plain(x, gw, gb, wt, bias, 32, 1e-5))}
            log(f"[phase2]   {sliced[name]['variant']} {sliced[name]['ms']:.4f} ms, plain "
                f"{sliced[name]['plain_ms']:.4f} ms")
            del x, wt, got, want
    return sliced


def tiny_config(frames: int = 5):
    from mgldvsr_tpu_torch.flow.raft import RAFTConfig
    from mgldvsr_tpu_torch.infer.pipeline import PipelineConfig
    from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig
    from mgldvsr_tpu_torch.models.unet import StructCondConfig, UNetConfig
    from mgldvsr_tpu_torch.models.vae import VAEConfig

    return PipelineConfig(
        num_frames=frames, ddpm_steps=2,
        unet=UNetConfig(model_channels=32, num_head_channels=16, context_dim=32,
                        semb_channels=32, channel_mult=(1, 2), attention_resolutions=(1, 2),
                        num_frames=frames),
        structcond=StructCondConfig(model_channels=32, out_channels=32, channel_mult=(1, 1),
                                    attention_resolutions=(1, 2), num_frames=frames),
        vae=VAEConfig(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, num_frames=frames,
                      enable_fusion=True, num_fuse_block=1),
        clip=CLIPTextConfig(width=32, heads=2, layers=2),
        raft=RAFTConfig(iters=2))


def phase3(seed: int, card: str, fused: bool) -> float:
    """The tiny restore on the card against the CPU, in the default or the
    fused configuration."""
    import torch

    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
    from mgldvsr_tpu_torch.ops import kernels

    cpu, gpu = tiny_pipelines(seed)
    cfg = cpu.cfg
    frames = upscale_frames(torch.from_numpy(lq_clip(seed + 1, 64)), 4)
    with fused_switch(fused):
        want = cpu.restore_segment(frames, deterministic=True)
        kernels.reset_launch_counts()
        got = gpu.restore_segment(frames.cuda(), deterministic=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    err = max_err(got.cpu(), want)
    log(f"[phase3] tiny 256x256 fp32 2 steps, fused conv {'on' if fused else 'off'}: card vs "
        f"CPU max_abs_err {err:.3e} (limit 1e-3), launches {counts}  [{card}]")
    if got.shape != (5, 256, 256, 3) or not torch.isfinite(got).all():
        raise AssertionError(f"phase 3 output {tuple(got.shape)} is not finite [5,256,256,3]")
    if not err <= 1e-3:
        raise AssertionError(f"phase 3: card and CPU disagree ({err:.3e})")
    must = ["guidance_residual", "guidance_scatter", "attention", "corr_lookup",
            "fused_group_norm"]
    for name in must + list(FUSED_ONLY) * fused:
        if counts[name] == 0:
            raise AssertionError(f"phase 3: kernel {name} was never launched")
    guided = (counts["guidance_residual"], counts["guidance_scatter"])
    if guided != (cfg.ddpm_steps,) * 2 or any(counts[name] for name in STANDALONE):
        raise AssertionError(f"phase 3: guidance pair launches {guided} in {cfg.ddpm_steps} "
                             f"steps, standalone warp {[counts[n] for n in STANDALONE]}")
    if not fused and any(counts[name] for name in FUSED_ONLY):
        raise AssertionError(f"phase 3: {FUSED_ONLY} launched with the switch off")
    if counts["corr_lookup"] != cfg.raft.iters:
        raise AssertionError(f"phase 3: {counts['corr_lookup']} lookup launches for "
                             f"{cfg.raft.iters} RAFT iterations of one batched call")
    return err


def tiny_pipelines(seed: int):
    """The tiny config on the CPU and on the card with the same seeded
    weights, RAFT calmed."""
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights

    cfg = tiny_config()
    cpu = MGLDVSRPipeline(cfg, "cpu")
    init_pipeline_weights(cpu, seed)
    calm_raft(cpu)
    gpu = MGLDVSRPipeline(cfg)
    for name, tower in gpu.towers().items():
        tower.load_state_dict(cpu.towers()[name].state_dict(), strict=True)
    return cpu, gpu


def phase3_tile(seed: int, card: str, fused: bool) -> float:
    """The tiny tile and latent protocols on the card against the CPU."""
    import torch

    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
    from mgldvsr_tpu_torch.ops import kernels

    cpu, gpu = tiny_pipelines(seed)
    steps = cpu.cfg.ddpm_steps
    worst = 0.0
    awkward = torch.from_numpy(lq_clip(seed + 3, 16)[:, :13, :11].copy())
    kw = dict(pch_size=64, pch_stride=48, min_side=64, tile=4, tile_overlap=2, deterministic=True)
    with fused_switch(fused):
        for patch_batch in (1, 2):
            want = cpu.restore_video(awkward, patch_batch=patch_batch, **kw)
            kernels.reset_launch_counts()
            got = gpu.restore_video(awkward.cuda(), patch_batch=patch_batch, **kw)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            err = max_err(got.cpu(), want)
            groups = 2 // patch_batch
            log(f"[phase3] tile protocol 13x11 -> 66x44, two 64px patches of nine 4-latent "
                f"tiles, {patch_batch} a group, fused conv {'on' if fused else 'off'}: card vs "
                f"CPU max_abs_err {err:.3e} (limit 1e-3), guidance launches "
                f"{counts['guidance_residual']} / {counts['guidance_scatter']} for {groups} "
                f"groups of {steps} steps  [{card}]")
            if got.shape != (5, 66, 44, 3) or not torch.isfinite(got).all() or not err <= 1e-3:
                raise AssertionError(f"phase 3 tile protocol: {tuple(got.shape)}, {err:.3e}")
            if not counts["guidance_residual"] == counts["guidance_scatter"] == steps * groups:
                raise AssertionError(f"phase 3 tile protocol: guidance launches {counts}")
            worst = max(worst, err)
        frames = upscale_frames(torch.from_numpy(lq_clip(seed + 4, 16)), 4)
        want, want_lat = cpu.restore_with_latents(frames, deterministic=True)
        kernels.reset_launch_counts()
        got, lat = gpu.restore_with_latents(frames.cuda(), deterministic=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    err, err_lat = max_err(got.cpu(), want), max_err(lat.cpu(), want_lat)
    lat_tol = 1e-3 * max(1.0, float(want_lat.abs().max()))
    log(f"[phase3] latent protocol 64x64, fused conv {'on' if fused else 'off'}: card vs CPU "
        f"frames max_abs_err {err:.3e} (limit 1e-3), latents {err_lat:.3e} (limit 1e-3 of max "
        f"|latent| {float(want_lat.abs().max()):.2f}), guidance launches "
        f"{counts['guidance_residual']}  [{card}]")
    if got.shape != (5, 64, 64, 3) or lat.shape != (5, 8, 8, 4):
        raise AssertionError(f"phase 3 latent protocol: shapes {tuple(got.shape)}, "
                             f"{tuple(lat.shape)}")
    if not (err <= 1e-3 and err_lat <= lat_tol and counts["guidance_residual"] == steps):
        raise AssertionError(f"phase 3 latent protocol: {err:.3e}, {err_lat:.3e}, {counts}")
    return max(worst, err)


def full_config(steps: int):
    import torch

    from mgldvsr_tpu_torch.flow.raft import RAFTConfig
    from mgldvsr_tpu_torch.infer.pipeline import PipelineConfig
    from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig
    from mgldvsr_tpu_torch.models.unet import StructCondConfig, UNetConfig
    from mgldvsr_tpu_torch.models.vae import VAEConfig

    bf16 = torch.bfloat16
    return PipelineConfig(
        num_frames=5, ddpm_steps=steps,
        unet=UNetConfig(num_frames=5, dtype=bf16),
        structcond=StructCondConfig(num_frames=5, dtype=bf16),
        vae=VAEConfig(num_frames=5, enable_fusion=True, dtype=bf16),
        clip=CLIPTextConfig(dtype=bf16),
        raft=RAFTConfig(iters=10))


def full_pipeline(seed: int, steps: int):
    """The full-width pipeline with seeded weights and the 512px test clip."""
    import torch

    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, upscale_frames
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights

    t0 = time.perf_counter()
    pipe = MGLDVSRPipeline(full_config(steps))
    init_pipeline_weights(pipe, seed)
    calm_raft(pipe)
    pipe.cast_to_compute_dtypes()
    frames = upscale_frames(torch.from_numpy(lq_clip(seed + 2, 128)).cuda(), 4)
    torch.cuda.synchronize()
    log(f"[phase4] weights on the card in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for t in pipe.towers().values() for p in t.parameters()) / 1e6:.1f}"
        f"M parameters)")
    return pipe, frames


def full_restore(pipe, frames, seed: int, steps: int, card: str, fused: bool):
    """One restore at full width; returns (frames out, launch counts)."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels

    phase = "phase5" if fused else "phase4"
    gen = torch.Generator(device="cuda").manual_seed(seed)
    stages: dict = {}
    torch.cuda.reset_peak_memory_stats()
    with fused_switch(fused):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = pipe.restore_segment(frames, gen, stage_seconds=stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    stage_txt = ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
    log(f"[{phase}] fused conv {'on' if fused else 'off'}, 512x512, 5 frames, {steps} steps: "
        f"{stage_txt}; total {wall:.3f} s, {5 / wall:.4f} frames/s, sampler "
        f"{1000 * stages['sampler'] / steps:.2f} ms/step, peak {peak / 2**30:.2f} GiB  [{card}]")
    log(f"[{phase}] launches {counts}  [{card}]")
    if fused:
        from mgldvsr_tpu_torch.ops.kernels.gn_silu_conv import derived_bytes

        held, held_bytes = derived_bytes()
        log(f"[{phase}] re-laid weights and float32 biases kept for the tensor-core conv kernel: "
            f"{held} tensors, {held_bytes / 2**30:.3f} GiB")
    if out.shape != (5, 512, 512, 3):
        raise AssertionError(f"{phase} output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError(f"{phase} output is not finite in [0, 1]")
    for name in KERNELS:
        idle = (DEFAULT_ONLY if fused else FUSED_ONLY) + STANDALONE + INT8_ONLY
        if (counts[name] == 0) != (name in idle):
            raise AssertionError(f"{phase}: kernel {name} was launched {counts[name]} times")
    # the guidance gradient: launch A and launch B once a step, nothing else
    if not counts["guidance_residual"] == counts["guidance_scatter"] == steps:
        raise AssertionError(f"{phase}: guidance launches {counts['guidance_residual']}, "
                             f"{counts['guidance_scatter']}, expected {steps} each")
    # 14 gated attention calls per step, all bf16 at head dim 64
    if not counts["attention_wgmma"] == counts["attention"] == 14 * steps:
        raise AssertionError(f"{phase}: {counts['attention']} attention launches, "
                             f"{counts['attention_wgmma']} on the tensor-core kernel, "
                             f"expected {14 * steps}")
    # RAFT runs once on the 8 frame pairs; each of its iterations is one lookup launch
    if counts["corr_lookup"] != pipe.cfg.raft.iters:
        raise AssertionError(f"{phase}: {counts['corr_lookup']} lookup launches, expected "
                             f"{pipe.cfg.raft.iters}")
    if fused:
        # 73 chains a step (45 in the UNet, 28 in the struct-cond encoder) and
        # 58 in the VAE, each two launches; all on the tensor-core kernel but
        # the UNet's 4-channel output conv and the VAE's 8- and 3-channel ones
        chains = 73 * steps + 58
        got = (counts["gn_silu_conv3x3"], counts["gn_scale_shift"],
               counts["gn_silu_conv3x3_wgmma"])
        if got != (chains, chains, chains - steps - 2):
            raise AssertionError(f"{phase}: (conv, statistics, tensor-core conv) launches {got}, "
                                 f"expected {(chains, chains, chains - steps - 2)}")
    return out, counts


def guidance_check(pipe, frames, seed: int) -> None:
    """The guidance gradient on this clip's flows and masks must be non-zero
    and equal its plain version (autograd of the loss through the plain
    warp) within 1e-6 of its largest value, in both modes."""
    import torch

    from mgldvsr_tpu_torch.ops.kernels.guidance import guidance_grad, guidance_grad_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    flows, masks = pipe.compute_flows(frames)
    lat = torch.randn(5, 64, 64, 4, device="cuda", generator=gen)
    occluded = float(masks[0].mean())
    if not occluded < 1.0:
        raise AssertionError("phase 4: every pixel is occluded; guidance does nothing")
    for mode in ("reference", "aligned"):
        grad = guidance_grad(lat, flows, masks, 5, mode)
        want = guidance_grad_plain(lat, flows, masks, 5, mode)
        err, tol = max_err(grad, want), 1e-6 * float(want.abs().max())
        log(f"[phase4] {mode}: flow |mean| {float(flows[0].abs().mean()):.4f} px at 1/8 res, "
            f"occluded share {occluded:.3f}, guidance grad norm {float(grad.norm()):.4e}, vs "
            f"the plain version max_abs_err {err:.3e} (limit {tol:.3e})")
        if not float(grad.norm()) > 0:
            raise AssertionError("phase 4: the guidance gradient is zero")
        if not err <= tol:
            raise AssertionError(f"phase 4: the guidance gradient differs from its plain "
                                 f"version ({err:.3e} > {tol:.3e})")


def full_latent_restore(pipe, frames, seed: int, steps: int, card: str) -> dict:
    """The latent protocol (``restore_with_latents``) at full width on phase
    4's pipeline and clip: frames [5,512,512,3] in [0, 1], latents
    [5,64,64,4], finite; every kernel of the default configuration launched,
    the guidance pair once a step."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(seed)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out, lat = pipe.restore_with_latents(frames, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    log(f"[phase4] latent protocol, 512x512, 5 frames, {steps} steps: total {wall:.3f} s, "
        f"frames {tuple(out.shape)}, latents {tuple(lat.shape)} |max| "
        f"{float(lat.abs().max()):.3f}; launches { {k: n for k, n in counts.items() if n} }  "
        f"[{card}]")
    if out.shape != (5, 512, 512, 3) or lat.shape != (5, 64, 64, 4):
        raise AssertionError(f"phase 4 latent: shapes {tuple(out.shape)}, {tuple(lat.shape)}")
    if not (torch.isfinite(out).all() and torch.isfinite(lat).all()
            and out.min() >= 0 and out.max() <= 1):
        raise AssertionError("phase 4 latent: frames not finite in [0, 1] or latents not finite")
    for name in KERNELS:
        if (counts[name] == 0) != (name in FUSED_ONLY + STANDALONE + INT8_ONLY):
            raise AssertionError(f"phase 4 latent: kernel {name} was launched {counts[name]} "
                                 f"times")
    if not counts["guidance_residual"] == counts["guidance_scatter"] == steps:
        raise AssertionError(f"phase 4 latent: guidance launches {counts['guidance_residual']}, "
                             f"{counts['guidance_scatter']}, expected {steps} each")
    return counts


GEOMETRIES = {  # phase 6: (pch_size, pch_stride, patch pixels, patches at 720x1280)
    "auto": (0, 0, (512, 512), 6),
    "reference": (960, 750, (736, 960), 2),
}


@contextlib.contextmanager
def sampler_steps(pipe, steps: int):
    """Run the enclosed restores with ``steps`` respaced steps."""
    from mgldvsr_tpu_torch.core.schedules import respace_schedule

    before = pipe.sched
    pipe.sched = respace_schedule(pipe.base_sched, steps)
    try:
        yield
    finally:
        pipe.sched = before


def tile_restore(pipe, lq, seed: int, geometry: str, patch_batch):
    """One ``restore_video``: (frames, launch counts, stage seconds, wall
    seconds, peak device bytes above what was allocated before it)."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels

    size, stride = GEOMETRIES[geometry][:2]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    stages: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe.restore_video(lq, gen, pch_size=size, pch_stride=stride,
                             patch_batch=patch_batch, stage_seconds=stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, kernels.launch_counts(), stages, wall,
            torch.cuda.max_memory_allocated() - base)


# phase 6 (a)'s steps: the tile protocol's checks do not depend on the count
# (50 until the heritage phase was added, cut for the script's time)
PHASE6_STEPS = 10


def phase6(pipe, seed: int, card: str) -> dict:
    """The tile protocol at full width on a 180x320 clip restored to
    720x1280: the bytes a patch adds to a group, then both geometries."""
    import math

    import torch

    from mgldvsr_tpu_torch.infer import pipeline as pipeline_mod

    lq = torch.from_numpy(lq_clip(seed + 5, 180, width=320)).cuda()
    per_px = {}
    with part("phase6 bytes a patch"), sampler_steps(pipe, 2):
        for geometry, (_, _, (ph, pw), _) in GEOMETRIES.items():
            peaks = [tile_restore(pipe, lq, seed, geometry, k)[4] for k in (1, 2)]
            per_px[geometry] = (peaks[1] - peaks[0]) / (ph * pw)
            log(f"[phase6] {geometry} geometry, {ph}x{pw} patches, 2 steps: peak above the "
                f"weights {peaks[0] / 2**30:.3f} GiB at one patch a group, "
                f"{peaks[1] / 2**30:.3f} GiB at two: a patch adds {peaks[1] - peaks[0]} B = "
                f"{per_px[geometry]:.0f} B a pixel  [{card}]")
    log(f"[phase6] PATCH_BYTES_PER_PIXEL in the pipeline {pipeline_mod.PATCH_BYTES_PER_PIXEL}, "
        f"the larger measured here {max(per_px.values()):.0f}  [{card}]")
    if not max(per_px.values()) <= pipeline_mod.PATCH_BYTES_PER_PIXEL:
        raise AssertionError(f"phase 6: a patch takes {max(per_px.values()):.0f} B a pixel, more "
                             f"than PATCH_BYTES_PER_PIXEL = {pipeline_mod.PATCH_BYTES_PER_PIXEL}")

    results = {}
    must = ("guidance_residual", "guidance_scatter", "attention", "corr_lookup", "channel_sums",
            "fused_group_norm")
    for geometry, n_steps in (("auto", PHASE6_STEPS), ("reference", 5)):
        _, _, (ph, pw), n_patches = GEOMETRIES[geometry]
        allowed = pipe.patch_batch_envelope(ph, pw)
        k = min(allowed, n_patches)
        groups = math.ceil(n_patches / k)
        with part(f"phase6 {geometry}"), sampler_steps(pipe, n_steps):
            out, counts, stages, wall, peak = tile_restore(pipe, lq, seed, geometry, None)
        stage_txt = ", ".join(f"{name} {sec:.3f} s" for name, sec in stages.items())
        log(f"[phase6] ({'a' if geometry == 'auto' else 'b'}) {geometry} geometry: 180x320 -> "
            f"720x1280, {n_patches} patches of {ph}x{pw}, {k} a group ({groups} groups; the "
            f"envelope allows {allowed}), "
            f"{n_steps} steps: {stage_txt}; total {wall:.3f} s, {5 / wall:.4f} frames/s, peak "
            f"above the weights {peak / 2**30:.2f} GiB  [{card}]")
        log(f"[phase6] ({'a' if geometry == 'auto' else 'b'}) launches "
            f"{ {name: n for name, n in counts.items() if n} }  [{card}]")
        if out.shape != (5, 720, 1280, 3):
            raise AssertionError(f"phase 6 {geometry}: output shape {tuple(out.shape)}")
        if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
            raise AssertionError(f"phase 6 {geometry}: output is not finite in [0, 1]")
        for name in must:
            if counts[name] == 0:
                raise AssertionError(f"phase 6 {geometry}: kernel {name} was never launched")
        for name in FUSED_ONLY + STANDALONE:
            if counts[name]:
                raise AssertionError(f"phase 6 {geometry}: {name} launched {counts[name]} times")
        if not counts["guidance_residual"] == counts["guidance_scatter"] == n_steps * groups:
            raise AssertionError(f"phase 6 {geometry}: guidance launches "
                                 f"{counts['guidance_residual']}, {counts['guidance_scatter']}, "
                                 f"expected {n_steps} steps x {groups} groups")
        results[geometry] = {"counts": counts, "stages": stages, "wall_s": wall,
                             "frames_per_s": 5 / wall, "peak_bytes": peak, "patch_batch": k,
                             "steps": n_steps}
    results["bytes_per_pixel"] = per_px
    with part("phase6 (c)"):
        results["envelope"] = envelope_group(pipe, seed, card)
    return results


def envelope_group(pipe, seed: int, card: str) -> dict:
    """(c) The largest group the envelope allows at 736x960 patches, on a
    clip of 184 LQ rows (736 working rows) just wide enough that the 960/750
    grid holds that many patches, at two steps. The VAE's widest activation
    (256 channels at the patch's size) then holds K·5·256·736·960 elements,
    past 2^32 from K = 5. The frames must match those of one patch a group up
    to bf16's rounding: an index that wrapped would hand the group's later
    patches another patch's data."""
    import torch

    from mgldvsr_tpu_torch.infer.canvas import ImageSpliter

    k = pipe.patch_batch_envelope(736, 960)
    lq_w = 240
    while len(ImageSpliter((5, 736, 4 * lq_w + (-4 * lq_w) % 32, 3), 960, 750).positions) < k:
        lq_w += 8
    lq = torch.from_numpy(lq_clip(seed + 6, 184, width=lq_w)).cuda()
    elements = k * 5 * 256 * 736 * 960
    with sampler_steps(pipe, 2):
        out, counts, stages, wall, peak = tile_restore(pipe, lq, seed, "reference", k)
        one, _, _, wall_one, _ = tile_restore(pipe, lq, seed, "reference", 1)
    diff = (out - one).abs()
    err_max, err_mean = float(diff.max()), float(diff.mean())
    log(f"[phase6] (c) the envelope's group: 184x{lq_w} -> 736x{4 * lq_w}, {k} patches of "
        f"736x960 in one group ({elements} elements in the VAE's widest activation, "
        f"{elements / 2**32:.2f} x 2^32), 2 steps: total {wall:.3f} s (one patch a group "
        f"{wall_one:.3f} s), peak above the weights {peak / 2**30:.2f} GiB; vs one patch a "
        f"group max_abs_err {err_max:.3e} (limit 0.25), mean {err_mean:.3e} (limit 5e-3)  "
        f"[{card}]")
    if out.shape != (5, 736, 4 * lq_w, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"phase 6 (c): output {tuple(out.shape)} is not finite")
    if out.min() < 0 or out.max() > 1 or not (err_max <= 0.25 and err_mean <= 5e-3):
        raise AssertionError(f"phase 6 (c): {k} patches a group disagree with one a group "
                             f"(max {err_max:.3e}, mean {err_mean:.3e})")
    for name in ("attention", "corr_lookup", "channel_sums", "fused_group_norm"):
        if counts[name] == 0:
            raise AssertionError(f"phase 6 (c): kernel {name} was never launched")
    if not counts["guidance_residual"] == counts["guidance_scatter"] == 2:
        raise AssertionError(f"phase 6 (c): guidance launches {counts['guidance_residual']}, "
                             f"{counts['guidance_scatter']}, expected 2 steps x 1 group")
    return {"patch_batch": k, "elements": elements, "wall_s": wall, "peak_bytes": peak,
            "max_abs_err": err_max, "mean_abs_err": err_mean}


def phase7(card: str) -> None:
    """The inference CLI on the card in its three modes at tiny widths, then
    once at full width."""
    import tempfile

    import torch

    from mgldvsr_tpu_torch.cli import infer as cli
    from mgldvsr_tpu_torch.io.frames import codec, read_frame, write_frame
    from mgldvsr_tpu_torch.ops import kernels

    clip = (lq_clip(11, 32, frames=7, width=48) * 255).round().astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        lq = os.path.join(tmp, "lq")
        os.makedirs(os.path.join(lq, "clip0"))
        for i, frame in enumerate(clip):
            write_frame(os.path.join(lq, "clip0", f"{i:08d}.png"), frame)
        for mode, extra in (("fixed", ["--window-batch", "2"]), ("tile", []), ("latent", [])):
            out = os.path.join(tmp, mode)
            t0 = time.perf_counter()
            cli.main(["--seqs-path", lq, "--out-path", out, "--preset", "tiny", "--mode", mode,
                      "--ddpm-steps", "2", "--seed", "1", *extra])
            wall = time.perf_counter() - t0
            names = sorted(os.listdir(os.path.join(out, "clip0")))
            pngs = [n for n in names if n.endswith(".png")]
            npys = [n for n in names if n.endswith(".npy")]
            shapes = {read_frame(os.path.join(out, "clip0", n)).shape for n in pngs}
            lat_shapes = {np.load(os.path.join(out, "clip0", n)).shape for n in npys}
            log(f"[phase7] {mode} {' '.join(extra)}: {len(pngs)} frames written, read back as "
                f"{sorted(shapes)} through {codec()}; {len(npys)} latents {sorted(lat_shapes)}; "
                f"{wall:.2f} s  [{card}]")
            if pngs != [f"{i:08d}.png" for i in range(7)] or shapes != {(128, 192, 3)}:
                raise AssertionError(f"phase 7 {mode}: frames {pngs}, shapes {shapes}")
            want_npys = [f"{i:08d}.npy" for i in range(7)] if mode == "latent" else []
            if npys != want_npys or lat_shapes - {(16, 24, 4)}:
                raise AssertionError(f"phase 7 {mode}: latents {npys}, shapes {lat_shapes}")

        # --preset full: the shipped widths, bf16, seeded weights; fixed mode
        # on five 128x128 frames restored to 512x512, three steps
        full_clip = (lq_clip(12, 128) * 255).round().astype(np.uint8)
        os.makedirs(os.path.join(tmp, "lq_full", "clip0"))
        for i, frame in enumerate(full_clip):
            write_frame(os.path.join(tmp, "lq_full", "clip0", f"{i:08d}.png"), frame)
        out = os.path.join(tmp, "full")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cli.main(["--seqs-path", os.path.join(tmp, "lq_full"), "--out-path", out, "--preset",
                  "full", "--mode", "fixed", "--ddpm-steps", "3", "--seed", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        pngs = sorted(os.listdir(os.path.join(out, "clip0")))
        shapes = {read_frame(os.path.join(out, "clip0", n)).shape for n in pngs}
        log(f"[phase7] --preset full fixed, 128x128 -> 512x512, 3 steps: {len(pngs)} frames "
            f"written, read back as {sorted(shapes)}; {wall:.2f} s with the weights' set-up; "
            f"launches { {k: n for k, n in counts.items() if n} }  [{card}]")
        if pngs != [f"{i:08d}.png" for i in range(5)] or shapes != {(512, 512, 3)}:
            raise AssertionError(f"phase 7 full: frames {pngs}, shapes {shapes}")
        for name in KERNELS:
            if (counts[name] == 0) != (name in FUSED_ONLY + STANDALONE + INT8_ONLY):
                raise AssertionError(f"phase 7 full: kernel {name} was launched {counts[name]} "
                                     f"times")
        if not (counts["guidance_residual"] == counts["guidance_scatter"] == 3
                and counts["attention_wgmma"] == counts["attention"] == 14 * 3):
            raise AssertionError(f"phase 7 full: launches {counts}")

# -- phase 8: stage-1 training ------------------------------------------------

# launched in every training micro-step: attention (UNet and struct-cond),
# the VAE encodes' channel sums (default configuration) and the fused
# GroupNorm; the fused configuration adds the chain's two kernels in place
# of the channel sums
TRAIN_EVERY_STEP = ("attention", "channel_sums", "fused_group_norm")
TRAIN_EVERY_STEP_FUSED = ("attention", "fused_group_norm") + FUSED_ONLY
# autograd nodes whose backward replays a kernel's plain version
PLAIN_BACKWARDS = ("_AttentionBackward", "_AttentionBNHDBackward", "_GNSiLUConvBackward",
                   "_ChannelSumsBackward", "_FusedGroupNormBackward")
TRAIN_LR = 5e-5
# phase 8 (a)'s gradient limits, card against CPU, as fractions of the norm
# (a leaf's plus 1e-3 of the largest leaf's, or the whole gradient's): about
# 3x the readings on an H100 (worst leaf 3.7e-3, a SPADE mlp_shared weight;
# the whole 9.2e-4), where the witness moves the same leaves by ~1e-2
TINY_GRAD_LEAF = 1e-2
TINY_GRAD_WHOLE = 3e-3


def jittered(pipe, seed: int):
    """Seeded weights plus 0.02 N(0, 1) on the UNet and struct-cond: seeded
    weights leave the temporal blend scalars and biases at zero, so some
    trainables would get no gradient and the checks below would pass
    vacuously."""
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights, jitter_weights

    init_pipeline_weights(pipe, seed)
    jitter_weights(pipe, 0.02, seed)
    return pipe


def phase8_tiny(seed: int, card: str, fused: bool) -> dict:
    """(a) one tiny fp32 micro-step on the card and on the CPU with the same
    weights and injected draws: the loss, every trainable's gradient and the
    parameters after the update it applies (grad_accum 1)."""
    import torch

    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.train.trainer import Stage1Config, Stage1Trainer

    cfg = tiny_config()
    cpu = jittered(MGLDVSRPipeline(cfg, "cpu"), seed)
    gpu = MGLDVSRPipeline(cfg)
    for name, tower in gpu.towers().items():
        tower.load_state_dict(cpu.towers()[name].state_dict(), strict=True)
    size = 256  # 32x32 latents: the attention gate opens (N >= 1024)
    lq = torch.from_numpy(lq_clip(seed + 20, size))
    gt = torch.from_numpy(lq_clip(seed + 21, size))
    trainers = [Stage1Trainer(p, Stage1Config(grad_accum=1, learning_rate=TRAIN_LR))
                for p in (cpu, gpu)]
    states = [t.init_state() for t in trainers]
    draws = trainers[0].draws(5, size // 8, size // 8, torch.Generator().manual_seed(seed))
    draws_gpu = draws._replace(**{f: getattr(draws, f).cuda()
                                  for f in ("lq_posterior", "gt_posterior", "t", "noise")})
    # The witness: the CPU against itself with both clips moved by 1e-5
    # relative, about how far the card's forward activations stand from the
    # CPU's. Gradients behind SPADE's ReLU change sides there; it shows how
    # far such a move carries each leaf, the scale of the limits below.
    rs = np.random.RandomState(seed + 22)
    moved = [x * (1 + 1e-5 * torch.from_numpy(rs.randn(*x.shape).astype(np.float32)))
             for x in (lq, gt)]
    with fused_switch(fused):
        loss_c, _, g_c = trainers[0].loss_and_grads(lq, gt, draws)
        _, _, g_w = trainers[0].loss_and_grads(*moved, draws)
        kernels.reset_launch_counts()
        loss_g, _, g_g = trainers[1].loss_and_grads(lq.cuda(), gt.cuda(), draws_gpu)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        trainers[0].train_step(states[0], lq, gt, draws=draws)
        trainers[1].train_step(states[1], lq.cuda(), gt.cuda(), draws=draws_gpu)
    norms = {k: float(g.norm()) for k, g in g_c.items()}
    big = max(norms.values())

    def spread(other):
        """Each leaf's |other - cpu| over its norm + 1e-3 of the largest
        leaf norm (a leaf whose exact gradient is zero holds rounding only),
        and the whole gradient's over its norm."""
        d = {k: float((other[k].cpu() - g).norm()) for k, g in g_c.items()}
        whole = (sum(v * v for v in d.values()) / sum(n * n for n in norms.values())) ** 0.5
        return {k: d[k] / (norms[k] + 1e-3 * big) for k in d}, whole

    card_leaf, grad_global = spread(g_g)
    wit_leaf, wit_global = spread(g_w)
    worst = max(card_leaf, key=card_leaf.get)
    worst_wit = max(wit_leaf, key=wit_leaf.get)
    grad_worst = card_leaf[worst]
    p_err = max(max_err(states[1].trainable[k].cpu(), v) for k, v in states[0].trainable.items())
    total = sum(v.numel() for v in states[0].trainable.values())
    p_off = sum(int(((states[1].trainable[k].cpu() - v).abs() > 1e-6).sum())
                for k, v in states[0].trainable.items()) / total
    loss_rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    log(f"[phase8] (a) tiny fp32 micro-step {size}x{size}, fused conv {'on' if fused else 'off'}: "
        f"card vs CPU loss {float(loss_g):.6f} / {float(loss_c):.6f} (rel {loss_rel:.2e}, limit "
        f"1e-4); gradients of {len(g_c)} leaves, card vs CPU: the whole {grad_global:.3e} of its "
        f"norm (limit {TINY_GRAD_WHOLE:.0e}), worst leaf {worst} {grad_worst:.3e} (limit "
        f"{TINY_GRAD_LEAF:.0e}; the witness there {wit_leaf[worst]:.3e}); witness, CPU vs CPU "
        f"with the clips moved by 1e-5: the whole {wit_global:.3e}, worst leaf {worst_wit} "
        f"{wit_leaf[worst_wit]:.3e} (the card there {card_leaf[worst_wit]:.3e}); parameters "
        f"after the update max |d| {p_err:.3e} (limit 2 lr = {2 * TRAIN_LR:.0e}: Adam's first "
        f"step moves each element by lr times the sign of its gradient, and a near-zero "
        f"gradient's sign is rounding), {100 * p_off:.3f}% of {total} elements off by more than "
        f"1e-6 (limit 1%); launches { {k: n for k, n in counts.items() if n} }  [{card}]")
    must = ("attention", "fused_group_norm") + (FUSED_ONLY if fused else ())
    if not (loss_rel <= 1e-4 and grad_worst <= TINY_GRAD_LEAF and grad_global <= TINY_GRAD_WHOLE
            and p_err <= 2 * TRAIN_LR + 1e-6 and p_off <= 0.01):
        raise AssertionError("phase 8 (a): card and CPU disagree")
    for name in must:
        if counts[name] == 0:
            raise AssertionError(f"phase 8 (a): kernel {name} was never launched")
    return {"loss_rel": loss_rel, "grad_global": grad_global, "grad_worst_leaf": grad_worst,
            "witness_global": wit_global, "witness_worst_leaf": wit_leaf[worst_wit],
            "param_err": p_err}


def train_clips(root: str, seed: int, clips: int = 2, frames: int = 8, size: int = 544) -> None:
    """``clips`` folders of ``frames`` seeded size x size PNG frames, written
    through the numpy PNG codec (the card's machine may lack PIL)."""
    from mgldvsr_tpu_torch.io.frames import encode_png

    for c in range(clips):
        os.makedirs(os.path.join(root, f"{100 + c:03d}"))
        clip = lq_clip(seed + 30 + c, size, frames=frames)
        for i, frame in enumerate(clip):
            with open(os.path.join(root, f"{100 + c:03d}", f"{i:08d}.png"), "wb") as f:
                f.write(encode_png((frame * 255).round().astype(np.uint8)))


def full_train_pipeline(seed: int):
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline

    return jittered(MGLDVSRPipeline(full_config(2)), seed)


def train_args(data_root: str, logdir: str, steps: int, *extra):
    from mgldvsr_tpu_torch.cli import train as cli

    return cli.parse_args(["--stage", "1", "--data-root", data_root, "--logdir", logdir,
                           "--max-steps", str(steps), "--grad-accum", "4", "--ckpt-every", "4",
                           "--log-every", "1", "--image-every", "1000000", "--no-tb",
                           "--lr", str(TRAIN_LR), *extra])


def check_micro_steps(records: list, every: tuple, fused: bool, phase: str) -> None:
    """Each micro-step's record: a finite loss, the trainables changed at
    the accumulation boundaries (grad_accum 4) only, every kernel of
    ``every`` launched, attention all on the tensor-core kernel, and the
    fused chain's kernels launched only in the fused configuration."""
    accum = 4
    for r in records:
        if not np.isfinite(r["loss"]):
            raise AssertionError(f"{phase}: loss {r['loss']} at step {r['step']}")
        if r["changed"] != (r["step"] % accum == 0):
            raise AssertionError(f"{phase}: trainables changed={r['changed']} at "
                                 f"micro-step {r['step']} (grad_accum {accum})")
        for name in every:
            if r["counts"][name] == 0:
                raise AssertionError(f"{phase}: kernel {name} not launched in "
                                     f"micro-step {r['step']}")
        if r["counts"]["attention_wgmma"] != r["counts"]["attention"]:
            raise AssertionError(f"{phase}: attention {r['counts']['attention']} "
                                 f"launches, {r['counts']['attention_wgmma']} on wgmma")
        if not fused and any(r["counts"][name] for name in FUSED_ONLY):
            raise AssertionError(f"{phase}: {FUSED_ONLY} launched with the switch off")


def train_full(seed: int, card: str, data_root: str, logdir: str, steps: int, extra=(),
               phase="[phase8] (b)", snapshot_at=None):
    """(b) the shipped widths through the command line's loop in the
    default configuration: bf16 towers, float32 masters, seeded and
    jittered weights, the two-stage recipe (GT 512, LQ 128, 5 frames),
    grad_accum 4; ``extra`` flags added (phase 12: ``--mesh``). Checks every
    micro-step; returns (final state's copies, stats, each micro-step's
    metrics.jsonl loss and launches, and with ``snapshot_at`` the state's
    host copy after that micro-step)."""
    import torch

    from mgldvsr_tpu_torch.cli import train as cli
    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.train.trainer import partition_params

    pipe = full_train_pipeline(seed)
    train, frozen = partition_params(pipe)
    before = {k: p.detach().clone() for k, p in train.items()}
    frozen_before = {k: p.detach().clone() for k, p in frozen.items()}
    records, snap = [], {}

    def on_step(step, state, metrics):
        t_in = time.perf_counter()  # the loop's own work for this step is done
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        kernels.reset_launch_counts()
        changed = any(not torch.equal(state.trainable[k], before[k]) for k in before)
        if changed:
            for k in before:
                before[k].copy_(state.trainable[k])
        if step == snapshot_at:
            snap.update(to_host(state_copies(state)))
        records.append({"step": step, "loss": metrics["loss"], "s": metrics["step_s"],
                        "wait_s": metrics["data_wait_s"], "changed": changed,
                        "counts": counts, "t_in": t_in, "t_out": time.perf_counter()})

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with fused_switch(False):
        state = cli.stage1(train_args(data_root, logdir, steps, *extra), pipe=pipe,
                           on_step=on_step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    accum = 4
    check_micro_steps(records, TRAIN_EVERY_STEP, False, phase)
    for k, p in frozen.items():
        if not torch.equal(p, frozen_before[k].to(p.dtype)):
            raise AssertionError(f"{phase}: frozen {k} changed")
    if all(torch.equal(state.ema[k], v) for k, v in state.trainable.items()):
        raise AssertionError(f"{phase}: EMA equals the trainables")
    logged = [json.loads(line)["loss"] for line in open(os.path.join(logdir, "metrics.jsonl"))]
    times = [r["s"] for r in records[1:]]
    waits = [r["wait_s"] for r in records[1:]]
    # the loop's wall over steps 2..N: from the end of step 1 to the end of
    # step N, less the time this script's checks took between the steps
    # (data waits, checkpoint saves and logging stay in)
    spans = [b["t_in"] - a["t_out"] for a, b in zip(records, records[1:])]
    window = sum(spans)
    clips_s = len(times) / window
    # what the loop does besides the wait and the step: logging, saves
    other = [span - r["s"] - r["wait_s"] for span, r in zip(spans, records[1:])]
    per_step = {name: records[-1]["counts"][name] for name in KERNELS}
    n_train = sum(v.numel() for v in state.trainable.values())
    log(f"{phase} full width{''.join(' ' + e for e in extra)}, fused conv off, {steps} "
        f"micro-steps at grad_accum {accum}: losses {[round(r['loss'], 4) for r in records]}; "
        f"updates at {[r['step'] for r in records if r['changed']]}; the loop's wall over steps "
        f"2-{steps} {window:.4f} s = {clips_s:.4f} clips/s (checkpoint saves at steps "
        f"{[r['step'] for r in records[1:] if r['step'] % 4 == 0]} included); micro-step s "
        f"(step_s) {[round(t, 4) for t in times]}, median {np.median(times):.4f}; data wait "
        f"before each step s {[round(w, 4) for w in waits]}, sum {sum(waits):.4f}; the rest "
        f"of each step's span (logging, checkpoint saves) s {[round(o, 4) for o in other]}; "
        f"peak device "
        f"memory {peak / 2**30:.2f} GiB; {n_train / 1e6:.1f}M trainables; launches a micro-step "
        f"{ {k: n for k, n in per_step.items() if n} }  [{card}]")
    final = state_copies(state)
    del state, pipe, train, frozen, before, frozen_before
    torch.cuda.empty_cache()
    steps_seen = {"losses": logged, "counts": [r["counts"] for r in records]}
    if snapshot_at is not None:
        steps_seen["at"] = {"final": snap, "losses": logged[:snapshot_at],
                            "counts": steps_seen["counts"][:snapshot_at]}
    return final, {"median_s": float(np.median(times)), "min_s": float(min(times)),
                   "max_s": float(max(times)), "window_s": window, "clips_per_s": clips_s,
                   "wait_s": sum(waits), "other_s": other, "peak_bytes": peak,
                   "launches": per_step}, steps_seen


def state_copies(state) -> dict:
    """Copies of a stage-1 state's trainables, EMA and optimizer fields."""
    final = {part: {k: v.detach().clone() for k, v in getattr(state, part).items()}
             for part in ("trainable", "ema")}
    final.update({part: {k: v.clone() for k, v in state.opt_state[part].items()}
                  for part in ("mu", "nu", "acc")})
    return final


def train_resume(seed: int, card: str, data_root: str, logdir: str, straight: dict) -> None:
    """(b) continued: a fresh pipeline from the same seed resumes the step-4
    checkpoint and replays steps 5-8; the result against the straight run."""
    import shutil

    import torch

    from mgldvsr_tpu_torch.cli import train as cli

    resumed_dir = logdir + "_resumed"
    os.makedirs(os.path.join(resumed_dir, "ckpt"))
    shutil.copytree(os.path.join(logdir, "ckpt", "4"), os.path.join(resumed_dir, "ckpt", "4"))
    pipe = full_train_pipeline(seed)
    state = cli.stage1(train_args(data_root, resumed_dir, 8, "--resume"), pipe=pipe)
    worst, identical, total = {}, 0, 0
    for part in ("trainable", "ema", "mu", "nu", "acc"):
        got = getattr(state, part) if part in ("trainable", "ema") else state.opt_state[part]
        for k, want in straight[part].items():
            total += 1
            identical += torch.equal(got[k], want)
            worst[part] = max(worst.get(part, 0.0), max_err(got[k], want))
    log(f"[phase8] (b) resume at step 4, replay 5-8 against the straight run: {identical} of "
        f"{total} tensors bit for bit (limit: all of them: masters, EMA, both Adam moments and "
        f"the accumulator); max |d| { {k: f'{v:.3e}' for k, v in worst.items()} }  [{card}]")
    if (step := state.step) != 8:
        raise AssertionError(f"phase 8 (b): resumed run ended at step {step}")
    if identical != total:
        raise AssertionError(f"phase 8 (b): the resumed run differs in {total - identical} of "
                             f"{total} tensors: {worst}")
    del state, pipe
    torch.cuda.empty_cache()


def train_profile(seed: int, card: str, data_root: str, logdir: str) -> dict:
    """Where a full-width micro-step's time goes (default configuration).
    torch.profiler traces of the CLI loop's own micro-steps, data workers
    running, no checkpoint save: device time a micro-step and the device's
    idle share of the traced wall (a trace of kernels only; the profiler
    still adds host time to every launch, so the share is an upper bound),
    and the share of the device time in the backwards that replay a
    kernel's plain version. The same loop then takes micro-steps 7-10 in the
    fused configuration (read at call time), checked as (b) checks its own.
    Then, on the same pipeline and clips loaded in advance, micro-steps
    alone; and the data path's host seconds a clip on one thread, with the
    video-codec branch it took."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mgldvsr_tpu_torch.cli import train as cli
    from mgldvsr_tpu_torch.data.datasets import RealVSRRecurrentDataset
    from mgldvsr_tpu_torch.data.degradations import RandomVideoCompression
    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.train.trainer import Stage1Config, Stage1Trainer, partition_params
    from mgldvsr_tpu_torch.utils.profiling import check_kernels, reattach_cupti

    pipe = full_train_pipeline(seed)
    fused_from, steps_in_all = 6, 10  # (c): the fused configuration after step 6
    train, frozen = partition_params(pipe)
    before = {k: p.detach().clone() for k, p in train.items()}
    frozen_before = {k: p.detach().clone() for k, p in frozen.items()}
    fused = []
    # two traces of the loop, each from the end of micro-step ``first`` to
    # the end of ``last``: kernels only over steps 2-5 (one update in four,
    # as at grad_accum 4), for the idle share (the least overhead a launch),
    # and kernels with host ops over step 6, to put the kernels under their
    # autograd nodes (one step: a trace with host ops is slow to read)
    windows = {"idle": (1, 5, profile(activities=[ProfilerActivity.CUDA])),
               "nodes": (5, 6, profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA]))}
    marks = {}

    def on_step(step, state, metrics):
        # the window runs from a started trace to its last step's end; the
        # profiler's own start and stop stay outside it
        for name, (first, last, prof) in windows.items():
            if step == last:
                torch.cuda.synchronize()
                marks[name] = (time.perf_counter() - marks[name]) * 1000 / (last - first)
                prof.stop()
        for name, (first, last, prof) in windows.items():
            if step == first:
                torch.cuda.synchronize()
                reattach_cupti()
                prof.start()
                marks[name] = time.perf_counter()
        if step > fused_from:
            torch.cuda.synchronize()
            changed = any(not torch.equal(state.trainable[k], before[k]) for k in before)
            fused.append({"step": step, "loss": metrics["loss"], "s": metrics["step_s"],
                          "changed": changed, "counts": kernels.launch_counts()})
        if step >= fused_from:
            for k in before:
                before[k].copy_(state.trainable[k])
            kernels.reset_launch_counts()
        if step == fused_from:
            os.environ["MGLD_FUSED_GN_CONV"] = "1"
            torch.cuda.reset_peak_memory_stats()

    with part("phase8 (c) loop"), fused_switch(False):
        state = cli.stage1(train_args(data_root, logdir, steps_in_all, "--ckpt-every",
                                      "1000000"), pipe=pipe, on_step=on_step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check_micro_steps(fused, TRAIN_EVERY_STEP_FUSED, True, "[phase8] (c)")
    for k, p in frozen.items():
        if not torch.equal(p, frozen_before[k].to(p.dtype)):
            raise AssertionError(f"[phase8] (c): frozen {k} changed")
    if all(torch.equal(state.ema[k], v) for k, v in state.trainable.items()):
        raise AssertionError("[phase8] (c): EMA equals the trainables")
    per_step = {name: fused[-1]["counts"][name] for name in KERNELS}
    log(f"[phase8] (c) full width, fused conv on, the same CLI loop's micro-steps "
        f"{fused_from + 1}-{steps_in_all} at grad_accum 4: losses "
        f"{[round(r['loss'], 4) for r in fused]}; updates at "
        f"{[r['step'] for r in fused if r['changed']]}; micro-step s (step_s) "
        f"{[round(r['s'], 4) for r in fused]}; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches a micro-step { {k: n for k, n in per_step.items() if n} }  [{card}]")
    del before, frozen_before, state
    t_read = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA

    def device_ms(name):
        first, last, prof = windows[name]
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == cuda) / 1000 / (last - first)

    for name, (_, _, prof) in windows.items():
        check_kernels(prof, f"phase 8: the {name} trace of the CLI loop", launched=True)
    wall, device = marks["idle"], device_ms("idle")
    first, last, nodes = windows["nodes"]
    by_node: dict = {}
    for e in nodes.events():
        if e.name.startswith("autograd::engine::evaluate_function:"):
            node = e.name.split(":")[-1].strip()
            if node in PLAIN_BACKWARDS:
                ms = e.device_time_total / 1000 / (last - first)
                by_node[node] = by_node.get(node, 0.0) + ms
    plain, device_nodes = sum(by_node.values()), device_ms("nodes")
    PARTS["phase8 (c) traces read"] = time.perf_counter() - t_read
    if device <= 0 or device_nodes <= 0:
        raise AssertionError("phase 8: the profiler saw no device time")

    deg1, deg2 = cli.default_degradation_cfg()
    ds = RealVSRRecurrentDataset(data_root, gt_size=512, degradation_1=deg1,
                                 degradation_2=deg2, seed=seed)
    t0 = time.perf_counter()
    items = [ds[i % len(ds)] for i in range(2)]
    host_s = (time.perf_counter() - t0) / len(items)
    # what the video compression of the two stages took on this machine:
    # "pyav", "cv2:<fourcc>" or "identity (<why>)"; none of them fails
    codec = sorted({t.branch for stage in (ds.stage1, ds.stage2)
                    for t in stage.transforms if isinstance(t, RandomVideoCompression)})
    log(f"[phase8] the stage-1 dataset's video compression on this machine: "
        f"{', '.join(map(str, codec))}  [{card}]")
    trainer = Stage1Trainer(pipe, Stage1Config(grad_accum=4, learning_rate=TRAIN_LR))
    state = trainer.init_state()
    clips = [(upscale_frames(torch.from_numpy(it["lqs"]).cuda(), 4),
              torch.from_numpy(it["gts"]).cuda()) for it in items]

    def steps(n):
        """``n`` micro-steps timed as the loop's ``step_s`` (to the metrics
        on the host)."""
        nonlocal state
        out = []
        for i in range(n):
            lq, gt = clips[i % len(clips)]
            t = time.perf_counter()
            state, metrics = trainer.train_step(
                state, lq, gt, torch.Generator(device="cuda").manual_seed(seed + i))
            metrics = {k: float(v) for k, v in metrics.items()}
            out.append(time.perf_counter() - t)
        return out

    # micro-steps alone, against the traced loop's with the workers beside
    # them
    with part("phase8 (c) micro-steps alone"):
        steps(1)  # warm
        alone = steps(4)
    med = {"alone": float(np.median(alone))}
    log(f"[phase8] the CLI loop under torch.profiler, data workers running: micro-steps 2-5 "
        f"traced for kernels only, {wall:.2f} ms of wall a micro-step, {device:.2f} ms of device "
        f"time, idle share {1 - device / wall:.4f}; micro-step 6 traced with host ops too "
        f"({marks['nodes']:.2f} ms of wall), {device_nodes:.2f} ms of device time, of it the "
        f"plain backwards {plain:.2f} ms = {100 * plain / device_nodes:.1f}% "
        f"({ {k: round(v, 2) for k, v in by_node.items()} }). Micro-steps on clips loaded in "
        f"advance, alone, s: {[round(t, 4) for t in alone]} (median {med['alone']:.4f}). Host "
        f"data path {host_s:.3f} s a clip (one thread, GT 512 from 544x544 PNGs, two stages)"
        f"  [{card}]")
    del state, trainer, pipe, clips
    torch.cuda.empty_cache()
    return {"wall_ms": wall, "device_ms": device, "idle_share": 1 - device / wall,
            "plain_backward_ms": plain, "plain_backward_share": plain / device_nodes,
            "by_node_ms": by_node, "step_s": med, "host_s_per_clip": host_s, "codec": codec,
            "fused": {"launches": per_step, "peak_bytes": peak,
                      "median_s": float(np.median([r["s"] for r in fused]))}}


def train_cli_tiny(card: str, tmp: str) -> None:
    """(d) ``--stage 1 --tiny --max-steps 4`` on the card, then the inference
    command line restores a clip with the parameters it exported."""
    from mgldvsr_tpu_torch.cli import infer as infer_cli
    from mgldvsr_tpu_torch.cli import train as cli
    from mgldvsr_tpu_torch.io.frames import read_frame

    root = os.path.join(tmp, "tiny_gt")
    train_clips(root, 40, clips=2, frames=6, size=48)
    logdir = os.path.join(tmp, "tiny_run")
    t0 = time.perf_counter()
    cli.main(["--stage", "1", "--data-root", root, "--tiny", "--max-steps", "4",
              "--grad-accum", "2", "--ckpt-every", "2", "--log-every", "1", "--logdir", logdir])
    wall = time.perf_counter() - t0
    records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    export = os.path.join(logdir, "export")
    out = os.path.join(tmp, "tiny_out")
    infer_cli.main(["--seqs-path", root, "--out-path", out, "--preset", "tiny", "--ddpm-steps",
                    "2", "--torch-ckpt", os.path.join(export, "mgld_ema.pt"), "--raft-ckpt",
                    os.path.join(export, "raft.pt"), "--num-shards", "2"])
    frames = sorted(os.listdir(os.path.join(out, "100")))
    shapes = {read_frame(os.path.join(out, "100", n)).shape for n in frames}
    log(f"[phase8] (d) training CLI --tiny on the card: steps {[r['step'] for r in records]}, "
        f"losses {[round(r['loss'], 4) for r in records]}, {wall:.2f} s; checkpoints "
        f"{sorted(os.listdir(os.path.join(logdir, 'ckpt')))}; the inference CLI restored "
        f"{len(frames)} frames {sorted(shapes)} with the exported parameters  [{card}]")
    if [r["step"] for r in records] != [1, 2, 3, 4] or not all(
            np.isfinite(r["loss"]) for r in records):
        raise AssertionError(f"phase 8 (d): metrics {records}")
    if frames != [f"{i:08d}.png" for i in range(6)] or shapes != {(192, 192, 3)}:
        raise AssertionError(f"phase 8 (d): restored {frames} {shapes}")


def to_host(tree):
    """A copy of a tree of tensors in host memory."""
    if hasattr(tree, "cpu"):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree


def phase8(seed: int, card: str, keep: dict | None = None) -> dict:
    """``keep``: where (b)'s straight run is kept (in host memory) for phase
    12 to hold its ranks against."""
    import shutil
    import tempfile

    with part("phase8 (a)"):
        out = {"tiny": {f: phase8_tiny(seed, card, f) for f in (False, True)}}
    with tempfile.TemporaryDirectory() as tmp:
        data_root = os.path.join(tmp, "gt")
        train_clips(data_root, seed)
        with part("phase8 (b)"):
            straight, out["default"], seen = train_full(seed, card, data_root,
                                                        os.path.join(tmp, "b"), 8,
                                                        snapshot_at=4)
        if keep is not None:
            keep["stage1"] = {"final": to_host(straight), **seen}
        with part("phase8 (b) resume"):
            train_resume(seed, card, data_root, os.path.join(tmp, "b"), straight)
        del straight
        shutil.rmtree(os.path.join(tmp, "b"))
        shutil.rmtree(os.path.join(tmp, "b_resumed"))
        with part("phase8 (c)"):
            out["profile"] = train_profile(seed, card, data_root, os.path.join(tmp, "p"))
        out["fused"] = out["profile"].pop("fused")
        with part("phase8 (d)"):
            train_cli_tiny(card, tmp)
    return out


# -- phase 9: stage-2 training --------------------------------------------------

STAGE2_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                           "video_autoencoder_kl_64x64x4_resi.yaml")
# launched in every stage-2 micro-step: the swc loss's warp, the channel sums
# (the decoder's and the LQ encode's 128^2-512^2 GroupNorms, forward and
# backward) and the fused GroupNorm (the 64^2 levels); the fused configuration
# gives every GroupNorm->SiLU->conv chain to the chain's two kernels
STAGE2_EVERY_STEP = ("warp_forward", "channel_sums", "fused_group_norm")
STAGE2_EVERY_STEP_FUSED = ("warp_forward", "fused_group_norm") + FUSED_ONLY
STAGE2_METRICS = ("loss_g", "nll_loss", "rec_loss", "temp_loss", "g_loss", "d_weight",
                  "loss_d", "logits_real", "logits_fake")
# phase 9 (a)'s limits, about 3x the readings on an H100 (in brackets, the
# worse of the two configurations). The generator's half, card against CPU:
# the metrics relative, the GAN means of logits of either sign against the
# logits' scale [1.05e-5, logits_real]; a gradient leaf's distance over its
# norm plus 1e-3 of the largest leaf norm, and the whole gradient's over
# its norm, for micro-step 1's gradient (the accumulator) [1.37e-4 /
# 8.1e-6], Adam's moments after the update [mu 5.57e-4 / 4.5e-5, nu
# 2.03e-4 / 5.7e-6] and micro-step 2's gradient taken from the first
# moment [9.91e-4 / 7.7e-5]. The discriminator's half against its float64
# replay on the card's own inputs, by the same measures [step 1 9.86e-6 /
# 5.43e-6, step 2 2.05e-6 / 1.61e-6, mu 7.58e-6 / 3.85e-6, nu 6.51e-6 /
# 2.12e-6], and its running statistics relative to their largest value
# [2.76e-7]. (The CPU's float32 is no reference for the discriminator: on
# these frames a LeakyReLU input lies within float32 rounding of 0, and
# the CPU's gradient stands 1.68e-3 of the whole from float64; the line
# prints it.)
S2_METRIC_REL = 3.5e-5
S2_LEAF = {"gen": 3e-3, "disc": 3e-5}
S2_WHOLE = {"gen": 2.5e-4, "disc": 1.7e-5}
S2_STATS_REL = 1e-6
# After the update, where the mean gradient is at least 1e-5 (1000 Adam
# eps) and 10x the leaf's largest gradient error, Adam's step is lr times
# the gradient's sign to within ~1e-4 lr on either side: there the
# parameters must agree to 1e-3 lr plus one float32 ulp of the parameter
# [0.130 of that for the generator, 0.303 for the discriminator];
# elsewhere a sign may flip and the two stand up to 2 lr apart. At least
# this share of the elements must be held so [78.32%, 99.23%].
S2_HELD_SHARE = {"gen": 0.75, "disc": 0.97}


def calm_spynet(trainer) -> None:
    """Scale the last conv of each SpyNet level by 1e-2: random SpyNet
    weights predict flows that the consistency check marks occluded
    everywhere, and the swc term would be zero."""
    import torch

    with torch.no_grad():
        for level in trainer.spynet.basic_module:
            level.basic_module[8].weight.mul_(1e-2)
            level.basic_module[8].bias.mul_(1e-2)


def snapshot(state) -> dict:
    """Copies of a stage-2 state's tensors (they change in place)."""
    import torch

    def copy(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().clone()
        if isinstance(tree, dict):
            return {k: copy(v) for k, v in tree.items()}
        return tree

    return {"trainable": copy(state.trainable), "logvar": copy(state.logvar),
            "disc": copy(state.disc), "opt_g": copy(state.opt_g), "opt_d": copy(state.opt_d),
            "step": state.step}


def leaf_spread(got: dict, want: dict):
    """(each leaf's |got - want| over its norm plus 1e-3 of the largest leaf
    norm, the whole's |got - want| over its norm)."""
    norms = {k: float(w.double().norm()) for k, w in want.items()}
    big = max(norms.values())
    d = {k: float((got[k].double() - w.double()).norm()) for k, w in want.items()}
    whole = (sum(v * v for v in d.values()) / sum(n * n for n in norms.values())) ** 0.5
    return {k: d[k] / (norms[k] + 1e-3 * big) for k in d}, whole


def held_after_update(got: dict, want: dict, got_mu: dict, want_mu: dict, b1: float):
    """Parameters after Adam's first update against a reference, on the
    elements where the update cannot depend on rounding: the reference's
    mean gradient (mu / (1 - b1)) at least 1e-5 and 10x the leaf's largest
    mean-gradient error. Returns (worst |d| there over 1e-3 lr plus one
    float32 ulp of the reference, the share of elements held)."""
    import torch

    worst, held, total = 0.0, 0, 0
    for k, w in want.items():
        g_w = want_mu[k].double() / (1 - b1)
        err = float((got_mu[k].double() / (1 - b1) - g_w).abs().max())
        mask = g_w.abs() >= max(10 * err, 1e-5)
        w32 = w.float()
        ulp = (torch.nextafter(w32.abs(), torch.tensor(float("inf"))) - w32.abs()).double()
        d = (got[k].double() - w.double()).abs() / (1e-3 * TRAIN_LR + ulp)
        if mask.any():
            worst = max(worst, float(d[mask].max()))
        held += int(mask.sum())
        total += mask.numel()
    return worst, held / total


def disc_replay64(steps: list, opt_cfg) -> dict:
    """The discriminator's half of each recorded micro-step replayed in
    float64 on the CPU from that micro-step's own inputs (the GT frames, the
    reconstruction it was given, the discriminator's tensors before it):
    the two training passes, the hinge loss (disc_start 0: factor 1), the
    gradient accumulation and Adam update of train/optim.py. Returns
    micro-step 1's accumulator, each micro-step's running statistics, and
    after the last the moments and the parameters."""
    import torch
    from torch.func import functional_call

    from mgldvsr_tpu_torch.models.discriminator import NLayerDiscriminator
    from mgldvsr_tpu_torch.train import optim
    from mgldvsr_tpu_torch.train.losses import hinge_d_loss

    disc = NLayerDiscriminator().double()
    names = [k for k, _ in disc.named_parameters()]
    params = {k: steps[0]["before"][k].double().clone() for k in names}
    opt = optim.init_opt_state(params, opt_cfg)
    out = {"stats": []}
    for s in steps:
        live = {k: v.double().clone().requires_grad_(k in names) for k, v in s["before"].items()}
        real = (s["real"] * 2.0 - 1.0).float().permute(0, 3, 1, 2).double()
        loss = hinge_d_loss(functional_call(disc, live, (real,), {"train": True}),
                            functional_call(disc, live, (s["recon"].double(),), {"train": True}))
        grads = dict(zip(names, torch.autograd.grad(loss, [live[k] for k in names])))
        optim.step(grads, opt, params, opt_cfg)
        out["stats"].append({k: v.detach() for k, v in live.items() if "running" in k})
        if "acc" not in out:
            out["acc"] = {k: v.clone() for k, v in opt["acc"].items()}
    out.update(mu=opt["mu"], nu=opt["nu"], params=params)
    return out


def phase9_tiny(seed: int, card: str, fused: bool) -> dict:
    """(a) two tiny fp32 micro-steps (grad_accum 2, disc_start 0) at 64x64
    from the same weights on the card and on the CPU. The generator's half,
    card against CPU: the metrics, micro-step 1's gradient (the
    accumulator), Adam's moments after the update (the mean of both
    micro-steps' gradients) and micro-step 2's gradient taken from the first
    moment, and the trainables and logvar after the update. The
    discriminator's half against its float64 replay on the card's own
    inputs: the same gradients and moments, its parameters after the update
    and its running statistics after each micro-step."""
    import torch

    from mgldvsr_tpu_torch.cli import train as cli
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights, jitter_weights
    from mgldvsr_tpu_torch.models.vae import VideoAutoencoderKLResi
    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer

    cfg = tiny_config()
    src = MGLDVSRPipeline(cfg, "cpu")
    init_pipeline_weights(src, seed)
    jitter_weights(src, 0.02, seed)
    vae_sd = src.vae.state_dict()
    aux = Stage2Trainer(src.vae, Stage2Config())
    cli.seed_stage2_aux(aux, seed)
    calm_spynet(aux)
    aux_sd = {name: getattr(aux, name).state_dict() for name in ("lpips", "disc", "spynet")}
    size = 64
    # other frames and latents in each micro-step
    items = [(torch.from_numpy(lq_clip(seed + 50 + 3 * i, size)),
              torch.from_numpy(lq_clip(seed + 51 + 3 * i, size)),
              torch.from_numpy(np.random.RandomState(seed + 52 + 3 * i).randn(5, 8, 8, 4)
                               .astype(np.float32))) for i in range(2)]

    def run(device):
        vae = VideoAutoencoderKLResi(cfg.vae).to(device)
        vae.load_state_dict(vae_sd)
        tr = Stage2Trainer(vae, Stage2Config(num_frames=5, grad_accum=2, disc_start=0,
                                             learning_rate=TRAIN_LR))
        for name, sd in aux_sd.items():
            getattr(tr, name).load_state_dict(sd)
        state = tr.init_state()
        seen, disc_step = [], tr.disc_step

        def recording(st, gt_01, recon_det):
            seen.append({"before": {k: v.detach().cpu().clone() for k, v in st.disc.items()},
                         "real": gt_01.cpu(), "recon": recon_det.detach().cpu().clone()})
            return disc_step(st, gt_01, recon_det)

        tr.disc_step = recording
        out = []
        for lq, gt, lat in items:
            state, m = tr.train_step(state, lq.to(device), gt.to(device), lat.to(device))
            snap = to_cpu(snapshot(state))
            snap.update(seen[-1], metrics={k: float(v) for k, v in m.items()})
            out.append(snap)
        return out, tr.opt_cfg

    with fused_switch(fused):
        cpu, opt_cfg = run("cpu")
        kernels.reset_launch_counts()
        gpu, _ = run("cuda")
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    b1 = opt_cfg.b1

    def gen(snaps):
        """The generator's trainables and logvar as one dict."""
        return {**snaps["trainable"], "logvar": snaps["logvar"]}

    def second(acc1, mu):
        """Micro-step 2's gradient: the first moment after the first
        update is (1 - b1) times the mean of the two."""
        return {k: 2 * mu[k].double() / (1 - b1) - acc1[k].double() for k in acc1}

    rows = {}
    g1, g2 = gpu[0]["opt_g"], gpu[1]["opt_g"]
    c1, c2 = cpu[0]["opt_g"], cpu[1]["opt_g"]
    rows["gen"] = {"step 1": leaf_spread(g1["acc"], c1["acc"]),
                   "step 2": leaf_spread(second(g1["acc"], g2["mu"]), second(c1["acc"], c2["mu"])),
                   "mu": leaf_spread(g2["mu"], c2["mu"]), "nu": leaf_spread(g2["nu"], c2["nu"])}
    gen_held = held_after_update(gen(gpu[1]), gen(cpu[1]), g2["mu"], c2["mu"], b1)
    replays = {side: disc_replay64(snaps, opt_cfg) for side, snaps in (("card", gpu),
                                                                      ("cpu", cpu))}
    rep = replays["card"]
    d1, d2 = gpu[0]["opt_d"], gpu[1]["opt_d"]
    rep_g2 = second(rep["acc"], rep["mu"])
    rows["disc"] = {"step 1": leaf_spread(d1["acc"], rep["acc"]),
                    "step 2": leaf_spread(second(d1["acc"], d2["mu"]), rep_g2),
                    "mu": leaf_spread(d2["mu"], rep["mu"]), "nu": leaf_spread(d2["nu"], rep["nu"])}
    cpu_disc = leaf_spread(cpu[0]["opt_d"]["acc"], replays["cpu"]["acc"])[1]
    disc_held = held_after_update({k: gpu[1]["disc"][k] for k in rep["params"]}, rep["params"],
                                  d2["mu"], rep["mu"], b1)
    stats_rel = max(max_err(gpu[i]["disc"][k], v) / float(v.abs().max())
                    for i in range(2) for k, v in rep["stats"][i].items())
    metric_err = {}
    for i in range(2):
        m_c, m_g = cpu[i]["metrics"], gpu[i]["metrics"]
        scale = abs(m_c["logits_real"]) + abs(m_c["logits_fake"])
        for name in STAGE2_METRICS:
            floor = scale if name in ("g_loss", "logits_real", "logits_fake") else abs(m_c[name])
            rel = abs(m_g[name] - m_c[name]) / max(abs(m_c[name]), floor, 1e-12)
            metric_err[name] = max(metric_err.get(name, 0.0), rel)

    def row(part):
        return ", ".join(f"{what} {max(d, key=d.get)} {max(d.values()):.3e} / {whole:.3e}"
                         for what, (d, whole) in rows[part].items())

    log(f"[phase9] (a) tiny fp32 stage-2 micro-steps {size}x{size}, 5 frames, grad_accum 2, "
        f"fused conv {'on' if fused else 'off'}: metrics card vs CPU, worst relative "
        f"{ {k: f'{v:.2e}' for k, v in metric_err.items()} } (limit {S2_METRIC_REL:.1e}); "
        f"d_weight {gpu[0]['metrics']['d_weight']:.6e} / {cpu[0]['metrics']['d_weight']:.6e}; "
        f"temp_loss {gpu[0]['metrics']['temp_loss']:.6f}. Worst leaf / whole over their norms "
        f"(limits): the generator card vs CPU: {row('gen')} ({S2_LEAF['gen']:.1e} / "
        f"{S2_WHOLE['gen']:.1e}); the discriminator card vs its float64 replay on the card's "
        f"inputs: {row('disc')} ({S2_LEAF['disc']:.1e} / {S2_WHOLE['disc']:.1e}), the CPU's "
        f"float32 against its own replay {cpu_disc:.3e} of the whole at step 1 (no limit); "
        f"running statistics {stats_rel:.3e} relative (limit {S2_STATS_REL:.1e}). After the "
        f"update, on the elements held, worst |d| over 1e-3 lr + 1 ulp: trainables and logvar "
        f"{gen_held[0]:.3f} ({100 * gen_held[1]:.2f}% held), the discriminator's parameters "
        f"against the replay {disc_held[0]:.3f} ({100 * disc_held[1]:.2f}% held) (limits 1, "
        f"{100 * S2_HELD_SHARE['gen']:.0f}% / {100 * S2_HELD_SHARE['disc']:.0f}% held); "
        f"launches "
        f"{ {k: n for k, n in counts.items() if n} }  [{card}]")
    for part, measures in rows.items():
        for what, (d, whole) in measures.items():
            if max(d.values()) > S2_LEAF[part] or whole > S2_WHOLE[part]:
                k = max(d, key=d.get)
                raise AssertionError(f"phase 9 (a): {part} {what}: leaf {k} {d[k]:.3e}, the "
                                     f"whole {whole:.3e} of its norm")
    if max(metric_err.values()) > S2_METRIC_REL:
        raise AssertionError(f"phase 9 (a): metrics card vs CPU {metric_err}")
    if stats_rel > S2_STATS_REL:
        raise AssertionError(f"phase 9 (a): running statistics {stats_rel:.3e}")
    for what, (worst, share) in (("gen", gen_held), ("disc", disc_held)):
        if worst > 1 or share < S2_HELD_SHARE[what]:
            raise AssertionError(f"phase 9 (a): {what} after the update: {worst:.3f} of the "
                                 f"limit on {100 * share:.2f}% of the elements")
    if cpu[0]["metrics"]["temp_loss"] <= 0:
        raise AssertionError("phase 9 (a): temp_loss is 0 (every pixel occluded)")
    for name in ("warp_forward", "fused_group_norm") + (FUSED_ONLY if fused else ()):
        if counts[name] == 0:
            raise AssertionError(f"phase 9 (a): kernel {name} was never launched")
    return {"metric_rel": metric_err, "rows": rows, "stats_rel": stats_rel,
            "held": {"gen": gen_held, "disc": disc_held}}


def to_cpu(snap):
    """``snap`` with every tensor on the CPU."""
    import torch

    if isinstance(snap, torch.Tensor):
        return snap.cpu()
    if isinstance(snap, dict):
        return {k: to_cpu(v) for k, v in snap.items()}
    return snap


def stage2_data(tmp: str, seed: int) -> dict:
    """Two seeded 10-frame 512x512 GT clips, their LQ frames at 128x128 (a
    bicubic downscale), and the latents of the LQ clips written by the
    inference command line's latent mode at full width (2 steps)."""
    import torch

    from mgldvsr_tpu_torch.cli import infer as infer_cli
    from mgldvsr_tpu_torch.io.frames import encode_png
    from mgldvsr_tpu_torch.ops.resize import resize2d

    roots = {k: os.path.join(tmp, k) for k in ("gt", "lq", "lat")}
    for c in range(2):
        clip = lq_clip(seed + 60 + c, 512, frames=10)
        lq = resize2d(torch.from_numpy(clip), (128, 128), method="bicubic").clamp(0, 1).numpy()
        for root, frames in (("gt", clip), ("lq", lq)):
            os.makedirs(os.path.join(roots[root], f"{200 + c:03d}"))
            for i, frame in enumerate(frames):
                with open(os.path.join(roots[root], f"{200 + c:03d}", f"{i:08d}.png"), "wb") as f:
                    f.write(encode_png((frame * 255).round().astype(np.uint8)))
    t0 = time.perf_counter()
    infer_cli.main(["--seqs-path", roots["lq"], "--out-path", roots["lat"], "--mode", "latent",
                    "--ddpm-steps", "2", "--seed", str(seed)])
    torch.cuda.empty_cache()
    n = len([f for f in os.listdir(os.path.join(roots["lat"], "200")) if f.endswith(".npy")])
    log(f"[phase9] latents of 2 LQ clips of 10 frames at 128x128 written by the latent mode at "
        f"full width (2 steps) in {time.perf_counter() - t0:.2f} s: {n} a clip, shape "
        f"{np.load(os.path.join(roots['lat'], '200', '00000000.npy')).shape}")
    if n != 10:
        raise AssertionError(f"phase 9: the latent mode wrote {n} latents for 10 frames")
    return roots


def stage2_args(roots: dict, logdir: str, steps: int, seed: int, *extra):
    from mgldvsr_tpu_torch.cli import train as cli

    return cli.parse_args(["--config", STAGE2_YAML, "--seed", str(seed), "--data-root",
                           roots["gt"], "--lq-root",
                           roots["lq"], "--latent-root", roots["lat"], "--logdir", logdir,
                           "--max-steps", str(steps), "--grad-accum", "4", "--ckpt-every", "4",
                           "--log-every", "1", "--no-tb", "--lr", str(TRAIN_LR), *extra])


def stage2_pipeline(args):
    """The shipped stage-2 widths (the YAML's model: section: bf16 VAE with
    fusion), float32 weights seeded by ``--seed`` and jittered by 0.02
    N(0, 1) (seeded temporal blends would leave the temporal convs without
    gradient)."""
    from mgldvsr_tpu_torch.cli import train as cli
    from mgldvsr_tpu_torch.io.init_weights import jitter_weights

    pipe = cli.build_pipeline(args)
    jitter_weights(pipe, 0.02, args.seed)
    return pipe


def stage2_full(seed: int, card: str, roots: dict, logdir: str, steps: int, fused: bool,
                extra=(), phase=None, snapshot_at=None):
    """(b)/(d) the shipped stage-2 config through the command line's loop,
    ``extra`` flags added (phase 12: ``--mesh``): every micro-step checked;
    returns (final state's copies, stats, each micro-step's metrics.jsonl
    losses and launches, and with ``snapshot_at`` the state's host copy
    after that micro-step)."""
    import torch

    from mgldvsr_tpu_torch.cli import train as cli
    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.train.stage2 import partition_vae_params

    phase = phase or ("[phase9] (d)" if fused else "[phase9] (b)")
    args = stage2_args(roots, logdir, steps, seed, *extra)
    pipe = stage2_pipeline(args)
    held, before, records, snap = {}, {}, [], {}

    def on_trainer(trainer):
        """Before the state is made: the VAE holds its float32 weights,
        which become the masters, and logvar starts at 0."""
        calm_spynet(trainer)
        held["trainer"] = trainer
        held["aux"] = {name: {k: v.clone() for k, v in getattr(trainer, name).state_dict().items()}
                       for name in ("lpips", "spynet")}
        train, frozen = partition_vae_params(trainer.vae)
        held["frozen"] = {k: p.detach().clone() for k, p in frozen.items()}
        before.update({k: p.detach().float().clone() for k, p in train.items()})
        before["logvar"] = torch.zeros((), device=trainer.device)

    def on_step(step, state, metrics):
        t_in = time.perf_counter()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        kernels.reset_launch_counts()
        now = dict(state.trainable, logvar=state.logvar)
        changed = [k for k in before if not torch.equal(now[k], before[k])]
        for k in changed:
            before[k].copy_(now[k])
        if step == snapshot_at:
            snap.update(to_host(snapshot(state)))
        records.append({"step": step, "m": metrics, "changed": len(changed),
                        "logvar": "logvar" in changed,
                        "counts": counts, "t_in": t_in, "t_out": time.perf_counter()})

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with fused_switch(fused):
        state = cli.stage2(args, pipe=pipe, on_step=on_step, on_trainer=on_trainer)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    trainer = held["trainer"]
    n_train = len(state.trainable) + 1
    every = STAGE2_EVERY_STEP_FUSED if fused else STAGE2_EVERY_STEP
    for r in records:
        m = r["m"]
        if not all(np.isfinite(m[k]) for k in STAGE2_METRICS) or m["temp_loss"] <= 0:
            raise AssertionError(f"{phase}: metrics {m} at step {r['step']}")
        # at an update every trainable moves but one whose gradient is
        # exactly zero (a bias that the next GroupNorm cancels)
        update = r["step"] % 4 == 0
        if (r["changed"] >= 0.95 * n_train and r["logvar"]) != update or (
                not update and r["changed"]):
            raise AssertionError(f"{phase}: {r['changed']} of {n_train} trainables "
                                 f"changed at micro-step {r['step']} (grad_accum 4), logvar "
                                 f"{r['logvar']}")
        for name in every:
            if r["counts"][name] == 0:
                raise AssertionError(f"{phase}: kernel {name} not launched in "
                                     f"micro-step {r['step']}")
        if r["counts"]["warp_forward"] != 1:  # the swc loss's warps in one call
            raise AssertionError(f"{phase}: {r['counts']['warp_forward']} warp_forward "
                                 f"launches in micro-step {r['step']}, not 1")
        if not fused and any(r["counts"][name] for name in FUSED_ONLY):
            raise AssertionError(f"{phase}: {FUSED_ONLY} launched with the switch off")
    _, frozen = partition_vae_params(trainer.vae)
    for k, p in frozen.items():
        if not torch.equal(p, held["frozen"][k].to(p.dtype)):
            raise AssertionError(f"{phase}: frozen VAE weight {k} changed")
    for name, sd in held["aux"].items():
        for k, v in getattr(trainer, name).state_dict().items():
            if not torch.equal(v, sd[k]):
                raise AssertionError(f"{phase}: {name} {k} changed")
    times = [r["m"]["step_s"] for r in records[1:]]
    spans = [b["t_in"] - a["t_out"] for a, b in zip(records, records[1:])]
    saves = [s for s, r in zip(spans, records[1:]) if r["step"] % 4 == 0]
    window = sum(spans)
    clips_s = len(spans) / window
    no_save = (len(spans) - len(saves)) / (window - sum(saves)) if len(spans) > len(saves) else None
    per_step = {name: records[-1]["counts"][name] for name in KERNELS}
    ms = {k: [round(r["m"][k], 4) for r in records] for k in ("loss_g", "temp_loss", "d_weight")}
    log(f"{phase} the shipped stage-2 config (VAE ch 128, bf16, fusion 2 blocks, 5 "
        f"frames, GT 512) through the CLI loop{''.join(' ' + e for e in extra)}, fused conv "
        f"{'on' if fused else 'off'}, {steps} "
        f"micro-steps at grad_accum 4: {ms}; trainables changed (of {n_train} with logvar) "
        f"{[r['changed'] for r in records]}; frozen VAE, LPIPS and SpyNet bit for bit; the "
        f"loop's wall over steps 2-{steps} {window:.4f} s = {clips_s:.4f} clips/s with the "
        f"saves at {[r['step'] for r in records[1:] if r['step'] % 4 == 0]} "
        f"({[round(s, 4) for s in saves]} s), "
        f"{'n/a' if no_save is None else f'{no_save:.4f}'} clips/s without their spans; "
        f"micro-step s (step_s) {[round(t, 4) for t in times]}, median {np.median(times):.4f}; "
        f"data wait s {[round(r['m']['data_wait_s'], 4) for r in records[1:]]}; peak device "
        f"memory {peak / 2**30:.2f} GiB; launches a micro-step "
        f"{ {k: n for k, n in per_step.items() if n} }  [{card}]")
    final = snapshot(state)
    del state, pipe, trainer, held
    torch.cuda.empty_cache()
    logged = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    steps_seen = {"losses": [{k: r[k] for k in STAGE2_METRICS} for r in logged],
                  "counts": [r["counts"] for r in records]}
    if snapshot_at is not None:
        steps_seen["at"] = {"final": snap, "losses": steps_seen["losses"][:snapshot_at],
                            "counts": steps_seen["counts"][:snapshot_at]}
    return final, {"clips_per_s": clips_s, "clips_per_s_no_save": no_save,
                   "median_s": float(np.median(times)), "window_s": window, "saves_s": saves,
                   "peak_bytes": peak, "launches": per_step}, steps_seen


def stage2_resume(seed: int, card: str, roots: dict, logdir: str, straight: dict) -> dict:
    """(b) continued: a fresh pipeline from the same seed resumes the step-4
    checkpoint and replays 5-8, which must equal the straight run bit for
    bit (the trainer runs cuDNN's deterministic algorithms)."""
    import shutil

    import torch

    from mgldvsr_tpu_torch.cli import train as cli

    resumed = logdir + "_resumed"
    os.makedirs(os.path.join(resumed, "ckpt"))
    shutil.copytree(os.path.join(logdir, "ckpt", "4"), os.path.join(resumed, "ckpt", "4"))
    args = stage2_args(roots, resumed, 8, seed, "--resume")
    state = cli.stage2(args, pipe=stage2_pipeline(args), on_trainer=calm_spynet)
    got = snapshot(state)
    worst, identical, total = {}, 0, 0

    def compare(part, a, b):
        nonlocal identical, total
        total += 1
        identical += torch.equal(a, b)
        worst[part] = max(worst.get(part, 0.0), max_err(a, b))

    compare("logvar", got["logvar"], straight["logvar"])
    for part in ("trainable", "disc"):
        for k, v in straight[part].items():
            compare(part, got[part][k], v)
    for opt in ("opt_g", "opt_d"):
        for part in ("mu", "nu", "acc"):
            for k, v in straight[opt][part].items():
                compare(f"{opt}.{part}", got[opt][part][k], v)
    log(f"[phase9] (b) resume at step 4, replay 5-8 against the straight run: {identical} of "
        f"{total} tensors bit for bit (limit: all of them: trainables, logvar, the "
        f"discriminator's parameters and statistics, both Adam states and accumulators); max "
        f"|d| { {k: f'{v:.3e}' for k, v in worst.items()} }  [{card}]")
    if got["step"] != 8:
        raise AssertionError(f"phase 9 (b): resumed run ended at step {got['step']}")
    if identical != total:
        raise AssertionError(f"phase 9 (b): the resumed run differs in {total - identical} of "
                             f"{total} tensors: {worst}")
    del state
    torch.cuda.empty_cache()
    return {"identical": identical, "total": total, "worst": worst}


def stage2_items(roots: dict, count: int, scale_factor: float):
    """``count`` windows of the stage-2 data on the card, as the loop feeds
    them: (lq upscaled x4, gt, latents / scale factor)."""
    import torch

    from mgldvsr_tpu_torch.data.datasets import REDSAutoencoderDataset
    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames

    ds = REDSAutoencoderDataset(roots["gt"], roots["lq"], roots["lat"], num_frame=5)
    out = []
    for i in range(count):
        it = ds[i % len(ds)]
        out.append((upscale_frames(torch.from_numpy(it["lqs"]).cuda(), 4),
                    torch.from_numpy(it["gts"]).cuda(),
                    torch.from_numpy(it["lts"]).cuda() / scale_factor))
    return out


def stage2_adversarial(seed: int, card: str, roots: dict) -> dict:
    """(c) four micro-steps of the shipped config through Stage2Trainer with
    disc_start 0 (the CLI reaches the GAN branch only at step 501):
    d_weight finite and non-zero, the discriminator's parameters moved by
    the update and its statistics by every micro-step, the decoder's last
    conv (the adaptive weight's reference, frozen) unchanged."""
    import torch

    from mgldvsr_tpu_torch.cli import train as cli
    from mgldvsr_tpu_torch.train.stage2 import LAST_LAYER, Stage2Config, Stage2Trainer

    pipe = stage2_pipeline(stage2_args(roots, "unused", 4, seed))
    trainer = Stage2Trainer(pipe.vae, Stage2Config(learning_rate=TRAIN_LR, grad_accum=4,
                                                   disc_start=0))
    cli.seed_stage2_aux(trainer, seed)
    calm_spynet(trainer)
    state = trainer.init_state()
    last = dict(pipe.vae.named_parameters())[LAST_LAYER].detach().clone()
    disc0 = snapshot(state)["disc"]
    items = stage2_items(roots, 4, pipe.cfg.scale_factor)
    out = []
    for i, (lq, gt, lat) in enumerate(items):
        stats = {k: v.clone() for k, v in state.disc.items() if "running" in k}
        state, m = trainer.train_step(state, lq, gt, lat)
        m = {k: float(v) for k, v in m.items()}
        moved = all(not torch.equal(v, state.disc[k]) for k, v in stats.items())
        out.append((m, moved))
        if not (np.isfinite(m["d_weight"]) and m["d_weight"] > 0 and moved
                and all(np.isfinite(m[k]) for k in STAGE2_METRICS)):
            raise AssertionError(f"phase 9 (c): micro-step {i + 1}: {m}, statistics moved "
                                 f"{moved}")
    params_moved = sum(not torch.equal(v, state.disc[k]) for k, v in disc0.items()
                       if "running" not in k)
    n_params = sum("running" not in k for k in disc0)
    last_same = torch.equal(dict(pipe.vae.named_parameters())[LAST_LAYER], last)
    d_weight = [round(m_["d_weight"], 6) for m_, _ in out]
    loss_d = [round(m_["loss_d"], 4) for m_, _ in out]
    g_loss = [round(m_["g_loss"], 4) for m_, _ in out]
    log(f"[phase9] (c) disc_start 0, 4 micro-steps at grad_accum 4, full width: d_weight "
        f"{d_weight}, loss_d {loss_d}, g_loss {g_loss}; running statistics moved every "
        f"micro-step; {params_moved} of {n_params} discriminator parameters moved by the "
        f"update; the decoder's conv_out unchanged: {last_same}  [{card}]")
    if params_moved != n_params or not last_same:
        raise AssertionError("phase 9 (c): discriminator not updated or conv_out changed")
    del state, trainer, pipe, items
    torch.cuda.empty_cache()
    return {"d_weight": d_weight}


# phase 9 (e)'s limits (readings on an H100 in brackets, default / fused
# configuration). Kernels against their plain versions on the same inputs,
# about 3x the readings: the reconstruction's max |d| over its max |value|
# [7.63e-3 / 7.63e-3, two bf16 ulps]; the whole of the trainables'
# gradients over its norm [1.32e-3 / 1.64e-3]; conv_out's weight gradient
# over its norm [5.62e-4 / 7.80e-4]. Both against the plain versions in
# float32, the kernels' distance over the plain bf16 run's: the
# reconstruction [0.873 / 0.833], the whole gradient [1.015 / 0.990],
# conv_out's [1.002 / 1.004], and the kernels' worst leaf over either plain
# run's worst [1.114 / 0.666]. A leaf is held only so: a temporal blend
# scalar's gradient is the difference of two large bf16 sums, which bf16
# rounding alone moves by up to 1.05e-1 of its norm.
S2_DEC_RECON = 2.3e-2
S2_DEC_WHOLE = 5e-3
S2_DEC_LAST = 2.4e-3
S2_DEC_TO_F32 = 1.5


@contextlib.contextmanager
def plain_group_norms():
    """Bind the models' GroupNorm and GroupNorm->SiLU->conv calls to the
    kernels' plain versions, which run on the card as on the CPU, for the
    enclosed calls; restore the wrappers after."""
    from mgldvsr_tpu_torch.models import layers
    from mgldvsr_tpu_torch.ops.kernels import gn_silu_conv as conv_mod
    from mgldvsr_tpu_torch.ops.kernels import groupnorm as gn_mod

    plain = {"channel_sums": gn_mod.channel_sums_plain,
             "fused_group_norm": gn_mod.fused_group_norm_plain,
             "gn_silu_conv3x3": conv_mod.gn_silu_conv3x3_plain}
    before = {name: getattr(layers, name) for name in plain}
    for name, fn in plain.items():
        setattr(layers, name, fn)
    try:
        yield
    finally:
        for name, fn in before.items():
            setattr(layers, name, fn)


def decoder_grads(vae, z, enc, cot, names) -> tuple:
    """(reconstruction, {name: gradient}, launches, cotangent) of one
    decoder forward and backward with the cotangent ``cot``, or
    ``cot(reconstruction)`` when it is a function; gradients in float32."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels

    params = dict(vae.named_parameters())
    last = params[names[-1]]
    kernels.reset_launch_counts()
    last.requires_grad_(True)
    try:
        recon = vae.decode(z, enc, 1.0)
        if callable(cot):
            cot = cot(recon.detach())
        grads = torch.autograd.grad(recon, [params[k] for k in names], cot.to(recon.dtype))
    finally:
        last.requires_grad_(False)
    torch.cuda.synchronize()
    return (recon.detach().float(), {k: g.float() for k, g in zip(names, grads)},
            kernels.launch_counts(), cot)


def stage2_decoder(seed: int, card: str, roots: dict) -> dict:
    """(e) the shipped config's decoder forward and backward at full width
    (bf16, 5 frames of 512x512, from a loaded window's latents and LQ
    encoder features), in both configurations: the kernels (channel sums and
    their gradient on the 128^2-512^2 levels, the fused GroupNorm; or the
    chain's two kernels, conv_out on the mma.sync kernel at 3 output
    channels) against their plain versions on the card, on the same inputs,
    weights and a seeded cotangent, and both against the plain versions in
    float32: the reconstruction, every trainable's gradient and the gradient
    of conv_out's weight (the adaptive GAN weight's reference)."""
    import dataclasses

    import torch

    from mgldvsr_tpu_torch.models.vae import VideoAutoencoderKLResi
    from mgldvsr_tpu_torch.train.stage2 import (
        LAST_LAYER,
        Stage2Config,
        Stage2Trainer,
        partition_vae_params,
    )

    pipe = stage2_pipeline(stage2_args(roots, "unused", 1, seed))
    Stage2Trainer(pipe.vae, Stage2Config()).init_state()  # the bf16 VAE, trainables live
    vae = pipe.vae
    lq, gt, lat = stage2_items(roots, 1, pipe.cfg.scale_factor)[0]
    train, _ = partition_vae_params(vae)
    names = [*train, LAST_LAYER]
    z = lat.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        _, enc = vae.encode((lq * 2 - 1).permute(0, 3, 1, 2).contiguous())
    gt = (gt * 2 - 1).permute(0, 3, 1, 2)
    vae32 = VideoAutoencoderKLResi(dataclasses.replace(vae.cfg, dtype=torch.float32)).cuda()
    vae32.load_state_dict({k: v.float() for k, v in vae.state_dict().items()})
    for k, p in vae32.named_parameters():
        p.requires_grad_(k in train)
    # the cotangent of the pixel term |gt - recon| (summed) at the float32
    # reconstruction, held fixed for every run
    with plain_group_norms():
        r32, g32, _, cot = decoder_grads(vae32, z, [e.float() for e in enc],
                                         lambda r: torch.sign(r - gt), names)
    del vae32
    torch.cuda.empty_cache()
    runs = {}
    for fused in (False, True):
        for plain in (False, True):
            with fused_switch(fused), (plain_group_norms() if plain else contextlib.nullcontext()):
                runs[fused, plain] = decoder_grads(vae, z, enc, cot, names)[:3]

    def dist(g, want):
        """({leaf: |g - want| over its norm + 1e-3 of the largest}, whole,
        conv_out's weight gradient over its norm)."""
        leaf, whole = leaf_spread({k: g[k] for k in train}, {k: want[k] for k in train})
        last = float((g[LAST_LAYER] - want[LAST_LAYER]).norm() / want[LAST_LAYER].norm())
        return leaf, whole, last

    # the worst leaf of either plain bf16 run against float32
    plain_worst = max(max(dist(runs[f, True][1], g32)[0].values()) for f in (False, True))
    out = {}
    for fused in (False, True):
        (rk, gk, ck), (rp, gp, cp) = runs[fused, False], runs[fused, True]
        _, whole, last = dist(gk, gp)
        recon = max_err(rk, rp) / float(rp.abs().max())
        k32, p32 = dist(gk, g32), dist(gp, g32)
        worst = max(k32[0], key=k32[0].get)
        ratio = {"reconstruction": (max_err(rk, r32) / max(max_err(rp, r32), 1e-30)),
                 "whole": k32[1] / p32[1], "conv_out": k32[2] / p32[2],
                 "worst leaf": k32[0][worst] / plain_worst}
        mma = ck["gn_silu_conv3x3"] - ck["gn_silu_conv3x3_wgmma"]
        tag = "fused" if fused else "default"
        out[tag] = {"recon": recon, "whole": whole, "conv_out": last, "to_f32": ratio,
                    "leaf": (worst, k32[0][worst], plain_worst)}
        log(f"[phase9] (e) decoder forward + backward at full width (bf16, 5 x 512x512, the "
            f"pixel loss's cotangent), fused conv {'on' if fused else 'off'}: kernels against "
            f"their plain versions on the card, reconstruction max |d| {recon:.3e} of its max "
            f"(limit {S2_DEC_RECON:.1e}), the {len(train)} trainables' gradients whole "
            f"{whole:.3e} of the norm (limit {S2_DEC_WHOLE:.1e}), conv_out's weight gradient "
            f"{last:.3e} (limit {S2_DEC_LAST:.1e}). Against the plain versions in float32, "
            f"kernels over plain bf16: "
            f"{ {k: f'{v:.3f}' for k, v in ratio.items()} } (limit {S2_DEC_TO_F32:.2f} each; "
            f"the whole {k32[1]:.3e} / {p32[1]:.3e}, the worst leaf {worst} {k32[0][worst]:.3e} "
            f"/ either plain run's worst {plain_worst:.3e} of its norm); launches "
            f"{({n: c for n, c in ck.items() if c})}, of them on the mma.sync conv {mma}; the "
            f"plain runs' {({n: c for n, c in cp.items() if c})}  [{card}]")
        if (recon > S2_DEC_RECON or whole > S2_DEC_WHOLE or last > S2_DEC_LAST
                or max(ratio.values()) > S2_DEC_TO_F32):
            raise AssertionError(f"phase 9 (e): {tag}: kernels and plain versions disagree "
                                 f"{out[tag]}")
        every = ("gn_silu_conv3x3", "gn_scale_shift") if fused else ("channel_sums",
                                                                    "fused_group_norm")
        if any(ck[n] == 0 for n in every) or (fused and mma == 0) or any(cp.values()):
            raise AssertionError(f"phase 9 (e): {tag}: launches {ck}, plain run {cp}")
    del pipe, vae, enc, runs
    torch.cuda.empty_cache()
    return out


def kernel_device_ms(fn, where: str) -> float:
    """Device ms a call of ``fn``: the kernels' summed time in a
    torch.profiler trace of one warm call. Raises, naming ``where``, on a
    trace without kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mgldvsr_tpu_torch.utils.profiling import check_kernels, reattach_cupti

    fn()
    torch.cuda.synchronize()
    reattach_cupti()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    check_kernels(prof, where, launched=True)
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda) / 1000


def stage2_profile(seed: int, card: str, roots: dict, logdir: str) -> dict:
    """Where a full-width stage-2 micro-step's time goes (default
    configuration): a torch.profiler trace of kernels only over the CLI
    loop's micro-steps 2-5 (no save): device time a micro-step and the
    device's idle share of the traced wall (an upper bound: the profiler adds
    host time to each launch). Then on the same trainer and a loaded window,
    the device time of its parts, each traced alone: SpyNet and the
    occlusion masks, the LQ encode, the decoder forward and backward, LPIPS
    forward and backward, the discriminator (the generator's pass and the
    discriminator's step)."""
    import torch
    from torch.func import functional_call
    from torch.profiler import ProfilerActivity, profile

    from mgldvsr_tpu_torch.cli import train as cli
    from mgldvsr_tpu_torch.train.stage2 import partition_vae_params
    from mgldvsr_tpu_torch.utils.profiling import check_kernels, reattach_cupti

    args = stage2_args(roots, logdir, 5, seed, "--ckpt-every", "1000000")
    pipe = stage2_pipeline(args)
    held, marks = {}, {}
    prof = profile(activities=[ProfilerActivity.CUDA])

    def on_trainer(trainer):
        calm_spynet(trainer)
        held["trainer"] = trainer

    def on_step(step, state, metrics):
        if step in (1, 5):
            torch.cuda.synchronize()
            if step == 1:
                reattach_cupti()
                prof.start()
                marks["t0"] = time.perf_counter()
            else:
                marks["wall"] = (time.perf_counter() - marks["t0"]) * 1000 / 4
                prof.stop()
        held["state"] = state

    with part("phase9 (d) profile loop"):
        cli.stage2(args, pipe=pipe, on_step=on_step, on_trainer=on_trainer)
    check_kernels(prof, "phase 9: the trace of the CLI loop", launched=True)
    cuda = torch.autograd.DeviceType.CUDA
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == cuda) / 1000 / 4
    wall = marks["wall"]
    if device <= 0:
        raise AssertionError("phase 9: the profiler saw no device time")
    tr, state = held["trainer"], held["state"]
    lq, gt01, lat = stage2_items(roots, 1, pipe.cfg.scale_factor)[0]
    gt = (gt01 * 2 - 1).permute(0, 3, 1, 2)
    lqn = (lq * 2 - 1).permute(0, 3, 1, 2).contiguous()
    z = lat.permute(0, 3, 1, 2).contiguous()
    train, _ = partition_vae_params(tr.vae)
    with torch.no_grad():
        _, enc = tr.vae.encode(lqn)
        recon = tr.vae.decode(z, enc)

    def encode():
        with torch.no_grad():
            tr.vae.encode(lqn)

    def decode_fwd():
        with torch.no_grad():
            tr.vae.decode(z, enc)

    def decode_fwd_bwd():
        out = tr.vae.decode(z, enc)
        torch.autograd.grad(out, list(train.values()), torch.ones_like(out))

    def lpips():
        r = recon.detach().float().requires_grad_(True)
        torch.autograd.grad(tr.lpips(gt, r).sum(), r)

    def disc():
        r = recon.detach().requires_grad_(True)
        torch.autograd.grad(functional_call(tr.disc, dict(state.disc), (r,),
                                            {"train": False}).mean(), r)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in tr.disc_params(state.disc).items()}
        bufs = {k: v.clone() for k, v in state.disc.items() if k not in params}
        lr_ = functional_call(tr.disc, {**params, **bufs}, (gt,), {"train": True})
        lf_ = functional_call(tr.disc, {**params, **bufs}, (recon,), {"train": True})
        torch.autograd.grad(lr_.mean() - lf_.mean(), list(params.values()))

    def flows():
        tr.frozen_flows(gt01)

    parts = {"flows (SpyNet + occlusion)": flows, "LQ encode": encode,
             "decoder forward": decode_fwd, "decoder forward + backward": decode_fwd_bwd,
             "LPIPS forward + backward": lpips, "discriminator (both passes)": disc}
    part_ms = {name: kernel_device_ms(fn, f"phase 9: {name} traced alone")
               for name, fn in parts.items()}
    part_ms["decoder backward"] = (part_ms["decoder forward + backward"]
                                   - part_ms["decoder forward"])
    log(f"[phase9] the CLI loop under torch.profiler (kernels only, micro-steps 2-5, data "
        f"workers running, no save): {wall:.2f} ms of wall a micro-step, {device:.2f} ms of "
        f"device time, idle share {1 - device / wall:.4f}. Device time of the parts, each "
        f"traced alone on a loaded window: "
        f"{ {k: f'{v:.2f} ms ({100 * v / device:.1f}%)' for k, v in part_ms.items()} } "
        f"(shares of the micro-step's device time)  [{card}]")
    del held, state, tr, pipe, recon, enc
    torch.cuda.empty_cache()
    return {"wall_ms": wall, "device_ms": device, "idle_share": 1 - device / wall,
            "parts_ms": part_ms}


WARP_FLOWS = ("scattered", "smooth", "large")


def warp_flow(kind: str, n: int, h: int, w: int, gen):
    """[n,h,w,2] flows for kernel 1: ``scattered`` N(0,1) x 3 a pixel (a
    tile's taps span ~20 px), ``smooth`` a 16x16 field of N(0,1) x 3 pixels
    upsampled bilinearly (a few pixels, as a real flow between neighbouring
    frames), ``large`` N(0,1) x 40 a pixel (taps far apart)."""
    import torch
    import torch.nn.functional as F

    if kind == "smooth":
        coarse = torch.randn(n, 2, 16, 16, device="cuda", generator=gen) * 3
        return F.interpolate(coarse, size=(h, w), mode="bilinear",
                             align_corners=False).permute(0, 2, 3, 1).contiguous()
    return torch.randn(n, h, w, 2, device="cuda", generator=gen) * (40 if kind == "large" else 3)


def warp_alone(card: str, n: int, what: str, kind: str = "scattered") -> dict:
    """Kernel 1 alone on [n,512,512,3] f32 frames warped by a ``kind`` flow
    (``what`` names the caller: the swc loss's stack of n = 6, E*warp's T-1
    = 4, phase 2's n = 4 and 1 under each flow): equal to its plain version,
    against the library call (F.grid_sample, bilinear, zeros,
    align_corners=True, on the NCHW frames) and the bound (one read of x and
    the flow, one write; 4 taps of 2 flops and ~12 flops of weights per
    output element); host microseconds a call beside the library call's."""
    import torch
    import torch.nn.functional as F

    from mgldvsr_tpu_torch.ops.kernels.flow_warp import warp_forward, warp_plain

    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.rand(n, 512, 512, 3, device="cuda", generator=gen)
    flow = warp_flow(kind, n, 512, 512, gen)
    got, want = warp_forward(x, flow), warp_plain(x, flow)
    err = max_err(got, want)
    bound_ms, by = bound(nbytes(x, flow, x), 20 * x.numel(), "f32")
    gy, gx = torch.meshgrid(torch.arange(512.0, device="cuda"),
                            torch.arange(512.0, device="cuda"), indexing="ij")
    grid = torch.stack([(gx + flow[..., 0]) * (2 / 511) - 1, (gy + flow[..., 1]) * (2 / 511) - 1],
                       -1)
    xn = x.permute(0, 3, 1, 2).contiguous()

    def sample():
        return F.grid_sample(xn, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    out = {"max_abs_err": err, "ms": cuda_ms(lambda: warp_forward(x, flow)),
           "plain_ms": cuda_ms(lambda: warp_plain(x, flow)), "bound_ms": bound_ms, "bound_by": by,
           "library_ms": cuda_ms(sample), "device_ms": graph_ms(lambda: warp_forward(x, flow)),
           "host_us": host_us(lambda: warp_forward(x, flow)), "library_host_us": host_us(sample)}
    log(f"[{what}] warp_forward alone at x[{n},512,512,3] f32, {kind} flow: max_abs_err "
        f"{err:.3e} (limit 0: bit for bit) against the plain version; {out['ms']:.4f} ms (device "
        f"{out['device_ms']:.4f}, host {out['host_us']:.1f} us a call), plain "
        f"{out['plain_ms']:.4f}, F.grid_sample {out['library_ms']:.4f} (host "
        f"{out['library_host_us']:.1f} us), bound {bound_ms:.4f} ms ({by})  [{card}]")
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: warp_forward at [{n},512,512,3], {kind} flow, differs from "
                             f"its plain version ({err:.3e})")
    return out


def phase9(seed: int, card: str, keep: dict | None = None) -> dict:
    """``keep``: where (b)'s straight run is kept (in host memory) for phase
    12 to hold its ranks against."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # phase 12 trains on the same data: it lives in keep's directory
        with part("phase9 data"):
            roots = stage2_data(os.path.join(keep["dir"], "s2") if keep else tmp, seed)
        with part("phase9 (b)"):
            straight, out["default"], seen = stage2_full(seed, card, roots,
                                                         os.path.join(tmp, "b"), 8, fused=False,
                                                         snapshot_at=4)
        if keep is not None:
            keep["stage2"] = {"final": to_host(straight), "roots": roots, **seen}
        with part("phase9 (b) resume"):
            out["resume"] = stage2_resume(seed, card, roots, os.path.join(tmp, "b"), straight)
        del straight
        shutil.rmtree(os.path.join(tmp, "b"))
        shutil.rmtree(os.path.join(tmp, "b_resumed"))
        with part("phase9 (c)"):
            out["adversarial"] = stage2_adversarial(seed, card, roots)
        with part("phase9 (e)"):
            out["decoder"] = stage2_decoder(seed, card, roots)
        with part("phase9 (d)"):
            _, out["fused"], _ = stage2_full(seed, card, roots, os.path.join(tmp, "d"), 4,
                                             fused=True)
        with part("phase9 (d) profile"):
            out["profile"] = stage2_profile(seed, card, roots, os.path.join(tmp, "p"))
    out["warp"] = warp_alone(card, 6, "phase9")
    with part("phase9 (a)"):
        out["tiny"] = {f: phase9_tiny(seed, card, f) for f in (False, True)}
    out["wall_s"] = time.perf_counter() - t0
    return out


# -- phase 10: the quality harness --------------------------------------------

# the harness's keys; the host numpy ones must come out of the tool bit for
# bit, the card's (and FID, on the card's features) within 1e-5 relative
# (b) the tool's row against (a)'s (its run leaves out NIQE and FID): bit for
# bit where the host computes, within TOOL_LIMIT where the card does
HOST_KEYS = ("psnr", "ssim", "l1_vs_other", "max_vs_other")
CARD_KEYS = ("lpips", "ewarp")
# the Inception features on the card against the CPU, of the largest |feature|
# (float32, TF32 off); E*warp with the kernels against their plain versions
INCEPTION_LIMIT = 1e-4
EWARP_LIMIT = 1e-5
TOOL_LIMIT = 1e-5


def to_uint8(frames) -> np.ndarray:
    """[T, H, W, 3] frames in [0, 1] on the card -> uint8, as a user's PNGs."""
    import torch

    return (frames.float().clamp(0, 1) * 255).round().to("cpu", torch.uint8).numpy()


@contextlib.contextmanager
def plain_flow_kernels():
    """Bind E*warp's warp and RAFT's window lookup to the kernels' plain
    versions for the enclosed calls; restore the wrappers after."""
    from mgldvsr_tpu_torch.flow import raft
    from mgldvsr_tpu_torch.metrics import temporal
    from mgldvsr_tpu_torch.ops.kernels.corr_lookup import lookup_corr_plain
    from mgldvsr_tpu_torch.ops.kernels.flow_warp import warp_plain

    before = temporal.warp_forward, raft.lookup_corr
    temporal.warp_forward, raft.lookup_corr = warp_plain, lookup_corr_plain
    try:
        yield
    finally:
        temporal.warp_forward, raft.lookup_corr = before


def quality_metrics(clips: dict, nets: dict, niqe_npz: str, dev) -> tuple[dict, dict]:
    """The harness's eight keys of one clip, with the tool's own functions on
    the frames as the tool loads them ([T, H, W, 3] float32 in [0, 255]):
    (row, seconds of each metric, the card synchronised around each); FID's
    features and distance apart (``fid_features``, ``fid_distance``)."""
    import torch

    from mgldvsr_tpu_torch.metrics.image import calculate_psnr, calculate_ssim
    from mgldvsr_tpu_torch.tools import quality_eval as qe

    ours, gt, other = clips["ours"], clips["gt"], clips["other"]
    steps = {
        "psnr": lambda: float(np.mean([calculate_psnr(o, g, 0, test_y_channel=True)
                                       for o, g in zip(ours, gt)])),
        "ssim": lambda: float(np.mean([calculate_ssim(o, g, 0, test_y_channel=True)
                                       for o, g in zip(ours, gt)])),
        "lpips": lambda: qe.lpips_score(nets["lpips"], ours / 255.0, gt / 255.0, dev),
        "niqe": lambda: qe.niqe_score(ours, niqe_npz),
        "ewarp": lambda: qe.ewarp_score(nets["raft"], ours / 255.0, dev),
        "l1_vs_other": lambda: float(np.mean(np.abs(ours - other))),
        "max_vs_other": lambda: float(np.max(np.abs(ours - other))),
        "fid_features": lambda: (qe.fid_features(nets["inception"], ours / 255.0, dev),
                                 qe.fid_features(nets["inception"], gt / 255.0, dev)),
    }
    row, secs = {}, {}
    for name, fn in steps.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row[name] = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    return row, secs


def quality_tool(tmp: str, clips: dict, nets: dict):
    """Write the clips as PNGs and LPIPS and RAFT as torch files, and start
    ``python -m mgldvsr_tpu_torch.tools.quality_eval`` on them on the card
    (without FID and NIQE, which (a) computes). Returns the running
    process."""
    import torch

    from mgldvsr_tpu_torch.io.frames import write_frame

    dirs = {k: os.path.join(tmp, k) for k in clips}
    for k, frames in clips.items():
        os.makedirs(os.path.join(dirs[k], "000"))
        for t, f in enumerate(frames):
            write_frame(os.path.join(dirs[k], "000", f"{t:08d}.png"), f.astype(np.uint8))
    ckpt = {k: os.path.join(tmp, f"{k}.pth") for k in ("lpips", "raft")}
    for k, path in ckpt.items():
        torch.save({n: v.detach().cpu() for n, v in nets[k].state_dict().items()}, path)
    # FID and NIQE are left to (a): the tool's run repeated them (about 30 s)
    cmd = [sys.executable, "-m", "mgldvsr_tpu_torch.tools.quality_eval",
           "--restored", dirs["ours"], "--gt", dirs["gt"], "--other", dirs["other"],
           "--lpips-ckpt", ckpt["lpips"], "--raft-ckpt", ckpt["raft"], "--device", "cuda"]
    return subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc, what: str, timeout: float = 600) -> list:
    """The JSON lines a started process printed; raises when it failed."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"phase 10: {what} exited {proc.returncode}:\n{out[-3000:]}\n"
                             f"{err[-3000:]}")
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def phase10(pipe, frames, out4, out5, card: str) -> dict:
    """The quality harness at full width on phase 4's clip: (a) in process,
    (b) through the tool, (c) the tiny smoke."""
    import copy
    import tempfile

    import torch

    from mgldvsr_tpu_torch.metrics.fid import calculate_activation_statistics, calculate_fid
    from mgldvsr_tpu_torch.metrics.niqe import fit_niqe_params
    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.tools import quality_eval as qe
    from mgldvsr_tpu_torch.tools.quality_smoke import gray255

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    u8 = {"ours": to_uint8(out4), "gt": to_uint8(frames), "other": to_uint8(out5)}
    clips = {k: v.astype(np.float32) for k, v in u8.items()}
    n = len(clips["ours"])
    nets = {"raft": pipe.raft, "lpips": qe.build_lpips("random", dev),
            "inception": qe.build_inception("random", dev)}
    with tempfile.TemporaryDirectory() as tmp:
        niqe_npz = os.path.join(tmp, "niqe.npz")
        with part("phase10 NIQE fit"):
            fit_niqe_params([gray255(f) for f in u8["gt"]], out_path=niqe_npz)

        # (a) cold: the launches of the whole row; then warm, timed
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with part("phase10 (a) cold"):
            row, _ = quality_metrics(clips, nets, niqe_npz, dev)
        counts = kernels.launch_counts()
        with part("phase10 (a) warm"):
            _, secs = quality_metrics(clips, nets, niqe_npz, dev)
        peak = torch.cuda.max_memory_allocated()
        feats_ours, feats_gt = row.pop("fid_features")
        t0 = time.perf_counter()
        row["fid_vs_against"] = calculate_fid(*calculate_activation_statistics(feats_ours),
                                              *calculate_activation_statistics(feats_gt))
        secs["fid_distance"] = time.perf_counter() - t0
        want = {name: (1 if name == "warp_forward" else 10 if name == "corr_lookup" else 0)
                for name in KERNELS}
        if any(counts[name] != want[name] for name in KERNELS):
            raise AssertionError(f"phase 10 (a): launches {counts}, expected {want}")
        if not all(np.isfinite(v) for v in row.values()) or row["ewarp"] <= 0:
            raise AssertionError(f"phase 10 (a): {row}")
        ms = {k: 1000 * v / n for k, v in secs.items()}
        log(f"[phase10] (a) 512x512, {n} frames, every metric on the card's frames as uint8: "
            f"{ {k: float(v) for k, v in row.items()} }; ms a frame (warm, synchronised; "
            f"FID's features of both populations and its host distance apart): "
            f"{ {k: round(v, 3) for k, v in ms.items()} }; peak {peak / 2**30:.3f} GiB; "
            f"launches {counts}  [{card}]")

        # (b) and (c) run beside the rest of (a)'s checks
        t_tools = time.perf_counter()
        tool = quality_tool(tmp, u8, nets)
        smoke = subprocess.Popen(
            [sys.executable, "-m", "mgldvsr_tpu_torch.tools.quality_smoke", "--preset", "tiny",
             "--device", "cuda", "--clips", "1", "--frames", "3"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            # the card's Inception features against the CPU's
            with part("phase10 (a) CPU Inception"):
                cpu_model = copy.deepcopy(nets["inception"]).cpu()
                with torch.no_grad():
                    cpu_feats = cpu_model(torch.from_numpy(clips["ours"] / 255.0) * 2
                                          - 1).numpy()
            inc_err = float(np.abs(feats_ours - cpu_feats).max() / np.abs(cpu_feats).max())
            # E*warp with the kernels against their plain versions, on the card
            with plain_flow_kernels():
                kernels.reset_launch_counts()
                plain = qe.ewarp_score(nets["raft"], clips["ours"] / 255.0, dev)
                plain_counts = kernels.launch_counts()
            ewarp_err = abs(row["ewarp"] - plain) / abs(plain)
            log(f"[phase10] (a) Inception features card against CPU {inc_err:.3e} of the "
                f"largest |feature| (limit {INCEPTION_LIMIT}); E*warp kernels {row['ewarp']!r} "
                f"against plain {plain!r}: {ewarp_err:.3e} relative (limit {EWARP_LIMIT})")
            if inc_err > INCEPTION_LIMIT or ewarp_err > EWARP_LIMIT or any(plain_counts.values()):
                raise AssertionError(f"phase 10 (a): Inception {inc_err:.3e}, E*warp "
                                     f"{ewarp_err:.3e}, plain launches {plain_counts}")
            with part("phase10 (b), (c) waited for"):
                rows = finish(tool, "quality_eval")
                PARTS["phase10 (b) done after"] = time.perf_counter() - t_tools
                lines = finish(smoke, "quality_smoke")
                PARTS["phase10 (c) done after"] = time.perf_counter() - t_tools
        finally:
            for proc in (tool, smoke):
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()

    # (b) the tool's row against (a)
    got = rows[0]
    diff = {k: (got.get(k), row[k]) for k in HOST_KEYS if got.get(k) != row[k]}
    rel = {k: abs(got[k] - row[k]) / max(abs(row[k]), 1e-30) for k in CARD_KEYS}
    log(f"[phase10] (b) quality_eval on the PNGs and the saved networks: {rows[0]}; relative "
        f"to (a) {rel}  [{card}]")
    if diff or any(v > TOOL_LIMIT for v in rel.values()) or rows[0]["tf32"] is not False:
        raise AssertionError(f"phase 10 (b): the tool's row differs from (a): {diff} {rel}")
    # (c) the tiny smoke
    summary = lines[-1]
    log(f"[phase10] (c) quality_smoke --preset tiny on the card: {summary}")
    if not summary.get("ok"):
        raise AssertionError(f"phase 10 (c): {summary}")
    warp = warp_alone(card, n - 1, "phase10")
    wall = time.perf_counter() - t_start
    return {"row": row, "ms_a_frame": ms, "peak_bytes": peak, "counts": counts,
            "inception_err": inc_err, "ewarp_err": ewarp_err, "tool_rel": rel,
            "smoke": summary, "warp": warp, "wall_s": wall}


# -- phase 11: the multi-device restore ---------------------------------------

WINDOW_PARALLEL_STEPS = 10  # phase 11 (a) and (b) at full width


class background:
    """A command started in the background, its output sent to files beside
    ``stem``; ``wait(timeout)`` -> (return code, stdout, stderr); ``ended``
    the ``time.perf_counter()`` at which it exited. As a context manager it
    kills the command if the block leaves early."""

    def __init__(self, cmd, cwd: str, env: dict, stem: str):
        import threading

        self.paths = (stem + ".out", stem + ".err")
        self.ended = None
        with open(self.paths[0], "w") as out, open(self.paths[1], "w") as err:
            self.proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=out, stderr=err,
                                         text=True)
        threading.Thread(target=self._reap, daemon=True).start()

    def _reap(self):
        self.proc.wait()
        self.ended = time.perf_counter()

    def wait(self, timeout: float):
        code = self.proc.wait(timeout=timeout)
        texts = []
        for path in self.paths:
            with open(path) as f:
                texts.append(f.read())
        return (code, *texts)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


@contextlib.contextmanager
def rank_env(rank: int = 0, world: int = 1):
    """``torchrun``'s rank variables for the enclosed block, then as they were."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase11_world_of_one(pipe, frames, card: str) -> dict:
    """(a) a world of one NCCL rank on cuda:0 from a file:// store: the
    window-parallel restore of one window equals ``restore_segment``."""
    import datetime
    import tempfile

    import torch

    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.parallel import mesh
    from mgldvsr_tpu_torch.parallel.sharded_sampler import exchange_first

    steps = WINDOW_PARALLEL_STEPS
    with tempfile.TemporaryDirectory() as tmp, rank_env(), sampler_steps(pipe, steps):
        want_stages: dict = {}
        kernels.reset_launch_counts()
        want = pipe.restore_segment(frames, deterministic=True, stage_seconds=want_stages)
        torch.cuda.synchronize()
        want_counts = kernels.launch_counts()
        device = mesh.init_group("cuda", f"file://{tmp}/store",
                                 timeout=datetime.timedelta(minutes=5))
        try:
            backend = torch.distributed.get_backend()
            nb, has_right = exchange_first(torch.ones(1, 64, 64, 4, device=device))
            mesh.barrier()
            stages: dict = {}
            kernels.reset_launch_counts()
            got = pipe.restore_windows_sharded(frames, deterministic=True, stage_seconds=stages)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        finally:
            mesh.destroy()
        witness = pipe.restore_segment(frames, deterministic=True)
    equal, err = torch.equal(got, want), max_err(got, want)
    spread = max_err(witness, want)
    log(f"[phase11] (a) NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, backend "
        f"{backend}, a world of one rank on {device}: the exchange received "
        f"{'nothing' if not has_right and not nb.any() else 'something'} (has_right "
        f"{has_right}); restore_windows_sharded of one 512x512 window, {steps} steps, "
        f"deterministic: equal to restore_segment {equal} (max_abs_err {err:.3e}; "
        f"restore_segment against itself {spread:.3e}); sampler "
        f"{1000 * stages['sampler'] / steps:.2f} ms/step against "
        f"{1000 * want_stages['sampler'] / steps:.2f}  [{card}]")
    if has_right or nb.any():
        raise AssertionError("phase 11 (a): the last rank received a neighbour's frame")
    if counts != want_counts:
        raise AssertionError(f"phase 11 (a): launches {counts} against restore_segment's "
                             f"{want_counts}")
    if not equal:
        raise AssertionError(f"phase 11 (a): restore_windows_sharded differs from "
                             f"restore_segment by {err:.3e}")
    return dict(counts=counts, sampler_ms=1000 * stages["sampler"] / steps)


def phase11_lockstep(pipe, card: str, seed: int) -> dict:
    """(b) two windows in lockstep at full width on the card."""
    import torch

    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
    from mgldvsr_tpu_torch.parallel import sharded_sampler as ss
    from mgldvsr_tpu_torch.tools.multicard_check import lockstep

    steps = WINDOW_PARALLEL_STEPS
    frames = upscale_frames(torch.from_numpy(lq_clip(seed + 21, 128, frames=10)).cuda(), 4)
    with sampler_steps(pipe, steps):
        runs = {w: lockstep(pipe, frames, w) for w in (0.0, 1.0)}
        seg_stages = [{}, {}, {}, {}]
        alone = [pipe.restore_segment(frames[5 * w:5 * w + 5], deterministic=True,
                                      stage_seconds=seg_stages[w]) for w in (0, 1)]
        # in turns for the times: pair, segments (above), pair, segments
        again = lockstep(pipe, frames, 1.0)
        for w in (0, 1):
            pipe.restore_segment(frames[5 * w:5 * w + 5], deterministic=True,
                                 stage_seconds=seg_stages[2 + w])
        torch.cuda.synchronize()
    last, nb, bflow, bocc = runs[1.0]["boundary"]
    got = ss.boundary_grad(last, nb, bflow, bocc)
    leaf = last.detach().clone().requires_grad_(True)
    ss.boundary_loss_plain(leaf, nb, bflow, bocc).backward()
    g_err, g_max = max_err(got, leaf.grad), float(leaf.grad.abs().max())
    unoccluded = float(1 - bocc.mean())
    same0 = [torch.equal(runs[0.0]["outs"][w], alone[w]) for w in (0, 1)]
    moved = [max_err(runs[1.0]["outs"][w], runs[0.0]["outs"][w]) for w in (0, 1)]
    counts = runs[1.0]["counts"]
    same = all(torch.equal(a, b) for a, b in zip(again["outs"], runs[1.0]["outs"]))
    pair_ms = [1000 * r["sampler_s"] / steps for r in (runs[1.0], again)]
    seg_ms = [1000 * (a["sampler"] + b["sampler"]) / steps
              for a, b in (seg_stages[:2], seg_stages[2:])]
    log(f"[phase11] (b) two 512x512 windows in lockstep, {steps} steps, deterministic: "
        f"boundary_grad against autograd of boundary_loss_plain max_abs_err {g_err:.3e} (limit "
        f"1e-6 of max |grad| {g_max:.3e}), {unoccluded:.3f} of the boundary unoccluded; at "
        f"weight 0 each window equals its restore_segment {same0}; weight 1 against 0: window 0 "
        f"{moved[0]:.3e}, window 1 {moved[1]:.3e}; warp_forward launches (window 0, window 1) "
        f"{[c['warp_forward'] for c in counts]}; weight 1 again the same bit for bit {same}; "
        f"the pair's sampler, in turns with two restore_segment calls' (weight 1): "
        f"{pair_ms[0]:.2f} / {seg_ms[0]:.2f} / {pair_ms[1]:.2f} / {seg_ms[1]:.2f} ms/step "
        f"({1000 * runs[0.0]['sampler_s'] / steps:.2f} at weight 0, the first)  [{card}]")
    log(f"[phase11] (b) launches of window 0 (a rank with a right neighbour): "
        f"{ {k: n for k, n in counts[0].items() if n} }  [{card}]")
    if not (g_err <= 1e-6 * g_max and g_max > 0):
        raise AssertionError(f"phase 11 (b): boundary_grad {g_err:.3e} from autograd")
    if not all(same0):
        raise AssertionError(f"phase 11 (b): at weight 0 the windows differ from "
                             f"restore_segment: {same0}")
    if not same:
        raise AssertionError("phase 11 (b): the lockstep at weight 1 differs from itself")
    if not (moved[0] > 0 and moved[1] == 0):
        raise AssertionError(f"phase 11 (b): the boundary term moved the windows by {moved}")
    if [c["warp_forward"] for c in counts] != [steps, 0]:
        raise AssertionError(f"phase 11 (b): warp_forward launches "
                             f"{[c['warp_forward'] for c in counts]}, expected [{steps}, 0]")
    for name in KERNELS:
        if (counts[0][name] == 0) != (name in FUSED_ONLY + INT8_ONLY + ("warp_dx",)):
            raise AssertionError(f"phase 11 (b): kernel {name} was launched {counts[0][name]} "
                                 f"times by window 0")
    if not (counts[0]["guidance_residual"] == counts[0]["guidance_scatter"] == steps
            and counts[0]["corr_lookup"] == 2 * pipe.cfg.raft.iters):
        raise AssertionError(f"phase 11 (b): window 0's launches {counts[0]}")
    return dict(counts=counts[0], pair_ms=pair_ms, segments_ms=seg_ms)


def phase11_tiny(seed: int, card: str) -> float:
    """(c) the lockstep at phase 3's tiny configuration, card against CPU."""
    import torch

    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
    from mgldvsr_tpu_torch.tools.multicard_check import lockstep

    cpu, gpu = tiny_pipelines(seed)
    frames = upscale_frames(torch.from_numpy(lq_clip(seed + 22, 64, frames=10)), 4)
    want = lockstep(cpu, frames, 1.0)
    got = lockstep(gpu, frames.cuda(), 1.0)
    err = max(max_err(g.cpu(), w) for g, w in zip(got["outs"], want["outs"]))
    moved = max_err(got["outs"][0], gpu.restore_segment(frames[:5].cuda(), deterministic=True))
    log(f"[phase11] (c) tiny 256x256 fp32 {cpu.cfg.ddpm_steps} steps, two windows in lockstep "
        f"at weight 1: card vs CPU max_abs_err {err:.3e} (limit 1e-3); the boundary term moved "
        f"window 0 by {moved:.3e} on the card; warp_forward launches "
        f"{[c['warp_forward'] for c in got['counts']]}  [{card}]")
    if not err <= 1e-3 or not moved > 0:
        raise AssertionError(f"phase 11 (c): card vs CPU {err:.3e}, moved {moved:.3e}")
    if [c["warp_forward"] for c in got["counts"]] != [cpu.cfg.ddpm_steps, 0]:
        raise AssertionError(f"phase 11 (c): warp_forward launches {got['counts']}")
    return err


def phase11_cli(card: str) -> None:
    """(d) the inference command line under torchrun with one rank:
    ``--window-parallel`` (fixed mode) and ``--patch-parallel`` (tile mode)
    write the frames of the same command without them."""
    import tempfile

    from mgldvsr_tpu_torch.cli import infer as cli
    from mgldvsr_tpu_torch.io.frames import read_frame, write_frame

    clip = (lq_clip(11, 32, frames=7, width=48) * 255).round().astype(np.uint8)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = repo
    with tempfile.TemporaryDirectory() as tmp:
        lq = os.path.join(tmp, "lq")
        os.makedirs(os.path.join(lq, "clip0"))
        for i, frame in enumerate(clip):
            write_frame(os.path.join(lq, "clip0", f"{i:08d}.png"), frame)
        # both torchrun commands start at once and run beside the two
        # commands without them, which run in this process
        modes = (("fixed", "--window-parallel"), ("tile", "--patch-parallel"))
        argvs = {mode: ["--seqs-path", lq, "--preset", "tiny", "--mode", mode, "--ddpm-steps",
                        "2", "--seed", "1"] for mode, _ in modes}
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            procs = {mode: stack.enter_context(background(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node=1", "-m", "mgldvsr_tpu_torch.cli.infer", *argvs[mode], flag,
                 "--out-path", os.path.join(tmp, mode + "_ranked")], repo, env,
                os.path.join(tmp, mode + "_log"))) for mode, flag in modes}
            for mode, _ in modes:
                cli.main([*argvs[mode], "--out-path", os.path.join(tmp, mode)])
            outs = {mode: proc.wait(300) for mode, proc in procs.items()}
        wall = time.perf_counter() - t0
        for mode, flag in modes:
            ranked, alone = os.path.join(tmp, mode + "_ranked"), os.path.join(tmp, mode)
            returncode, stdout, stderr = outs[mode]
            if returncode:
                raise AssertionError(f"phase 11 (d) {mode}: torchrun exited {returncode}:\n"
                                     f"{stdout[-2000:]}\n{stderr[-3000:]}")
            names = sorted(os.listdir(os.path.join(alone, "clip0")))
            diff = [int(np.abs(read_frame(os.path.join(ranked, "clip0", n)).astype(int)
                               - read_frame(os.path.join(alone, "clip0", n))).max())
                    for n in names]
            log(f"[phase11] (d) torchrun --nproc_per_node=1 cli.infer --mode {mode} {flag}: "
                f"{len(names)} frames, max |difference| to the run without it {max(diff)} "
                f"(limit 0); {wall:.2f} s for both commands with torchrun and both without "
                f"[{card}]")
            if names != [f"{i:08d}.png" for i in range(7)] or max(diff):
                raise AssertionError(f"phase 11 (d) {mode}: frames {names}, differences {diff}")
            if "rank 0 of 1" not in stdout:
                raise AssertionError(f"phase 11 (d) {mode}: no process group:\n{stdout}")


def phase11(pipe, frames, seed: int, card: str) -> dict:
    """The multi-device restore on one card: (a) a world of one NCCL rank,
    (b) two windows in lockstep at full width, (c) the same at tiny widths
    against the CPU, (d) the command line under torchrun."""
    with part("phase11 (a)"):
        one = phase11_world_of_one(pipe, frames, card)
    with part("phase11 (b)"):
        pair = phase11_lockstep(pipe, card, seed)
    with part("phase11 (c)"):
        phase11_tiny(seed, card)
    with part("phase11 (d)"):
        phase11_cli(card)
    return dict(counts=pair["counts"], world_of_one=one, pair_ms=pair["pair_ms"],
                segments_ms=pair["segments_ms"])


# -- phase 12: training over ranks on one card --------------------------------


def same_trees(got: dict, want: dict) -> tuple:
    """(tensors equal bit for bit, tensors, max |difference|) of two trees
    of tensors with the same keys (``want`` in host memory)."""
    import torch

    identical = total = 0
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            i, t, m = same_trees(g, w)
            identical, total, worst = identical + i, total + t, max(worst, m)
        elif isinstance(w, torch.Tensor):
            g = g.detach().cpu()
            total += 1
            identical += torch.equal(g, w)
            worst = max(worst, max_err(g, w))
    return identical, total, worst


@contextlib.contextmanager
def world_of_one(tmp: str):
    """A world of one NCCL rank on cuda:0 from a file:// store, for the
    enclosed block."""
    import datetime

    from mgldvsr_tpu_torch.parallel import mesh

    with rank_env():
        mesh.init_group("cuda", f"file://{tmp}/store", timeout=datetime.timedelta(minutes=10))
        try:
            yield
        finally:
            mesh.destroy()


def phase12_stage1(seed: int, card: str, ref: dict, zero1: bool) -> dict:
    """(a) phase 8 (b)'s full-width CLI loop (the same data) with ``--mesh``
    or ``--mesh --zero1`` for its first 4 micro-steps (one update): the
    masters, moments, accumulator, EMA, the metrics.jsonl losses and every
    micro-step's launches equal phase 8's straight run after micro-step 4."""
    import tempfile

    extra = ("--mesh", "--zero1") if zero1 else ("--mesh",)
    steps = 4
    ref = ref["at"]
    with tempfile.TemporaryDirectory() as tmp:
        data_root = os.path.join(tmp, "gt")
        train_clips(data_root, seed)
        with world_of_one(tmp):
            final, stats, seen = train_full(seed, card, data_root, os.path.join(tmp, "b"), steps,
                                            extra=extra, phase="[phase12] (a)")
    identical, total, worst = same_trees(final, ref["final"])
    same_losses = seen["losses"] == ref["losses"]
    same_counts = seen["counts"] == ref["counts"]
    log(f"[phase12] (a) {' '.join(extra)} in a world of one NCCL rank against phase 8 (b)'s "
        f"straight run at micro-step {steps}: {identical} of {total} tensors "
        f"bit for bit (masters, EMA, both moments, "
        f"the accumulator; max |d| {worst:.3e}); metrics.jsonl losses equal {same_losses}; "
        f"launches of every micro-step equal {same_counts}; peak "
        f"{stats['peak_bytes'] / 2**30:.2f} GiB; {stats['clips_per_s']:.4f} clips/s  [{card}]")
    if identical != total or not same_losses or not same_counts:
        raise AssertionError(f"phase 12 (a) {extra}: {total - identical} of {total} tensors "
                             f"differ (max {worst:.3e}), losses {seen['losses']} against "
                             f"{ref['losses']}, launches equal {same_counts}")
    return {"launches": stats["launches"], "peak_bytes": stats["peak_bytes"],
            "clips_per_s": stats["clips_per_s"]}


def phase12_stage2(seed: int, card: str, ref: dict) -> dict:
    """(b) phase 9 (b)'s CLI loop with ``--mesh`` in a world of one NCCL
    rank for its first 4 micro-steps (one update): the whole state, the
    metrics.jsonl losses and the launches equal phase 9's straight run after
    micro-step 4."""
    import tempfile

    roots, ref = ref["roots"], ref["at"]
    with tempfile.TemporaryDirectory() as tmp:
        with world_of_one(tmp):
            final, stats, seen = stage2_full(seed, card, roots, os.path.join(tmp, "b"), 4,
                                             fused=False, extra=("--mesh",),
                                             phase="[phase12] (b)")
    identical, total, worst = same_trees(final, ref["final"])
    same_losses = seen["losses"] == ref["losses"]
    same_counts = seen["counts"] == ref["counts"]
    log(f"[phase12] (b) stage 2 --mesh in a world of one NCCL rank against phase 9 (b)'s "
        f"straight run at micro-step 4: {identical} of {total} tensors "
        f"bit for bit (trainables, logvar, the "
        f"discriminator and its running statistics, both Adam states; max |d| {worst:.3e}); "
        f"metrics.jsonl metrics equal {same_losses}; launches equal {same_counts}  [{card}]")
    if identical != total or not same_losses or not same_counts:
        raise AssertionError(f"phase 12 (b): {total - identical} of {total} tensors differ "
                             f"(max {worst:.3e}), metrics equal {same_losses}, launches equal "
                             f"{same_counts}")
    return {"launches": stats["launches"]}


def phase12_cli(card: str) -> dict:
    """(c) ``torchrun --standalone --nproc_per_node=1 -m
    mgldvsr_tpu_torch.cli.train --tiny --mesh --zero1 --tensor-parallel 1``
    for 4 micro-steps: the metrics.jsonl losses and the step-4 checkpoint of
    the command without the flags; then the command without them resumes
    the ranked run's step-2 checkpoint and writes the same step-4
    checkpoint. ``--tensor-parallel 2`` in a world of one NCCL rank (in
    this process) degrades to 1 x 1, prints the mesh line and writes the
    same again."""
    import io
    import shutil
    import tempfile

    import torch

    from mgldvsr_tpu_torch.cli import train as cli
    from mgldvsr_tpu_torch.io.checkpoint import CheckpointManager

    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = repo
    keys = ("loss", "loss_simple", "loss_vlb", "grad_norm")
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "tiny_gt")
        train_clips(root, 40, clips=2, frames=6, size=48)
        base = ["--stage", "1", "--data-root", root, "--tiny", "--max-steps", "4",
                "--grad-accum", "2", "--ckpt-every", "2", "--log-every", "1", "--no-tb"]
        runs = {name: os.path.join(tmp, name)
                for name in ("plain", "ranked", "resumed", "degraded")}
        mesh_line = "mesh {'data': 1, 'tensor': 1} over 1 devices, host 0/1"
        # the torchrun command runs beside the plain and the degraded runs,
        # which run in this process
        t0 = time.perf_counter()
        with background(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node=1", "-m", "mgldvsr_tpu_torch.cli.train", *base, "--logdir",
                 runs["ranked"], "--mesh", "--zero1", "--tensor-parallel", "1"], repo, env,
                os.path.join(tmp, "ranked_log")) as proc:
            cli.main([*base, "--logdir", runs["plain"]])
            printed = io.StringIO()
            with world_of_one(tmp), contextlib.redirect_stdout(printed):
                cli.stage1(cli.parse_args([*base, "--logdir", runs["degraded"], "--mesh",
                                           "--zero1", "--tensor-parallel", "2"]))
            returncode, stdout, stderr = proc.wait(600)
        wall = time.perf_counter() - t0
        if returncode or "rank 0 of 1" not in stdout or mesh_line not in stdout:
            raise AssertionError(f"phase 12 (c): torchrun exited {returncode}:\n"
                                 f"{stdout[-2000:]}\n{stderr[-3000:]}")
        if mesh_line not in printed.getvalue():
            raise AssertionError(f"phase 12 (c) --tensor-parallel 2: no mesh line in\n"
                                 f"{printed.getvalue()[-2000:]}")
        os.makedirs(os.path.join(runs["resumed"], "ckpt"))
        shutil.copytree(os.path.join(runs["ranked"], "ckpt", "2"),
                        os.path.join(runs["resumed"], "ckpt", "2"))
        cli.main([*base, "--logdir", runs["resumed"], "--resume"])
        logged = {name: [{k: json.loads(line)[k] for k in keys}
                         for line in open(os.path.join(d, "metrics.jsonl"))]
                  for name, d in runs.items()}
        states = {name: CheckpointManager(os.path.join(d, "ckpt")).restore(4)
                  for name, d in runs.items()}
    checks = {}
    for name in ("ranked", "resumed", "degraded"):
        got, want = states[name], states["plain"]
        checks[name] = same_trees({p: got[p] for p in ("trainable", "ema", "opt_state")},
                                  {p: want[p] for p in ("trainable", "ema", "opt_state")})
    same_losses = logged["ranked"] == logged["plain"] == logged["degraded"]
    resumed_tail = logged["resumed"] == logged["plain"][2:]
    log(f"[phase12] (c) torchrun --nproc_per_node=1 cli.train --tiny --mesh --zero1 "
        f"--tensor-parallel 1, 4 micro-steps: metrics.jsonl equal to the run without the flags "
        f"(and to --tensor-parallel 2's, degraded to 1 x 1 with the mesh line) {same_losses}; "
        f"its step-4 checkpoint {checks['ranked'][0]} of {checks['ranked'][1]} tensors bit for "
        f"bit ({checks['degraded'][0]} with --tensor-parallel 2); resumed without --mesh from its "
        f"step-2 checkpoint: steps 3-4 logged the same {resumed_tail}, the step-4 checkpoint "
        f"{checks['resumed'][0]} of {checks['resumed'][1]} tensors bit for bit; {wall:.2f} s for "
        f"the torchrun command beside the plain and degraded runs  [{card}]")
    for name, (identical, total, worst) in checks.items():
        if identical != total:
            raise AssertionError(f"phase 12 (c) {name}: {total - identical} of {total} tensors "
                                 f"differ (max {worst:.3e})")
    if not (same_losses and resumed_tail):
        raise AssertionError(f"phase 12 (c): metrics {logged}")
    return {"wall_s": wall}


def phase12(seed: int, card: str, keep: dict) -> dict:
    """Training over ranks on one card: (a) stage 1 with ``--mesh`` and
    with ``--mesh --zero1``, (b) stage 2 with ``--mesh``, each in a world of
    one NCCL rank against phases 8 and 9's straight runs, (c) the command
    line under torchrun."""
    t0 = time.perf_counter()
    out = {}
    with part("phase12 (a)"):
        out["stage1"] = phase12_stage1(seed, card, keep["stage1"], zero1=False)
    with part("phase12 (a) zero1"):
        out["stage1_zero1"] = phase12_stage1(seed, card, keep["stage1"], zero1=True)
    with part("phase12 (b)"):
        out["stage2"] = phase12_stage2(seed, card, keep["stage2"])
    with part("phase12 (c)"):
        out["cli"] = phase12_cli(card)
    out["wall_s"] = time.perf_counter() - t0
    return out


# -- phase 13: full width against float32 -------------------------------------

# (a)'s limit on the 2-step 256 px fp32 restore, card against CPU: the limit
# tests/test_torch_full_width.py holds the port's CPU restore to against the
# JAX package at the same size and steps
FP32_RESTORE_LIMIT = 5e-3
# (a) without guidance: 3.5x the 2.855e-5 that every card run has read
UNGUIDED_LIMIT = 1e-4
# (b)'s bound on phase 4's bf16 restore against the fp32 one (512 px, 50
# steps, deterministic). PERF.md section 6 wrote max 0.75, mean 0.05 before
# the first card run (tests/test_torch_full_width.py's bf16 drift on the
# CPU at 2 steps and 256 px, scaled to 50 steps with a margin). That run
# read max 0.4678, mean 9.451e-3 on an H100; the max is held at 0.6 since
# (1.28x the reading: both restores repeat bit for bit from run to run),
# the mean at the 0.05 written first.
BF16_BOUND = {"max": 0.6, "mean": 0.05}
# (d)'s bound on phase 4's bf16 pipeline at 256 px, 2 steps, against (a)'s
# fp32 restore on the card, written before the first card run: about 3x the
# port's own bf16 drift on the CPU at that size and step count
# (tests/test_torch_full_width.py: max 0.164, mean 9.3e-3, 37.6 dB), the
# bound that test holds the CPU drift to
BF16_256_BOUND = {"max": 0.5, "mean": 0.03}


def guidance_residuals(latents, flows, masks, t: int, mode: str) -> list:
    """Each term's residual m prev - m lat and its mask m, term by term as
    ``guidance_terms`` orders them (the plain version's arithmetic). The
    guidance gradient is 1/N sgn(residual) m through the warp's transpose."""
    import torch

    from mgldvsr_tpu_torch.ops.kernels import guidance as guide_mod
    from mgldvsr_tpu_torch.ops.kernels.flow_warp import warp_plain

    lat = latents.reshape(latents.shape[0] // t, t, *latents.shape[1:])
    zero = torch.zeros_like(lat[:, 0])
    out = []
    for tm in guide_mod.guidance_terms(t, mode):
        m = 1.0 - masks[tm.kind][:, tm.occ]
        prev = zero if tm.src < 0 else warp_plain(lat[:, tm.src], flows[1 - tm.kind][:, tm.flow])
        out.append((m * prev - m * lat[:, tm.frame], m))
    return out


@contextlib.contextmanager
def recorded_guidance(calls: list):
    """Within the block, every guidance gradient of a card restore is held
    against its plain version on the same inputs (1e-6 of its largest
    element), and the sign and size of each term's residual go to ``calls``
    on the host."""
    import torch

    from mgldvsr_tpu_torch.core import diffusion
    from mgldvsr_tpu_torch.ops.kernels.guidance import guidance_grad_plain

    inner = diffusion.guidance_grad

    def record(latents, flows, masks, t, mode):
        grad = inner(latents, flows, masks, t, mode)
        want = guidance_grad_plain(latents, flows, masks, t, mode)
        err = max_err(grad, want)
        if not err <= 1e-6 * float(want.abs().max()):
            raise AssertionError(f"guidance call {len(calls)}: kernel and plain version differ "
                                 f"by {err:.3e}")
        calls.append({"latents": latents.cpu(), "signs": [
            (torch.sgn(r).cpu(), m.cpu()) for r, m in guidance_residuals(latents, flows, masks,
                                                                        t, mode)]})
        return grad

    diffusion.guidance_grad = record
    try:
        yield calls
    finally:
        diffusion.guidance_grad = inner


@contextlib.contextmanager
def replayed_guidance(card_calls: list, stats: dict):
    """Within the block, the i-th guidance gradient of a CPU restore takes
    each residual's sign from the card's i-th call (``recorded_guidance``)
    instead of its own: the plain version with the card's decisions. A sign
    that differs from the CPU's own is a flip; ``stats`` gets their count,
    the live residuals, the largest |residual| among the flips and overall,
    the largest distance of the two sides' latents, and how many mask
    elements differ."""
    import torch

    from mgldvsr_tpu_torch.core import diffusion
    from mgldvsr_tpu_torch.ops.kernels import guidance as guide_mod

    inner = diffusion.guidance_grad
    stats.update(flips=0, live=0, flip_residual=0.0, residual=0.0, latents=0.0, masks=0)

    def replay(latents, flows, masks, t, mode):
        call = card_calls[stats.setdefault("calls", 0)]
        stats["calls"] += 1
        stats["latents"] = max(stats["latents"], max_err(latents, call["latents"]))
        b = latents.shape[0] // t
        inv_n = guide_mod._inv_n(b * latents[0].numel())  # the mean over a frame's terms
        grad = torch.zeros_like(latents).reshape(b, t, *latents.shape[1:])
        cot = torch.empty((b, guide_mod.warp_slots(t, mode), *latents.shape[1:]),
                          dtype=latents.dtype)
        terms = guide_mod.guidance_terms(t, mode)
        for tm, (r, m), (sign, card_m) in zip(terms, guidance_residuals(latents, flows, masks,
                                                                         t, mode), call["signs"]):
            live = m != 0
            flipped = live & (torch.sgn(r) != sign)
            stats["live"] += int(torch.broadcast_to(live, r.shape).sum())
            stats["flips"] += int(flipped.sum())
            stats["masks"] += int((m != card_m).sum())
            stats["residual"] = max(stats["residual"], float(r.abs().max()))
            if flipped.any():
                stats["flip_residual"] = max(stats["flip_residual"],
                                             float(r.abs()[flipped].max()))
            ct = inv_n * sign * m
            grad[:, tm.frame] -= ct
            if tm.slot >= 0:
                cot[:, tm.slot] = ct
        return guide_mod.guidance_scatter_plain(grad.reshape(latents.shape), cot, flows, t, mode)

    diffusion.guidance_grad = replay
    try:
        yield stats
    finally:
        diffusion.guidance_grad = inner


def guided_card_vs_cpu(gpu, cpu, frames, limit: float, what: str, card: str) -> dict:
    """A deterministic guided restore, card against CPU. The L1 guidance
    steps each latent by the sign of a residual, and a residual within
    rounding of 0 can take either sign on the two sides; the first steps
    amplify the sides' rounding ~15x a step, so one such flip moves the
    frames by up to ~1e-2 over a patch where the rest agree to ~1e-5.
    So: every guidance gradient of the card's restore equals its plain
    version on its inputs; the CPU restores with the card's residual signs
    (``replayed_guidance``, which counts where the CPU's own signs differ);
    the replay must agree with the card within ``limit``, and flips must be
    rare (at most 1e-3 of the live residuals) and each lie within 4x the two
    sides' latent distance of 0, where rounding can put it on either side.
    Without a flip the replay is the CPU's own restore, up to the order of
    the gradient's sums, so the CPU's restore with its own signs is not
    run."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels

    calls, stats = [], {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_guidance(calls):
        got = gpu.restore_segment(frames.cuda(), deterministic=True)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    got = got.cpu()
    t0 = time.perf_counter()
    with replayed_guidance(calls, stats):
        replayed = cpu.restore_segment(frames, deterministic=True)
    cpu_s = time.perf_counter() - t0
    d = (got - replayed).abs()
    out = {"replayed_max_abs_err": float(d.max()), "replayed_mean_abs_err": float(d.mean()),
           "limit": limit, "card_s": card_s, "cpu_s": cpu_s, **stats}
    log(f"[phase13] {what}, card vs CPU: {stats['flips']} of {stats['live']} residual signs "
        f"flipped (largest |residual| flipped {stats['flip_residual']:.3e}, of all "
        f"{stats['residual']:.3e}; latents {stats['latents']:.3e} apart, {stats['masks']} "
        f"mask elements differ); with the card's signs max_abs_err "
        f"{out['replayed_max_abs_err']:.3e} (limit {limit:.1e}), mean "
        f"{out['replayed_mean_abs_err']:.3e}; card {card_s:.2f} s, CPU {cpu_s:.2f} s  [{card}]")
    if got.shape != frames.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: output {tuple(got.shape)} is not finite")
    if stats["calls"] != len(calls):
        raise AssertionError(f"{what}: {len(calls)} guidance calls on the card, "
                             f"{stats['calls']} on the CPU")
    if not (out["replayed_max_abs_err"] <= limit and stats["flips"] <= 1e-3 * stats["live"]
            and stats["flip_residual"] <= 4 * stats["latents"]):
        raise AssertionError(f"{what}: card and CPU disagree: {out}")
    return {**out, "counts": counts}


def fp32_config(steps: int):
    """``full_config`` with every tower in float32."""
    import dataclasses

    import torch

    cfg = full_config(steps)
    return dataclasses.replace(cfg, **{
        name: dataclasses.replace(getattr(cfg, name), dtype=torch.float32)
        for name in ("unet", "structcond", "vae", "clip")})


def with_steps(pipe, steps: int):
    """The same towers (shared, not copied) with a ``steps``-step sampler."""
    import copy
    import dataclasses

    from mgldvsr_tpu_torch.core.schedules import respace_schedule

    out = copy.copy(pipe)
    out.cfg = dataclasses.replace(pipe.cfg, ddpm_steps=steps)
    out.sched = respace_schedule(pipe.base_sched, steps)
    return out


def fp32_launches(counts: dict, steps: int, attention_a_step: int, phase: str,
                  wide: int = 0) -> None:
    """fp32 towers: every gated attention call of the UNet and struct-cond
    on the FMA kernel and ``wide`` of the VAE's mid attention on the wide
    kernel, every GroupNorm on the fused GroupNorm kernel (no channel sums),
    the guidance pair once a step, one lookup a RAFT iteration."""
    want = {"attention": attention_a_step * steps + wide, "attention_wgmma": 0,
            "attention_wide": wide, "channel_sums": 0,
            "guidance_residual": steps, "guidance_scatter": steps, "corr_lookup": 10}
    got = {k: counts[k] for k in want}
    if got != want or counts["fused_group_norm"] == 0 or any(counts[n] for n in FUSED_ONLY):
        raise AssertionError(f"{phase}: launches {counts}, expected {want}, fused GroupNorm > 0 "
                             f"and none of {FUSED_ONLY}")


def phase13_card_vs_cpu(pipe32, seed: int, card: str) -> dict:
    """(a) the 2-step 256 px fp32 restore, card against this machine's CPU:
    without guidance within ``UNGUIDED_LIMIT``, then guided
    (``guided_card_vs_cpu``) within ``FP32_RESTORE_LIMIT``."""
    import torch

    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, upscale_frames

    steps = 2
    frames = upscale_frames(torch.from_numpy(lq_clip(seed + 3, 64)), 4)
    gpu = with_steps(pipe32, steps)
    cpu = MGLDVSRPipeline(fp32_config(steps), "cpu")
    for name, tower in cpu.towers().items():
        tower.load_state_dict({k: v.cpu() for k, v in pipe32.towers()[name].state_dict().items()},
                              strict=True)
    with part("phase13 (a) unguided card"):
        got = gpu.restore_segment(frames.cuda(), deterministic=True, use_guidance=False).cpu()
    with part("phase13 (a) unguided CPU"):
        unguided = max_err(got, cpu.restore_segment(frames, deterministic=True,
                                                    use_guidance=False))
    log(f"[phase13] (a) fp32 full width, 256x256, {steps} steps, deterministic, without "
        f"guidance: card vs CPU max_abs_err {unguided:.3e} (limit {UNGUIDED_LIMIT:.0e}; "
        f"{torch.get_num_threads()} CPU threads)  [{card}]")
    if not unguided <= UNGUIDED_LIMIT:
        raise AssertionError(f"phase 13 (a): card and CPU disagree without guidance "
                             f"({unguided:.3e})")
    out = guided_card_vs_cpu(gpu, cpu, frames, FP32_RESTORE_LIMIT,
                             f"(a) fp32 full width, 256x256, {steps} steps, deterministic", card)
    del cpu
    log(f"[phase13] (a) launches { {k: n for k, n in out['counts'].items() if n} }  [{card}]")
    # 256 px: the gated self-attention is the 32^2 level's, 5 UNet calls and
    # 2 struct-cond calls a step, and the VAE's mid attention at 32^2 latents
    # (head dim 512) in the encoder and the decoder, on the wide kernel
    fp32_launches(out["counts"], steps, 7, "phase 13 (a)", wide=2)
    return {"unguided_max_abs_err": unguided, **out}


def phase13_bf16_vs_fp32(pipe16, pipe32, frames, steps: int, card: str) -> dict:
    """(b) phase 4's 512 px restore in bf16 and in fp32, deterministic."""
    import torch

    from mgldvsr_tpu_torch.ops import kernels

    outs, secs = {}, {}
    for name, pipe in (("bf16", pipe16), ("fp32", pipe32)):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        outs[name] = pipe.restore_segment(frames, deterministic=True)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        counts = kernels.launch_counts()
        if name == "fp32":
            fp32_launches(counts, steps, 14, "phase 13 (b)")
        elif counts["attention_wgmma"] != 14 * steps:
            raise AssertionError(f"phase 13 (b): bf16 attention launches {counts}")
    d = (outs["bf16"].float() - outs["fp32"]).abs()
    out = {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
           "psnr_db": float(10 * torch.log10(1.0 / (d * d).mean())), "seconds": secs,
           "bound": BF16_BOUND}
    log(f"[phase13] (b) 512x512, {steps} steps, deterministic, bf16 (phase 4's weights) vs "
        f"fp32: max |d| {out['max_abs']:.4e} (bound {BF16_BOUND['max']}), mean |d| "
        f"{out['mean_abs']:.4e} (bound {BF16_BOUND['mean']}), PSNR {out['psnr_db']:.2f} dB; "
        f"bf16 {secs['bf16']:.2f} s, fp32 {secs['fp32']:.2f} s  [{card}]")
    for name, o in outs.items():
        if o.shape != (5, 512, 512, 3) or not torch.isfinite(o).all():
            raise AssertionError(f"phase 13 (b): {name} output {tuple(o.shape)} is not finite")
    if not (out["max_abs"] <= BF16_BOUND["max"] and out["mean_abs"] <= BF16_BOUND["mean"]):
        raise AssertionError(f"phase 13 (b): bf16 against fp32 beyond the bound: {out}")
    return out


def phase13_bf16_256(pipe16, pipe32, seed: int, card: str) -> dict:
    """(d) phase 4's bf16 pipeline at (a)'s 256 px, 2 steps, deterministic,
    on (a)'s frames: the VAE's mid attention on the bf16 head-dim-512
    kernel (encode and decode, reading the VAE's views in place), held
    against the fp32 twin's restore of the same frames on the card within
    ``BF16_256_BOUND``."""
    import torch

    from mgldvsr_tpu_torch.infer.pipeline import upscale_frames
    from mgldvsr_tpu_torch.ops import kernels

    steps = 2
    frames = upscale_frames(torch.from_numpy(lq_clip(seed + 3, 64)), 4).cuda()
    outs, counts, secs = {}, {}, {}
    for name, pipe in (("fp32", pipe32), ("bf16", pipe16)):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        outs[name] = with_steps(pipe, steps).restore_segment(frames, deterministic=True)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        counts[name] = kernels.launch_counts()
    d = (outs["bf16"].float() - outs["fp32"]).abs()
    out = {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
           "psnr_db": float(10 * torch.log10(1.0 / (d * d).mean())), "seconds": secs,
           "bound": BF16_256_BOUND, "counts": counts["bf16"]}
    attn = {k: n for k, n in counts["bf16"].items() if "attention" in k}
    log(f"[phase13] (d) bf16 (phase 4's weights) vs fp32 on the card, 256x256, {steps} steps, "
        f"deterministic: max |d| {out['max_abs']:.4e} (bound {BF16_256_BOUND['max']}), mean |d| "
        f"{out['mean_abs']:.4e} (bound {BF16_256_BOUND['mean']}), PSNR {out['psnr_db']:.2f} dB; "
        f"bf16 {secs['bf16']:.2f} s, fp32 {secs['fp32']:.2f} s; {attn}  [{card}]")
    if outs["bf16"].shape != frames.shape or not torch.isfinite(outs["bf16"]).all():
        raise AssertionError(f"phase 13 (d): output {tuple(outs['bf16'].shape)} is not finite")
    # 7 gated calls a step on the head-dim-64 tensor-core kernel (the 32^2
    # level's), the VAE's mid attention twice on the wide one, in place
    if (attn["attention_wgmma"], attn["attention_wide"], attn["attention_wide_strided"],
            attn["attention"]) != (7 * steps, 2, 2, 7 * steps + 2):
        raise AssertionError(f"phase 13 (d): attention launches {attn}")
    fp32_launches(counts["fp32"], steps, 7, "phase 13 (d)", wide=2)
    if not (out["max_abs"] <= BF16_256_BOUND["max"] and out["mean_abs"] <= BF16_256_BOUND["mean"]):
        raise AssertionError(f"phase 13 (d): bf16 against fp32 beyond the bound: {out}")
    return out


def phase13_stock_unet(seed: int, card: str) -> dict:
    """(c) the stock UNet at tiny widths, card against CPU: its forward; the
    restore without guidance; the guided restore (phase 3's) on two clips
    (``guided_card_vs_cpu``)."""
    import dataclasses

    import torch

    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline, upscale_frames
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights

    base = tiny_config()
    cfg = dataclasses.replace(base, unet=dataclasses.replace(base.unet, use_temporal=False,
                                                              use_spade=False))
    cpu = MGLDVSRPipeline(cfg, "cpu")
    init_pipeline_weights(cpu, seed)
    calm_raft(cpu)
    gpu = MGLDVSRPipeline(cfg)
    for name, tower in gpu.towers().items():
        tower.load_state_dict(cpu.towers()[name].state_dict(), strict=True)
    if any("temporal" in k or ".spade." in k for k in gpu.unet.state_dict()):
        raise AssertionError("phase 13 (c): the stock UNet holds temporal or SPADE layers")
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(5, 4, 32, 32, generator=gen)
    t = torch.tensor([999, 700, 400, 100, 0])
    ctx = torch.randn(5, 77, base.clip.width, generator=gen)
    with torch.no_grad():
        want = cpu.unet(x, t, ctx, None)
        got = gpu.unet(x.cuda(), t.cuda(), ctx.cuda(), None).cpu()
    forward = max_err(got, want) / float(want.abs().max())
    frames = upscale_frames(torch.from_numpy(lq_clip(seed + 1, 64)), 4)
    plain = max_err(gpu.restore_segment(frames.cuda(), deterministic=True, use_guidance=False)
                    .cpu(), cpu.restore_segment(frames, deterministic=True, use_guidance=False))
    log(f"[phase13] (c) tiny stock UNet (use_temporal=False, use_spade=False), card vs CPU: "
        f"forward {forward:.3e} of max |eps| (limit 1e-4); restore without guidance "
        f"{plain:.3e} (limit 1e-3)  [{card}]")
    if not (forward <= 1e-4 and plain <= 1e-3):
        raise AssertionError(f"phase 13 (c): forward {forward:.3e}, restore without guidance "
                             f"{plain:.3e}")
    guided = {}
    for clip in (seed + 1, seed + 2):
        frames = upscale_frames(torch.from_numpy(lq_clip(clip, 64)), 4)
        guided[f"clip {clip}"] = r = guided_card_vs_cpu(
            gpu, cpu, frames, 1e-3, f"(c) tiny stock UNet, guided, clip {clip}", card)
        for name in ("attention", "fused_group_norm", "guidance_residual", "corr_lookup"):
            if r["counts"][name] == 0:
                raise AssertionError(f"phase 13 (c): kernel {name} was never launched")
    return {"forward_rel": forward, "unguided": plain, "guided": guided}


def phase13(pipe16, frames, seed: int, steps: int, card: str) -> dict:
    """Full width against float32: (a) card against CPU, (d) bf16 against
    fp32 at (a)'s size, (b) bf16 against fp32 at 512 px, (c) the stock UNet
    at tiny widths."""
    import torch

    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights

    t0 = time.perf_counter()
    with part("phase13 fp32 twin"):
        pipe32 = MGLDVSRPipeline(fp32_config(steps))
        init_pipeline_weights(pipe32, seed)
        calm_raft(pipe32)
    # the twin holds phase 4's weights before their cast
    for name in ("unet", "clip", "vae"):
        sd16 = pipe16.towers()[name].state_dict()
        for k, v in pipe32.towers()[name].state_dict().items():
            if not torch.equal(v.to(sd16[k].dtype), sd16[k]):
                raise AssertionError(f"phase 13: the fp32 twin's {name}.{k} is not phase 4's")
    out = {}
    with part("phase13 (a)"):
        out["card_vs_cpu"] = phase13_card_vs_cpu(pipe32, seed, card)
    with part("phase13 (d)"):
        out["bf16_256px"] = phase13_bf16_256(pipe16, pipe32, seed, card)
    with part("phase13 (b)"):
        out["bf16_vs_fp32"] = phase13_bf16_vs_fp32(pipe16, pipe32, frames, steps, card)
    with part("phase13 (c)"):
        out["stock_unet"] = phase13_stock_unet(seed, card)
    del pipe32
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


# -- phase 14: the soak tool ---------------------------------------------------


def soak_start(tmp: str) -> tuple:
    """Start the soak tool at tiny widths on the card, as a user runs it, in
    the background: its own processes and ~0.15 GiB of the card, so it can
    run beside another phase. Returns (the run, its work folder, its start)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    workdir = os.path.join(tmp, "soak")
    run = background(
        [sys.executable, "-m", "mgldvsr_tpu_torch.tools.soak_train", "--tiny", "--steps", "40",
         "--sig-frac", "0.25", "--log-every", "1", "--clips", "2", "--frames-per-clip", "6",
         "--startup-timeout", "240", "--workdir", workdir],
        os.path.dirname(os.path.abspath(__file__)), env, os.path.join(tmp, "soak_log"))
    return run, workdir, time.perf_counter()


def soak_finish(card: str, started: tuple) -> dict:
    """Wait for the soak run and hold its summary; ``wall_s`` is the run's
    own, from its start to its exit."""
    run, workdir, t0 = started
    returncode, stdout, stderr = run.wait(600)
    while run.ended is None:
        time.sleep(0.01)
    wall = run.ended - t0
    path = os.path.join(workdir, "soak_summary.json")
    if returncode or not os.path.isfile(path):
        raise AssertionError(f"phase 14: the soak tool exited {returncode}: "
                             f"{stdout[-2000:]} {stderr[-2000:]}")
    with open(path) as f:
        summary = json.load(f)
    log(f"[phase14] soak_train --tiny on the card, 40 micro-steps: checkpoint at step "
        f"{summary['ckpt_step']}, killed at {summary['killed_at_step']}, resumed at "
        f"{summary['resumed_first_step']}, replayed steps {summary['seam_replayed_steps']} "
        f"(loss difference {summary['seam_difference']:.3e}), "
        f"{summary['steps_per_sec_median']:.3f} steps/s, peak "
        f"{summary['peak_mem_last_gb']} GiB; {wall:.1f} s from its start to its exit  [{card}]")
    if not (summary["ok"] and summary["resume_exact"] and summary["peak_mem_last_gb"]):
        raise AssertionError(f"phase 14: {summary}")
    return dict(summary, wall_s=wall)


def phase14(card: str) -> dict:
    """The soak tool at tiny widths on the card, alone."""
    with tempfile.TemporaryDirectory() as tmp:
        started = soak_start(tmp)
        with started[0]:
            return soak_finish(card, started)


# -- phase 15: the device synthesis and the stock text-to-image path ----------

SYN_LEVEL = 1.0 / 255


def synthesis_kernels(seed: int, n: int) -> dict:
    """A kernel set a clip, stacked: [n, 21, 21] each."""
    from mgldvsr_tpu_torch.train.synthesis import sample_degradation_kernels

    sets = [sample_degradation_kernels(np.random.RandomState(seed + i)) for i in range(n)]
    return {k: np.stack([s[k] for s in sets]) for k in sets[0]}


def jpeg_blocks_apart(got, want, coefs_got, coefs_want, pix_atol: float = 1e-5) -> int:
    """The CPU tests' DiffJPEG limits for one JPEG step of the same input
    on two sides ([N,H,W,3] outputs, each side's scaled coefficients): the
    coefficients within 1e-4; each block whose rounding differs holds a
    coefficient within 1e-4 of a half-integer; at most 0.1% of the blocks
    differ; every pixel outside them within ``pix_atol``. Returns the
    number of blocks apart."""
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    apart = torch.zeros(got.shape[:3], dtype=torch.bool)
    n_blocks = n_diff = 0
    w = got.shape[2]
    for plane, (cg, cw) in enumerate(zip(coefs_got, coefs_want)):
        cg, cw = cg.float().cpu(), cw.float().cpu()
        err = max_err(cg, cw)
        if err > 1e-4:
            raise AssertionError(f"DiffJPEG plane {plane}: coefficients {err:.3e} apart")
        flipped = (cg.round() != cw.round()).flatten(2).any(dim=2)
        half = ((cw - cw.floor()).sub(0.5).abs() < 1e-4).flatten(2).any(dim=2)
        if bool((flipped & ~half).any()):
            raise AssertionError(f"DiffJPEG plane {plane}: a block rounds apart without a "
                                 f"coefficient at a half-integer")
        n_blocks += flipped.numel()
        n_diff += int(flipped.sum())
        px = 8 if plane == 0 else 16
        for i, b in flipped.nonzero().tolist():
            r, c = divmod(b, w // px)
            apart[i, r * px:(r + 1) * px, c * px:(c + 1) * px] = True
    if n_diff > 1e-3 * n_blocks:
        raise AssertionError(f"DiffJPEG: {n_diff} of {n_blocks} blocks apart")
    d = (got - want).abs().amax(dim=-1)
    if bool((d[~apart] > pix_atol).any()):
        raise AssertionError(f"DiffJPEG: pixels outside the blocks apart "
                             f"{float(d[~apart].max()):.3e}")
    return n_diff


def levels_apart(got, want) -> int:
    """Pixels on the 1/255 grid: each within 1e-5 or one level, at most
    0.1% a level apart. Returns how many are."""
    d = (got.float().cpu() - want.float().cpu()).abs()
    level = (d - SYN_LEVEL).abs() <= 1e-5
    if not bool(((d <= 1e-5) | level).all()):
        raise AssertionError(f"levels: {float(d.max()):.3e} apart")
    if int(level.sum()) > 1e-3 * d.numel():
        raise AssertionError(f"levels: {int(level.sum())} of {d.numel()} pixels a level apart")
    return int(level.sum())


def synthesis_card_vs_cpu(seed: int, card: str) -> dict:
    """(a) card against CPU at [2,128,128,3] with the same draws (made on
    the CPU): the sharpened GT within 1e-5; each step of the chain on the
    card's input to it, card against CPU: the JPEG steps by
    ``jpeg_blocks_apart``, the final levels by ``levels_apart``, every other
    step within 1e-5; then the whole chain by ``levels_apart``, which a JPEG
    block apart (found step by step, and explained there) may excuse."""
    import torch

    from mgldvsr_tpu_torch.ops.diffjpeg import scaled_coefficients
    from mgldvsr_tpu_torch.ops.img_process import usm_sharp
    from mgldvsr_tpu_torch.train import synthesis as syn

    cfg = syn.SynthesisConfig()
    gt = torch.from_numpy(lq_clip(seed + 40, 128, frames=2))
    kern = {k: torch.from_numpy(v) for k, v in synthesis_kernels(seed + 40, 2).items()}
    draws = syn.draw_synthesis(torch.Generator().manual_seed(seed + 41), 2, 128, 128, cfg, "cpu")
    sharp_cpu, sharp_gpu = usm_sharp(gt), usm_sharp(gt.cuda())
    usm_err = max_err(sharp_gpu.cpu(), sharp_cpu)
    if usm_err > 1e-5:
        raise AssertionError(f"phase 15 (a): usm_sharp card vs CPU {usm_err:.3e}")
    steps = syn.synthesis_steps(kern, draws, 128, 128, cfg)
    x, errs, blocks = sharp_gpu, {}, 0
    for name, step in steps:
        got, want = step(x), step(x.cpu())
        if name.startswith("jpeg"):
            q = (draws.stage1 if name == "jpeg1" else draws.stage2).quality
            blocks += jpeg_blocks_apart(got, want,
                                        scaled_coefficients(x.clamp(0, 1), q.cuda()),
                                        scaled_coefficients(x.cpu().clamp(0, 1), q))
        elif name == "levels":
            levels_apart(got, want)
        elif max_err(got.cpu(), want) > 1e-5:
            raise AssertionError(f"phase 15 (a): step {name} card vs CPU "
                                 f"{max_err(got.cpu(), want):.3e}")
        errs[name] = max_err(got.cpu(), want)
        x = got
    lq_gpu, _ = syn.apply_synthesis(gt.cuda(), kern, draws, cfg)
    lq_cpu, _ = syn.apply_synthesis(gt, kern, draws, cfg)
    whole = max_err(lq_gpu.cpu(), lq_cpu)
    try:
        levels = levels_apart(lq_gpu, lq_cpu)
    except AssertionError:
        if not blocks:
            raise
        levels = None
    log(f"[phase15] (a) synthesis card vs CPU at [2,128,128,3], the same draws: usm "
        f"{usm_err:.3e}; steps {', '.join(f'{k} {v:.2e}' for k, v in errs.items())}; JPEG "
        f"blocks apart {blocks}; the whole chain max |d| {whole:.3e} ({levels} pixels a "
        f"level apart)  [{card}]")
    return {"usm": usm_err, "steps": errs, "jpeg_blocks_apart": blocks, "whole": whole,
            "levels_apart": levels}


def synthesis_full(seed: int, card: str, host_s: float | None) -> dict:
    """(a) a stage-1 clip's GT [8,512,512,3] float32 on the card, a kernel
    set a frame, draws from the card's generator: LQ [8,128,128,3], finite,
    in [0, 1], on the 1/255 grid; ms a clip (warm, synchronised, median of
    3)."""
    import torch

    from mgldvsr_tpu_torch.train import synthesis as syn

    cfg = syn.SynthesisConfig()
    gt = torch.from_numpy(lq_clip(seed + 30, 512, frames=8)).cuda()
    kern = {k: torch.from_numpy(v).cuda() for k, v in synthesis_kernels(seed + 30, 8).items()}
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lq, sharp = syn.synthesize_lq(gen, gt, kern, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            first = lq
    ms = 1000 * float(np.median(times[1:]))
    if first.shape != (8, 128, 128, 3) or sharp.shape != gt.shape:
        raise AssertionError(f"phase 15 (a): shapes {tuple(first.shape)}, {tuple(sharp.shape)}")
    if not (bool(torch.isfinite(first).all()) and 0 <= float(first.min())
            and float(first.max()) <= 1):
        raise AssertionError("phase 15 (a): the LQ is not finite in [0, 1]")
    if not torch.equal(torch.round(first * 255) / 255, first):
        raise AssertionError("phase 15 (a): the LQ is off the 1/255 grid")
    host = f"{host_s:.3f} s a clip" if host_s is not None else "not measured in this run"
    log(f"[phase15] (a) synthesis on the card, GT [8,512,512,3] float32 -> LQ [8,128,128,3]: "
        f"{ms:.2f} ms a clip (median of 3 warm calls; first call {1000 * times[0]:.2f} ms); "
        f"the host data path (phase 8, one thread): {host}  [{card}]")
    return {"ms_a_clip": ms, "first_ms": 1000 * times[0], "host_s_a_clip": host_s}


def made_up_prompt(seed: int, tmp: str):
    """(tokens [1, 77], empty tokens [1, 77]): a made-up vocabulary (a
    merges file written from ``seed``) and a prompt of its words."""
    import gzip

    from mgldvsr_tpu_torch.data.tokenizer import SimpleTokenizer, tokenize

    rs = np.random.RandomState(seed)
    words = ["".join(rs.choice(list("abcdefghijklmnopqrstuvwxyz"), rs.randint(3, 9)))
             for _ in range(12)]
    lines, seen = ["#version: made up"], set()
    for w in words:
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            if (parts[0], parts[1]) not in seen:
                seen.add((parts[0], parts[1]))
                lines.append(f"{parts[0]} {parts[1]}")
            parts = [parts[0] + parts[1]] + parts[2:]
    path = os.path.join(tmp, "bpe_made_up.txt.gz")
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    tok = SimpleTokenizer(path)
    prompt = " ".join(words[:8])
    return tokenize(prompt, 77, tokenizer=tok), tokenize("", 77, tokenizer=tok), prompt


def gated_self_attentions(cfg, latent: int) -> int:
    """The UNet's self-attention calls a forward that pass the kernel's
    gate (N >= 1024 tokens): every transformer at a level with at least
    1024 latent pixels, num_res_blocks of them going down and one more
    coming up."""
    from mgldvsr_tpu_torch.ops.attention import gated

    count, ds = 0, 1
    for level in range(len(cfg.channel_mult)):
        n = (latent // ds) ** 2
        if ds in cfg.attention_resolutions and gated(n, n, cfg.num_head_channels, 2):
            count += 2 * cfg.num_res_blocks + 1
        ds *= 2
    return count


# phase 15 (f): the kernels' distance from the float32 twin over the plain
# versions' in bf16, at most (as phase 9 (e)'s S2_DEC_TO_F32)
T2I_TO_F32 = 1.5


@contextlib.contextmanager
def plain_attention():
    """Bind the attention dispatch's kernel entry to its plain version for
    the enclosed calls; restore the wrapper after."""
    from mgldvsr_tpu_torch.ops import attention as dispatch
    from mgldvsr_tpu_torch.ops.kernels.attention import attention_bnhd_plain

    before = dispatch.attention_bnhd
    dispatch.attention_bnhd = attention_bnhd_plain
    try:
        yield
    finally:
        dispatch.attention_bnhd = before


@contextlib.contextmanager
def recorded_kernel_calls(seen: dict):
    """Bind the models' kernel entries (the attention dispatch's
    ``attention_bnhd``; ``models.layers``' ``fused_group_norm``,
    ``channel_sums`` and ``gn_silu_conv3x3``) to wrappers that count each
    call in ``seen`` under its kernel's name and its operands' shapes,
    dtypes, strides and arguments, then pass it on; restore them after."""
    from mgldvsr_tpu_torch.models import layers
    from mgldvsr_tpu_torch.ops import attention as dispatch

    before = {"attention_bnhd": dispatch.attention_bnhd,
              **{name: getattr(layers, name)
                 for name in ("fused_group_norm", "channel_sums", "gn_silu_conv3x3")}}

    def note(key):
        seen[key] = seen.get(key, 0) + 1

    def attention_bnhd(q, k, v):
        note(("attention", tuple(q.shape), tuple(q.stride()), tuple(k.stride()),
              tuple(v.stride()), q.dtype))
        return before["attention_bnhd"](q, k, v)

    def fused_group_norm(x, weight, bias, groups, eps):
        note(("fused_group_norm", tuple(x.shape), x.dtype, groups, eps))
        return before["fused_group_norm"](x, weight, bias, groups, eps)

    def channel_sums(x):
        note(("channel_sums", tuple(x.shape), x.dtype))
        return before["channel_sums"](x)

    def gn_silu_conv3x3(x, gn_weight, gn_bias, weight, bias, groups, eps):
        note(("gn_silu_conv3x3", tuple(x.shape), x.dtype, weight.shape[0], bias.dtype, groups,
              eps))
        return before["gn_silu_conv3x3"](x, gn_weight, gn_bias, weight, bias, groups, eps)

    dispatch.attention_bnhd = attention_bnhd
    layers.fused_group_norm, layers.channel_sums = fused_group_norm, channel_sums
    layers.gn_silu_conv3x3 = gn_silu_conv3x3
    try:
        yield
    finally:
        dispatch.attention_bnhd = before.pop("attention_bnhd")
        for name, fn in before.items():
            setattr(layers, name, fn)


def strided_randn(shape, stride, dtype, dev, gen, mean: float = 0.0):
    """N(mean, 1) values of ``dtype`` laid out with ``stride`` in a buffer
    of their own (a view of it)."""
    import torch

    size = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    return (torch.randn(size, device=dev, generator=gen) + mean).to(dtype).as_strided(shape,
                                                                                   stride)


def t2i_kernel_shapes(seen: dict, card: str) -> dict:
    """(e) every kernel against its plain version at every shape (b) gave
    it (``seen``, from ``recorded_kernel_calls``), on seeded inputs, with
    phase 2's limits: attention in bf16 3 ulps at max |out| against the
    plain version in bf16 and in float32 (q, k and v laid out with the
    path's strides, read in place), the fused GroupNorm 2 ulps at max |y|
    in bf16 (1e-5 in float32), the channel sums 1e-5 of the largest, the
    fused chain 3 ulps at max |y| in bf16 (1e-4 of it in float32) and its
    statistics 1e-5 of the largest, relative. Times (kernel, plain
    version, the library call), bounds as phase 2's. Returns kernel ->
    shape -> row."""
    import torch
    import torch.nn.functional as F

    from mgldvsr_tpu_torch.ops import kernels
    from mgldvsr_tpu_torch.ops.kernels import attention as attn_mod
    from mgldvsr_tpu_torch.ops.kernels import gn_silu_conv as conv_mod
    from mgldvsr_tpu_torch.ops.kernels import groupnorm as gn_mod

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1515)
    bf16 = torch.bfloat16
    out = {}

    def kind(dtype):
        return "bf16" if dtype == bf16 else "f32"

    def row(name, label, calls, err, tol, fn, plain, library, bnd, **extra):
        r = {"calls": calls, "max_abs_err": err, "limit": tol, "ms": cuda_ms(fn, iters=5),
             "plain_ms": cuda_ms(plain, iters=5), "library_ms": cuda_ms(library, iters=5),
             "bound_ms": bnd[0], "bound_by": bnd[1], **extra}
        log(f"[phase15] (e) {name} {label} ({calls} calls in (b)'s warm run): max_abs_err "
            f"{err:.3e} (limit {tol:.3e}) kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            f"{''.join(f', {k} {v}' for k, v in extra.items())}  [{card}]")
        if not (err <= tol):
            raise AssertionError(f"phase 15 (e): {name} {label}: {err:.3e} > {tol:.3e}")
        out.setdefault(name, {})[label] = r

    for key, calls in sorted(seen.items(), key=str):
        name = key[0]
        if name == "attention":
            _, shape, sq, sk, sv, dtype = key
            q, k = (strided_randn(shape, st, dtype, dev, gen) for st in (sq, sk))
            v = strided_randn(shape, sv, dtype, dev, gen, mean=1.0)
            kernels.reset_launch_counts()
            got = attn_mod.attention_bnhd(q, k, v)
            c = kernels.launch_counts()
            want32 = attn_mod.attention_bnhd_plain(q.float(), k.float(), v.float())
            tol = bf16_ulps(3, want32) if dtype == bf16 else 1e-4
            err = max(max_err(got, want32), max_err(got, attn_mod.attention_bnhd_plain(q, k, v)))
            del want32
            b, n, h, d = shape
            if dtype == bf16 and d == 64 and c["attention_wgmma"] != 1:
                raise AssertionError(f"phase 15 (e): attention {shape} did not take wgmma: {c}")
            qh, kh, vh = (z.transpose(1, 2) for z in (q, k, v))
            row("attention", f"[{b},{n},{h},{d}] {kind(dtype)} strides {list(sq)}", calls, err,
                tol, lambda: attn_mod.attention_bnhd(q, k, v),
                lambda: attn_mod.attention_bnhd_plain(q, k, v),
                lambda: F.scaled_dot_product_attention(qh, kh, vh),
                bound(nbytes(q, k, v, got), 4.0 * b * h * n * n * d, kind(dtype)),
                read_in_place=bool(c["attention_strided"]))
        elif name == "fused_group_norm":
            _, shape, dtype, groups, eps = key
            x, w, b = group_norm_case(shape, dtype, dev, gen)
            got = gn_mod.fused_group_norm(x, w, b, groups, eps)
            want = gn_mod.fused_group_norm_plain(x, w, b, groups, eps)
            wd, bd = w.to(dtype), b.to(dtype)
            row(name, f"{list(shape)} {kind(dtype)} eps {eps:g}", calls, max_err(got, want),
                group_norm_limit(want), lambda: gn_mod.fused_group_norm(x, w, b, groups, eps),
                lambda: gn_mod.fused_group_norm_plain(x, w, b, groups, eps),
                lambda: F.group_norm(x, groups, wd, bd, eps),
                bound(nbytes(x, got, w, b), 8.0 * x.numel(), "f32"))
        elif name == "channel_sums":
            _, shape, dtype = key
            x = torch.randn(shape, device=dev, generator=gen).to(dtype) + 0.5
            got, want = gn_mod.channel_sums(x), gn_mod.channel_sums_plain(x)
            row(name, f"{list(shape)} {kind(dtype)}", calls,
                max(max_err(got[0], want[0]), max_err(got[1], want[1])),
                1e-5 * float(want[1].abs().max()), lambda: gn_mod.channel_sums(x),
                lambda: gn_mod.channel_sums_plain(x),
                lambda: torch.var_mean(x, dim=(2, 3)),
                bound(nbytes(x, *got), 3.0 * x.numel(), "f32"),
                kernel="channel_sums_kernel (csrc/groupnorm.cu)",
                threads=gn_mod.channel_sums_plan(shape[0] * shape[1], shape[2] * shape[3],
                                                 x.element_size()))
        elif name == "gn_silu_conv3x3":
            _, shape, dtype, co, bias_dtype, groups, eps = key
            n, c, h, w_ = shape
            x = (torch.randn(shape, device=dev, generator=gen) * 1.5 + 0.3).to(dtype)
            gw = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
            gb = 0.1 * torch.randn(c, device=dev, generator=gen)
            wt = (torch.randn(co, c, 3, 3, device=dev, generator=gen) * (9 * c) ** -0.5).to(dtype)
            bias = (0.1 * torch.randn(co, device=dev, generator=gen)).to(bias_dtype)
            kernels.reset_launch_counts()
            got = conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, groups, eps)
            on_wgmma = kernels.launch_counts()["gn_silu_conv3x3_wgmma"]
            want = conv_mod.gn_silu_conv3x3_plain(x, gw, gb, wt, bias, groups, eps)
            tol = (bf16_ulps(3, want) if dtype == bf16
                   else 1e-4 * float(want.float().abs().max()))
            gwd, gbd, biasd = gw.to(dtype), gb.to(dtype), bias.to(dtype)
            row(name, f"[{n},{c},{h},{w_}]->{co} {kind(dtype)}", calls, max_err(got, want), tol,
                lambda: conv_mod.gn_silu_conv3x3(x, gw, gb, wt, bias, groups, eps),
                lambda: conv_mod.gn_silu_conv3x3_plain(x, gw, gb, wt, bias, groups, eps),
                lambda: F.conv2d(F.silu(F.group_norm(x, groups, gwd, gbd, eps)), wt, biasd,
                                 padding=1),
                bound(nbytes(x, wt, got, gw, gb, bias), 18.0 * c * co * n * h * w_, kind(dtype)),
                variant=conv_mod.kernel_variant(dtype, co), on_wgmma=bool(on_wgmma))
            # the chain's statistics, once a shape (chains of one input and
            # several output widths share them)
            label = f"{list(shape)} {kind(dtype)} eps {eps:g}"
            if label in out.get("gn_scale_shift", {}):
                out["gn_scale_shift"][label]["calls"] += calls
                continue
            sums = gn_mod.gn_scale_shift(x, gw, gb, groups, eps)
            plain = gn_mod.gn_scale_shift_plain(x, gw, gb, groups, eps)
            groups_view = x.view(n, groups, -1)
            row("gn_scale_shift", label, calls,
                max(max_err(a, p) / float(p.abs().max()) for a, p in zip(sums, plain)), 1e-5,
                lambda: gn_mod.gn_scale_shift(x, gw, gb, groups, eps),
                lambda: gn_mod.gn_scale_shift_plain(x, gw, gb, groups, eps),
                lambda: torch.var_mean(groups_view, dim=2),
                bound(nbytes(x, gw, gb, *sums), 3.0 * x.numel(), "f32"))
        else:
            raise AssertionError(f"phase 15 (e): no check for {key}")
        torch.cuda.empty_cache()
    return out


def t2i_against_plain(pipe, unet32, vae32, ctx, unc, x_T, card: str) -> dict:
    """(f) one UNet call of (b)'s sampler (the batch-2 CFG call at its
    first timestep) and one decode (of x_T, latents of the sampler's
    scale), at full width in bf16: the kernels in each configuration
    against the plain versions (``plain_group_norms``, ``plain_attention``)
    in bf16 on the card, and each against the float32 twin (the same
    seeded weights, never cast) on the plain versions. Distances are
    ||a - b|| / ||b||; the kernels' distance from float32 must stay within
    ``T2I_TO_F32`` times the plain bf16 run's (PERF.md section 6, written
    before the first card run)."""
    import torch

    from mgldvsr_tpu_torch.core.samplers import make_ddim_timesteps
    from mgldvsr_tpu_torch.infer.pipeline import _nchw, _nhwc
    from mgldvsr_tpu_torch.ops import kernels

    first = int(make_ddim_timesteps(pipe.sched.num_timesteps, 50)[-1])
    tb = torch.full((2,), first, device="cuda", dtype=torch.int64)
    x2 = _nchw(torch.cat([x_T, x_T], dim=0))
    ctx2 = torch.cat([unc, ctx], dim=0)

    def run(unet, vae):
        kernels.reset_launch_counts()
        with torch.no_grad():
            eps = unet(x2, tb, ctx2, None).float()
            img = _nhwc(vae.decode(_nchw(x_T / pipe.cfg.scale_factor))).float()
        torch.cuda.synchronize()
        return eps, img, {k: v for k, v in kernels.launch_counts().items() if v}

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    with plain_group_norms(), plain_attention():
        want = run(unet32, vae32)
        plain = run(pipe.unet, pipe.vae)
    if want[2] or plain[2]:
        raise AssertionError(f"phase 15 (f): the plain runs launched {want[2]}, {plain[2]}")
    out = {"unet_plain_from_f32": rel(plain[0], want[0]),
           "decode_plain_from_f32": rel(plain[1], want[1])}
    for fused in (False, True):
        with fused_switch(fused):
            got = run(pipe.unet, pipe.vae)
        tag = "fused" if fused else "default"
        r = {"unet_from_plain": rel(got[0], plain[0]), "decode_from_plain": rel(got[1], plain[1]),
             "unet_from_f32": rel(got[0], want[0]), "decode_from_f32": rel(got[1], want[1]),
             "launches": got[2]}
        r["unet_to_f32"] = r["unet_from_f32"] / out["unet_plain_from_f32"]
        r["decode_to_f32"] = r["decode_from_f32"] / out["decode_plain_from_f32"]
        out[tag] = r
        log(f"[phase15] (f) {tag}: one batch-2 CFG UNet call at t={int(tb[0])} and one decode "
            f"at 512x512, bf16 kernels against the plain versions in bf16: UNet "
            f"{r['unet_from_plain']:.3e}, decode {r['decode_from_plain']:.3e} (||d|| / ||plain||);"
            f" against the float32 twin: UNet {r['unet_from_f32']:.3e} (plain bf16 "
            f"{out['unet_plain_from_f32']:.3e}, ratio {r['unet_to_f32']:.3f}), decode "
            f"{r['decode_from_f32']:.3e} (plain bf16 {out['decode_plain_from_f32']:.3e}, ratio "
            f"{r['decode_to_f32']:.3f}; limit {T2I_TO_F32} each); launches {got[2]}  [{card}]")
        if not (r["unet_to_f32"] <= T2I_TO_F32 and r["decode_to_f32"] <= T2I_TO_F32):
            raise AssertionError(f"phase 15 (f) {tag}: {r}")
        needed = (("gn_silu_conv3x3", "gn_scale_shift", "fused_group_norm") if fused
                  else ("channel_sums", "fused_group_norm"))
        if (any(not got[2].get(k) for k in needed)
                or got[2].get("attention_wgmma") != gated_self_attentions(pipe.cfg.unet, 64)):
            raise AssertionError(f"phase 15 (f) {tag}: launches {got[2]}")
    return out


def t2i_full(seed: int, card: str, tmp: str) -> dict:
    """(b) the stock SD 2.1 text-to-image path at full width in bf16, in
    both configurations; after it (f) one of its UNet calls and a decode
    against the plain versions and a float32 twin, and (e) every kernel at
    every shape its warm runs gave it."""
    import dataclasses

    import torch

    from mgldvsr_tpu_torch.infer.txt2img import Text2ImgConfig, Text2ImgPipeline
    from mgldvsr_tpu_torch.infer.txt2img import text2img_unet_config
    from mgldvsr_tpu_torch.io.init_weights import init_module_weights
    from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig
    from mgldvsr_tpu_torch.models.unet import InflatedUNetDualCond
    from mgldvsr_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from mgldvsr_tpu_torch.ops import kernels

    bf16 = torch.bfloat16
    cfg = Text2ImgConfig(unet=text2img_unet_config(bf16),
                         vae=VAEConfig(num_frames=1, enable_fusion=False, dtype=bf16),
                         clip=CLIPTextConfig(dtype=bf16))
    pipe = Text2ImgPipeline(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 50)
    for tower in pipe.towers().values():
        init_module_weights(tower, gen)
    # (f)'s float32 twin: the weights before their cast, kept on the host
    # until (b) has run
    weights32 = {name: {k: v.cpu() for k, v in getattr(pipe, name).state_dict().items()}
                 for name in ("unet", "vae")}
    pipe.cast_to_compute_dtypes()
    tokens, empty, prompt = made_up_prompt(seed + 50, tmp)
    steps, inv_steps, scale = 50, 10, 7.5
    per_call = gated_self_attentions(cfg.unet, 64)
    calls = steps + inv_steps
    out = {"prompt": prompt, "gated_attention_a_unet_call": per_call}
    x_T = torch.randn(1, 64, 64, 4, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(seed + 51))
    seen = {}
    for fused in (False, True):
        name = "fused" if fused else "default"
        # warm (cuDNN's first calls, the re-laid weights), every kernel call
        # noted: the guided sampler, the decode, the encode and the unguided
        # inversion at (b)'s shapes
        kernels.reset_launch_counts()
        noted = {}
        with fused_switch(fused), recorded_kernel_calls(noted):
            ctx = pipe.embed_tokens(torch.from_numpy(tokens))
            pipe.invert(pipe.decode(pipe.sample_latents(ctx, height=512, width=512, num_steps=2,
                                                        cfg_scale=scale, uncond_context=ctx)),
                        ctx, num_steps=1)
        torch.cuda.synchronize()
        warm = kernels.launch_counts()
        for kernel in ("attention", "fused_group_norm", "channel_sums", "gn_silu_conv3x3"):
            if sum(c for key, c in noted.items() if key[0] == kernel) != warm[kernel]:
                raise AssertionError(f"phase 15 (b) {name}: {kernel} launched {warm[kernel]} "
                                     f"times, {noted} noted")
        for key, c in noted.items():
            seen[key] = seen.get(key, 0) + c
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with fused_switch(fused):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            ctx = pipe.embed_tokens(torch.from_numpy(tokens))
            unc = pipe.embed_tokens(torch.from_numpy(empty))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lat = pipe.sample_latents(ctx, height=512, width=512, num_steps=steps,
                                      cfg_scale=scale, uncond_context=unc, x_T=x_T)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            raw = pipe.decode(lat)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            img = raw.clamp(-1, 1)
            inv = pipe.invert(img, ctx, torch.Generator(device="cuda").manual_seed(seed + 52),
                              num_steps=inv_steps)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if img.shape != (1, 512, 512, 3) or not bool(torch.isfinite(raw).all()):
            raise AssertionError(f"phase 15 (b) {name}: image {tuple(img.shape)}, finite "
                                 f"{bool(torch.isfinite(raw).all())}")
        if inv.shape != (1, 64, 64, 4) or not bool(torch.isfinite(inv).all()):
            raise AssertionError(f"phase 15 (b) {name}: the inversion is not finite")
        if not counts["attention"] == counts["attention_wgmma"] == per_call * calls:
            raise AssertionError(f"phase 15 (b) {name}: {counts['attention']} attention "
                                 f"launches, {counts['attention_wgmma']} on wgmma, expected "
                                 f"{per_call} a UNet call x {calls}")
        if fused:
            # all but the chains of 8 output channels or fewer: the UNet's output
            # conv (a call), the decoder's (3) and the encoder's (8, once)
            narrow = calls + 2
            conv = counts["gn_silu_conv3x3"]
            if not (conv > 0 and counts["gn_scale_shift"] == conv
                    and counts["gn_silu_conv3x3_wgmma"] == conv - narrow
                    and counts["channel_sums"] == 0 and counts["fused_group_norm"] > 0):
                raise AssertionError(f"phase 15 (b) fused: launches {counts}")
        elif not (counts["fused_group_norm"] > 0 and counts["channel_sums"] > 0
                  and counts["gn_silu_conv3x3"] == 0):
            raise AssertionError(f"phase 15 (b) default: launches {counts}")
        row = {"clip_s": t1 - t0, "ms_a_step": 1000 * (t2 - t1) / steps, "decode_s": t3 - t2,
               "invert_s": t4 - t3, "invert_ms_a_step_with_encode": 1000 * (t4 - t3) / inv_steps,
               "peak_gib": peak / 2**30, "image_range": [float(raw.min()), float(raw.max())],
               "counts": counts}
        out[name] = row
        log(f"[phase15] (b) text to image {name}: SD 2.1 stock UNet bf16, VAE ch 128, "
            f"OpenCLIP ViT-H text, prompt {prompt!r} and the empty one, CFG {scale}, 512x512, "
            f"{steps} DDIM steps: text {row['clip_s']:.3f} s, {row['ms_a_step']:.2f} ms/step "
            f"(batch 2), decode {row['decode_s']:.3f} s, inversion {inv_steps} steps "
            f"{row['invert_s']:.3f} s; peak {row['peak_gib']:.2f} GiB; image range "
            f"[{row['image_range'][0]:.3g}, {row['image_range'][1]:.3g}] (raw; the inversion "
            f"takes it clamped to [-1, 1]); attention {counts['attention']} ({per_call} a UNet call, all wgmma), "
            f"launches {counts}  [{card}]")
    with torch.device("cuda"):
        unet32 = InflatedUNetDualCond(dataclasses.replace(cfg.unet, dtype=torch.float32)).eval()
        vae32 = AutoencoderKL(dataclasses.replace(cfg.vae, dtype=torch.float32)).eval()
    unet32.load_state_dict(weights32["unet"])
    vae32.load_state_dict(weights32["vae"])
    del weights32
    out["against_plain"] = t2i_against_plain(
        pipe, unet32, vae32, pipe.embed_tokens(torch.from_numpy(tokens)),
        pipe.embed_tokens(torch.from_numpy(empty)), x_T, card)
    del pipe, unet32, vae32
    torch.cuda.empty_cache()
    out["kernel_shapes"] = t2i_kernel_shapes(seen, card)
    return out


def tiny_t2i(device: str, seed: int):
    """The tiny text-to-image pipeline (the CPU tests' widths, float32) with
    seeded weights drawn on the CPU."""
    import torch

    from mgldvsr_tpu_torch.infer.txt2img import Text2ImgConfig, Text2ImgPipeline
    from mgldvsr_tpu_torch.io.init_weights import init_module_weights
    from mgldvsr_tpu_torch.models.cliptext import CLIPTextConfig
    from mgldvsr_tpu_torch.models.unet import UNetConfig
    from mgldvsr_tpu_torch.models.vae import VAEConfig

    cfg = Text2ImgConfig(
        timesteps=100,
        unet=UNetConfig(model_channels=32, num_head_channels=16, context_dim=32, semb_channels=32,
                        channel_mult=(1, 2), attention_resolutions=(1, 2), num_frames=1,
                        use_temporal=False, use_spade=False),
        vae=VAEConfig(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, num_frames=1,
                      enable_fusion=False),
        clip=CLIPTextConfig(width=32, heads=2, layers=2, context_length=8, vocab_size=64))
    cpu = Text2ImgPipeline(cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for tower in cpu.towers().values():
        init_module_weights(tower, gen)
    if device == "cpu":
        return cpu
    pipe = Text2ImgPipeline(cfg, device=device)
    for name, tower in pipe.towers().items():
        tower.load_state_dict(cpu.towers()[name].state_dict())
    return pipe


def t2i_tiny_card_vs_cpu(seed: int, card: str, fused: bool) -> dict:
    """(c) the tiny pipeline, card against CPU: DDIM under guidance 3.0 and
    PLMS from the same x_T, 4 steps, then DDIM inversion of the DDIM image
    (the same posterior noise), each within 1e-3."""
    import torch

    gpu, cpu = tiny_t2i("cuda", seed + 60), tiny_t2i("cpu", seed + 60)
    gen = torch.Generator().manual_seed(seed + 61)
    tokens = torch.randint(1, 64, (2, 8), generator=gen)
    empty = torch.zeros(2, 8, dtype=torch.int64)
    x_T = torch.randn(2, 8, 8, 4, generator=gen)
    noise = torch.randn(2, 8, 8, 4, generator=gen)
    out = {}
    with fused_switch(fused):
        for sampler in ("ddim", "plms"):
            kw = dict(uncond_tokens=empty, cfg_scale=3.0, height=64, width=64, num_steps=4,
                      sampler=sampler)
            got = gpu.generate(tokens.cuda(), x_T=x_T.cuda(), **kw).cpu()
            want = cpu.generate(tokens, x_T=x_T, **kw)
            out[sampler] = max_err(got, want)
            if sampler == "ddim":
                img = want.clamp(-1, 1)
        ctx = cpu.embed_tokens(tokens)
        out["invert"] = max_err(gpu.invert(img.cuda(), ctx.cuda(), num_steps=4,
                                           noise=noise.cuda()).cpu(),
                                cpu.invert(img, ctx, num_steps=4, noise=noise))
    log(f"[phase15] (c) tiny text to image {'fused' if fused else 'default'}, card vs CPU: "
        f"DDIM {out['ddim']:.3e}, PLMS {out['plms']:.3e}, inversion {out['invert']:.3e} "
        f"(limit 1e-3)  [{card}]")
    if max(out.values()) > 1e-3:
        raise AssertionError(f"phase 15 (c): {out}")
    return out


def tiny_encoders(seed: int) -> dict:
    """The tiny alternate encoders, textual inversion's tower input and the
    classifier in its three pools, seeded on the CPU: name -> (module,
    inputs)."""
    import torch

    from mgldvsr_tpu_torch.io.init_weights import init_module_weights
    from mgldvsr_tpu_torch.models import classifier as cls
    from mgldvsr_tpu_torch.models import encoders as enc

    gen = torch.Generator().manual_seed(seed)
    img = torch.rand(2, 40, 36, 3, generator=gen) * 2 - 1
    clip_cfg = enc.CLIPImageConfig(image_size=28, patch_size=14, width=32, heads=2, layers=2,
                                   output_dim=16)
    mods = {
        "class_embedder": (enc.ClassEmbedder(16, 10), (torch.tensor([1, 7, 3]),)),
        "transformer_text": (enc.TransformerTextEmbedder(enc.TransformerTextConfig(
            vocab_size=100, width=32, depth=2, heads=2, max_seq_len=16)),
            (torch.randint(0, 100, (2, 12), generator=gen),)),
        "spatial_rescaler": (enc.SpatialRescaler(2, multiplier=0.5, in_channels=3,
                                                 out_channels=8), (img,)),
        "clip_image": (enc.FrozenClipImageEmbedder(clip_cfg, project_dim=8), (img,)),
    }
    x = torch.randn(2, 16, 16, 4, generator=gen)
    t = torch.tensor([3, 77])
    for pool in ("attention", "adaptive", "spatial"):
        cfg = cls.ClassifierConfig(model_channels=32, num_classes=10, channel_mult=(1, 2),
                                   num_res_blocks=1, attention_resolutions=(2,), pool=pool,
                                   image_size=16)
        mods[f"classifier_{pool}"] = (cls.NoisyLatentClassifier(cfg), (x, t))
    for module, _ in mods.values():
        init_module_weights(module.eval(), gen)
    return mods


def encoders_card_vs_cpu(seed: int, card: str) -> dict:
    """(d) each tiny encoder and the classifier, card against CPU, within
    1e-4 of max |output|; and textual inversion's substitution through the
    tiny text tower of (c) with the gradient in the learned rows."""
    import copy

    import torch

    from mgldvsr_tpu_torch.models import textual_inversion as ti

    out = {}
    with torch.no_grad():
        for name, (module, inputs) in tiny_encoders(seed + 70).items():
            want = module(*inputs)
            got = copy.deepcopy(module).cuda()(*(i.cuda() for i in inputs)).cpu()
            out[name] = max_err(got, want) / float(want.abs().max())
    tower = tiny_t2i("cpu", seed + 71).clip
    ph = {"*": 5}
    tokens = torch.tensor([[1, 5, 2, 0, 0, 0, 0, 0], [5, 5, 3, 9, 0, 0, 0, 0]])
    # a fixed random cotangent: the sum of squares of a LayerNorm's output
    # (unit weights) is constant, and its gradient rounding noise
    cot = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(seed + 72))
    grads = []
    for t, move in ((tower, lambda z: z), (copy.deepcopy(tower).cuda(), lambda z: z.cuda())):
        rows = {k: move(v).requires_grad_(True)
                for k, v in ti.init_placeholder_params(ph, 32, seed=seed).items()}
        tk = move(tokens)
        y = t(tk, ti.apply_single_vector(rows, ph, tk, t.token_embedding(tk)))
        (y * move(cot)).sum().backward()
        grads.append((y.detach().cpu(), rows["*"].grad.cpu()))
    (y_cpu, g_cpu), (y_gpu, g_gpu) = grads
    out["textual_inversion"] = max_err(y_gpu, y_cpu) / float(y_cpu.abs().max())
    out["textual_inversion_grad"] = max_err(g_gpu, g_cpu) / float(g_cpu.abs().max())
    log(f"[phase15] (d) tiny encoders and classifier, card vs CPU (of max |output|, limit "
        f"1e-4): {', '.join(f'{k} {v:.2e}' for k, v in out.items())}  [{card}]")
    if max(out.values()) > 1e-4 or not float(g_cpu.abs().max()) > 0:
        raise AssertionError(f"phase 15 (d): {out}")
    return out


def phase15(seed: int, card: str, host_s: float | None = None) -> dict:
    """The device synthesis and the stock text-to-image path."""
    import tempfile

    t0 = time.perf_counter()
    with part("phase15 (a)"):
        out = {"synthesis": synthesis_full(seed, card, host_s),
               "synthesis_card_vs_cpu": synthesis_card_vs_cpu(seed, card)}
    with part("phase15 (b), (e), (f)"), tempfile.TemporaryDirectory() as tmp:
        out["txt2img"] = t2i_full(seed, card, tmp)
    with part("phase15 (c)"):
        out["tiny_txt2img"] = {f: t2i_tiny_card_vs_cpu(seed, card, f) for f in (False, True)}
    with part("phase15 (d)"):
        out["encoders"] = encoders_card_vs_cpu(seed, card)
    out["wall_s"] = time.perf_counter() - t0
    return out


# -- phase 16: MaskFlownet, deformable convolution, the BasicSR heritage ---------

# (a)'s limits, card against CPU in float32 with TF32 off: the ops, and each
# architecture's outputs relative to their largest |value|
HERITAGE_OP_LIMIT = 1e-5
HERITAGE_ARCH_LIMIT = 1e-4


def seeded_weights(module, seed: int):
    """Fill every trainable parameter from a CPU generator: N(0, 1/fan_in)
    where it has two or more axes, 0.05 N(0, 1) otherwise (fixed
    parameters, ECB's edge masks, stay), so that no branch is zero."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if not p.requires_grad:
                continue
            r = torch.randn(p.shape, generator=gen)
            p.copy_(r / float(np.sqrt(p[0].numel())) if p.dim() >= 2 else 0.05 * r)
    return module.eval()


def heritage_tiny_cases(seed: int) -> dict:
    """The JAX tests' tiny widths (MaskFlownet at its own, as the JAX test
    runs it): name -> (module on the CPU, its inputs, its keyword inputs)."""
    import torch

    from mgldvsr_tpu_torch.flow.maskflownet import MaskFlownetS
    from mgldvsr_tpu_torch.models.heritage import face_archs as fa
    from mgldvsr_tpu_torch.models.heritage import misc_archs as mi
    from mgldvsr_tpu_torch.models.heritage import sr_archs as sr
    from mgldvsr_tpu_torch.models.heritage import stylegan2 as sg
    from mgldvsr_tpu_torch.models.heritage import swinir as sw
    from mgldvsr_tpu_torch.models.heritage import video_archs as va

    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen)

    def flows(t, h, w):
        return tuple(1.5 * torch.randn((1, t - 1, h, w, 2), generator=gen) for _ in range(2))

    dictionary = {str(fs): {p: torch.randn((3, 6, 8, ch), generator=gen) for p in fa.PARTS}
                  for fs, ch in zip(fa.FEATURE_SIZES, fa.CHANNEL_SIZES)}
    boxes = [[4, 8, 20, 24], [36, 8, 56, 24], [20, 24, 40, 44], [12, 44, 52, 60]]
    img = rand(1, 8, 8, 3)
    cases = {
        "RRDBNet": (sr.RRDBNet(num_feat=16, num_block=2, num_grow_ch=8), (rand(1, 16, 16, 3),)),
        "MSRResNet": (sr.MSRResNet(num_feat=16, num_block=2), (img,)),
        "SRVGGNetCompact": (sr.SRVGGNetCompact(num_feat=16, num_conv=2), (img,)),
        "RCAN": (mi.RCAN(num_feat=16, num_group=1, num_block=1), (img,)),
        "UNetDiscriminatorSN": (sr.UNetDiscriminatorSN(num_feat=16), (rand(1, 32, 32, 3),)),
        "BasicVSR": (va.BasicVSR(num_feat=8, num_block=1), (rand(1, 3, 8, 8, 3),) + flows(3, 8, 8)),
        "BasicVSRPlusPlus": (va.BasicVSRPlusPlus(num_feat=8, num_block=1),
                             (rand(1, 3, 8, 8, 3),) + flows(3, 8, 8)),
        "EDVR": (va.EDVR(num_feat=8, num_frame=5, num_extract_block=1, num_reconstruct_block=1,
                         deform_groups=2), (rand(1, 5, 16, 16, 3),)),
        "CouplePropModule": (va.CouplePropModule(num_ch=4, num_feat=8, num_block=2),
                             (rand(1, 4, 8, 8, 4),) + flows(4, 8, 8)),
        "SwinIR": (sw.SwinIR(upscale=4, embed_dim=16, depths=(2,), num_heads=(2,)),
                   (rand(1, 16, 16, 3),)),
        "TOFlow": (mi.TOFlow(), (rand(1, 7, 32, 32, 3),)),
        "DUF": (mi.DUF(scale=4, num_layer=16), (rand(1, 7, 8, 8, 3),)),
        "ECBSR": (mi.ECBSR(num_feat=8, num_block=2), (img,)),
        "RIDNet": (mi.RIDNet(num_feat=16, num_block=1), (img,)),
        "DEResNet": (mi.DEResNet(), (rand(1, 32, 32, 3),)),
        "StyleGAN2Generator": (sg.StyleGAN2Generator(out_size=16, num_style_feat=32, num_mlp=2,
                                                     narrow=0.125),
                               (torch.randn((2, 32), generator=gen),)),
        "StyleGAN2Discriminator": (sg.StyleGAN2Discriminator(in_size=16, narrow=0.125),
                                   (rand(2, 16, 16, 3),)),
        "HiFaceGAN": (fa.HiFaceGAN(num_feat=8), (rand(1, 64, 64, 3) * 2 - 1,)),
        "HiFaceGANDiscriminator": (fa.HiFaceGANDiscriminator(num_feat=8), (rand(1, 64, 64, 6),)),
        "DFDNet": (fa.DFDNet(64, dictionary), (rand(1, 64, 64, 3) * 2 - 1, boxes)),
        "MaskFlownetS": (MaskFlownetS(), (rand(1, 96, 128, 3), rand(1, 96, 128, 3))),
    }
    out = {}
    for i, (name, (module, args)) in enumerate(cases.items()):
        seeded_weights(module, seed + i)
        kwargs = {}
        if name == "StyleGAN2Generator":
            kwargs["noises"] = [torch.randn((1, r, r, 1), generator=gen) for r in
                                (2 ** ((k + 5) // 2) for k in range(module.num_layers))]
        out[name] = (module, args, kwargs)
    return out


def heritage_ops_card_vs_cpu(seed: int, card: str) -> dict:
    """(a) the three ops of the slice, card against CPU."""
    import torch

    from mgldvsr_tpu_torch.flow.maskflownet import local_correlation
    from mgldvsr_tpu_torch.ops.dcn import modulated_deform_conv2d
    from mgldvsr_tpu_torch.ops.stylegan_ops import upfirdn2d

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 7, 9, 16), generator=gen)
    offset = 3.0 * torch.randn((2, 7, 9, 2 * 4 * 9), generator=gen)
    mask = torch.rand((2, 7, 9, 4 * 9), generator=gen)
    weight = torch.randn((8, 16, 3, 3), generator=gen) / 12
    bias = torch.randn((8,), generator=gen)
    f1, f2 = torch.randn((2, 2, 12, 13, 32), generator=gen)
    img, kern = torch.randn((2, 7, 9, 4), generator=gen), torch.rand((4, 4), generator=gen)
    ops = {
        "modulated_deform_conv2d": lambda *a: modulated_deform_conv2d(*a, deform_groups=4),
        "local_correlation": lambda a, b: local_correlation(a, b, 4),
        "upfirdn2d": lambda a, k: upfirdn2d(a, k, up=2, down=1, pad=(2, 1)),
    }
    inputs = {"modulated_deform_conv2d": (x, offset, mask, weight, bias),
              "local_correlation": (f1, f2), "upfirdn2d": (img, kern)}
    out = {}
    for name, fn in ops.items():
        want = fn(*inputs[name])
        got = fn(*(t.cuda() for t in inputs[name])).cpu()
        err = float((got - want).abs().max())
        out[name] = err
        if not err <= HERITAGE_OP_LIMIT:
            raise AssertionError(f"phase 16 (a): {name} card vs CPU {err:.3e} > "
                                 f"{HERITAGE_OP_LIMIT}")
    log(f"[phase16] (a) ops card vs CPU, max |d| (limit {HERITAGE_OP_LIMIT}): "
        f"{ {k: f'{v:.3e}' for k, v in out.items()} }  [{card}]")
    return out


def heritage_tiny_card_vs_cpu(seed: int, card: str) -> dict:
    """(a) every ported architecture at tiny widths, card against CPU, fp32."""
    import copy

    import torch

    def leaves(o):
        if isinstance(o, torch.Tensor):
            return [o]
        if isinstance(o, dict):
            return [t for k in sorted(o) for t in leaves(o[k])]
        return [t for x in o for t in leaves(x)]

    def move(a):
        if isinstance(a, torch.Tensor):
            return a.cuda()
        if isinstance(a, (list, tuple)) and a and isinstance(a[0], torch.Tensor):
            return type(a)(move(t) for t in a)
        return a

    out = {}
    with torch.no_grad():
        for name, (module, args, kwargs) in heritage_tiny_cases(seed).items():
            want = leaves(module(*args, **kwargs))
            card_mod = copy.deepcopy(module).cuda()
            got = leaves(card_mod(*(move(a) for a in args),
                                  **{k: move(v) for k, v in kwargs.items()}))
            scale = max(float(w.abs().max()) for w in want)
            err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want)) / scale
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            out[name] = err
            if len(got) != len(want) or not finite or not err <= HERITAGE_ARCH_LIMIT:
                raise AssertionError(f"phase 16 (a): {name} card vs CPU {err:.3e} of max "
                                     f"|output| (limit {HERITAGE_ARCH_LIMIT}), finite {finite}")
    log(f"[phase16] (a) {len(out)} architectures at tiny widths, card vs CPU in fp32, of max "
        f"|output| (limit {HERITAGE_ARCH_LIMIT}): { {k: f'{v:.2e}' for k, v in out.items()} }  "
        f"[{card}]")
    return out


def timed_run(fn, frames: int, card: str, what: str, reps: int = 2) -> tuple:
    """fn() once to warm, then ``reps`` synchronised runs: (output, ms a
    frame, peak bytes of the runs)."""
    import torch

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (reps * frames)
        peak = torch.cuda.max_memory_allocated()
    outs = out if isinstance(out, (list, tuple)) else [out]
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    log(f"[phase16] (b) {what}: {ms:.2f} ms a frame (warm, synchronised, {reps} runs), peak "
        f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above the weights and inputs), "
        f"finite {finite}  [{card}]")
    if not finite:
        raise AssertionError(f"phase 16 (b): {what} gave non-finite values")
    return out, ms, peak


def heritage_full(seed: int, card: str) -> dict:
    """(b) the published widths on the card, seeded weights, fp32."""
    import tempfile

    import torch

    from mgldvsr_tpu_torch.data.heritage_datasets import VideoRecurrentTestDataset
    from mgldvsr_tpu_torch.flow.maskflownet import MaskFlownetS
    from mgldvsr_tpu_torch.flow.spynet import SpyNet
    from mgldvsr_tpu_torch.io.frames import encode_png
    from mgldvsr_tpu_torch.models.heritage import sr_archs as sr
    from mgldvsr_tpu_torch.models.heritage import stylegan2 as sg
    from mgldvsr_tpu_torch.models.heritage import swinir as sw
    from mgldvsr_tpu_torch.models.heritage import video_archs as va

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        lq = lq_clip(seed + 60, 180, frames=7, width=320)
        for side, clip in (("lq", lq), ("gt", np.repeat(np.repeat(lq, 4, 1), 4, 2))):
            os.makedirs(os.path.join(tmp, side, "000"))
            for i, frame in enumerate(clip):
                with open(os.path.join(tmp, side, "000", f"{i:08d}.png"), "wb") as f:
                    f.write(encode_png((frame * 255).round().astype(np.uint8)))
        spynet = seeded_weights(SpyNet(), seed).to(dev)
        # random weights give flows of hundreds of pixels: calm them as phase 9 does
        calm_spynet(types.SimpleNamespace(spynet=spynet))
        bvpp = seeded_weights(va.BasicVSRPlusPlus(num_feat=64, num_block=7, deform_groups=16),
                              seed + 1).to(dev)

        def video_path():
            item = VideoRecurrentTestDataset(os.path.join(tmp, "gt"), os.path.join(tmp, "lq"))[0]
            lqs = torch.from_numpy(item["lqs"]).to(dev)
            flows_backward = spynet(lqs[:-1], lqs[1:])[None]
            flows_forward = spynet(lqs[1:], lqs[:-1])[None]
            return bvpp(lqs[None], flows_forward, flows_backward)

        hr, out["basicvsrpp_ms"], out["basicvsrpp_peak"] = timed_run(
            video_path, 7, card, "7 PNG frames 180x320 through VideoRecurrentTestDataset, "
            "SpyNet flows and BasicVSR++ (mid 64, 7 blocks, 16 groups) -> 720x1280")
        if tuple(hr.shape) != (1, 7, 720, 1280, 3):
            raise AssertionError(f"phase 16 (b): BasicVSR++ gave {tuple(hr.shape)}")
        del bvpp, spynet, hr
        frames = torch.from_numpy(lq).to(dev)

    edvr = seeded_weights(va.EDVR(num_feat=64, num_frame=5, num_extract_block=5,
                                  num_reconstruct_block=10, deform_groups=8), seed + 2).to(dev)
    y, out["edvr_ms"], out["edvr_peak"] = timed_run(
        lambda: edvr(frames[None, 1:6]), 1, card,
        "EDVR M (64 feat, 5 frames, 8 groups, 5 / 10 blocks), the centre window -> 720x1280")
    assert tuple(y.shape) == (1, 720, 1280, 3), y.shape
    del edvr
    rrdb = seeded_weights(sr.RRDBNet(num_feat=64, num_block=23, num_grow_ch=32), seed + 3).to(dev)
    y, out["rrdbnet_ms"], out["rrdbnet_peak"] = timed_run(
        lambda: rrdb(frames[3:4]), 1, card, "RRDBNet as Real-ESRGAN x4plus (64, 23, 32), "
        "180x320 -> 720x1280")
    assert tuple(y.shape) == (1, 720, 1280, 3), y.shape
    del rrdb
    swin = seeded_weights(sw.SwinIR(upscale=4, embed_dim=180, depths=(6,) * 6,
                                    num_heads=(6,) * 6, window_size=8), seed + 4).to(dev)
    y, out["swinir_ms"], out["swinir_peak"] = timed_run(
        lambda: swin(frames[3:4, :128, :128]), 1, card,
        "SwinIR classical x4 (embed 180, depths and heads 6x6, window 8, mlp 2), 128x128 -> "
        "512x512")
    assert tuple(y.shape) == (1, 512, 512, 3), y.shape
    del swin
    mfn = seeded_weights(MaskFlownetS(), seed + 5).to(dev)
    pair = torch.rand((2, 1, 512, 512, 3), generator=gen, device=dev)
    y, out["maskflownet_ms"], out["maskflownet_peak"] = timed_run(
        lambda: mfn(pair[0], pair[1]), 1, card, "MaskFlownet_S, a 512x512 pair")
    assert tuple(y.shape) == (1, 512, 512, 2), y.shape
    del mfn
    g = seeded_weights(sg.StyleGAN2Generator(out_size=512, num_style_feat=512, num_mlp=8,
                                             channel_multiplier=2), seed + 6).to(dev)
    z = torch.randn((1, 512), generator=gen, device=dev)
    noises = [torch.randn((1, r, r, 1), generator=gen, device=dev)
              for r in (2 ** ((k + 5) // 2) for k in range(g.num_layers))]
    y, out["stylegan2_ms"], out["stylegan2_peak"] = timed_run(
        lambda: g(z, noises=noises), 1, card,
        "StyleGAN2 generator, out 512, channel multiplier 2, injected noise")
    assert tuple(y.shape) == (1, 512, 512, 3), y.shape
    del g
    torch.cuda.empty_cache()
    return out


def phase16(seed: int, card: str) -> dict:
    """MaskFlownet, the deformable conv and the BasicSR heritage."""
    from mgldvsr_tpu_torch.utils.precision import tf32_off

    t0 = time.perf_counter()
    with tf32_off():
        with part("phase16 (a)"):
            out = {"ops": heritage_ops_card_vs_cpu(seed, card),
                   "tiny": heritage_tiny_card_vs_cpu(seed, card)}
        with part("phase16 (b)"):
            out["full"] = heritage_full(seed, card)
    out["wall_s"] = time.perf_counter() - t0
    return out


# -- phase 17: the native clip loader and the runtime extras ------------------



def header_check() -> dict:
    """The codec headers under /usr/include and the codec libraries the
    dynamic linker knows."""
    import re
    import shutil

    headers = {h: os.path.isfile(os.path.join("/usr/include", h))
               for h in ("png.h", "jpeglib.h", "zlib.h")}
    ldconfig = shutil.which("ldconfig") or "/sbin/ldconfig"
    try:
        out = subprocess.run([ldconfig, "-p"], capture_output=True, text=True,
                             timeout=60).stdout
    except OSError as e:
        out = f"({e})"
    libs = sorted({line.split()[0] for line in out.splitlines()
                   if re.search(r"libpng|libjpeg|libz\.", line)})
    return {"headers": headers, "libraries": libs}


def loader_build(card: str) -> dict:
    """(a) The library built from the checkout; its codecs and the header
    check."""
    from mgldvsr_tpu_torch import native

    check = header_check()
    t0 = time.perf_counter()
    path = native.build_native()
    secs = time.perf_counter() - t0
    out = {"library": os.path.basename(path), "build_s": secs, "found": native.found_codecs(),
           "codecs": native.codecs(), **check}
    log(f"[phase17] (a) native loader built with g++ in {secs:.2f} s: {out['library']}, codecs "
        f"{out['codecs']} (headers found by the compiler {out['found']}); /usr/include "
        f"{check['headers']}; ldconfig {check['libraries']}  [{card}]")
    if tuple(out["codecs"]) != tuple(out["found"]):
        raise AssertionError(f"phase 17 (a): codecs {out['codecs']} but headers {out['found']}")
    return out


def loader_against_python(card: str, tmp: str, codecs) -> dict:
    """(b) Every frame's decode and clips (each flip, the transpose, tickets
    fetched out of order) against the Python path, bit for bit."""
    from mgldvsr_tpu_torch.data.file_client import PackedBackend, imfrombytes
    from mgldvsr_tpu_torch.native.loader import NativeClipLoader, pack_image_dir

    root, pk = os.path.join(tmp, "b_gt"), os.path.join(tmp, "b_pk")
    train_clips(root, 50, clips=2, frames=4, size=96)
    pack_image_dir(root, pk)
    backend = PackedBackend(pk)
    keys = sorted(backend.keys())
    if "png" not in codecs:
        try:
            NativeClipLoader(pk).decode(keys[0])
        except IOError as e:
            log(f"[phase17] (b) no PNG codec: decode raises {e}  [{card}]")
            return {"skipped": "no png codec"}
        raise AssertionError("phase 17 (b): a PNG record decoded without the PNG codec")
    want = {k: imfrombytes(backend.get(k), float32=True) for k in keys}
    loader = NativeClipLoader(pk, 3)
    same = all(np.array_equal(loader.decode(k), want[k]) for k in keys)
    window = keys[:4]
    cases = [(t % 5, t % 7, 40 + t % 9, 48, bool(t & 1), bool(t & 2), bool(t & 4))
             for t in range(16)]
    tickets = [loader.submit_clip(window, top, left, ch, cw, hflip=hf, vflip=vf, transpose=tr)
               for top, left, ch, cw, hf, vf, tr in cases]
    clips_same = True
    for (top, left, ch, cw, hf, vf, tr), ticket in reversed(list(zip(cases, tickets))):
        ref = np.stack([want[k][top:top + ch, left:left + cw] for k in window])
        ref = ref[:, :, ::-1] if hf else ref
        ref = ref[:, ::-1] if vf else ref
        ref = ref.transpose(0, 2, 1, 3) if tr else ref
        clips_same &= bool(np.array_equal(loader.fetch(ticket), ref))
    loader.close()
    log(f"[phase17] (b) {len(keys)} frames against the Python decode, bit for bit {same}; "
        f"{len(cases)} clips of 4 frames (flips, transpose, fetched in reverse) bit for bit "
        f"{clips_same}  [{card}]")
    if not (same and clips_same):
        raise AssertionError("phase 17 (b): the native loader disagrees with the Python path")
    return {"decode_equal": same, "clips_equal": clips_same}


def loader_dataset(card: str, tmp: str, codecs) -> dict:
    """(c) RealVSRRecurrentDataset on the packed frames through
    prefetch_iterator's spawned workers against the disk path."""
    from mgldvsr_tpu_torch.data.datasets import RealVSRRecurrentDataset, prefetch_iterator
    from mgldvsr_tpu_torch.native.loader import pack_image_dir

    root, pk = os.path.join(tmp, "c_gt"), os.path.join(tmp, "c_pk")
    train_clips(root, 60, clips=2, frames=6, size=96)
    pack_image_dir(root, pk)
    deg = {"random_blur": {"params": {"prob": 1.0, "kernel_size": [3], "kernel_list": ["iso"],
                                      "kernel_prob": [1.0], "sigma_x": [0.4, 1.0],
                                      "sigma_y": [0.4, 1.0], "rotate_angle": [-3.14, 3.14]}}}
    kw = dict(num_frame=3, gt_size=64, use_hflip=True, use_rot=True, val_partition="none",
              degradation_1=deg, seed=5)
    disk = RealVSRRecurrentDataset(root, **kw)
    packed = RealVSRRecurrentDataset(root, packed_root=pk, io_threads=2, **kw)
    want = "native" if "png" in codecs else "python"
    order = [3, 0, 2, 1]
    t0 = time.perf_counter()
    items = list(prefetch_iterator(packed, order, num_workers=2))
    secs = time.perf_counter() - t0
    err = max(float(np.abs(item[k] - disk[i][k]).max())
              for i, item in zip(order, items) for k in ("lqs", "gts"))
    log(f"[phase17] (c) dataset read path {packed.read_path} (want {want}); {len(order)} "
        f"samples through 2 spawned workers in {secs:.2f} s, max |d| against the disk path "
        f"{err:.3e} (limit 1e-6)  [{card}]")
    if packed.read_path != want or err > 1e-6:
        raise AssertionError("phase 17 (c): the packed dataset disagrees with the disk path")
    return {"read_path": packed.read_path, "max_abs_err": err, "prefetch_s": secs}


def loader_train_cli(card: str, tmp: str) -> dict:
    """(d) The training command line, stage 1 --tiny, on packed frames read
    by the native pool of 2 threads; the kernels it launches."""
    import io

    import torch

    from mgldvsr_tpu_torch.cli import train as cli
    from mgldvsr_tpu_torch.native.loader import pack_image_dir
    from mgldvsr_tpu_torch.ops import kernels

    root, pk = os.path.join(tmp, "d_gt"), os.path.join(tmp, "d_pk")
    train_clips(root, 40, clips=2, frames=6, size=48)
    pack_image_dir(root, pk)
    logdir = os.path.join(tmp, "d_run")
    said = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        cli.main(["--stage", "1", "--data-root", root, "--tiny", "--max-steps", "2",
                  "--grad-accum", "1", "--ckpt-every", "2", "--log-every", "1", "--no-tb",
                  "--logdir", logdir, "--set", f"data.packed_root={pk}",
                  "--set", "data.io_threads=2"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    path_line = [ln for ln in said.getvalue().splitlines() if ln.startswith("data:")]
    log(f"[phase17] (d) training CLI --tiny, 2 micro-steps on packed frames: {path_line}; "
        f"losses {[round(r['loss'], 4) for r in records]}; launches {counts}; {secs:.2f} s  "
        f"[{card}]")
    if [r["step"] for r in records] != [1, 2] or not all(np.isfinite(r["loss"])
                                                          for r in records):
        raise AssertionError(f"phase 17 (d): metrics {records}")
    if not path_line or not counts.get("fused_group_norm"):
        raise AssertionError(f"phase 17 (d): read path {path_line}, launches {counts}")
    return {"counts": kernels.launch_counts(), "read_path_line": path_line[0], "wall_s": secs}


TRACE_REPEATS = 5  # (e)'s traces in this process, each held


TRACE_ONE_CALL = r"""
import json, os, sys
import torch
import chip_smoke
from mgldvsr_tpu_torch.ops.kernels.groupnorm import fused_group_norm
from mgldvsr_tpu_torch.utils.profiling import trace
args = chip_smoke.trace_gn_args(torch)
fused_group_norm(*args)
with trace(sys.argv[1]):
    fused_group_norm(*args)
with open(os.path.join(sys.argv[1], "trace.json")) as f:
    events = json.load(f)["traceEvents"]
print(json.dumps(sorted({e["name"] for e in events if e.get("cat") == "kernel"})))
"""


def start_trace_run(logdir: str) -> subprocess.Popen:
    """(e)'s held trace of one fused_group_norm call in a fresh interpreter,
    started early: its start-up runs beside (b)-(d)."""
    return subprocess.Popen([sys.executable, "-c", TRACE_ONE_CALL, logdir],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def trace_gn_args(torch):
    """One fused_group_norm call's arguments: [2,128,64,64] f32, 32 groups."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 128, 64, 64, device="cuda", generator=gen)
    return x, torch.ones(128, device="cuda"), torch.zeros(128, device="cuda"), 32, 1e-6


def profiling_checks(card: str, tmp: str, trace_run: subprocess.Popen) -> dict:
    """(e) StepTimer over a device sleep, device_memory_stats' peak over an
    allocation, and ``TRACE_REPEATS`` traces of one fused_group_norm call
    with torch's own ``mul_`` beside it in this process, after every earlier
    phase's profiler sessions, CUDA graph captures and process groups, as a
    user's long training process would take them: each must name both
    kernels. The same trace in a fresh interpreter (``trace_run``'s) too."""
    import torch

    from mgldvsr_tpu_torch.ops.kernels.groupnorm import fused_group_norm
    from mgldvsr_tpu_torch.utils.profiling import StepTimer, device_memory_stats, trace

    args = trace_gn_args(torch)
    fused_group_norm(*args)  # warm

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles = int(10_000_000 * 50 / start.elapsed_time(end))  # ~50 ms
    timer = StepTimer()
    marker = torch.zeros(1, device="cuda")
    timer.start()
    torch.cuda._sleep(cycles)
    marker += 1
    timer.stop(marker)
    timed_ms = 1000 * timer.best

    torch.cuda.reset_peak_memory_stats()
    block = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    stats = device_memory_stats()
    del block

    names, skews, launch_calls = [], [], []
    for i in range(TRACE_REPEATS):
        logdir = os.path.join(tmp, f"e_trace{i}")
        with trace(logdir):  # raises where the session holds launch calls and no kernel
            fused_group_norm(*args)
            args[0].mul_(1.0)  # one of torch's own kernels beside it
        with open(os.path.join(logdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        names.append(sorted({e["name"] for e in kernels}))
        launch_calls.append(sum(1 for e in events if e.get("cat") == "cuda_runtime"
                                and "Launch" in e.get("name", "")))
        # the kernel's start less its launch call's, in µs
        launches = {e["args"]["correlation"]: e["ts"] for e in events
                    if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
        skews.append([round(e["ts"] - launches[e["args"]["correlation"]], 1) for e in kernels
                      if e.get("args", {}).get("correlation") in launches])
    out, err = trace_run.communicate(timeout=300)
    if trace_run.returncode:
        raise AssertionError(f"phase 17 (e): the trace run exited {trace_run.returncode}: "
                             f"{err[-2000:]}")
    fresh = json.loads(out.strip().splitlines()[-1])
    short = [[n[:60] for n in trace_names] for trace_names in names]
    log(f"[phase17] (e) StepTimer over a ~50 ms device sleep: {timed_ms:.1f} ms (at least 40); "
        f"device_memory_stats after a 256 MiB allocation {stats}; a fresh interpreter's trace: "
        f"{fresh}; in this process {TRACE_REPEATS} traces of a fused_group_norm call and a "
        f"torch mul_: kernels {short}, launch calls {launch_calls}; kernel start less launch, "
        f"us: {skews}  [{card}]")
    if timed_ms < 40 or stats["peak_bytes_in_use"] < 256 * 2**20 or not stats["bytes_limit"]:
        raise AssertionError(f"phase 17 (e): timer {timed_ms} ms, memory {stats}")
    if not any("group_norm_kernel" in n for n in fresh):
        raise AssertionError(f"phase 17 (e): the fresh trace names no GroupNorm kernel: {fresh}")
    for i, trace_names in enumerate(names):
        if not (any("group_norm_kernel" in n for n in trace_names)
                and any("MulFunctor" in n for n in trace_names)):
            raise AssertionError(f"phase 17 (e): in-process trace {i} names {short[i]}, not the "
                                 f"GroupNorm kernel and torch's mul_ kernel")
    return {"timer_ms": timed_ms, "memory": stats, "trace_kernels": fresh,
            "trace_kernels_in_process": short, "trace_launch_calls": launch_calls,
            "trace_skew_us": skews}


def phase17(card: str) -> dict:
    """The native clip loader, the dataset and training CLI on it, the
    profiling hooks and the loader benchmark."""
    from mgldvsr_tpu_torch.tools import loader_bench

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = {"build": loader_build(card)}
        trace_run = start_trace_run(os.path.join(tmp, "e_trace"))
        try:
            codecs = out["build"]["codecs"]
            with part("phase17 (b), (c)"):
                out["loader"] = loader_against_python(card, tmp, codecs)
                out["dataset"] = loader_dataset(card, tmp, codecs)
            with part("phase17 (d)"):
                out["train"] = loader_train_cli(card, tmp)
            with part("phase17 (e)"):
                out["profiling"] = profiling_checks(card, tmp, trace_run)
        finally:
            if trace_run.poll() is None:
                trace_run.kill()
                trace_run.wait()
    with part("phase17 (f)"):
        out["bench"] = loader_bench.run(loader_bench.parse_args(["--busy", "cuda"]))
    log(f"[phase17] (f) loader_bench (5 frames, 360 px source, 128 crop, 40 clips, 4 threads; "
        f"the busy main thread a CUDA matmul loop): {json.dumps(out['bench'])}  [{card}]")
    out["wall_s"] = time.perf_counter() - t0
    return out


# -- phase 18: MGLD_INT8_CONV ----------------------------------------------------


def int8_pipeline(seed: int, steps: int):
    """Phase 4's pipeline built under MGLD_INT8_CONV=1 (the switch is read
    when a conv is built): the same seeded float32 weights, each int8 site's
    levels taken from them by the cast to bf16."""
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights

    before = os.environ.get("MGLD_INT8_CONV")
    os.environ["MGLD_INT8_CONV"] = "1"
    try:
        pipe = MGLDVSRPipeline(full_config(steps))
    finally:
        if before is None:
            del os.environ["MGLD_INT8_CONV"]
        else:
            os.environ["MGLD_INT8_CONV"] = before
    init_pipeline_weights(pipe, seed)
    calm_raft(pipe)
    pipe.cast_to_compute_dtypes()
    return pipe


def int8_restore(pipe, frames, seed: int, card: str, what: str):
    """One restore (the pipeline's steps) in the default configuration:
    (frames, launch counts, stage seconds, the int8 modules' calls by
    tower and module, the shapes each int8 conv was given)."""
    import torch

    from mgldvsr_tpu_torch.models.layers import Int8Conv3x3
    from mgldvsr_tpu_torch.ops import kernels

    calls, shapes, hooks = {}, set(), []
    for tower in ("unet", "structcond", "vae"):
        for name, m in pipe.towers()[tower].named_modules():
            if isinstance(m, Int8Conv3x3):
                def hook(mod, args, key=(tower, name)):
                    calls[key] = calls.get(key, 0) + 1
                    x = args[0]
                    shapes.add((key[0], tuple(x.shape), str(x.dtype).replace("torch.", ""),
                                mod.out_channels, mod.stride[0]))
                hooks.append(m.register_forward_pre_hook(hook))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    stages: dict = {}
    try:
        with fused_switch(False):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = pipe.restore_segment(frames, gen, stage_seconds=stages)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
    finally:
        for h in hooks:
            h.remove()
    log(f"[phase18] {what}: 512x512, 5 frames: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"; total {wall:.3f} s  [{card}]")
    return out, counts, stages, calls, shapes


def int8_case(x, wt, bias, stride: int, out_dtype) -> dict:
    """One int8 conv shape on the card: the chain, the absmax and the conv
    kernel alone against the plain version bit for bit (y; the levels,
    through an identity kernel on the first channels; the int32 sums,
    through the conv kernel alone on the levels with sx = sw = 1), timed
    beside the plain version, the bound and the yardsticks (``torch._int_mm``
    of the im2col'd levels, cuDNN's bf16 conv)."""
    import torch
    import torch.nn.functional as F

    from mgldvsr_tpu_torch.ops.kernels import int8_conv as K

    dev = x.device
    n, c, h, w = x.shape
    co = wt.shape[0]
    kq, sw = K.quantize_weight(wt)
    ho, wo = K.output_size(h, w, stride)
    want = K.int8_conv3x3_plain(x, kq, sw, bias, stride, out_dtype)
    got = K.int8_conv3x3(x, kq, sw, bias, stride, out_dtype)
    amax = K.int8_absmax(x)
    xq, sx = K.quantize_activation(x)
    kq_cpu, sw_cpu = K.quantize_weight(wt.cpu())
    checks = {"y": torch.equal(got, want),
              "absmax": torch.equal(amax, x.abs().amax().float().reshape(1)),
              "weight_levels_as_cpu": torch.equal(kq.cpu(), kq_cpu) and torch.equal(sw.cpu(),
                                                                                     sw_cpu)}
    # the int32 sums: the levels as x, sx = 1 (max|x| taken as 127), sw = 1, no bias
    one = torch.tensor([127.0], device=dev).view(torch.int32)
    acc = K.conv_alone(xq.to(x.dtype).contiguous(), one, kq, torch.ones_like(sw),
                       torch.zeros_like(bias), stride, torch.float32)
    checks["acc"] = torch.equal(acc, K.int8_accumulate(xq, kq, stride).float())
    # the levels: an identity kernel on the first channels gives xq * sx
    m = min(c, 32)
    ident = torch.zeros(m, c, 3, 3, dtype=torch.int8, device=dev)
    ident[torch.arange(m), torch.arange(m), 1, 1] = 1
    lv = K.int8_conv3x3(x, ident, torch.ones(m, device=dev), torch.zeros(m, device=dev), stride,
                        torch.float32)
    checks["levels"] = torch.equal(torch.round(lv / sx).to(torch.int8),
                                   xq[:, :m, ::stride, ::stride])
    r = {"shape": f"[{n},{c},{h},{w}]->{co}" + (f" s{stride}" if stride > 1 else ""),
         "dtype": f"{str(x.dtype)[6:]}->{str(out_dtype)[6:]}", "bit_for_bit": checks,
         "max_abs_err": max_err(got, want)}
    ops = 2 * 9 * c * co * n * ho * wo
    conv_bytes = nbytes(x, kq, sw, bias, got)
    r["bound_ms"], r["bound_by"] = bound(conv_bytes, ops, "int8")
    r["absmax_bound_ms"], _ = bound(nbytes(x), n * c * h * w, "bf16")
    iters = 10 if ops > 1e11 else 20
    r["ms"] = cuda_ms(lambda: K.int8_conv3x3(x, kq, sw, bias, stride, out_dtype), iters=iters)
    r["device_ms"] = graph_ms(lambda: K.int8_conv3x3(x, kq, sw, bias, stride, out_dtype),
                              iters=iters)
    r["absmax_ms"] = cuda_ms(lambda: K.int8_absmax(x), iters=iters)
    r["absmax_device_ms"] = graph_ms(lambda: K.int8_absmax(x), iters=iters)
    r["conv_alone_ms"] = cuda_ms(lambda: K.conv_alone(x, amax.view(torch.int32), kq, sw, bias,
                                                      stride, out_dtype), iters=iters)
    r["tops"] = ops / r["device_ms"] / 1e9
    r["plain_ms"] = cuda_ms(lambda: K.int8_conv3x3_plain(x, kq, sw, bias, stride, out_dtype),
                            iters=2, warmup=1)
    r["absmax_library_ms"] = cuda_ms(lambda: x.abs().amax(), iters=iters)
    # yardsticks: torch._int_mm on the im2col'd levels ([M, K] x [K, Co], K and
    # Co padded to multiples of 8), cuDNN's bf16 conv at the same shape
    k_pad, co_pad = -(-9 * c // 8) * 8, -(-co // 8) * 8
    cols = F.unfold(xq.to(torch.float16), 3, padding=1, stride=stride)  # [n, 9c, L]
    a = torch.zeros(n * ho * wo, k_pad, dtype=torch.int8, device=dev)
    a[:, :9 * c] = cols.transpose(1, 2).reshape(-1, 9 * c).to(torch.int8)
    del cols
    b = torch.zeros(k_pad, co_pad, dtype=torch.int8, device=dev)
    b[:9 * c, :co] = kq.reshape(co, 9 * c).t()
    try:  # a yardstick only: a shape torch._int_mm refuses is recorded, not a failure
        r["int_mm_ms"] = round(cuda_ms(lambda: torch._int_mm(a, b), iters=iters), 4)
    except RuntimeError as err:
        r["int_mm_ms"] = f"refused: {str(err).splitlines()[0]}"
    del a, b
    xb, wb = x.to(torch.bfloat16), wt.to(torch.bfloat16)
    bb = bias.to(torch.bfloat16)
    r["cudnn_bf16_ms"] = cuda_ms(lambda: F.conv2d(xb, wb, bb, stride=stride, padding=1),
                                 iters=iters)
    return r


def int8_shapes(shapes: set) -> list:
    """The conv shapes phase 18 holds: the largest by work of each tower, the
    Cin 3 and 4 convs, the largest at stride 2, the 32-channel output convs
    (the RDB's growth convs) of most and least work, the largest of at most 8
    output channels and the largest on frames up to 8 pixels wide."""
    def work(sh):
        _, (n, c, h, w), _, co, st = sh
        return n * c * h * w * co / st / st

    picked = []

    def pick(cands, most=True):
        cands = sorted(cands, key=work)
        if cands:
            sh = cands[-1] if most else cands[0]
            if sh not in picked:
                picked.append(sh)

    for tower in ("vae", "unet", "structcond"):
        pick([sh for sh in shapes if sh[0] == tower])
    for cin in (3, 4):
        pick([sh for sh in shapes if sh[1][1] == cin])
    pick([sh for sh in shapes if sh[4] == 2])
    grow = [sh for sh in shapes if sh[3] == 32]
    pick(grow)
    pick(grow, most=False)
    pick([sh for sh in shapes if sh[3] <= 8])
    pick([sh for sh in shapes if (sh[1][3] - 1) // sh[4] + 1 <= 8])
    return picked


def phase18(pipe16, frames, seed: int, card: str) -> dict:
    """MGLD_INT8_CONV=1 at full width (docstring, Phase 18)."""
    import torch

    from mgldvsr_tpu_torch.models.layers import Int8Conv3x3

    steps = 10
    out = {}
    with part("phase18 pipeline"):
        pipe = int8_pipeline(seed, steps)
    mods = {(tower, name): m for tower in ("unet", "structcond", "vae")
            for name, m in pipe.towers()[tower].named_modules() if isinstance(m, Int8Conv3x3)}
    # nothing quantized from bf16: every site holds levels taken from its float32
    # weight before the cast, valid for the bf16 weight it holds now
    for key, m in mods.items():
        if m.weight.dtype != torch.bfloat16 or m._levels is None:
            raise AssertionError(f"phase 18: {key} holds no levels from float32 weights")
        m.levels()
    with part("phase18 restores"), sampler_steps(pipe16, steps):
        ref, ref_counts, ref_stages, _, _ = int8_restore(pipe16, frames, seed, card,
                                                            f"phase 4's pipeline, {steps} steps")
        got, counts, stages, calls, shapes = int8_restore(pipe, frames, seed, card,
                                                             f"int8 convs, {steps} steps")
    if got.shape != (5, 512, 512, 3) or not torch.isfinite(got).all() or got.min() < 0 \
            or got.max() > 1:
        raise AssertionError("phase 18: the int8 restore is not finite [5,512,512,3] in [0, 1]")
    # every mapped site: once a UNet (and struct-cond) call, once in the encode or decode
    for (tower, name), m in mods.items():
        want = steps if tower in ("unet", "structcond") else 1
        if calls.get((tower, name), 0) != want:
            raise AssertionError(f"phase 18: {tower}.{name} ran {calls.get((tower, name), 0)} "
                                 f"times, expected {want}")
    total = sum(calls.values())
    if not counts["int8_conv3x3"] == counts["int8_absmax"] == total:
        raise AssertionError(f"phase 18: int8 launches {counts['int8_absmax']} / "
                             f"{counts['int8_conv3x3']}, expected one each for the {total} calls")
    for name in KERNELS:
        if (counts[name] == 0) != (name in FUSED_ONLY + STANDALONE):
            raise AssertionError(f"phase 18: kernel {name} was launched {counts[name]} times")
    if any(ref_counts[name] for name in INT8_ONLY):
        raise AssertionError("phase 18: phase 4's pipeline launched an int8 kernel")
    diff = (got - ref).abs()
    out.update(counts=counts, sites=len(mods), calls=total, launches_a_step=sum(
        n for (tower, _), n in calls.items() if tower != "vae") // steps,
        sampler_ms_per_step=1000 * stages["sampler"] / steps,
        phase4_sampler_ms_per_step=1000 * ref_stages["sampler"] / steps,
        mean_abs_vs_phase4=float(diff.mean()), max_abs_vs_phase4=float(diff.max()))
    log(f"[phase18] {len(mods)} int8 sites, {total} calls, every one on the kernel "
        f"({counts['int8_conv3x3']} conv and {counts['int8_absmax']} absmax launches; "
        f"{out['launches_a_step']} a sampler step); sampler {out['sampler_ms_per_step']:.2f} "
        f"ms/step against phase 4's pipeline {out['phase4_sampler_ms_per_step']:.2f} at the "
        f"same {steps} steps; |int8 - phase 4| mean {out['mean_abs_vs_phase4']:.4e} max "
        f"{out['max_abs_vs_phase4']:.4e} (no limit)  [{card}]")
    del pipe, mods, got, ref
    torch.cuda.empty_cache()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = {}
    with part("phase18 kernels"):
        for tower, shape, dtype, co, stride in int8_shapes(shapes):
            n, c, h, w = shape
            x = torch.randn(shape, device=dev, generator=gen).to(getattr(torch, dtype))
            wt = torch.randn(co, c, 3, 3, device=dev, generator=gen) / (9 * c) ** 0.5
            bias = 0.1 * torch.randn(co, device=dev, generator=gen)
            r = int8_case(x, wt, bias, stride, torch.bfloat16)
            r["tower"] = tower
            cases[r["shape"]] = r
            log(f"[phase18] {tower} {r['shape']} {r['dtype']}: bit for bit {r['bit_for_bit']}; "
                f"chain {r['ms']:.4f} ms (device {r['device_ms']:.4f}, {r['tops']:.1f} TOPS), "
                f"absmax {r['absmax_ms']:.4f} (device {r['absmax_device_ms']:.4f}, bound "
                f"{r['absmax_bound_ms']:.4f}, x.abs().amax() {r['absmax_library_ms']:.4f}), "
                f"conv alone {r['conv_alone_ms']:.4f}, bound {r['bound_ms']:.4f} "
                f"({r['bound_by']}), plain {r['plain_ms']:.4f}; yardsticks torch._int_mm "
                f"{r['int_mm_ms']}, cuDNN bf16 {r['cudnn_bf16_ms']:.4f}  [{card}]")
            if not all(r["bit_for_bit"].values()):
                raise AssertionError(f"phase 18: {r['shape']} differs from the plain version: "
                                     f"{r['bit_for_bit']}")
            del x, wt
    out["cases"] = cases
    first = next(r for r in cases.values() if r["tower"] == "vae")
    worst = max(r["max_abs_err"] for r in cases.values())
    out["results"] = {
        "int8_conv3x3": {"shape": first["shape"], "max_abs_err": worst, "ms": first["ms"],
                         "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
                         "bound_by": first["bound_by"], "library_ms": None,
                         "device_ms": first["device_ms"], "int_mm_ms": first["int_mm_ms"],
                         "cudnn_bf16_ms": first["cudnn_bf16_ms"], "shapes": cases},
        "int8_absmax": {"shape": first["shape"].split("->")[0], "max_abs_err": 0.0,
                        "ms": first["absmax_ms"], "plain_ms": first["absmax_library_ms"],
                        "bound_ms": first["absmax_bound_ms"], "bound_by": "bytes",
                        "library_ms": first["absmax_library_ms"],
                        "device_ms": first["absmax_device_ms"]},
    }
    return out



def straight_runs(seed: int, card: str, keep: dict) -> None:
    """Phases 8 (b) and 9 (b)'s straight runs alone, kept for phase 12."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        data_root = os.path.join(tmp, "gt")
        train_clips(data_root, seed)
        final, _, seen = train_full(seed, card, data_root, os.path.join(tmp, "b"), 8,
                                    snapshot_at=4)
        keep["stage1"] = {"final": to_host(final), **seen}
        del final
        roots = stage2_data(os.path.join(keep["dir"], "s2"), seed)
        final, _, seen = stage2_full(seed, card, roots, os.path.join(tmp, "s2b"), 8, fused=False,
                                     snapshot_at=4)
        keep["stage2"] = {"final": to_host(final), "roots": roots, **seen}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="respaced DDPM steps of phases 4, 5 and 6 (a)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only-train", action="store_true",
                    help="build the kernels and run phases 8 and 9 alone (no result line)")
    ap.add_argument("--only-stage2", action="store_true",
                    help="build the kernels and run phase 9 alone (no result line)")
    ap.add_argument("--only-quality", action="store_true",
                    help="build the kernels and run phases 4 and 5's restores and phase 10 "
                         "alone (no result line)")
    ap.add_argument("--only-parallel", action="store_true",
                    help="build the kernels and run phase 11 alone on phase 4's weights (no "
                         "result line)")
    ap.add_argument("--only-train-parallel", action="store_true",
                    help="build the kernels and run phases 8 (b) and 9 (b)'s straight runs and "
                         "phase 12 (no result line)")
    ap.add_argument("--only-attention", action="store_true",
                    help="build the kernels and run phase 2's attention checks and the "
                         "head-dim-512 kernels alone (no result line)")
    ap.add_argument("--only-fp32", action="store_true",
                    help="build the kernels and run phases 13 and 14 alone (no result line)")
    ap.add_argument("--only-txt2img", action="store_true",
                    help="build the kernels and run phase 15 alone (no result line)")
    ap.add_argument("--only-loader", action="store_true",
                    help="build the kernels and run phase 17 alone: the native clip loader, "
                         "the profiling hooks and the loader benchmark (no result line)")
    ap.add_argument("--only-int8", action="store_true",
                    help="build the kernels and run phase 18 alone on phase 4's weights (no "
                         "result line)")
    ap.add_argument("--only-heritage", action="store_true",
                    help="run phase 16 alone: MaskFlownet, the deformable conv and the "
                         "BasicSR heritage (no kernel build, no result line)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from mgldvsr_tpu_torch.ops.kernels import _build

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[phase0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; tf32 off for matmul and cuDNN")

    times: dict = {}
    if args.only_heritage:
        with wall("phase16", card, times):
            log(json.dumps(phase16(args.seed, card), default=str))
        return 0
    so, secs = _build.build()
    _build.library()
    log(f"[phase1] built {so.name} in {secs:.2f} s (nvcc, sm_90a)")
    if args.only_loader:
        with wall("phase17", card, times):
            log(json.dumps(phase17(card), default=str))
        return 0
    if args.only_train or args.only_stage2:
        if args.only_train:
            with wall("phase8", card, times):
                log(json.dumps(phase8(args.seed, card), default=str))
        with wall("phase9", card, times):
            log(json.dumps(phase9(args.seed, card), default=str))
        return 0
    if args.only_quality:
        pipe, frames = full_pipeline(args.seed, args.steps)
        out4, _ = full_restore(pipe, frames, args.seed, args.steps, card, fused=False)
        out5, _ = full_restore(pipe, frames, args.seed, args.steps, card, fused=True)
        with wall("phase10", card, times):
            log(json.dumps(phase10(pipe, frames, out4, out5, card), default=str))
        return 0
    if args.only_parallel:
        pipe, frames = full_pipeline(args.seed, args.steps)
        with wall("phase11", card, times):
            log(json.dumps(phase11(pipe, frames, args.seed, card), default=str))
        return 0
    if args.only_attention:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        attention_checks(dev, gen)
        log(json.dumps(wide_attention(dev, gen, card)))
        return 0
    if args.only_fp32:
        pipe, frames = full_pipeline(args.seed, args.steps)
        with wall("phase13", card, times):
            log(json.dumps(phase13(pipe, frames, args.seed, args.steps, card), default=str))
        del pipe, frames
        with wall("phase14", card, times):
            log(json.dumps(phase14(card), default=str))
        return 0
    if args.only_txt2img:
        with wall("phase15", card, times):
            log(json.dumps(phase15(args.seed, card), default=str))
        return 0
    if args.only_int8:
        pipe, frames = full_pipeline(args.seed, args.steps)
        with wall("phase18", card, times):
            log(json.dumps(phase18(pipe, frames, args.seed, card), default=str))
        return 0
    if args.only_train_parallel:
        with tempfile.TemporaryDirectory() as tmp:
            keep = {"dir": tmp}
            straight_runs(args.seed, card, keep)
            with wall("phase12", card, times):
                log(json.dumps(phase12(args.seed, card, keep), default=str))
        return 0

    with wall("phase2", card, times):
        results = phase2(card)
    with wall("phase3", card, times):
        for fused in (False, True):
            phase3(args.seed, card, fused=fused)
            phase3_tile(args.seed, card, fused=fused)
    with wall("phase4", card, times):
        pipe, frames = full_pipeline(args.seed, args.steps)
        out4, counts4 = full_restore(pipe, frames, args.seed, args.steps, card, fused=False)
        guidance_check(pipe, frames, args.seed)
        counts_latent = full_latent_restore(pipe, frames, args.seed, args.steps, card)
    with wall("phase5", card, times):
        out5, counts5 = full_restore(pipe, frames, args.seed, args.steps, card, fused=True)
        log(f"[phase5] mean |fused - default| over the frames "
            f"{float((out5 - out4).abs().mean()):.4e} (bf16 rounds at other places in the two "
            f"configurations; no limit)")
    with wall("phase10", card, times):
        quality = phase10(pipe, frames, out4, out5, card)
    del out4, out5
    with wall("phase6", card, times):
        tile = phase6(pipe, args.seed, card)
    with wall("phase11", card, times):
        parallel = phase11(pipe, frames, args.seed, card)
    with wall("phase13", card, times):
        fp32 = phase13(pipe, frames, args.seed, args.steps, card)
    with wall("phase18", card, times):
        int8 = phase18(pipe, frames, args.seed, card)
    results.update(int8.pop("results"))
    del pipe, frames
    with wall("phase7", card, times):
        phase7(card)
    with tempfile.TemporaryDirectory() as tmp:
        keep = {"dir": tmp}
        with wall("phase8", card, times):
            train = phase8(args.seed, card, keep)
        with wall("phase9", card, times):
            stage2 = phase9(args.seed, card, keep)
        # phase 14's soak runs beside phase 12 (its own processes, a tiny
        # model; both phases' rates are taken sharing the card): phase 14's
        # wall is the soak's own, from its start to its exit
        soak = soak_start(tmp)
        with soak[0]:
            with wall("phase12", card, times):
                ranked = phase12(args.seed, card, keep)
            times["phase14"] = soak_finish(card, soak)["wall_s"]
        log(f"[phase14] {times['phase14']:.1f} s of wall, beside phase 12  [{card}]")
        del keep
    with wall("phase15", card, times):
        t2i = phase15(args.seed, card, train["profile"]["host_s_per_clip"])["txt2img"]
    with wall("phase16", card, times):
        heritage = phase16(args.seed, card)
    with wall("phase17", card, times):
        loader = phase17(card)
    log(f"[phases] s of wall: { {k: round(v, 1) for k, v in times.items()} }; heritage "
        f"(phase 16): {json.dumps(heritage, default=str)}; loader (phase 17): "
        f"{json.dumps(loader, default=str)}  [{card}]")

    # launches: the count on the path that runs the kernel (the fused
    # configuration for the fused conv, phase 18's restore for the int8 convs,
    # the default one for the others)
    kernels = [{"name": name, "route": route, "source": src, "replaces": rep,
                "launches": (counts5 if name in FUSED_ONLY else
                             int8["counts"] if name in INT8_ONLY else counts4)[name],
                "launches_default": counts4[name], "launches_fused": counts5[name],
                "launches_latent": counts_latent[name],
                "launches_tile": tile["auto"]["counts"][name],
                "launches_tile_reference": tile["reference"]["counts"][name],
                "launches_train": train["default"]["launches"][name],
                "launches_train_fused": train["fused"]["launches"][name],
                "launches_stage2": stage2["default"]["launches"][name],
                "launches_stage2_fused": stage2["fused"]["launches"][name],
                "launches_quality": quality["counts"][name],
                "launches_window_parallel": parallel["counts"][name],
                "launches_train_parallel": ranked["stage1"]["launches"][name],
                "launches_fp32_256px": fp32["card_vs_cpu"]["counts"][name],
                "launches_txt2img": t2i["default"]["counts"][name],
                "launches_txt2img_fused": t2i["fused"]["counts"][name],
                "launches_loader_train": loader["train"]["counts"][name],
                "launches_int8": int8["counts"][name],
                **results[name]}
               for name, (route, src, rep) in KERNELS.items()]
    for entry in kernels:
        # phase 15 (e): the kernel at the text-to-image path's shapes
        shapes = t2i["kernel_shapes"].get(entry["name"], {})
        entry["txt2img_shapes"] = shapes
        entry["max_abs_err"] = max([entry["max_abs_err"]]
                                   + [r["max_abs_err"] for r in shapes.values()])
        if entry["name"] == "attention":
            entry["wgmma_launches"] = counts4["attention_wgmma"]
            entry["strided_launches"] = counts4["attention_strided"]
            entry["wide_launches_fp32_256px"] = fp32["card_vs_cpu"]["counts"]["attention_wide"]
            entry["wide_launches_bf16_256px"] = fp32["bf16_256px"]["counts"]["attention_wide"]
            entry["wgmma_launches_txt2img"] = t2i["default"]["counts"]["attention_wgmma"]
        if entry["name"] == "gn_silu_conv3x3":
            entry["wgmma_launches"] = counts5["gn_silu_conv3x3_wgmma"]
            entry["wgmma_launches_txt2img_fused"] = t2i["fused"]["counts"][
                "gn_silu_conv3x3_wgmma"]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
